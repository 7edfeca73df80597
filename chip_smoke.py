#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genomeassembler_dev_tpu_torch) on one
NVIDIA GPU: builds the Myers Levenshtein kernel from csrc/myers.cu, holds it
against its plain PyTorch version, replays the own_k9_rl12 golden fixture,
then drives eight own-dBG experiments at the study shape through
Assembler.run_experiment and checks them against the native C++ engine.

    python3 chip_smoke.py

Needs a CUDA card, nvcc for sm_90a and a C++ compiler for native/. Every
phase's check raises on a mismatch, so any failure exits non-zero. The last
line is {"ok": true, "device": {...}}; the line before it is nvidia-smi's
name and power limit, and the one before that the kernel record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "fixtures", "own_k9_rl12.json")
KERNEL_SOURCE = "genomeassembler_dev_tpu_torch/csrc/myers.cu"
REPLACES = "genomeassembler_dev_tpu/ops/pallas/myers_kernel.py:58"
RTOL = 2e-5  # float32 scores: the JAX package's float32 tolerance


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rand_dna(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), size=n))


def mutate(rng, s: str, rate: float) -> str:
    """Substitutions, insertions and deletions at `rate` each."""
    out = []
    for ch in s:
        r = rng.random()
        if r < rate:
            out.append("ACGT"[int(rng.integers(4))])
        elif r < 2 * rate:
            out.extend([ch, "ACGT"[int(rng.integers(4))]])
        elif r >= 3 * rate:
            out.append(ch)
    return "".join(out)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events over reps runs."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.merge import native
    from genomeassembler_dev_tpu_torch.ops import myers
    from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein
    from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler, pack_strings
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_genome
    from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- phase 1: the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[1] gpu: {smi}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # -- phase 2: build the kernel --------------------------------------------
    t0 = time.perf_counter()
    so = myers.build()
    print(f"[2] built {os.path.relpath(so, HERE)} in {time.perf_counter() - t0:.2f} s")
    with open(so + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"[2] ptxas: {line.strip()}")

    # -- phase 3: kernel vs plain DP on the card ------------------------------
    def to_dev(queries, target):
        mat, lens = pack_strings(queries, pad=0)
        return (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
                torch.from_numpy(encode_dna(target)).to(dev))

    max_err = 0

    def compare(name, args, mode):
        nonlocal max_err
        got = myers.batched_levenshtein_myers(*args, mode=mode)
        want = batched_levenshtein(*args, mode=mode)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"{name} {mode}: kernel != plain DP")
        print(f"[3] {name} {mode}: {got.numel()} distances equal")

    rng = np.random.default_rng(0)
    target = rand_dna(rng, 90)
    cases = {"random": ([rand_dna(rng, int(rng.integers(1, 120))) for _ in range(9)]
                        + [target, target[10:40]], target)}
    rng = np.random.default_rng(1)
    target = rand_dna(rng, 150)
    cases["multiword+empty"] = ([rand_dna(rng, 200), target + "ACGT" * 10, ""], target)
    for name, (queries, target) in cases.items():
        for mode in ("NW", "HW"):
            compare(name, to_dev(queries, target), mode)

    # the slice's shape: 512 solutions padded to 2048 columns, real lengths
    # 0..1030, against a 1 kb segment
    rng = np.random.default_rng(2)
    segment = rand_dna(rng, 1000)
    sols = [""] + [mutate(rng, segment[int(a):], 0.02)[:1030]
                   for a in rng.integers(0, 600, 383)]
    sols += [rand_dna(rng, int(n)) for n in rng.integers(1, 1031, 128)]
    mat, lens = pack_strings(sols, l_multiple=2048)
    check(mat.shape == (512, 2048), f"slice shape {mat.shape}")
    slice_args = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
                  torch.from_numpy(encode_dna(segment)).to(dev))
    for mode in ("NW", "HW"):
        compare("slice 512x2048x1000", slice_args, mode)
    k_ms = cuda_ms(lambda: myers.batched_levenshtein_myers(*slice_args, mode="NW"), 20)
    p_ms = cuda_ms(lambda: batched_levenshtein(*slice_args, mode="NW"), 3)
    print(f"[3] slice 512x2048x1000 NW: kernel {k_ms:.3f} ms, plain DP {p_ms:.3f} ms")

    # the velvet path's default shape: 256 x 2048 queries, HW, 50 kb target
    rng = np.random.default_rng(3)
    hw_args = (torch.from_numpy(rng.integers(0, 4, (256, 2048)).astype(np.uint8)).to(dev),
               torch.full((256,), 2048, dtype=torch.int32, device=dev),
               torch.from_numpy(rng.integers(0, 4, 50000).astype(np.uint8)).to(dev))
    compare("velvet 256x2048x50000", hw_args, "HW")
    hk_ms = cuda_ms(lambda: myers.batched_levenshtein_myers(*hw_args, mode="HW"), 3)
    hp_ms = cuda_ms(lambda: batched_levenshtein(*hw_args, mode="HW"), 1)
    print(f"[3] velvet 256x2048x50000 HW: kernel {hk_ms:.3f} ms, plain DP {hp_ms:.3f} ms")

    # -- phase 4: the own_k9_rl12 golden fixture ------------------------------
    with open(GOLDEN) as f:
        fx = json.load(f)
    c, ref = fx["config"], fx["reference"]
    gcfg = ExperimentConfig(seq_len=c["seq_len"], read_len=c["read_len"],
                            dbg_kmer=c["dbg_kmer"], kmer=c["break_kmer"], seed=c["seed"],
                            n_orderings=ref["n_orderings"])
    gasm = Assembler(gcfg, dev)
    codes = np.stack([encode_dna(r) for r in fx["reads"]])
    read_set = (codes, np.ones(len(codes), bool), np.zeros(len(codes), np.int32))
    rs = gasm._replay_read_set(torch.from_numpy(encode_dna(fx["segment"])).to(dev), read_set)
    check(gasm.contigs(rs.codes, rs.valid, StageTimer(dev, False)) == ref["contigs"],
          "golden contigs")
    res = gasm.run_experiment(fx["segment"], read_set)
    cols = res.columns
    check(sorted(cols["sequence"]) == sorted(ref["solutions"]), "golden solution set")
    row = {s: i for i, s in enumerate(cols["sequence"])}
    idx = [row[s] for s in ref["sequence"]]
    for col, key in (("kmer_breaks", "kmer_breaks"), ("lev_dist_vs_true", "lev_dist_vs_true")):
        check(np.array_equal(np.asarray(cols[col])[idx], ref[key]), f"golden {col}")
    for col, key in (("bp_score_true", "bp_score"),
                     ("bp_score_norm_by_break_freqs_true", "bp_score_norm_by_break_freqs"),
                     ("bp_score_norm_by_len_true", "bp_score_norm_by_len")):
        check(np.allclose(np.asarray(cols[col])[idx], ref[key], rtol=RTOL, atol=0),
              f"golden {col}")
    print(f"[4] own_k9_rl12: {len(ref['contigs'])} contigs, {res.n_solutions} solutions, "
          "breaks and distances equal, scores within rtol 2e-5")

    # -- phase 5: eight experiments at the study shape ------------------------
    cfg = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9, coverage_target=40.0,
                           kmer=8, seed=1234, n_orderings=10000)
    asm = Assembler(cfg, dev)
    segments = [synthetic_genome(1000 + i, 1000) for i in range(8)]
    torch.cuda.synchronize()
    myers.batched_levenshtein_myers.launches = 0
    t0 = time.perf_counter()
    results = [asm.run_experiment(s) for s in segments]
    wall = time.perf_counter() - t0
    launches = myers.batched_levenshtein_myers.launches
    check(launches > 0, "the Myers kernel was not launched on the main path")

    stage_sum: dict[str, float] = {}
    for res in results:
        for name, t in res.timings.items():
            stage_sum[name] = stage_sum.get(name, 0.0) + t
    probs = asm.table.combined.cpu().numpy()
    for i, (segment, res) in enumerate(zip(segments, results)):
        cols = res.columns
        n = res.n_solutions
        check(n >= 1 and all(len(np.asarray(cols[k])) == n for k in cols),
              f"exp {i}: column lengths")
        check(np.isfinite(np.asarray(cols["bp_score_true"])).all(), f"exp {i}: finite scores")
        # the same seed gives the same reads: re-simulate and check each stage
        timer = StageTimer(dev, False)
        rs = asm.simulate(torch.from_numpy(encode_dna(segment)).to(dev), timer)
        valid = rs.valid.cpu().numpy()
        check(int(valid.sum()) == res.stats["nr_of_reads"], f"exp {i}: read count")
        reads = ["".join("ACGT"[b] for b in r) for r in rs.codes.cpu().numpy()[valid]]
        contigs = asm.contigs(rs.codes, rs.valid, timer)
        check(contigs == native.contigs_from_reads_native(reads, cfg.dbg_kmer),
              f"exp {i}: contigs != native engine")
        scores, breaks = native.breakscore_native(cols["sequence"], reads, probs)
        check(np.array_equal(np.asarray(cols["kmer_breaks"]), breaks),
              f"exp {i}: kmer_breaks != native engine")
        check(np.allclose(np.asarray(cols["bp_score_true"]), scores, rtol=RTOL, atol=0),
              f"exp {i}: bp_score != native engine")
        mat, lens = pack_strings(cols["sequence"])
        plain = batched_levenshtein(torch.from_numpy(mat).to(dev),
                                    torch.from_numpy(lens).to(dev),
                                    torch.from_numpy(encode_dna(segment)).to(dev), "NW")
        check(np.array_equal(np.asarray(cols["lev_dist_vs_true"]), plain.cpu().numpy()),
              f"exp {i}: lev_dist_vs_true != plain DP")
        print(f"[5] exp {i}: {res.stats['nr_of_reads']} reads, {len(contigs)} contigs, "
              f"{n} solutions (longest {max(len(s) for s in cols['sequence'])}): "
              "contigs, breaks, scores and distances agree")
    for name, t in stage_sum.items():
        print(f"[5] stage {name}: {1e3 * t / len(results):.2f} ms per experiment")
    print(f"[5] {len(results)} experiments in {wall:.3f} s -> "
          f"{len(results) / wall:.3f} experiments/s; Myers launches {launches}")
    print(f"[6] total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "myers_levenshtein", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
