"""Headline benchmark of the port (mirrors bench.py at the repository's root,
which benches the JAX package): reads/s on one card for read dedup + dBG
build + contig walk + octamer count over a batch of segments, against the
same pipeline in single-threaded C++ (native/gadev.cpp: hash-map dBG and
rolling k-mer counter), with bench.py's extras.

    python -m genomeassembler_dev_tpu_torch.bench            # B 1024 x 1 kb on cuda
    python -m genomeassembler_dev_tpu_torch.bench --device cpu --segments 4 --seq-len 300

Workload (BASELINE.md): B segments synthetic_genome(i, L), reads of 12
bases at coverage 40 simulated on the device in one batched call, dbg k 9.
`bench_step` computes what bench.py's jit(vmap(per_segment)) computes, for
the whole batch at once: each segment's distinct reads with their counts
(one sort over the batch), one union dBG and one doubling walk over the
distinct reads' 9-mers (dbg/graph.py::contigs_union), and the octamer
counts through the histogram kernel (csrc/histogram.cu) over every counted
read's windows, which equal JAX's multiplicity-weighted counts of the
distinct reads.

Prints ONE JSON line on stdout: {"metric", "value" (reads/s), "unit",
"vs_baseline" (median of the per-pair ratios C++ time / step time, over
interleaved pairs), "extras", "device"}; diagnostics go to stderr. Every
gate and every extra is fatal: a failure raises, and the process exits
non-zero without a JSON line. It runs on CUDA; `--device cpu` is for tests,
at a shape the caller gives, and reports no device rooflines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
from genomeassembler_dev_tpu_torch.dbg.assemble import dedup_contigs
from genomeassembler_dev_tpu_torch.dbg.graph import contigs_union
from genomeassembler_dev_tpu_torch.merge import native
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers_batched
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
from genomeassembler_dev_tpu_torch.pipeline.batch_runner import run_experiments_batched
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
from genomeassembler_dev_tpu_torch.sim.reads import (
    n_draws_for, probability_track, reads_from_uniforms)
from genomeassembler_dev_tpu_torch.sim.segments import synthetic_genome
from genomeassembler_dev_tpu_torch.utils.roofline import bytes_bound_ms, lev_bound_ms

METRIC = "reads_per_sec_kmer_count_plus_dbg_build"
READ_LEN, COVERAGE, DBG_K, OCT_K = 12, 40.0, 9, 8
# JAX's fixed capacities (bench.py): outputs beyond them are not comparable
MAX_WALKS, U_CAP = 256, 1024
REPS = 10  # steps a timed group
PAIRS = 5  # interleaved C++ passes and device groups
CHECKED_SEGMENTS = 8  # spread over the batch, held against the native engine
E2E_SEGMENTS = 32
LEV_NW_WIDTH = 1024  # NW queries against a segment-long target
LEV_HW_WIDTH, HW_TARGET_PER_BASE = 2048, 50  # HW: 50,000-base target at 1 kb


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"bench gate failed: {what}")


def simulate_inputs(n_seg: int, seq_len: int, device, seed: int = 0):
    """Reads of segments synthetic_genome(i, seq_len), i < n_seg, simulated
    in one batched call from a seeded torch.Generator, each segment from
    its own uniforms: (codes [B, N, 12] uint8, valid [B, N] bool)."""
    device = torch.device(device)
    table = load_default_query_table(device)
    genome = torch.from_numpy(np.stack(
        [encode_dna(synthetic_genome(i, seq_len)) for i in range(n_seg)])).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((n_seg, n_draws_for(COVERAGE, seq_len, READ_LEN)), generator=gen,
                   dtype=torch.float32, device=device)
    rs = reads_from_uniforms(u, genome, probability_track(genome, table.probs[OCT_K], OCT_K),
                             READ_LEN)
    return rs.codes, rs.valid


class StepOut(NamedTuple):
    """bench.py's four per-segment outputs [B], then what the gates read."""
    contig_chars: torch.Tensor  # letters over every walk
    walks: torch.Tensor
    octamers: torch.Tensor  # octamer windows counted
    distinct_reads: torch.Tensor
    counts8: torch.Tensor  # [B, 4^8] int32 octamer counts
    buf: torch.Tensor  # [W, max_len] uint8: every walk of the batch
    lens: torch.Tensor  # [W]
    overflow: torch.Tensor  # [W]
    walk_seg: torch.Tensor  # [W] segment of each walk


def dedup_with_counts(codes: torch.Tensor, valid: torch.Tensor):
    """Each segment's distinct reads and their multiplicities (the function
    of JAX's ops/dedup.py::pack_read_codes and dedup_with_counts), from one
    sort over the batch: codes [B, N, R] -> (segment [U], read [U] int64
    packed big-endian at 2 bits a base, count [U]), ascending by segment,
    then read. Reads with a code above 3 are dropped, as JAX drops them."""
    B, N, R = codes.shape
    if 2 * R + (B - 1).bit_length() > 62:
        raise ValueError(f"{B} segments of {R}-base reads do not pack into an int64")
    shifts = 2 * torch.arange(R - 1, -1, -1, device=codes.device)
    packed = ((codes.long() & 3) << shifts).sum(dim=-1)
    keep = valid & (codes <= 3).all(dim=-1)
    seg = torch.arange(B, device=codes.device)[:, None].expand(B, N)
    key, counts = torch.unique(((seg << 2 * R) | packed)[keep], sorted=True,
                               return_counts=True)
    return key >> 2 * R, key & ((1 << 2 * R) - 1), counts


def read_windows(reads: torch.Tensor, read_len: int, k: int) -> torch.Tensor:
    """All k-base window codes of packed reads: [U] -> [U, read_len - k + 1]
    (JAX's ops/dedup.py::unpack_kmer_windows)."""
    shifts = 2 * torch.arange(read_len - k, -1, -1, device=reads.device)
    return (reads[:, None] >> shifts) & ((1 << 2 * k) - 1)


def octamer_windows(codes: torch.Tensor, valid: torch.Tensor):
    """The histogram kernel's input: every octamer window of each segment's
    counted reads (valid, bases 0-3 only), (codes [B, N * 5] int32, valid
    [B, N * 5])."""
    B = codes.shape[0]
    oc, ov = kmer_window_codes(codes, OCT_K)
    ov = ov & (valid & (codes <= 3).all(dim=-1))[..., None]
    return oc.reshape(B, -1), ov.reshape(B, -1)


def bench_step(codes: torch.Tensor, valid: torch.Tensor, max_len: int) -> StepOut:
    """Read dedup, dBG and walk, and octamer counts of B segments' reads
    (codes [B, N, R], valid [B, N]) on their device."""
    B, _, R = codes.shape
    useg, ureads, _ = dedup_with_counts(codes, valid)
    n_u = torch.bincount(useg, minlength=B)
    # the distinct reads' windows, a row of the longest segment's count each
    row = torch.arange(useg.shape[0], device=codes.device) - (torch.cumsum(n_u, 0) - n_u)[useg]
    shape = (B, int(n_u.max()), R - DBG_K + 1)
    kc = torch.zeros(shape, dtype=torch.int64, device=codes.device)
    kv = torch.zeros(shape, dtype=torch.bool, device=codes.device)
    kc[useg, row] = read_windows(ureads, R, DBG_K)
    kv[useg, row] = True
    buf, lens, overflow, wseg = contigs_union(kc, kv, DBG_K, max_len)
    counts8 = count_kmers_batched(*octamer_windows(codes, valid), 4**OCT_K)
    return StepOut(
        contig_chars=torch.zeros(B, dtype=torch.int64, device=codes.device).index_add_(
            0, wseg, lens),
        walks=torch.bincount(wseg, minlength=B), octamers=counts8.sum(dim=1),
        distinct_reads=n_u, counts8=counts8, buf=buf, lens=lens, overflow=overflow,
        walk_seg=wseg)


def contig_sets(out: StepOut, segs: list[int]) -> list[list[str]]:
    """The canonical contig set of each segment in segs, from the step's
    walks; raises if one of them overflowed."""
    sel = torch.isin(out.walk_seg, torch.tensor(segs, device=out.walk_seg.device))
    buf, lens, overflow, wseg = (t[sel].cpu().numpy()
                                 for t in (out.buf, out.lens, out.overflow, out.walk_seg))
    return [dedup_contigs(buf[wseg == b], lens[wseg == b], np.ones(int((wseg == b).sum()), bool),
                          overflow[wseg == b]) for b in segs]


def read_strings(codes: torch.Tensor, valid: torch.Tensor) -> list[list[str]]:
    """Each segment's valid reads as strings (N for a code above 3): the
    C++ baseline's input."""
    letters = np.frombuffer(b"ACGTN", np.uint8)[np.minimum(codes.cpu().numpy(), 4)]
    rows = letters.view(f"S{codes.shape[-1]}")[..., 0]
    keep = valid.cpu().numpy()
    return [rows[b][keep[b]].astype(str).tolist() for b in range(rows.shape[0])]


def check_gates(codes: torch.Tensor, valid: torch.Tensor, out: StepOut) -> list[int]:
    """bench.py's fatal gates, per segment, and the native engine on
    CHECKED_SEGMENTS segments spread over the batch (contig sets and octamer
    counts). Returns the segments checked."""
    B = codes.shape[0]
    require(int(out.walks.max()) <= MAX_WALKS, f"more than {MAX_WALKS} walks in a segment")
    require(int(out.distinct_reads.max()) <= U_CAP, f"more than {U_CAP} distinct reads")
    require(torch.equal(out.octamers, valid.sum(dim=1) * (READ_LEN - OCT_K + 1)),
            "weighted octamer count != total windows")
    segs = sorted(set(np.linspace(0, B - 1, min(CHECKED_SEGMENTS, B)).round().astype(int)
                      .tolist()))
    reads = read_strings(codes[segs], valid[segs])
    counts = out.counts8[segs].cpu().numpy()
    for b, contigs, seg_reads, seg_counts in zip(segs, contig_sets(out, segs), reads, counts):
        require(contigs == native.contigs_from_reads_native(seg_reads, DBG_K),
                f"segment {b}: contigs != native engine")
        require(np.array_equal(seg_counts, native.count_kmers_native(seg_reads, OCT_K)),
                f"segment {b}: octamer counts != native engine")
    return segs


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_group(fn, device: torch.device, reps: int = REPS) -> float:
    """Seconds a call of fn(), over `reps` calls that end in a synchronise."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps


def cpp_pass(reads_by_seg: list[list[str]]) -> float:
    """Seconds of the single-core C++ baseline over every segment: octamer
    counts and contigs."""
    t0 = time.perf_counter()
    for reads in reads_by_seg:
        native.count_kmers_native(reads, OCT_K)
        native.contigs_from_reads_native(reads, DBG_K)
    return time.perf_counter() - t0


def pair_ratios(cpp_s: list[float], step_s: list[float]) -> tuple[list[float], float]:
    """Each interleaved pair's ratio (C++ seconds / step seconds), and their
    median: vs_baseline. Pairs sampled under the same host load cancel its
    swings, which a best-of-N against a min-of-M would not."""
    ratios = [c / s for c, s in zip(cpp_s, step_s, strict=True)]
    return ratios, float(np.median(ratios))


def device_entry(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    index = device.index if device.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"platform": "gpu", "name": name, "power_limit": limit}


def lev_cases(n_seg: int, seq_len: int, device):
    """The edit-distance extras' inputs, random bases from a fixed seed:
    (mode, queries [S, M] uint8, lengths [S], target [n]) for NW, S x 1024
    against a segment-long target, and HW, S x 2048 against a 50-segment
    target, with S = min(256, n_seg) (GA_BENCH_FULL=1: 2048 at HW)."""
    rng = np.random.default_rng(1)
    S = min(256, n_seg)
    cases = []
    for mode, s, M, n in (
            ("NW", S, LEV_NW_WIDTH, seq_len),
            ("HW", 2048 if os.environ.get("GA_BENCH_FULL") else S, LEV_HW_WIDTH,
             HW_TARGET_PER_BASE * seq_len)):
        qs = torch.from_numpy(rng.integers(0, 4, (s, M)).astype(np.uint8)).to(device)
        qlen = torch.full((s,), M, dtype=torch.int32, device=device)
        tgt = torch.from_numpy(rng.integers(0, 4, n).astype(np.uint8)).to(device)
        cases.append((mode, qs, qlen, tgt))
    return cases


def run(device, n_seg: int = 1024, seq_len: int = 1000) -> dict:
    """The bench on `device`; returns the JSON line's payload."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    tag = "gpu" if on_card else "cpu"
    card = device_entry(device)
    log(f"device: {card}")
    codes, valid = simulate_inputs(n_seg, seq_len, device)
    n_reads = int(valid.sum())
    log(f"{n_reads} reads ({n_seg} segments x ~{n_reads // n_seg})")

    def step():
        return bench_step(codes, valid, seq_len + DBG_K)

    out = step()
    log(f"walks/segment ~{out.walks.float().mean():.1f}, contig chars/segment "
        f"~{out.contig_chars.float().mean():.1f}, distinct reads/segment "
        f"~{out.distinct_reads.float().mean():.1f}")
    segs = check_gates(codes, valid, out)
    log(f"gates: octamer totals of {n_seg} segments; contigs and counts of segments "
        f"{segs} equal to the native engine")

    # interleaved single-core C++ / device pairs, after one untimed group
    reads_by_seg = read_strings(codes, valid)
    time_group(step, device)
    cpp_s, step_s = [], []
    for i in range(PAIRS):
        cpp_s.append(cpp_pass(reads_by_seg))
        step_s.append(time_group(step, device))
        log(f"pair {i}: cpp {cpp_s[-1] * 1e3:.1f} ms, {tag} {step_s[-1] * 1e3:.3f} ms "
            f"-> ratio {cpp_s[-1] / step_s[-1]:.2f}x")
    ratios, vs_baseline = pair_ratios(cpp_s, step_s)
    t_step = min(step_s)
    extras = {f"{tag}_ms_per_batch": t_step * 1e3, "cpp_ms_best": min(cpp_s) * 1e3,
              "cpp_ms_range": [min(cpp_s) * 1e3, max(cpp_s) * 1e3], "ratio_pairs": ratios}
    log(f"{tag}: {t_step * 1e3:.3f} ms/batch -> {n_reads / t_step:,.0f} reads/s; median "
        f"ratio {vs_baseline:.2f}x")
    if on_card:
        # the least bytes the step moves: its inputs read once, every output
        # it returns (the counts and the walks the gates read too) written once
        bound = bytes_bound_ms(codes, valid, *out)
        extras.update(fused_step_bound_ms=bound,
                      fused_step_pct_of_hbm_bound=100.0 * bound / (t_step * 1e3))

    # end-to-end experiments/s of the batched runner (K1 once an experiment)
    cfg = ExperimentConfig(seq_len=seq_len, read_len=READ_LEN, dbg_kmer=DBG_K,
                           coverage_target=COVERAGE, kmer=OCT_K, seed=1234, n_orderings=10000)
    e2e = [synthetic_genome(1000 + i, seq_len) for i in range(min(E2E_SEGMENTS, n_seg))]
    table = load_default_query_table(device)
    for key in ("experiments_per_sec_e2e_cold", "experiments_per_sec_e2e"):
        t0 = time.perf_counter()
        res = run_experiments_batched(cfg, e2e, device, table)
        secs = time.perf_counter() - t0
        require(len(res) == len(e2e) and all(r.n_solutions >= 1 for r in res),
                "e2e: an experiment without solutions")
        extras[key] = len(e2e) / secs
        log(f"e2e batched study: {len(e2e)} experiments in {secs:.3f} s ({key})")

    # the B 256 group (bench.py's ms/batch history axis)
    b = min(256, n_seg)
    bench_step(codes[:b], valid[:b], seq_len + DBG_K)
    t_b = min(time_group(lambda: bench_step(codes[:b], valid[:b], seq_len + DBG_K), device)
              for _ in range(3))
    extras[f"{tag}_ms_per_batch_b{b}"] = t_b * 1e3
    log(f"B {b} group: {t_b * 1e3:.3f} ms/batch")

    # edit-distance throughput through the Myers kernel's wrapper
    for mode, qs, qlen, tgt in lev_cases(n_seg, seq_len, device):
        (S, M), n = qs.shape, tgt.shape[0]
        d = batched_levenshtein_auto(qs, qlen, tgt, mode=mode)
        lo = 0 if mode == "HW" else abs(M - n)
        require(bool(((d >= lo) & (d <= max(M, n))).all()), f"{mode} distances out of range")
        # NW: bench.py's REPS calls; HW: one call, as bench.py times it
        secs = time_group(lambda: batched_levenshtein_auto(qs, qlen, tgt, mode=mode), device,
                          REPS if mode == "NW" else 1)
        shape = f"{S}x{M}x{n}"
        extras[f"lev_{mode.lower()}_gcells_per_sec_{shape}"] = S * M * n / secs / 1e9
        if mode == "HW":
            extras[f"lev_hw_alignments_per_sec_{shape}"] = S / secs
        if on_card:
            extras[f"lev_{mode.lower()}_pct_of_bound_{shape}"] = (
                100.0 * lev_bound_ms(qlen, n, "words") / (secs * 1e3))
        log(f"edit distance {mode} {shape}: {secs * 1e3:.3f} ms -> "
            f"{S * M * n / secs / 1e9:.1f} Gcell/s")

    return {"metric": METRIC, "value": n_reads / t_step, "unit": "reads/s",
            "vs_baseline": vs_baseline, "extras": extras, "device": card}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1; cpu for tests)")
    ap.add_argument("--segments", type=int, default=None,
                    help="segments in the batch (1024 on a card)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="bases a segment (1000 on a card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"bench: --device {args.device}: no CUDA device here; the bench "
                         "runs on a card (--device cpu is for tests, at a shape they give)")
    if device.type == "cpu" and (args.segments is None or args.seq_len is None):
        raise SystemExit("bench: --device cpu runs at a shape the caller gives "
                         "(--segments, --seq-len)")
    payload = run(device, args.segments or 1024, args.seq_len or 1000)
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
