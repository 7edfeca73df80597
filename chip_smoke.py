#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genomeassembler_dev_tpu_torch) on one
NVIDIA GPU.

  [1] the card;
  [2] builds the four kernels from csrc/ (myers.cu, histogram.cu,
      prefix_min.cu, ks.cu), all nvcc processes at once;
  [3] holds the Myers kernel against the plain DP, on the TPU kernel's test
      cases, on queries at the edges of its launch plan (strips, warps,
      bands; alone and mixed in one launch), on queries and targets with
      ~5% N (code 255, which matches N: one warp, a block of warps, two
      bands) and at the study shapes, and [3b] the prefix-min kernel against
      the same plain results and the Myers kernel at every width;
  [3c] holds the histogram kernel against its plain version and the native
      C++ k-mer counter (k 2 to 9, int64 codes out of range, the parts'
      edges, the count study's four shapes) and times it beside
      torch.bincount;
  [3d] holds the KS kernel (K4, csrc/ks.cu) against the pooled sort on
      crafted rows (ties, values equal to the track's, track zeros tying the
      zero run, all-zero, one-nonzero and NaN rows, kept counts at the
      capacity, scalar loads, the largest capacity, a row past its
      capacity), groups of tracks and real breakscore rows at the k 9 and
      50 kb shapes, within one float32 ulp (bit-equal rows counted); checks
      that a bound above capacity takes the pooled sort, and times K4 at
      both shapes beside its byte bound and the pooled sort;
  [4] replays the golden fixtures own_k9_rl12, own_k13_rl16 and own_k15_rl20;
  [5] drives eight own-dBG experiments at the study shape through
      Assembler.run_experiment and checks them against the native engine;
  [6] runs `cli study-all` in process: the full own grid (7 rows x 4
      iterations at the study shape), the k-mer-count study and the GC
      study, then checks every artifact against the native engine, the
      prefix-min kernel and the plain DP;
  [8] replays the golden fixture velvet_k15_rl12, then runs `cli
      study-velvet` once per row of the velvet grid on 50 kb segments with
      velvet-contract contigs (tiles overlapping by dbg_kmer - 1), checks
      every experiment against the segment, the native engine, the CPU KS
      and the plain DP, times the Myers kernel and the plain DP at the
      velvet path's real shape, and the kernel on a repeat-heavy ensemble
      (256 mutated 2x copies of the segment, rows 0-3 against the plain DP),
      with the prefix-min kernel equal to it on every row of both; then a
      repeat-heavy velvet experiment end to end (a 50 kb segment with
      planted repeats, row 40:37, its dBG's unitigs as contigs): at least
      two evaluation chunks, every solution's scores equal to an evaluate
      with the chunks at other rows and the first 64 to their evaluate
      alone;
  [9] runs `cli study-own --traversal biased` on 1 kb segments with planted
      repeats (rows 12:9, 16:13, 25:15) and checks every experiment against
      a host string-level greedy walk, the port's CPU run, the native engine,
      the prefix-min kernel and the plain DP;
 [10] runs `cli study-own --batched --seg-batch 16` over the full own grid
      (7 rows x 16 iterations at the study shape) and the serial study on the
      same segments, checks that every artifact agrees, and every experiment
      against the native engine, the prefix-min kernel and (exp 1) the plain
      DP; times each row both ways and the batched stages;
 [11] holds the device ensemble merge against the native engine at 64 and
      128 contigs with 10,000 orderings, and both against the spec at 200,
      checks the collision guard on a duplicate-heavy ensemble, and times
      the device and native merges;
 [12] runs `cli fit-model` at full width (k 8, hidden 256, batch 4096, 500
      steps), checks that the loss halves, the card's forward against the CPU
      plain path and a checkpoint round trip, and prints steps/s;
 [13] the parallel layer at world 1: a one-rank NCCL group and its mesh,
      the sharded sim+count step at the study shape (16 x 1 kb, K2), the
      breakscore, KS and Levenshtein steps on one batched-runner group (K1),
      the dp x tp train step against [12]'s unsharded step, the sharded table
      lookup, both ring Levenshteins at one shard against K1 (timed), the
      batched runner with the mesh against mesh=None, and `cli bench-scaling
      --devices 1` at the study shape. K1's and K2's launches there join the
      kernel record;
 [14] `run --plots` on one study-shape experiment: the track and the
      re-drawn breakpoints it plots, from the card, against the CPU plain
      track and the experiment's own reads; the three figures are drawn
      where matplotlib is installed, and a line says so where it is not;
 [15] a device trace (utils/profiling.py) of one study-shape experiment with
      its stages annotated, then one K2 and one K3 call: every K1, K2, K3
      and K4 launch must be a kernel event of its name launched inside its
      span;
      prints the device busy share of the experiment's window, its top five
      device operations and the trace file;
 [16] the port's headline bench (genomeassembler_dev_tpu_torch/bench.py) at
      B 1024 x 1 kb with its fatal gates (the step against the native engine
      on 8 segments), its JSON line printed, then K2 at the step's shape
      [1024, 16,670] against its plain version, timed beside torch.bincount,
      K1 on the bench's NW inputs (256 x 1024 x 1000) against the plain DP,
      and a device trace of one step (busy share, top device operations);
 [17] BASELINE config 1: `cli run` on one 50 kb segment with 150-base reads
      at dbg k 31 and 10,000 orderings; the re-simulated reads' contigs,
      solutions, kmer_breaks and bp_score_true against the native engine,
      their read FASTAs read back, and lev_dist_vs_true (K1 in NW mode at
      the pipeline's [64, 50,048] x 50,000) against K3 and the plain DP on
      the real rows; prints the stage times, the walk's W and buffer bytes,
      the peak device memory and K1's time beside its bound;
 [18] BASELINE config 3: `cli study-own --batched --seg-batch 64` over the
      own grid at full scale (7 rows x 200 experiments, each row's last batch
      filled up with its first segment): every artifact, one K1 launch a run
      and none of K3, and on each row the experiments on both sides of every
      batch boundary equal to Assembler.run_experiment on the card; prints
      the study's and each row's experiments/s, the worker's merge seconds
      beside the overlapped stage and the peak device memory.

Every call of K1, K2 and K3 in [3], [3b], [3c], [16] and [17] checks that the
caller's current CUDA device is the same after it as before (on one card
there is no other device to move to).

    python3 chip_smoke.py

Needs a CUDA card, nvcc for sm_90a and a C++ compiler for native/. Every
check raises on a mismatch, so any failure exits non-zero. The last line is
{"ok": true, "device": {...}}; the line before it is nvidia-smi's name and
power limit, and the one before that the kernel record. Each kernel's
bound_ms there is the least time the card could take for the work of the
timed call: bytes over the memory rate for the histogram, operations over
the card's issue rate for the Levenshtein kernels
(genomeassembler_dev_tpu_torch/utils/roofline.py).
"""

from __future__ import annotations

import csv
import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from genomeassembler_dev_tpu_torch.utils.roofline import (
    HBM_BYTES_PER_MS, bytes_bound_ms, lev_bound_ms)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = [os.path.join(HERE, "tests", "golden", "fixtures", f"{n}.json")
            for n in ("own_k9_rl12", "own_k13_rl16", "own_k15_rl20")]
STUDY_DIR = os.path.join(HERE, "build", "smoke_study")
STUDY_ITERS = 4
VELVET_FIXTURE = os.path.join(HERE, "tests", "golden", "fixtures", "velvet_k15_rl12.json")
VELVET_DIR = os.path.join(HERE, "build", "smoke_velvet")
VELVET_LEN = 50000  # the velvet study's segments (studies/STUDY_velvet_r5.md)
VELVET_TILE = 5000
BIASED_DIR = os.path.join(HERE, "build", "smoke_biased")
BIASED_GRID = ((12, 9), (16, 13), (25, 15))  # the biased study's rows
BATCHED_DIR = os.path.join(HERE, "build", "smoke_batched")
BATCHED_ITERS = 16  # one batch of 16 segments a row
MODEL_DIR = os.path.join(HERE, "build", "smoke_model")
NCCL_STORE = os.path.join(HERE, "build", "smoke_parallel", "nccl_store")
PARALLEL_SEGMENTS = 16  # the batched study's batch: 16 segments of 1 kb
REPEAT_DIR = os.path.join(HERE, "build", "smoke_velvet_repeats")
REPEAT_ROW = (40, 37)  # the velvet grid row with the fewest solutions on repeats
REPEAT_ORDERINGS = 20000  # the velvet path's own (pipeline/velvet.py)
UNITIG_READ = 60  # error-free reads that make the repeat segment's velvet contigs
PLOTS_DIR = os.path.join(HERE, "build", "smoke_plots")
TRACE_DIR = os.path.join(HERE, "build", "smoke_trace")
BENCH_TRACE_DIR = os.path.join(HERE, "build", "bench_trace")
CONFIG1_DIR = os.path.join(HERE, "build", "smoke_config1")
# BASELINE config 1 (studies/STUDY_config1_r2.md): one 50 kb segment, 150-base reads
CONFIG1 = {"seq_len": 50000, "read_len": 150, "dbg_kmer": 31, "coverage": 40,
           "n_orderings": 10000}
OWN_FULL_DIR = os.path.join(HERE, "build", "smoke_own_full")
OWN_FULL_ITERS = 200  # BASELINE config 3 (studies/STUDY_own_full_r2.md): 200 a row
OWN_FULL_BATCH = 64
KERNEL_NAMES = {"myers_levenshtein": "myers_kernel", "kmer_histogram": "histogram_kernel",
                "prefix_min_levenshtein": "prefix_min_kernel",
                "ks_sparse": "ks_sparse_kernel"}  # in the kernels' symbols
KERNELS = {  # name in the record: (csrc name, TPU kernel it replaces)
    "myers_levenshtein": ("myers", "genomeassembler_dev_tpu/ops/pallas/myers_kernel.py:58"),
    "kmer_histogram": ("histogram",
                       "genomeassembler_dev_tpu/ops/pallas/histogram_kernel.py:27"),
    "prefix_min_levenshtein": ("prefix_min",
                               "genomeassembler_dev_tpu/ops/pallas/edit_distance_kernel.py:32"),
    # K4: no TPU kernel; the JAX package sorts the pooled rows with jnp.sort
    "ks_sparse": ("ks", "none (genomeassembler_dev_tpu/ops/ks.py sorts with jnp.sort)"),
}
RTOL = 2e-5  # float32 scores: the JAX package's float32 tolerance
# query lengths at the Myers kernel's strip, warp and band edges
EDGE_LENGTHS = (1, 31, 32, 33, 63, 64, 65, 1024, 1025, 8192, 8193, 16385, 50048)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rand_dna(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), size=n))


def with_ns(rng, s: str, rate: float = 0.05) -> str:
    """s with each base replaced by N at `rate`."""
    return "".join("N" if rng.random() < rate else ch for ch in s)


def non_acgt_cases(target: str) -> dict:
    """{name: (queries, target)} whose N (code 255) must match N, as in the
    plain DP and the spec: four strings, then queries and a target with ~5%
    N at one warp, a block of warps (S 8) and two bands."""
    cases = {"N strings": (["ACGTNNACG", "AAAAAA", "NNNN", "ACGTAAACGTTACAA"], "ACGTNNACGTTACNA")}
    rng = np.random.default_rng(10)
    n_target = with_ns(rng, target)
    cases["N one warp"] = ([with_ns(rng, n_target[a : a + 200]) for a in range(0, 100, 10)]
                           + [with_ns(rng, rand_dna(rng, 90)), ""], n_target)
    cases["N block of warps"] = ([with_ns(rng, (n_target * 17)[:5000]),
                                  with_ns(rng, n_target[7:290])], n_target)
    cases["N two bands"] = ([with_ns(rng, (n_target * 467)[:140000]), with_ns(rng, n_target[:33]),
                             ""], n_target)
    return cases


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


def mutate_codes(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    """mutate() on base codes, vectorised: substitutions, insertions and
    deletions at `rate` each."""
    r = rng.random(codes.size)
    base = np.where(r < rate, rng.integers(0, 4, codes.size), codes).astype(np.uint8)
    counts = np.where(r < 2 * rate, np.where(r < rate, 1, 2), np.where(r < 3 * rate, 0, 1))
    out = np.repeat(base, counts)
    out[np.cumsum(counts)[counts == 2] - 1] = rng.integers(0, 4, int((counts == 2).sum()))
    return out


def slice_shape_args(dev):
    """(queries, lengths, target) at the slice's shape: 512 solutions padded
    to 2048 columns, real lengths 0..1030, against a 1 kb segment."""
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.pipeline.evaluate import pack_strings

    rng = np.random.default_rng(2)
    segment = rand_dna(rng, 1000)
    sols = [""] + [mutate(rng, segment[int(a):], 0.02)[:1030]
                   for a in rng.integers(0, 600, 383)]
    sols += [rand_dna(rng, int(n)) for n in rng.integers(1, 1031, 128)]
    mat, lens = pack_strings(sols, l_multiple=2048)
    check(mat.shape == (512, 2048), f"slice shape {mat.shape}")
    return (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(encode_dna(segment)).to(dev))


def hw_shape_args(dev):
    """(queries, lengths, target) of a plain HW shape: 256 x 2048 random
    queries against a random 50 kb target."""
    rng = np.random.default_rng(3)
    return (torch.from_numpy(rng.integers(0, 4, (256, 2048)).astype(np.uint8)).to(dev),
            torch.full((256,), 2048, dtype=torch.int32, device=dev),
            torch.from_numpy(rng.integers(0, 4, 50000).astype(np.uint8)).to(dev))


def repeat_heavy_args(segment: str, target: torch.Tensor):
    """(queries, lengths, target) of a repeat-heavy velvet ensemble on
    target's device: 256 mutated ~2x copies of the segment, [256, 100,096]."""
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna

    rng = np.random.default_rng(6)
    doubled = np.tile(encode_dna(segment), 2)
    reps = [mutate_codes(rng, doubled, 0.003) for _ in range(256)]
    mat = np.zeros((256, -(-max(map(len, reps)) // 128) * 128), np.uint8)
    for i, r in enumerate(reps):
        mat[i, : len(r)] = r
    return (torch.from_numpy(mat).to(target.device),
            torch.tensor([len(r) for r in reps], dtype=torch.int32, device=target.device), target)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events over reps runs."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def captured(fn, calls: int) -> torch.cuda.CUDAGraph:
    """`calls` calls of fn() captured as one CUDA graph, kept for inspection."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: the library is loaded outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.instantiate()
    return graph


def graph_us(fn, calls: int = 50) -> float:
    """Mean microseconds of fn() on the card, replayed as one CUDA graph: the
    device's time without the host's launches."""
    return 1e3 * cuda_ms(captured(fn, calls).replay, 10) / calls


def graph_nodes(fn) -> list[int]:
    """The node types (CUgraphNodeType: 0 a kernel, 2 a memset) of one fn()
    call captured as a CUDA graph, read through the driver API."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.restype = cuda.cuGraphNodeGetType.restype = ctypes.c_int
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    graph = captured(fn, 1)  # alive while its raw handle is read
    raw = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0, "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(node, ctypes.byref(t)) == 0, "cuGraphNodeGetType")
        types.append(t.value)
    return types


def keeps_device(kernel: str, call):
    """call() (one kernel's wrapper), checking that the caller's current CUDA
    device is the same after the call as before it. With one card there is
    no other device to move to, so the check cannot fail there."""
    before = torch.cuda.current_device()
    out = call()
    torch.cuda.synchronize()
    after = torch.cuda.current_device()
    check(after == before, f"{kernel} moved the current device from {before} to {after}")
    return out


def max_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def reads_of(rs) -> list[str]:
    """The valid reads of a ReadSet as strings."""
    valid = rs.valid.cpu().numpy()
    return ["".join("ACGT"[b] for b in r) for r in rs.codes.cpu().numpy()[valid]]


def check_same_columns(what: str, got: dict, want: dict) -> None:
    """Two SolutionsTables of one experiment agree: the solutions in the same
    order, integers exact, KS within atol 1e-6 (NaN where NaN), the other
    floats within RTOL."""
    from genomeassembler_dev_tpu_torch.pipeline.assembler import RESULT_COLUMNS

    check(list(got) == RESULT_COLUMNS, f"{what}: columns")
    check(list(got["sequence"]) == list(want["sequence"]), f"{what}: solutions differ")
    for col in RESULT_COLUMNS[1:]:
        a, b = np.asarray(got[col]), np.asarray(want[col])
        if col in ("sequence_len", "kmer_breaks", "lev_dist_vs_true"):
            check(np.array_equal(a, b), f"{what}: {col} differs")
        elif col.startswith("stat_test_KS"):
            check(np.array_equal(np.isnan(a), np.isnan(b)) and np.allclose(
                a[~np.isnan(b)], b[~np.isnan(b)], rtol=0, atol=1e-6), f"{what}: {col} differs")
        else:
            check(np.allclose(a, b, rtol=RTOL, atol=0, equal_nan=True), f"{what}: {col} differs")


def octamer_code(s: str) -> int:
    code = 0
    for ch in s:
        code = 4 * code + "ACGT".index(ch)
    return code


def greedy_walks(reads: list[str], k: int, probs8: np.ndarray, max_len: int) -> list[str]:
    """String-level biased traversal: from every (branch node, out-edge)
    pair, continue along the out-edge whose junction octamer is most
    probable (ties to the smallest base) to a dead end or max_len."""
    out_edges: dict[str, set] = {}
    in_deg: dict[str, int] = {}
    for km in {r[i : i + k] for r in reads for i in range(len(r) - k + 1)}:
        out_edges.setdefault(km[:-1], set()).add(km[-1])
        in_deg[km[1:]] = in_deg.get(km[1:], 0) + 1
    walks = set()
    for node, chars in out_edges.items():
        if in_deg.get(node, 0) == 1 and len(chars) == 1:
            continue  # not a branch node
        for c in chars:
            s = node + c
            while len(s) < max_len:
                cands = out_edges.get(s[-(k - 1):])
                if not cands:
                    break
                s += min(cands, key=lambda b: (-probs8[octamer_code(s[-7:] + b)], b))
            walks.add(s)
    return sorted(walks)


def merge_cases(rng_for) -> dict:
    """The contig sets of tests/test_merge_device.py's crossover (C 64),
    production (C 128) and duplicate-heavy cases."""
    rng = rng_for(7)
    base = rand_dna(rng, 1200)
    c64, seen = [], set()
    for i in range(0, 1152, 18):
        s = base[i : i + 24]
        if rng.random() < 0.5:  # half lose the overlap (random tail)
            s = s[:12] + rand_dna(rng, 12)
        if s not in seen:
            seen.add(s)
            c64.append(s)
    rng = rng_for(3)
    seg = rand_dna(rng, 1500)
    seg = seg[:400] + seg[100:300] + seg[400:]  # planted repeat
    c128, seen = [], set()
    for lo in range(0, len(seg) - 30, (len(seg) - 30) // 128):
        s = seg[lo : lo + 30]
        if s not in seen:
            seen.add(s)
            c128.append(s)
    rng = rng_for(0)
    dup = "ACGTC" + rand_dna(rng, 20) + "ACGTC"  # suffix_k == prefix_k
    other = [rand_dna(rng, 30) for _ in range(4)]
    return {"C 64": c64[:64], "C 128": c128[:128],
            "duplicate-heavy": [dup, other[0], dup, other[1], dup, other[2], other[3]]}


def phase_ks(dev, record: dict) -> None:
    """[3d] K4 (csrc/ks.cu) against the pooled sort, ops/ks.py's plain
    version (batched_ks_2samp), on the card: crafted rows (ties inside a
    row, values equal to track values, track zeros tying the zero run,
    all-zero, one-nonzero and NaN rows, kept counts at the capacity and at
    the largest shared capacity, rows past it whose keys live in a global
    scratch row, dense rows under no bound but N), groups of several tracks,
    the score groups that run_experiments_batched hands K4 for own1k.k9's
    first row (12:9, the cell's first 64 segments, in the runner's score
    groups) and
    breakscore rows at BASELINE config 1's shape (one 50 kb segment, 150-base
    reads): every row within one float32 ulp, NaN where NaN, the bit-equal
    rows counted. A row past its bound's capacity reads NaN, and the wrapper
    refuses rows it cannot load 16 bytes at a time. The study's runner takes
    K4 for every KS row (eval.ks_kernel_rows == eval.ks_rows, one launch a
    group) and gives the KS columns of the pooled sort within one ulp. K4 is
    timed on the study's groups and at the 50 kb shape by CUDA events over
    calls and as a CUDA graph, beside its byte bound and the pooled sort in
    chunks of KS_ROWS rows as evaluate_group ran it before K4."""
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.core.querytable import TOTAL, load_default_query_table
    from genomeassembler_dev_tpu_torch.ops import ks
    from genomeassembler_dev_tpu_torch.pipeline import evaluate
    from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
    from genomeassembler_dev_tpu_torch.pipeline.batch_runner import run_experiments_batched
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.pipeline.evaluate import KS_ROWS, pack_member
    from genomeassembler_dev_tpu_torch.score.breakscore import breakscore
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_genome
    from genomeassembler_dev_tpu_torch.utils import profiling
    from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

    rec = record["ks_sparse"]
    rec.update(rows=0, bit_equal_rows=0, max_ulp=0)
    torch.cuda.synchronize()
    ks.ks_2samp_sparse.launches = 0

    def pooled(x, y):
        """The pooled sort of x's rows in chunks of KS_ROWS, as evaluate_group
        ran it before K4: row b against y[b // (B // G)]."""
        y_rows = y.repeat_interleave(x.shape[0] // y.shape[0], dim=0)
        return torch.cat([ks.batched_ks_2samp(x[lo : lo + KS_ROWS], y_rows[lo : lo + KS_ROWS])
                          for lo in range(0, x.shape[0], KS_ROWS)])

    def ulps(got: torch.Tensor, want: torch.Tensor, what: str) -> np.ndarray:
        """Each row's distance in float32 ulps (the statistics are >= 0),
        after checking that NaN rows are NaN on both sides."""
        g, w = got.cpu().numpy(), want.cpu().numpy()
        nan = np.isnan(w)
        check(np.array_equal(np.isnan(g), nan), f"{what}: NaN rows differ")
        d = np.zeros(len(w), np.int64)
        d[~nan] = np.abs(g[~nan].view(np.int32).astype(np.int64)
                         - w[~nan].view(np.int32).astype(np.int64))
        return d

    def compare(what, x, y, bound):
        before = ks.ks_2samp_sparse.launches
        got = keeps_device("K4", lambda: ks.ks_2samp_sparse(x, y, bound))
        check(ks.ks_2samp_sparse.launches == before + 1, f"{what}: K4 was not launched")
        want = pooled(x, y)
        d = ulps(got, want, what)
        check(int(d.max(initial=0)) <= 1, f"{what}: K4 {int(d.max())} ulps from the pooled sort")
        equal = int((d == 0).sum())
        rec["rows"] += len(d)
        rec["bit_equal_rows"] += equal
        rec["max_ulp"] = max(rec["max_ulp"], int(d.max(initial=0)))
        print(f"[3d] {what}: {len(d)} rows ({int(torch.isnan(want).sum())} NaN), {equal} "
              f"bit-equal to the pooled sort, the rest within {int(d.max(initial=0))} ulp")
        return got

    # -- crafted rows at the table's width, tracks of the k 9 segments' length
    rng = np.random.default_rng(20)
    N, M = TOTAL, 993
    tracks = (rng.random((8, M)) * 1e-3 + 2.0**-22).astype(np.float32)
    tracks[1, 100:107] = 0.0  # windows holding an N
    tracks[1, 200:203] = -0.0

    def sparse_rows(B, n, values, seed):
        r = np.random.default_rng(seed)
        x = np.zeros((B, N), np.float32)
        for row in x:
            row[r.choice(N, n, replace=False)] = r.choice(values, n)
        return x

    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    bound = 1024  # the k 9 study's padded distinct reads
    cap = ks.capacity(bound, N)
    smooth = rng.random(5000).astype(np.float32) * 2e-3
    ties = np.float32([1 / 3, 1 / 7, 0.25, 1e-3])
    crafted = {
        "ties inside rows": (sparse_rows(4, 900, np.concatenate([ties, smooth[:20]]), 1),
                             tracks[:1]),
        "values equal to track values": (sparse_rows(4, 900, tracks[0], 2), tracks[:1]),
        "track zeros tying the zero run": (sparse_rows(4, 900, tracks[1], 3), tracks[1:2]),
        "all-zero rows": (np.zeros((2, N), np.float32), tracks[:2]),
        "one-nonzero rows": (sparse_rows(4, 1, np.float32([1.0, 1e-3, tracks[0, 5], 1e-9]), 4),
                             tracks[:1]),
        "kept counts at the capacity": (sparse_rows(4, cap, smooth, 5), tracks[:2]),
        "groups of 8 tracks, 16 rows each": (sparse_rows(128, 700, smooth, 6), tracks),
    }
    nan_rows = sparse_rows(6, 500, smooth, 7)
    nan_rows[1, :] = np.nan
    nan_rows[3, N - 1] = np.nan
    nan_rows[4, N // 2] = np.nan
    crafted["NaN rows"] = (nan_rows, tracks[:2])
    for what, (x, y) in crafted.items():
        compare(what, on(x), on(y), bound)
    # the largest capacity in shared memory, and keys past it in global scratch
    compare("kept counts at the largest shared capacity",
            on(sparse_rows(2, ks.SHARED_CAPACITY, smooth, 9)), on(tracks[:1]),
            ks.SHARED_CAPACITY)
    compare("40,000 kept values in a global scratch row",
            on(sparse_rows(2, 40000, smooth, 12)), on(tracks[:2]), 40000)
    dense = rng.random((2, N)).astype(np.float32) * 2e-3 + 2.0**-30
    dense[1, :7] = 0.0
    compare("dense rows under the bound N", on(dense), on(tracks[:1]), N)
    # a row past its bound's capacity reads NaN (the caller broke its bound)
    past = sparse_rows(2, cap + 1, smooth, 10)
    past[1] = sparse_rows(1, cap, smooth, 11)[0]
    got = ks.ks_2samp_sparse(on(past), on(tracks[:1]), bound)
    check(bool(torch.isnan(got[0])) and int(ulps(got[1:], pooled(on(past[1:]), on(tracks[:1])),
                                                 "at the capacity").max()) <= 1,
          "a row past its capacity reads NaN, the row at it its statistic")
    print(f"[3d] a row of {cap + 1} nonzero values under a bound of {bound} (capacity {cap}) "
          f"reads NaN; its neighbour at the capacity its statistic")
    # rows that 16-byte loads cannot take are refused, not read
    x = on(sparse_rows(2, 900, smooth, 8))
    flat = torch.zeros(2 * N + 1, dtype=torch.float32, device=dev)
    for what, rows in (("N 69,903", x[:, 1:].contiguous()),
                       ("rows 4 bytes off a 16-byte boundary", flat[1:].view(2, N))):
        try:
            ks.ks_2samp_sparse(rows, on(tracks[:1]), bound)
            check(False, f"K4 took {what}")
        except ValueError:
            print(f"[3d] {what}: refused")

    # -- own1k.k9's score groups, as the study's runner hands them to K4 -----
    study = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9, coverage_target=40.0,
                             kmer=8, seed=1234, n_orderings=10000)
    segs = [synthetic_genome([1234, i], 1000) for i in range(64)]  # the cell's set, batch 1
    table = load_default_query_table(dev)
    run_experiments_batched(study, segs[:8], dev, table)  # warm
    groups = []  # every group's (rows, tracks, bound): ~10 GB of rows

    def captured_k4(x, y, b):
        groups.append((x, y, b))
        return ks.ks_2samp_sparse(x, y, b)

    def study_run(ks_of_group):
        saved, evaluate.ks_2samp_sparse = evaluate.ks_2samp_sparse, ks_of_group
        try:
            profiling.collect()
            launches = ks.ks_2samp_sparse.launches
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                results = run_experiments_batched(study, segs, dev, table)
            return results, profiling.collect().counters, ks.ks_2samp_sparse.launches - launches
        finally:
            evaluate.ks_2samp_sparse = saved

    res_k, count_k, launched_k = study_run(captured_k4)
    res_p, count_p, launched_p = study_run(lambda x, y, b: pooled(x, y))
    members = [y.shape[0] for _, y, _ in groups]
    check(launched_k == len(groups) > 0 and sum(members) == len(segs) and launched_p == 0
          and count_k["eval.ks_kernel_rows"] == count_k["eval.ks_rows"] > 0,
          f"study runner: K4 launches {launched_k} for groups of {members}, counters {count_k}")
    worst = 0
    for col in ("stat_test_KS_true", "stat_test_KS_random"):
        for rk, rp in zip(res_k, res_p):
            d = ulps(torch.from_numpy(np.asarray(rk.columns[col], np.float32)),
                     torch.from_numpy(np.asarray(rp.columns[col], np.float32)), col)
            worst = max(worst, int(d.max(initial=0)))
    check(worst <= 1, f"study runner KS columns: K4 {worst} ulps from the pooled sort")
    print(f"[3d] study runner, 12:9 x {len(segs)} segments: {launched_k} K4 launches, one a "
          f"score group of {members} members, for "
          f"{count_k['eval.ks_rows']} KS rows (eval.ks_kernel_rows "
          f"{count_k['eval.ks_kernel_rows']}); its KS columns within {worst} ulp of the "
          f"runner with the pooled sort")
    for i, (x, y, b) in enumerate(groups):
        nonzero = int((x.nan_to_num(0.0) != 0).sum(dim=1).max())
        check(nonzero <= b, f"study group {i}: a row holds {nonzero} nonzero entries over {b}")
        compare(f"study group {i}, {y.shape[0]} members x {x.shape[0] // y.shape[0]} rows "
                f"(bound {b}, most nonzero {nonzero})", x, y, b)

    # -- breakscore rows at BASELINE config 1's shape -------------------------
    c = CONFIG1
    k50 = ExperimentConfig(seq_len=c["seq_len"], read_len=c["read_len"], dbg_kmer=c["dbg_kmer"],
                           coverage_target=float(c["coverage"]), kmer=8, seed=1234,
                           n_orderings=c["n_orderings"])
    seg50 = synthetic_genome([1234, 0], c["seq_len"])
    asm = Assembler(k50, dev)
    rs = asm.simulate(torch.from_numpy(encode_dna(seg50)).to(dev), StageTimer(dev, False))
    # the truth as the one real row, every read matched, padded as the runner pads
    pmat, plens, rc, rn, rv = pack_member([seg50], rs.codes, rs.valid, k50.read_chunk)
    x50 = breakscore(torch.from_numpy(pmat).to(dev), torch.from_numpy(plens).to(dev), rc, rn,
                     rv, asm.table.combined, break_kmer=k50.kmer).path_freq
    y50, b50 = rs.track[None].contiguous(), rc.shape[0]
    compare(f"50 kb breakscore rows ({x50.shape[0]} rows, one real; bound {b50}, the real "
            f"row's nonzero entries {int((x50[0] != 0).sum())})", x50, y50, b50)

    # -- time on the study's groups and at the 50 kb shape --------------------
    def row_bytes(x):
        """The bytes K4 must read of x: a real row all of it, a NaN row (the
        padding) its entries up to its first NaN."""
        nan = torch.isnan(x)
        return 4 * int(torch.where(nan.any(dim=1), nan.float().argmax(dim=1) + 1,
                                   x.shape[1]).sum())

    def timed(calls, n_exp):
        """ms an experiment of `calls`, each (x, y, bound), and their byte bound."""
        t = {"events_ms": sum(cuda_ms(lambda: ks.ks_2samp_sparse(x, y, b), 20)
                              for x, y, b in calls) / n_exp,
             "graph_ms": sum(1e-3 * graph_us(lambda: ks.ks_2samp_sparse(x, y, b), 20)
                             for x, y, b in calls) / n_exp,
             "pooled_ms": sum(cuda_ms(lambda: pooled(x, y), 3) for x, y, _ in calls) / n_exp,
             "bound_ms": sum(row_bytes(x) + 4 * (y.numel() + x.shape[0])
                             for x, y, _ in calls) / HBM_BYTES_PER_MS / n_exp,
             "rows": sum(x.shape[0] for x, _, _ in calls) / n_exp,
             "real_rows": sum(int((~torch.isnan(x).any(dim=1)).sum())
                              for x, _, _ in calls) / n_exp}
        t["bound_share"] = t["bound_ms"] / t["graph_ms"]
        return t

    timings = {"own1k.k9 12:9 groups": timed(groups, len(segs)),
               "own50k.config1": timed([(x50, y50, b50)], 1)}
    for shape, t in timings.items():
        print(f"[3d] {shape}, an experiment: {t['rows']:.1f} rows ({t['real_rows']:.1f} real); "
              f"K4 {t['events_ms']:.4f} ms (events), {t['graph_ms']:.4f} ms as a CUDA graph "
              f"(the tracks' sort included); the pooled sort in chunks of {KS_ROWS} "
              f"{t['pooled_ms']:.3f} ms; bound {t['bound_ms']:.4f} ms (bytes), "
              f"{100 * t['bound_share']:.1f}%")
    k9 = timings["own1k.k9 12:9 groups"]
    rec.update(timings=timings, ms=k9["graph_ms"], bound_ms=k9["bound_ms"], bound_by="bytes",
               plain_ms=k9["pooled_ms"], library_ms=None,
               launches=rec.get("launches", 0) + ks.ks_2samp_sparse.launches)


def phase_model(dev) -> dict:
    """[12] `cli fit-model` at full width (k 8, hidden 256, batch 4096, 500
    steps) in process on the card; the trained forward on the card against
    the CPU plain path, and a checkpoint round trip. Returns what [13]
    needs."""
    from contextlib import redirect_stdout
    import io

    from genomeassembler_dev_tpu_torch import cli
    from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
    from genomeassembler_dev_tpu_torch.models import breakage_model as bm

    shutil.rmtree(MODEL_DIR, ignore_errors=True)
    path = os.path.join(MODEL_DIR, "breakage_model.npz")
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        cli.main(["fit-model", "--device", "cuda", "--out", path])
    wall = time.perf_counter() - t0  # the losses' read-back synchronises
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    check(rec["loss_last"] < 0.5 * rec["loss_first"],
          f"fit-model: loss {rec['loss_first']} -> {rec['loss_last']}, not halved")
    model = bm.load_params(path, dev)
    check(tuple(model.w2.shape) == (256, 256), f"fit-model: w2 {tuple(model.w2.shape)}")
    codes = torch.from_numpy(np.random.default_rng(12).integers(0, 4**8, 4096)).to(dev)
    cpu_model = bm.load_params(path, "cpu")
    with torch.no_grad():
        # layer by layer on the same input: the two devices' float32
        # activations may round to neighbouring bf16 values, which must be
        # one bf16 ulp apart; every row's output is held to the CPU's
        # read-out of the card's activations, every row whose bf16
        # activations all equal the CPU's own forward's to that forward
        feats = bm.one_hot_octamer(codes)
        h1 = model.layer1(feats)
        h2 = model.layer2(h1)
        got = model.readout(h2).cpu()
        cpu_h1 = cpu_model.layer1(feats.cpu())
        want = cpu_model.readout(cpu_model.layer2(cpu_h1))
        apart = torch.zeros(len(codes), dtype=torch.bool)
        for mine, theirs, own in ((h1, cpu_h1, cpu_h1),
                                  (h2, cpu_model.layer2(h1.cpu()), cpu_model.layer2(cpu_h1))):
            a, b = bm.round_bf16(mine).cpu(), bm.round_bf16(theirs)
            diff = a != b
            mag = torch.maximum(a.abs(), b.abs())[diff].clamp(min=2.0**-126)
            check(bool(((a - b).abs()[diff] <= 2.0 ** (torch.floor(torch.log2(mag)) - 7)).all()),
                  "fit-model: a card activation more than one bf16 ulp from the CPU's")
            apart |= (a != bm.round_bf16(own)).any(dim=1)
        err_readout = float((got - cpu_model.readout(h2.cpu())).abs().max())
        err = float((got - want).abs()[~apart].max())
        check(err <= 1e-4 and err_readout <= 1e-4 and apart.float().mean() < 0.05,
              f"fit-model: card forward vs CPU plain path: max abs err {err} "
              f"({int(apart.sum())} rows with a bf16 activation rounded apart, read-out "
              f"err {err_readout})")
        again_path = os.path.join(MODEL_DIR, "again.npz")
        bm.save_params(again_path, model)
        check(torch.equal(bm.forward(bm.load_params(again_path, dev), feats).cpu(), got),
              "fit-model: checkpoint round trip changed the outputs")
    # steady-state steps at the same width: the CLI's time above holds the
    # table load, the checkpoint and, in a fresh process, CUDA's start-up
    target = torch.log(load_default_query_table(dev).probs[8].to(torch.float32))[codes]
    step = bm.make_train_step(bm.adam(model, 3e-3))
    step(model, codes, target)
    step_ms = cuda_ms(lambda: step(model, codes, target), 50)
    print(f"[12] fit-model k 8, hidden 256, batch 4096, 500 steps: {wall:.3f} s "
          f"({500 / wall:.1f} steps/s, table load and checkpoint included); loss "
          f"{rec['loss_first']:.4f} -> {rec['loss_last']:.4f}; card forward on 4,096 codes "
          f"within {err:.2e} of the CPU plain path ({int(apart.sum())} rows with an "
          f"activation one bf16 ulp apart, within {err_readout:.2e} of the CPU's read-out of "
          "the card's activations); checkpoint round trip equal")
    print(f"[12] a training step at the same width, steady state: {step_ms:.3f} ms "
          f"({1e3 / step_ms:.1f} steps/s, CUDA events over 50 steps)")
    return {"path": path}


def study_group(dev, cfg, segments: list[str]):
    """One batched-runner score group of the given segments at `cfg`: each
    one's solutions (Assembler.run_experiment) padded to shared [G, S, L],
    its distinct reads to [G, U, R], as pipeline/batch_runner.py packs them;
    with the segments [G, L] and the read tracks [G, W]."""
    from genomeassembler_dev_tpu_torch.core.encoding import INVALID, encode_dna
    from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
    from genomeassembler_dev_tpu_torch.pipeline.evaluate import pack_member
    from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

    asm = Assembler(cfg, dev)
    packed, genomes, tracks = [], [], []
    for seg in segments:
        genome = torch.from_numpy(encode_dna(seg)).to(dev)
        rs = asm.simulate(genome, StageTimer(dev, False))
        packed.append(pack_member(asm.run_experiment(seg).columns["sequence"], rs.codes,
                                  rs.valid, cfg.read_chunk))
        genomes.append(genome)
        tracks.append(rs.track)
    G = len(segments)
    S, L = (max(p[0].shape[i] for p in packed) for i in (0, 1))
    U = max(p[2].shape[0] for p in packed)
    pm = np.full((G, S, L), INVALID, np.uint8)
    pl = np.zeros((G, S), np.int32)
    rc = torch.zeros((G, U, cfg.read_len), dtype=torch.uint8, device=dev)
    rn = torch.zeros((G, U), dtype=torch.int32, device=dev)
    rv = torch.zeros((G, U), dtype=torch.bool, device=dev)
    for g, (pmat, plens, codes, counts, valid) in enumerate(packed):
        pm[g, : pmat.shape[0], : pmat.shape[1]] = pmat
        pl[g, : plens.shape[0]] = plens
        rc[g, : codes.shape[0]], rn[g, : counts.shape[0]], rv[g, : valid.shape[0]] = (
            codes, counts, valid)
    return (torch.from_numpy(pm).to(dev), torch.from_numpy(pl).to(dev), rc, rn, rv,
            torch.stack(genomes), torch.stack(tracks))


def phase_parallel(dev, record: dict, model: dict) -> None:
    """[13] the parallel layer on one card: a one-rank NCCL group, then the
    sharded steps, the train step, the table lookup, both rings, the batched
    runner with a mesh and `cli bench-scaling --devices 1`, each against its
    unsharded counterpart. K1's and K2's launches while the layer's paths run
    are added to the kernel record; the comparisons come after the count."""
    from contextlib import redirect_stdout
    import io

    import torch.distributed as dist

    from genomeassembler_dev_tpu_torch import cli
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
    from genomeassembler_dev_tpu_torch.models import breakage_model as bm
    from genomeassembler_dev_tpu_torch.ops import myers
    from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein
    from genomeassembler_dev_tpu_torch.ops.edit_distance_ring import (
        make_ring_levenshtein, make_ring_levenshtein_myers)
    from genomeassembler_dev_tpu_torch.ops.histogram import (
        count_kmers_batched, count_kmers_batched_plain)
    from genomeassembler_dev_tpu_torch.ops.ks import batched_ks_2samp, ks_2samp_sparse
    from genomeassembler_dev_tpu_torch.ops.prefix_min import batched_levenshtein_prefix_min
    from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
    from genomeassembler_dev_tpu_torch.parallel import multihost, sharding
    from genomeassembler_dev_tpu_torch.parallel.table_sharding import make_sharded_table_lookup
    from genomeassembler_dev_tpu_torch.pipeline.assembler import RESULT_COLUMNS
    from genomeassembler_dev_tpu_torch.pipeline.evaluate import pack_strings
    from genomeassembler_dev_tpu_torch.pipeline.batch_runner import run_experiments_batched
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.score.breakscore import breakscore
    from genomeassembler_dev_tpu_torch.sim.reads import n_draws_for
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store

    os.makedirs(os.path.dirname(NCCL_STORE), exist_ok=True)
    if os.path.exists(NCCL_STORE):
        os.remove(NCCL_STORE)
    t0 = time.perf_counter()
    multihost.initialize(f"file://{NCCL_STORE}", 1, 0, device_type="cuda")
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    mesh = multihost.global_mesh(device_type="cuda")
    print(f"[13] {dist.get_backend()} group of 1 rank and its (1, 1, 1) mesh in "
          f"{time.perf_counter() - t0:.3f} s")
    table = load_default_query_table(dev)
    probs8 = table.probs[8].to(torch.float32)
    base = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9, kmer=8, coverage_target=40.0,
                            seed=1234, n_orderings=10000)
    segs = synthetic_segment_store(1234, 1000, PARALLEL_SEGMENTS).seqs
    genomes = torch.from_numpy(np.stack([encode_dna(s) for s in segs])).to(dev)
    seeds = torch.arange(PARALLEL_SEGMENTS, dtype=torch.int32, device=dev)
    n_draws = n_draws_for(40.0, 1000, 12)
    group = study_group(dev, base, list(segs[:4]))
    pm, pl, rc, rn, rv, gm, tracks = group
    rng = np.random.default_rng(13)
    codes = torch.from_numpy(rng.integers(0, 4**8, (4, 4096))).to(dev)
    # the rings' cases: [64, 2048] x 1000 NW and [16, 512] x 5,000 HW
    seg = segs[0]
    sols = [mutate(rng, seg[int(a):], 0.02)[:1030] for a in rng.integers(0, 600, 64)]
    mat, lens = pack_strings(sols, l_multiple=2048)
    nw_args = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
               torch.from_numpy(encode_dna(seg)).to(dev))
    long_target = rand_dna(rng, 5000)
    hw_q = [mutate(rng, long_target[int(a) : int(a) + 500], 0.03)[:512]
            for a in rng.integers(0, 4500, 16)]
    mat, lens = pack_strings(hw_q, l_multiple=512)
    hw_args = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
               torch.from_numpy(encode_dna(long_target)).to(dev))
    batch_cfg = base.with_(read_len=12, dbg_kmer=9)
    run_experiments_batched(batch_cfg, list(segs), dev, table)  # warm, before the count
    model_cpu = bm.load_params(model["path"], "cpu")
    train_codes = torch.from_numpy(rng.integers(0, 4**8, 4096)).to(dev)
    train_target = torch.log(probs8)[train_codes]

    # -- the layer's paths, counted ------------------------------------------
    torch.cuda.synchronize()
    myers.batched_levenshtein_myers.launches = 0
    count_kmers_batched.launches = 0
    batched_levenshtein_prefix_min.launches = 0
    ks_2samp_sparse.launches = 0
    t_path = time.perf_counter()
    sim_step = sharding.make_sim_count_step(mesh, 12, n_draws, 8)
    counts = sim_step(genomes, seeds, probs8)
    bs_step = sharding.make_breakscore_step(mesh)
    bs = bs_step(pm, pl, rc, rn, rv, table.combined)
    ks = sharding.make_ks_step(mesh)(bs["path_freq"], tracks, rc.shape[1])
    lev = sharding.make_lev_step(mesh)(pm, pl, gm)
    local = sharding.shard_params(mesh, bm.load_params(model["path"], dev))
    train = sharding.make_sharded_train_step(mesh, bm.adam(local, 3e-3))
    loss = train(local, train_codes, train_target)
    looked, overflow = make_sharded_table_lookup(mesh, 4**8)(codes, probs8)
    rings = {}
    for kind, maker in (("prefix-min", make_ring_levenshtein),
                        ("myers", make_ring_levenshtein_myers)):
        for shape, mode, args in (("64x2048x1000", "NW", nw_args),
                                  ("16x512x5000", "HW", hw_args)):
            fn = maker(mesh, "read", mode)
            start = time.perf_counter()
            rings[(kind, shape)] = (fn(*args), mode, args)
            torch.cuda.synchronize()
            rings[(kind, shape)] += (time.perf_counter() - start,)
    start = time.perf_counter()
    batched = run_experiments_batched(batch_cfg, list(segs), dev, table, mesh=mesh)
    mesh_runner_s = time.perf_counter() - start
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["bench-scaling", "--device", "cuda", "--devices", "1", "--seq-len", "1000",
                  "--draws-per-segment", str(n_draws), "--segments-per-device",
                  str(PARALLEL_SEGMENTS)])
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = {"myers_levenshtein": myers.batched_levenshtein_myers.launches,
                "kmer_histogram": count_kmers_batched.launches,
                "ks_sparse": ks_2samp_sparse.launches}
    check(batched_levenshtein_prefix_min.launches == 0, "prefix-min launched by the layer")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the parallel layer")
        record[name]["launches"] += n
        record[name]["parallel_launches"] = n
    print(f"[13] the layer's paths in {path_s:.3f} s; launches: Myers "
          f"{launches['myers_levenshtein']}, histogram {launches['kmer_histogram']}, KS "
          f"{launches['ks_sparse']}")

    # -- each against its unsharded counterpart ------------------------------
    rs = sharding.simulate_read_shard(genomes, seeds, probs8, 12, n_draws, 0)
    wc, wv = kmer_window_codes(rs.codes, 8)
    wv = (wv & rs.valid[..., None]).reshape(PARALLEL_SEGMENTS, -1)
    wc = wc.reshape(PARALLEL_SEGMENTS, -1)
    check(torch.equal(counts, count_kmers_batched(wc, wv, 4**8)), "sim+count != K2 unsharded")
    check(torch.equal(counts, count_kmers_batched_plain(wc, wv, 4**8)), "sim+count != plain")
    sim_ms = cuda_ms(lambda: sim_step(genomes, seeds, probs8), 5)
    print(f"[13] sim+count step, B {PARALLEL_SEGMENTS} x 1,000 bases, {n_draws} draws, k 8: "
          f"equal to K2's unsharded count and the plain count of the same reads; "
          f"{sim_ms:.3f} ms a step")

    want = breakscore(pm, pl, rc, rn, rv, table.combined)
    check(torch.equal(bs["kmer_breaks"], want.kmer_breaks), "breakscore step: kmer_breaks")
    for name in ("bp_score", "bp_score_norm_by_break_freqs", "bp_score_norm_by_len",
                 "path_freq", "site_counts"):
        check(torch.allclose(bs[name], getattr(want, name), rtol=RTOL, atol=0, equal_nan=True),
              f"breakscore step: {name}")
    ks_want = torch.stack([batched_ks_2samp(pf, tr) for pf, tr in zip(want.path_freq, tracks)])
    check(torch.allclose(ks, ks_want, rtol=0, atol=1e-6, equal_nan=True), "KS step")
    lev_want = torch.stack([batched_levenshtein(a, b, g) for a, b, g in zip(pm, pl, gm)])
    check(torch.equal(lev, lev_want), "Levenshtein step != plain DP")
    step_ms = {"breakscore": cuda_ms(lambda: bs_step(pm, pl, rc, rn, rv, table.combined), 5),
               "ks": cuda_ms(lambda: sharding.make_ks_step(mesh)(bs["path_freq"], tracks,
                                                                 rc.shape[1]), 5),
               "lev": cuda_ms(lambda: sharding.make_lev_step(mesh)(pm, pl, gm), 5)}
    print(f"[13] breakscore, KS and Levenshtein steps on one group {tuple(pm.shape)} with "
          f"{rc.shape[1]} reads: equal to the unsharded calls (breaks and distances exact, "
          f"scores rtol 2e-5); ms a step: " + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items()))

    ref = bm.params_from_numpy(bm.params_to_numpy(model_cpu), dev)
    ref_loss = bm.make_train_step(bm.adam(ref, 3e-3))(ref, train_codes, train_target)
    check(abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)),
          f"train step loss {float(loss)} != unsharded {float(ref_loss)}")
    for name in bm.PARAM_NAMES:
        a, b = getattr(local, name), getattr(ref, name)
        check(torch.allclose(a.grad, b.grad, rtol=2.0**-7, atol=0), f"train step grad {name}")
        check(torch.allclose(a, b, rtol=0, atol=1e-5), f"train step {name}")
    train_ms = cuda_ms(lambda: train(local, train_codes, train_target), 20)
    print(f"[13] sharded train step (hidden 256, batch 4096): loss {float(loss):.5f}, equal to "
          f"[12]'s unsharded step within rtol 1e-5, grads within 2^-7, parameters within 1e-5; "
          f"{train_ms:.3f} ms a step")

    check(int(overflow) == 0 and torch.equal(looked, probs8[codes]), "table lookup != gather")
    print("[13] sharded table lookup [4, 4096] equal to a direct gather, no overflow")

    ring_rec = {}
    for (kind, shape), (got, mode, args, secs) in rings.items():
        k1 = myers.batched_levenshtein_myers(*args, mode=mode)
        check(torch.equal(got, k1), f"{kind} ring {shape} {mode} != K1")
        k1_ms = cuda_ms(lambda: myers.batched_levenshtein_myers(*args, mode=mode), 5)
        ring_rec[f"{kind} {shape} {mode}"] = {"ring_ms": 1e3 * secs, "k1_ms": k1_ms}
        print(f"[13] {kind} ring at one shard, {shape} {mode}: equal to K1; ring "
              f"{1e3 * secs:.1f} ms (a Python loop of {args[2].shape[0] + 1} wavefront steps), "
              f"K1 {k1_ms:.3f} ms")
    record["myers_levenshtein"]["rings_one_shard"] = ring_rec

    start = time.perf_counter()
    plain_runner = run_experiments_batched(batch_cfg, list(segs), dev, table)
    runner_s = time.perf_counter() - start
    check(len(batched) == len(plain_runner) == PARALLEL_SEGMENTS, "runner: result count")
    for i, (a, b) in enumerate(zip(batched, plain_runner)):
        check(a.stats == b.stats and a.columns["sequence"] == b.columns["sequence"],
              f"runner exp {i}: solutions or stats")
        for col in RESULT_COLUMNS[1:]:
            x, y = np.asarray(a.columns[col]), np.asarray(b.columns[col])
            check(np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f"runner exp {i}: {col}")
    print(f"[13] run_experiments_batched with the mesh, row 12:9 x {PARALLEL_SEGMENTS}: every "
          f"artifact equal to mesh=None; {mesh_runner_s:.3f} s with it, {runner_s:.3f} s without")

    pts = json.loads(out.getvalue().strip().splitlines()[-1])
    check([p["devices"] for p in pts] == [1] and pts[0]["reads_per_s"] > 0, f"bench {pts}")
    print(f"[13] bench-scaling --devices 1 at the study shape ({PARALLEL_SEGMENTS} x 1,000 "
          f"bases, {n_draws} draws a segment): {pts[0]['reads_per_s']} reads/s")
    record["kmer_histogram"]["parallel"] = {"sim_count_ms": sim_ms,
                                            "bench_scaling_reads_per_s": pts[0]["reads_per_s"]}
    record["myers_levenshtein"]["parallel_steps_ms"] = step_ms
    dist.destroy_process_group()
    print(f"[13] steps: train {train_ms:.3f} ms; process group destroyed")


def phase_repeat_velvet(dev, record: dict) -> None:
    """[8] a repeat-heavy velvet experiment end to end: run_velvet_study (as
    `study-velvet` runs it) on one 50 kb segment with planted repeats at
    REPEAT_ROW, on the contigs an error-free velvet run would give: the
    unitigs of the segment's dBG at the row's k, which end at every repeat
    and overlap by k - 1. The ensemble then merges into many solutions,
    which IndustryAssembler.evaluate cuts into at least two chunks. Every
    solution's scores must not depend on where the chunks fall: the run's
    evaluate is held against one with the chunks at other rows, and its
    first 64 rows against their evaluate alone."""
    from genomeassembler_dev_tpu_torch.merge import native
    from genomeassembler_dev_tpu_torch.ops import myers
    from genomeassembler_dev_tpu_torch.ops.prefix_min import batched_levenshtein_prefix_min
    from genomeassembler_dev_tpu_torch.pipeline import results as res_io
    from genomeassembler_dev_tpu_torch.pipeline import evaluate as evaluation
    from genomeassembler_dev_tpu_torch.pipeline import velvet
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.pipeline.experiments import run_velvet_study
    from genomeassembler_dev_tpu_torch.sim.segments import (
        read_fasta, synthetic_segment_store, write_fasta)

    t_phase = time.perf_counter()
    shutil.rmtree(REPEAT_DIR, ignore_errors=True)
    segs = synthetic_segment_store(1234, VELVET_LEN, 1, repeats=True)
    segment = segs.seqs[0]
    read_len, k = REPEAT_ROW
    unitigs = native.contigs_from_reads_native(
        [segment[i : i + UNITIG_READ] for i in range(VELVET_LEN - UNITIG_READ + 1)], k)
    contigs_path = os.path.join(REPEAT_DIR, "contigs", "contigs_exp_1.fa")
    write_fasta(contigs_path, {f"NODE_{j + 1}": c for j, c in enumerate(unitigs)})
    base = ExperimentConfig(seq_len=VELVET_LEN, read_len=12, kmer=8, coverage_target=40.0,
                            seed=1234, industry_standard=True,
                            velvet_n_orderings=REPEAT_ORDERINGS)
    seen = []
    evaluate = velvet.IndustryAssembler.evaluate

    def spy(self, solutions, rs, genome):
        seen.append((self, solutions, rs, genome, evaluate(self, solutions, rs, genome)))
        return seen[-1][-1]

    velvet.IndustryAssembler.evaluate = spy
    torch.cuda.synchronize()
    myers.batched_levenshtein_myers.launches = 0
    t0 = time.perf_counter()
    run_velvet_study(REPEAT_DIR, segs,
                     lambda asm, seg, ind: list(read_fasta(contigs_path).values()),
                     dev, base=base, grid=(REPEAT_ROW,), total_iters=1)
    torch.cuda.synchronize()
    study_s = time.perf_counter() - t0
    velvet.IndustryAssembler.evaluate = evaluate
    chunks = myers.batched_levenshtein_myers.launches  # one launch a chunk
    record["myers_levenshtein"]["launches"] += chunks
    ((asm, sols, rs, genome, ev),) = seen
    n = len(sols)
    width = -(-max(map(len, sols)) // 128) * 128
    n_reads = evaluation.pack_reads(rs.codes, rs.valid, asm.config.read_chunk)[0].shape[0]
    rows = evaluation.eval_chunk_rows(width, n_reads, rs.track.shape[0])
    check(chunks == -(-n // rows) >= 2,
          f"repeat velvet: {n} solutions, {rows} rows a chunk, {chunks} chunks")
    cfg = base.with_(read_len=read_len, dbg_kmer=k)
    cols = res_io.load_result_columns(res_io.solutions_path(REPEAT_DIR, 1, cfg))
    with open(res_io.stats_path(REPEAT_DIR, 1, cfg)) as f:
        timings = json.load(f)["timings"]
    row_of = {s: i for i, s in enumerate(sols)}
    kept = [row_of[s] for s in cols["sequence"]]
    check(len(kept) >= 1 and all(segment.find(s) != -1 for s in cols["sequence"])
          and sum(segment.find(s) != -1 for s in sols) == len(kept), "repeat velvet: kept rows")
    for col, key in (("lev_dist_vs_true", "lev"), ("kmer_breaks", "kmer_breaks"),
                     ("bp_score_true", "bp_score"), ("stat_test_KS_true", "ks")):
        check(np.array_equal(cols[col], ev[key][kept], equal_nan=key == "ks"),
              f"repeat velvet: the table's {col} != its evaluate's")
    check(bool((cols["lev_dist_vs_true"] == 0).all()), "repeat velvet: a kept row's HW distance")

    budget = evaluation.EVAL_BUDGET_BYTES
    evaluation.EVAL_BUDGET_BYTES = budget * 5 // 8
    other = evaluation.eval_chunk_rows(width, n_reads, rs.track.shape[0])
    check(other % 64 == 0 and rows % other != 0 and -(-n // other) > chunks,
          f"repeat velvet: {other} rows a chunk do not move the boundaries")
    t0 = time.perf_counter()
    ev_other = asm.evaluate(sols, rs, genome)
    torch.cuda.synchronize()
    other_s = time.perf_counter() - t0
    evaluation.EVAL_BUDGET_BYTES = budget
    ev_64 = asm.evaluate(sols[:64], rs, genome)
    exact = []
    for key, got in ev.items():
        for what, want, part in (("other chunks", ev_other[key], got),
                                 ("the first 64 alone", ev_64[key], got[:64])):
            if key in ("kmer_breaks", "lev"):
                check(np.array_equal(part, want), f"repeat velvet {key}: {what}")
            else:
                check(np.allclose(part, want, rtol=RTOL, atol=0, equal_nan=True),
                      f"repeat velvet {key}: {what}")
                exact.append(np.array_equal(part, want, equal_nan=True))
    mat, lens = evaluation.pack_strings(sols[:64])
    batched_levenshtein_prefix_min.launches = 0
    k3 = batched_levenshtein_prefix_min(torch.from_numpy(mat).to(dev),
                                        torch.from_numpy(lens).to(dev), genome, mode="HW")
    check(batched_levenshtein_prefix_min.launches == 1, "repeat velvet: the prefix-min launch")
    record["prefix_min_levenshtein"]["launches"] += batched_levenshtein_prefix_min.launches
    check(np.array_equal(k3.cpu().numpy(), ev["lev"][:64]),
          "repeat velvet: the first 64 HW distances != the prefix-min kernel")
    phase_s = time.perf_counter() - t_phase
    record["myers_levenshtein"]["repeat_velvet"] = {
        "orderings": REPEAT_ORDERINGS, "unitigs": len(unitigs), "solutions": n,
        "chunk_rows": rows, "chunks": chunks, "kept": len(kept), "study_s": study_s,
        "timings_s": timings, "phase_s": phase_s}
    print(f"[8] repeat-heavy velvet experiment, row {read_len}:{k} on a 50 kb repeat segment: "
          f"{len(unitigs)} unitig contigs, {REPEAT_ORDERINGS} orderings -> "
          f"{n} solutions (longest "
          f"{width} columns), {chunks} evaluation chunks of {rows} rows (Myers launches "
          f"{chunks}); {len(kept)} kept, each in the segment at HW distance 0; run_velvet_study "
          f"{study_s:.3f} s, stage ms: " + ", ".join(
              f"{name} {1e3 * t:.2f}" for name, t in timings.items()))
    print(f"[8] repeat-heavy velvet: the {n} solutions' scores equal an evaluate in "
          f"{-(-n // other)} chunks of {other} rows ({other_s:.3f} s) and the first 64 their "
          f"evaluate alone (breaks and distances exact, floats rtol 2e-5, "
          f"{'all bit-equal' if all(exact) else 'not all bit-equal'}); the first 64 HW "
          f"distances equal the prefix-min kernel; phase {phase_s:.1f} s"
          + (" (over 60 s)" if phase_s > 60 else ""))


def phase_plots(dev, record: dict) -> None:
    """[14] `run --plots` on one study-shape experiment (row 12:9, 1 kb) on
    the card: the track and the re-drawn breakpoints it plots come from the
    card, and are held against the CPU's plain track and the experiment's
    own reads. The figures are drawn where matplotlib is installed."""
    from contextlib import redirect_stdout
    from importlib.util import find_spec
    import io

    from genomeassembler_dev_tpu_torch import cli
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
    from genomeassembler_dev_tpu_torch.ops import myers
    from genomeassembler_dev_tpu_torch.pipeline import experiments
    from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.sim.reads import probability_track
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store

    shutil.rmtree(PLOTS_DIR, ignore_errors=True)
    drawing = find_spec("matplotlib") is not None
    drawn = []  # every ReadSet that Assembler.simulate returns in this phase
    simulate = Assembler.simulate

    def spy(self, genome, timer):
        drawn.append(simulate(self, genome, timer))
        return drawn[-1]

    Assembler.simulate = spy
    out = io.StringIO()
    torch.cuda.synchronize()
    myers.batched_levenshtein_myers.launches = 0
    t0 = time.perf_counter()
    with redirect_stdout(out):
        cli.main(["run", "--synthetic", "--seq-len", "1000", "--total-iters", "1", "--read-len",
                  "12", "--dbg-kmer", "9", "--workdir", PLOTS_DIR, "--device", "cuda"]
                 + (["--plots"] if drawing else []))
    run_s = time.perf_counter() - t0
    check(myers.batched_levenshtein_myers.launches == 1, "plots: the run's Myers launch")
    record["myers_levenshtein"]["launches"] += 1
    cfg = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9, kmer=8, coverage_target=40.0,
                           seed=1234, n_orderings=10000)
    segment = synthetic_segment_store(1234, 1000, 1).seqs[0]
    track, positions = experiments.plot_inputs(Assembler(cfg, dev), segment)
    Assembler.simulate = simulate
    check(len(drawn) == (3 if drawing else 2), f"plots: {len(drawn)} read draws")
    own = drawn[0].positions[drawn[0].valid].cpu().numpy()
    for rs in drawn[1:]:
        check(rs.positions.device.type == "cuda", "plots: the re-drawn reads are not the card's")
        check(np.array_equal(rs.positions[rs.valid].cpu().numpy(), own),
              "plots: re-drawn breakpoints != the experiment's reads")
    check(np.array_equal(positions, own) and len(own) > 0, "plots: plot_inputs' breakpoints")
    cpu_track = probability_track(torch.from_numpy(encode_dna(segment)),
                                  load_default_query_table("cpu").probs[8], 8).numpy()
    check(track.shape == cpu_track.shape == (993,) and np.allclose(track, cpu_track, rtol=RTOL,
                                                                    atol=0),
          "plots: the card's track != the CPU plain track")
    print(f"[14] run row 12:9, 1 kb: the card's probability track ({track.shape[0]} windows) "
          f"equals the CPU plain track within rtol 2e-5; the {len(own)} breakpoints re-drawn "
          f"on the card equal the experiment's reads; {run_s:.3f} s for the command")
    if not drawing:
        print("[14] drawing not run: matplotlib is absent on this machine (the device part "
              "above ran as --plots runs it)")
        return
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    from matplotlib.image import imread

    for path, name in zip(rec["plots"], ("ProbabilityTrack", "BreakpointHistogram",
                                         "ScoresVsLevDist")):
        check(os.path.basename(path).startswith(name + "_"), f"plots: {path}")
        img = imread(path)
        check(img.ndim == 3 and min(img.shape[:2]) > 100, f"plots: {path} {img.shape}")
    print(f"[14] --plots drew {len(rec['plots'])} figures, each decodes: "
          + ", ".join(os.path.basename(p) for p in rec["plots"]))


def phase_trace(dev, record: dict, k2_args, k3_args) -> None:
    """[15] a device trace (utils/profiling.py) of one study-shape experiment
    with an annotation around each stage, then one K2 and one K3 call.
    Every launch of K1, K2, K3 and K4 must be a kernel event of that name
    whose launch lies inside its annotation (K1's and K4's: evaluate). Prints the device busy share of the
    experiment's window, its top five device operations and the trace."""
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.ops import myers
    from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers_batched
    from genomeassembler_dev_tpu_torch.ops.ks import ks_2samp_sparse
    from genomeassembler_dev_tpu_torch.ops.prefix_min import batched_levenshtein_prefix_min
    from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_genome
    from genomeassembler_dev_tpu_torch.utils.profiling import annotate, trace
    from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    cfg = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9, coverage_target=40.0,
                           kmer=8, seed=1234, n_orderings=10000)
    asm = Assembler(cfg, dev)
    segment = synthetic_genome(1000, 1000)  # [5]'s first experiment
    want = asm.run_experiment(segment).columns  # warm, untraced
    counters = {"myers_levenshtein": myers.batched_levenshtein_myers,
                "kmer_histogram": count_kmers_batched,
                "prefix_min_levenshtein": batched_levenshtein_prefix_min,
                "ks_sparse": ks_2samp_sparse}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    stages = ("simulate", "dBG", "merge", "evaluate")
    with trace(TRACE_DIR):
        with annotate("experiment"):
            timer = StageTimer(dev, False)  # each stage ends in a synchronise
            genome = torch.from_numpy(encode_dna(segment)).to(dev)
            with annotate("simulate"):
                rs = asm.simulate(genome, timer)
            with annotate("dBG"):
                contigs = asm.contigs(rs.codes, rs.valid, timer)
            with annotate("merge"):
                sols = asm.merge(contigs, timer)
            with annotate("evaluate"):
                cols = asm.score(sols, rs, genome, timer)
        with annotate("K2"):
            count_kmers_batched(*k2_args)
        with annotate("K3"):
            batched_levenshtein_prefix_min(*k3_args)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    check(cols["sequence"] == want["sequence"] and np.array_equal(
        cols["lev_dist_vs_true"], want["lev_dist_vs_true"]), "trace: traced experiment != untraced")
    path, events = trace_events(TRACE_DIR)
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"}
    check(set(stages) | {"experiment", "K2", "K3"} <= spans.keys(), f"trace: spans {list(spans)}")
    launch_of = {e["args"]["correlation"]: e for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get(
                     "args", {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    found = {}
    for name, symbol in KERNEL_NAMES.items():
        span = spans[{"myers_levenshtein": "evaluate", "kmer_histogram": "K2",
                      "prefix_min_levenshtein": "K3", "ks_sparse": "evaluate"}[name]]
        mine = [e for e in device if e.get("cat") == "kernel" and symbol in e["name"]]
        inside = [e for e in mine if span[0] <= launch_of.get(
            e["args"].get("correlation"), {"ts": -1})["ts"] <= span[1]]
        found[name] = len(inside)
        check(launches[name] >= 1 and len(mine) == len(inside) == launches[name],
              f"trace: {name}: {launches[name]} launches, {len(mine)} kernel events named "
              f"{symbol}, {len(inside)} launched inside their span")
        record[name]["traced_launches"] = launches[name]
    lo, hi = spans["experiment"]
    busy, top, _ = device_busy(device, lo, hi)
    print(f"[15] traced experiment (row 12:9, {len(sols)} solutions) equals its untraced run; "
          f"kernel events inside their spans: " + ", ".join(
              f"{KERNEL_NAMES[n]} {found[n]} of {launches[n]} launches" for n in found))
    print(f"[15] device busy {busy / (hi - lo):.4f} of the experiment's {(hi - lo) / 1e3:.3f} ms "
          f"window ({busy / 1e3:.3f} ms); stage spans ms: " + ", ".join(
              f"{st} {(spans[st][1] - spans[st][0]) / 1e3:.3f}" for st in stages))
    for name, us in top:
        print(f"[15] top device op: {us / 1e3:.3f} ms  {name[:110]}")
    print(f"[15] trace: {os.path.relpath(path, HERE)} ({os.path.getsize(path)} bytes)")
    record["myers_levenshtein"]["trace"] = {
        "busy_share": busy / (hi - lo), "window_ms": (hi - lo) / 1e3,
        "top_ops_ms": [[name[:80], us / 1e3] for name, us in top], "file": path}


def trace_events(logdir: str) -> tuple[str, list[dict]]:
    """The one trace file under logdir and its events."""
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        return path, json.load(f)["traceEvents"]


def device_busy(device: list[dict], lo: float, hi: float):
    """Of the device events (kernels, copies, sets) within [lo, hi] us: the
    us the card was busy (the union of their intervals), the five device
    operations that took most of it by name, and how many events fell in."""
    cuts = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device
                  if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for a, b in cuts:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_op: dict[str, float] = {}
    for a, b, e in ((max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e) for e in device):
        if b > a:
            by_op[e["name"]] = by_op.get(e["name"], 0.0) + b - a
    return busy, sorted(by_op.items(), key=lambda kv: -kv[1])[:5], len(cuts)


def phase_bench(dev, record: dict) -> None:
    """[16] the port's headline bench (genomeassembler_dev_tpu_torch/bench.py)
    at full size, B 1024 x 1 kb with 256 queries at HW: its fatal gates hold
    the step against the native engine (octamer totals of every segment, the
    contig sets and octamer counts of 8), and its JSON line is printed. Then
    K2 at the step's shape, [1024, 16,670], against its plain version,
    timed beside torch.bincount; K1 on the bench's NW inputs (256 x 1024 x
    1000) against the plain DP; and a device trace of one step: the card's
    busy share of it and its top device operations."""
    from genomeassembler_dev_tpu_torch import bench
    from genomeassembler_dev_tpu_torch.ops import myers
    from genomeassembler_dev_tpu_torch.ops.edit_distance import (
        batched_levenshtein, batched_levenshtein_auto)
    from genomeassembler_dev_tpu_torch.ops.histogram import (
        count_kmers_batched, count_kmers_batched_plain)
    from genomeassembler_dev_tpu_torch.utils.profiling import annotate, trace

    B, L = 1024, 1000
    torch.cuda.synchronize()
    count_kmers_batched.launches = 0
    myers.batched_levenshtein_myers.launches = 0
    t0 = time.perf_counter()
    payload = bench.run(dev, B, L)
    wall = time.perf_counter() - t0
    k2, k1 = count_kmers_batched.launches, myers.batched_levenshtein_myers.launches
    check(k2 > 0 and k1 > 0, f"the bench launched K2 {k2} and K1 {k1} times")
    record["kmer_histogram"]["launches"] += k2
    record["myers_levenshtein"]["launches"] += k1
    check(payload["metric"] == bench.METRIC and payload["value"] > 0
          and np.isfinite(payload["vs_baseline"]), f"bench payload {payload}")
    print(json.dumps(payload))
    print(f"[16] bench B {B} x {L}: {payload['value']:.1f} reads/s, vs_baseline "
          f"{payload['vs_baseline']:.3f} (median of "
          f"{', '.join(f'{r:.2f}' for r in payload['extras']['ratio_pairs'])}); gates "
          f"passed; K2 launches {k2}, K1 launches {k1}; {wall:.1f} s")

    rec = record["kmer_histogram"]
    codes, valid = bench.simulate_inputs(B, L, dev)
    oc, ov = bench.octamer_windows(codes, valid)
    got = keeps_device("K2", lambda: count_kmers_batched(oc, ov, 4**8))
    want = count_kmers_batched_plain(oc, ov, 4**8)
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got, want))
    check(torch.equal(got, want), f"bench shape {tuple(oc.shape)}: histogram kernel != plain")
    flat = (torch.arange(B, device=dev)[:, None] * 4**8 + oc.long())[ov]
    shape = {"B": B, "N": oc.shape[1],
             "ms": 1e-3 * graph_us(lambda: count_kmers_batched(oc, ov, 4**8), 20),
             "host_loop_ms": cuda_ms(lambda: count_kmers_batched(oc, ov, 4**8), 20),
             "plain_ms": cuda_ms(lambda: count_kmers_batched_plain(oc, ov, 4**8), 5),
             "library_ms": cuda_ms(lambda: torch.bincount(flat, minlength=B * 4**8), 20),
             "bound_ms": bytes_bound_ms(oc, ov, got), "bound_by": "bytes", "launches": k2}
    rec["bench_shape"] = shape
    print(f"[16] K2 at the step's shape {tuple(oc.shape)}, k 8: equal to the plain version; "
          f"kernel {shape['ms']:.4f} ms as a CUDA graph ({shape['host_loop_ms']:.4f} ms by "
          f"events over calls), torch.bincount {shape['library_ms']:.4f} ms, plain "
          f"{shape['plain_ms']:.3f} ms; bound {shape['bound_ms']:.4f} ms (bytes), share "
          f"{shape['bound_ms'] / shape['ms']:.3f}")

    (mode, qs, qlen, tgt), _ = bench.lev_cases(B, L, dev)
    got = keeps_device("K1", lambda: batched_levenshtein_auto(qs, qlen, tgt, mode=mode))
    want = batched_levenshtein(qs, qlen, tgt, mode=mode)
    record["myers_levenshtein"]["max_abs_err"] = max(
        record["myers_levenshtein"]["max_abs_err"], max_err(got, want))
    check(torch.equal(got, want), f"bench's {mode} {tuple(qs.shape)} x {tgt.shape[0]}: "
          "Myers kernel != plain DP")
    print(f"[16] K1 on the bench's {mode} inputs {tuple(qs.shape)} x {tgt.shape[0]}: equal "
          "to the plain DP")

    shutil.rmtree(BENCH_TRACE_DIR, ignore_errors=True)
    bench.bench_step(codes, valid, L + bench.DBG_K)  # warm at this allocation
    torch.cuda.synchronize()
    with trace(BENCH_TRACE_DIR):
        with annotate("bench_step"):
            bench.bench_step(codes, valid, L + bench.DBG_K)
            torch.cuda.synchronize()
    path, events = trace_events(BENCH_TRACE_DIR)
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e["name"] == "bench_step"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, top, n_ops = device_busy(device, lo, hi)
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime" and lo <= e["ts"] <= hi
                and ("Synchronize" in e["name"] or "MemcpyAsync" in e["name"]))
    check(any(KERNEL_NAMES["kmer_histogram"] in e["name"] and lo <= e["ts"] <= hi
              for e in device), "bench step trace: no histogram kernel in the step")
    print(f"[16] traced step B {B}: device busy {busy / (hi - lo):.4f} of its "
          f"{(hi - lo) / 1e3:.3f} ms window ({busy / 1e3:.3f} ms), {n_ops} device operations, "
          f"{syncs} host waits or copies")
    for name, us in top:
        print(f"[16] top device op: {us / 1e3:.3f} ms  {name[:110]}")
    print(f"[16] trace: {os.path.relpath(path, HERE)} ({os.path.getsize(path)} bytes)")


def phase_config1(dev, record: dict) -> None:
    """[17] BASELINE config 1: `cli run` on one 50 kb segment with 150-base
    reads at dbg k 31 and 10,000 orderings (studies/STUDY_config1_r2.md's
    command), in process on the card. The reads are re-simulated from the
    seed: the contigs must equal the native engine's, the solutions its
    merge, kmer_breaks and bp_score_true its breakage scorer;
    lev_dist_vs_true (K1 in NW mode on the pipeline's [64, L] pack against
    the segment) must equal K3 on the same input and the plain DP on the
    real rows. Prints the stage times, the walk's W and buffer, the peak
    device memory and K1's time at this shape beside its bound."""
    from genomeassembler_dev_tpu_torch import cli
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.dbg.graph import contigs_sparse
    from genomeassembler_dev_tpu_torch.merge import native
    from genomeassembler_dev_tpu_torch.ops import myers
    from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein
    from genomeassembler_dev_tpu_torch.ops.ks import ks_2samp_sparse
    from genomeassembler_dev_tpu_torch.ops.prefix_min import batched_levenshtein_prefix_min
    from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
    from genomeassembler_dev_tpu_torch.pipeline import results as res_io
    from genomeassembler_dev_tpu_torch.pipeline.assembler import RESULT_COLUMNS, Assembler
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.pipeline.evaluate import (
        COL_MULTIPLE, ROW_MULTIPLE, pack_strings)
    from genomeassembler_dev_tpu_torch.sim.reads_io import read_param_string, save_read_fastas
    from genomeassembler_dev_tpu_torch.sim.segments import read_fasta, synthetic_segment_store
    from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

    c = CONFIG1
    shutil.rmtree(CONFIG1_DIR, ignore_errors=True)
    argv = ["run", "--synthetic", "--seq-len", str(c["seq_len"]), "--read-len",
            str(c["read_len"]), "--dbg-kmer", str(c["dbg_kmer"]), "--coverage",
            str(c["coverage"]), "--n-orderings", str(c["n_orderings"]), "--ind", "1",
            "--device", "cuda", "--workdir", CONFIG1_DIR]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    myers.batched_levenshtein_myers.launches = 0
    batched_levenshtein_prefix_min.launches = 0
    ks_2samp_sparse.launches = 0
    before = torch.cuda.current_device()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    k1 = myers.batched_levenshtein_myers.launches
    check(k1 >= 1, "config 1: the Myers kernel was not launched")
    check(batched_levenshtein_prefix_min.launches == 0, "config 1: prefix-min launched")
    check(ks_2samp_sparse.launches == 1, f"config 1: KS kernel launches "
          f"{ks_2samp_sparse.launches}, not one")
    check(torch.cuda.current_device() == before, "config 1 moved the current device")
    record["myers_levenshtein"]["launches"] += k1
    record["ks_sparse"]["launches"] += 1

    cfg = ExperimentConfig(seq_len=c["seq_len"], read_len=c["read_len"],
                           dbg_kmer=c["dbg_kmer"], kmer=8, coverage_target=float(c["coverage"]),
                           seed=1234, n_orderings=c["n_orderings"])
    path, spath = res_io.solutions_path(CONFIG1_DIR, 1, cfg), res_io.stats_path(CONFIG1_DIR, 1, cfg)
    check(sorted(os.listdir(res_io.exp_dir(CONFIG1_DIR, 1)))
          == sorted(os.path.basename(p) for p in (path, spath)), "config 1: artifacts")
    with open(path, newline="") as f:
        check(next(csv.reader(f)) == RESULT_COLUMNS, "config 1: columns")
    cols = res_io.load_result_columns(path)
    with open(spath) as f:
        stats = json.load(f)
    segment = stats["stats"]["genome_seq"]
    # cli run's segment: the first of the synthetic store at its --total-iters default
    check(segment == synthetic_segment_store(cfg.seed, cfg.seq_len, 10).seqs[0],
          "config 1: the segment")
    target = torch.from_numpy(encode_dna(segment)).to(dev)

    asm = Assembler(cfg, dev)
    timer = StageTimer(dev, False)
    rs = asm.simulate(target, timer)
    reads = reads_of(rs)
    check(len(reads) == stats["stats"]["nr_of_reads"], "config 1: read count")
    # the walk's buffer at this size: [W, contig_cap] uint8
    kcodes, kvalid = kmer_window_codes(rs.codes, cfg.dbg_kmer, dtype=torch.int64)
    kvalid = kvalid & rs.valid[:, None]
    buf, _, _, _, n_walks, n_nodes = contigs_sparse(kcodes, kvalid, cfg.dbg_kmer, cfg.contig_cap)
    check(buf.shape == (n_walks, cfg.contig_cap), f"config 1: walk buffer {tuple(buf.shape)}")
    contigs = asm.contigs(rs.codes, rs.valid, timer)
    check(contigs == native.contigs_from_reads_native(reads, cfg.dbg_kmer),
          "config 1: contigs != native engine")
    sols = cols["sequence"]
    check(sorted(sols) == sorted(native.assemble_native(contigs, cfg.dbg_kmer, cfg.seed,
                                                        cfg.n_orderings)),
          "config 1: solutions != native merge")
    probs = asm.table.combined.cpu().numpy()
    scores, breaks = native.breakscore_native(sols, reads, probs)
    check(np.array_equal(cols["kmer_breaks"], breaks), "config 1: kmer_breaks != native engine")
    check(np.allclose(cols["bp_score_true"], scores, rtol=RTOL, atol=0),
          "config 1: bp_score_true != native engine")
    # the read FASTAs (sim/reads_io.py) of these reads, read back
    fa1, _, ref = save_read_fastas(CONFIG1_DIR, 1, cfg, rs.codes.cpu().numpy(),
                                   rs.valid.cpu().numpy(), rs.positions.cpu().numpy(), segment)
    check(list(read_fasta(fa1).values()) == reads and list(read_fasta(ref).values()) == [segment]
          and read_param_string(cfg) in fa1, "config 1: read FASTAs")

    # the pipeline's own pack of the solutions: K1 (the path's launch gave
    # the column), K3 and the plain DP on the real rows
    mat, lens = pack_strings(sols, s_multiple=ROW_MULTIPLE, l_multiple=COL_MULTIPLE)
    args = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev), target)
    n_real = len(sols)
    got = keeps_device("K1", lambda: myers.batched_levenshtein_myers(*args, mode="NW"))
    check(np.array_equal(cols["lev_dist_vs_true"], got.cpu().numpy()[:n_real]),
          "config 1: lev_dist_vs_true != Myers kernel on the pipeline's pack")
    k3 = keeps_device("K3", lambda: batched_levenshtein_prefix_min(*args, mode="NW"))
    rec = record["prefix_min_levenshtein"]
    rec["launches"] += batched_levenshtein_prefix_min.launches
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(k3, got))
    check(torch.equal(k3, got), f"config 1 {tuple(mat.shape)}: prefix-min != Myers")
    t0 = time.perf_counter()
    plain = batched_levenshtein(args[0][:n_real].contiguous(), args[1][:n_real].contiguous(),
                                target, "NW")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rec = record["myers_levenshtein"]
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got[:n_real], plain))
    check(torch.equal(got[:n_real], plain), "config 1: Myers != plain DP on the real rows")
    k1_ms = cuda_ms(lambda: myers.batched_levenshtein_myers(*args, mode="NW"), 3)
    k3_ms = cuda_ms(lambda: batched_levenshtein_prefix_min(*args, mode="NW"), 1)
    bound = lev_bound_ms(args[1], cfg.seq_len, "words")
    # one query runs on one SM: the longest row's bound there is 132 times its card bound
    sm_bound = 132 * lev_bound_ms(torch.tensor([int(lens.max())]), cfg.seq_len, "words")
    rec.update(config1_shape=[*mat.shape, cfg.seq_len], config1_launches=k1, config1_ms=k1_ms,
               config1_bound_ms=bound, config1_sm_bound_ms=sm_bound,
               config1_plain_real_rows_ms=1e3 * plain_s)
    record["prefix_min_levenshtein"].update(
        config1_ms=k3_ms, config1_bound_ms=lev_bound_ms(args[1], cfg.seq_len, "cells"))

    longest = int(np.argmax(cols["sequence_len"]))
    print(f"[17] config 1 (run --seq-len {cfg.seq_len} --read-len {cfg.read_len} --dbg-kmer "
          f"{cfg.dbg_kmer} --n-orderings {cfg.n_orderings}): {len(reads)} reads, "
          f"{int(kvalid.sum())} k-mer instances, {n_nodes} nodes, {len(contigs)} contigs, "
          f"{n_real} solutions, the longest {cols['sequence_len'][longest]} bases at distance "
          f"{cols['lev_dist_vs_true'][longest]}; contigs, solutions, breaks and scores equal "
          "to the native engine, the distances to K3 and the plain DP")
    print(f"[17] walk buffer: W {n_walks} x {cfg.contig_cap} = {buf.numel()} bytes")
    print(f"[17] wall {wall:.3f} s from the command; stage ms: " + ", ".join(
        f"{name} {1e3 * t:.2f}" for name, t in stats["timings"].items())
          + f"; peak device memory {peak / 2**30:.3f} GiB ({peak} bytes); K1 launches {k1}")
    print(f"[17] K1 NW {tuple(mat.shape)} x {cfg.seq_len}: {k1_ms:.3f} ms (CUDA events, 3 "
          f"calls), bound {bound:.4f} ms on the card, {sm_bound:.3f} ms for the longest row on "
          f"one SM ({sm_bound / k1_ms:.3f} of it); K3 {k3_ms:.3f} ms; the plain DP on the "
          f"{n_real} real rows {plain_s:.3f} s")


def phase_own_full(dev, record: dict) -> None:
    """[18] BASELINE config 3: the reference's own study at full scale,
    `study-own --batched --seg-batch 64` over the 7 grid rows x 200
    experiments (studies/STUDY_own_full_r2.md's command), in process on the
    card. Every artifact is checked for presence and row counts, K1 must run
    once an experiment the runner ran (each row's last batch filled up with
    its first segment) and K3 never, and on each row the experiments on both
    sides of every batch boundary must equal Assembler.run_experiment on the
    card. Prints the wall time and experiments/s of the study and each row,
    the worker's merge seconds beside the overlapped stage, and the peak
    device memory."""
    from genomeassembler_dev_tpu_torch import cli
    from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
    from genomeassembler_dev_tpu_torch.ops import myers
    from genomeassembler_dev_tpu_torch.ops.ks import ks_2samp_sparse
    from genomeassembler_dev_tpu_torch.ops.prefix_min import batched_levenshtein_prefix_min
    from genomeassembler_dev_tpu_torch.pipeline import results as res_io
    from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store

    iters, batch = OWN_FULL_ITERS, OWN_FULL_BATCH
    serial_dir = OWN_FULL_DIR + "_serial"
    for d in (OWN_FULL_DIR, serial_dir):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    myers.batched_levenshtein_myers.launches = 0
    batched_levenshtein_prefix_min.launches = 0
    ks_2samp_sparse.launches = 0
    t0 = time.time()
    cli.main(["study-own", "--synthetic", "--total-iters", str(iters), "--seq-len", "1000",
              "--coverage", "40", "--n-orderings", "10000", "--batched", "--seg-batch",
              str(batch), "--device", "cuda", "--workdir", OWN_FULL_DIR])
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    grid = ExperimentConfig.OWN_STUDY_GRID
    n_exp = len(grid) * iters
    runs = len(grid) * -(-iters // batch) * batch  # the fillers of each row's last batch too
    k1 = myers.batched_levenshtein_myers.launches
    check(k1 == runs, f"own study: Myers launches {k1}, not one for each of {runs} runs")
    check(batched_levenshtein_prefix_min.launches == 0, "own study: prefix-min launched")
    k4 = ks_2samp_sparse.launches  # one a score group
    check(0 < k4 <= runs, f"own study: KS kernel launches {k4} for {runs} runs")
    record["myers_levenshtein"]["launches"] += k1
    record["ks_sparse"]["launches"] += k4
    print(f"[18] study-own --batched --seg-batch {batch}: {n_exp} experiments in {wall:.3f} s "
          f"({n_exp / wall:.3f} experiments/s), {runs} runs with the fillers, Myers launches "
          f"{k1}, KS kernel launches {k4}; peak device memory {peak / 2**30:.3f} GiB "
          f"({peak} bytes)")

    base = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9, kmer=8, coverage_target=40.0,
                            seed=1234, n_orderings=10000)
    segs = synthetic_segment_store(base.seed, base.seq_len, iters)
    table = load_default_query_table(dev)
    # both sides of every batch boundary, 1-based: the first and last of each batch
    samples = sorted({i for lo in range(0, iters, batch) for i in (lo + 1, min(lo + batch, iters))})
    n_solutions = 0
    last = t0
    for read_len, dbg_kmer in grid:
        cfg = base.with_(read_len=read_len, dbg_kmer=dbg_kmer)
        paths = [res_io.solutions_path(OWN_FULL_DIR, i, cfg) for i in range(1, iters + 1)]
        check(all(os.path.exists(p) and os.path.exists(res_io.stats_path(OWN_FULL_DIR, i + 1, cfg))
                  for i, p in enumerate(paths)), f"own row {read_len}:{dbg_kmer}: artifacts")
        row_end = max(os.path.getmtime(p) for p in paths)
        secs, last = row_end - last, row_end
        for p in paths:
            with open(p) as f:
                n_solutions += sum(1 for _ in f) - 1
        merge_s = overlap_s = 0.0  # each batch's stages, read from its first experiment
        for lo in range(0, iters, batch):
            with open(res_io.stats_path(OWN_FULL_DIR, lo + 1, cfg)) as f:
                t = json.load(f)["timings"]
            merge_s += t["Merging shuffled contig orderings (worker thread)"]
            overlap_s += t["Merging + evaluating solutions (overlapped)"]
        asm = Assembler(cfg, dev, table)
        for ind in samples:
            what = f"own row {read_len}:{dbg_kmer} exp {ind}"
            res = asm.run_experiment(segs.seqs[ind - 1])
            res_io.save_result(serial_dir, ind, cfg, res)
            got, want = (res_io.load_result_columns(res_io.solutions_path(d, ind, cfg))
                         for d in (OWN_FULL_DIR, serial_dir))
            check_same_columns(f"{what} against Assembler.run_experiment", got, want)
            with open(res_io.stats_path(OWN_FULL_DIR, ind, cfg)) as f:
                check(json.load(f)["stats"] == json.loads(json.dumps(res.stats)),
                      f"{what}: stats differ")
        print(f"[18] row {read_len}:{dbg_kmer}: {iters} experiments in {secs:.3f} s "
              f"({iters / secs:.3f} experiments/s, artifact write times); merges on the worker "
              f"{merge_s:.3f} s of the overlapped stage's {overlap_s:.3f} s; experiments "
              f"{', '.join(map(str, samples))} equal to Assembler.run_experiment")

    out_dir = os.path.join(OWN_FULL_DIR, "IndustryModel_False")
    for name, rows in (("results_summary.csv", 2 * n_exp), ("results_all.csv", n_solutions)):
        with open(os.path.join(out_dir, name)) as f:
            got = sum(1 for _ in f) - 1
        check(got == rows, f"own study {name}: {got} rows, expected {rows}")
    n_tables = len(glob.glob(os.path.join(OWN_FULL_DIR, "results", "exp_*", "SolutionsTable*")))
    check(n_tables == n_exp, f"own study: {n_tables} SolutionsTables, expected {n_exp}")
    print(f"[18] {n_tables} SolutionsTables, {n_solutions} solutions; results_summary.csv "
          f"and results_all.csv hold a row for each; the fillers were {runs - n_exp} of "
          f"{runs} runs ({(runs - n_exp) / runs:.3f})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from genomeassembler_dev_tpu_torch import cli
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.merge import native
    from genomeassembler_dev_tpu_torch.ops import cuda_build, myers
    from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein
    from genomeassembler_dev_tpu_torch.ops.histogram import (
        count_kmers_batched, count_kmers_batched_plain)
    from genomeassembler_dev_tpu_torch.ops.ks import batched_ks_2samp_masked
    from genomeassembler_dev_tpu_torch.ops.prefix_min import batched_levenshtein_prefix_min
    from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
    from genomeassembler_dev_tpu_torch.pipeline import results as res_io
    from genomeassembler_dev_tpu_torch.pipeline.assembler import RESULT_COLUMNS, Assembler
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.pipeline.evaluate import (
        COL_MULTIPLE, ROW_MULTIPLE, pack_strings, path_prob_profile)
    from genomeassembler_dev_tpu_torch.pipeline.velvet import (
        VELVET_RESULT_COLUMNS, IndustryAssembler)
    from genomeassembler_dev_tpu_torch.sim.segments import (
        synthetic_genome, synthetic_segment_store, write_fasta)
    from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    record = {name: {"name": name, "route": "cuda",
                     "source": f"genomeassembler_dev_tpu_torch/csrc/{src}.cu",
                     "replaces": replaces, "max_abs_err": 0}
              for name, (src, replaces) in KERNELS.items()}

    # -- phase 1: the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[1] gpu: {smi}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # -- phase 2: build the kernels -------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build(*(src for src, _ in KERNELS.values()))
    check(myers.build() == libs[0], "myers.build() names another library")
    print(f"[2] built {len(libs)} kernels in {time.perf_counter() - t0:.2f} s")
    for so in libs:
        with open(so + ".log") as f:
            fn = ""
            for line in f:
                m = re.search(r"entry function '\w*?\d([a-z_]+_kernel)(I(?:Li\d+E|[il])+E)?",
                              line)
                if m:  # template arguments: integers, or int32 / int64 codes
                    args = [a or {"i": "int32", "l": "int64"}[t]
                            for a, t in re.findall(r"Li(\d+)E|([il])E", m.group(2) or "")]
                    fn = m.group(1) + (f"<{', '.join(args)}>" if args else "")
                elif "registers" in line or "spill" in line:
                    print(f"[2] {os.path.basename(so)} {fn} ptxas: {line.strip()}")

    # -- phase 3: Myers kernel vs plain DP on the card ------------------------
    def to_dev(queries, target):
        mat, lens = pack_strings(queries, pad=0)
        return (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
                torch.from_numpy(encode_dna(target)).to(dev))

    lev_cases = []  # (name, args, mode, plain result, Myers result)

    def compare(name, args, mode):
        got = keeps_device("K1", lambda: myers.batched_levenshtein_myers(*args, mode=mode))
        want = batched_levenshtein(*args, mode=mode)
        torch.cuda.synchronize()
        rec = record["myers_levenshtein"]
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got, want))
        check(torch.equal(got, want), f"{name} {mode}: kernel != plain DP")
        lev_cases.append((name, args, mode, want, got))
        print(f"[3] {name} {mode}: {got.numel()} distances equal")

    rng = np.random.default_rng(0)
    target = rand_dna(rng, 90)
    cases = {"random": ([rand_dna(rng, int(rng.integers(1, 120))) for _ in range(9)]
                        + [target, target[10:40]], target)}
    rng = np.random.default_rng(1)
    target = rand_dna(rng, 150)
    cases["multiword+empty"] = ([rand_dna(rng, 200), target + "ACGT" * 10, ""], target)
    # the strip, warp and band edges of the kernel's launch plan, against a
    # short target so that the plain DP stays fast: each length alone, then
    # all in one launch (the longest query sets the plan), then two bands
    rng = np.random.default_rng(4)
    target = rand_dna(rng, 300)
    edge = {n: mutate(rng, (target * (n // 300 + 1))[:n], 0.02)[:n] for n in EDGE_LENGTHS}
    for n, q in edge.items():
        cases[f"length {n}"] = ([q], target)
    cases["mixed 0..50048"] = ([""] + list(edge.values()), target)
    cases["two bands 140000"] = ([mutate(rng, (target * 467)[:140000], 0.02)[:140000],
                                  edge[33], ""], target)
    cases.update(non_acgt_cases(target))
    for name, (queries, target) in cases.items():
        for mode in ("NW", "HW"):
            compare(name, to_dev(queries, target), mode)

    slice_args = slice_shape_args(dev)
    for mode in ("NW", "HW"):
        compare("slice 512x2048x1000", slice_args, mode)
    k_ms = cuda_ms(lambda: myers.batched_levenshtein_myers(*slice_args, mode="NW"), 20)
    p_ms = cuda_ms(lambda: batched_levenshtein(*slice_args, mode="NW"), 3)
    slice_lens, slice_n = slice_args[1], slice_args[2].shape[0]
    k_bound = lev_bound_ms(slice_lens, slice_n, "words")
    print(f"[3] slice 512x2048x1000 NW: kernel {k_ms:.3f} ms, plain DP {p_ms:.3f} ms, "
          f"bound {k_bound:.4f} ms")
    # no PyTorch call computes an edit distance: library_ms stays null
    record["myers_levenshtein"].update(ms=k_ms, plain_ms=p_ms, bound_ms=k_bound,
                                       bound_by="operations", library_ms=None)

    hw_args = hw_shape_args(dev)
    compare("HW 256x2048x50000", hw_args, "HW")
    hk_ms = cuda_ms(lambda: myers.batched_levenshtein_myers(*hw_args, mode="HW"), 3)
    hp_ms = cuda_ms(lambda: batched_levenshtein(*hw_args, mode="HW"), 1)
    print(f"[3] HW 256x2048x50000: kernel {hk_ms:.3f} ms, plain DP {hp_ms:.3f} ms, bound "
          f"{lev_bound_ms(hw_args[1], 50000, 'words'):.4f} ms")

    # -- phase 3b: prefix-min kernel vs the same plain results and Myers ------
    rec = record["prefix_min_levenshtein"]
    for name, args, mode, want, k1 in lev_cases:
        got = keeps_device("K3", lambda: batched_levenshtein_prefix_min(*args, mode=mode))
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got, want))
        check(torch.equal(got, want), f"{name} {mode}: prefix-min kernel != plain DP")
        check(torch.equal(got, k1), f"{name} {mode}: prefix-min kernel != Myers kernel")
        print(f"[3b] {name} {mode}: {got.numel()} distances equal to plain DP and Myers "
              f"(width {args[0].shape[1]})")
    m_ms = cuda_ms(lambda: batched_levenshtein_prefix_min(*slice_args, mode="NW"), 20)
    m_bound = lev_bound_ms(slice_lens, slice_n, "cells")
    print(f"[3b] slice 512x2048x1000 NW: kernel {m_ms:.3f} ms, Myers {k_ms:.3f} ms, "
          f"plain DP {p_ms:.3f} ms, bound {m_bound:.4f} ms")
    mh_ms = cuda_ms(lambda: batched_levenshtein_prefix_min(*hw_args, mode="HW"), 3)
    mh_bound = lev_bound_ms(hw_args[1], 50000, "cells")
    print(f"[3b] HW 256x2048x50000: kernel {mh_ms:.3f} ms, Myers {hk_ms:.3f} ms, "
          f"plain DP {hp_ms:.3f} ms, bound {mh_bound:.4f} ms")
    rec.update(ms=m_ms, plain_ms=p_ms, bound_ms=m_bound, bound_by="operations",
               library_ms=None, hw_ms=mh_ms, hw_bound_ms=mh_bound)

    # -- phase 3c: histogram kernel vs plain and the native counter -----------
    rec = record["kmer_histogram"]

    def hist_case(name, codes, valid, bins, native_counts=None):
        got = keeps_device("K2", lambda: count_kmers_batched(codes, valid, bins))
        want = count_kmers_batched_plain(codes, valid, bins)
        torch.cuda.synchronize()
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got, want))
        check(torch.equal(got, want), f"{name}: histogram kernel != plain")
        if native_counts is not None:
            check(np.array_equal(got.cpu().numpy(), native_counts),
                  f"{name}: histogram kernel != native counter")
        print(f"[3c] {name}: {got.shape[0]} x {bins} counts equal"
              + (" (and to the native counter)" if native_counts is not None else ""))

    for k in (2, 4, 6, 8, 9):  # the cases of tests/test_pallas_kernels.py, and k 2, 6
        rng = np.random.default_rng(k)
        codes = torch.from_numpy(rng.integers(0, 4**k, (2, 700)).astype(np.int32)).to(dev)
        valid = torch.from_numpy(rng.random((2, 700)) < 0.9).to(dev)
        hist_case(f"k {k} [2, 700] 10% invalid", codes, valid, 4**k)
        hist_case(f"k {k} one row all invalid", codes,
                  torch.stack([valid[0], torch.zeros_like(valid[1])]), 4**k)
        hist_case(f"k {k} one bin (contention)", torch.full((1, 70000), 4**k - 1,
                                                            dtype=torch.int64, device=dev),
                  torch.ones((1, 70000), dtype=torch.bool, device=dev), 4**k)
        # int64 codes, every 7th out of range (the kernel drops them as it reads)
        wide = rng.integers(0, 4**k, (3, 4099))
        wide[:, ::7] = rng.choice([-1, -2**40, 4**k, 2**40], wide[:, ::7].shape)
        hist_case(f"k {k} int64 codes out of range", torch.from_numpy(wide).to(dev),
                  torch.from_numpy(rng.random(wide.shape) < 0.9).to(dev), 4**k)
        # a part holds at most 65,532 entries: one part, then two, at one bin
        # (a counter at its most) and at random codes
        for n in (65532, 65533, 65535, 65536):
            hist_case(f"k {k} one bin, N {n}", torch.full((2, n), 4**k - 1 - (n & 1),
                                                          dtype=torch.int32, device=dev),
                      torch.ones((2, n), dtype=torch.bool, device=dev), 4**k)
            hist_case(f"k {k} random, N {n}", torch.from_numpy(
                rng.integers(0, 4**k, (2, n)).astype(np.int32)).to(dev),
                torch.ones((2, n), dtype=torch.bool, device=dev), 4**k)
    # the TPU kernel's measurement shape: 256 segments of 3,333 reads of 12
    # bases, 5 octamer windows each; every row also against the native counter
    rng = np.random.default_rng(8)
    reads = rng.integers(0, 4, (256, 3333, 12)).astype(np.uint8)
    reads[:, :50, 6] = 255  # an N in 50 reads of every segment
    codes, valid = kmer_window_codes(torch.from_numpy(reads).to(dev), 8)
    codes, valid = codes.reshape(256, -1), valid.reshape(256, -1)
    check(codes.shape == (256, 16665), f"histogram shape {tuple(codes.shape)}")
    read_strs = [["".join("ACGTN"[min(c, 4)] for c in r) for r in seg] for seg in reads]
    native_rows = np.stack([native.count_kmers_native(seg, 8) for seg in read_strs])
    hist_case("B 256 x N 16665, k 8", codes, valid, 4**8, native_rows)
    k2_args = (codes, valid, 4**8)  # [15] traces one call at this shape
    # the library call for the same function: one bincount of row * bins +
    # code, its flat index prepared outside the timed call
    flat = (torch.arange(256, device=dev)[:, None] * 4**8 + codes.long())[valid]
    h_ms = cuda_ms(lambda: count_kmers_batched(codes, valid, 4**8), 50)
    hb_ms = cuda_ms(lambda: torch.bincount(flat, minlength=256 * 4**8), 50)
    hp_ms2 = cuda_ms(lambda: count_kmers_batched_plain(codes, valid, 4**8), 20)
    h_dev = 1e-3 * graph_us(lambda: count_kmers_batched(codes, valid, 4**8))
    h_bound = (codes.numel() * (codes.element_size() + 1) + 256 * 4**8 * 4) / HBM_BYTES_PER_MS
    print(f"[3c] B 256 x N 16665, k 8: kernel {h_ms:.4f} ms, torch.bincount {hb_ms:.4f} ms "
          f"(it syncs), plain {hp_ms2:.3f} ms (CUDA events over calls); kernel {h_dev:.4f} ms "
          f"as a CUDA graph; bound {h_bound:.4f} ms (bytes)")
    rec.update(ms=h_dev, host_loop_ms=h_ms, plain_ms=hp_ms2, bound_ms=h_bound, bound_by="bytes",
               library_ms=hb_ms)
    # the count study's four calls under study-all: one segment's 3,333 reads
    # of 12 bases, all windows in one row (B 1), as Assembler.count_only
    # passes them; each call is one kernel launch and nothing else
    count_us = {}
    for k in (2, 4, 6, 8):
        kc, kv = kmer_window_codes(torch.from_numpy(reads[0]).to(dev), k)
        kc, kv = kc.reshape(1, -1), kv.reshape(1, -1)
        hist_case(f"count study k {k}, B 1 x N {kc.shape[1]}", kc, kv, 4**k,
                  native.count_kmers_native(read_strs[0], k)[None])
        nodes = graph_nodes(lambda: count_kmers_batched(kc, kv, 4**k))
        check(nodes == [0], f"count study k {k}: one call ran graph nodes {nodes}, not one kernel")
        kflat = kc.long()[kv]
        c = count_us[k] = {
            "N": kc.shape[1],
            "us": graph_us(lambda: count_kmers_batched(kc, kv, 4**k)),
            "bound_us": 1e3 * (kc.numel() * 5 + 4**k * 4) / HBM_BYTES_PER_MS,
            "host_loop_us": 1e3 * cuda_ms(lambda: count_kmers_batched(kc, kv, 4**k), 100),
            "bincount_host_loop_us": 1e3 * cuda_ms(
                lambda: torch.bincount(kflat, minlength=4**k), 100)}
        print(f"[3c] count study k {k}, B 1 x N {kc.shape[1]}: one kernel a call (graph "
              f"nodes {nodes}); kernel {c['us']:.2f} us as a CUDA graph, a call from the host "
              f"{c['host_loop_us']:.2f} us, torch.bincount {c['bincount_host_loop_us']:.2f} us; "
              f"bound {c['bound_us']:.3f} us (bytes)")
    rec["count_study"] = count_us

    # -- phase 3d: the KS kernel vs the pooled sort ---------------------------
    phase_ks(dev, record)

    # -- phase 4: the golden fixtures -----------------------------------------
    for path in FIXTURES:
        with open(path) as f:
            fx = json.load(f)
        c, ref = fx["config"], fx["reference"]
        gcfg = ExperimentConfig(seq_len=c["seq_len"], read_len=c["read_len"],
                                dbg_kmer=c["dbg_kmer"], kmer=c["break_kmer"], seed=c["seed"],
                                n_orderings=ref["n_orderings"])
        gasm = Assembler(gcfg, dev)
        codes = np.stack([encode_dna(r) for r in fx["reads"]])
        read_set = (codes, np.ones(len(codes), bool), np.zeros(len(codes), np.int32))
        rs = gasm._replay_read_set(torch.from_numpy(encode_dna(fx["segment"])).to(dev),
                                   read_set)
        check(gasm.contigs(rs.codes, rs.valid, StageTimer(dev, False)) == ref["contigs"],
              f"{fx['name']} contigs")
        res = gasm.run_experiment(fx["segment"], read_set)
        cols = res.columns
        check(sorted(cols["sequence"]) == sorted(ref["solutions"]),
              f"{fx['name']} solution set")
        row = {s: i for i, s in enumerate(cols["sequence"])}
        idx = [row[s] for s in ref["sequence"]]
        for col in ("kmer_breaks", "lev_dist_vs_true"):
            check(np.array_equal(np.asarray(cols[col])[idx], ref[col]), f"{fx['name']} {col}")
        for col, key in (("bp_score_true", "bp_score"),
                         ("bp_score_norm_by_break_freqs_true", "bp_score_norm_by_break_freqs"),
                         ("bp_score_norm_by_len_true", "bp_score_norm_by_len")):
            check(np.allclose(np.asarray(cols[col])[idx], ref[key], rtol=RTOL, atol=0),
                  f"{fx['name']} {col}")
        print(f"[4] {fx['name']}: {len(ref['contigs'])} contigs, {res.n_solutions} "
              "solutions, breaks and distances equal, scores within rtol 2e-5")

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
        reads = reads_of(rs)
        check(len(reads) == res.stats["nr_of_reads"], f"exp {i}: read count")
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

    # -- phase 6: the study chain, cli study-all ------------------------------
    shutil.rmtree(STUDY_DIR, ignore_errors=True)
    argv = ["study-all", "--synthetic", "--total-iters", str(STUDY_ITERS),
            "--workdir", STUDY_DIR, "--device", "cuda"]
    torch.cuda.synchronize()
    myers.batched_levenshtein_myers.launches = 0
    count_kmers_batched.launches = 0
    batched_levenshtein_prefix_min.launches = 0
    t0 = time.time()
    cli.main(argv)
    chain_wall = time.time() - t0
    record["myers_levenshtein"]["launches"] = myers.batched_levenshtein_myers.launches
    record["kmer_histogram"]["launches"] = count_kmers_batched.launches
    check(batched_levenshtein_prefix_min.launches == 0, "prefix-min launched in the chain")
    for name in ("myers_levenshtein", "kmer_histogram"):
        check(record[name]["launches"] > 0, f"{name} was not launched by study-all")
    print(f"[6] study-all: {chain_wall:.3f} s; launches in the chain: Myers "
          f"{record['myers_levenshtein']['launches']}, histogram "
          f"{record['kmer_histogram']['launches']}")

    base = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9, kmer=8,
                            coverage_target=40.0, seed=1234, n_orderings=10000)
    segs = synthetic_segment_store(base.seed, base.seq_len, STUDY_ITERS)
    n_solutions = 0
    last_write = t0
    own_checks = []  # each row's first K3 check: (row, args)
    for read_len, dbg_kmer in ExperimentConfig.OWN_STUDY_GRID:
        cfg = base.with_(read_len=read_len, dbg_kmer=dbg_kmer)
        asm = Assembler(cfg, dev)
        stage_sum = {}
        row_end = last_write
        for ind in range(1, STUDY_ITERS + 1):
            what = f"row {read_len}:{dbg_kmer} exp {ind}"
            path = res_io.solutions_path(STUDY_DIR, ind, cfg)
            check(os.path.exists(path) and os.path.exists(
                res_io.stats_path(STUDY_DIR, ind, cfg)), f"{what}: artifacts")
            row_end = max(row_end, os.path.getmtime(path))
            with open(path, newline="") as f:
                check(next(csv.reader(f)) == RESULT_COLUMNS, f"{what}: columns")
            cols = res_io.load_result_columns(path)
            with open(res_io.stats_path(STUDY_DIR, ind, cfg)) as f:
                for name, t in json.load(f)["timings"].items():
                    stage_sum[name] = stage_sum.get(name, 0.0) + t
            n_solutions += len(cols["sequence"])
            segment = segs.seqs[ind - 1]
            target = torch.from_numpy(encode_dna(segment)).to(dev)
            timer = StageTimer(dev, False)
            rs = asm.simulate(target, timer)
            reads = reads_of(rs)
            check(asm.contigs(rs.codes, rs.valid, timer)
                  == native.contigs_from_reads_native(reads, dbg_kmer),
                  f"{what}: contigs != native engine")
            scores, breaks = native.breakscore_native(cols["sequence"], reads, probs)
            check(np.array_equal(cols["kmer_breaks"], breaks),
                  f"{what}: kmer_breaks != native engine")
            check(np.allclose(cols["bp_score_true"], scores, rtol=RTOL, atol=0),
                  f"{what}: bp_score != native engine")
            mat, lens = pack_strings(cols["sequence"])
            args = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev), target)
            k3 = batched_levenshtein_prefix_min(*args, mode="NW").cpu().numpy()
            check(np.array_equal(cols["lev_dist_vs_true"], k3),
                  f"{what}: lev_dist_vs_true != prefix-min kernel")
            if ind == 1:
                plain = batched_levenshtein(*args, mode="NW").cpu().numpy()
                check(np.array_equal(cols["lev_dist_vs_true"], plain),
                      f"{what}: lev_dist_vs_true != plain DP")
                own_checks.append((f"{read_len}:{dbg_kmer}", args))
        secs = row_end - last_write
        last_write = row_end
        print(f"[6] row {read_len}:{dbg_kmer}: {STUDY_ITERS} experiments agree with the "
              f"native engine, the prefix-min kernel and (exp 1) the plain DP; "
              f"{STUDY_ITERS / secs:.3f} experiments/s (artifact write times); stage ms "
              "per experiment: " + ", ".join(
                  f"{name} {1e3 * t / STUDY_ITERS:.2f}" for name, t in stage_sum.items()))
    record["prefix_min_levenshtein"]["launches"] = batched_levenshtein_prefix_min.launches
    check(batched_levenshtein_prefix_min.launches > 0, "prefix-min checked nothing")
    # K3 and K1 at the own checks' real shapes (after the launch count)
    own_ms = {}
    for row, args in own_checks:
        own_ms[row] = {
            "shape": [*args[0].shape, args[2].shape[0]],
            "ms": cuda_ms(lambda: batched_levenshtein_prefix_min(*args, mode="NW"), 20),
            "myers_ms": cuda_ms(lambda: myers.batched_levenshtein_myers(*args, mode="NW"), 20),
            "bound_ms": lev_bound_ms(args[1], args[2].shape[0], "cells")}
        print(f"[6] K3 at the row {row} check {own_ms[row]['shape']} NW: "
              f"{own_ms[row]['ms']:.4f} ms (Myers {own_ms[row]['myers_ms']:.4f} ms), "
              f"bound {own_ms[row]['bound_ms']:.4f} ms")
    record["prefix_min_levenshtein"]["own_checks"] = own_ms

    out_dir = os.path.join(STUDY_DIR, "IndustryModel_False")
    n_exp = len(ExperimentConfig.OWN_STUDY_GRID) * STUDY_ITERS
    for name, rows in (("results_summary.csv", 2 * n_exp), ("results_all.csv", n_solutions)):
        with open(os.path.join(out_dir, name)) as f:
            got = sum(1 for _ in f) - 1
        check(got == rows, f"{name}: {got} rows, expected {rows}")
    with open(os.path.join(STUDY_DIR, "gc_dependency.csv")) as f:
        check(len(list(csv.DictReader(f))) == STUDY_ITERS, "gc_dependency.csv rows")
    check(len(glob.glob(os.path.join(STUDY_DIR, "results", "exp_*", "*"))) == 2 * n_exp,
          "artifact count")

    with open(os.path.join(STUDY_DIR, "kmer_count_vs_prob.csv")) as f:
        count_rows = list(csv.DictReader(f))
    for k in (2, 4, 6, 8):
        kcfg = base.with_(only_kmers_from_reads=True, kmer=k)
        rs = Assembler(kcfg, dev).simulate(
            torch.from_numpy(encode_dna(segs.seqs[0])).to(dev), StageTimer(dev, False))
        want = native.count_kmers_native(reads_of(rs), k)
        got = np.array([int(r["count"]) for r in count_rows if int(r["k"]) == k])
        check(np.array_equal(got, want), f"kmer_count_vs_prob.csv k {k} != native counter")
    print(f"[6] {n_exp} experiments, {n_solutions} solutions; summaries, GC table and "
          "k-mer counts (k 2/4/6/8, equal to the native counter) agree")
    # -- phase 8: the velvet study, cli study-velvet at 50 kb ----------------
    with open(VELVET_FIXTURE) as f:
        fx = json.load(f)
    c, ref = fx["config"], fx["reference"]
    vasm = IndustryAssembler(ExperimentConfig(
        seq_len=c["seq_len"], read_len=c["read_len"], dbg_kmer=c["dbg_kmer"],
        kmer=c["break_kmer"], seed=c["seed"], industry_standard=True), dev)
    codes = np.stack([encode_dna(r) for r in fx["reads"]])
    read_set = (codes, np.ones(len(codes), bool), np.zeros(len(codes), np.int32))
    target = torch.from_numpy(encode_dna(fx["segment"])).to(dev)
    ev = vasm.evaluate(ref["sequence"], vasm._replay_read_set(target, read_set), target)
    for key, col in (("bp_score", "bp_score"), ("bp_nb", "bp_score_norm_by_break_freqs"),
                     ("bp_nl", "bp_score_norm_by_len")):
        check(np.allclose(ev[key], ref[col], rtol=RTOL, atol=0), f"{fx['name']} {col}")
    for key, col in (("kmer_breaks", "kmer_breaks"), ("lev", "lev_dist_vs_true")):
        check(np.array_equal(ev[key], ref[col]), f"{fx['name']} {col}")
    mat, lens = pack_strings(ref["sequence"])
    prof, prof_ok = path_prob_profile(torch.from_numpy(mat).to(dev),
                                      torch.from_numpy(lens).to(dev), vasm.table.probs[8])
    for i, want in enumerate(ref["path_prob_dist"]):
        check(np.allclose(prof[i][prof_ok[i]].cpu().numpy(), want, rtol=RTOL, atol=0),
              f"{fx['name']} path_prob_dist row {i}")
    res = vasm.run_external(fx["segment"], fx["external_contigs"], read_set)
    kept = [p for p in ref["sequence"] if fx["segment"].find(p) != -1]
    check(sorted(res.columns["sequence"]) == sorted(kept), f"{fx['name']} kept solutions")
    for s, sp in zip(res.columns["sequence"], res.columns["path_prob_dist_startpos"]):
        check(sp == ref["path_prob_dist_startpos"][ref["sequence"].index(s)],
              f"{fx['name']} startpos")
    print(f"[8] {fx['name']}: {len(ref['solutions'])} solutions; scores within rtol 2e-5, "
          "breaks, HW distances, profiles and startpos equal to the original C++")

    shutil.rmtree(VELVET_DIR, ignore_errors=True)
    vsegs = synthetic_segment_store(1234, VELVET_LEN, 1)
    vbase = ExperimentConfig(seq_len=VELVET_LEN, read_len=12, kmer=8, coverage_target=40.0,
                             seed=1234, industry_standard=True)
    for _, k in ExperimentConfig.VELVET_STUDY_GRID:
        step = VELVET_TILE - (k - 1)
        write_fasta(os.path.join(VELVET_DIR, f"contigs_k{k}", "contigs_exp_1.fa"),
                    {f"NODE_{j + 1}": vsegs.seqs[0][lo : lo + VELVET_TILE] for j, lo in
                     enumerate(range(0, VELVET_LEN - (k - 1), step))})
    torch.cuda.synchronize()
    myers.batched_levenshtein_myers.launches = 0
    peaks = {}
    t0 = time.time()
    for read_len, k in ExperimentConfig.VELVET_STUDY_GRID:
        torch.cuda.reset_peak_memory_stats()
        cli.main(["study-velvet", "--synthetic", "--seq-len", str(VELVET_LEN),
                  "--total-iters", "1", "--grid", f"{read_len}:{k}",
                  "--contigs-dir", os.path.join(VELVET_DIR, f"contigs_k{k}"),
                  "--workdir", VELVET_DIR, "--device", "cuda"])
        peaks[(read_len, k)] = torch.cuda.max_memory_allocated()
    velvet_wall = time.time() - t0
    velvet_launches = myers.batched_levenshtein_myers.launches
    check(velvet_launches > 0, "the Myers kernel was not launched by study-velvet")
    print(f"[8] study-velvet: {len(peaks)} rows in {velvet_wall:.3f} s; Myers launches "
          f"{velvet_launches}")

    segment = vsegs.seqs[0]
    target = torch.from_numpy(encode_dna(segment)).to(dev)
    for read_len, k in ExperimentConfig.VELVET_STUDY_GRID:
        what = f"velvet row {read_len}:{k}"
        cfg = vbase.with_(read_len=read_len, dbg_kmer=k)
        path = res_io.solutions_path(VELVET_DIR, 1, cfg)
        with open(path, newline="") as f:
            check(next(csv.reader(f)) == VELVET_RESULT_COLUMNS, f"{what}: columns")
        cols = res_io.load_result_columns(path)
        with open(res_io.stats_path(VELVET_DIR, 1, cfg)) as f:
            timings = json.load(f)["timings"]
        check(cols["sequence"] == [segment], f"{what}: the one solution is the segment")
        check(cols["path_prob_dist_startpos"].tolist() == [0], f"{what}: startpos")
        check(cols["lev_dist_vs_true"].tolist() == [0], f"{what}: lev_dist_vs_true")
        check(cols["contig_frac_len"].tolist() == [100.0], f"{what}: contig_frac_len")
        asm = IndustryAssembler(cfg, dev)
        rs = asm.simulate(target, StageTimer(dev, False))
        reads = reads_of(rs)
        scores, breaks = native.breakscore_native(cols["sequence"], reads, probs)
        check(np.array_equal(cols["kmer_breaks"], breaks), f"{what}: kmer_breaks != native")
        check(np.allclose(cols["bp_score_true"], scores, rtol=RTOL, atol=0),
              f"{what}: bp_score != native engine")
        mat, lens = pack_strings(cols["sequence"])
        prof, prof_ok = path_prob_profile(torch.from_numpy(mat), torch.from_numpy(lens),
                                          asm.table.probs[8].cpu())
        cpu_ks = batched_ks_2samp_masked(prof, prof_ok, rs.track.cpu()).numpy()
        for col in ("stat_test_KS_true", "stat_test_KS_random"):
            check(np.array_equal(cols[col], cpu_ks), f"{what}: {col} != CPU KS")
        if (read_len, k) in ((12, 11), (40, 37)):
            plain = batched_levenshtein(torch.from_numpy(mat).to(dev),
                                        torch.from_numpy(lens).to(dev), target, "HW")
            check(np.array_equal(cols["lev_dist_vs_true"], plain.cpu().numpy()),
                  f"{what}: lev_dist_vs_true != plain DP")
        print(f"[8] {what}: 1 solution = the segment, startpos 0, HW distance 0, 100% "
              f"covered; breaks and scores agree with the native engine, KS with the CPU"
              f"{', distance with the plain DP' if (read_len, k) in ((12, 11), (40, 37)) else ''}"
              f"; peak {peaks[(read_len, k)] / 2**30:.3f} GiB; stage ms: " + ", ".join(
                  f"{name} {1e3 * t:.2f}" for name, t in timings.items()))

    # K1 and the plain DP at the velvet path's real shape: [64, 50,048] with
    # one real 50,000-base row, HW, against the 50 kb segment
    mat, lens = pack_strings([segment], s_multiple=ROW_MULTIPLE, l_multiple=COL_MULTIPLE)
    check(mat.shape == (64, 50048), f"velvet shape {mat.shape}")
    vargs = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev), target)
    row_args = (vargs[0][:1, :VELVET_LEN].contiguous(), vargs[1][:1].contiguous(), target)
    outs = {"kernel": [], "plain": [], "row": []}
    vk_ms = cuda_ms(lambda: outs["kernel"].append(
        myers.batched_levenshtein_myers(*vargs, mode="HW")), 1)
    vp_ms = cuda_ms(lambda: outs["plain"].append(batched_levenshtein(*vargs, mode="HW")), 1)
    vr_ms = cuda_ms(lambda: outs["row"].append(batched_levenshtein(*row_args, mode="HW")), 1)
    check(torch.equal(outs["kernel"][0], outs["plain"][0]), "velvet shape: kernel != plain DP")
    check(outs["kernel"][0].tolist() == [0] * 64 and outs["row"][0].tolist() == [0],
          "velvet shape: HW distances")
    print(f"[8] velvet shape 64x50048 (1 real row) x 50000 HW: kernel {vk_ms:.3f} ms, "
          f"plain DP {vp_ms:.3f} ms, plain DP on the real row [1, 50000] {vr_ms:.3f} ms")
    record["myers_levenshtein"].update(velvet_ms=vk_ms, velvet_plain_ms=vp_ms,
                                       velvet_row_plain_ms=vr_ms,
                                       velvet_bound_ms=lev_bound_ms(vargs[1], VELVET_LEN, "words"))
    k3_out = []
    v3_ms = cuda_ms(lambda: k3_out.append(batched_levenshtein_prefix_min(*vargs, mode="HW")), 1)
    torch.cuda.synchronize()
    rec = record["prefix_min_levenshtein"]
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(k3_out[0], outs["kernel"][0]))
    check(torch.equal(k3_out[0], outs["kernel"][0]), "velvet shape: prefix-min != Myers")
    rec.update(velvet_ms=v3_ms, velvet_bound_ms=lev_bound_ms(vargs[1], VELVET_LEN, "cells"))
    print(f"[8] velvet shape: prefix-min kernel {v3_ms:.3f} ms, equal to Myers on all 64 "
          f"rows; bounds {rec['velvet_bound_ms']:.3f} ms (Myers "
          f"{record['myers_levenshtein']['velvet_bound_ms']:.4f} ms), 132 times that on the "
          "one SM that runs the one real row")

    # a repeat-heavy velvet ensemble: 256 mutated ~2x copies of the segment,
    # HW against it; K1 on all rows, the plain DP on rows 0-3 alone
    rargs = repeat_heavy_args(segment, target)
    outs = []
    rk_ms = cuda_ms(lambda: outs.append(myers.batched_levenshtein_myers(*rargs, mode="HW")), 1)
    t0 = time.time()
    want = batched_levenshtein(rargs[0][:4].contiguous(), rargs[1][:4].contiguous(), target,
                               "HW")
    torch.cuda.synchronize()
    rp_s = time.time() - t0
    got = outs[0][:4]
    rec = record["myers_levenshtein"]
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(got, want))
    check(torch.equal(got, want), "repeat-heavy shape: kernel != plain DP on rows 0-3")
    check(bool((outs[0] >= rargs[1] - VELVET_LEN).all()), "repeat-heavy shape: distances")
    print(f"[8] repeat-heavy shape {tuple(rargs[0].shape)} x {VELVET_LEN} HW: kernel "
          f"{rk_ms:.3f} ms for 256 rows; rows 0-3 {got.tolist()} equal to the plain DP "
          f"({rp_s:.1f} s on those rows)")
    rec["repeat_heavy_ms"] = rk_ms
    k3_out = []
    r3_ms = cuda_ms(lambda: k3_out.append(batched_levenshtein_prefix_min(*rargs, mode="HW")), 1)
    torch.cuda.synchronize()
    rec = record["prefix_min_levenshtein"]
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err(k3_out[0], outs[0]))
    check(torch.equal(k3_out[0], outs[0]), "repeat-heavy shape: prefix-min != Myers")
    rec.update(repeat_heavy_ms=r3_ms,
               repeat_heavy_bound_ms=lev_bound_ms(rargs[1], VELVET_LEN, "cells"))
    print(f"[8] repeat-heavy shape: prefix-min kernel {r3_ms:.3f} ms (bound "
          f"{rec['repeat_heavy_bound_ms']:.3f} ms), equal to Myers on all 256 rows; Myers "
          f"bound {lev_bound_ms(rargs[1], VELVET_LEN, 'words'):.4f} ms")

    phase_repeat_velvet(dev, record)

    # -- phase 9: the biased traversal, cli study-own --traversal biased ------
    shutil.rmtree(BIASED_DIR, ignore_errors=True)
    grid = ",".join(f"{r}:{k}" for r, k in BIASED_GRID)
    torch.cuda.synchronize()
    myers.batched_levenshtein_myers.launches = 0
    batched_levenshtein_prefix_min.launches = 0
    t0 = time.time()
    cli.main(["study-own", "--traversal", "biased", "--repeat-segments", "--synthetic",
              "--grid", grid, "--total-iters", str(STUDY_ITERS), "--workdir", BIASED_DIR,
              "--device", "cuda"])
    biased_wall = time.time() - t0
    biased_launches = myers.batched_levenshtein_myers.launches
    check(biased_launches > 0, "the Myers kernel was not launched by the biased study")
    check(batched_levenshtein_prefix_min.launches == 0, "prefix-min launched in the study")
    print(f"[9] study-own --traversal biased: {len(BIASED_GRID)} rows x {STUDY_ITERS} in "
          f"{biased_wall:.3f} s; Myers launches {biased_launches}")
    record["myers_levenshtein"]["launches"] += velvet_launches + biased_launches

    bbase = ExperimentConfig(seq_len=1000, read_len=12, dbg_kmer=9, kmer=8,
                             coverage_target=40.0, seed=1234, n_orderings=10000,
                             traversal="biased")
    bsegs = synthetic_segment_store(bbase.seed, bbase.seq_len, STUDY_ITERS, repeats=True)
    for read_len, k in BIASED_GRID:
        cfg = bbase.with_(read_len=read_len, dbg_kmer=k)
        asm, cpu_asm = Assembler(cfg, dev), Assembler(cfg, "cpu")
        probs8_np = cpu_asm.table.probs[8].numpy()
        stage_sum = {}
        n_capped = n_sol = 0
        for ind in range(1, STUDY_ITERS + 1):
            what = f"biased row {read_len}:{k} exp {ind}"
            path = res_io.solutions_path(BIASED_DIR, ind, cfg)
            cols = res_io.load_result_columns(path)
            with open(res_io.stats_path(BIASED_DIR, ind, cfg)) as f:
                for name, t in json.load(f)["timings"].items():
                    stage_sum[name] = stage_sum.get(name, 0.0) + t
            target = torch.from_numpy(encode_dna(bsegs.seqs[ind - 1])).to(dev)
            timer = StageTimer(dev, False)
            rs = asm.simulate(target, timer)
            reads = reads_of(rs)
            contigs = asm.contigs(rs.codes, rs.valid, timer)
            check(contigs == greedy_walks(reads, k, probs8_np, cfg.contig_cap),
                  f"{what}: contigs != host greedy walk")
            check(contigs == cpu_asm.contigs(rs.codes.cpu(), rs.valid.cpu(),
                                             StageTimer("cpu", False)),
                  f"{what}: contigs != the port's CPU run")
            want = sorted(set(contigs), key=lambda s: (-len(s), s))[: cfg.biased_max_solutions]
            check(sorted(cols["sequence"]) == sorted(want), f"{what}: solutions")
            n_capped += sum(len(s) == cfg.contig_cap for s in contigs)
            n_sol += len(want)
            scores, breaks = native.breakscore_native(cols["sequence"], reads, probs)
            check(np.array_equal(cols["kmer_breaks"], breaks), f"{what}: kmer_breaks != native")
            check(np.allclose(cols["bp_score_true"], scores, rtol=RTOL, atol=0),
                  f"{what}: bp_score != native engine")
            mat, lens = pack_strings(cols["sequence"])
            args = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev), target)
            k3 = batched_levenshtein_prefix_min(*args, mode="NW").cpu().numpy()
            check(np.array_equal(cols["lev_dist_vs_true"], k3),
                  f"{what}: lev_dist_vs_true != prefix-min kernel")
            if ind == 1:
                plain = batched_levenshtein(*args, mode="NW").cpu().numpy()
                check(np.array_equal(cols["lev_dist_vs_true"], plain),
                      f"{what}: lev_dist_vs_true != plain DP")
        print(f"[9] biased row {read_len}:{k}: {STUDY_ITERS} experiments, {n_sol} solutions "
              f"({n_capped} contigs capped at {cfg.contig_cap}); contigs equal to the host "
              "greedy walk and the CPU run, breaks and scores to the native engine, "
              "distances to the prefix-min kernel and (exp 1) the plain DP; stage ms per "
              "experiment: " + ", ".join(f"{name} {1e3 * t / STUDY_ITERS:.2f}"
                                         for name, t in stage_sum.items()))
    record["prefix_min_levenshtein"]["launches"] += batched_levenshtein_prefix_min.launches

    # -- phase 10: the batched own study, cli study-own --batched -------------
    shutil.rmtree(BATCHED_DIR, ignore_errors=True)
    study = ["study-own", "--synthetic", "--total-iters", str(BATCHED_ITERS), "--device", "cuda"]
    dirs = {name: os.path.join(BATCHED_DIR, name) for name in ("batched", "serial")}
    torch.cuda.synchronize()
    myers.batched_levenshtein_myers.launches = 0
    batched_levenshtein_prefix_min.launches = 0
    starts = {"batched": time.time()}
    cli.main(study + ["--batched", "--seg-batch", "16", "--workdir", dirs["batched"]])
    batched_wall = time.time() - starts["batched"]
    batched_launches = myers.batched_levenshtein_myers.launches
    n_exp = len(ExperimentConfig.OWN_STUDY_GRID) * BATCHED_ITERS
    check(batched_launches == n_exp,
          f"Myers launches in the batched study: {batched_launches}, not one an experiment")
    check(batched_levenshtein_prefix_min.launches == 0, "prefix-min launched in the study")
    record["myers_levenshtein"]["launches"] += batched_launches
    starts["serial"] = time.time()
    cli.main(study + ["--workdir", dirs["serial"]])
    serial_wall = time.time() - starts["serial"]
    print(f"[10] study-own --batched --seg-batch 16: {n_exp} experiments in {batched_wall:.3f} s "
          f"({n_exp / batched_wall:.3f} experiments/s), Myers launches {batched_launches}; the "
          f"serial study {serial_wall:.3f} s ({n_exp / serial_wall:.3f} experiments/s)")

    bsegs = synthetic_segment_store(base.seed, base.seq_len, BATCHED_ITERS)
    last = dict(starts)
    for read_len, dbg_kmer in ExperimentConfig.OWN_STUDY_GRID:
        cfg = base.with_(read_len=read_len, dbg_kmer=dbg_kmer)
        asm = Assembler(cfg, dev)
        row_end = {}
        for name, d in dirs.items():
            row_end[name] = max(os.path.getmtime(res_io.solutions_path(d, ind, cfg))
                                for ind in range(1, BATCHED_ITERS + 1))
        for ind in range(1, BATCHED_ITERS + 1):
            what = f"batched row {read_len}:{dbg_kmer} exp {ind}"
            got, want = (res_io.load_result_columns(res_io.solutions_path(d, ind, cfg))
                         for d in (dirs["batched"], dirs["serial"]))
            check_same_columns(f"{what} against the serial run", got, want)
            stats = []
            for d in (dirs["batched"], dirs["serial"]):
                with open(res_io.stats_path(d, ind, cfg)) as f:
                    stats.append(json.load(f))
            check(stats[0]["stats"] == stats[1]["stats"], f"{what}: stats != serial")
            segment = bsegs.seqs[ind - 1]
            target = torch.from_numpy(encode_dna(segment)).to(dev)
            reads = reads_of(asm.simulate(target, StageTimer(dev, False)))
            check(len(reads) == stats[0]["stats"]["nr_of_reads"], f"{what}: read count")
            _, breaks = native.breakscore_native(got["sequence"], reads, probs)
            check(np.array_equal(got["kmer_breaks"], breaks), f"{what}: kmer_breaks != native")
            mat, lens = pack_strings(got["sequence"])
            args = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev), target)
            check(np.array_equal(got["lev_dist_vs_true"], batched_levenshtein_prefix_min(
                *args, mode="NW").cpu().numpy()), f"{what}: lev_dist_vs_true != prefix-min kernel")
            if ind == 1:
                check(np.array_equal(got["lev_dist_vs_true"], batched_levenshtein(
                    *args, mode="NW").cpu().numpy()), f"{what}: lev_dist_vs_true != plain DP")
                stage_ms = {name: 1e3 * t for name, t in stats[0]["timings"].items()}
        secs = {name: row_end[name] - last[name] for name in dirs}
        last = row_end
        print(f"[10] row {read_len}:{dbg_kmer}: {BATCHED_ITERS} experiments equal to the serial "
              "run (artifacts), the native engine (breaks), the prefix-min kernel and (exp 1) "
              f"the plain DP; batched {secs['batched']:.3f} s "
              f"({BATCHED_ITERS / secs['batched']:.3f} experiments/s), serial "
              f"{secs['serial']:.3f} s ({BATCHED_ITERS / secs['serial']:.3f} experiments/s) "
              "(artifact write times); batch stages ms: " + ", ".join(
                  f"{name} {t:.2f}" for name, t in stage_ms.items()))
    record["prefix_min_levenshtein"]["launches"] += batched_levenshtein_prefix_min.launches
    for name in ("results_summary.csv", "results_all.csv"):
        rows = []
        for d in (dirs["batched"], dirs["serial"]):
            with open(os.path.join(d, "IndustryModel_False", name), newline="") as f:
                rows.append(list(csv.reader(f)))
        check(len(rows[0]) == len(rows[1]) and rows[0][0] == rows[1][0], f"{name}: rows")
        for x, y in zip(rows[0][1:], rows[1][1:]):
            num = [i for i, v in enumerate(y) if re.fullmatch(r"[-+.\deE]+|nan", v)]
            check([v for i, v in enumerate(x) if i not in num]
                  == [v for i, v in enumerate(y) if i not in num]
                  and np.allclose([float(x[i]) for i in num], [float(y[i]) for i in num],
                                  rtol=RTOL, atol=1e-6, equal_nan=True), f"{name}: values")
    print("[10] results_summary.csv and results_all.csv equal to the serial study's")

    # -- phase 11: the device ensemble merge ----------------------------------
    from genomeassembler_dev_tpu_torch.core.rng import shuffle_orderings
    from genomeassembler_dev_tpu_torch.merge import engine
    from genomeassembler_dev_tpu_torch.merge.device import (
        _hash_arrays, _merge_kernel, assemble_device)
    from genomeassembler_dev_tpu_torch.spec import reference_semantics as spec

    cases = merge_cases(np.random.default_rng)
    for name, seed in (("C 64", 1234), ("C 128", 11)):
        contigs = cases[name]
        check(len(contigs) == int(name[2:]), f"{name}: {len(contigs)} contigs")
        torch.cuda.synchronize()
        t0 = time.time()
        got = assemble_device(contigs, 9, seed, 10000, dev)
        dev_s = time.time() - t0
        t0 = time.time()
        want = native.assemble_native(contigs, 9, seed, 10000)
        nat_s = time.time() - t0
        check(got == want, f"{name}: device merge != native engine at 10,000 orderings")
        small = [assemble_device(contigs, 9, seed, 200, dev),
                 native.assemble_native(contigs, 9, seed, 200),
                 spec.assemble_solutions(spec.shuffled_orderings(contigs, seed, 200), 9)]
        check(small[0] == small[1] == small[2], f"{name}: device, native and spec at 200")
        auto = engine.preferred_backend(len(contigs), 10000, True, True)
        # the device merge's split: the ordering replay on the host, then the
        # fixpoint loop on the card; the rest is the hash arrays and the
        # host chain rebuild
        t0 = time.time()
        perms = shuffle_orderings(len(contigs), 10000, seed)
        replay_s = time.time() - t0
        arrays = [torch.from_numpy(a.astype(np.int64)).to(dev) for a in _hash_arrays(contigs)]
        torch.cuda.synchronize()
        t0 = time.time()
        _merge_kernel(torch.from_numpy(perms).long().to(dev), *arrays, 9)
        torch.cuda.synchronize()
        loop_s = time.time() - t0
        print(f"[11] {name}, dbg k 9, 10,000 orderings: {len(got)} solutions, device merge "
              f"{dev_s:.3f} s (ordering replay {replay_s:.3f} s, fixpoint loop on the card "
              f"{loop_s:.3f} s, the rest the hash arrays and the chain rebuild), native "
              f"{nat_s:.3f} s; equal, and equal to the spec at 200 orderings; auto on CUDA "
              f"picks {auto}")
    dup = cases["duplicate-heavy"]
    got = assemble_device(dup, 6, 1234, 50, dev)
    check(assemble_device.last_n_fallback > 0, "duplicate-heavy: the collision guard idle")
    check(got == native.assemble_native(dup, 6, 1234, 50)
          == spec.assemble_solutions(spec.shuffled_orderings(dup, 1234, 50), 6),
          "duplicate-heavy: device != native, spec")
    print(f"[11] duplicate-heavy: {assemble_device.last_n_fallback} of 50 orderings re-merged "
          "exactly on the host; equal to native and spec")

    # -- phase 12: the breakage model, cli fit-model -------------------------
    model = phase_model(dev)

    # -- phase 13: the parallel layer on one card -----------------------------
    phase_parallel(dev, record, model)

    # -- phase 14: --plots on the card ----------------------------------------
    phase_plots(dev, record)

    # -- phase 15: the device trace -------------------------------------------
    phase_trace(dev, record, k2_args, slice_args)

    # -- phase 16: the headline bench -----------------------------------------
    phase_bench(dev, record)

    # -- phase 17: BASELINE config 1, cli run at 50 kb ------------------------
    phase_config1(dev, record)

    # -- phase 18: BASELINE config 3, the own study at full scale -------------
    phase_own_full(dev, record)

    print(f"[7] total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(record.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
