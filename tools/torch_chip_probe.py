"""Measurements of the PyTorch/CUDA port on one NVIDIA GPU that chip_smoke.py
does not make. Each is a subcommand; each needs a CUDA card and nvcc.

  k1-vs-parent PARENT_CU  K1 built from another source of csrc/myers.cu (for
                          example an earlier commit's, written out with
                          `git show <commit>:genomeassembler_dev_tpu_torch/csrc/myers.cu`)
                          beside the current one: both on chip_smoke.py's
                          non-ACGT cases against the plain DP, then both
                          timed in turns (other, current, current, other,
                          other, current) by CUDA events at chip_smoke.py's
                          four K1 shapes (the slice's 512 x 2048 x 1000 NW,
                          256 x 2048 x 50,000 HW, the velvet shape
                          [64, 50,048] and the repeat-heavy [256, 100,096]),
                          and the current one through its wrapper.
  trace-sessions          three torch.profiler sessions (utils/profiling.py)
                          in one process, each around K1, K2 and K3 launches:
                          the kernel events by name and the API call each
                          one's launch correlates with.

    python3 tools/torch_chip_probe.py k1-vs-parent build/myers_parent.cu
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def k1_vs_parent(parent_cu: str) -> None:
    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.ops import cuda_build, myers
    from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein
    from genomeassembler_dev_tpu_torch.pipeline.evaluate import (
        COL_MULTIPLE, ROW_MULTIPLE, pack_strings)
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store

    dev = torch.device("cuda")
    other_so = os.path.join(cuda_build.BUILD_DIR, "libmyers_other.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    subprocess.run([shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", *cuda_build.NVCC_FLAGS,
                    "-I", os.path.join(REPO, "genomeassembler_dev_tpu_torch", "csrc"),
                    "-o", other_so, parent_cu], check=True, capture_output=True)
    libs = {"other": ctypes.CDLL(other_so), "current": cuda_build.load("myers", myers._declare)}
    myers._declare(libs["other"])

    def launch(name, args, mode="HW"):
        """One launch of a library at the current launch plan."""
        q, ql, t = args
        W = max(1, -(-q.shape[1] // 32))
        plan = myers.launch_plan(W)
        out = torch.empty(q.shape[0], dtype=torch.int32, device=dev)
        hbuf = (torch.empty((q.shape[0], t.shape[0]), dtype=torch.int8, device=dev)
                if W > plan.band_words else None)
        err = libs[name].gadev_myers_launch(
            q.data_ptr(), ql.data_ptr(), t.data_ptr(), out.data_ptr(),
            None if hbuf is None else hbuf.data_ptr(), q.shape[0], q.shape[1], t.shape[0],
            plan.words_per_lane, plan.lanes, plan.shared_bytes, int(mode == "HW"),
            *cuda_build.launch_args(q))
        if err:
            raise RuntimeError(f"{name} launch: CUDA error {err}")
        return out

    target = chip_smoke.rand_dna(np.random.default_rng(4), 300)
    for case, (queries, t) in chip_smoke.non_acgt_cases(target).items():
        mat, lens = pack_strings(queries, pad=0)
        args = (torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev),
                torch.from_numpy(encode_dna(t)).to(dev))
        for mode in ("NW", "HW"):
            want = batched_levenshtein(*args, mode=mode)
            got = {name: launch(name, args, mode) for name in libs}
            torch.cuda.synchronize()
            print(f"{case} {mode}: equal to the plain DP: " + ", ".join(
                f"{name} {torch.equal(out, want)}" for name, out in got.items())
                + f" (plain {want.tolist()[:4]}, other {got['other'].tolist()[:4]})")
    segment = synthetic_segment_store(1234, chip_smoke.VELVET_LEN, 1).seqs[0]
    target = torch.from_numpy(encode_dna(segment)).to(dev)
    mat, lens = pack_strings([segment], s_multiple=ROW_MULTIPLE, l_multiple=COL_MULTIPLE)
    shapes = {  # name: (args, mode, calls a timing)
        "slice [512, 2048] x 1000 NW": (chip_smoke.slice_shape_args(dev), "NW", 20),
        "[256, 2048] x 50000 HW": (chip_smoke.hw_shape_args(dev), "HW", 3),
        "velvet [64, 50048] HW": ((torch.from_numpy(mat).to(dev),
                                   torch.from_numpy(lens).to(dev), target), "HW", 3),
        "repeat-heavy [256, 100096] HW": (chip_smoke.repeat_heavy_args(segment, target),
                                          "HW", 3)}
    times = {}
    for shape, (args, mode, reps) in shapes.items():
        outs = [launch(name, args, mode) for name in libs]
        torch.cuda.synchronize()
        if not torch.equal(*outs):
            raise RuntimeError(f"{shape}: the two kernels disagree")
        t = times[shape] = {"other": [], "current": [], "wrapper": []}
        for name in ("other", "current", "current", "other", "other", "current"):
            t[name].append(chip_smoke.cuda_ms(lambda: launch(name, args, mode), reps))
        t["wrapper"] = [chip_smoke.cuda_ms(
            lambda: myers.batched_levenshtein_myers(*args, mode=mode), reps) for _ in range(3)]
        print(f"{shape}, ms a launch: " + "; ".join(
            f"{name} " + ", ".join(f"{x:.3f}" for x in v) for name, v in t.items()))
    print(json.dumps(times))


def trace_sessions() -> None:
    from genomeassembler_dev_tpu_torch.ops import cuda_build, myers
    from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers_batched
    from genomeassembler_dev_tpu_torch.ops.prefix_min import batched_levenshtein_prefix_min
    from genomeassembler_dev_tpu_torch.utils.profiling import annotate, trace

    dev = torch.device("cuda")
    print("NVCC_FLAGS", " ".join(cuda_build.NVCC_FLAGS))
    rng = np.random.default_rng(0)
    lev = (torch.from_numpy(rng.integers(0, 4, (64, 512)).astype(np.uint8)).to(dev),
           torch.full((64,), 512, dtype=torch.int32, device=dev),
           torch.from_numpy(rng.integers(0, 4, 1000).astype(np.uint8)).to(dev))
    hist = (torch.from_numpy(rng.integers(0, 4**8, (4, 5000)).astype(np.int32)).to(dev),
            torch.ones((4, 5000), dtype=torch.bool, device=dev), 4**8)
    calls = {"K1": (myers.batched_levenshtein_myers, lev, 3),
             "K2": (count_kmers_batched, hist, 2),
             "K3": (batched_levenshtein_prefix_min, lev, 1)}
    for fn, args, _ in calls.values():
        fn(*args)  # the libraries load before the first session
    torch.cuda.synchronize()
    logroot = os.path.join(REPO, "build", "probe_traces")
    shutil.rmtree(logroot, ignore_errors=True)
    for session in range(3):
        logdir = os.path.join(logroot, str(session))
        with trace(logdir):
            for name, (fn, args, n) in calls.items():
                with annotate(name):
                    for _ in range(n):
                        fn(*args)
            torch.cuda.synchronize()
        (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        api = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
        for symbol in chip_smoke.KERNEL_NAMES.values():
            mine = [e for e in events if e.get("cat") == "kernel" and symbol in e["name"]]
            print(f"session {session}: {len(mine)} {symbol} events, launched by "
                  f"{sorted({api.get(e['args'].get('correlation'), 'none') for e in mine})}")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("torch_chip_probe: no CUDA device")
    what = sys.argv[1]
    t0 = time.perf_counter()
    if what == "k1-vs-parent":
        k1_vs_parent(sys.argv[2])
    elif what == "trace-sessions":
        trace_sessions()
    else:
        sys.exit(f"unknown subcommand {what!r}")
    print(f"{what}: {time.perf_counter() - t0:.1f} s")
