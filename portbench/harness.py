"""The benchmark harness: finds a cell's files by name, sets the program up,
runs the measured window, checks the window's outputs against the plain
reference and reads the metrics.

Files, each found by the name in BENCHMARK.json:

  portbench/workloads/<cell>.json   config, traffic mix, chips, why
  portbench/configs/<config>.json   the deployment: entry, experiment
                                    settings, grid, limits of the check
  portbench/metrics/<metric>.py     one metric's reader: read(run)

Two entries drive the program (genomeassembler_dev_tpu_torch), chosen by
the configuration's "entry" (ENTRIES):

  study_batched      calls of pipeline/experiments.py::run_own_study over
                     one grid row and `total_iters` segments each, batched,
                     back to back, cycling through the mix's rows
  assembler_serial   Assembler.run_experiment then results.save_result,
                     one segment after another

Both cycle through the mix's segment set in its own order; --seed draws
the experiments that the check recomputes with the plain reference.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from portbench.traffic import segments as traffic

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "genomeassembler_dev_tpu")
EXACT_CHECKS = ("missing_tables", "solution_sets", "int_columns", "aggregates")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ".") -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload_file(name: str, pkg_dir: str = PKG_DIR) -> dict:
    return load_json(os.path.join(pkg_dir, "workloads", f"{name}.json"))


def config_file(name: str, pkg_dir: str = PKG_DIR) -> dict:
    return load_json(os.path.join(pkg_dir, "configs", f"{name}.json"))


def metric_reader(name: str, pkg_dir: str = PKG_DIR):
    """The module of portbench/metrics/<name>.py."""
    path = os.path.join(pkg_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list[str]:
    """Names of the `kind` ("end_to_end" or "per_layer") metrics the cell
    reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN_MODULES})


# -- the record of a run that the metric readers read -----------------------


@dataclass
class Experiment:
    workdir: str
    ind: int  # 1-based, as the results layout names it
    row: tuple[int, int]  # (read_len, dbg_kmer)
    segment: str
    latency_s: float | None = None  # serial entry: call to save_result's return
    save_s: float | None = None  # serial entry: save_result alone


@dataclass
class Call:
    row: tuple[int, int]
    seconds: float  # host clock around the call
    workdir: str
    experiments: list[Experiment]
    batch_heads: list[int]  # the first experiment of each batch
    fillers: dict[int, int]  # batch head -> filler runs added to its batch


@dataclass
class Run:
    cell: str
    config: dict
    mix: dict
    setup_s: float
    window_s: float
    experiments: list[Experiment]
    calls: list[Call] = field(default_factory=list)
    trace: object = None  # trace.Trace in a traced run
    window_peak_bytes: int | None = None
    _stats: dict = field(default_factory=dict)

    def stats(self, exp: Experiment) -> dict:
        """The experiment's stats JSON as the window wrote it."""
        key = (exp.workdir, exp.ind)
        if key not in self._stats:
            self._stats[key] = load_json(stats_path(exp, self.config))
        return self._stats[key]

    def timings(self, exp: Experiment) -> dict[str, float]:
        return self.stats(exp)["timings"]

    def solution_lengths(self, exp: Experiment) -> np.ndarray:
        names, rows = read_table(table_path(exp, self.config))
        j = names.index("sequence_len")
        return np.array([int(r[j]) for r in rows], np.int64)


def param_string(config: dict, row) -> str:
    e = config["experiment"]
    return (f"_SeqLen-{e['seq_len']}_SeqSeed-{e['seed']}_ReadLen-{row[0]}"
            f"_DBGKmer-{row[1]}_kmer-{e['kmer']}_IndustryModel-False")


def table_path(exp: Experiment, config: dict) -> str:
    return os.path.join(exp.workdir, "results", f"exp_{exp.ind}",
                        f"SolutionsTable{param_string(config, exp.row)}.csv")


def stats_path(exp: Experiment, config: dict) -> str:
    return os.path.join(exp.workdir, "results", f"exp_{exp.ind}",
                        f"AssemblyStats{param_string(config, exp.row)}.json")


def read_table(path: str) -> tuple[list[str], list[list[str]]]:
    import csv

    with open(path, newline="") as f:
        r = csv.reader(f)
        names = next(r)
        return names, list(r)


# -- the program's side -----------------------------------------------------


class Program:
    """The port, set up for one cell: the query table on the device and the
    cell's segment set. Each entry (a subclass) runs its own unit of work:
    `warm` once a row in set-up, `unit` back to back in the window."""

    per_call = 1

    def __init__(self, config: dict, mix: dict, device, log):
        self.config, self.mix, self.device, self.log = config, mix, device, log
        t = time.perf_counter()
        from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
        from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig

        import torch

        if self.device.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=self.device)
        log(f"setup: import and device context {time.perf_counter() - t:.3f} s")
        t = time.perf_counter()
        self.table = load_default_query_table(self.device)
        log(f"setup: query table to the device {time.perf_counter() - t:.3f} s")
        self.base = ExperimentConfig(**config["experiment"])
        self.rows = [tuple(r) for r in mix["rows"]]
        t = time.perf_counter()
        self.set = traffic.segments(mix["set_seed"], 0, mix["set_size"],
                                    config["experiment"]["seq_len"], bool(mix["repeats"]))
        log(f"setup: {mix['set_size']} segments {time.perf_counter() - t:.3f} s")

    def warm_up(self, scratch: str) -> None:
        """One unit of the window's work a row, at the window's shapes, on
        the set's first segments."""
        for row in self.rows:
            t = time.perf_counter()
            workdir = tempfile.mkdtemp(prefix="warm-", dir=scratch)
            self.warm(workdir, row)
            shutil.rmtree(workdir, ignore_errors=True)
            self.log(f"setup: warm-up row {row[0]}:{row[1]} {time.perf_counter() - t:.3f} s")

    def window(self, seconds: float, scratch: str, annotate) -> tuple[float, list[Call],
                                                                       list[Experiment]]:
        """Whole rounds (one unit a row, in the mix's order) back to back
        until `seconds` have passed, so that every run weighs the rows
        alike; returns (window seconds, calls, experiments)."""
        calls, exps = [], []
        start = time.perf_counter()
        c = 0
        while True:
            for row in self.rows:
                segs = traffic.cycle(self.set, c * self.per_call, self.per_call)
                c += 1
                end = self.unit(c, row, segs, scratch, annotate, calls, exps)
            if end - start >= seconds:
                return end - start, calls, exps

    def close(self) -> None:
        self.table = None


class StudyBatched(Program):
    """Calls of pipeline/experiments.py::run_own_study over one grid row and
    `total_iters` segments, batched as `cli study-own --batched` runs, each
    call in a fresh workdir."""

    def __init__(self, config: dict, mix: dict, device, log):
        super().__init__(config, mix, device, log)
        self.per_call = mix["total_iters"]
        self.seg_batch = config["seg_batch"]

    def warm(self, workdir: str, row) -> None:
        self._call(workdir, row, self.set[: self.seg_batch])

    def unit(self, c, row, segs, scratch, annotate, calls, exps) -> float:
        wd = tempfile.mkdtemp(prefix=f"call{c}-", dir=scratch)
        t0 = time.perf_counter()
        with annotate(f"call {row[0]}:{row[1]}"):
            self._call(wd, row, segs)
        t1 = time.perf_counter()
        call_exps = [Experiment(wd, i + 1, row, s) for i, s in enumerate(segs)]
        n, sb = len(segs), self.seg_batch
        heads = list(range(1, n + 1, sb))
        calls.append(Call(row, t1 - t0, wd, call_exps, heads,
                          {h: sb - min(sb, n - h + 1) for h in heads}))
        exps += call_exps
        return t1

    def _call(self, workdir: str, row, segs: list[str]) -> None:
        from genomeassembler_dev_tpu_torch.pipeline.experiments import run_own_study
        from genomeassembler_dev_tpu_torch.sim.segments import SegmentStore

        store = SegmentStore(names=tuple(f"seg_{i}" for i in range(len(segs))),
                             seqs=tuple(segs))
        run_own_study(workdir, store, self.device, self.base, grid=(tuple(row),),
                      total_iters=len(segs), table=self.table, batched=True,
                      seg_batch=self.seg_batch)


class AssemblerSerial(Program):
    """Assembler.run_experiment then results.save_result (the body of
    `cli run`), one segment after another into one workdir."""

    def __init__(self, config: dict, mix: dict, device, log):
        super().__init__(config, mix, device, log)
        from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler

        (row,) = self.rows
        self.asm = Assembler(self.base.with_(read_len=row[0], dbg_kmer=row[1]),
                             self.device, self.table)
        self.workdir = None

    def warm(self, workdir: str, row) -> None:
        self._experiment(workdir, 1, self.set[0], _no_span)

    def unit(self, c, row, segs, scratch, annotate, calls, exps) -> float:
        if self.workdir is None:
            self.workdir = tempfile.mkdtemp(prefix="window-", dir=scratch)
        t0 = time.perf_counter()
        with annotate("experiment"):
            save_s = self._experiment(self.workdir, c, segs[0], annotate)
        t1 = time.perf_counter()
        exps.append(Experiment(self.workdir, c, row, segs[0], t1 - t0, save_s))
        return t1

    def _experiment(self, workdir: str, ind: int, seg: str, annotate) -> float:
        """One experiment and its save; returns save_result's seconds."""
        from genomeassembler_dev_tpu_torch.pipeline.results import save_result

        res = self.asm.run_experiment(seg)
        t = time.perf_counter()
        with annotate("save"):
            save_result(workdir, ind, self.asm.config, res)
        return time.perf_counter() - t

    def close(self) -> None:
        self.asm = None
        super().close()


ENTRIES = {"study_batched": StudyBatched, "assembler_serial": AssemblerSerial}


def _no_span(name):
    return contextlib.nullcontext()


# -- the check --------------------------------------------------------------


def _float(v: str) -> float:
    return float("nan") if v == "NA" else float(v)


def _gap(p: float, r: float) -> float:
    if math.isnan(p) and math.isnan(r):
        return 0.0
    if p == r:
        return 0.0
    if r == 0.0 or math.isnan(p) or math.isnan(r):
        return math.inf
    return abs(p - r) / abs(r)


INT_COLUMNS = ("sequence_len", "kmer_breaks", "lev_dist_vs_true", "contig_frac_len")
FLOAT_COLUMNS = ("bp_score_true", "bp_score_norm_by_break_freqs_true",
                 "bp_score_norm_by_len_true", "stat_test_KS_true", "bp_score_random",
                 "bp_score_norm_by_break_freqs_random", "bp_score_norm_by_len_random",
                 "stat_test_KS_random")


def compare_rows(rows: dict, stats: dict, ref: dict) -> dict:
    """The check's numbers for one experiment: its solutions' columns
    ({sequence: {column: value}}) and stats against the reference's."""
    out = dict.fromkeys(EXACT_CHECKS, 0) | {"score_rel_gap": 0.0}
    if set(rows) != set(ref["rows"]):
        out["solution_sets"] = 1
        return out
    for seq, got in rows.items():
        want = ref["rows"][seq]
        for name in INT_COLUMNS:
            if float(got[name]) != float(want[name]):
                out["int_columns"] += 1
        for name in FLOAT_COLUMNS:
            p, w = float(got[name]), float(want[name])
            if math.isnan(p) != math.isnan(w):
                out["int_columns"] += 1
            else:
                out["score_rel_gap"] = max(out["score_rel_gap"], _gap(p, w))
    for key, want in ref["stats"].items():
        if stats.get(key) != want:
            out["int_columns"] += 1
    return out


def compare_experiment(exp: Experiment, config: dict, ref: dict) -> dict:
    """compare_rows on the table and stats that the window wrote; rows out
    of descending bp_score order, or a solution twice, count as wrong."""
    tpath, spath = table_path(exp, config), stats_path(exp, config)
    if not (os.path.exists(tpath) and os.path.exists(spath)):
        return dict.fromkeys(EXACT_CHECKS, 0) | {"missing_tables": 1, "score_rel_gap": 0.0}
    names, table = read_table(tpath)
    rows = {r[names.index("sequence")]: {n: _float(v) for n, v in zip(names, r)
                                         if n != "sequence"} for r in table}
    out = compare_rows(rows, load_json(spath)["stats"], ref)
    bp = [_float(r[names.index("bp_score_true")]) for r in table]
    if len(rows) != len(table):
        out["solution_sets"] = 1
    if any(a < b for a, b in zip(bp, bp[1:])):
        out["int_columns"] += 1
    return out


def compare_aggregates(exp: Experiment, config: dict, ref: dict, n_in_call: int) -> dict:
    """The study's results_summary.csv and results_all.csv rows of one
    experiment against its table and the reference's means."""
    out = {"aggregates": 0, "score_rel_gap": 0.0}
    d = os.path.join(exp.workdir, "IndustryModel_False")
    try:
        _, summary = read_table(os.path.join(d, "results_summary.csv"))
        _, all_rows = read_table(os.path.join(d, "results_all.csv"))
        names, rows = read_table(table_path(exp, config))
    except (OSError, StopIteration):
        out["aggregates"] = 1
        return out
    if len(summary) != 2 * n_in_call:
        out["aggregates"] += 1
        return out
    for r, key in zip(summary[2 * (exp.ind - 1) : 2 * exp.ind],
                      ("bp_score_norm_by_len_true", "bp_score_norm_by_len_random")):
        vals = [v[key] for v in ref["rows"].values()]
        want = float(np.nanmean(vals)) if vals else float("nan")
        if ([int(r[0]), int(r[1]), r[2], r[4]]
                != [exp.row[0], exp.row[1], "bp_score_norm_by_len",
                    str(key.endswith("_random"))]):
            out["aggregates"] += 1
        out["score_rel_gap"] = max(out["score_rel_gap"], _gap(_float(r[3]), want))
    mine = [r for r in all_rows if int(r[2]) == exp.ind]
    head = ["sequence_len", "kmer_breaks", "bp_score_norm_by_break_freqs_true",
            "bp_score_norm_by_len_true", "bp_score_true", "bp_score_random",
            "lev_dist_vs_true", "stat_test_KS_true"]
    col = {n: j for j, n in enumerate(names)}
    if len(mine) != len(rows):
        out["aggregates"] += 1
        return out
    for a, t in zip(mine, rows):
        got = [_float(v) for v in a[3:]]
        want = [_float(t[col[n]]) for n in head]
        if [int(a[0]), int(a[1])] != list(exp.row) or not all(
                (math.isnan(x) and math.isnan(y)) or x == y for x, y in zip(got, want)):
            out["aggregates"] += 1
    return out


def batch_edges(call: Call) -> set[int]:
    """The first and the last experiment of each of the call's batches."""
    n = len(call.experiments)
    ends = call.batch_heads[1:] + [n + 1]
    return {i for h, e in zip(call.batch_heads, ends) for i in (h, e - 1)}


def check_sample(run: Run, seed: int) -> list[Experiment]:
    """`check_experiments` of the window's experiments, drawn from the seed
    and shared evenly over the rows; in batched calls half of a row's share
    comes from the batches' edges (a batch's first and last experiment, the
    last one beside the fillers) and half from the rest."""
    rng = np.random.default_rng([seed, 2])
    rows = sorted({e.row for e in run.experiments})
    k = -(-run.mix["check_experiments"] // len(rows))
    edge_ids = {id(e) for c in run.calls for e in c.experiments if e.ind in batch_edges(c)}
    sample = []
    for row in rows:
        pool = [e for e in run.experiments if e.row == row]
        edges = [e for e in pool if id(e) in edge_ids]
        rest = [e for e in pool if id(e) not in edge_ids]
        n_edge = min(len(edges), k // 2 if rest else k)
        n_rest = min(len(rest), k - n_edge)
        sample += [edges[i] for i in sorted(rng.choice(len(edges), n_edge, replace=False))]
        sample += [rest[i] for i in sorted(rng.choice(len(rest), n_rest, replace=False))]
    return sample


def check(run: Run, seed: int, device, log) -> dict:
    """Every experiment of the window has its outputs; a sample drawn from
    the seed (check_sample) is compared with the plain reference."""
    from portbench.reference import experiment as reference

    numbers = dict.fromkeys(EXACT_CHECKS, 0) | {"score_rel_gap": 0.0}
    for exp in run.experiments:
        if not os.path.exists(table_path(exp, run.config)):
            numbers["missing_tables"] += 1
    sample = check_sample(run, seed)
    probs = reference.load_probs(reference.default_table_path())
    t = time.perf_counter()
    call_of = {id(e): c for c in run.calls for e in c.experiments}
    refs = {}  # a segment's row recurs in later calls: one reference for both
    for exp in sample:
        cfg = run.config["experiment"] | {"read_len": exp.row[0], "dbg_kmer": exp.row[1]}
        key = (exp.segment, exp.row)
        if key not in refs:
            refs[key] = reference.run(exp.segment, cfg, probs, device)
        ref = refs[key]
        parts = [compare_experiment(exp, run.config, ref)]
        if id(exp) in call_of:
            parts.append(compare_aggregates(exp, run.config, ref,
                                            len(call_of[id(exp)].experiments)))
        for p in parts:
            for k, v in p.items():
                numbers[k] = max(numbers[k], v) if k == "score_rel_gap" else numbers[k] + v
    log(f"check: {len(sample)} experiments against the reference in "
        f"{time.perf_counter() - t:.3f} s")
    return numbers


def limits(config: dict) -> dict:
    return dict.fromkeys(EXACT_CHECKS, 0) | config["limits"]


# -- one run ----------------------------------------------------------------


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, root: str = ".",
             log=None, t_start: float | None = None, overrides: dict | None = None) -> dict:
    """Set up, measure, check and read one cell; returns the result line's
    object. `device` is the torch device the program runs on; set-up is
    timed from `t_start`. `overrides` ({"config": {...}, "traffic": {...}})
    shrinks a cell for the CPU tests."""
    t_setup = t_start if t_start is not None else time.perf_counter()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = manifest(root)
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    wl = workload_file(cell)
    if (wl["config"], wl["traffic"]["name"], wl["chips"]) != (
            entry["config"], entry["traffic"], entry["chips"]):
        raise SystemExit(f"portbench/workloads/{cell}.json disagrees with BENCHMARK.json")
    config = config_file(wl["config"]) | (overrides or {}).get("config", {})
    mix = wl["traffic"] | (overrides or {}).get("traffic", {})

    import torch

    from portbench import trace as trace_mod

    scratch = tempfile.mkdtemp(prefix="portbench-")
    try:
        prog = ENTRIES[config["entry"]](config, mix, device, log)
        prog.warm_up(scratch)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_setup
        log(f"setup: {setup_s:.3f} s in all")

        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()

        def annotate(name):
            if prof is None:
                return contextlib.nullcontext()
            return torch.profiler.record_function(trace_mod.SPAN_PREFIX + name)

        try:
            with annotate("window"):
                window_s, calls, exps = prog.window(seconds, scratch, annotate)
                if cuda:
                    torch.cuda.synchronize(device)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        log(f"window: {len(exps)} experiments in {window_s:.3f} s"
            + "".join(f"; call {c.row[0]}:{c.row[1]} {c.seconds:.3f} s" for c in calls))
        found = forbidden_loaded()
        if found:
            raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
        run = Run(cell, config, mix, setup_s, window_s, exps, calls)
        peak = None
        if cuda:
            run.window_peak_bytes = torch.cuda.max_memory_allocated(device)
            peak = max(setup_peak, run.window_peak_bytes)
        if prof is not None:
            t = time.perf_counter()
            run.trace = trace_mod.summarize(prof, trace_mod.SPAN_PREFIX + "window")
            prof = None
            log(f"trace: read in {time.perf_counter() - t:.3f} s")

        kind = "per_layer" if trace else "end_to_end"
        units = {m["name"]: m["unit"] for m in bench[kind]}
        metrics = {}
        for name in cell_metrics(bench, cell, kind):
            value = metric_reader(name).read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}

        prog.close()
        del prog
        if cuda:
            torch.cuda.empty_cache()
        numbers = check(run, seed, device, log)
        lim = limits(config)
        correct = all(numbers[k] <= lim[k] for k in numbers)
        wrong = numbers["missing_tables"] + (0 if correct else 1)

        dev = {"platform": "gpu" if cuda else "cpu", "count": 1}
        if cuda:
            from portbench.device import device_entry

            dev |= {"kind": torch.cuda.get_device_name(device),
                    "memory_peak_bytes": int(peak)} | device_entry(device)
        if run.trace is not None:
            dev |= {"busy_s": run.trace.busy_s, "window_s": run.trace.window_s}
        result = {"correct": correct, "attempted": len(exps), "failed": wrong,
                  "metrics": metrics, "device": dev}
        if run.trace is not None:
            result["breakdown"] = {"device_ops": run.trace.top_ops(),
                                   "idle_gaps": [[n, s] for n, s in run.trace.gaps]}
        result["checks"] = {k: {"value": numbers[k], "limit": lim[k]} for k in numbers}
        return result
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
