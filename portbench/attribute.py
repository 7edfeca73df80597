"""One traced run of a cell, as `python3 -m portbench.run --trace 1` makes
it, read further against the program's own spans: what the result line
cannot say yet (portbench/trace.py and the harness keep no launch or thread
of an event).

    python3 -m portbench.attribute --workload <cell> --seed <n> --seconds <s> [--out FILE]

It prints the run's result line, then one JSON object (also written to
--out, by default build/attribute_<cell>_<seed>.json) with, per
experiment written: the program spans' host ms (all, and self: less their
children) by name and thread, each span's device ms (every device
operation by the innermost main-thread span open at its launch, paired by
correlation id), the idle gaps named by harness span > program span
(worker: span): host operation, the share of the window's idle time inside
a main-thread program span, the share of each harness call outside every
program span, K1's device seconds attributed to eval.levenshtein against
all of its kernel events, and the counters.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import spans
from portbench.trace import SPAN_PREFIX

WINDOW = SPAN_PREFIX + "window"
K1 = "myers_kernel"


def per_span_ms(span_list, n: int) -> dict:
    """{name: [count, host ms per experiment, self ms per experiment]} of
    one thread's spans."""
    inner = spans.Innermost(span_list)
    child_ns = [0] * len(inner.spans)
    for i, up in enumerate(inner.up):
        if up >= 0:
            child_ns[up] += inner.spans[i].end_ns - inner.spans[i].start_ns
    out: dict[str, list] = {}
    for s, c in zip(inner.spans, child_ns):
        d = s.end_ns - s.start_ns
        row = out.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += d / 1e6 / n
        row[2] += (d - c) / 1e6 / n
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def analyse(evs: list, rec, n_experiments: int, n_gaps: int = 10) -> dict:
    """The report of one traced window: `evs` the trace's spans.Events,
    `rec` the program's record of the window."""
    n = max(n_experiments, 1)
    win = next(e for e in evs if e.name == WINDOW and e.kind == "annotation"
               and e.end_ns > e.start_ns)
    w0, w1, main = win.start_ns, win.end_ns, win.thread
    main_spans = [s for s in rec.spans if s.thread == rec.owner]
    by_thread: dict[int, list] = {}
    for s in rec.spans:
        if s.thread != rec.owner:
            by_thread.setdefault(s.thread, []).append(s)
    workers = sorted(by_thread.values(), key=len, reverse=True)
    worker = spans.Innermost(workers[0]) if workers else None

    device = spans.device_by_span(evs, main_spans, main, w0, w1)
    k1_by = spans.device_by_span(evs, main_spans, main, substring=K1)
    k1_all = spans.device_seconds(evs, K1)

    harness_spans = spans.Innermost(
        [e for e in evs if e.kind == "annotation" and e.thread == main
         and e.name.startswith(SPAN_PREFIX) and e.name != WINDOW and e.end_ns > e.start_ns])
    main_inner = spans.Innermost(main_spans)
    gaps = spans.idle_gaps(evs, w0, w1)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]
    shortest = min((g1 - g0 for g0, g1 in longest), default=0)
    host_ops = [e for e in evs if e.kind == "host" and e.thread == main
                and e.end_ns - e.start_ns >= shortest // 2]
    covered = spans.Union(main_spans).covered_ns
    idle_ns = sum(g1 - g0 for g0, g1 in gaps)
    idle_in_spans = sum(covered(g0, g1) for g0, g1 in gaps)

    calls = []
    for c in harness_spans.spans:
        if c.name.startswith((SPAN_PREFIX + "call", SPAN_PREFIX + "experiment")):
            out = (c.end_ns - c.start_ns) - covered(c.start_ns, c.end_ns)
            calls.append(out / (c.end_ns - c.start_ns))
    saves = [e for e in harness_spans.spans if e.name == SPAN_PREFIX + "save"]
    program_ms = per_span_ms(main_spans, n)
    eval_ms = sum(v[1] for k, v in program_ms.items() if k.startswith("eval."))
    stage_ms = sum(v[1] for k, v in program_ms.items()
                   if k.startswith("Evaluating each de novo assembled solution"))
    return {
        "experiments": n_experiments,
        "window_s": (w1 - w0) / 1e9,
        "spans_main": program_ms,
        "spans_worker": [per_span_ms(w, n) for w in workers],
        "device_ms_by_span": {k: 1000.0 * v / n for k, v in
                              sorted(device.items(), key=lambda kv: -kv[1])},
        "eval.ks_device_ms": 1000.0 * device.get("eval.ks", 0.0) / n,
        "eval.score_device_ms": 1000.0 * (device.get("eval.breakscore", 0.0)
                                          + device.get("eval.random", 0.0)) / n,
        "eval.lev_device_ms": 1000.0 * device.get("eval.levenshtein", 0.0) / n,
        "k1_device_s": {"all": k1_all, "eval.levenshtein": k1_by.get("eval.levenshtein", 0.0),
                        "by_span": k1_by},
        "idle_s": idle_ns / 1e9,
        "idle_share_in_program_spans": idle_in_spans / idle_ns if idle_ns else None,
        "idle_gaps": [[spans.label_gap(g0, g1, harness_spans, main_inner, worker, host_ops),
                       (g1 - g0) / 1e9] for g0, g1 in longest],
        "call_share_outside_spans": {"mean": sum(calls) / len(calls), "max": max(calls),
                                     "calls": len(calls)} if calls else None,
        "harness_save_ms": sum(e.end_ns - e.start_ns for e in saves) / 1e6 / n
        if saves else None,
        "eval_spans_ms": eval_ms,
        "eval_stage_ms": stage_ms,
        "counters": rec.counters,
        "counters_per_experiment": {k: v / n for k, v in rec.counters.items()},
    }


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch
    import torch.profiler

    from portbench import harness

    sessions = []
    plain = torch.profiler.profile

    class Kept(plain):
        """The harness's profiler, kept for the reading after the run."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            sessions.append(self)

    torch.profiler.profile = Kept
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                                  torch.device("cuda", 0), ".", t_start=t0)
    finally:
        torch.profiler.profile = plain
    print(json.dumps(result), flush=True)
    if spans.last is None:
        print("the program kept no record of the window", file=sys.stderr)
        return 1
    t = time.perf_counter()
    report = analyse(spans.events(sessions[-1]), spans.last, result["attempted"])
    report["read_s"] = time.perf_counter() - t
    out = args.out or os.path.join("build", f"attribute_{args.workload}_{args.seed}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"result": result, "report": report}, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
