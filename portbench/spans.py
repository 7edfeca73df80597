"""The program's own spans and counters of a traced window, and where they
meet the device trace.

In a traced run the program (its utils/profiling.py) keeps every span and
counter of the window in memory, on the clock of the trace's events, on
every thread; `record` takes them over once a run for the metric readers
that name them. A program that keeps no such record (one older than its
`collect`) gives None, and so do the readers.

The rest works on plain tuples, so it can be held against hand-built
events: `device_by_span` gives each device operation's time to the
program span on the launching thread that was open when its launch ran
(kernel and launch paired by correlation id), `idle_gaps` finds the
window's idle stretches as trace.summarize does, and `label_gap` names one
by the innermost harness and program spans around it.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from portbench.trace import SPAN_PREFIX

# the last record taken over, for a tool that runs harness.run_cell and
# reads the record after it (portbench/attribute.py)
last = None


def record(run):
    """The program's record of the run's traced window (its `spans`, each
    with name, thread, parent, start_ns and end_ns, its `counters` and the
    `owner` thread, whose spans are also record_functions of the trace),
    taken over from the program once and kept on the run; None in a run
    without a trace or where the program keeps no record."""
    global last
    if run.trace is None:
        return None
    if not hasattr(run, "program_record"):
        try:
            from genomeassembler_dev_tpu_torch.utils.profiling import collect
        except ImportError:
            run.program_record = None
        else:
            run.program_record = collect()
        last = run.program_record
    return run.program_record


def span_ms_per_experiment(run, name: str) -> float | None:
    """Host milliseconds of every span `name` of the window, per experiment
    written (fillers count for nothing, as the StageTimer readers divide);
    None where the window has no such span."""
    rec = record(run)
    if rec is None or not run.experiments:
        return None
    spans = [s for s in rec.spans if s.name == name]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(run.experiments)


def counter(run, name: str) -> int | None:
    rec = record(run)
    return None if rec is None else rec.counters.get(name)


# -- the device trace against the program's spans ----------------------------

@dataclass(frozen=True)
class Event:
    """One event of the trace, reduced to what attribution needs. `kind` is
    "device" (work on the card), "device annotation" (the card's copy of a
    record_function span: no work), "launch" (a CUDA runtime or driver call
    on the host), "annotation" (a record_function span on the host) or
    "host" (any other host operation); `thread` is the profiler's thread id."""

    name: str
    kind: str
    start_ns: int
    end_ns: int
    thread: int
    correlation: int


def events(prof) -> list[Event]:
    """The Events of a torch.profiler session."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        span = e.is_user_annotation() or name.startswith(SPAN_PREFIX)
        if e.device_type() == DeviceType.CUDA:
            kind = "device annotation" if span else "device"
        elif span:
            kind = "annotation"
        elif name.startswith(("cuda", "cu")) and e.correlation_id():
            kind = "launch"
        else:
            kind = "host"
        start = e.start_ns()
        out.append(Event(name, kind, start, start + e.duration_ns(), e.start_thread_id(),
                         e.correlation_id()))
    return out


def main_thread(evs: list[Event], window_span: str) -> int:
    """The profiler's id of the thread that ran the harness's window span."""
    return next(e.thread for e in evs if e.name == window_span and e.kind == "annotation"
                and e.end_ns > e.start_ns)


class Innermost:
    """The innermost of one thread's properly nested spans at a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
        self.starts = [s.start_ns for s in self.spans]
        self.up = []  # each span's enclosing span, by index, or -1
        stack = []
        for i, s in enumerate(self.spans):
            while stack and self.spans[stack[-1]].end_ns < s.end_ns:
                stack.pop()
            self.up.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int):
        """The innermost span open at t, or None. Of the spans that started
        by t, the latest one that is still open is an ancestor of the latest
        one of all."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i].end_ns < t:
            i = self.up[i]
        return self.spans[i] if i >= 0 else None


def device_by_span(evs: list[Event], program_spans, thread: int, lo_ns: int | None = None,
                   hi_ns: int | None = None, substring: str = "") -> dict[str, float]:
    """Device seconds of every device operation (whose name holds
    `substring`) launched in [lo, hi] (the whole trace by default), by the
    innermost of `program_spans` (the spans of the profiler's thread
    `thread`) open at its launch: "-" collects launches of that thread under
    no span, "other threads" those of other threads and "?" device
    operations whose launch the trace does not hold."""
    launch = {e.correlation: e for e in evs if e.kind == "launch"}
    inner = Innermost(program_spans)
    out: dict[str, float] = {}
    for e in evs:
        if e.kind != "device" or substring not in e.name:
            continue
        at = launch.get(e.correlation)
        if at is None:
            key = "?"
        elif (lo_ns is not None and at.start_ns < lo_ns) or (
                hi_ns is not None and at.start_ns > hi_ns):
            continue
        elif at.thread != thread:
            key = "other threads"
        else:
            span = inner.at(at.start_ns)
            key = span.name if span is not None else "-"
        out[key] = out.get(key, 0.0) + (e.end_ns - e.start_ns) / 1e9
    return out


def device_seconds(evs: list[Event], substring: str) -> float:
    return sum((e.end_ns - e.start_ns) / 1e9 for e in evs
               if e.kind == "device" and substring in e.name)


def idle_gaps(evs: list[Event], w0: int, w1: int) -> list[tuple[int, int]]:
    """The stretches of [w0, w1] in which nothing ran on the card, as
    trace.summarize finds them, in time order."""
    device = sorted((max(e.start_ns, w0), min(e.end_ns, w1)) for e in evs
                    if e.kind == "device" and e.end_ns > w0 and e.start_ns < w1)
    gaps, cursor = [], w0
    for s, t in device:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if w1 > cursor:
        gaps.append((cursor, w1))
    return gaps


class Union:
    """The union of a set of spans, for the time of a stretch inside it."""

    def __init__(self, spans):
        self.parts: list[list[int]] = []
        for s in sorted(spans, key=lambda s: s.start_ns):
            if self.parts and s.start_ns <= self.parts[-1][1]:
                self.parts[-1][1] = max(self.parts[-1][1], s.end_ns)
            else:
                self.parts.append([s.start_ns, s.end_ns])
        self.starts = [p[0] for p in self.parts]

    def covered_ns(self, lo: int, hi: int) -> int:
        """Nanoseconds of [lo, hi] inside the union."""
        i = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        total = 0
        for s, t in self.parts[i:]:
            if s >= hi:
                break
            total += max(0, min(t, hi) - max(s, lo))
        return total


def label_gap(g0: int, g1: int, harness_spans: Innermost, main: Innermost,
              worker: Innermost | None, host_ops) -> str:
    """`<harness span> > <program span> (worker: <span>): <host op or python>`
    at the gap's midpoint: the innermost harness span, the innermost program
    span of the main thread and of the worker, and the host operation that
    covers at least half of the gap most."""
    mid = (g0 + g1) // 2
    h = harness_spans.at(mid)
    p = main.at(mid)
    w = worker.at(mid) if worker is not None else None
    label = h.name[len(SPAN_PREFIX):] if h is not None else "-"
    label += f" > {p.name if p is not None else '-'}"
    if w is not None:
        label += f" (worker: {w.name})"
    best, best_overlap = None, 0
    for op in host_ops:
        overlap = min(op.end_ns, g1) - max(op.start_ns, g0)
        if overlap > best_overlap:
            best, best_overlap = op.name, overlap
    what = best if best is not None and best_overlap >= (g1 - g0) // 2 else (
        "python or native host code")
    return f"{label}: {what}"[:200]
