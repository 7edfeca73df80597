"""Reading a torch.profiler trace of the measured window: the device's busy
time (the union of every operation on the card), device time by operation
name, and the idle gaps labelled with what the host was doing.

The harness marks its own spans with record_function names that start with
`portbench.`; a gap is labelled with the innermost such span around it and
the host operation that overlaps it most.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    window_s: float  # the traced window, from its own span
    busy_s: float  # union of device activity inside the window
    device_s: dict[str, float] = field(default_factory=dict)  # by operation name
    gaps: list[tuple[str, float]] = field(default_factory=list)  # longest first

    def device_seconds(self, substring: str) -> float:
        return sum(s for name, s in self.device_s.items() if substring in name)

    def top_ops(self, n: int = 10) -> list[list]:
        return [[name[:160], s] for name, s in
                sorted(self.device_s.items(), key=lambda kv: -kv[1])[:n]]


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event of the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        # a record_function span also has a device-side copy; it is no work
        on_device = e.device_type() == DeviceType.CUDA and not (
            e.is_user_annotation() or e.name().startswith(SPAN_PREFIX))
        out.append((e.name(), on_device, start, start + e.duration_ns()))
    return out


def summarize(prof, window_span: str, n_gaps: int = 10) -> Trace:
    events = _events(prof)
    win = [e for e in events if not e[1] and e[0] == window_span]
    win.sort(key=lambda e: e[2])
    if not win:
        raise RuntimeError(f"the trace has no span {window_span!r}")
    w0, w1 = win[0][2], win[0][3]
    device = sorted((max(s, w0), min(t, w1), n) for n, d, s, t in events
                    if d and t > w0 and s < w1)
    by_name: dict[str, float] = {}
    for s, t, n in device:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e9
    busy_ns = 0
    gaps_ns = []
    cursor = w0
    for s, t, _ in device:
        if s > cursor:
            gaps_ns.append((cursor, s))
        if t > cursor:
            busy_ns += t - max(s, cursor)
            cursor = t
    if w1 > cursor:
        gaps_ns.append((cursor, w1))
    gaps_ns.sort(key=lambda g: g[0] - g[1])
    gaps_ns = gaps_ns[:n_gaps]
    # only an operation that covers half of a gap can label it
    shortest = min((g1 - g0 for g0, g1 in gaps_ns), default=0)
    host = [e for e in events if not e[1] and e[3] - e[2] >= shortest // 2]
    spans = [e for e in host if e[0].startswith(SPAN_PREFIX) and e[0] != window_span]
    ops = [e for e in host if not e[0].startswith(SPAN_PREFIX)
           and not e[0].startswith("ProfilerStep")]
    gaps = [(_label(g0, g1, spans, ops), (g1 - g0) / 1e9) for g0, g1 in gaps_ns]
    return Trace((w1 - w0) / 1e9, busy_ns / 1e9, by_name, gaps)


def _label(g0: int, g1: int, spans, ops) -> str:
    mid = (g0 + g1) // 2
    around = [e for e in spans if e[2] <= mid <= e[3]]
    span = min(around, key=lambda e: e[3] - e[2])[0][len(SPAN_PREFIX):] if around else "-"
    best, best_overlap = None, 0
    for name, _, s, t in ops:
        overlap = min(t, g1) - max(s, g0)
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    if best is None or best_overlap < (g1 - g0) // 2:
        what = "python or native host code"
    else:
        what = best
    return f"{span}: {what}"[:160]
