"""Device traces, and the program's own spans and counters (the port's
counterpart of genomeassembler_dev_tpu/utils/profiling.py).

The reference's only tracing is wall-clock stage prints
(lib/DeNovoAssembler.R:52-56); StageTimer keeps that contract. This module
adds real device traces on top: wrap any region in `trace(logdir)` and open
the file it writes in Perfetto (ui.perfetto.dev) or TensorBoard's profiler
plugin to see every kernel on the card (the hand-written ones of csrc/
under their own names), the host's launches and the named sub-regions of
`annotate`.

`annotate(name)` and `count(name, n)` record only while a torch.profiler
session records: `trace()` opens one, and so may any caller (a benchmark's
traced run). The flag they read is torch.autograd.profiler's own, so with
no session open a span or a counter costs one check of it: no
record_function, no clock read, no allocation. While a session records,
each span is kept in memory (name, thread, parent span, start and end in
epoch nanoseconds, the clock of the profiler's events) on every thread,
the merge worker's included, whose record_functions the profiler does not
keep; on the thread that owns the session a span also opens a
record_function, so it shows in the trace file. `collect()` hands over and
clears what was recorded.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _session

if not hasattr(_session, "_is_profiler_enabled"):  # torch < 2.1
    raise ImportError("torch.autograd.profiler has no _is_profiler_enabled flag")

_OFF = nullcontext()
_lock = threading.Lock()
_ids = itertools.count()
_spans: list[list] = []  # [name, thread, parent, start_ns, end_ns], in order of opening
_counters: dict[str, int] = {}
_open = threading.local()  # .stack: indices of this thread's open spans
_owner = threading.main_thread().ident  # the thread whose spans open record_functions


@dataclass
class Span:
    name: str
    thread: int  # threading.get_ident() of the thread that ran it
    parent: int  # index in Record.spans of the enclosing span of its thread, or -1
    start_ns: int  # epoch ns, the clock of torch.profiler's events
    end_ns: int


@dataclass
class Record:
    spans: list[Span] = field(default_factory=list)
    counters: dict[str, int] = field(default_factory=dict)
    owner: int = 0  # thread whose spans are also record_functions in the trace

    def to_json(self) -> dict:
        return {"owner": self.owner, "counters": self.counters,
                "spans": [vars(s) for s in self.spans]}


def tracing() -> bool:
    """Whether spans and counters record now (a torch.profiler session is
    recording); a site whose count takes work asks this first."""
    return _session._is_profiler_enabled


class _Span:
    __slots__ = ("entry", "fn", "stack")

    def __init__(self, name: str):
        self.entry = [name, threading.get_ident(), -1, 0, 0]

    def __enter__(self):
        entry = self.entry
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.stack = stack
        with _lock:
            if stack:
                entry[2] = stack[-1]
            stack.append(next(_ids))
            _spans.append(entry)
        self.fn = None
        if entry[1] == _owner:
            self.fn = torch.profiler.record_function(entry[0])
            self.fn.__enter__()
        entry[3] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.entry[4] = time.time_ns()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        self.stack.pop()
        return False


def annotate(name: str):
    """A named span: a context manager that records while a torch.profiler
    session records, and otherwise does nothing."""
    if not _session._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while a torch.profiler session records."""
    if not _session._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def collect() -> Record:
    """The spans and counters recorded since the last collect, which are
    then cleared. Call it with no span open: one still open reads end_ns 0."""
    global _ids
    with _lock:
        spans, counters = _spans[:], dict(_counters)
        _spans.clear()
        _counters.clear()
        _ids = itertools.count()
    return Record([Span(*s) for s in spans], counters, _owner)


@contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed region: CPU activity,
    and CUDA activity when a card is present. On exit it writes
    <logdir>/<host>_<pid>.<ns>.pt.trace.json (Chrome trace format) and the
    program's spans and counters of the region (every thread's) as
    <logdir>/<host>_<pid>.<ns>.program.json. Yields the profiler, whose
    events can also be read in process; its `program` attribute holds the
    region's Record after the exit."""
    global _owner
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    collect()  # what an earlier session left
    owner, _owner = _owner, threading.get_ident()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
            yield prof
    finally:
        _owner = owner
    prof.program = collect()
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.program.json")
    with open(path, "w") as f:
        json.dump(prof.program.to_json(), f)
