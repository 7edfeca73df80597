"""Device traces (the port's counterpart of genomeassembler_dev_tpu/utils/profiling.py).

The reference's only tracing is wall-clock stage prints
(lib/DeNovoAssembler.R:52-56); StageTimer keeps that contract. This module
adds real device traces on top: wrap any region in `trace(logdir)` and open
the file it writes in Perfetto (ui.perfetto.dev) or TensorBoard's profiler
plugin to see every kernel on the card (the hand-written ones of csrc/
under their own names), the host's launches and the named sub-regions of
`annotate`.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed region: CPU activity,
    and CUDA activity when a card is present. On exit it writes
    <logdir>/<host>_<pid>.<ns>.pt.trace.json (Chrome trace format). Yields
    the profiler, whose events can also be read in process."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextmanager
def annotate(name: str):
    """Named sub-region within a trace (shows up in the trace viewer)."""
    with torch.profiler.record_function(name):
        yield
