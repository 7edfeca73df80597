"""Stage banners and timing (mirrors genomeassembler_dev_tpu/utils/timers.py),
with a device synchronise at the end of each stage on CUDA so a stage's time
includes the kernels it queued. Each stage is also a span of
utils/profiling.py named by its message, so a trace places it on its clock."""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from genomeassembler_dev_tpu_torch.utils.profiling import annotate


class StageTimer:
    """Collects per-stage wall times; optionally prints reference-style
    banners (message dot-padded to 70 columns, then 'DONE! -- <t> <unit>')."""

    def __init__(self, device, verbose: bool = True):
        self.device = torch.device(device)
        self.verbose = verbose
        self.times: dict[str, float] = {}

    @contextmanager
    def stage(self, msg: str):
        if self.verbose:
            print(f"{msg}{'.' * max(0, 70 - len(msg))}", end="", flush=True)
        with annotate(msg):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                self.times[msg] = self.times.get(msg, 0.0) + dt
                if self.verbose:
                    unit, val = ("secs", dt) if dt < 60 else ("mins", dt / 60)
                    print(f"DONE! -- {val:.3g} {unit}")
