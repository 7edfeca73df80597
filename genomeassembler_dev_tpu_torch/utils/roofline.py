"""The least time one NVIDIA H100 SXM could take for a piece of work (NVIDIA's
data sheet; 700 W): the bytes it must move over the memory rate, or the
operations it must do over the card's issue rate. `bench.py` and
chip_smoke.py state their kernels' and steps' shares against these."""

from __future__ import annotations

import torch

HBM_BYTES_PER_MS = 3.35e9  # 3.35 TB/s of device memory
# 132 SMs x 4 warp instructions of 32 lanes a cycle x 1.98 GHz: the most
# scalar operations of any type the card issues, its 67 TFLOP/s of float32
# with an FMA counted once. (64 integer lanes an SM, 16.7 T/s, is no bound:
# the prefix-min kernel beat it at the repeat-heavy shape on an H100.)
OPS_PER_MS = 132 * 128 * 1.98e6
CELL_OPS = 5  # prefix-min: the compare, the substitution add, a three-way min (two DPX ops)
WORD_STEP_OPS = 20  # Myers: Hyyro's step on one 32-bit word, as written in csrc/myers.cu


def bytes_bound_ms(*tensors: torch.Tensor) -> float:
    """Milliseconds to move every byte of `tensors` once at HBM_BYTES_PER_MS."""
    return sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_MS


def lev_bound_ms(lens: torch.Tensor, n: int, kind: str) -> float:
    """Integer-operation bound of a Levenshtein call against an n-base
    target: the cells (prefix-min) or 32-bit word steps (Myers) that the
    queries' real lengths need, at OPS_PER_MS."""
    lens = lens.long().clamp(min=0)
    if kind == "cells":
        return n * int(lens.sum()) * CELL_OPS / OPS_PER_MS
    return n * int(((lens + 31) // 32).sum()) * WORD_STEP_OPS / OPS_PER_MS
