"""k-mer counting (mirrors genomeassembler_dev_tpu/ops/histogram.py), with
the histogram kernel of csrc/histogram.cu.

The kernel replaces the TPU kernel
genomeassembler_dev_tpu/ops/pallas/histogram_kernel.py (`_kernel`, wrapper
`count_kmers_mxu_pallas`): per-row counts of masked codes. For CUDA tensors
`count_kmers_batched` launches it on the current stream or raises; for CPU
tensors it runs the plain version, a flat bincount of row * bins + code,
which is also the kernel's oracle. Invalid entries are dropped, and so are
codes outside [0, bins), by the kernel itself as it reads int32 or int64
codes. `launch_plan` sizes the kernel's slices, parts and counter copies;
what bounds the kernel is described at the top of csrc/histogram.cu.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from genomeassembler_dev_tpu_torch.ops import cuda_build

SLICE_BINS = 65536  # 128 KiB of packed 16-bit counters, one block's slice
MAX_PART = 65532  # entries of a part: a 16-bit counter never carries; a multiple of 4
FEW_BINS = 1024  # up to this many bins a slice, each warp counts into its own copy
THREADS = 1024


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class HistogramPlan(NamedTuple):
    """How csrc/histogram.cu lays a [B, N] -> [B, bins] count on the card:
    a grid of (slices x parts, B) blocks."""
    slice_bins: int  # bins a block counts: all of them, or 65,536
    n_slices: int
    n_parts: int  # parts of a row; more than one adds into a zeroed output
    chunk: int  # entries of a part, at most MAX_PART
    copies: int  # counter copies a block: 1, or one a warp for few bins
    threads: int
    shared_bytes: int  # copies x whole 16-byte vectors of packed counters


def launch_plan(N: int, bins: int) -> HistogramPlan:
    """The kernel's launch for rows of N entries into `bins` bins; each row
    is one grid row of blocks, so the plan does not depend on the batch."""
    slice_bins = min(bins, SLICE_BINS)
    n_parts = max(1, _cdiv(N, MAX_PART))
    chunk = 4 * _cdiv(_cdiv(N, n_parts), 4)  # at most MAX_PART, a multiple of 4
    copies = THREADS // 32 if slice_bins <= FEW_BINS else 1
    copy_words = 4 * _cdiv(_cdiv(slice_bins, 2), 4)  # two counters a 32-bit word
    return HistogramPlan(slice_bins, _cdiv(bins, slice_bins), n_parts, chunk, copies,
                         THREADS, 4 * copies * copy_words)


def _declare(lib: ctypes.CDLL) -> None:
    lib.gadev_histogram_launch.restype = ctypes.c_int
    lib.gadev_histogram_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p])


def count_kmers_batched_plain(codes: torch.Tensor, valid: torch.Tensor,
                              num_bins: int) -> torch.Tensor:
    """The plain version: codes [B, N] -> counts [B, num_bins] int32."""
    B = codes.shape[0]
    c = codes.long()
    keep = valid & (c >= 0) & (c < num_bins)
    row = torch.arange(B, device=codes.device)[:, None].expand_as(c)
    flat = (row * num_bins + c)[keep]
    return torch.bincount(flat, minlength=B * num_bins).view(B, num_bins).to(torch.int32)


def count_kmers_batched(codes: torch.Tensor, valid: torch.Tensor,
                        num_bins: int) -> torch.Tensor:
    """Per-row histograms: codes [B, N] (int32 or int64) under valid [B, N]
    -> counts [B, num_bins] int32."""
    if codes.device != valid.device:
        raise ValueError(f"inputs on several devices: {codes.device}, {valid.device}")
    if codes.dim() != 2 or valid.shape != codes.shape:
        raise ValueError(f"codes and valid must be [B, N], got {tuple(codes.shape)} "
                         f"and {tuple(valid.shape)}")
    if codes.device.type == "cpu":
        return count_kmers_batched_plain(codes, valid, num_bins)
    if codes.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {codes.device}")
    if codes.dtype not in (torch.int32, torch.int64) or valid.dtype != torch.bool:
        raise ValueError(f"codes must be int32 or int64 and valid bool, got "
                         f"{codes.dtype} and {valid.dtype}")
    B, N = codes.shape
    if not 0 < num_bins < 2**31 or B > 65535:
        raise ValueError(f"{num_bins} bins or {B} rows: beyond the kernel's grid")
    codes = codes.contiguous()
    valid = valid.contiguous()
    plan = launch_plan(N, num_bins)
    alloc = torch.zeros if plan.n_parts > 1 else torch.empty
    out = alloc((B, num_bins), dtype=torch.int32, device=codes.device)
    vec = codes.data_ptr() % 16 == 0 and valid.data_ptr() % 4 == 0
    lib = cuda_build.load("histogram", _declare)
    err = lib.gadev_histogram_launch(
        codes.data_ptr(), valid.data_ptr(), out.data_ptr(), B, N, num_bins,
        plan.slice_bins, plan.n_parts, plan.chunk, plan.copies, plan.threads,
        plan.shared_bytes, codes.element_size(), int(vec), *cuda_build.launch_args(codes))
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {err}")
    count_kmers_batched.launches += 1
    return out


# kernel launches since the last reset; CPU calls do not count
count_kmers_batched.launches = 0


def count_kmers(codes: torch.Tensor, valid: torch.Tensor, num_bins: int,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """Histogram of all k-mer codes: counts [num_bins], int32 unweighted
    (the histogram kernel over one flattened row) or in the weights' dtype
    (plain index_add_). Invalid entries are dropped."""
    flat = codes.reshape(-1)
    v = valid.reshape(-1)
    if weights is None:
        return count_kmers_batched(flat[None, :], v[None, :], num_bins)[0]
    c = flat.long()
    keep = v & (c >= 0) & (c < num_bins)
    w = weights.reshape(-1)
    out = torch.zeros(num_bins, dtype=w.dtype, device=codes.device)
    return out.index_add_(0, c[keep], w[keep])
