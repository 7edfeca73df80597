"""k-mer counting (mirrors genomeassembler_dev_tpu/ops/histogram.py), with
the histogram kernel of csrc/histogram.cu.

The kernel replaces the TPU kernel
genomeassembler_dev_tpu/ops/pallas/histogram_kernel.py (`_kernel`, wrapper
`count_kmers_mxu_pallas`): per-row counts of masked codes. For CUDA tensors
`count_kmers_batched` launches it on the current stream or raises; for CPU
tensors it runs the plain version, a flat bincount of row * bins + code,
which is also the kernel's oracle. Invalid entries are dropped, and so are
codes outside [0, bins).
"""

from __future__ import annotations

import ctypes

import torch

from genomeassembler_dev_tpu_torch.ops import cuda_build

_SLICE_BINS = 16384  # 64 KiB of shared-memory counters per block
_FILL_BLOCKS = 528  # 4 blocks for each of the H100's 132 SMs
_PART_LEN = 2048  # the shortest part of a row that a block streams


def _declare(lib: ctypes.CDLL) -> None:
    lib.gadev_histogram_launch.restype = ctypes.c_int
    lib.gadev_histogram_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


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
    # codes of 4^k bins fit int32 for k <= 15; larger values are out of range
    codes = codes.clamp(-1, num_bins).to(torch.int32).contiguous()
    valid = valid.contiguous()
    slice_bins = min(num_bins, _SLICE_BINS)
    blocks = B * -(-num_bins // slice_bins)
    n_parts = max(1, min(-(-N // _PART_LEN), -(-_FILL_BLOCKS // blocks)))
    alloc = torch.zeros if n_parts > 1 else torch.empty
    out = alloc((B, num_bins), dtype=torch.int32, device=codes.device)
    lib = cuda_build.load("histogram", _declare)
    err = lib.gadev_histogram_launch(
        codes.data_ptr(), valid.data_ptr(), out.data_ptr(), B, N, num_bins,
        slice_bins, n_parts, *cuda_build.launch_args(codes))
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
