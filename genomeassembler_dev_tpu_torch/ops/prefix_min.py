"""The prefix-min row-DP Levenshtein kernel (csrc/prefix_min.cu) and its
wrapper.

Replaces the TPU kernel
genomeassembler_dev_tpu/ops/pallas/edit_distance_kernel.py (`_kernel`,
wrapper `batched_levenshtein_pallas`). It computes what the Myers kernel
(ops/myers.py) computes, by the other algorithm, so the two check each other
on the card where the plain DP takes seconds. As in the JAX package, the
pipeline's `batched_levenshtein_auto` dispatches to the Myers kernel only.
For CUDA tensors the wrapper launches the kernel on the current stream or
raises; for CPU tensors it runs the plain DP of ops/edit_distance.py, which
is also the kernel's oracle.
"""

from __future__ import annotations

import ctypes

import torch

from genomeassembler_dev_tpu_torch.ops import cuda_build
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein

# the DP row lives in registers: at most 32 columns x 512 threads
# (csrc/prefix_min.cu, gadev_prefix_min_launch)
MAX_WIDTH = 32 * 512


def _declare(lib: ctypes.CDLL) -> None:
    lib.gadev_prefix_min_launch.restype = ctypes.c_int
    lib.gadev_prefix_min_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def batched_levenshtein_prefix_min(queries: torch.Tensor, query_lens: torch.Tensor,
                                   target: torch.Tensor, mode: str = "NW") -> torch.Tensor:
    """Edit distance of each query [B, M] (uint8 codes, its first
    query_lens[b] positions count) vs one exact-length target [N] (uint8).
    NW: global; HW: infix. An empty query gives N in NW and 0 in HW.
    Returns [B] int32. On the card M is at most MAX_WIDTH."""
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    devices = {queries.device, query_lens.device, target.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if queries.device.type == "cpu":
        return batched_levenshtein(queries, query_lens, target, mode=mode)
    if queries.device.type != "cuda":
        raise ValueError(f"no prefix-min kernel for device {queries.device}")
    if queries.dim() != 2 or queries.dtype != torch.uint8:
        raise ValueError(f"queries must be [B, M] uint8, got {tuple(queries.shape)} "
                         f"{queries.dtype}")
    B, M = queries.shape
    if query_lens.shape != (B,) or query_lens.dtype != torch.int32:
        raise ValueError(f"query_lens must be [{B}] int32, got "
                         f"{tuple(query_lens.shape)} {query_lens.dtype}")
    if target.dim() != 1 or target.dtype != torch.uint8:
        raise ValueError(f"target must be [N] uint8, got {tuple(target.shape)} "
                         f"{target.dtype}")
    if not (queries.is_contiguous() and query_lens.is_contiguous()
            and target.is_contiguous()):
        raise ValueError("queries, query_lens and target must be contiguous")
    if M > MAX_WIDTH:
        raise ValueError(f"query width {M} exceeds the kernel's {MAX_WIDTH}")
    if B and int(query_lens.max()) > M:
        raise ValueError(f"a query length exceeds the query width {M}")
    out = torch.empty(B, dtype=torch.int32, device=queries.device)
    lib = cuda_build.load("prefix_min", _declare)
    err = lib.gadev_prefix_min_launch(
        queries.data_ptr(), query_lens.data_ptr(), target.data_ptr(), out.data_ptr(),
        B, M, target.shape[0], int(mode == "HW"), *cuda_build.launch_args(queries))
    if err != 0:
        raise RuntimeError(f"prefix-min kernel launch failed: CUDA error {err}")
    batched_levenshtein_prefix_min.launches += 1
    return out


# kernel launches since the last reset; CPU calls do not count
batched_levenshtein_prefix_min.launches = 0
