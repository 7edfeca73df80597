"""The second Levenshtein kernel (csrc/prefix_min.cu) and its wrapper.

Replaces the TPU kernel
genomeassembler_dev_tpu/ops/pallas/edit_distance_kernel.py (`_kernel`,
wrapper `batched_levenshtein_pallas`), the prefix-min row DP. It computes
what the Myers kernel (ops/myers.py) computes, by a cell-by-cell DP run as a
wavefront over a query's lanes, so the two check each other on the card
where the plain DP takes seconds. As in the JAX package, the pipeline's
`batched_levenshtein_auto` dispatches to the Myers kernel only. For CUDA
tensors the wrapper launches the kernel on the current stream or raises;
for CPU tensors it runs the plain DP of ops/edit_distance.py, which is also
the kernel's oracle. `launch_plan` sizes the columns a lane, the lanes and
the bands; it takes every width. What bounds the kernel is described at the
top of csrc/prefix_min.cu.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from genomeassembler_dev_tpu_torch.ops import cuda_build
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein

# the most lanes (threads) of a query, csrc/prefix_min.cu's kMaxLanes and
# its __launch_bounds__; checked against the library when it loads
MAX_LANES = 512
# the kernel's two templates, (C DP columns a lane keeps in registers, R
# rows a lane computes a step): queries of up to 16 x MAX_LANES columns, and
# wider ones
ONE_BLOCK = (16, 4)
BANDED = (32, 4)


class PrefixMinPlan(NamedTuple):
    """How csrc/prefix_min.cu lays queries of at most M columns on the card,
    one block a query."""
    cols_per_lane: int  # C, consecutive DP columns of one lane
    rows_per_step: int  # R, target rows a lane computes at each step
    lanes: int  # threads of one query, a multiple of 32

    @property
    def band_cols(self) -> int:
        """Columns a query covers at once; wider ones run in bands."""
        return self.lanes * self.cols_per_lane


def launch_plan(M: int) -> PrefixMinPlan:
    """The kernel's launch for queries of at most M columns: C columns a
    lane, R rows a step, and as many warps as M needs, up to MAX_LANES
    lanes; wider queries run in bands of MAX_LANES x C columns. C 16 keeps
    more warps busy where a query fits one block, C 32 shortens the chain of
    bands of a wider one."""
    C, R = ONE_BLOCK if M <= ONE_BLOCK[0] * MAX_LANES else BANDED
    return PrefixMinPlan(C, R, min(32 * -(-max(M, 1) // (32 * C)), MAX_LANES))


def _declare(lib: ctypes.CDLL) -> None:
    lib.gadev_prefix_min_launch.restype = ctypes.c_int
    lib.gadev_prefix_min_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.gadev_prefix_min_max_lanes.restype = ctypes.c_int
    lib.gadev_prefix_min_max_lanes.argtypes = []
    if lib.gadev_prefix_min_max_lanes() != MAX_LANES:
        raise RuntimeError(f"csrc/prefix_min.cu is built for "
                           f"{lib.gadev_prefix_min_max_lanes()} lanes, the plan "
                           f"assumes {MAX_LANES}")


def batched_levenshtein_prefix_min(queries: torch.Tensor, query_lens: torch.Tensor,
                                   target: torch.Tensor, mode: str = "NW") -> torch.Tensor:
    """Edit distance of each query [B, M] (uint8 codes, its first
    query_lens[b] positions count) vs one exact-length target [N] (uint8).
    NW: global; HW: infix. An empty query gives N in NW and 0 in HW.
    Returns [B] int32."""
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
    if B and int(query_lens.max()) > M:
        raise ValueError(f"a query length exceeds the query width {M}")
    N = target.shape[0]
    plan = launch_plan(M)
    out = torch.empty(B, dtype=torch.int32, device=queries.device)
    # the bands' hand-off row, only for queries wider than one band
    hbuf = (torch.empty((B, N), dtype=torch.int32, device=queries.device)
            if M > plan.band_cols else None)
    lib = cuda_build.load("prefix_min", _declare)
    err = lib.gadev_prefix_min_launch(
        queries.data_ptr(), query_lens.data_ptr(), target.data_ptr(), out.data_ptr(),
        None if hbuf is None else hbuf.data_ptr(), B, M, N, plan.cols_per_lane,
        plan.rows_per_step, plan.lanes, int(mode == "HW"), *cuda_build.launch_args(queries))
    if err != 0:
        raise RuntimeError(f"prefix-min kernel launch failed: CUDA error {err}")
    batched_levenshtein_prefix_min.launches += 1
    return out


# kernel launches since the last reset; CPU calls do not count
batched_levenshtein_prefix_min.launches = 0
