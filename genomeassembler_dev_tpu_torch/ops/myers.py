"""The Myers bit-vector Levenshtein kernel (csrc/myers.cu) and its wrapper.

Replaces the TPU kernel genomeassembler_dev_tpu/ops/pallas/myers_kernel.py
(`_kernel`, wrapper `batched_levenshtein_myers`). The kernel is CUDA C++ for
Hopper (sm_90a), built with nvcc at first use (ops/cuda_build.py) and bound
with ctypes. For CUDA tensors the wrapper launches it on the current
stream or raises; for CPU tensors it runs the plain prefix-min DP
(ops/edit_distance.py), which is also the kernel's oracle. The kernel runs
one query's words as a wavefront over a warp or a block of lanes, with
VP/VN in registers and the match masks in shared memory; `launch_plan`
sizes that from the batch and the query width. What bounds the kernel on
the card is described at the top of csrc/myers.cu.

Codes are core/encoding.py's: 0-3 and 255 for any non-ACGT base. Equal
codes match, so N matches N, as in the plain DP and the spec. The wrapper
refuses a target code in 4-254 on either device: the kernel's match masks
have no row for it and would read the N row. A query code there needs no
check: it sets no match bit, and against a target of 0-3 and 255 the
plain DP matches it nowhere either.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from genomeassembler_dev_tpu_torch.ops import cuda_build
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein


def build() -> str:
    """Compile csrc/myers.cu unless built; returns the library's path."""
    return cuda_build.build("myers")[0]


# words a lane keeps in registers -> the most lanes (threads) of a query,
# csrc/myers.cu's max_lanes(S), its templates' __launch_bounds__; checked
# against the library when it loads
MAX_LANES = {1: 32, 2: 32, 4: 32, 8: 512}
# S of a query wider than one warp's 4 x 32 words: at the velvet shape S 8
# (224 lanes) took 21.1 ms, S 4 (416 lanes) 24.6 ms and S 2 (800 lanes)
# 28.8 ms on an H100 80GB HBM3 at 700 W
BLOCK_WORDS_PER_LANE = 8
PEQ_CODES = 6  # match-mask rows a word keeps: A, C, G, T, 255 (N) and outside the target


class MyersPlan(NamedTuple):
    """How csrc/myers.cu lays queries of at most W words on the card, one
    block a query."""
    words_per_lane: int  # S, a strip of consecutive words of one lane
    lanes: int  # threads of one query: 32 (one warp) or a block of warps
    shared_bytes: int  # dynamic shared memory: the warps' mailbox, then the Peq masks

    @property
    def band_words(self) -> int:
        """Words a query covers at once; wider ones run in bands."""
        return self.lanes * self.words_per_lane


def launch_plan(W: int) -> MyersPlan:
    """The kernel's launch for queries of at most W 32-column words. Up to
    128 words a query takes one warp with the fewest words a lane that fits;
    wider ones take a block of warps at BLOCK_WORDS_PER_LANE words a lane, up
    to MAX_LANES, and run in bands above that."""
    for S in (1, 2, 4):
        if W <= 32 * S:
            lanes = 32
            break
    else:
        S = BLOCK_WORDS_PER_LANE
        lanes = min(32 * -(-W // (32 * S)), MAX_LANES[S])
    # int32 words: a two-slot mailbox per warp, then [S][PEQ_CODES][lanes]
    shared = 4 * (2 * (lanes // 32) + S * PEQ_CODES * lanes)
    return MyersPlan(S, lanes, shared)


def _declare(lib: ctypes.CDLL) -> None:
    lib.gadev_myers_launch.restype = ctypes.c_int
    lib.gadev_myers_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.gadev_myers_max_lanes.restype = ctypes.c_int
    lib.gadev_myers_max_lanes.argtypes = [ctypes.c_int]
    built = {S: lib.gadev_myers_max_lanes(S) for S in MAX_LANES}
    if built != MAX_LANES:
        raise RuntimeError(f"csrc/myers.cu is built for lanes {built}, the plan "
                           f"assumes {MAX_LANES}")


def _foreign_codes(target: torch.Tensor) -> torch.Tensor:
    """0-d bool: a code in 4-254 in the target."""
    return ((target > 3) & (target < 255)).any()


FOREIGN_CODES = "target codes 4-254: the Myers kernel takes 0-3 and 255 (core/encoding.py)"


def batched_levenshtein_myers(queries: torch.Tensor, query_lens: torch.Tensor,
                              target: torch.Tensor, mode: str = "NW") -> torch.Tensor:
    """Edit distance of each query [B, M] (uint8 codes 0-3 and 255, its
    first query_lens[b] positions count) vs one exact-length target [N]
    (uint8, the same codes). NW: global; HW: infix. An empty query gives N
    in NW and 0 in HW. Returns [B] int32."""
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    devices = {queries.device, query_lens.device, target.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if queries.device.type == "cpu":
        if bool(_foreign_codes(target)):
            raise ValueError(FOREIGN_CODES)
        return batched_levenshtein(queries, query_lens, target, mode=mode)
    if queries.device.type != "cuda":
        raise ValueError(f"no Myers kernel for device {queries.device}")
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
    if B:  # one read-back for both checks
        longest, foreign = torch.stack([
            query_lens.max(), _foreign_codes(target).to(torch.int32)]).tolist()
        if longest > M:
            raise ValueError(f"a query length exceeds the query width {M}")
        if foreign:
            raise ValueError(FOREIGN_CODES)
    N = target.shape[0]
    W = max(1, -(-M // 32))
    plan = launch_plan(W)
    out = torch.empty(B, dtype=torch.int32, device=queries.device)
    # the bands' hand-off row, only for queries wider than one band
    hbuf = (torch.empty((B, N), dtype=torch.int8, device=queries.device)
            if W > plan.band_words else None)
    lib = cuda_build.load("myers", _declare)
    err = lib.gadev_myers_launch(
        queries.data_ptr(), query_lens.data_ptr(), target.data_ptr(), out.data_ptr(),
        None if hbuf is None else hbuf.data_ptr(), B, M, N, plan.words_per_lane,
        plan.lanes, plan.shared_bytes, int(mode == "HW"), *cuda_build.launch_args(queries))
    if err != 0:
        raise RuntimeError(f"Myers kernel launch failed: CUDA error {err}")
    batched_levenshtein_myers.launches += 1
    return out


# kernel launches since the last reset; CPU calls do not count
batched_levenshtein_myers.launches = 0
