"""Batched two-sample Kolmogorov-Smirnov statistic (mirrors
genomeassembler_dev_tpu/ops/ks.py).

Each row's sample is pooled with the second sample (one shared [M], or one
a row [B, M]: each segment of a batch has its own track) and sorted; both ECDFs
are cumulative sums of origin weights along the sorted order, and the gap is
read only at the end of each tie run (right-continuous ECDFs, ties across
the two samples included, as R's ks.test).

K4 (csrc/ks.cu, wrapper `ks_2samp_sparse`) computes the same statistic on
the card for rows whose entries are mostly 0.0, as breakscore's path_freq
rows are: it sorts only each row's nonzero values and counts the zeros as
one tie run. The callers take it for every CUDA path_freq row
(pipeline/evaluate.py, parallel/sharding.py); the pooled sort stays for CPU
rows, the velvet path's masked profile and as K4's oracle. K4 replaces no
TPU kernel: the JAX package sorts the pooled rows with jnp.sort.
"""

from __future__ import annotations

import ctypes

import torch

from genomeassembler_dev_tpu_torch.ops import cuda_build

# the most keys a row keeps in K4's shared memory (128 KiB of float32; more
# go to a global scratch row) and its block's threads: csrc/ks.cu's
# kSharedCapacity and kThreads, checked against the library when it loads
SHARED_CAPACITY = 32768
THREADS = 512
MIN_CAPACITY = 32


def _ks_from_pooled(values: torch.Tensor, wx: torch.Tensor,
                    wy: torch.Tensor) -> torch.Tensor:
    """values/wx/wy: [B, P]; weights sum to 1 per row (0 on padding).
    Returns [B] float32 statistics. The float32 weights are summed in
    float64, so the result does not depend on the summation order."""
    order_vals, order = torch.sort(values, dim=1)
    cx = torch.cumsum(wx.gather(1, order).double(), dim=1)
    cy = torch.cumsum(wy.gather(1, order).double(), dim=1)
    gap = (cx - cy).abs()
    nxt = torch.cat([order_vals[:, 1:],
                     torch.full_like(order_vals[:, :1], float("inf"))], dim=1)
    run_end = (order_vals != nxt) & torch.isfinite(order_vals)
    return torch.where(run_end, gap, 0.0).amax(dim=1).to(torch.float32)


def batched_ks_2samp_masked(x_rows: torch.Tensor, x_valid: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
    """KS statistic of the valid entries of each row of x_rows [B, N] vs the
    shared sample y [M], or vs its own row of y [B, M]. Rows with no valid
    entries return NaN."""
    B, N = x_rows.shape
    M = y.shape[-1]
    dev = x_rows.device
    n_valid = x_valid.sum(dim=1)
    xm = torch.where(x_valid, x_rows.float(), float("inf"))
    values = torch.cat([xm, y.float().expand(B, M)], dim=1)
    inv_n = (1.0 / n_valid.clamp(min=1).float())[:, None]
    wx = torch.cat([torch.where(x_valid, inv_n, 0.0),
                    torch.zeros(B, M, device=dev)], dim=1)
    wy = torch.cat([torch.zeros(B, N, device=dev),
                    torch.full((B, M), 1.0 / M, dtype=torch.float32, device=dev)],
                   dim=1)
    d = _ks_from_pooled(values, wx, wy)
    return torch.where(n_valid > 0, d, float("nan"))


def batched_ks_2samp(x_rows: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """KS statistic of each full row of x_rows [B, N] vs the shared sample
    y [M], or vs its own row of y [B, M]. Rows containing NaN (no matched
    reads) return NaN."""
    nan = torch.isnan(x_rows)
    d = batched_ks_2samp_masked(torch.where(nan, 0.0, x_rows),
                                torch.ones_like(nan), y)
    return torch.where(nan.any(dim=1), float("nan"), d)


def capacity(nonzero_bound: int, N: int) -> int:
    """The keys K4 gives a row of N entries of which at most nonzero_bound
    are not 0.0: the next power of two of the smaller, at least
    MIN_CAPACITY (a row sorts only as many as it holds). Up to
    SHARED_CAPACITY they are shared memory, above it a global scratch row."""
    if nonzero_bound < 0:
        raise ValueError(f"a bound of {nonzero_bound} nonzero entries a row")
    cap = MIN_CAPACITY
    while cap < min(nonzero_bound, N):
        cap *= 2
    return cap


def weights(N: int, M: int) -> tuple[float, float]:
    """The float32 weights of an entry of x and of y that the pooled sort
    gives (batched_ks_2samp_masked: a float32 reciprocal, and 1/M rounded to
    float32), as Python floats."""
    wx = torch.reciprocal(torch.tensor(float(N), dtype=torch.float32)).item()
    return wx, torch.tensor(1.0 / M, dtype=torch.float32).item()


def _declare(lib: ctypes.CDLL) -> None:
    lib.gadev_ks_launch.restype = ctypes.c_int
    lib.gadev_ks_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                    + [ctypes.c_double] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.gadev_ks_shared_capacity.restype = lib.gadev_ks_threads.restype = ctypes.c_int
    lib.gadev_ks_shared_capacity.argtypes = lib.gadev_ks_threads.argtypes = []
    built = (lib.gadev_ks_shared_capacity(), lib.gadev_ks_threads())
    if built != (SHARED_CAPACITY, THREADS):
        raise RuntimeError(f"csrc/ks.cu is built for (capacity, threads) {built}, the plan "
                           f"assumes {(SHARED_CAPACITY, THREADS)}")


def ks_2samp_sparse(x_rows: torch.Tensor, y: torch.Tensor, nonzero_bound: int) -> torch.Tensor:
    """K4: batched_ks_2samp of float32 CUDA rows x_rows [B, N], each with at
    most nonzero_bound entries that are not 0.0, vs float32 y [G, M] (G
    divides B; row b takes y[b // (B // G)]). Returns [B] float32, NaN for a
    row holding NaN or more nonzero entries than its capacity (`capacity`).
    Sorts y's rows and launches csrc/ks.cu on the current stream, or raises;
    x_rows lies on a 16-byte boundary with N % 4 == 0 (16-byte loads)."""
    if x_rows.dim() != 2 or y.dim() != 2:
        raise ValueError(f"x_rows must be [B, N] and y [G, M], got {tuple(x_rows.shape)} "
                         f"and {tuple(y.shape)}")
    if x_rows.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"x_rows and y must be float32, got {x_rows.dtype} and {y.dtype}")
    (B, N), (G, M) = x_rows.shape, y.shape
    if N == 0 or N % 4 or M == 0 or G == 0 or B % G:
        raise ValueError(f"x_rows {tuple(x_rows.shape)} vs y {tuple(y.shape)}: K4 takes "
                         f"N % 4 == 0, N, M >= 1 and G rows of y dividing B")
    if not (x_rows.is_contiguous() and y.is_contiguous()) or x_rows.data_ptr() % 16:
        raise ValueError("x_rows and y must be contiguous, x_rows on a 16-byte boundary")
    cap = capacity(nonzero_bound, N)
    if x_rows.device.type != "cuda" or y.device != x_rows.device:
        raise ValueError(f"K4 takes CUDA tensors on one device, got {x_rows.device} and "
                         f"{y.device}")
    ys = torch.sort(y, dim=1).values  # each track once a call
    out = torch.empty(B, dtype=torch.float32, device=x_rows.device)
    scratch = (torch.empty((B, cap), dtype=torch.float32, device=x_rows.device)
               if cap > SHARED_CAPACITY else None)
    lib = cuda_build.load("ks", _declare)
    err = lib.gadev_ks_launch(
        x_rows.data_ptr(), ys.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, N, M, B // G, cap,
        *weights(N, M), *cuda_build.launch_args(x_rows))
    if err != 0:
        raise RuntimeError(f"KS kernel launch failed: CUDA error {err}")
    ks_2samp_sparse.launches += 1
    return out


# kernel launches since the last reset
ks_2samp_sparse.launches = 0
