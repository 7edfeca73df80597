"""Batched two-sample Kolmogorov-Smirnov statistic (mirrors
genomeassembler_dev_tpu/ops/ks.py).

Each row's sample is pooled with the second sample (one shared [M], or one
a row [B, M]: each segment of a batch has its own track) and sorted; both ECDFs
are cumulative sums of origin weights along the sorted order, and the gap is
read only at the end of each tie run (right-continuous ECDFs, ties across
the two samples included, as R's ks.test).
"""

from __future__ import annotations

import torch


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
