"""Batched Levenshtein distance (mirrors genomeassembler_dev_tpu/ops/edit_distance.py).

The plain version is the prefix-min row DP. With
c[j] = min(dp[j] + 1, dp[j-1] + sub_j) and c[0] the row boundary,

    dp_new[j] = min_{l <= j} (c[l] + (j - l)) = cummin(c[j] - j) + j,

one `torch.cummin` per target character. It is the CPU route and the oracle
of the Myers kernel (ops/myers.py), which `batched_levenshtein_auto` takes
for CUDA tensors.

Modes (edlib task naming):
  NW: global distance, answer dp_n[len_q].
  HW: infix, target prefix/suffix gaps free: row boundary 0, answer the
      minimum over rows of dp_i[len_q].
"""

from __future__ import annotations

import torch


def batched_levenshtein(
    queries: torch.Tensor,  # [B, M] base codes (pad arbitrary)
    query_lens: torch.Tensor,  # [B] int
    target: torch.Tensor,  # [N] base codes, exact length
    mode: str = "NW",
) -> torch.Tensor:
    """Edit distance of each query vs one shared target. Returns [B] int32."""
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    B, M = queries.shape
    dev = queries.device
    idx = torch.arange(M + 1, dtype=torch.int32, device=dev)
    dp = idx[None, :].expand(B, M + 1).contiguous()
    q = queries.to(torch.int32)
    lens = query_lens.long().clamp(min=0)[:, None]
    best = dp.gather(1, lens)[:, 0]
    boundary = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for i, t_char in enumerate(target.to(torch.int32), start=1):
        sub = (q != t_char).to(torch.int32)
        c_mid = torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + sub)
        c = torch.cat([boundary if mode == "HW" else boundary + i, c_mid], dim=1)
        dp = torch.cummin(c - idx, dim=1).values + idx
        if mode == "HW":
            best = torch.minimum(best, dp.gather(1, lens)[:, 0])
    if mode == "HW":
        return best
    return dp.gather(1, lens)[:, 0]


def batched_levenshtein_auto(queries: torch.Tensor, query_lens: torch.Tensor,
                             target: torch.Tensor, mode: str = "NW") -> torch.Tensor:
    """The Myers kernel's wrapper: the CUDA kernel for CUDA tensors, this
    module's plain DP for CPU tensors. `target` must be exact-length."""
    from genomeassembler_dev_tpu_torch.ops.myers import batched_levenshtein_myers

    return batched_levenshtein_myers(queries, query_lens, target, mode=mode)
