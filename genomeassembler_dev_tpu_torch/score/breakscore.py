"""Breakage scorer (mirrors genomeassembler_dev_tpu/score/breakscore.py).

Every distinct read is matched in every solution (ops/match.py); the break
site is the octamer starting 4 bases before the match, shrunk to a 2/4/6-mer
at the solution's start; read multiplicities are scatter-added into a
[S, 69904] count matrix in the combined table index space, and every
bp_score flavour is a float32 dot product of that matrix with a table.

A group of G segments scores in one call: solutions [G, S, L] with one read
set a segment [G, U, R], as jax.vmap(breakscore) over the group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from genomeassembler_dev_tpu_torch.core.querytable import OFFSETS, TOTAL
from genomeassembler_dev_tpu_torch.ops.match import find_first_match
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes


@dataclass
class BreakScores:
    """Per solution row; a group's fields gain a leading [G]."""
    bp_score: torch.Tensor  # [S] float32
    bp_score_norm_by_break_freqs: torch.Tensor  # [S] float32
    bp_score_norm_by_len: torch.Tensor  # [S] float32
    kmer_breaks: torch.Tensor  # [S] int32 total matched read count
    path_freq: torch.Tensor  # [S, TOTAL] float32, NaN rows when no matches
    site_counts: torch.Tensor  # [S, TOTAL] float32 raw break counts


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [S, F] @ b [F] in full float32. TF32 is switched off first: the JAX
    reference forces HIGHEST precision for these dots, and scores are
    compared at rtol 2e-5. A group a [G, S, F] takes one product a member: a
    BLAS library's summation order may depend on the row count, so this
    keeps each member's scores bit-equal to its own [S, F] call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.dim() == 3:
        return torch.stack([m @ b for m in a])
    return a @ b


def breakscore(
    path_codes: torch.Tensor,  # [S, L] base codes, pad > 3; a group: [G, S, L]
    path_lens: torch.Tensor,  # [S] int32; [G, S]
    read_codes: torch.Tensor,  # [U, R] distinct read base codes; [G, U, R]
    read_counts: torch.Tensor,  # [U] int32 multiplicities; [G, U]
    read_valid: torch.Tensor,  # [U] bool; [G, U]
    probs_combined: torch.Tensor,  # [TOTAL] (true or uniform table)
    break_kmer: int = 8,
) -> BreakScores:
    lead = path_codes.shape[:-1]  # [S] or [G, S]
    path_lens = path_lens.reshape(-1)
    path_codes = path_codes.reshape(-1, path_codes.shape[-1])
    S = path_codes.shape[0]  # every row of the group
    dev = path_codes.device
    found, first = find_first_match(path_codes, path_lens, read_codes, read_valid)
    n_sets = read_codes.shape[0] if read_codes.dim() == 3 else 1

    # break-site combined-table index per (solution, read)
    pos = first.long()  # [S, U]
    start = torch.clamp(pos - break_kmer // 2, min=0)
    ek = torch.full_like(pos, 8)  # matches at 1, 2, 3 shrink the site
    for p, k in ((1, 2), (2, 4), (3, 6)):
        ek = torch.where(pos == p, k, ek)
    win8, _ = kmer_window_codes(path_codes, 8, dtype=torch.int64)  # [S, L-7]
    code8 = win8.gather(1, start.clamp(max=win8.shape[1] - 1))
    site_code = code8 >> (2 * (8 - ek))
    offsets = torch.tensor([OFFSETS[2], OFFSETS[4], OFFSETS[6], OFFSETS[8]],
                           device=dev)
    combined_idx = offsets[(ek >> 1) - 1] + site_code

    # scatter-add read multiplicities into per-solution break counts. The
    # counts are integers below 2^24, exact in float32 in any add order.
    row_counts = read_counts.reshape(n_sets, found.shape[1]).repeat_interleave(S // n_sets, dim=0)
    w = torch.where(found, row_counts, 0).to(torch.float32)
    row = torch.arange(S, device=dev)[:, None].expand_as(combined_idx)
    counts = torch.zeros(S * TOTAL, dtype=torch.float32, device=dev)
    counts.index_add_(0, (row * TOTAL + combined_idx)[found], w[found])
    counts = counts.view(S, TOTAL)
    total = w.sum(dim=1)

    probs = probs_combined.to(torch.float32)
    counts, total = counts.view(lead + (TOTAL,)), total.view(lead)
    bp_score = dot_f32(counts, probs)
    safe_total = total.clamp(min=1.0)[..., None]
    norm_by_breaks = torch.where(total > 0, dot_f32(counts / safe_total, probs), 0.0)
    norm_by_len = bp_score / path_lens.view(lead).to(torch.float32).clamp(min=1.0)
    path_freq = torch.where(total[..., None] > 0, counts / safe_total, float("nan"))
    return BreakScores(
        bp_score=bp_score,
        bp_score_norm_by_break_freqs=norm_by_breaks,
        bp_score_norm_by_len=norm_by_len,
        kmer_breaks=total.to(torch.int32),
        path_freq=path_freq,
        site_counts=counts,
    )
