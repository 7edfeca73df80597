"""Contig traversal by pointer doubling (mirrors
genomeassembler_dev_tpu/dbg/doubling.py).

Interior nodes of a unitig chain (in = out = 1) form disjoint linked lists.
Doubling (uptr, uoff) upstream gives every interior node its chain head and
offset; the head's walk id comes from the walk list; the chain's last node
(whose successor is terminal) writes the walk's terminal character and
length. All characters land in the buffer by flat scatters.
"""

from __future__ import annotations

import torch

PAD = 255


def walk_contigs_doubling(
    node_char: torch.Tensor,  # [V] uint8 last base of each node
    succ: torch.Tensor,  # [V] int64 successor node index (-1 if out != 1)
    pred: torch.Tensor,  # [V] int64 predecessor node index (-1 if in != 1)
    branch: torch.Tensor,  # [V] bool
    out_deg: torch.Tensor,  # [V] int
    walk_start: torch.Tensor,  # [W] int64 node index (edge suffix), -1 invalid
    walk_prefix: torch.Tensor,  # [W] int64 (k-1)-mer code of the branch prefix
    walk_valid: torch.Tensor,  # [W] bool
    k: int,
    max_len: int,
):
    """Returns (buf [W, max_len] uint8, lens [W] int64, overflow [W] bool)."""
    dev = node_char.device
    V = node_char.shape[0]
    W = walk_start.shape[0]
    if W == 0:
        return (torch.full((0, max_len), PAD, dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    self_idx = torch.arange(V, device=dev)
    terminal = branch | (out_deg == 0)

    # --- upstream doubling: head + offset for interior nodes ---------------
    interior = ~terminal  # in == 1 and out == 1, so pred >= 0
    has_pred = pred >= 0
    pred_c = pred.clamp(min=0)
    head = interior & (~has_pred | terminal[pred_c])
    up = interior & ~head & has_pred
    uptr = torch.where(up, pred_c, self_idx)
    uoff = up.to(torch.int64)
    # 2^n_iters > min(max_len, V): a chain that has not reached its head by
    # then is longer than max_len and is flagged as overflow below
    for _ in range(max(1, min(max_len, V).bit_length())):
        uoff = uoff + uoff[uptr]
        uptr = uptr[uptr]

    # --- walk ids at heads: a valid walk's non-terminal start is a head, and
    # has in-degree 1, so no two walks share one -------------------------
    s_c = walk_start.clamp(0, V - 1)
    s_term = terminal[s_c]
    start_nonterm = walk_valid & ~s_term
    start_term = walk_valid & s_term
    wids = torch.arange(W, device=dev)
    head_walk = torch.full((V,), -1, dtype=torch.int64, device=dev)
    head_walk[walk_start[start_nonterm]] = wids[start_nonterm]

    # --- characters, by flat scatters into [W * max_len] -------------------
    flat = torch.full((W * max_len,), PAD, dtype=torch.uint8, device=dev)
    wid = head_walk[uptr]  # [V] walk id of each node's chain (or -1)
    node_ok = interior & (wid >= 0)
    idx_i = wid * max_len + torch.clamp(k - 1 + uoff, max=max_len - 1)
    flat[idx_i[node_ok]] = node_char[node_ok]

    # the chain's last node writes the terminal character and the length
    succ_c = succ.clamp(min=0)  # interior => succ >= 0
    is_last = node_ok & terminal[succ_c]
    idx_l = wid * max_len + torch.clamp(k + uoff, max=max_len - 1)
    flat[idx_l[is_last]] = node_char[succ_c][is_last]
    lens0 = torch.zeros(W, dtype=torch.int64, device=dev)
    lens0[wid[is_last]] = (k + 1 + uoff)[is_last]

    # walks whose start node is terminal have length k and the start node's
    # own character at column k-1
    idx_t = wids * max_len + (k - 1)
    flat[idx_t[start_term]] = node_char[s_c][start_term]

    buf = flat.view(W, max_len)
    shifts = 2 * (k - 2 - torch.arange(k - 1, device=dev))
    prefix_chars = ((walk_prefix[:, None] >> shifts[None, :]) & 3).to(torch.uint8)
    buf[:, : k - 1] = torch.where(walk_valid[:, None], prefix_chars,
                                  torch.full_like(prefix_chars, PAD))

    lens = torch.where(walk_valid, torch.where(start_term, k, lens0), 0)
    # an interior-start walk whose last node never reached its head has
    # lens0 == 0: its chain is longer than max_len
    overflow = walk_valid & ((lens > max_len) | (start_nonterm & (lens0 == 0)))
    return buf, lens, overflow
