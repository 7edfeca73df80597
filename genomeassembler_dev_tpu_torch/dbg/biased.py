"""Breakage-probability-biased dBG traversal (mirrors
genomeassembler_dev_tpu/dbg/biased.py).

Standard traversal stops at every branch node. Biased traversal continues
through branches: at each node it takes the present out-edge whose junction
octamer (the trailing 8-mer of node + candidate base) has the highest
breakage probability, ties going to the smallest base. Walks start from the
same (branch node, out-edge) pairs as the standard walk and stop at a dead
end or at the max_len cap; cycles are possible once branches are passable,
and a capped walk returns overflow=True.

The JAX module has three entry points: a dense 4^(k-1)-node graph for
k <= 10, the sorted-unique int32 graph for k <= 15 and two-word codes for
k 16-31. One int64 code holds k <= 31, so here the sorted-unique builder of
dbg/graph.py serves every k from 9 to 31 (`biased_contigs`), with arrays
sized exactly. For every k >= 9 the junction octamer is the edge code's
trailing 16 bits.
"""

from __future__ import annotations

import torch

from genomeassembler_dev_tpu_torch.dbg.dense import DenseDBG
from genomeassembler_dev_tpu_torch.dbg.graph import build_dbg, walk_starts_sparse

PAD = 255
OCTAMER_MASK = (1 << 16) - 1


def _check_k(k: int) -> None:
    if k - 1 < 8:
        raise ValueError("biased traversal needs dbg_kmer >= 9 (octamer junctions)")


def biased_successor_edges(p_idx: torch.Tensor, s_idx: torch.Tensor, char: torch.Tensor,
                           oct_code: torch.Tensor, n_nodes: int,
                           probs8: torch.Tensor) -> torch.Tensor:
    """succ_b[node] = index of the node reached by the out-edge whose
    junction octamer has the highest probability, -1 at dead ends. Each
    (p_idx, char) pair occurs once (edges are unique). A present edge weighs
    probs8[oct_code] >= 0, an absent one -1; ties go to the smallest char."""
    dev = p_idx.device
    w4 = torch.full((n_nodes, 4), -1.0, dtype=torch.float32, device=dev)
    s4 = torch.full((n_nodes, 4), -1, dtype=torch.int64, device=dev)
    w4[p_idx, char] = probs8.to(torch.float32)[oct_code]
    s4[p_idx, char] = s_idx
    best_w, best_s = w4[:, 0], s4[:, 0]
    for c in range(1, 4):  # a strictly larger weight wins: ties keep the smaller char
        better = w4[:, c] > best_w
        best_w = torch.where(better, w4[:, c], best_w)
        best_s = torch.where(better, s4[:, c], best_s)
    return torch.where(best_w >= 0, best_s, -1)


def biased_successor(g: DenseDBG, probs8: torch.Tensor) -> torch.Tensor:
    """succ_b over the dense graph's 4^(k-1) node ids (k >= 9)."""
    _check_k(g.k)
    V = g.out_deg.shape[0]
    edges = torch.nonzero(g.presence).squeeze(1)
    return biased_successor_edges(edges >> 2, edges & (V - 1), edges & 3,
                                  edges & OCTAMER_MASK, V, probs8)


def _greedy_walk(node_char: torch.Tensor, succ_b: torch.Tensor, w_start: torch.Tensor,
                 prefix_chars: torch.Tensor, k: int, max_len: int):
    """From each start node follow succ_b to a dead end (-1) or the max_len
    cap. prefix_chars [W, k-1] seed the buffer; the start node's own char
    lands at column k-1. Returns (buf [W, max_len] uint8, lens [W], overflow
    [W]).

    succ_b is a static functional graph, so the whole path is materialised
    by pointer doubling: with jump = succ^L, the node at step j+L is
    jump[P[:, j]], and each round doubles the known path length, log2(max_len)
    rounds of [W, L] gathers in place of max_len sequential steps."""
    V = node_char.shape[0]
    steps = max_len - (k - 1)  # chars appended after the seeded prefix
    # dead ends (-1) go to a sink V, and the sink to itself
    sink = torch.full((1,), V, dtype=torch.int64, device=succ_b.device)
    succ1 = torch.cat([torch.where(succ_b < 0, V, succ_b), sink])
    path = w_start[:, None]  # path[:, j] = node after j greedy steps
    jump = succ1
    known = 1
    while known < steps:
        path = torch.cat([path, jump[path]], dim=1)
        jump = jump[jump]
        known *= 2
    path = path[:, :steps]
    live = path < V  # a char is written at step j iff the node is real
    chars = torch.where(live, node_char[path.clamp(max=V - 1)], PAD)
    buf = torch.cat([prefix_chars, chars.to(torch.uint8)], dim=1)
    lens = (k - 1) + live.sum(dim=1)
    # the cap was hit while still extending: every step wrote a char and the
    # last node still has a successor
    overflow = live[:, -1] & (succ1[path[:, -1]] < V)
    return buf, lens, overflow


def biased_contigs(kmer_codes: torch.Tensor, kmer_valid: torch.Tensor,
                   probs8: torch.Tensor, k: int, max_len: int):
    """Greedy probability-guided walks from every branch out-edge of the
    graph of the valid codes, 9 <= k <= 31.

    Returns (buf [W, max_len] uint8, lens [W], walk_valid [W], overflow [W],
    n_walks, n_nodes), the last two as ints: the outputs of JAX's
    biased_contigs_sparse and biased_contigs_big_k, and of
    biased_contigs_dense without n_nodes."""
    _check_k(k)
    g = build_dbg(kmer_codes, kmer_valid, k)
    succ_b = biased_successor_edges(g.edge_from, g.edge_to, g.edges & 3,
                                    g.edges & OCTAMER_MASK, g.n_nodes, probs8)
    start, prefix, valid, n_walks = walk_starts_sparse(g)
    shifts = 2 * (k - 2 - torch.arange(k - 1, device=prefix.device))
    prefix_chars = ((prefix[:, None] >> shifts[None, :]) & 3).to(torch.uint8)
    buf, lens, overflow = _greedy_walk((g.nodes & 3).to(torch.uint8), succ_b, start,
                                       prefix_chars, k, max_len)
    return buf, lens, valid, overflow, n_walks, g.n_nodes
