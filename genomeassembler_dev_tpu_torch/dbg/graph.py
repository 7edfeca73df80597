"""De Bruijn graph over integer k-mer codes (mirrors
genomeassembler_dev_tpu/dbg/graph.py), for every k up to 31.

The edge set is the set of unique k-mer codes; nodes are the unique
(k-1)-mer prefixes and suffixes; degrees come from scatter-adds over node
indices; a node branches when (in != 1 or out != 1) and out > 0. One int64
code holds k <= 31, so this one builder covers both of the JAX package's
sparse paths: `contigs_sparse` (int32 codes, k <= 15) and
`dbg/big_k.py::contigs_big_k` (hi/lo code pairs, k 16-31).

The JAX module keeps fixed-capacity arrays padded with SENTINEL = 2^31-1 so
that its compiled shapes stay few. Eager PyTorch sizes every array exactly:
invalid codes are dropped by masking before the sort, so no sentinel has to
sort above the codes.

A batch of segments builds one graph, the disjoint union of the segments'
graphs: every k-mer code carries its segment, and nodes and edges are
distinct (segment, code) pairs (`contigs_union`, the batched runner's
stage 2). Where the segment fits above the code's 2k bits in one int64, a
pair is one packed key; otherwise pairs are ranked as rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from genomeassembler_dev_tpu_torch.dbg.doubling import walk_contigs_doubling

MAX_K = 31  # 2k bits in one int64 code


@dataclass
class DBG:
    k: int
    edges: torch.Tensor  # [E] k-mer codes of the distinct (segment, code) pairs, int64
    edge_seg: torch.Tensor  # [E] segment of each edge (0 for one segment); pairs ascend
    nodes: torch.Tensor  # [V] (k-1)-mer codes of the distinct (segment, code) pairs, int64
    edge_from: torch.Tensor  # [E] node index of each edge's prefix
    edge_to: torch.Tensor  # [E] node index of each edge's suffix
    in_deg: torch.Tensor  # [V] int64
    out_deg: torch.Tensor  # [V] int64
    branch: torch.Tensor  # [V] bool
    succ: torch.Tensor  # [V] node index of the unique successor, -1 otherwise
    pred: torch.Tensor  # [V] node index of the unique predecessor, -1 otherwise

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


def _distinct(seg: torch.Tensor | None, codes: torch.Tensor, bits: int, packed: bool):
    """The distinct (segment, code) pairs in ascending order, as (segments,
    codes), and each input's index among them. Codes are below 2^bits; a
    pair is one key seg << bits | code where `packed`, a row otherwise."""
    if packed:
        key = codes if seg is None else (seg << bits) | codes
        uniq, inv = torch.unique(key, return_inverse=True)
        return uniq >> bits, uniq & ((1 << bits) - 1), inv
    uniq, inv = torch.unique(torch.stack([seg, codes], dim=1), dim=0, return_inverse=True)
    return uniq[:, 0], uniq[:, 1], inv


def build_dbg(kmer_codes: torch.Tensor, kmer_valid: torch.Tensor, k: int,
              n_seg: int = 1) -> DBG:
    """The graph of the valid codes among (possibly repeated) kmer_codes.
    With n_seg > 1 the leading axis of kmer_codes [n_seg, ...] indexes
    segments, and the graph is the disjoint union of theirs."""
    if not 2 <= k <= MAX_K:
        raise ValueError(f"k must be in 2..{MAX_K} (got {k})")
    keep = kmer_valid.reshape(-1)
    codes = kmer_codes.reshape(-1)[keep].long()
    seg = None
    if n_seg > 1:
        seg = torch.arange(n_seg, device=codes.device).view((n_seg,) + (1,) * (
            kmer_codes.dim() - 1)).expand(kmer_codes.shape).reshape(-1)[keep]
    packed = 2 * k + (n_seg - 1).bit_length() <= 62
    edge_seg, edges, _ = _distinct(seg, codes, 2 * k, packed)
    prefix = edges >> 2
    suffix = edges & ((1 << (2 * (k - 1))) - 1)
    E = edges.shape[0]
    _, nodes, inv = _distinct(None if seg is None else edge_seg.repeat(2),
                              torch.cat([prefix, suffix]), 2 * (k - 1), packed)
    n = nodes.shape[0]
    p_idx, s_idx = inv[:E], inv[E:]
    out_deg = torch.bincount(p_idx, minlength=n)
    in_deg = torch.bincount(s_idx, minlength=n)
    branch = ((in_deg != 1) | (out_deg != 1)) & (out_deg > 0)

    # a node of out-degree 1 has exactly one edge writing its successor,
    # a node of in-degree 1 exactly one writing its predecessor
    succ = torch.full((n,), -1, dtype=torch.int64, device=nodes.device)
    single_out = out_deg[p_idx] == 1
    succ[p_idx[single_out]] = s_idx[single_out]
    pred = torch.full((n,), -1, dtype=torch.int64, device=nodes.device)
    single_in = in_deg[s_idx] == 1
    pred[s_idx[single_in]] = p_idx[single_in]
    return DBG(k=k, edges=edges, edge_seg=edge_seg, nodes=nodes, edge_from=p_idx, edge_to=s_idx,
               in_deg=in_deg, out_deg=out_deg, branch=branch, succ=succ, pred=pred)


def walk_starts_sparse(g: DBG):
    """Edges whose prefix node branches, in ascending edge code order.
    Returns (start node index, prefix code, valid, n_walks)."""
    is_walk = g.branch[g.edge_from]
    start = g.edge_to[is_walk]
    return (start, g.edges[is_walk] >> 2, torch.ones_like(start, dtype=torch.bool),
            start.shape[0])


def contigs_sparse(kmer_codes: torch.Tensor, kmer_valid: torch.Tensor, k: int,
                   max_len: int):
    """Build the graph and walk every contig by pointer doubling.

    Returns (buf [n_walks, max_len] uint8, lens [n_walks], walk_valid,
    overflow, n_walks, n_nodes), the last two as ints. Every array is sized
    exactly, so there is no capacity to retry."""
    g = build_dbg(kmer_codes, kmer_valid, k)
    start, prefix, valid, n_walks = walk_starts_sparse(g)
    buf, lens, overflow = walk_contigs_doubling(
        (g.nodes & 3).to(torch.uint8), g.succ, g.pred, g.branch, g.out_deg,
        start, prefix, valid, k, max_len,
    )
    return buf, lens, valid, overflow, n_walks, g.n_nodes


def contigs_union(kmer_codes: torch.Tensor, kmer_valid: torch.Tensor, k: int,
                  max_len: int):
    """contigs_sparse for a batch: kmer_codes [B, ...] of B segments build
    one union graph and one doubling walk. Returns (buf [W, max_len] uint8,
    lens [W], overflow [W], seg [W]): every walk of the batch, with the
    segment of its start edge."""
    g = build_dbg(kmer_codes, kmer_valid, k, n_seg=kmer_codes.shape[0])
    start, prefix, valid, _ = walk_starts_sparse(g)
    buf, lens, overflow = walk_contigs_doubling(
        (g.nodes & 3).to(torch.uint8), g.succ, g.pred, g.branch, g.out_deg,
        start, prefix, valid, k, max_len,
    )
    return buf, lens, overflow, g.edge_seg[g.branch[g.edge_from]]
