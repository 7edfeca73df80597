"""De Bruijn graph for small k (mirrors genomeassembler_dev_tpu/dbg/dense.py).

The JAX module shapes every gather and scatter as a one-hot matmul for the
TPU's matrix unit. Here the same outputs come from sort/unique, searchsorted
and plain scatters, and the walk is the pointer-doubling walk of
dbg/doubling.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from genomeassembler_dev_tpu_torch.dbg.doubling import walk_contigs_doubling


@dataclass
class DenseDBG:
    k: int
    presence: torch.Tensor  # [4^k] bool
    in_deg: torch.Tensor  # [V] int32, V = 4^(k-1)
    out_deg: torch.Tensor  # [V] int32
    branch: torch.Tensor  # [V] bool
    succ: torch.Tensor  # [V] int64 dense node id (-1 unless out == 1)
    pred: torch.Tensor  # [V] int64 dense node id (-1 unless in == 1)


def build_dbg_dense(kmer_codes: torch.Tensor, kmer_valid: torch.Tensor,
                    k: int) -> DenseDBG:
    """The graph over all 4^(k-1) nodes, indexed by (k-1)-mer code."""
    V = 4 ** (k - 1)
    codes = kmer_codes.reshape(-1)[kmer_valid.reshape(-1)].long()
    presence = torch.bincount(codes, minlength=4**k) > 0
    # the 4 out-edges of a prefix are adjacent codes, the 4 in-edges of a
    # suffix are V-strided: degrees are sums over reshapes
    by_prefix = presence.view(V, 4).to(torch.int32)
    by_suffix = presence.view(4, V).to(torch.int32)
    out_deg = by_prefix.sum(dim=1, dtype=torch.int32)
    in_deg = by_suffix.sum(dim=0, dtype=torch.int32)
    branch = ((in_deg != 1) | (out_deg != 1)) & (out_deg > 0)
    node = torch.arange(V, device=codes.device)
    succ_char = by_prefix.argmax(dim=1)
    succ = torch.where(out_deg == 1, ((node << 2) | succ_char) & (V - 1), -1)
    pred_char = by_suffix.argmax(dim=0)
    # the in-edge with first char c has prefix (c * V + node) >> 2
    pred = torch.where(in_deg == 1, (pred_char * V + node) >> 2, -1)
    return DenseDBG(k=k, presence=presence, in_deg=in_deg, out_deg=out_deg,
                    branch=branch, succ=succ, pred=pred)


def contigs_dense(kmer_codes: torch.Tensor, kmer_valid: torch.Tensor, k: int,
                  max_len: int):
    """Build the graph over the active nodes and walk every contig.

    Returns (buf [n_walks, max_len] uint8, lens [n_walks], walk_valid,
    overflow, n_walks, n_nodes), the last two as ints. Walks are the edges
    out of branch nodes, in ascending edge code order. Eager PyTorch sizes
    every array exactly, so there is no capacity to retry.
    """
    V = 4 ** (k - 1)
    edges = torch.unique(kmer_codes.reshape(-1)[kmer_valid.reshape(-1)].long())
    prefix = edges >> 2
    suffix = edges & (V - 1)
    nodes = torch.unique(torch.cat([prefix, suffix]))  # sorted
    n = nodes.shape[0]
    p_idx = torch.searchsorted(nodes, prefix)
    s_idx = torch.searchsorted(nodes, suffix)
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

    is_walk = branch[p_idx]
    walk_start = s_idx[is_walk]
    walk_prefix = prefix[is_walk]
    walk_valid = torch.ones_like(walk_start, dtype=torch.bool)
    buf, lens, overflow = walk_contigs_doubling(
        (nodes & 3).to(torch.uint8), succ, pred, branch, out_deg,
        walk_start, walk_prefix, walk_valid, k, max_len,
    )
    return buf, lens, walk_valid, overflow, walk_start.shape[0], n
