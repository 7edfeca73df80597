"""De Bruijn graph for small k (mirrors genomeassembler_dev_tpu/dbg/dense.py).

The JAX module shapes every gather and scatter as a one-hot matmul for the
TPU's matrix unit. Here `build_dbg_dense` gives the same direct-indexed
tables by bincount and reshapes, and `contigs_dense` is the sorted-unique
builder of dbg/graph.py with the pointer-doubling walk of dbg/doubling.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from genomeassembler_dev_tpu_torch.dbg.graph import contigs_sparse


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
    """Build the graph over the active nodes and walk every contig; the
    outputs of dbg/graph.py::contigs_sparse. The JAX module's direct-indexed
    4^k tables serve the TPU's matrix unit; on the GPU the sorted-unique
    graph is the same work at k <= 10, so the dense path builds that one."""
    return contigs_sparse(kmer_codes, kmer_valid, k, max_len)
