"""Reads -> dBG -> canonical contig set (mirrors
genomeassembler_dev_tpu/dbg/assemble.py).

Dispatch as in the JAX module: the dense path for k <= 10, the sparse
int64 path above it up to k = 31, and a ValueError beyond. The JAX module
retries under growing walk and node capacities so that its compiled shapes
stay few. Eager PyTorch sizes every array exactly, so the ladder is gone;
the overflow check on max_contig_len stays. `contigs_from_read_codes_batched`
serves a batch of segments from one union graph (dbg/graph.py).
"""

from __future__ import annotations

import numpy as np
import torch

from genomeassembler_dev_tpu_torch.core.encoding import decode_dna
from genomeassembler_dev_tpu_torch.dbg.dense import contigs_dense
from genomeassembler_dev_tpu_torch.dbg.graph import MAX_K, contigs_sparse, contigs_union
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes

DENSE_MAX_K = 10


def contigs_from_read_codes(
    read_codes: torch.Tensor,  # [N, R] base codes
    read_valid: torch.Tensor,  # [N] bool
    dbg_kmer: int,
    max_contig_len: int,
) -> list[str]:
    """Canonical contig set from reads. Raises if a walk overflows
    max_contig_len."""
    if dbg_kmer > MAX_K:
        raise ValueError(f"dbg_kmer > {MAX_K} is not supported (62-bit code limit)")
    kcodes, kvalid = kmer_window_codes(read_codes, dbg_kmer, dtype=torch.int64)
    kvalid = kvalid & read_valid[:, None]
    build = contigs_dense if dbg_kmer <= DENSE_MAX_K else contigs_sparse
    buf, lens, wvalid, overflow, _, _ = build(kcodes, kvalid, dbg_kmer, max_contig_len)
    return dedup_contigs(buf.cpu().numpy(), lens.cpu().numpy(),
                         wvalid.cpu().numpy(), overflow.cpu().numpy())


def contigs_from_read_codes_batched(
    read_codes: torch.Tensor,  # [B, N, R] base codes of B segments' reads
    read_valid: torch.Tensor,  # [B, N] bool
    dbg_kmer: int,
    max_contig_len: int,
) -> list[list[str]]:
    """Each segment's canonical contig set, equal to contigs_from_read_codes
    on its own reads, from one graph and one walk over the batch. Raises if
    a walk overflows max_contig_len."""
    if dbg_kmer > MAX_K:
        raise ValueError(f"dbg_kmer > {MAX_K} is not supported (62-bit code limit)")
    kcodes, kvalid = kmer_window_codes(read_codes, dbg_kmer, dtype=torch.int64)
    buf, lens, overflow, seg = contigs_union(kcodes, kvalid & read_valid[..., None],
                                             dbg_kmer, max_contig_len)
    # only the walks' real columns come to the host
    width = min(max_contig_len, max(1, int(lens.max()) if lens.numel() else 1))
    buf, lens, overflow, seg = (t.cpu().numpy() for t in (buf[:, :width], lens, overflow, seg))
    sets = []
    for b in range(read_codes.shape[0]):
        m = seg == b
        sets.append(dedup_contigs(buf[m], lens[m], np.ones(int(m.sum()), bool), overflow[m]))
    return sets


def dedup_contigs(buf: np.ndarray, lens: np.ndarray, walk_valid: np.ndarray,
                  overflow: np.ndarray) -> list[str]:
    if (overflow & walk_valid).any():
        raise ValueError("contig walk overflowed max_contig_len; increase the cap")
    return sorted({decode_dna(row[:ln])
                   for row, ln, ok in zip(buf, lens, walk_valid) if ok})
