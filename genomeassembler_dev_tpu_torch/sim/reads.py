"""Ultrasonication read simulation on a device (mirrors
genomeassembler_dev_tpu/sim/reads.py).

1. the per-position octamer breakage-probability track of the segment,
2. ceil(coverage * L / read_len) breakpoint draws weighted by the track, by
   inverse-CDF sampling (float32 cumsum + searchsorted) of uniforms drawn
   from an explicit torch.Generator,
3. draws whose read would overrun the 3' end are marked invalid,
4. reads = genome[pos : pos + read_len].

torch.Generator and jax.random give different uniforms from one seed, so the
equality gate with the JAX package is "given identical read sets" (or, for
the simulator itself, given identical uniforms: `reads_from_uniforms`).

A stack of segments [B, L] of one length simulates as a batch: every segment
takes the same uniforms, as the reference reseeds identically before every
experiment, and each segment's reads equal those of its own serial run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from genomeassembler_dev_tpu_torch.core.querytable import QueryTable
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes


@dataclass
class ReadSet:
    """Simulated read set (invalid slots = 3' boundary discards)."""

    codes: torch.Tensor  # [..., N, read_len] uint8 base codes
    valid: torch.Tensor  # [..., N] bool
    positions: torch.Tensor  # [..., N] int32 0-based breakpoint positions
    track: torch.Tensor  # [..., L-k+1] float32 octamer probability track
    read_len: int


def probability_track(genome_codes: torch.Tensor, table_probs_k: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Per-position k-mer probability track, float32. Windows containing
    non-ACGT bases get probability 0 (unsampleable)."""
    codes, valid = kmer_window_codes(genome_codes, k, dtype=torch.int64)
    probs = table_probs_k.to(torch.float32)[codes]
    return torch.where(valid, probs, torch.zeros_like(probs))


def reads_from_uniforms(u: torch.Tensor, genome_codes: torch.Tensor,
                        track: torch.Tensor, read_len: int) -> ReadSet:
    """Breakpoints from uniforms u [N] in [0, 1) by inverse CDF, then the
    reads of a segment [L] (track [L-k+1]) or of each segment of a stack
    [B, L] (track [B, L-k+1]), all from the same uniforms.

    searchsorted is right-sided, so a uniform that lands exactly on a CDF
    step picks the next position, as jnp.searchsorted(side="right") does.
    The CDF is summed in float64. The octamer table's smallest probability
    is above 2^-22, so every float32 track entry is a multiple of 2^-45, and
    below 2^8 (segments up to ~2.5 Mb) every float64 partial sum is exact:
    the CDF is the same in any summation order. A float32 cumsum on CUDA is
    not, and moved a few steps between runs of one seed."""
    L = genome_codes.shape[-1]
    cdf = torch.cumsum(track.to(torch.float64), dim=-1)
    pos = torch.searchsorted(cdf, u.to(torch.float64) * cdf[..., -1:], right=True)
    pos = torch.clamp(pos.to(torch.int32), max=track.shape[-1] - 1)
    valid = pos + read_len <= L  # 3' boundary discard
    offs = torch.arange(read_len, dtype=torch.int32, device=u.device)
    gather_idx = torch.clamp(pos[..., None] + offs, max=L - 1)  # [..., N, R]
    codes = torch.gather(genome_codes, -1, gather_idx.flatten(-2).long())
    codes = codes.view(gather_idx.shape).to(torch.uint8)
    return ReadSet(codes=codes, valid=valid, positions=pos, track=track,
                   read_len=read_len)


def simulate_reads(generator: torch.Generator, genome_codes: torch.Tensor,
                   table_probs_k8: torch.Tensor, read_len: int, n_draws: int,
                   break_kmer: int = 8) -> ReadSet:
    """Draw breakpoints weighted by the octamer track and gather reads, for
    one segment [L] or a stack [B, L]. `generator` must live on
    genome_codes' device."""
    track = probability_track(genome_codes, table_probs_k8, break_kmer)
    u = torch.rand(n_draws, generator=generator, dtype=torch.float32,
                   device=genome_codes.device)
    return reads_from_uniforms(u, genome_codes, track, read_len)


def n_draws_for(coverage_target: float, genome_len: int, read_len: int) -> int:
    """ceil(coverage * L / read_len)."""
    return math.ceil(coverage_target * genome_len / read_len)


def generate_reads(generator: torch.Generator, genome_codes: torch.Tensor,
                   table: QueryTable, read_len: int, coverage_target: float,
                   break_kmer: int = 8) -> ReadSet:
    """simulate_reads with the reference's draw-count formula."""
    n = n_draws_for(coverage_target, genome_codes.shape[-1], read_len)
    return simulate_reads(generator, genome_codes, table.probs[break_kmer],
                          read_len, n, break_kmer)


def dedup_reads(read_codes: torch.Tensor, valid: torch.Tensor):
    """Distinct reads with multiplicities, in lexicographic order (np.unique's
    order in the JAX package). Reads containing non-ACGT codes are dropped:
    downstream matching masks codes to 2 bits, which would alias N to T.
    Returns (unique_codes [U, R] uint8, counts [U] int32)."""
    keep = valid & (read_codes <= 3).all(dim=1)
    arr = read_codes[keep]
    if arr.shape[0] == 0:
        return arr, torch.zeros(0, dtype=torch.int32, device=read_codes.device)
    uniq, counts = torch.unique(arr, dim=0, sorted=True, return_counts=True)
    return uniq, counts.to(torch.int32)
