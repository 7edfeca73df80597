"""Rolling k-mer window codes (mirrors genomeassembler_dev_tpu/ops/windows.py)."""

from __future__ import annotations

import torch


def kmer_window_codes(codes: torch.Tensor, k: int, dtype=torch.int32):
    """Big-endian codes of all k-length windows along the last axis.

    codes: [..., L] integer tensor with bases 0..3 (values > 3 = invalid/pad).
    Returns (window_codes [..., L-k+1] dtype, valid [..., L-k+1] bool).
    Windows touching an invalid base are marked invalid (their code is
    garbage; mask before use). int32 holds k <= 15, int64 k <= 31.
    """
    L = codes.shape[-1]
    n = L - k + 1
    if n <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")
    base = codes.to(dtype) & 3
    valid_base = codes <= 3
    out = torch.zeros(codes.shape[:-1] + (n,), dtype=dtype, device=codes.device)
    valid = torch.ones(codes.shape[:-1] + (n,), dtype=torch.bool, device=codes.device)
    for i in range(k):
        out = (out << 2) | base[..., i : i + n]
        valid = valid & valid_base[..., i : i + n]
    return out, valid


def pack_words(codes: torch.Tensor, word_bases: int = 16) -> torch.Tensor:
    """Pack 2-bit codes big-endian into 32-bit words along the last axis,
    zero-padding the tail. The words are returned as int64 holding the same
    values as the JAX version's uint32."""
    L = codes.shape[-1]
    n_words = -(-L // word_bases)
    c = codes.to(torch.int64) & 3
    pad = n_words * word_bases - L
    if pad:
        c = torch.nn.functional.pad(c, (0, pad))
    c = c.reshape(c.shape[:-1] + (n_words, word_bases))
    shifts = torch.arange(word_bases - 1, -1, -1, device=codes.device) * 2
    return (c << shifts).sum(dim=-1)
