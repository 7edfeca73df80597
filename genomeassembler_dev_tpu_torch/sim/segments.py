"""Synthetic genome segments (mirrors synthetic_genome in
genomeassembler_dev_tpu/sim/segments.py)."""

from __future__ import annotations

import numpy as np

from genomeassembler_dev_tpu_torch.core.encoding import decode_dna


def synthetic_genome(seed: int, length: int) -> str:
    """Seeded uniform-random ACGT sequence (hermetic stand-in for T2T)."""
    rng = np.random.default_rng(seed)
    return decode_dna(rng.integers(0, 4, size=length).astype(np.uint8))
