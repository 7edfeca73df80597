"""2-bit DNA encoding (mirrors genomeassembler_dev_tpu/core/encoding.py).

A=0, C=1, G=2, T=3, anything else INVALID=255. Numeric order is lexicographic
order, so sorting codes sorts strings. Strings live on the host, so encoding
stays numpy; callers move the codes to their device.
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"

# 255 marks non-ACGT characters (e.g. N); callers decide how to handle them.
INVALID = 255

_ENC_LUT = np.full(256, INVALID, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _ENC_LUT[ord(_b)] = _i
    _ENC_LUT[ord(_b.lower())] = _i

_DEC_LUT = np.frombuffer(BASES.encode(), dtype=np.uint8)

_COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G


def encode_dna(seq: str | bytes) -> np.ndarray:
    """Encode an ASCII DNA string to uint8 codes (A=0,C=1,G=2,T=3, other=255)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENC_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_dna(codes: np.ndarray) -> str:
    """Decode uint8 codes back to an ACGT string. Codes must be in 0..3."""
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.size and codes.max() > 3:
        raise ValueError("decode_dna: codes outside 0..3 (invalid/N present?)")
    return _DEC_LUT[codes].tobytes().decode()


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code vector (codes in 0..3): read_2 of the
    reference's simulator is the reverse complement of read_1."""
    return _COMPLEMENT[np.asarray(codes, dtype=np.uint8)][::-1]
