"""The least time one NVIDIA H100 SXM could take for a Levenshtein call (a
copy of genomeassembler_dev_tpu_torch/utils/roofline.py's word-step bound as
of the benchmark's first version).

132 SMs x 4 warp instructions of 32 lanes a cycle x 1.98 GHz is the most
scalar operations of any type the card issues (NVIDIA's H100 SXM data sheet,
67 TFLOP/s of float32 with an FMA counted once, at 700 W). The Myers kernel
(csrc/myers.cu) spends 20 such operations on Hyyro's step of one 32-bit
word, so a call of queries with real lengths `lens` against an n-base target
needs n * sum(ceil(len / 32)) * 20 operations, whatever implements it.
"""

from __future__ import annotations

import numpy as np

OPS_PER_MS = 132 * 128 * 1.98e6
WORD_STEP_OPS = 20


def lev_words_bound_ms(lens, n: int) -> float:
    lens = np.maximum(np.asarray(lens, np.int64), 0)
    return n * int(((lens + 31) // 32).sum()) * WORD_STEP_OPS / OPS_PER_MS
