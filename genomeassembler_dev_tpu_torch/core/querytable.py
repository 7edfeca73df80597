"""Breakage-probability QueryTable on a device (mirrors
genomeassembler_dev_tpu/core/querytable.py).

Dense per-k tables indexed by k-mer code for k in (2, 4, 6, 8), normalised
jointly to sum to one, with NA entries replaced by their table's minimum
before normalising. The combined index space is OFFSETS[k] + code, 69,904
entries in all. The tables are the pipeline's "weights": `from_numpy` carries
the JAX package's arrays over unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

KS = (2, 4, 6, 8)
SIZES = {k: 4**k for k in KS}
OFFSETS = {2: 0, 4: 16, 6: 272, 8: 4368}
TOTAL = 69904  # sum of 4^k for k in (2,4,6,8)


@dataclass(frozen=True)
class QueryTable:
    """probs[k][code] (float64, on one device) is the probability of the
    k-mer with integer code `code`; the four tables jointly sum to 1."""

    probs: dict[int, torch.Tensor] = field(repr=False)

    @cached_property
    def combined(self) -> torch.Tensor:
        """All 69,904 probabilities in combined-index order, float64."""
        return torch.cat([self.probs[k] for k in KS])

    @staticmethod
    def from_numpy(probs: dict[int, np.ndarray], device) -> "QueryTable":
        """Tables given as numpy arrays (e.g. the JAX package's
        QueryTable.probs) -> the same values as float64 tensors on `device`."""
        return QueryTable(probs={
            k: torch.as_tensor(np.asarray(probs[k], np.float64), device=device)
            for k in KS
        })

    @staticmethod
    def uniform(device) -> "QueryTable":
        """The random-probability control: every entry 1/69904."""
        return QueryTable(probs={
            k: torch.full((SIZES[k],), 1.0 / TOTAL, dtype=torch.float64,
                          device=device)
            for k in KS
        })


def load_query_table_npz(path: str, device) -> QueryTable:
    """Load the dense npz asset (raw values, NA as NaN) and normalise."""
    with np.load(path) as data:
        raw = {}
        for k in KS:
            dense = data[f"raw_k{k}"]
            raw[k] = np.where(np.isnan(dense), np.nanmin(dense), dense)
    total = sum(float(raw[k].sum()) for k in KS)
    return QueryTable.from_numpy({k: raw[k] / total for k in KS}, device)


def default_query_table_path() -> str:
    """Location of the QueryTable asset bundled with this repo."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "data", "querytable.npz")


def load_default_query_table(device) -> QueryTable:
    return load_query_table_npz(default_query_table_path(), device)
