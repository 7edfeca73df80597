"""The benchmark's segment generators, frozen here so that later changes to the
program cannot change the traffic.

`synthetic_genome` and `plant_repeats` are copies of
genomeassembler_dev_tpu_torch/sim/segments.py as of the benchmark's first
version, at their default parameters.

A traffic mix names a set of segments: segment i of the set is made from
(set_seed, i), as the reference's study runs one fixed set of sampled
segments through every grid row. A run cycles through the set in its own
order, so every run does the same work and --seed chooses only the
experiments that the check recomputes: the work of one segment varies by
orders of magnitude (from one solution to thousands), and segments drawn
from the seed made the runs of different seeds differ far more than two
runs of one seed.
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


def synthetic_genome(seed, length: int) -> str:
    """Seeded uniform-random ACGT sequence."""
    rng = np.random.default_rng(seed)
    return _BASES[rng.integers(0, 4, size=length).astype(np.uint8)].tobytes().decode()


def _revcomp_str(s: list[str]) -> list[str]:
    return [_COMPLEMENT[b] for b in reversed(s)]


def plant_repeats(
    segment: str,
    rng: np.random.Generator,
    n_events: int | None = None,
    motif_len: tuple[int, int] = (20, 80),
    max_extra_copies: int = 2,
    structure: tuple[str, ...] = ("forward", "tandem", "inverted", "diverged"),
) -> str:
    """Plant segmental duplications: per event one of a forward copy, a
    tandem run of 2-4 copies, an inverted (reverse-complement) copy or a copy
    with 1-5% point substitutions. The output keeps the input's length."""
    seg = list(segment)
    L = len(seg)
    if n_events is None:
        n_events = max(2, L // 350)
    for _ in range(n_events):
        ml = int(rng.integers(motif_len[0], motif_len[1] + 1))
        if ml >= L:
            continue
        src = int(rng.integers(0, L - ml + 1))
        motif = seg[src : src + ml]
        kind = structure[int(rng.integers(0, len(structure)))]
        if kind == "tandem":
            n_copies = int(rng.integers(2, 5))
            dst = src + ml
            for _ in range(n_copies):
                if dst + ml > L:
                    break
                seg[dst : dst + ml] = motif
                dst += ml
            continue
        for _ in range(int(rng.integers(1, max_extra_copies + 1))):
            dst = int(rng.integers(0, L - ml + 1))
            copy = list(motif)
            if kind == "inverted":
                copy = _revcomp_str(copy)
            elif kind == "diverged":
                rate = float(rng.uniform(0.01, 0.05))
                n_mut = max(1, int(round(rate * ml)))
                for p in rng.choice(ml, size=n_mut, replace=False):
                    old = copy[p]
                    copy[p] = "ACGT".replace(old, "")[int(rng.integers(0, 3))]
            seg[dst : dst + ml] = copy
    return "".join(seg)


def segment(seed: int, index: int, length: int, repeats: bool) -> str:
    """Segment `index` of the run seeded `seed`: a uniform-random sequence
    from (seed, index), with repeats planted from (seed, index, 1)."""
    if seed < 0 or index < 0:
        raise ValueError("seed and index must be non-negative")
    seq = synthetic_genome([seed, index], length)
    if repeats:
        seq = plant_repeats(seq, np.random.default_rng([seed, index, 1]))
    return seq


def segments(seed: int, start: int, count: int, length: int, repeats: bool) -> list[str]:
    """Segments start .. start + count - 1 of the run seeded `seed`."""
    return [segment(seed, i, length, repeats) for i in range(start, start + count)]


def cycle(segment_set: list[str], start: int, count: int) -> list[str]:
    """Positions start .. start + count - 1 of the set repeated end to end."""
    return [segment_set[p % len(segment_set)] for p in range(start, start + count)]
