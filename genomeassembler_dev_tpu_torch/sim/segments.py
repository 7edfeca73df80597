"""Segment store: FASTA IO, synthetic genomes, and reference-segment sampling
(mirrors genomeassembler_dev_tpu/sim/segments.py; numpy and strings only, so
the same seed gives the same segments as the JAX package).

The reference samples 1,000 (chromosome, start) pairs from BSgenome
T2T-CHM13v2.0 autosomes and caches them as a FASTA
(lib/GenerateReads.R:49-111). The 3 GB genome package is an external asset;
this module implements the identical sampling contract against any
user-provided genome FASTA, plus a seeded synthetic-genome source so the full
pipeline runs hermetically.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from genomeassembler_dev_tpu_torch.core.encoding import decode_dna, encode_dna


def read_fasta(path: str) -> dict[str, str]:
    """Minimal FASTA reader: name (up to first whitespace) -> sequence."""
    seqs: dict[str, list[str]] = {}
    name = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            else:
                if name is None:
                    raise ValueError(f"{path}: sequence before header")
                seqs[name].append(line.upper())
    return {k: "".join(v) for k, v in seqs.items()}


def write_fasta(path: str, seqs: dict[str, str], width: int = 80) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")


def synthetic_genome(seed: int, length: int) -> str:
    """Seeded uniform-random ACGT sequence (hermetic stand-in for T2T)."""
    rng = np.random.default_rng(seed)
    return decode_dna(rng.integers(0, 4, size=length).astype(np.uint8))


@dataclass(frozen=True)
class SegmentStore:
    """Named segments, the unit of experiment sharding. Mirrors the
    reference's SampledRefGenome FASTA contract (GenerateReads.R:97-106):
    names are '<chrom>_<start>' and duplicates are removed."""

    names: tuple[str, ...]
    seqs: tuple[str, ...]

    def __len__(self):
        return len(self.names)

    def codes(self, ind: int) -> np.ndarray:
        return encode_dna(self.seqs[ind])

    def save(self, path: str) -> None:
        write_fasta(path, dict(zip(self.names, self.seqs)))

    @staticmethod
    def load(path: str) -> "SegmentStore":
        d = read_fasta(path)
        return SegmentStore(names=tuple(d), seqs=tuple(d.values()))


def sample_segments(
    genome: dict[str, str],
    seq_len: int,
    n_samples: int,
    seed: int,
) -> SegmentStore:
    """Sample (chromosome, start) pairs and extract seq_len segments,
    following GenerateReads.R:69-90: chromosome uniform over entries, start
    uniform in [1, len-1] (1-based), sorted by (chrom, start), deduplicated
    (unique sequences, first name kept). Segments containing non-ACGT
    characters (N runs, IUPAC codes) are dropped: the reference's T2T-CHM13
    source is gapless so it never sees them, but arbitrary user FASTAs
    (--segments-fasta) are not."""
    rng = np.random.default_rng(seed)
    chroms = list(genome)
    picks = rng.integers(0, len(chroms), size=n_samples)
    entries = []
    for c_idx in picks:
        chrom = chroms[c_idx]
        clen = len(genome[chrom])
        start = int(rng.integers(1, clen - 1, endpoint=True))  # 1-based
        entries.append((chrom, start))
    entries.sort()
    names, seqs, seen = [], [], set()
    for chrom, start in entries:
        seq = genome[chrom][start - 1 : start - 1 + seq_len]
        if len(seq) < seq_len or seq in seen:
            continue
        if any(b not in "ACGT" for b in seq):
            continue
        seen.add(seq)
        names.append(f"{chrom}_{start}")
        seqs.append(seq)
    return SegmentStore(names=tuple(names), seqs=tuple(seqs))


def synthetic_segment_store(
    seed: int, seq_len: int, n_segments: int, chrom_len: int | None = None,
    repeats: bool = False,
) -> SegmentStore:
    """Hermetic segment source: one synthetic 'chromosome' per required
    scale, sampled with the same contract as sample_segments. With
    repeats=True each segment gets planted duplications (see plant_repeats) —
    the study-grade stand-in for real genomic sequence."""
    chrom_len = chrom_len or max(10 * seq_len, seq_len + 1000)
    genome = {"chrS": synthetic_genome(seed, chrom_len)}
    n_sample = 4 * n_segments + 8  # oversample: tail/duplicate picks drop
    store = sample_segments(genome, seq_len, n_sample, seed)
    if len(store) < n_segments:
        raise ValueError(
            f"only {len(store)} unique segments from chrom_len={chrom_len}; "
            "increase chrom_len"
        )
    names, seqs = store.names[:n_segments], store.seqs[:n_segments]
    if repeats:
        seqs = tuple(
            plant_repeats(s, np.random.default_rng((seed, i)))
            for i, s in enumerate(seqs)
        )
    return SegmentStore(names=names, seqs=seqs)


_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


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
    """Plant segmental duplications with realistic repeat *structure*.

    Uniform-random segments have no repeats at k >= 13, so on them the dBG is
    a single path and the assembly study degenerates to one solution per
    experiment (round-2 study: 5 of 7 grid rows collapsed). The reference's
    segments are real T2T genome with genuine repeat structure
    (lib/GenerateReads.R:49-111, README.md:47), which is not just exact
    forward-strand copies — per event this generator draws one of:

      * forward  — verbatim copy at a random position: clean branch nodes at
                   every dbg_kmer up to the motif length;
      * tandem   — 2-4 adjacent copies overwriting the run after the source:
                   the motif's k-mers chain back onto themselves, creating a
                   CYCLE in the dBG (exercises the standard walker's overflow
                   path and the biased walker's visit cap);
      * inverted — reverse-complement copy: branches whose continuation runs
                   the other strand, as real inverted repeats/palindromes do;
      * diverged — copy with 1-5% random point substitutions: bubbles
                   (paths that separate and rejoin) rather than clean forks.

    Event positions/types are drawn from `rng`, so segments stay hermetic and
    reproducible. Output length always equals the input length (copies
    overwrite in place, as a fixed-length sampled window would)."""
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
