"""Experiment configuration (mirrors genomeassembler_dev_tpu/pipeline/config.py:
the same fields, defaults and validation)."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ExperimentConfig:
    seq_len: int = 1000
    read_len: int = 100  # reference default; studies use 12..40
    coverage_target: float = 10.0  # studies use 40
    kmer: int = 8  # breakage k-mer ("break_kmer")
    dbg_kmer: int = 9
    seed: int = 1234
    industry_standard: bool = False
    only_kmers_from_reads: bool = False
    save_read_files: bool = True
    action: str = "ratio"  # reference declares but never uses "zscore"
    n_orderings: int = 10000
    # the industry-standard path's own ordering count; None = its default
    velvet_n_orderings: int | None = None
    merge_backend: str = "auto"  # native | spec | device | auto
    read_chunk: int = 512
    max_contig_len: int | None = None  # default: 2 * seq_len
    traversal: str = "standard"  # "biased" = probability-guided
    biased_max_solutions: int = 256

    # grid used by the own-dBG study
    OWN_STUDY_GRID = (
        (12, 9), (14, 9), (16, 13), (18, 15), (20, 15), (25, 15), (40, 15),
    )
    # grid used by the velvet study
    VELVET_STUDY_GRID = (
        (12, 11), (14, 13), (16, 13), (18, 15), (20, 17), (25, 19), (40, 37),
    )

    def with_(self, **kw) -> "ExperimentConfig":
        return replace(self, **kw)

    @property
    def contig_cap(self) -> int:
        return self.max_contig_len or 2 * self.seq_len

    def validate(self) -> "ExperimentConfig":
        """Raise ValueError with an actionable message for invalid knob
        combinations."""
        if self.kmer not in (2, 4, 6, 8):
            raise ValueError(f"kmer must be one of 2/4/6/8 (got {self.kmer})")
        if self.industry_standard:
            # the velvet path only uses dbg_kmer as the merge overlap (k-1)
            if not 2 <= self.dbg_kmer <= 64:
                raise ValueError(
                    f"dbg_kmer must be in 2..64 on the velvet path "
                    f"(got {self.dbg_kmer})"
                )
        elif not 2 <= self.dbg_kmer <= 31:
            raise ValueError(
                f"dbg_kmer must be in 2..31 (got {self.dbg_kmer}; 62-bit code limit)"
            )
        if self.read_len < self.dbg_kmer and not self.industry_standard:
            raise ValueError(
                f"read_len {self.read_len} < dbg_kmer {self.dbg_kmer}: reads "
                "contain no dBG k-mers"
            )
        if self.seq_len < max(self.read_len, self.kmer):
            raise ValueError(
                f"seq_len {self.seq_len} shorter than read_len/kmer: no "
                "breakpoints can be sampled"
            )
        if self.traversal == "biased" and self.dbg_kmer < 9:
            raise ValueError("biased traversal needs dbg_kmer >= 9 (octamer junctions)")
        if self.traversal not in ("standard", "biased"):
            raise ValueError(f"unknown traversal {self.traversal!r}")
        if self.n_orderings < 1:
            raise ValueError("n_orderings must be >= 1")
        return self

    def param_string(self) -> str:
        """The reference's artifact parameter string
        (lib/DeNovoAssembler.R:280-308)."""
        return (
            f"_SeqLen-{self.seq_len}"
            f"_SeqSeed-{self.seed}"
            f"_ReadLen-{self.read_len}"
            f"_DBGKmer-{self.dbg_kmer}"
            f"_kmer-{self.kmer}"
            f"_IndustryModel-{self.industry_standard}"
        )
