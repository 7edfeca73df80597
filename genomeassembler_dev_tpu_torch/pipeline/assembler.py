"""Per-experiment orchestrator (mirrors genomeassembler_dev_tpu/pipeline/assembler.py).

simulate reads -> dBG contigs -> ordering-ensemble merge -> score every
solution against the true and the uniform probability tables -> one results
table. The break-count matrix does not depend on the table, so it is built
once and both score families are dot products against it.

Ported: the standard traversal for every dbg_kmer up to 31 with every merge
backend (merge/engine.py), the biased traversal (dbg/biased.py) for dbg_kmer
9-31, and the k-mer-count path (only_kmers_from_reads). Everything runs on the
Assembler's explicit `device`; pipeline/batch_runner.py runs the standard
path batched across segments.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
from genomeassembler_dev_tpu_torch.core.querytable import (
    QueryTable, load_default_query_table)
from genomeassembler_dev_tpu_torch.dbg.assemble import contigs_from_read_codes, dedup_contigs
from genomeassembler_dev_tpu_torch.dbg.biased import biased_contigs
from genomeassembler_dev_tpu_torch.merge.engine import assemble_solutions
from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
from genomeassembler_dev_tpu_torch.pipeline.evaluate import (
    pack_member, evaluate_group, solution_columns)
from genomeassembler_dev_tpu_torch.sim.reads import ReadSet, generate_reads, probability_track
from genomeassembler_dev_tpu_torch.utils.profiling import annotate
from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

RESULT_COLUMNS = [
    "sequence",
    "sequence_len",
    "bp_score_true",
    "bp_score_norm_by_break_freqs_true",
    "bp_score_norm_by_len_true",
    "kmer_breaks",
    "lev_dist_vs_true",
    "stat_test_KS_true",
    "contig_frac_len",
    "bp_score_random",
    "bp_score_norm_by_break_freqs_random",
    "bp_score_norm_by_len_random",
    "stat_test_KS_random",
]


@dataclass
class ExperimentResult:
    """One experiment's outputs: the joined solutions table (host arrays, in
    RESULT_COLUMNS order) plus the dbg_summary stats and stage times."""

    columns: dict[str, np.ndarray | list]
    stats: dict
    timings: dict[str, float]

    @property
    def n_solutions(self) -> int:
        return len(self.columns["sequence"])


def experiment_stats(cfg: ExperimentConfig, segment: str, genome_np: np.ndarray,
                     n_reads: int) -> dict:
    """The dbg_summary stats of one experiment."""
    acgt = np.bincount(genome_np[genome_np <= 3], minlength=4)
    return {
        "base_composition": (acgt / len(segment)).tolist(),
        "coverage": round(n_reads * cfg.read_len / cfg.seq_len, 3),
        "nr_of_reads": n_reads,
        "genome_seq": segment,
    }


class Assembler:
    """Drives experiments over segments on one device. Stateless across
    experiments apart from the loaded tables."""

    def __init__(self, config: ExperimentConfig, device, table: QueryTable | None = None,
                 verbose: bool = False):
        self.config = config.validate()
        self.device = torch.device(device)
        self.table = table if table is not None else load_default_query_table(self.device)
        self.uniform = QueryTable.uniform(self.device)
        self.verbose = verbose

    # -- stages -------------------------------------------------------------

    def simulate(self, genome_codes: torch.Tensor, timer: StageTimer) -> ReadSet:
        cfg = self.config
        with timer.stage("Generating sequencing reads"):
            # the reference reseeds identically before every experiment
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
            return generate_reads(gen, genome_codes, self.table, cfg.read_len,
                                  cfg.coverage_target, cfg.kmer)

    def _replay_read_set(self, genome_codes: torch.Tensor, read_set: tuple) -> ReadSet:
        """Wrap stored (codes, valid, positions) arrays as a ReadSet; the
        track is recomputed from the segment."""
        codes, valid, positions = (torch.tensor(np.asarray(a), device=self.device)
                                   for a in read_set)
        track = probability_track(genome_codes, self.table.probs[self.config.kmer],
                                  self.config.kmer)
        return ReadSet(codes=codes.to(torch.uint8), valid=valid.to(torch.bool),
                       positions=positions.to(torch.int32), track=track,
                       read_len=int(codes.shape[1]))

    def contigs(self, read_codes: torch.Tensor, read_valid: torch.Tensor,
                timer: StageTimer) -> list[str]:
        cfg = self.config
        with timer.stage("Running DBG de novo genome assembler"):
            if cfg.traversal == "biased":
                return self._biased_contigs(read_codes, read_valid)
            return contigs_from_read_codes(read_codes, read_valid, cfg.dbg_kmer,
                                           cfg.contig_cap)

    def _biased_contigs(self, read_codes: torch.Tensor,
                        read_valid: torch.Tensor) -> list[str]:
        """Probability-guided traversal: greedy continuation through branches
        by junction-octamer probability, on the one int64 graph for every k."""
        cfg = self.config
        kcodes, kvalid = kmer_window_codes(read_codes, cfg.dbg_kmer, dtype=torch.int64)
        buf, lens, wvalid, overflow, _, _ = biased_contigs(
            kcodes, kvalid & read_valid[:, None], self.table.probs[8],
            cfg.dbg_kmer, cfg.contig_cap)
        # capped (overflowing) walks are kept at their truncated length
        return dedup_contigs(buf.cpu().numpy(), lens.cpu().numpy(), wvalid.cpu().numpy(),
                             np.zeros(overflow.shape, bool))

    def merge(self, contigs: list[str], timer: StageTimer) -> list[str]:
        cfg = self.config
        with timer.stage("Merging shuffled contig orderings"):
            if cfg.traversal == "biased":
                # biased walks already continue through branches to dead
                # ends, so each walk is a maximal candidate assembly and the
                # ordering-ensemble merge (a fragment joiner) is skipped: the
                # solutions are the sorted deduped walks, longest first,
                # truncated to biased_max_solutions
                sols = sorted(set(contigs), key=lambda s: (-len(s), s))
                return sols[: cfg.biased_max_solutions]
            return assemble_solutions(contigs, cfg.dbg_kmer, cfg.seed, cfg.n_orderings,
                                      backend=cfg.merge_backend, device=self.device)

    def score(self, solutions: list[str], rs: ReadSet, genome_codes: torch.Tensor,
              timer: StageTimer) -> dict[str, np.ndarray | list]:
        cfg = self.config
        with timer.stage("Evaluating each de novo assembled solution"):
            with annotate("eval.pack"):
                member = pack_member(solutions, rs.codes, rs.valid, cfg.read_chunk)
            host = evaluate_group([member], genome_codes[None], rs.track[None], self.table,
                                  self.uniform, cfg.kmer)
            with annotate("eval.columns"):
                return solution_columns(solutions, member[1], {n: a[0] for n, a in host.items()},
                                        cfg.seq_len)

    def count_only(self, rs: ReadSet, timer: StageTimer) -> dict[str, np.ndarray]:
        """The only_kmers_from_reads path: the histogram of the reads'
        breakage k-mers beside the probability table, in k-mer code order."""
        k = self.config.kmer
        with timer.stage("Extracting k-mers from sequencing reads"):
            codes, valid = kmer_window_codes(rs.codes, k)
            counts = count_kmers(codes, valid & rs.valid[:, None], 4**k)
            return {"prob": self.table.probs[k].cpu().numpy(),
                    "count": counts.cpu().numpy()}

    # -- full experiment ----------------------------------------------------

    def run_experiment(self, segment: str, read_set: tuple | None = None) -> ExperimentResult:
        """Run one experiment. `read_set` optionally replays a stored
        (codes, valid, positions) tuple instead of simulating: given
        identical read sets, every downstream output is deterministic."""
        cfg = self.config
        timer = StageTimer(self.device, self.verbose)
        genome_np = encode_dna(segment)
        genome_codes = torch.from_numpy(genome_np).to(self.device)
        if read_set is not None:
            rs = self._replay_read_set(genome_codes, read_set)
        else:
            rs = self.simulate(genome_codes, timer)

        stats = experiment_stats(self.config, segment, genome_np, int(rs.valid.sum()))
        if cfg.only_kmers_from_reads:
            cols = self.count_only(rs, timer)
            return ExperimentResult(columns=cols, stats=stats, timings=timer.times)

        contigs = self.contigs(rs.codes, rs.valid, timer)
        solutions = self.merge(contigs, timer)
        cols = self.score(solutions, rs, genome_codes, timer)
        return ExperimentResult(columns=cols, stats=stats, timings=timer.times)
