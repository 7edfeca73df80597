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

from genomeassembler_dev_tpu_torch.core.encoding import INVALID, encode_dna
from genomeassembler_dev_tpu_torch.core.querytable import (
    QueryTable, load_default_query_table)
from genomeassembler_dev_tpu_torch.dbg.assemble import contigs_from_read_codes, dedup_contigs
from genomeassembler_dev_tpu_torch.dbg.biased import biased_contigs
from genomeassembler_dev_tpu_torch.merge.engine import assemble_solutions
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers
from genomeassembler_dev_tpu_torch.ops.ks import batched_ks_2samp
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
from genomeassembler_dev_tpu_torch.score.breakscore import BreakScores, breakscore, dot_f32
from genomeassembler_dev_tpu_torch.sim.reads import (
    ReadSet, dedup_reads, generate_reads, probability_track)
from genomeassembler_dev_tpu_torch.utils.profiling import annotate, count, tracing
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_strings(strings: list[str], pad: int = INVALID, s_multiple: int = 1,
                 l_multiple: int = 1):
    """[S] strings -> ([S', L'] uint8 codes, [S'] int32 lens), both sizes
    rounded up to their multiples (the JAX version's bucket ladder served
    its jit cache). Pad rows have length 0."""
    L = _round_up(max((len(s) for s in strings), default=1), l_multiple)
    S = _round_up(max(len(strings), 1), s_multiple)
    mat = np.full((S, L), pad, np.uint8)
    lens = np.zeros(S, np.int32)
    for i, s in enumerate(strings):
        mat[i, : len(s)] = encode_dna(s)
        lens[i] = len(s)
    return mat, lens


def pad_reads(uniq: torch.Tensor, counts: torch.Tensor, multiple: int = 512):
    """Distinct reads padded to a multiple of rows; pad rows are invalid and
    carry count 0. Returns (codes [U', R], counts [U'], valid [U'])."""
    U = uniq.shape[0]
    Up = _round_up(max(U, 1), multiple)
    codes = torch.zeros((Up, uniq.shape[1]), dtype=torch.uint8, device=uniq.device)
    cnts = torch.zeros(Up, dtype=torch.int32, device=uniq.device)
    valid = torch.zeros(Up, dtype=torch.bool, device=uniq.device)
    codes[:U] = uniq
    cnts[:U] = counts
    valid[:U] = True
    return codes, cnts, valid


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


def solution_columns(solutions: list[str], plens_np: np.ndarray, host: dict[str, np.ndarray],
                     seq_len: int) -> dict[str, np.ndarray | list]:
    """The own path's results table from every score of every solution
    (host arrays in solution order, pad rows allowed past len(solutions)):
    rows by true-table bp_score, descending and stable."""
    n_real = len(solutions)
    host = {name: a[:n_real] for name, a in host.items()}
    # own-path coverage fraction: every startpos is 0, so it is the longest
    # solution over seq_len, capped at 100%
    max_len = int(plens_np.max()) if solutions else 0
    contig_frac = min(100.0, 100.0 * max_len / seq_len)
    order = np.argsort(-host["bp"], kind="stable")
    return {
        "sequence": [solutions[i] for i in order],
        "sequence_len": plens_np[:n_real][order],
        "bp_score_true": host["bp"][order],
        "bp_score_norm_by_break_freqs_true": host["bp_nb"][order],
        "bp_score_norm_by_len_true": host["bp_nl"][order],
        "kmer_breaks": host["breaks"][order],
        "lev_dist_vs_true": host["lev"][order],
        "stat_test_KS_true": host["ks"][order],
        "contig_frac_len": np.full(n_real, contig_frac),
        "bp_score_random": host["rand"][order],
        "bp_score_norm_by_break_freqs_random": host["rand_nb"][order],
        "bp_score_norm_by_len_random": host["rand_nl"][order],
        "stat_test_KS_random": host["ks"][order],
    }


def random_scores(bs: BreakScores, plens: torch.Tensor, uniform: QueryTable):
    """The random pass: the same break counts against the uniform table.
    Returns (bp_score, norm_by_break_freqs, norm_by_len), each [S] (a
    group's [G, S])."""
    uni = uniform.combined.to(torch.float32)
    total = bs.kmer_breaks.to(torch.float32).clamp(min=1.0)
    bp_rand = dot_f32(bs.site_counts, uni)
    norm_breaks = torch.where(
        bs.kmer_breaks > 0, dot_f32(bs.site_counts / total[..., None], uni), 0.0)
    return bp_rand, norm_breaks, bp_rand / plens.to(torch.float32).clamp(min=1.0)


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
        dev = self.device
        with timer.stage("Evaluating each de novo assembled solution"):
            with annotate("eval.pack"):
                pmat_np, plens_np = pack_strings(solutions, s_multiple=64, l_multiple=128)
                pmat = torch.from_numpy(pmat_np).to(dev)
                plens = torch.from_numpy(plens_np).to(dev)
                uniq, counts = dedup_reads(rs.codes, rs.valid)
                rcodes, rcounts, rvalid = pad_reads(uniq, counts, cfg.read_chunk)
            if tracing():
                count("eval.bases", int(plens_np.sum()))
                count("eval.cells", pmat_np.size)
            with annotate("eval.breakscore"):
                bs = breakscore(pmat, plens, rcodes, rcounts, rvalid,
                                self.table.combined, break_kmer=cfg.kmer)
            with annotate("eval.random"):
                bp_rand, bp_rand_norm_breaks, bp_rand_norm_len = random_scores(
                    bs, plens, self.uniform)
            with annotate("eval.levenshtein"):
                lev = batched_levenshtein_auto(pmat, plens, genome_codes, mode="NW")
            with annotate("eval.ks"):
                ks = batched_ks_2samp(bs.path_freq, rs.track)
            with annotate("eval.readback"):
                host = {name: t.cpu().numpy() for name, t in (
                    ("bp", bs.bp_score),
                    ("bp_nb", bs.bp_score_norm_by_break_freqs),
                    ("bp_nl", bs.bp_score_norm_by_len),
                    ("breaks", bs.kmer_breaks),
                    ("lev", lev),
                    ("ks", ks),
                    ("rand", bp_rand),
                    ("rand_nb", bp_rand_norm_breaks),
                    ("rand_nl", bp_rand_norm_len),
                )}
            with annotate("eval.columns"):
                return solution_columns(solutions, plens_np, host, cfg.seq_len)

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
