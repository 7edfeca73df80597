"""Industry-standard (external-assembler) path (mirrors
genomeassembler_dev_tpu/pipeline/velvet.py).

The reference's velvet path: reads are written as paired FASTAs, velvet
assembles them externally, and its contigs.fa enters the scoring pipeline
with the path's own semantics (lib/DeNovoAssembler.R:173-233,
lib/BreakageScorer.cpp):

  * 20,000 shuffled orderings in the native merge unless
    velvet_n_orderings says otherwise;
  * the per-position octamer probability profile of each solution, whose
    KS statistic against the segment's octamer track is `stat_test_KS_*`;
  * `path_prob_dist_startpos` = the solution's first occurrence in the
    segment; solutions absent from it are dropped;
  * Levenshtein distance in HW (infix) mode, through the Myers kernel;
  * the covered fraction of the segment by interval union, with the R
    code's endpoint convention kept literally.

The velveth/velvetg subprocess adapter runs when the binaries are on PATH;
otherwise callers supply the contigs.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import torch

from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
from genomeassembler_dev_tpu_torch.merge.engine import assemble_solutions
from genomeassembler_dev_tpu_torch.pipeline.assembler import (
    Assembler, ExperimentResult, experiment_stats)
from genomeassembler_dev_tpu_torch.pipeline.evaluate import (
    evaluate_group, pack_chunks, pack_reads)
from genomeassembler_dev_tpu_torch.pipeline.results import VELVET_RESULT_COLUMNS  # noqa: F401
from genomeassembler_dev_tpu_torch.sim.reads import ReadSet
from genomeassembler_dev_tpu_torch.sim.segments import read_fasta
from genomeassembler_dev_tpu_torch.utils.profiling import annotate
from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

DEFAULT_ORDERINGS = 20000  # BreakageScorer.cpp:86


def covered_fraction(startpos: np.ndarray, lens: np.ndarray, seq_len: int) -> float:
    """GRanges reduce/setdiff coverage (lib/DeNovoAssembler.R:431-445): the
    ranges [startpos, startpos + len] (the R code's literal endpoint
    convention) unioned; the covered percentage of [1, seq_len]."""
    ivals = []
    for s, ln in zip(startpos, lens):
        lo, hi = max(1, int(s)), min(seq_len, int(s) + int(ln))
        if hi >= lo:
            ivals.append((lo, hi))
    if not ivals:
        return 0.0
    ivals.sort()
    covered = 0
    cur_lo, cur_hi = ivals[0]
    for lo, hi in ivals[1:]:
        if lo > cur_hi + 1:
            covered += cur_hi - cur_lo + 1
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    covered += cur_hi - cur_lo + 1
    return 100.0 * (1.0 - (seq_len - covered) / seq_len)


class IndustryAssembler(Assembler):
    """Scores externally assembled contigs with the velvet path's semantics."""

    def evaluate(self, solutions: list[str], rs: ReadSet,
                 genome_codes: torch.Tensor) -> dict[str, np.ndarray]:
        """Every score of every solution, in solution order (nothing
        filtered): host arrays bp_score, bp_nb, bp_nl, kmer_breaks, bp_rand,
        bp_rand_nb, bp_rand_nl, ks and lev (HW), each [len(solutions)]. The
        solution axis is cut into chunks of eval_chunk_rows rows; a last
        partial chunk is filled with length-0 rows."""
        cfg = self.config
        with annotate("eval.pack"):
            reads = pack_reads(rs.codes, rs.valid, cfg.read_chunk)
            pmat, plens, rows = pack_chunks(solutions, reads[0].shape[0], rs.track.shape[0])
        outs: dict[str, list[np.ndarray]] = {}
        for lo in range(0, pmat.shape[0], rows):
            host = evaluate_group([(pmat[lo : lo + rows], plens[lo : lo + rows]) + reads],
                                  genome_codes[None], rs.track[None], self.table, self.uniform,
                                  cfg.kmer, mode="HW", profile_ks=True)
            for name, a in host.items():
                outs.setdefault(name, []).append(a[0])
        n = len(solutions)
        return {name: np.concatenate(parts)[:n] for name, parts in outs.items()}

    def run_external(self, segment: str, external_contigs: list[str],
                     read_set: tuple | None = None) -> ExperimentResult:
        """One velvet-path experiment on external contigs. `read_set`
        optionally replays stored (codes, valid, positions) arrays instead of
        simulating, as in Assembler.run_experiment."""
        cfg = self.config
        timer = StageTimer(self.device, self.verbose)
        genome_np = encode_dna(segment)
        genome_codes = torch.from_numpy(genome_np).to(self.device)
        if read_set is not None:
            rs = self._replay_read_set(genome_codes, read_set)
        else:
            rs = self.simulate(genome_codes, timer)
        stats = experiment_stats(self.config, segment, genome_np, int(rs.valid.sum()))

        with timer.stage("Merging shuffled contig orderings (velvet path)"):
            solutions = assemble_solutions(
                external_contigs, cfg.dbg_kmer, cfg.seed,
                cfg.velvet_n_orderings or DEFAULT_ORDERINGS, backend=cfg.merge_backend,
                device=self.device)

        with timer.stage("Evaluating each de novo assembled solution"):
            ev = self.evaluate(solutions, rs, genome_codes)
            with annotate("eval.columns"):
                plens = np.array([len(s) for s in solutions], np.int32)
                startpos = np.array([segment.find(s) for s in solutions], np.int64)
                keep = startpos != -1  # lib/DeNovoAssembler.R:360-362
                frac = covered_fraction(startpos[keep], plens[keep], cfg.seq_len)
                # rows by true-table bp_score, descending and stable; solutions
                # absent from the segment are dropped after ordering
                order = np.argsort(-ev["bp_score"], kind="stable")
                order = order[keep[order]]
                cols = {
                    "sequence": [solutions[i] for i in order],
                    "sequence_len": plens[order],
                    "bp_score_true": ev["bp_score"][order],
                    "bp_score_norm_by_break_freqs_true": ev["bp_nb"][order],
                    "bp_score_norm_by_len_true": ev["bp_nl"][order],
                    "kmer_breaks": ev["kmer_breaks"][order],
                    "lev_dist_vs_true": ev["lev"][order],
                    "stat_test_KS_true": ev["ks"][order],
                    "path_prob_dist_startpos": startpos[order],
                    "contig_frac_len": np.full(len(order), frac),
                    "bp_score_random": ev["bp_rand"][order],
                    "bp_score_norm_by_break_freqs_random": ev["bp_rand_nb"][order],
                    "bp_score_norm_by_len_random": ev["bp_rand_nl"][order],
                    "stat_test_KS_random": ev["ks"][order],
                }
        return ExperimentResult(columns=cols, stats=stats, timings=timer.times)

    # -- velvet subprocess adapter (lib/DeNovoAssembler.R:182-222) ----------

    @staticmethod
    def velvet_available() -> bool:
        return shutil.which("velveth") is not None and shutil.which("velvetg") is not None

    def run_velvet(self, read1_fasta: str, read2_fasta: str, out_dir: str) -> list[str]:
        """velveth/velvetg with the reference's flags; returns the contigs."""
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run(
            ["velveth", out_dir, str(self.config.dbg_kmer), "-shortPaired", "-fasta",
             "-separate", read1_fasta, read2_fasta],
            check=True, capture_output=True,
        )
        subprocess.run(
            ["velvetg", out_dir, "-exp_cov", "auto", "-cov_cutoff", "auto",
             "-scaffolding", "yes"],
            check=True, capture_output=True,
        )
        return list(read_fasta(os.path.join(out_dir, "contigs.fa")).values())
