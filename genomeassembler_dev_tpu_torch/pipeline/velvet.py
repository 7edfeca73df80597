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
from genomeassembler_dev_tpu_torch.core.querytable import TOTAL
from genomeassembler_dev_tpu_torch.merge.engine import assemble_solutions
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev_tpu_torch.ops.ks import batched_ks_2samp_masked
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
from genomeassembler_dev_tpu_torch.pipeline.assembler import (
    Assembler, ExperimentResult, experiment_stats, pack_strings, pad_reads, random_scores)
from genomeassembler_dev_tpu_torch.pipeline.results import VELVET_RESULT_COLUMNS  # noqa: F401
from genomeassembler_dev_tpu_torch.score.breakscore import breakscore
from genomeassembler_dev_tpu_torch.sim.reads import ReadSet, dedup_reads
from genomeassembler_dev_tpu_torch.sim.segments import read_fasta
from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

DEFAULT_ORDERINGS = 20000  # BreakageScorer.cpp:86
# Device bytes one evaluation chunk may take: a quarter of an 80 GB H100,
# leaving the rest to the caching allocator's pools and the inputs.
EVAL_BUDGET_BYTES = 20 * 10**9


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


def path_prob_profile(pmat: torch.Tensor, plens: torch.Tensor, probs8: torch.Tensor):
    """The rolling octamer probability of every solution position
    (BreakageScorer.cpp:199-215): (profile [S, L-7] float32, valid [S, L-7]),
    windows past a solution's length masked out."""
    win8, valid = kmer_window_codes(pmat, 8, dtype=torch.int64)
    pos = torch.arange(win8.shape[1], device=pmat.device)
    valid = valid & (pos[None, :] + 8 <= plens[:, None])
    return probs8.to(torch.float32)[win8.clamp(max=65535)], valid


def eval_chunk_rows(sol_len: int, n_reads: int, track_len: int) -> int:
    """Solutions evaluated at once, a multiple of 64, so that one chunk's
    intermediates stay under EVAL_BUDGET_BYTES. Per solution row: ~64 bytes
    per window (the matcher's keys, sort and permutation, the profile), per
    distinct read (the [S, U] match and break-site arrays, int64) and per
    track entry (the KS pooled sort and its float64 cumulative sums), plus
    four float32 count matrices over the 69,904-entry table."""
    row_bytes = 64 * (sol_len + n_reads + track_len) + 16 * TOTAL
    return max(64, EVAL_BUDGET_BYTES // row_bytes // 64 * 64)


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
        dev = self.device
        uniq, counts = dedup_reads(rs.codes, rs.valid)
        rcodes, rcounts, rvalid = pad_reads(uniq, counts, cfg.read_chunk)
        width = -(-max((len(s) for s in solutions), default=1) // 128) * 128
        s_chunk = eval_chunk_rows(width, rcodes.shape[0], rs.track.shape[0])
        pmat_np, plens_np = pack_strings(
            solutions, s_multiple=64 if len(solutions) <= s_chunk else s_chunk,
            l_multiple=128)
        outs: dict[str, list[np.ndarray]] = {}
        for lo in range(0, pmat_np.shape[0], s_chunk):
            pmat = torch.from_numpy(pmat_np[lo : lo + s_chunk]).to(dev)
            plens = torch.from_numpy(plens_np[lo : lo + s_chunk]).to(dev)
            bs = breakscore(pmat, plens, rcodes, rcounts, rvalid, self.table.combined,
                            break_kmer=cfg.kmer)
            bp_rand, bp_rand_nb, bp_rand_nl = random_scores(bs, plens, self.uniform)
            prof, prof_valid = path_prob_profile(pmat, plens, self.table.probs[8])
            chunk = {
                "bp_score": bs.bp_score,
                "bp_nb": bs.bp_score_norm_by_break_freqs,
                "bp_nl": bs.bp_score_norm_by_len,
                "kmer_breaks": bs.kmer_breaks,
                "bp_rand": bp_rand,
                "bp_rand_nb": bp_rand_nb,
                "bp_rand_nl": bp_rand_nl,
                "ks": batched_ks_2samp_masked(prof, prof_valid, rs.track),
                "lev": batched_levenshtein_auto(pmat, plens, genome_codes, mode="HW"),
            }
            for name, t in chunk.items():
                outs.setdefault(name, []).append(t.cpu().numpy())
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
