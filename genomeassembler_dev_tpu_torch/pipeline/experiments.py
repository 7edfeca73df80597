"""Study runners: the reference's experiment scripts as library functions.

  * run_own_study      — scripts/02_Real_vs_rand_prob_own.R: the grid of
                         (read_len, dbg_kmer) x total_iters own-dBG
                         experiments, with per-experiment CSV artifacts and
                         summary aggregation (results_summary/results_all).
  * run_kmer_count_study — scripts/01_Real_vs_rand_prob_break_vs_kmers.R:
                         count-only runs for k in {2,4,6,8} and the R^2 of
                         count vs probability.
  * run_gc_study       — scripts/03_GC_content_dependency.R: GC content of
                         each segment vs its mean scores from the saved
                         SolutionsTables.
  * run_velvet_study   — scripts/00_Real_vs_rand_prob_velvet.R: the velvet
                         grid on externally assembled contigs.

Plot generation is replaced by the CSV outputs the plots were drawn from
(SURVEY.md §7.4); any plotting stack can consume them. `plots=True` adds
the per-experiment diagnostics (emit_experiment_plots), and
utils/plots.py::study_plots draws a study's figures from its CSVs.

Mirrors genomeassembler_dev_tpu/pipeline/experiments.py on an explicit
device.
"""

from __future__ import annotations

import csv
import itertools
import os
import shutil
from dataclasses import dataclass

import numpy as np
import torch

from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
from genomeassembler_dev_tpu_torch.core.querytable import QueryTable, load_default_query_table
from genomeassembler_dev_tpu_torch.pipeline import results as res_io
from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
from genomeassembler_dev_tpu_torch.pipeline.batch_runner import run_experiments_batched
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
from genomeassembler_dev_tpu_torch.sim.reads_io import save_read_fastas
from genomeassembler_dev_tpu_torch.sim.segments import SegmentStore
from genomeassembler_dev_tpu_torch.utils.plots import require_matplotlib
from genomeassembler_dev_tpu_torch.utils.profiling import annotate, count
from genomeassembler_dev_tpu_torch.utils.timers import StageTimer


def _write_csv(path: str, names: list[str], rows: list[list]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        w.writerows(rows)


# the reference's results_all column selection (scripts/02_…:174-210,
# 00_…:175-216) plus experiment index and the random-score column our
# stats use
RESULTS_ALL_HEADER = [
    "read_len", "dbg_kmer", "experiment", "sequence_len", "kmer_breaks",
    "bp_score_norm_by_break_freqs_true", "bp_score_norm_by_len_true",
    "bp_score_true", "bp_score_random", "lev_dist_vs_true", "stat_test_KS_true",
]
SUMMARY_HEADER = ["read_len", "dbg_kmer", "Key", "Value", "random_prob"]
# the columns results_summary.csv takes an experiment's mean of: the own
# study's (scripts/02_…:59-120) and the velvet study's (00_…:55-120)
OWN_SUMMARY_KEYS = ("bp_score_norm_by_len_true", "bp_score_norm_by_len_random")
VELVET_SUMMARY_KEYS = ("stat_test_KS_true", "stat_test_KS_random") + OWN_SUMMARY_KEYS


def _spelled_as_read(col: np.ndarray) -> list[str]:
    """A column as load_result_columns reads it (float64 or int64), spelled
    as csv.writer spells its numpy scalars: repr, NaN as "nan"."""
    if col.dtype.kind == "f":
        return ["nan" if x != x else repr(x) for x in col.tolist()]
    return list(map(str, col.tolist()))


def _field_column(name: str, col, fields: list[str]) -> list[str] | None:
    """A column's results_all fields from the fields save_result_fields
    wrote of it, in the bytes the read-back would give, or None where they
    cannot be shown to be those bytes. A float field is the repr of the
    value's float64, which the loader reads back exactly. A column the
    loader turns to int64 is formatted from its values where it is float in
    memory, and taken as written where it is an int within 2**53."""
    if col.dtype.kind == "f":
        if name in res_io.INT_COLUMNS and not np.isnan(col).any():
            return _spelled_as_read(col.astype(np.float64).astype(np.int64))
        return ["nan" if f == "NA" else f for f in fields] if "NA" in fields else fields
    if (name in res_io.INT_COLUMNS
            and -(2**53) <= int(col.min(initial=0)) and int(col.max(initial=0)) <= 2**53):
        return fields
    return None


def _experiment_rows(read_len: int, dbg_kmer: int, ind: int, cols: dict, keys,
                    fields: dict[str, list[str]] | None = None) -> tuple[str, list[float]] | None:
    """An experiment's results_all.csv rows, as one block of CRLF-ended lines
    in the bytes csv.writer gives, and the means of its summary `keys`.

    `cols` is load_result_columns' reading of its table; or, with `fields`
    ({name: the fields save_result_fields wrote}), the columns the table was
    saved from, which give the same bytes and means without reading the
    table back. Returns None where that cannot be shown: a column other
    than `sequence` that is not a 1-D float (of at most 64 bits) or int
    array, or a results_all column that _field_column refuses."""
    if fields is None:
        columns = [_spelled_as_read(cols[name]) for name in RESULTS_ALL_HEADER[3:]]
    else:
        if not all(isinstance(c, np.ndarray) and c.ndim == 1
                   and (c.dtype.kind in "iu" or (c.dtype.kind == "f" and c.itemsize <= 8))
                   for name, c in cols.items() if name != "sequence"):
            return None
        columns = [_field_column(name, cols[name], fields[name])
                   for name in RESULTS_ALL_HEADER[3:]]
        if None in columns:
            return None
    rows = list(map(",".join, zip(itertools.repeat(f"{read_len},{dbg_kmer},{ind}"), *columns)))
    block = "\r\n".join(rows) + "\r\n" if rows else ""
    means = []
    for key in keys:
        col = cols.get(key, ())
        means.append(float(np.nanmean(np.asarray(col, np.float64))) if len(col) else float("nan"))
    return block, means


def _save(workdir: str, ind: int, cfg: ExperimentConfig, res, keys, kept: dict) -> None:
    """save_result; where the table was written plain, the experiment's
    results_all block and summary means go to kept[(read_len, dbg_kmer,
    ind)] for _aggregate."""
    _, names, fields, plain = res_io.save_result_fields(workdir, ind, cfg, res)
    if plain:
        rows = _experiment_rows(cfg.read_len, cfg.dbg_kmer, ind, res.columns, keys,
                               dict(zip(names, fields)))
        if rows is not None:
            kept[(cfg.read_len, cfg.dbg_kmer, ind)] = rows


def _aggregate(workdir: str, base: ExperimentConfig, grid, total_iters: int, keys,
               kept: dict) -> tuple[str, str]:
    """A study's aggregation: per experiment whose SolutionsTable exists, in
    grid row then experiment order, the means of `keys` (results_summary.csv)
    and every solution's row (results_all.csv), each file in one write of
    csv.writer's bytes; returns both paths. An experiment's rows come from
    `kept` (see _save) where it is there, else from its table read back.
    kept holds about 46 KB a 510-row experiment: ~9 MB for a row of 200,
    ~64 MB for the own study's 1,400."""
    summary = [",".join(SUMMARY_HEADER) + "\r\n"]
    blocks = [",".join(RESULTS_ALL_HEADER) + "\r\n"]
    for read_len, dbg_kmer in grid:
        cfg = base.with_(read_len=read_len, dbg_kmer=dbg_kmer)
        for i in range(1, total_iters + 1):
            path = res_io.solutions_path(workdir, i, cfg)
            if not os.path.exists(path):
                continue
            rows = kept.get((read_len, dbg_kmer, i))
            if rows is None:
                count("study.tables_reread")
                rows = _experiment_rows(read_len, dbg_kmer, i,
                                       res_io.load_result_columns(path), keys)
            else:
                count("study.tables_from_memory")
            block, means = rows
            blocks.append(block)
            summary += [f"{read_len},{dbg_kmer},{key.rsplit('_', 1)[0]},{mean!r},"
                        f"{key.endswith('_random')}\r\n" for key, mean in zip(keys, means)]
    out_dir = os.path.join(workdir, f"IndustryModel_{base.industry_standard}")
    os.makedirs(out_dir, exist_ok=True)
    paths = (os.path.join(out_dir, "results_summary.csv"),
             os.path.join(out_dir, "results_all.csv"))
    for path, text in zip(paths, (summary, blocks)):
        with open(path, "w", newline="") as f:
            f.write("".join(text))
    return paths


@dataclass
class StudyReport:
    summary_path: str
    all_path: str
    n_experiments: int
    n_skipped: int


def run_own_study(
    workdir: str,
    segments: SegmentStore,
    device,
    base: ExperimentConfig | None = None,
    grid: tuple[tuple[int, int], ...] | None = None,
    total_iters: int | None = None,
    table: QueryTable | None = None,
    verbose: bool = False,
    batched: bool = False,
    seg_batch: int = 16,
    plots: bool = False,
) -> StudyReport:
    """The own-dBG study (scripts/02_…:21-53 + aggregation :59-214) on
    `device`.

    Segments index experiments: experiment i uses segments[i-1] (1-based ind,
    as the reference's exp_<i> layout). Existing artifacts are skipped —
    the reference's file-per-experiment resume contract. With batched=True
    the device stages run across seg_batch segments at a time
    (pipeline/batch_runner.py; identical outputs, far fewer launches), and
    no read FASTAs are written, as in the JAX package. plots=True draws each
    experiment's diagnostics (emit_experiment_plots); without matplotlib it
    raises before any experiment runs.
    """
    if plots:
        require_matplotlib()
    base = base or ExperimentConfig(
        seq_len=1000, coverage_target=40.0, kmer=8, seed=1234
    )
    grid = grid or ExperimentConfig.OWN_STUDY_GRID
    total_iters = total_iters or len(segments)
    table = table if table is not None else load_default_query_table(device)

    n_run = n_skip = 0
    kept: dict = {}
    for read_len, dbg_kmer in grid:
        cfg = base.with_(read_len=read_len, dbg_kmer=dbg_kmer)
        pending = [i for i in range(1, total_iters + 1)
                   if not res_io.experiment_done(workdir, i, cfg)]
        n_skip += total_iters - len(pending)
        asm = Assembler(cfg, device, table, verbose=verbose)
        if batched:
            for lo in range(0, len(pending), seg_batch):
                chunk = pending[lo : lo + seg_batch]
                # the last chunk is filled up with its first segment, as the
                # JAX runner keeps one batch shape; the extra results go
                segs_chunk = [segments.seqs[i - 1] for i in chunk]
                segs_chunk += segs_chunk[:1] * (seg_batch - len(chunk))
                with annotate("study.batch"):
                    results = run_experiments_batched(cfg, segs_chunk, device, table,
                                                      verbose=verbose)
                with annotate("study.save"):
                    for i, res in zip(chunk, results):
                        _save(workdir, i, cfg, res, OWN_SUMMARY_KEYS, kept)
                        if plots:
                            emit_experiment_plots(workdir, i, asm, res, segments.seqs[i - 1])
                        n_run += 1
            continue
        for i in pending:
            res = asm.run_experiment(segments.seqs[i - 1])
            _save(workdir, i, cfg, res, OWN_SUMMARY_KEYS, kept)
            if cfg.save_read_files:
                _save_reads(workdir, i, asm, segments)
            if plots:
                emit_experiment_plots(workdir, i, asm, res, segments.seqs[i - 1])
            n_run += 1

    if base.save_read_files:
        # the reference deletes data/reads/exp_* after the final iteration
        # (lib/DeNovoAssembler.R:76-83); artifacts in results/ remain
        reads_root = os.path.join(workdir, "reads")
        if os.path.isdir(reads_root):
            shutil.rmtree(reads_root, ignore_errors=True)

    with annotate("study.aggregate"):
        summary_path, all_path = _aggregate(workdir, base, grid, total_iters,
                                            OWN_SUMMARY_KEYS, kept)
    return StudyReport(summary_path, all_path, n_run, n_skip)


def _save_reads(workdir: str, ind: int, asm: Assembler, segments: SegmentStore):
    """The reference's per-experiment read FASTA artifacts
    (lib/GenerateReads.R:419-479): the experiment's reads, re-simulated from
    its seed."""
    seg = segments.seqs[ind - 1]
    rs = asm.simulate(torch.from_numpy(encode_dna(seg)).to(asm.device),
                      StageTimer(asm.device, verbose=False))
    save_read_fastas(
        workdir, ind, asm.config, rs.codes.cpu().numpy(), rs.valid.cpu().numpy(),
        rs.positions.cpu().numpy(), seg, segments.names[ind - 1],
    )


def plot_inputs(asm: Assembler, segment: str) -> tuple[np.ndarray, np.ndarray]:
    """The device part of an experiment's diagnostics, as host arrays: the
    segment's breakage-probability track (sim/reads.py::probability_track at
    the config's kmer) and the breakpoint positions of the valid reads,
    re-drawn with Assembler.simulate from the experiment's seed on the
    Assembler's device, as _save_reads does. They are the positions the
    experiment drew, serial or batched."""
    rs = asm.simulate(torch.from_numpy(encode_dna(segment)).to(asm.device),
                      StageTimer(asm.device, verbose=False))
    return rs.track.cpu().numpy(), rs.positions[rs.valid].cpu().numpy()


def emit_experiment_plots(workdir: str, ind: int, asm: Assembler, res,
                          segment: str) -> list[str]:
    """The reference's per-experiment PDF diagnostics, behind a flag
    (lib/DeNovoAssembler.R:485-563 score boxplots; lib/GenerateReads.R:261-345
    probability track + breakpoint histogram), under the JAX package's file
    names; returns the three paths."""
    from genomeassembler_dev_tpu_torch.utils import plots

    d = res_io.exp_dir(workdir, ind)
    ps = asm.config.param_string()
    track, positions = plot_inputs(asm, segment)
    return [
        plots.plot_probability_track(track, os.path.join(d, f"ProbabilityTrack{ps}.png")),
        plots.plot_breakpoint_histogram(positions, asm.config.seq_len,
                                        os.path.join(d, f"BreakpointHistogram{ps}.png")),
        plots.plot_score_vs_levdist(res.columns, os.path.join(d, f"ScoresVsLevDist{ps}.png")),
    ]


def top_fraction_contrast(values: np.ndarray, frac: float = 0.05,
                          companions: dict[str, np.ndarray] | None = None) -> dict:
    """The reference's headline top-5%-vs-rest contrast
    (scripts/02_Real_vs_rand_prob_own.R:221-260 slice_max(prop=0.05) vs
    slice_min(prop=0.95), significance via t.test — Welch by R default;
    velvet variant scripts/00_…:221-260).

    Ranks `values` descending; the top floor(frac*n) rows are "Top 5%", the
    bottom floor((1-frac)*n) are "Remaining" (the reference's slice_min —
    NOT the complement, so a sliver in the middle can belong to both/neither
    exactly as in R). Returns mean/median of both groups plus the Welch
    t-statistic/p-value, and the same group summaries for each companion
    column (e.g. Levenshtein distance) split by the SAME ranking."""
    import scipy.stats as st

    v = np.asarray(values, float)
    ok = ~np.isnan(v)
    v = v[ok]
    n = v.size
    n_top = int(np.floor(frac * n))
    n_rest = int(np.floor((1.0 - frac) * n))
    order = np.argsort(-v, kind="stable")
    top_idx, rest_idx = order[:n_top], order[::-1][:n_rest]
    out: dict = {"n": n, "n_top": n_top, "n_rest": n_rest}
    if n_top < 2 or n_rest < 2:
        return out | {"t_stat": float("nan"), "t_p": float("nan")}
    top, rest = v[top_idx], v[rest_idx]
    t_stat, t_p = st.ttest_ind(top, rest, equal_var=False)
    out |= {
        "top_mean": float(top.mean()), "top_median": float(np.median(top)),
        "rest_mean": float(rest.mean()), "rest_median": float(np.median(rest)),
        "t_stat": float(t_stat), "t_p": float(t_p),
    }
    for name, comp in (companions or {}).items():
        c = np.asarray(comp, float)[ok]
        ct, cr = c[top_idx], c[rest_idx]
        out[name] = {
            "top_mean": float(np.nanmean(ct)),
            "top_median": float(np.nanmedian(ct)),
            "rest_mean": float(np.nanmean(cr)),
            "rest_median": float(np.nanmedian(cr)),
        }
    return out


def study_statistics(all_csv_path: str, top_frac: float = 0.05) -> dict:
    """The study's significance tests: per grid row, a one-way ANOVA of
    bp_score across binned Levenshtein distance and the Spearman correlation
    of bp_score vs Levenshtein distance (scripts/02_…:548-588), plus the
    top-5%-vs-rest contrast of the reference's figure family
    (scripts/02_…:221-260; velvet variant 00_…:221-260) on each score
    column present, with Levenshtein summaries of the same split and the
    random-probability score contrasted under its own ranking."""
    import gzip

    import scipy.stats as st

    # accept a gzip-compressed results_all.csv.gz (large studies commit only
    # the .gz); a plain path whose .gz sibling is the committed artifact also
    # resolves
    if not os.path.exists(all_csv_path) and os.path.exists(all_csv_path + ".gz"):
        all_csv_path = all_csv_path + ".gz"
    opener = gzip.open if all_csv_path.endswith(".gz") else open
    with opener(all_csv_path, "rt", newline="") as f:
        rows = list(csv.DictReader(f))
    by_grid: dict[tuple[int, int], list[dict]] = {}
    for r in rows:
        key = (int(float(r["read_len"])), int(float(r["dbg_kmer"])))
        by_grid.setdefault(key, []).append(r)
    score_cols = ("bp_score_norm_by_len_true", "bp_score_true",
                  "bp_score_norm_by_break_freqs_true", "bp_score_random")

    def col(rows_, name):
        if name not in rows_[0]:
            return None
        return np.array([float(r[name]) if r[name] != "" else np.nan
                         for r in rows_], float)

    out = {}
    for key, vals in by_grid.items():
        bp = col(vals, "bp_score_true")
        lev = col(vals, "lev_dist_vs_true")
        # degenerate rows (constant score or Levenshtein column) have no
        # defined rank correlation — report nan rather than let spearmanr
        # emit ConstantInputWarning (same guard shape as the ANOVA branch)
        if np.unique(bp[~np.isnan(bp)]).size < 2 or \
                np.unique(lev[~np.isnan(lev)]).size < 2:
            rho, rho_p = float("nan"), float("nan")
        else:
            rho, rho_p = st.spearmanr(bp, lev)
        # bin lev into up to 6 groups (the reference's default bins)
        edges = np.linspace(lev.min(), lev.max() + 1e-9, 7)
        groups = [bp[(lev >= lo) & (lev < hi)] for lo, hi in zip(edges[:-1], edges[1:])]
        groups = [g for g in groups if g.size > 1]
        if len(groups) >= 2:
            f_stat, f_p = st.f_oneway(*groups)
        else:
            f_stat, f_p = float("nan"), float("nan")
        entry = {
            "spearman_rho": float(rho), "spearman_p": float(rho_p),
            "anova_F": float(f_stat), "anova_p": float(f_p),
            "n": int(bp.size),
        }
        top5 = {}
        for sc in score_cols:
            v = col(vals, sc)
            if v is None or np.isnan(v).all():
                continue
            top5[sc] = top_fraction_contrast(
                v, top_frac, companions={"lev_dist_vs_true": lev})
        entry["top_fraction"] = top5
        out[f"{key[0]}:{key[1]}"] = entry
    return out


def count_prob_r_squared(prob: np.ndarray, count: np.ndarray) -> float:
    """R^2 of the least-squares fit count ~ prob (float64 inputs)."""
    A = np.stack([prob, np.ones_like(prob)], axis=1)
    coef, *_ = np.linalg.lstsq(A, count, rcond=None)
    pred = A @ coef
    ss_res = float(((count - pred) ** 2).sum())
    ss_tot = float(((count - count.mean()) ** 2).sum())
    return 1.0 - ss_res / ss_tot if ss_tot else float("nan")


def run_velvet_study(
    workdir: str,
    segments: SegmentStore,
    contig_source,
    device,
    base: ExperimentConfig | None = None,
    grid: tuple[tuple[int, int], ...] | None = None,
    total_iters: int | None = None,
    table: QueryTable | None = None,
    verbose: bool = False,
) -> StudyReport:
    """The industry-standard study (scripts/00_Real_vs_rand_prob_velvet.R) on
    `device`: the own study's shape, with contigs from an external assembler.

    contig_source(assembler, segment, ind) -> list[str] supplies the
    external contigs: IndustryAssembler.run_velvet when the velvet binaries
    exist, or any user-provided assembly."""
    from genomeassembler_dev_tpu_torch.pipeline.velvet import IndustryAssembler

    base = (base or ExperimentConfig(seq_len=50000, coverage_target=40.0,
                                     kmer=8, seed=1234)).with_(industry_standard=True)
    grid = grid or ExperimentConfig.VELVET_STUDY_GRID
    total_iters = total_iters or len(segments)
    table = table if table is not None else load_default_query_table(device)

    n_run = n_skip = 0
    kept: dict = {}
    for read_len, dbg_kmer in grid:
        cfg = base.with_(read_len=read_len, dbg_kmer=dbg_kmer)
        asm = IndustryAssembler(cfg, device, table, verbose=verbose)
        for i in range(1, total_iters + 1):
            if res_io.experiment_done(workdir, i, cfg):
                n_skip += 1
                continue
            contigs = contig_source(asm, segments.seqs[i - 1], i)
            res = asm.run_external(segments.seqs[i - 1], contigs)
            _save(workdir, i, cfg, res, VELVET_SUMMARY_KEYS, kept)
            n_run += 1

    # aggregation (scripts/00_…:55-120): per-experiment mean rows of the KS
    # and length-normalised scores, and per-solution results_all rows
    # (00_…:175-216)
    summary_path, all_path = _aggregate(workdir, base, grid, total_iters,
                                        VELVET_SUMMARY_KEYS, kept)
    return StudyReport(summary_path, all_path, n_run, n_skip)


def run_kmer_count_study(
    workdir: str,
    segment: str,
    device,
    base: ExperimentConfig | None = None,
    ks: tuple[int, ...] = (2, 4, 6, 8),
    table: QueryTable | None = None,
) -> dict[int, float]:
    """Script 01: for each k, count read k-mers on `device` and regress
    count on probability; returns {k: R^2} and writes kmer_count_vs_prob.csv.
    Demonstrates that breakage probability is not explained by k-mer
    frequency (scripts/01_…:48-56)."""
    base = base or ExperimentConfig(seq_len=1000, read_len=20, coverage_target=40.0,
                                    seed=1234)
    table = table if table is not None else load_default_query_table(device)
    rows, r2 = [], {}
    for k in ks:
        cfg = base.with_(only_kmers_from_reads=True, kmer=k)
        res = Assembler(cfg, device, table).run_experiment(segment)
        prob = res.columns["prob"]
        count = res.columns["count"].astype(np.float64)
        r2[k] = count_prob_r_squared(prob, count)
        for code in range(len(prob)):
            rows.append([k, code, prob[code], int(count[code])])
    _write_csv(os.path.join(workdir, "kmer_count_vs_prob.csv"),
               ["k", "code", "prob", "count"], rows)
    return r2


def run_gc_study(
    workdir: str,
    segments: SegmentStore,
    cfg: ExperimentConfig,
    total_iters: int,
) -> str:
    """Script 03: GC fraction of each experiment's segment vs its mean scores
    from the saved SolutionsTables; writes gc_dependency.csv."""
    rows = []
    for i in range(1, total_iters + 1):
        path = res_io.solutions_path(workdir, i, cfg)
        if not os.path.exists(path):
            continue
        seq = segments.seqs[i - 1]
        gc = (seq.count("G") + seq.count("C")) / len(seq)
        cols = res_io.load_result_columns(path)
        rows.append([
            i, gc,
            float(np.nanmean(cols["bp_score_true"])),
            float(np.nanmean(cols["bp_score_norm_by_len_true"])),
            float(np.nanmean(cols["bp_score_norm_by_break_freqs_true"])),
            float(np.nanmean(cols["lev_dist_vs_true"])),
        ])
    out = os.path.join(workdir, "gc_dependency.csv")
    _write_csv(out, ["experiment", "gc_fraction", "mean_bp_score",
                     "mean_bp_score_norm_by_len",
                     "mean_bp_score_norm_by_break_freqs", "mean_lev_dist"], rows)
    return out
