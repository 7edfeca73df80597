"""Result artifacts: per-experiment CSV + stats, resume contract.

Mirrors the reference's layout (lib/DeNovoAssembler.R:268-313):

  <workdir>/results/exp_<ind>/SolutionsTable<param_string>.csv
  <workdir>/results/exp_<ind>/AssemblyStats<param_string>.json

(the reference writes an .RData RDS for the stats; JSON is the native format
here, same content). Mirrors genomeassembler_dev_tpu/pipeline/results.py:
the same paths, formatting, schema check and loader. The file-per-experiment layout is the restart unit:
`experiment_done` + skip-if-exists gives idempotent re-runs of missing
shards, as in the reference's aggregation scripts.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from genomeassembler_dev_tpu_torch.pipeline.assembler import RESULT_COLUMNS, ExperimentResult
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
from genomeassembler_dev_tpu_torch.utils.profiling import annotate

# the velvet path's solution table (pipeline/velvet.py)
VELVET_RESULT_COLUMNS = [
    "sequence", "sequence_len",
    "bp_score_true", "bp_score_norm_by_break_freqs_true",
    "bp_score_norm_by_len_true", "kmer_breaks", "lev_dist_vs_true",
    "stat_test_KS_true", "path_prob_dist_startpos", "contig_frac_len",
    "bp_score_random", "bp_score_norm_by_break_freqs_random",
    "bp_score_norm_by_len_random", "stat_test_KS_random",
]


def exp_dir(workdir: str, ind: int) -> str:
    return os.path.join(workdir, "results", f"exp_{ind}")


def solutions_path(workdir: str, ind: int, cfg: ExperimentConfig) -> str:
    return os.path.join(exp_dir(workdir, ind), f"SolutionsTable{cfg.param_string()}.csv")


def stats_path(workdir: str, ind: int, cfg: ExperimentConfig) -> str:
    return os.path.join(exp_dir(workdir, ind), f"AssemblyStats{cfg.param_string()}.json")


def experiment_done(workdir: str, ind: int, cfg: ExperimentConfig) -> bool:
    return os.path.exists(solutions_path(workdir, ind, cfg))


def _fmt(v) -> str:
    if isinstance(v, (float, np.floating)):
        if np.isnan(v):
            return "NA"
        return repr(float(v))
    return str(v)


def _canonical_names(cols: dict) -> list[str]:
    """Canonical column order with schema validation.

    Known solution-table columns are written in the canonical order of the
    reference's joined table (RESULT_COLUMNS; the velvet path's variant adds
    path_prob_dist_startpos — lib/BreakageScorer.cpp:343-353, consumed at
    lib/DeNovoAssembler.R:361-371). A result that matches part of a schema
    but is missing canonical columns signals a drifted or misnamed builder
    column and fails loud instead of being silently written; results with no
    schema overlap (e.g. the count-only path's prob/count) keep their own
    order, with extras appended after the canonical set."""
    schema = (VELVET_RESULT_COLUMNS if "path_prob_dist_startpos" in cols
              else RESULT_COLUMNS)
    present = [c for c in schema if c in cols]
    if not present:
        return list(cols)  # non-solution table (count-only path)
    missing = [c for c in schema if c not in cols]
    if missing:
        raise ValueError(
            f"solution table is missing canonical columns {missing}; "
            f"got {sorted(cols)}")
    return present + [c for c in cols if c not in schema]


def save_result(workdir: str, ind: int, cfg: ExperimentConfig, res: ExperimentResult) -> str:
    with annotate("results.save"):
        d = exp_dir(workdir, ind)
        os.makedirs(d, exist_ok=True)
        path = solutions_path(workdir, ind, cfg)
        cols = res.columns
        names = _canonical_names(cols)
        n = len(cols[names[0]])
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(names)
            for i in range(n):
                w.writerow([_fmt(cols[c][i]) for c in names])
        with open(stats_path(workdir, ind, cfg), "w") as f:
            json.dump({"stats": res.stats, "timings": res.timings}, f, indent=1)
        return path


def load_result_columns(path: str) -> dict[str, np.ndarray | list]:
    """Read a SolutionsTable CSV back into column arrays."""
    with open(path, newline="") as f:
        r = csv.reader(f)
        names = next(r)
        rows = list(r)
    out: dict[str, np.ndarray | list] = {}
    for j, name in enumerate(names):
        vals = [row[j] for row in rows]
        if name == "sequence":
            out[name] = vals
            continue
        conv = []
        for v in vals:
            if v == "NA":
                conv.append(np.nan)
            else:
                conv.append(float(v))
        arr = np.asarray(conv)
        if name in ("sequence_len", "kmer_breaks", "lev_dist_vs_true") and not np.isnan(arr).any():
            arr = arr.astype(np.int64)
        out[name] = arr
    return out
