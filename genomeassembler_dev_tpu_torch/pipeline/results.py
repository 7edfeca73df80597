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
from genomeassembler_dev_tpu_torch.utils.profiling import annotate, count

# the velvet path's solution table (pipeline/velvet.py)
VELVET_RESULT_COLUMNS = [
    "sequence", "sequence_len",
    "bp_score_true", "bp_score_norm_by_break_freqs_true",
    "bp_score_norm_by_len_true", "kmer_breaks", "lev_dist_vs_true",
    "stat_test_KS_true", "path_prob_dist_startpos", "contig_frac_len",
    "bp_score_random", "bp_score_norm_by_break_freqs_random",
    "bp_score_norm_by_len_random", "stat_test_KS_random",
]

# the columns load_result_columns reads as int64 where they hold no NA
INT_COLUMNS = ("sequence_len", "kmer_breaks", "lev_dist_vs_true")


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


def _format_column(col) -> list[str]:
    """A column's fields, as _fmt formats them one cell at a time: a 1-D
    float array (float64 or narrower; tolist() gives each value's exact
    float64) or int, uint or bool array through tolist() at once, anything
    else a cell at a time."""
    if isinstance(col, np.ndarray) and col.ndim == 1:
        if col.dtype.kind == "f" and col.itemsize <= 8:
            return ["NA" if x != x else repr(x) for x in col.tolist()]
        if col.dtype.kind in "iub":
            return list(map(str, col.tolist()))
    return [_fmt(v) for v in col]


def _unquoted(fields) -> bool:
    """Whether csv's QUOTE_MINIMAL writes every one of these fields as it is."""
    text = "".join(fields)
    return not any(ch in text for ch in ',"\r\n')


def save_result(workdir: str, ind: int, cfg: ExperimentConfig, res: ExperimentResult) -> str:
    """Write an experiment's SolutionsTable and stats; returns the table's
    path. See save_result_fields."""
    return save_result_fields(workdir, ind, cfg, res)[0]


def save_result_fields(workdir: str, ind: int, cfg: ExperimentConfig,
                       res: ExperimentResult) -> tuple[str, list[str], list[list[str]], bool]:
    """Write an experiment's SolutionsTable and stats, as save_result does;
    returns (path, column names, each column's fields, plain). The table is
    formatted a column at a time and written at once, in the bytes
    csv.writer gives; where csv would quote a field (a `,`, `"`, CR or LF in
    it, or the one field of a one-column row empty) or a column's length
    differs from the first's, csv.writer writes it and `plain` is False.
    The fields are the cells of the table written when `plain` is True."""
    with annotate("results.save"):
        d = exp_dir(workdir, ind)
        os.makedirs(d, exist_ok=True)
        path = solutions_path(workdir, ind, cfg)
        cols = res.columns
        names = _canonical_names(cols)
        n = len(cols[names[0]])
        fields = [_format_column(cols[c]) for c in names]
        plain = (all(len(f) == n for f in fields)
                 and all(map(_unquoted, [names, *fields]))
                 and (len(names) > 1 or "" not in [names[0], *fields[0]]))
        with open(path, "w", newline="") as f:
            if plain:
                f.write("\r\n".join([",".join(names), *map(",".join, zip(*fields))]) + "\r\n")
            else:
                count("results.codec_fallback")
                w = csv.writer(f)
                w.writerow(names)
                for i in range(n):
                    w.writerow([_fmt(cols[c][i]) for c in names])
        count("results.rows_written", n)
        with open(stats_path(workdir, ind, cfg), "w") as f:
            f.write(json.dumps({"stats": res.stats, "timings": res.timings}, indent=1))
        return path, names, fields, plain


def _split_unquoted(text: str) -> list[list[str]] | None:
    """The rows csv.reader gives of `text`, where that is a split on line
    ends and commas: no `"`, every line ended by CRLF or every one by LF, no
    empty line, every row as wide as the first. Otherwise None."""
    if not text or '"' in text:
        return None
    lines = text.split("\r\n" if "\r" in text else "\n")
    if lines[-1] == "":
        lines.pop()
    if "" in lines or any("\r" in line or "\n" in line for line in lines):
        return None
    rows = [line.split(",") for line in lines]
    width = len(rows[0])
    if any(len(row) != width for row in rows):
        return None
    return rows


def load_result_columns(path: str) -> dict[str, np.ndarray | list]:
    """Read a SolutionsTable CSV back into column arrays: `sequence` a list of
    str, every other column float64 with NA as NaN, and sequence_len,
    kmer_breaks and lev_dist_vs_true int64 where they hold no NA. An unquoted
    table is split on line ends and commas; any other goes through
    csv.reader."""
    with open(path, newline="\n") as f:  # no newline translation, as newline=""
        rows = _split_unquoted(f.read())
    if rows is not None:
        names = rows[0]
        columns = list(zip(*rows[1:])) if len(rows) > 1 else [()] * len(names)
    else:
        count("results.codec_fallback")
        with open(path, newline="") as f:
            r = csv.reader(f)
            names = next(r)
            rows = list(r)
        columns = [[row[j] for row in rows] for j in range(len(names))]
    out: dict[str, np.ndarray | list] = {}
    for name, vals in zip(names, columns):
        if name == "sequence":
            out[name] = list(vals)
            continue
        arr = np.array([np.nan if v == "NA" else float(v) for v in vals], dtype=np.float64)
        if name in INT_COLUMNS and not np.isnan(arr).any():
            arr = arr.astype(np.int64)
        out[name] = arr
    return out
