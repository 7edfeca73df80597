"""Optional diagnostics plots (matplotlib), replacing the reference's PDF
outputs (lib/DeNovoAssembler.R:485-563 boxplots; lib/GenerateReads.R:261-345
probability-track and breakpoint histograms). All plots are derived from the
same CSV/array data the pipeline already emits; matplotlib is imported lazily
so headless/minimal installs never pay for it.

The port's copy of genomeassembler_dev_tpu/utils/plots.py: the same figures,
file names, bins and Welch p-values. Every input is a host numpy array (or
a study's CSVs); callers move tensors off the device first."""

from __future__ import annotations

import os

import numpy as np


def require_matplotlib() -> None:
    """Raise ImportError, naming matplotlib, unless it can be imported; run
    before any work whose figures would otherwise fail at the end."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("--plots draws with matplotlib, which cannot be imported "
                          f"here ({e})") from e


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_probability_track(track: np.ndarray, out_path: str, title: str = "") -> str:
    """Breakage probability along the segment (GenerateReads.R:261-299)."""
    plt = _plt()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig, ax = plt.subplots(figsize=(11, 4))
    ax.bar(np.arange(len(track)), track, width=1.0, color="grey")
    ax.set_xlabel("Genome sequence (8-mer sliding window by 1 nt)")
    ax.set_ylabel("Breakage probability")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_breakpoint_histogram(positions: np.ndarray, seq_len: int, out_path: str,
                              bins: int = 300) -> str:
    """Sampled breakpoint positions (GenerateReads.R:316-345)."""
    plt = _plt()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig, ax = plt.subplots(figsize=(11, 4))
    ax.hist(positions, bins=bins, color="grey")
    ax.set_xlim(0, seq_len)
    ax.set_xlabel("Genomic sequence position")
    ax.set_ylabel("Breakpoint draws")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_score_vs_levdist(columns: dict, out_path: str, bins: int = 6) -> str:
    """Boxplots of the three bp_score flavours vs binned Levenshtein distance
    (lib/DeNovoAssembler.R:485-563)."""
    plt = _plt()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    lev = np.asarray(columns["lev_dist_vs_true"], dtype=float)
    edges = np.linspace(0, max(lev.max(), 1), bins)
    labels = [f"({edges[i]:.0f},{edges[i+1]:.0f}]" for i in range(len(edges) - 1)]
    fig, axes = plt.subplots(1, 3, figsize=(19, 5))
    for ax, key, ylabel in zip(
        axes,
        ["bp_score_true", "bp_score_norm_by_len_true",
         "bp_score_norm_by_break_freqs_true"],
        ["Actual", "Normalised by length", "Normalised by nr of breaks"],
    ):
        vals = np.asarray(columns[key], dtype=float)
        groups = []
        for i in range(len(edges) - 1):
            lo, hi = edges[i], edges[i + 1]
            sel = (lev > lo) & (lev <= hi) if i else (lev >= lo) & (lev <= hi)
            groups.append(vals[sel & ~np.isnan(vals)])
        ax.boxplot(groups, tick_labels=labels)
        ax.set_ylabel(ylabel)
        ax.tick_params(axis="x", rotation=90)
    fig.suptitle("Breakage probability scores vs binned Levenshtein distance")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


# ---------------------------------------------------------------------------
# Study-level (aggregated) figures — the reference's per-study figure
# families, rendered from the committed results_summary.csv / results_all.csv
# (scripts/02_Real_vs_rand_prob_own.R:129-546; 00_…:129-169). One call per
# study directory; every figure lands in <study_dir>/figures/.
# ---------------------------------------------------------------------------

_COL_TRUE = "#2166ac"
_COL_RAND = "#b2182b"


def _read_csv_rows(path: str) -> list[dict]:
    import csv
    import gzip

    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path = path + ".gz"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        return list(csv.DictReader(f))


def _facet_boxpair(plt, rows_by_facet, out_path, ylabel, title,
                   group_names, colors, pvals=None, ylim=None):
    """One row of facets; each facet holds len(group_names) boxes (the
    reference's facet_wrap(vars(read_len), nrow=1) + geom_signif layout)."""
    facets = list(rows_by_facet)
    n = max(1, len(facets))
    fig, axes = plt.subplots(1, n, figsize=(2.3 * n + 2, 5), sharey=True)
    axes = np.atleast_1d(axes)
    for ax, fc in zip(axes, facets):
        groups = rows_by_facet[fc]
        bp = ax.boxplot([g if len(g) else [np.nan] for g in groups],
                        tick_labels=group_names, patch_artist=True,
                        showfliers=True,
                        flierprops=dict(marker=".", alpha=0.1, markersize=3))
        for patch, c in zip(bp["boxes"], colors):
            patch.set_facecolor(c)
            patch.set_alpha(0.75)
        ax.set_title(fc, fontsize=11)
        ax.tick_params(axis="x", rotation=45)
        if pvals is not None and fc in pvals and np.isfinite(pvals[fc]):
            p = pvals[fc]
            stars = ("***" if p < 1e-3 else "**" if p < 1e-2
                     else "*" if p < 5e-2 else "NS")
            ax.set_xlabel(f"t-test {stars} (p={p:.2g})", fontsize=9)
        if ylim is not None:
            ax.set_ylim(*ylim)
    axes[0].set_ylabel(ylabel)
    fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def study_plots(study_dir: str, top_frac: float = 0.05) -> list[str]:
    """Render the aggregated figure families for one study output directory
    (an IndustryModel_* dir holding results_summary.csv / results_all.csv):

      * true-vs-random boxplots per grid row from the summary long table —
        bp_score_norm_by_len for the own study (02_…:129-169) and the KS
        statistic whenever the summary carries stat_test_KS rows (00_…:129-169);
      * top-5%-vs-rest boxplots of the length-normalised score per read_len
        (02_…:217-290, both p4 and p5 rank by bp_score_norm_by_len_true);
      * binned-Levenshtein boxplots (4 bins) of the normalised and raw score
        (02_…:344-430).
    """
    import scipy.stats as st

    plt = _plt()
    fig_dir = os.path.join(study_dir, "figures")
    out: list[str] = []

    srows = _read_csv_rows(os.path.join(study_dir, "results_summary.csv"))
    keys = sorted({r["Key"] for r in srows}) if srows else []
    for key, fname, ylab in (
        ("bp_score_norm_by_len", "Breakscore_contigs_reference.png",
         "Breakage score norm. by contig length"),
        ("stat_test_KS", "KS-statistic_contigs_reference.png",
         "KS statistic"),
    ):
        if key not in keys:
            continue
        by_facet: dict[str, list] = {}
        pvals: dict[str, float] = {}
        rls = sorted({int(float(r["read_len"])) for r in srows}, reverse=True)
        for rl in rls:
            sel = [r for r in srows
                   if int(float(r["read_len"])) == rl and r["Key"] == key
                   and r["Value"] not in ("", "nan")]
            t = np.array([float(r["Value"]) for r in sel
                          if r["random_prob"] == "False"])
            rd = np.array([float(r["Value"]) for r in sel
                           if r["random_prob"] == "True"])
            fc = f"Read len: {rl}"
            by_facet[fc] = [t[~np.isnan(t)], rd[~np.isnan(rd)]]
            if len(t) > 1 and len(rd) > 1:
                pvals[fc] = float(st.ttest_ind(t, rd, equal_var=False,
                                               nan_policy="omit").pvalue)
        out.append(_facet_boxpair(
            plt, by_facet, os.path.join(fig_dir, fname), ylab,
            "Non-random vs random probability (per experiment mean)",
            ["Non-random", "Random"], [_COL_TRUE, _COL_RAND], pvals))

    arows = _read_csv_rows(os.path.join(study_dir, "results_all.csv"))
    if arows:
        rls = sorted({int(float(r["read_len"])) for r in arows}, reverse=True)

        def colf(rows, name):
            return np.array([float(r[name]) if r[name] not in ("", "nan")
                             else np.nan for r in rows])

        # top-5% vs remaining, ranked by the length-normalised score
        by_facet, pvals = {}, {}
        for rl in rls:
            sel = [r for r in arows if int(float(r["read_len"])) == rl]
            v = colf(sel, "bp_score_norm_by_len_true")
            v = v[~np.isnan(v)]
            if not v.size:
                continue
            v = np.sort(v)[::-1]
            n_top = max(1, int(np.floor(top_frac * v.size)))
            top, rest = v[:n_top], v[n_top:]
            fc = f"Read len: {rl}"
            by_facet[fc] = [top, rest]
            if len(top) > 1 and len(rest) > 1:
                pvals[fc] = float(st.ttest_ind(top, rest,
                                               equal_var=False).pvalue)
        out.append(_facet_boxpair(
            plt, by_facet,
            os.path.join(fig_dir, "Breakscore_Top-vs-all-solutions.png"),
            "Breakage score norm. by contig length",
            f"Top {int(top_frac*100)}% vs remaining solutions",
            [f"Top {int(top_frac*100)}%", "Remaining"],
            [_COL_TRUE, _COL_RAND], pvals))

        # binned Levenshtein vs (normalised, raw) score — 4 equal-width bins
        for score_col, fname, ylab in (
            ("bp_score_norm_by_len_true",
             "Binned-Levenshtein-distance_vs_NormBreakscore.png",
             "Breakage score norm. by contig length"),
            ("bp_score_true",
             "Binned-Levenshtein-distance_vs_Breakscore.png",
             "Breakage score"),
        ):
            n_bins = 4
            fig, axes = plt.subplots(1, max(1, len(rls)),
                                     figsize=(2.8 * len(rls) + 2, 5))
            axes = np.atleast_1d(axes)
            for ax, rl in zip(axes, rls):
                sel = [r for r in arows if int(float(r["read_len"])) == rl]
                v = colf(sel, score_col)
                lev = colf(sel, "lev_dist_vs_true")
                ok = ~np.isnan(v) & ~np.isnan(lev)
                v, lev = v[ok], lev[ok]
                if not v.size:
                    continue
                edges = np.linspace(0, max(lev.max(), 1), n_bins + 1)
                groups, labels = [], []
                for i in range(n_bins):
                    lo, hi = edges[i], edges[i + 1]
                    m = (lev >= lo) & (lev <= hi) if i == 0 else \
                        (lev > lo) & (lev <= hi)
                    groups.append(v[m] if m.any() else [np.nan])
                    labels.append(f"({lo:.0f},{hi:.0f}]")
                bp = ax.boxplot(groups, tick_labels=labels, patch_artist=True,
                                flierprops=dict(marker=".", alpha=0.1,
                                                markersize=3))
                for patch in bp["boxes"]:
                    patch.set_facecolor("#80b1d3")
                    patch.set_alpha(0.75)
                ax.set_title(f"Read len: {rl}", fontsize=11)
                ax.tick_params(axis="x", rotation=45)
            axes[0].set_ylabel(ylab)
            fig.supxlabel("Levenshtein distance")
            fig.tight_layout()
            os.makedirs(fig_dir, exist_ok=True)
            p = os.path.join(fig_dir, fname)
            fig.savefig(p, dpi=120)
            plt.close(fig)
            out.append(p)
    return out
