"""PyTorch port vs the JAX package end to end: Assembler.run_experiment on a
replayed read set (all 13 result columns and the stats), the k-mer-count
path, the own-dBG golden fixtures, and the port's independence from jax."""

import csv
import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from genomeassembler_dev_tpu.core.encoding import encode_dna  # noqa: E402
from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.pipeline import assembler as jasm  # noqa: E402
from genomeassembler_dev_tpu.pipeline.config import ExperimentConfig as JConfig  # noqa: E402
from genomeassembler_dev_tpu.sim.reads import generate_reads  # noqa: E402
from genomeassembler_dev_tpu.sim.segments import synthetic_genome  # noqa: E402
from genomeassembler_dev_tpu_torch.core.querytable import QueryTable  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import assembler as tasm  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import evaluate  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "golden", "fixtures")
RTOL = 2e-5
INT_COLUMNS = ("sequence_len", "kmer_breaks", "lev_dist_vs_true")
SMALL = dict(seq_len=300, read_len=12, coverage_target=15.0, kmer=8, dbg_kmer=9,
             seed=1234, n_orderings=300)


def by_sequence(cols):
    """Row index of each sequence: rows tied on bp_score may order
    differently on two backends, so rows are aligned by sequence."""
    return {s: i for i, s in enumerate(cols["sequence"])}


@pytest.fixture(scope="module")
def jtable():
    return load_default_query_table()


# BASELINE config 1 cut to CPU size: its 150-base reads, dbg k 31 (JAX's
# dbg/big_k.py path) and scoring, on a 2,400-base segment with a planted
# 200-base repeat (longer than a read, so several solutions) at coverage 20
CONFIG1 = dict(seq_len=2400, read_len=150, coverage_target=20.0, kmer=8, dbg_kmer=31,
               seed=1234, n_orderings=300)
# a 1 kb segment (no repeat) at coverage 6 breaks into enough contigs for
# 317 solutions: 320 padded rows, so the serial KS takes two chunks of KS_ROWS
MANY = dict(seq_len=1000, read_len=12, coverage_target=6.0, kmer=8, dbg_kmer=9, seed=1234,
            n_orderings=3000)
# each case's config and its segment with a planted repeat, as (genome
# length, cut, repeat start, repeat end, end): g[:cut] + g[start:end] + g[cut:end]
REPLAYED = {"small": (SMALL, (300, 150, 30, 70, 260)),
            "config1": (CONFIG1, (2400, 1200, 100, 300, 2200)),
            "many": (MANY, (1000, 1000, 0, 0, 1000))}


@pytest.fixture(scope="module", params=list(REPLAYED))
def replayed(request, jtable):
    """One JAX-simulated read set (with a planted repeat, so several
    solutions) through both pipelines."""
    cfg, (n, cut, lo, hi, end) = REPLAYED[request.param]
    g = synthetic_genome(42, n)
    segment = g[:cut] + g[lo:hi] + g[cut:end]
    rs = generate_reads(jax.random.key(1234), encode_dna(segment), jtable, cfg["read_len"],
                        cfg["coverage_target"])
    read_set = tuple(np.asarray(a) for a in (rs.codes, rs.valid, rs.positions))
    jres = jasm.Assembler(JConfig(**cfg), jtable).run_experiment(segment, read_set)
    asm = tasm.Assembler(ExperimentConfig(**cfg), "cpu",
                         QueryTable.from_numpy(jtable.probs, "cpu"))
    return jres, asm.run_experiment(segment, read_set)


def test_all_columns_vs_jax(replayed):
    jres, tres = replayed
    assert list(tres.columns) == tasm.RESULT_COLUMNS == jasm.RESULT_COLUMNS
    assert tres.n_solutions == jres.n_solutions > 1
    jrow = by_sequence(jres.columns)
    assert set(jrow) == set(tres.columns["sequence"])
    idx = [jrow[s] for s in tres.columns["sequence"]]
    for name in tasm.RESULT_COLUMNS[1:]:
        got = np.asarray(tres.columns[name])
        want = np.asarray(jres.columns[name])[idx]
        if name in INT_COLUMNS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    bp = tres.columns["bp_score_true"]
    assert (np.diff(bp) <= 0).all()  # rows by true-table bp_score, descending


def test_stats_and_timings(replayed):
    jres, tres = replayed
    assert tres.stats == jres.stats
    assert set(tres.timings) == {
        "Running DBG de novo genome assembler", "Merging shuffled contig orderings",
        "Evaluating each de novo assembled solution"}


@pytest.mark.parametrize("name", ["own_k9_rl12", "own_k13_rl16", "own_k15_rl20"])
def test_golden_own(name):
    """The dense path (k 9) and the sparse path (k 13, 15) against the
    original C++'s outputs."""
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        fx = json.load(f)
    c, ref = fx["config"], fx["reference"]
    cfg = ExperimentConfig(seq_len=c["seq_len"], read_len=c["read_len"],
                           dbg_kmer=c["dbg_kmer"], kmer=c["break_kmer"], seed=c["seed"],
                           n_orderings=ref["n_orderings"])
    asm = tasm.Assembler(cfg, "cpu")
    codes = np.stack([encode_dna(r) for r in fx["reads"]])
    read_set = (codes, np.ones(len(codes), bool), np.zeros(len(codes), np.int32))
    rs = asm._replay_read_set(torch.from_numpy(encode_dna(fx["segment"])), read_set)
    timer = tasm.StageTimer("cpu", verbose=False)
    assert asm.contigs(rs.codes, rs.valid, timer) == ref["contigs"]
    res = asm.run_experiment(fx["segment"], read_set)
    assert sorted(res.columns["sequence"]) == sorted(ref["solutions"])
    row = by_sequence(res.columns)
    idx = [row[s] for s in ref["sequence"]]
    for name, col in (("kmer_breaks", "kmer_breaks"), ("lev_dist_vs_true", "lev_dist_vs_true"),
                      ("sequence_len", "sequence_len")):
        np.testing.assert_array_equal(np.asarray(res.columns[col])[idx], ref[name])
    for name, col in (("bp_score", "bp_score_true"),
                      ("bp_score_norm_by_break_freqs", "bp_score_norm_by_break_freqs_true"),
                      ("bp_score_norm_by_len", "bp_score_norm_by_len_true")):
        np.testing.assert_allclose(np.asarray(res.columns[col])[idx], ref[name], rtol=RTOL)


def test_config_mirrors_jax():
    names = [f.name for f in dataclasses.fields(JConfig)]
    assert [f.name for f in dataclasses.fields(ExperimentConfig)] == names
    assert all(getattr(ExperimentConfig(), n) == getattr(JConfig(), n) for n in names)
    assert ExperimentConfig.OWN_STUDY_GRID == JConfig.OWN_STUDY_GRID
    for bad in (dict(kmer=5), dict(dbg_kmer=40), dict(read_len=8, dbg_kmer=9),
                dict(n_orderings=0), dict(traversal="x")):
        with pytest.raises(ValueError):
            JConfig(**bad).validate()
        with pytest.raises(ValueError):
            ExperimentConfig(**bad).validate()


@pytest.mark.parametrize("k", [2, 4, 6, 8])
def test_count_only_vs_jax(jtable, k):
    """The k-mer-count path on one replayed read set: the table's column and
    the read k-mer counts equal JAX's."""
    segment = synthetic_genome(43, 300)
    rs = generate_reads(jax.random.key(1234), encode_dna(segment), jtable, 20, 15.0, k)
    read_set = tuple(np.asarray(a) for a in (rs.codes, rs.valid, rs.positions))
    kw = {**SMALL, "read_len": 20, "kmer": k, "only_kmers_from_reads": True}
    jres = jasm.Assembler(JConfig(**kw), jtable).run_experiment(segment, read_set)
    tres = tasm.Assembler(ExperimentConfig(**kw), "cpu",
                          QueryTable.from_numpy(jtable.probs, "cpu")).run_experiment(
                              segment, read_set)
    assert list(tres.columns) == list(jres.columns) == ["prob", "count"]
    np.testing.assert_array_equal(tres.columns["prob"], jres.columns["prob"])
    np.testing.assert_array_equal(tres.columns["count"], jres.columns["count"])
    assert tres.columns["count"].sum() > 0
    assert tres.stats == jres.stats
    assert list(tres.timings) == ["Extracting k-mers from sequencing reads"]


def assert_same_artifacts(dir_a, dir_b):
    """Two study workdirs hold the same artifacts with the same values:
    solution lists and integers exact, floats at RTOL (NaN where NaN), the
    stats equal; only the stage timings may differ."""
    from genomeassembler_dev_tpu_torch.pipeline.results import load_result_columns

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    def cell(v):
        try:
            return float(v)
        except ValueError:
            return v

    assert files(dir_a) == files(dir_b)
    for rel in files(dir_a):
        a, b = os.path.join(dir_a, rel), os.path.join(dir_b, rel)
        if rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa)["stats"] == json.load(fb)["stats"], rel
        elif os.path.basename(rel).startswith("SolutionsTable"):
            ca, cb = load_result_columns(a), load_result_columns(b)
            assert list(ca) == list(cb), rel
            for name in ca:
                if name == "sequence" or np.asarray(ca[name]).dtype.kind in "iu":
                    np.testing.assert_array_equal(ca[name], cb[name], err_msg=f"{rel} {name}")
                else:
                    np.testing.assert_allclose(ca[name], cb[name], rtol=RTOL,
                                               err_msg=f"{rel} {name}")
        else:  # the study's aggregate tables
            with open(a, newline="") as fa, open(b, newline="") as fb:
                ra, rb = list(csv.reader(fa)), list(csv.reader(fb))
            assert len(ra) == len(rb) and ra[0] == rb[0], rel
            for x, y in zip(ra[1:], rb[1:]):
                x, y = [cell(v) for v in x], [cell(v) for v in y]
                assert [v for v in x if isinstance(v, str)] == [v for v in y if isinstance(v, str)]
                np.testing.assert_allclose([v for v in x if not isinstance(v, str)],
                                           [v for v in y if not isinstance(v, str)],
                                           rtol=RTOL, err_msg=rel)


def test_unported_paths_raise(tmp_path):
    """Nothing is left unported: plots=True draws each experiment's three
    figures, serial and batched, and batched=True writes the serial run's
    artifact values."""
    from genomeassembler_dev_tpu_torch.pipeline.experiments import run_own_study
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store

    segs = synthetic_segment_store(3, 250, 3)
    base = ExperimentConfig(seq_len=250, coverage_target=12.0, kmer=8, seed=1234,
                            n_orderings=50)
    reports = {name: run_own_study(str(tmp_path / name), segs, "cpu", base=base,
                                   grid=((12, 9), (16, 13)), total_iters=3,
                                   batched=name == "batched", seg_batch=2, plots=True)
               for name in ("serial", "batched")}
    assert reports["batched"].n_experiments == reports["serial"].n_experiments == 6
    figures = {name: sorted(os.path.relpath(p, tmp_path / name) for p in glob.glob(
        str(tmp_path / name / "results" / "exp_*" / "*.png"))) for name in reports}
    assert figures["serial"] == figures["batched"] and len(figures["serial"]) == 6 * 3
    for fig in ("ProbabilityTrack", "BreakpointHistogram", "ScoresVsLevDist"):
        assert sum(os.path.basename(f).startswith(fig + "_") for f in figures["serial"]) == 6
    for name in reports:  # the figures are not artifacts of the serial run
        for f in figures[name]:
            os.remove(tmp_path / name / f)
    assert_same_artifacts(str(tmp_path / "serial"), str(tmp_path / "batched"))


def test_pack_strings_pad_rows():
    mat, lens = evaluate.pack_strings(["ACG", "T"], s_multiple=4, l_multiple=8)
    assert mat.shape == (4, 8) and lens.tolist() == [3, 1, 0, 0]
    assert (mat[1, 1:] == 255).all() and (mat[2:] == 255).all()
    codes, counts, valid = evaluate.pad_reads(torch.ones((3, 5), dtype=torch.uint8),
                                          torch.tensor([2, 1, 4], dtype=torch.int32), 4)
    assert codes.shape == (4, 5) and counts.tolist() == [2, 1, 4, 0]
    assert valid.tolist() == [True, True, True, False]


def test_port_imports_no_jax():
    modules = [
        "genomeassembler_dev_tpu_torch.cli",
        "genomeassembler_dev_tpu_torch.pipeline.assembler",
        "genomeassembler_dev_tpu_torch.pipeline.experiments",
        "genomeassembler_dev_tpu_torch.pipeline.results",
        "genomeassembler_dev_tpu_torch.ops.cuda_build",
        "genomeassembler_dev_tpu_torch.ops.histogram",
        "genomeassembler_dev_tpu_torch.ops.myers",
        "genomeassembler_dev_tpu_torch.ops.prefix_min",
        "genomeassembler_dev_tpu_torch.dbg.assemble",
        "genomeassembler_dev_tpu_torch.dbg.biased",
        "genomeassembler_dev_tpu_torch.pipeline.velvet",
        "genomeassembler_dev_tpu_torch.dbg.graph",
        "genomeassembler_dev_tpu_torch.merge.engine",
        "genomeassembler_dev_tpu_torch.merge.device",
        "genomeassembler_dev_tpu_torch.core.rng",
        "genomeassembler_dev_tpu_torch.spec.reference_semantics",
        "genomeassembler_dev_tpu_torch.pipeline.batch_runner",
        "genomeassembler_dev_tpu_torch.pipeline.evaluate",
        "genomeassembler_dev_tpu_torch.sim.reads_io",
        "genomeassembler_dev_tpu_torch.sim.segments",
        "genomeassembler_dev_tpu_torch.utils.plots",
        "genomeassembler_dev_tpu_torch.utils.profiling",
    ]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
              " or m.split('.')[0] == 'genomeassembler_dev_tpu']\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
