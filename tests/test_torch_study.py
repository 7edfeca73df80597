"""PyTorch port vs the JAX package: segments, FASTA and read artifacts, result
tables, the study statistics, the GC and k-mer-count studies, and the
study-all command end to end. Files written from identical arrays must be
byte-equal; study runs simulate reads with different generators, so there
the names, headers and row structure must be equal."""

import contextlib
import csv
import filecmp
import glob
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu import cli as jcli  # noqa: E402
from genomeassembler_dev_tpu.core import encoding as jenc  # noqa: E402
from genomeassembler_dev_tpu.merge import native as jnative  # noqa: E402
from genomeassembler_dev_tpu.ops import histogram as jhist  # noqa: E402
from genomeassembler_dev_tpu.ops.windows import kmer_window_codes as j_windows  # noqa: E402
from genomeassembler_dev_tpu.pipeline import experiments as jexp  # noqa: E402
from genomeassembler_dev_tpu.pipeline import results as jres  # noqa: E402
from genomeassembler_dev_tpu.pipeline.assembler import ExperimentResult as JResult  # noqa: E402
from genomeassembler_dev_tpu.pipeline.config import ExperimentConfig as JConfig  # noqa: E402
from genomeassembler_dev_tpu.sim import reads_io as jrio  # noqa: E402
from genomeassembler_dev_tpu.sim import segments as jseg  # noqa: E402
from genomeassembler_dev_tpu_torch import cli as tcli  # noqa: E402
from genomeassembler_dev_tpu_torch.core import encoding as tenc  # noqa: E402
from genomeassembler_dev_tpu_torch.merge import native as tnative  # noqa: E402
from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import experiments as texp  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import results as tres  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline.assembler import (  # noqa: E402
    RESULT_COLUMNS, ExperimentResult)
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig  # noqa: E402
from genomeassembler_dev_tpu_torch.sim import reads_io as trio  # noqa: E402
from genomeassembler_dev_tpu_torch.sim import segments as tseg  # noqa: E402

CFG = dict(seq_len=300, read_len=16, dbg_kmer=13, kmer=8, seed=1234)
STUDY_ARGS = ["study-all", "--synthetic", "--seq-len", "300", "--coverage", "12",
              "--n-orderings", "50", "--total-iters", "2", "--grid", "12:9,16:13"]


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("repeats", [False, True])
def test_segment_store_vs_jax(repeats):
    j = jseg.synthetic_segment_store(7, 400, 5, repeats=repeats)
    t = tseg.synthetic_segment_store(7, 400, 5, repeats=repeats)
    assert t.names == j.names and t.seqs == j.seqs
    assert len(t) == 5 and all(len(s) == 400 for s in t.seqs)


def test_sample_segments_vs_jax():
    """Tail picks, duplicates and segments holding N drop out on both sides."""
    genome = {"chr1": jseg.synthetic_genome(3, 900),
              "chr2": "ACGT" * 50 + "N" * 30 + jseg.synthetic_genome(4, 400)}
    j = jseg.sample_segments(genome, 120, 40, seed=9)
    t = tseg.sample_segments(genome, 120, 40, seed=9)
    assert (t.names, t.seqs) == (j.names, j.seqs)
    assert 0 < len(t) < 40


def test_fasta_round_trip(tmp_path):
    store = tseg.synthetic_segment_store(11, 250, 3)
    tp, jp = str(tmp_path / "port.fa"), str(tmp_path / "jax.fa")
    store.save(tp)
    jseg.SegmentStore(names=store.names, seqs=store.seqs).save(jp)
    assert filecmp.cmp(tp, jp, shallow=False)
    assert tseg.SegmentStore.load(tp) == store
    assert tseg.read_fasta(tp) == jseg.read_fasta(tp) == dict(zip(store.names, store.seqs))


def test_reverse_complement_vs_jax():
    codes = np.random.default_rng(2).integers(0, 4, 37).astype(np.uint8)
    np.testing.assert_array_equal(tenc.reverse_complement(codes),
                                  jenc.reverse_complement(codes))
    assert tenc.decode_dna(tenc.reverse_complement(tenc.encode_dna("AACGT"))) == "ACGTT"


@pytest.mark.parametrize("k", [2, 8])
def test_count_kmers_native_vs_jax_and_histogram(k):
    rng = np.random.default_rng(k)
    reads = ["".join(rng.choice(list("ACGT"), 20)) for _ in range(60)]
    reads[3] = reads[3][:9] + "N" + reads[3][10:]  # windows over N are skipped
    got = tnative.count_kmers_native(reads, k)
    np.testing.assert_array_equal(got, jnative.count_kmers_native(reads, k))
    codes = np.stack([jenc.encode_dna(r) for r in reads])
    kc, kv = j_windows(jnp.asarray(codes), k)
    np.testing.assert_array_equal(got, np.asarray(jhist.count_kmers(kc, kv, 4**k)))
    tc, tv = (torch.tensor(np.asarray(a)) for a in (kc, kv))
    np.testing.assert_array_equal(got, count_kmers(tc, tv, 4**k).numpy())


def test_read_artifacts_byte_equal(tmp_path):
    rng = np.random.default_rng(4)
    segment = jseg.synthetic_genome(8, 200)
    positions = rng.integers(0, 190, 30).astype(np.int32)
    codes = np.stack([jenc.encode_dna(segment[p : p + 16]) for p in np.minimum(positions, 184)])
    valid = positions <= 184
    paths = []
    for side, rio, cfg in (("t", trio, ExperimentConfig(**CFG)), ("j", jrio, JConfig(**CFG))):
        paths.append(rio.save_read_fastas(str(tmp_path / side), 3, cfg, codes, valid,
                                          positions, segment, "chrS_1201"))
    for tp, jp in zip(*paths):
        assert os.path.basename(tp) == os.path.basename(jp)
        assert filecmp.cmp(tp, jp, shallow=False), tp
    npz = str(tmp_path / "reads.npz")
    trio.save_read_set_npz(npz, codes, valid, positions)
    for a, b in zip(jrio.load_read_set_npz(npz), (codes, valid, positions)):
        np.testing.assert_array_equal(a, b)


def result_columns(n=5, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"sequence": ["".join(rng.choice(list("ACGT"), 12)) for _ in range(n)]}
    for name in RESULT_COLUMNS[1:]:
        if name in ("sequence_len", "kmer_breaks", "lev_dist_vs_true"):
            cols[name] = rng.integers(0, 400, n).astype(np.int32)
        else:
            cols[name] = rng.random(n).astype(np.float32)
    cols["stat_test_KS_true"][1] = np.nan
    return cols


def test_save_result_byte_equal(tmp_path):
    cols = result_columns()
    stats = {"coverage": 12.3, "nr_of_reads": 99, "genome_seq": "ACGT"}
    timings = {"Evaluating each de novo assembled solution": 0.5}
    t = tres.save_result(str(tmp_path / "t"), 2, ExperimentConfig(**CFG),
                         ExperimentResult(cols, stats, timings))
    j = jres.save_result(str(tmp_path / "j"), 2, JConfig(**CFG), JResult(cols, stats, timings))
    assert os.path.relpath(t, tmp_path / "t") == os.path.relpath(j, tmp_path / "j")
    assert filecmp.cmp(t, j, shallow=False)
    assert filecmp.cmp(tres.stats_path(str(tmp_path / "t"), 2, ExperimentConfig(**CFG)),
                       jres.stats_path(str(tmp_path / "j"), 2, JConfig(**CFG)), shallow=False)
    got, want = tres.load_result_columns(t), jres.load_result_columns(j)
    assert list(got) == list(want) == RESULT_COLUMNS
    for name in RESULT_COLUMNS:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))


def test_result_schema_check():
    cols = result_columns()
    shuffled = dict(reversed(list(cols.items())))
    assert tres._canonical_names(shuffled) == jres._canonical_names(shuffled) == RESULT_COLUMNS
    velvet = {**cols, "path_prob_dist_startpos": cols["bp_score_true"]}
    assert tres._canonical_names(velvet) == jres._canonical_names(velvet)
    assert tres._canonical_names({"prob": 1, "count": 2}) == ["prob", "count"]
    del cols["kmer_breaks"]
    for mod in (tres, jres):
        with pytest.raises(ValueError, match="missing canonical columns"):
            mod._canonical_names(cols)


def test_statistics_vs_jax(tmp_path):
    rng = np.random.default_rng(12)
    path = str(tmp_path / "results_all.csv")
    head = ["read_len", "dbg_kmer", "experiment", "sequence_len", "kmer_breaks",
            "bp_score_norm_by_break_freqs_true", "bp_score_norm_by_len_true",
            "bp_score_true", "bp_score_random", "lev_dist_vs_true", "stat_test_KS_true"]
    rows = []
    for read_len, dbg in ((12, 9), (16, 13)):
        for _ in range(60):
            rows.append([read_len, dbg, 1, int(rng.integers(200, 400)),
                         int(rng.integers(0, 500))] + list(rng.random(4))
                        + [int(rng.integers(0, 80)), rng.random()])
    rows[5][6] = ""  # a missing value
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows([head] + rows)
    assert (json.dumps(texp.study_statistics(path), sort_keys=True)
            == json.dumps(jexp.study_statistics(path), sort_keys=True))
    v = rng.random(101)
    v[7] = np.nan
    lev = rng.integers(0, 50, 101)
    assert (json.dumps(texp.top_fraction_contrast(v, 0.05, {"lev": lev}), sort_keys=True)
            == json.dumps(jexp.top_fraction_contrast(v, 0.05, {"lev": lev}), sort_keys=True))


def test_gc_study_vs_jax(tmp_path):
    segs = tseg.synthetic_segment_store(5, 300, 3)
    cfg = ExperimentConfig(**CFG)
    for i in (1, 3):  # experiment 2 is missing: both skip it
        tres.save_result(str(tmp_path), i, cfg,
                         ExperimentResult(result_columns(seed=i), {}, {}))
    t = texp.run_gc_study(str(tmp_path), segs, cfg, 3)
    os.replace(t, str(tmp_path / "port.csv"))
    j = jexp.run_gc_study(str(tmp_path), jseg.SegmentStore(segs.names, segs.seqs),
                          JConfig(**CFG), 3)
    assert filecmp.cmp(str(tmp_path / "port.csv"), j, shallow=False)
    assert len(csv_rows(j)) == 3


def test_r_squared_as_the_jax_study(tmp_path):
    """The R^2 of JAX's k-mer-count study, recomputed by the port's function
    from the counts and probabilities the study wrote, is bit-equal."""
    seg = jseg.synthetic_genome(5, 250)
    base = JConfig(seq_len=250, read_len=20, coverage_target=12.0, seed=1234,
                   n_orderings=50)
    r2 = jexp.run_kmer_count_study(str(tmp_path), seg, base=base, ks=(2, 4))
    rows = csv_rows(str(tmp_path / "kmer_count_vs_prob.csv"))[1:]
    for k in (2, 4):
        prob = np.array([float(r[2]) for r in rows if r[0] == str(k)])
        count = np.array([float(r[3]) for r in rows if r[0] == str(k)])
        assert texp.count_prob_r_squared(prob, count) == r2[k]


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """study-all through both command lines, at a small size, in two
    workdirs; returns ((workdir, printed JSON) of the port, of JAX)."""
    out = []
    for name, main, device in (("port", tcli.main, ["--device", "cpu"]),
                               ("jax", jcli.main, ["--platform", "cpu"])):
        wd = str(tmp_path_factory.mktemp(name))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(STUDY_ARGS + ["--workdir", wd] + device)
        out.append((wd, json.loads(buf.getvalue())))
    return out


def test_study_all_files_and_json(studies):
    (twd, tout), (jwd, jout) = studies
    assert files_under(twd) == files_under(jwd)
    assert len(files_under(os.path.join(twd, "results"))) == 2 * 2 * 2
    assert tout.keys() == jout.keys()
    assert tout["own"]["ran"] == jout["own"]["ran"] == 4
    assert tout["kmer_count_r_squared"].keys() == jout["kmer_count_r_squared"].keys()
    assert all(np.isfinite(v) for v in tout["kmer_count_r_squared"].values())


def test_study_all_tables(studies):
    (twd, _), (jwd, _) = studies
    out = os.path.join("IndustryModel_False")
    t = csv_rows(os.path.join(twd, out, "results_summary.csv"))
    j = csv_rows(os.path.join(jwd, out, "results_summary.csv"))
    assert [r[:3] + r[4:] for r in t] == [r[:3] + r[4:] for r in j]
    t = csv_rows(os.path.join(twd, out, "results_all.csv"))
    j = csv_rows(os.path.join(jwd, out, "results_all.csv"))
    assert t[0] == j[0]
    groups = [list(dict.fromkeys(tuple(r[:3]) for r in rows[1:])) for rows in (t, j)]
    assert groups[0] == groups[1] and len(groups[0]) == 4
    t = csv_rows(os.path.join(twd, "gc_dependency.csv"))
    j = csv_rows(os.path.join(jwd, "gc_dependency.csv"))
    assert [r[:2] for r in t] == [r[:2] for r in j] and len(t) == 3
    t = csv_rows(os.path.join(twd, "kmer_count_vs_prob.csv"))
    j = csv_rows(os.path.join(jwd, "kmer_count_vs_prob.csv"))
    assert [r[:3] for r in t] == [r[:3] for r in j]  # k, code, prob
    assert len(t) == 1 + 16 + 256 + 4096 + 65536


def test_study_own_resumes(studies, capsys):
    (twd, _), _ = studies
    tcli.main(["study-own"] + STUDY_ARGS[1:] + ["--workdir", twd, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert (out["ran"], out["skipped"]) == (0, 4)


def test_cli_run_and_refusals(tmp_path, capsys):
    args = ["--workdir", str(tmp_path), "--seq-len", "250", "--coverage", "12",
            "--n-orderings", "50", "--total-iters", "2"]
    tcli.main(["run", "--device", "cpu"] + args)
    out = json.loads(capsys.readouterr().out)
    assert out["solutions"] > 0 and os.path.exists(out["csv"])
    assert set(out["stats"]) == {"base_composition", "coverage", "nr_of_reads"}
    # --plots draws three figures an experiment beside its artifacts
    tcli.main(["study-own", "--device", "cpu", "--plots", "--grid", "12:9,16:13"] + args
              + ["--workdir", str(tmp_path / "plots")])
    assert json.loads(capsys.readouterr().out)["ran"] == 4
    for ind in (1, 2):
        figures = sorted(os.path.basename(p).split("_SeqLen")[0] for p in glob.glob(
            str(tmp_path / "plots" / "results" / f"exp_{ind}" / "*.png")))
        assert figures == sorted(["BreakpointHistogram", "ProbabilityTrack",
                                  "ScoresVsLevDist"] * 2)
    # --batched --seg-batch reach the batched runner and write the serial
    # run's values (the last batch of two filled up with its first segment)
    for name, extra in (("serial", []), ("batched", ["--batched", "--seg-batch", "2"])):
        tcli.main(["study-own", "--device", "cpu", "--grid", "12:9,40:15", "--seq-len", "250",
                   "--coverage", "12", "--n-orderings", "50", "--total-iters", "3",
                   "--workdir", str(tmp_path / name)] + extra)
        assert json.loads(capsys.readouterr().out)["ran"] == 6
    tables = sorted(os.path.relpath(p, tmp_path / "serial") for p in glob.glob(
        str(tmp_path / "serial" / "results" / "exp_*" / "SolutionsTable*.csv")))
    assert len(tables) == 6
    for rel in tables:
        ca, cb = (tres.load_result_columns(str(tmp_path / name / rel))
                  for name in ("serial", "batched"))
        assert ca["sequence"] == cb["sequence"], rel
        for col in RESULT_COLUMNS[1:]:
            np.testing.assert_allclose(ca[col], cb[col], rtol=2e-5, err_msg=f"{rel} {col}")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main(["study-own"] + args)
