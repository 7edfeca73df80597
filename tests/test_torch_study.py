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


SCORE_COLUMNS = [c for c in RESULT_COLUMNS
                 if c not in ("sequence", "sequence_len", "kmer_breaks", "lev_dist_vs_true")]


def _own_nan():
    cols = result_columns(6, seed=3)
    for name in SCORE_COLUMNS:
        cols[name][0] = np.nan
    cols["stat_test_KS_random"][:] = np.nan
    cols["lev_dist_vs_true"] = cols["lev_dist_vs_true"].astype(np.float32)
    cols["lev_dist_vs_true"][2] = np.nan  # NA in an int column keeps it float64
    return cols


def _rows(cols, n):
    return {name: col[:n] for name, col in cols.items()}


def _long_row():
    cols = _rows(result_columns(2, seed=5), 1)
    cols["sequence"] = [jseg.synthetic_genome(6, 50_000)]
    cols["sequence_len"][:] = 50_000
    return cols


def _velvet():
    cols = result_columns(4, seed=7)
    cols["path_prob_dist_startpos"] = np.array([0, 17, 301, 44], dtype=np.int64)
    cols["contig_frac_len"] = np.full(4, 0.8125)
    return cols


def _int_extremes(dtype):
    cols = result_columns(4, seed=8)
    info = np.iinfo(dtype)
    for name in ("sequence_len", "kmer_breaks", "lev_dist_vs_true"):
        # int64's max would overflow the reader's float64 round trip
        cols[name] = np.array([0, info.min, min(info.max, 2**62 + 1), 12], dtype=dtype)
    return cols


def _float_list():
    cols = result_columns(5, seed=9)
    cols["bp_score_true"] = [0.1, float("nan"), 1e-300, -2.5, 3.0]
    return cols


def _quoted():
    cols = result_columns(4, seed=10)
    cols["sequence"][1] = 'AC,G"T\nA'
    return cols


# tables as the program's callers hand them over, and the corners of csv's
# quoting; the column-at-a-time writer must give csv.writer's bytes on each
RESULT_TABLES = {
    "own": result_columns,
    "own_nan": _own_nan,
    "zero_rows": lambda: _rows(result_columns(), 0),
    "one_row_50kb": _long_row,
    "velvet": _velvet,
    "count_only": lambda: {"prob": np.random.default_rng(1).random(256).astype(np.float32),
                           "count": np.arange(256, dtype=np.int64) * 7},
    "float_list": _float_list,
    "int32": lambda: _int_extremes(np.int32),
    "int64": lambda: _int_extremes(np.int64),
    "bool": lambda: {**result_columns(3, seed=11), "flag": np.array([True, False, True])},
    "quoted_sequence": _quoted,
    "one_column": lambda: {"prob": np.array([0.5, np.nan, 0.25], dtype=np.float32)},
    "one_column_empty": lambda: {"label": ["a", "", "c"]},
    "short_column": lambda: {**result_columns(4), "bp_score_true": np.ones(3, np.float32)},
}


def _save_both(tmp_path, cols):
    """The table saved by the port and by the JAX package; returns both
    paths after holding the tables and the stats byte-equal, and the
    error both raised (a column shorter than the first), if any."""
    stats = {"coverage": 12.3, "nr_of_reads": 99, "genome_seq": "ACGT"}
    timings = {"Evaluating each de novo assembled solution": 0.5}
    paths, errors = [], []
    for side, mod, cfg, result in (("t", tres, ExperimentConfig(**CFG), ExperimentResult),
                                   ("j", jres, JConfig(**CFG), JResult)):
        try:
            mod.save_result(str(tmp_path / side), 2, cfg, result(cols, stats, timings))
            errors.append(None)
        except IndexError as e:
            errors.append(type(e))
        paths.append((mod.solutions_path(str(tmp_path / side), 2, cfg),
                      mod.stats_path(str(tmp_path / side), 2, cfg)))
    (t, t_stats), (j, j_stats) = paths
    assert errors[0] == errors[1]
    assert os.path.relpath(t, tmp_path / "t") == os.path.relpath(j, tmp_path / "j")
    assert filecmp.cmp(t, j, shallow=False)
    if errors[0] is None:
        assert filecmp.cmp(t_stats, j_stats, shallow=False)
    else:  # the table as far as it got, and no stats
        assert not os.path.exists(t_stats) and not os.path.exists(j_stats)
    return t, j, errors[0]


def _load_both(path):
    """Both packages' reading of one file: their columns, or their error."""
    out = []
    for mod in (tres, jres):
        try:
            out.append(mod.load_result_columns(path))
        except (ValueError, IndexError) as e:
            out.append((type(e), str(e)))
    return out


def assert_same_columns(got, want):
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w), name
        if isinstance(w, np.ndarray):
            assert (g.dtype, g.shape) == (w.dtype, w.shape), name
            np.testing.assert_array_equal(g, w, err_msg=name)  # NaN where NaN
        else:
            assert g == w, name


@pytest.mark.parametrize("table", list(RESULT_TABLES))
def test_save_result_byte_equal(tmp_path, table):
    t, j, error = _save_both(tmp_path, RESULT_TABLES[table]())
    if error is not None:
        return
    got, want = _load_both(t)[0], _load_both(j)[1]
    if isinstance(want, tuple):  # a field that is no float: both refuse it
        assert got == want
        return
    assert_same_columns(got, want)
    if table == "own":
        assert list(got) == RESULT_COLUMNS


def _crlf_to_lf(path):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data.replace(b"\r\n", b"\n"))


def _quote_all(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    with open(path, "w", newline="") as f:
        csv.writer(f, quoting=csv.QUOTE_ALL).writerows(rows)


def _row_with(path, change):
    with open(path, newline="") as f:
        lines = f.read().split("\r\n")
    lines[2] = change(lines[2])
    with open(path, "w", newline="") as f:
        f.write("\r\n".join(lines))


READ_TABLES = [t for t in RESULT_TABLES if t != "short_column"]


@pytest.mark.parametrize("table,rewrite", [(t, None) for t in READ_TABLES] + [
    ("own_nan", _crlf_to_lf), ("own_nan", _quote_all),
    ("own", lambda p: _row_with(p, lambda r: r + ",1.5")),
    ("own", lambda p: _row_with(p, lambda r: r.rsplit(",", 1)[0])),
    ("one_column", lambda p: _row_with(p, lambda r: "")),
    ("one_column", lambda p: _row_with(p, lambda r: r + "\n1.0"))],
    ids=READ_TABLES + ["lf_line_ends", "quoted_fields", "long_row", "short_row", "empty_line",
                       "mixed_line_ends"])
def test_load_result_columns_vs_jax(tmp_path, table, rewrite):
    cols = RESULT_TABLES[table]()
    path = jres.save_result(str(tmp_path), 2, JConfig(**CFG), JResult(cols, {}, {}))
    if rewrite is not None:
        rewrite(path)
    got, want = _load_both(path)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert_same_columns(got, want)
    if table == "own_nan":
        assert want["lev_dist_vs_true"].dtype == np.float64
        assert want["kmer_breaks"].dtype == np.int64


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


# --- the studies' aggregation from the fields each save formatted ---------

AGG_BASE = dict(seq_len=300, coverage_target=12.0, kmer=8, seed=1234, n_orderings=50)
FROM_MEMORY, REREAD = "study.tables_from_memory", "study.tables_reread"


@pytest.fixture(scope="module")
def tables_jt():
    """The query table, for the JAX package and for the port on the CPU."""
    from genomeassembler_dev_tpu.core.querytable import load_default_query_table as jload
    from genomeassembler_dev_tpu_torch.core.querytable import QueryTable

    jt = jload()
    return jt, QueryTable.from_numpy(jt.probs, "cpu")


def _study(wd, tables, grid, total_iters, batched=True):
    texp.run_own_study(wd, tseg.synthetic_segment_store(21, 300, total_iters), "cpu",
                       ExperimentConfig(**AGG_BASE), grid=grid, total_iters=total_iters,
                       table=tables[1], batched=batched, seg_batch=2)


def _agg_fresh(wd, tables):
    _study(wd, tables, ((12, 9),), 3)
    return ((12, 9),), 3


def _agg_resumed(wd, tables):
    grid = ((12, 9), (16, 13))
    _study(wd, tables, grid, 2)  # an earlier call: these tables are read back
    _study(wd, tables, grid, 4)
    return grid, 4


def _agg_velvet(wd, tables):
    base = ExperimentConfig(**AGG_BASE).with_(velvet_n_orderings=100)
    segs = tseg.synthetic_segment_store(22, 300, 2)
    texp.run_velvet_study(
        wd, segs, lambda asm, seg, i: [seg[lo : lo + 120] for lo in range(0, 290, 110)],
        "cpu", base, grid=((12, 11),), total_iters=2, table=tables[1])
    return ((12, 11),), 2


def _float_lev_no_nan():
    cols = result_columns(5, seed=13)
    # float in memory, no NaN: the loader reads it as int64, 13.0 as 13
    # and 0.75 as 0
    cols["lev_dist_vs_true"] = np.array([13.0, 0.75, 2.5e6, -3.0, 0.0], np.float32)
    cols["kmer_breaks"] = np.array([1.0, 2.0, 300.0, 4.0, 5.0])
    return cols


def _saved(*tables):
    """Saves `tables` as experiments 1.. of one row, as the study's saves do,
    then aggregates them."""
    def run(wd, _tables):
        base = ExperimentConfig(**AGG_BASE)
        cfg, kept = base.with_(read_len=12, dbg_kmer=9), {}
        for i, make in enumerate(tables, 1):
            texp._save(wd, i, cfg, ExperimentResult(make(), {}, {}), texp.OWN_SUMMARY_KEYS,
                       kept)
        texp._aggregate(wd, base, ((12, 9),), len(tables), texp.OWN_SUMMARY_KEYS, kept)
        return ((12, 9),), len(tables)
    return run


# case: (how the workdir is made, tables aggregated from memory, tables read
# back); a table whose fields cannot be shown to give the read-back's bytes
# (the csv module wrote it, an int beyond 2**53, a list column, an int
# column that the loader reads as float) is read back
AGGREGATE_CASES = {
    "batched_fresh": (_agg_fresh, 3, 0),
    "resumed": (_agg_resumed, 4 + 4, 4),  # the earlier call aggregated its own 4
    "nan_scores": (_saved(_own_nan, result_columns), 2, 0),
    "float_lev_no_nan": (_saved(_float_lev_no_nan, _own_nan), 2, 0),
    "zero_rows": (_saved(lambda: _rows(result_columns(), 0), result_columns), 2, 0),
    "csv_fallback": (_saved(result_columns, _quoted), 1, 1),
    "int64_beyond_2_53": (_saved(lambda: _int_extremes(np.int64), _own_nan), 1, 1),
    "list_column": (_saved(_float_list, result_columns), 1, 1),
    "int_score_column": (_saved(lambda: {**result_columns(4, seed=14),
                                         "bp_score_true": np.arange(4, dtype=np.int32)},
                                result_columns), 1, 1),
    "velvet": (_agg_velvet, 2, 0),
}


def _study_csvs(wd, industry):
    d = os.path.join(wd, f"IndustryModel_{industry}")
    out = []
    for name in ("results_summary.csv", "results_all.csv"):
        with open(os.path.join(d, name), "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("case", list(AGGREGATE_CASES))
def test_aggregate_from_fields_byte_equal(tmp_path, tables_jt, case):
    """Both CSVs of a study aggregated from the kept fields are the bytes of
    the same workdir aggregated from its tables read back, and of the JAX
    package's aggregation over the same tables (csv.writer over the numpy
    scalars of each table read back)."""
    from torch.profiler import ProfilerActivity, profile

    from genomeassembler_dev_tpu_torch.utils import profiling

    make, n_memory, n_reread = AGGREGATE_CASES[case]
    wd = str(tmp_path)
    velvet = case == "velvet"
    keys = texp.VELVET_SUMMARY_KEYS if velvet else texp.OWN_SUMMARY_KEYS
    profiling.collect()
    with profile(activities=[ProfilerActivity.CPU]):
        grid, total_iters = make(wd, tables_jt)
    counters = profiling.collect().counters
    assert (counters.get(FROM_MEMORY, 0), counters.get(REREAD, 0)) == (n_memory, n_reread)
    got = _study_csvs(wd, velvet)

    base = ExperimentConfig(**AGG_BASE).with_(industry_standard=velvet)
    texp._aggregate(wd, base, grid, total_iters, keys, {})
    assert _study_csvs(wd, velvet) == got

    jbase, store = JConfig(**AGG_BASE), jseg.SegmentStore((), ())
    if velvet:
        jexp.run_velvet_study(wd, store, None, jbase, grid, total_iters, tables_jt[0])
    else:
        jexp.run_own_study(wd, store, jbase, grid, total_iters, tables_jt[0], batched=True)
    assert _study_csvs(wd, velvet) == got
    summary, rows = (csv_rows(os.path.join(wd, f"IndustryModel_{velvet}", name))
                     for name in ("results_summary.csv", "results_all.csv"))
    tables = glob.glob(os.path.join(wd, "results", "exp_*", "SolutionsTable*.csv"))
    assert len(summary) == 1 + len(keys) * len(tables)
    assert len(rows) == 1 + sum(len(tres.load_result_columns(t)["sequence_len"]) for t in tables)
