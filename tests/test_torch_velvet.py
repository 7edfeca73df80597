"""PyTorch port vs the JAX package: the velvet (industry-standard) path —
covered_fraction, IndustryAssembler.run_external on replayed read sets, the
golden fixture velvet_k15_rl12, the study-velvet command, the result-CSV
round trip of the velvet columns and the velveth/velvetg adapter. Integers
are compared exactly, floats at rtol 2e-5."""

import contextlib
import csv
import filecmp
import io
import json
import os
import stat
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from genomeassembler_dev_tpu import cli as jcli  # noqa: E402
from genomeassembler_dev_tpu.core.encoding import encode_dna, kmer_codes_np  # noqa: E402
from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.pipeline import results as jres_io  # noqa: E402
from genomeassembler_dev_tpu.pipeline import velvet as jvel  # noqa: E402
from genomeassembler_dev_tpu.pipeline.config import ExperimentConfig as JConfig  # noqa: E402
from genomeassembler_dev_tpu.sim.reads import generate_reads  # noqa: E402
from genomeassembler_dev_tpu.sim.segments import plant_repeats, synthetic_genome  # noqa: E402
from genomeassembler_dev_tpu.spec import reference_semantics as spec  # noqa: E402
from genomeassembler_dev_tpu_torch import cli as tcli  # noqa: E402
from genomeassembler_dev_tpu_torch.core.querytable import TOTAL, QueryTable  # noqa: E402
from genomeassembler_dev_tpu_torch.merge.engine import assemble_solutions  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import evaluate  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import results as tres_io  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import velvet as tvel  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig  # noqa: E402
from genomeassembler_dev_tpu_torch.sim.segments import (  # noqa: E402
    synthetic_segment_store, write_fasta)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "golden", "fixtures", "velvet_k15_rl12.json")
RTOL = 2e-5
INT_COLUMNS = ("sequence_len", "kmer_breaks", "lev_dist_vs_true", "path_prob_dist_startpos")


@pytest.fixture(scope="module")
def jtable():
    return load_default_query_table()


@pytest.fixture(scope="module")
def ttable(jtable):
    return QueryTable.from_numpy(jtable.probs, "cpu")


def tiles(seq, piece, overlap):
    """Velvet-shaped contigs: tiles of `piece` bases overlapping by
    `overlap` (tools/make_external_contigs.py)."""
    return [seq[lo : lo + piece] for lo in range(0, len(seq) - overlap, piece - overlap)]


@pytest.mark.parametrize("startpos,lens,seq_len", [
    ([0], [1000], 1000), ([1], [499], 1000), ([0, 200], [300, 300], 1000),
    ([0], [500], 1000), ([], [], 1000), ([5, 700, 300, 20], [50, 400, 10, 30], 1000),
    ([990], [50], 1000)])
def test_covered_fraction_vs_jax(startpos, lens, seq_len):
    """The cases of tests/test_velvet_path.py:25-41, disjoint and
    overhanging ranges; equal to the float."""
    args = (np.array(startpos, np.int64), np.array(lens, np.int64), seq_len)
    assert tvel.covered_fraction(*args) == jvel.covered_fraction(*args)


def test_covered_fraction_endpoints():
    assert tvel.covered_fraction(np.array([0]), np.array([1000]), 1000) == 100.0
    assert abs(tvel.covered_fraction(np.array([1]), np.array([499]), 1000) - 50.0) < 0.1
    assert tvel.covered_fraction(np.array([]), np.array([]), 1000) == 0.0


def run_both(jtable, ttable, segment, contigs, read_len, coverage, **cfg_kw):
    """One JAX-simulated read set through JAX's and the port's run_external;
    JAX's `simulate` is replaced on its instance by the replay."""
    rs = generate_reads(jax.random.key(1234), encode_dna(segment), jtable, read_len, coverage)
    read_set = tuple(np.asarray(a) for a in (rs.codes, rs.valid, rs.positions))
    kw = dict(seq_len=len(segment), read_len=read_len, coverage_target=coverage, kmer=8,
              seed=1234, industry_standard=True, **cfg_kw)
    jas = jvel.IndustryAssembler(JConfig(**kw), jtable)
    jas.simulate = lambda genome_codes, timer: jas._replay_read_set(genome_codes, read_set)
    jres = jas.run_external(segment, contigs)
    tas = tvel.IndustryAssembler(ExperimentConfig(**kw), "cpu", ttable)
    return jres, tas.run_external(segment, contigs, read_set=read_set)


def exact_ks(solution, segment, probs8):
    """The KS statistic of the solution's octamer profile vs the segment's
    octamer track, by the spec's float64 ECDFs."""
    p = np.asarray(probs8, np.float32)
    return spec.ks_2samp(p[kmer_codes_np(encode_dna(solution), 8)],
                         p[kmer_codes_np(encode_dna(segment), 8)])


def assert_same_tables(jres, tres, segment, probs8):
    assert list(tres.columns) == tvel.VELVET_RESULT_COLUMNS == jvel.VELVET_RESULT_COLUMNS
    assert sorted(tres.columns["sequence"]) == sorted(jres.columns["sequence"])
    # rows tied on bp_score may order differently: align by sequence
    jrow = {s: i for i, s in enumerate(jres.columns["sequence"])}
    idx = [jrow[s] for s in tres.columns["sequence"]]
    for name in tvel.VELVET_RESULT_COLUMNS[1:]:
        got = np.asarray(tres.columns[name])
        want = np.asarray(jres.columns[name])[idx]
        if name in INT_COLUMNS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name.startswith("stat_test_KS"):
            # the port sums the ECDF steps in float64 and equals the exact
            # statistic; JAX sums them in float32, which leaves up to one
            # float32 step at 1.0 (2^-23) where the exact statistic is 0
            exact = [exact_ks(s, segment, probs8) for s in tres.columns["sequence"]]
            np.testing.assert_allclose(got, exact, rtol=RTOL, err_msg=name)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=2.0**-23, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    assert (np.diff(tres.columns["bp_score_true"]) <= 0).all()
    assert tres.stats == jres.stats
    assert list(tres.timings) == [
        "Merging shuffled contig orderings (velvet path)",
        "Evaluating each de novo assembled solution"]


def case_pieces():
    """True pieces plus a junk contig (tests/test_velvet_path.py:72-99)."""
    g = synthetic_genome(10, 300)
    return g, [g[0:120], g[110:230], g[220:300], "ACGT" * 10], 12, 12.0, 9, 200


def case_k37():
    """The k 37 row: two contigs with a 36-base overlap merge to the truth
    (tests/test_velvet_path.py:125-142)."""
    g = synthetic_genome(11, 400)
    return g, [g[0:200], g[164:400]], 40, 10.0, 37, 100


def case_repeats():
    """Velvet-contract tiles of a segment with planted repeats, and a tile
    with a substitution: several solutions, some absent from the segment."""
    g = plant_repeats(synthetic_genome(12, 600), np.random.default_rng(12), n_events=3,
                      motif_len=(20, 40))
    ts = tiles(g, 150, 12)
    bad = ts[1][:60] + ("A" if ts[1][60] != "A" else "C") + ts[1][61:]
    return g, ts + [bad], 16, 20.0, 13, 500


@pytest.mark.parametrize("case", [case_pieces, case_k37, case_repeats])
def test_run_external_vs_jax(jtable, ttable, case):
    segment, contigs, read_len, coverage, dbg_kmer, n_ord = case()
    jres, tres = run_both(jtable, ttable, segment, contigs, read_len, coverage,
                          dbg_kmer=dbg_kmer, velvet_n_orderings=n_ord)
    assert tres.n_solutions >= 1
    assert_same_tables(jres, tres, segment, jtable.probs[8])
    for s, sp in zip(tres.columns["sequence"], tres.columns["path_prob_dist_startpos"]):
        assert segment.find(s) == sp != -1


def test_run_external_default_orderings(jtable, ttable):
    """Velvet-contract tiles at the default 20,000 orderings reconstruct the
    segment: one solution, startpos 0, HW distance 0, 100% covered."""
    segment = synthetic_genome(13, 1000)
    jres, tres = run_both(jtable, ttable, segment, tiles(segment, 300, 10), 12, 15.0,
                          dbg_kmer=11)
    assert_same_tables(jres, tres, segment, jtable.probs[8])
    cols = tres.columns
    assert cols["sequence"] == [segment]
    assert cols["path_prob_dist_startpos"].tolist() == [0]
    assert cols["lev_dist_vs_true"].tolist() == [0]
    assert cols["contig_frac_len"].tolist() == [100.0]


def test_chunked_evaluation_equals_one_chunk(ttable, monkeypatch):
    """100 solutions evaluated in chunks of 64 rows (the last chunk filled
    with length-0 rows) give the scores of one 128-row evaluation."""
    rng = np.random.default_rng(5)
    segment = synthetic_genome(14, 400)
    sols = [segment[a : a + int(n)] for a, n in zip(rng.integers(0, 300, 100),
                                                      rng.integers(20, 100, 100))]
    cfg = ExperimentConfig(seq_len=400, read_len=12, coverage_target=10.0, dbg_kmer=11,
                           industry_standard=True)
    asm = tvel.IndustryAssembler(cfg, "cpu", ttable)
    genome = torch.from_numpy(encode_dna(segment))
    rs = asm.simulate(genome, tvel.StageTimer("cpu", verbose=False))
    whole = asm.evaluate(sols, rs, genome)
    assert evaluate.eval_chunk_rows(128, rs.codes.shape[0], rs.track.shape[0]) > 100
    row_bytes = 64 * (128 + 512 + rs.track.shape[0]) + 16 * TOTAL
    monkeypatch.setattr(evaluate, "EVAL_BUDGET_BYTES", 64 * row_bytes)
    assert evaluate.eval_chunk_rows(128, 512, rs.track.shape[0]) == 64
    chunked = asm.evaluate(sols, rs, genome)
    assert whole.keys() == chunked.keys()
    for name in whole:
        assert whole[name].shape == (100,)
        np.testing.assert_array_equal(chunked[name], whole[name], err_msg=name)


def test_golden_velvet_k15_rl12(ttable):
    """The original C++ on recorded reads: the native merge at 20,000
    orderings gives its solutions, and the port's scoring of its sequences
    gives its scores, breaks, HW distances, probability profiles and
    startpos (tests/test_golden.py:151-190)."""
    with open(FIXTURE) as f:
        fx = json.load(f)
    c, ref = fx["config"], fx["reference"]
    sols = assemble_solutions(fx["external_contigs"], c["dbg_kmer"], c["seed"], 20000)
    assert sorted(sols) == sorted(ref["solutions"])

    cfg = ExperimentConfig(seq_len=c["seq_len"], read_len=c["read_len"],
                           dbg_kmer=c["dbg_kmer"], kmer=c["break_kmer"], seed=c["seed"],
                           industry_standard=True)
    asm = tvel.IndustryAssembler(cfg, "cpu", ttable)
    codes = np.stack([encode_dna(r) for r in fx["reads"]])
    read_set = (codes, np.ones(len(codes), bool), np.zeros(len(codes), np.int32))
    genome = torch.from_numpy(encode_dna(fx["segment"]))
    rs = asm._replay_read_set(genome, read_set)
    paths = ref["sequence"]
    ev = asm.evaluate(paths, rs, genome)
    np.testing.assert_allclose(ev["bp_score"], ref["bp_score"], rtol=RTOL)
    np.testing.assert_allclose(ev["bp_nb"], ref["bp_score_norm_by_break_freqs"], rtol=RTOL)
    np.testing.assert_allclose(ev["bp_nl"], ref["bp_score_norm_by_len"], rtol=RTOL)
    np.testing.assert_array_equal(ev["kmer_breaks"], ref["kmer_breaks"])
    np.testing.assert_array_equal(ev["lev"], ref["lev_dist_vs_true"])
    pmat, plens = evaluate.pack_strings(paths)
    prof, valid = evaluate.path_prob_profile(torch.from_numpy(pmat), torch.from_numpy(plens),
                                         ttable.probs[8])
    for i, want in enumerate(ref["path_prob_dist"]):
        got = prof[i][valid[i]].numpy()
        assert got.shape == (len(paths[i]) - 7,)
        np.testing.assert_allclose(got, want, rtol=RTOL)

    res = asm.run_external(fx["segment"], fx["external_contigs"], read_set=read_set)
    startpos = np.asarray(ref["path_prob_dist_startpos"])
    defined = {p: sp for p, sp, b in zip(paths, startpos, ref["kmer_breaks"]) if b > 0}
    kept = [p for p in paths if fx["segment"].find(p) != -1]
    assert res.columns["sequence"] == kept and len(kept) >= 1
    for s, sp in zip(res.columns["sequence"], res.columns["path_prob_dist_startpos"]):
        assert sp == defined[s]


def test_result_csv_round_trip(jtable, ttable, tmp_path):
    """save_result keeps the velvet path's own columns, path_prob_dist_startpos
    included, and writes the bytes JAX's save_result writes for the same
    columns."""
    segment, contigs, read_len, coverage, dbg_kmer, n_ord = case_repeats()
    _, tres = run_both(jtable, ttable, segment, contigs, read_len, coverage,
                       dbg_kmer=dbg_kmer, velvet_n_orderings=n_ord)
    kw = dict(seq_len=len(segment), read_len=read_len, dbg_kmer=dbg_kmer,
              industry_standard=True)
    t = tres_io.save_result(str(tmp_path / "t"), 1, ExperimentConfig(**kw), tres)
    j = jres_io.save_result(str(tmp_path / "j"), 1, JConfig(**kw), jvel.ExperimentResult(
        tres.columns, tres.stats, tres.timings))
    assert filecmp.cmp(t, j, shallow=False)
    back = tres_io.load_result_columns(t)
    assert list(back) == tvel.VELVET_RESULT_COLUMNS
    assert back["sequence"] == tres.columns["sequence"]
    for name in tvel.VELVET_RESULT_COLUMNS[1:]:
        np.testing.assert_array_equal(np.asarray(back[name], np.float64),
                                      np.asarray(tres.columns[name], np.float64), err_msg=name)


def fake_velvet(bin_dir, monkeypatch):
    """Stub velveth/velvetg executables: each records its argv, velvetg
    writes a canned multi-line contigs.fa (tests/test_velvet_path.py:155-205)."""
    bin_dir.mkdir()
    (bin_dir / "velveth").write_text(textwrap.dedent("""\
        #!/bin/sh
        echo "$@" > "$1/velveth_args.txt"
    """))
    (bin_dir / "velvetg").write_text(textwrap.dedent("""\
        #!/bin/sh
        echo "$@" > "$1/velvetg_args.txt"
        cat > "$1/contigs.fa" <<'EOF'
        >NODE_1_length_24_cov_3.0
        ACGTACGTACGT
        ACGTACGTACGT
        >NODE_2_length_8_cov_2.0
        GGGGCCCC
        EOF
    """))
    for name in ("velveth", "velvetg"):
        p = bin_dir / name
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")


def test_velvet_adapter_fake_binaries(tmp_path, ttable, monkeypatch):
    fake_velvet(tmp_path / "bin", monkeypatch)
    cfg = ExperimentConfig(seq_len=200, read_len=16, dbg_kmer=13, industry_standard=True)
    asm = tvel.IndustryAssembler(cfg, "cpu", ttable)
    assert tvel.IndustryAssembler.velvet_available()
    r1, r2 = str(tmp_path / "read_1.fa"), str(tmp_path / "read_2.fa")
    out_dir = str(tmp_path / "velvet_out")
    assert asm.run_velvet(r1, r2, out_dir) == ["ACGTACGTACGTACGTACGTACGT", "GGGGCCCC"]
    h_args = (tmp_path / "velvet_out" / "velveth_args.txt").read_text().split()
    assert h_args == [out_dir, "13", "-shortPaired", "-fasta", "-separate", r1, r2]
    g_args = (tmp_path / "velvet_out" / "velvetg_args.txt").read_text().split()
    assert g_args == [out_dir, "-exp_cov", "auto", "-cov_cutoff", "auto",
                      "-scaffolding", "yes"]


def test_cli_velvet_binaries_or_stop(tmp_path, monkeypatch, capsys):
    """Without --contigs-dir the command runs the velvet binaries on reads
    simulated at each row's read length, and stops when there are none."""
    args = ["study-velvet", "--device", "cpu", "--workdir", str(tmp_path / "wd"),
            "--synthetic", "--seq-len", "200", "--coverage", "5", "--total-iters", "1",
            "--grid", "14:13"]
    path = os.environ["PATH"]
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(SystemExit, match="contigs-dir"):
        tcli.main(args)
    monkeypatch.setenv("PATH", path)
    fake_velvet(tmp_path / "bin", monkeypatch)
    tcli.main(args)
    out = json.loads(capsys.readouterr().out)
    assert out["ran"] == 1
    reads = os.path.join(tmp_path, "wd", "reads", "exp_1")
    (read1,) = [f for f in os.listdir(reads) if f.startswith("read_1")]
    with open(os.path.join(reads, read1)) as f:
        seqs = [line.strip() for line in f if not line.startswith(">")]
    assert seqs and all(len(s) == 14 for s in seqs)
    assert os.path.exists(os.path.join(tmp_path, "wd", "velvet", "exp_1", "velveth_args.txt"))


@pytest.fixture(scope="module")
def velvet_studies(tmp_path_factory):
    """study-velvet through both command lines on the same contigs
    directories (velvet-contract tiles per row), one workdir each; returns
    ((workdir, printed JSON) of the port, of JAX), the grid and the store."""
    seq_len, iters, grid = 600, 2, ((12, 11), (40, 37))
    store = synthetic_segment_store(1234, seq_len, iters)
    root = tmp_path_factory.mktemp("velvet")
    out = []
    for name, main, device in (("port", tcli.main, ["--device", "cpu"]),
                               ("jax", jcli.main, ["--platform", "cpu"])):
        wd = str(root / name)
        printed = []
        for read_len, k in grid:
            cdir = str(root / f"contigs_k{k}")
            for i, seg in enumerate(store.seqs, start=1):
                write_fasta(os.path.join(cdir, f"contigs_exp_{i}.fa"),
                            {f"NODE_{j}": t for j, t in enumerate(tiles(seg, 200, k - 1), 1)})
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(["study-velvet", "--synthetic", "--seq-len", str(seq_len),
                      "--coverage", "10", "--total-iters", str(iters),
                      "--grid", f"{read_len}:{k}", "--contigs-dir", cdir,
                      "--workdir", wd] + device)
            printed.append(json.loads(buf.getvalue()))
        out.append((wd, printed))
    return out, grid, store


def csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_study_velvet_artifacts(velvet_studies):
    ((twd, tout), (jwd, jout)), grid, store = velvet_studies
    files = sorted(os.path.relpath(os.path.join(d, f), twd)
                   for d, _, fs in os.walk(twd) for f in fs)
    jfiles = sorted(os.path.relpath(os.path.join(d, f), jwd)
                    for d, _, fs in os.walk(jwd) for f in fs)
    assert files == jfiles
    assert len([f for f in files if f.startswith("results")]) == 2 * 2 * len(grid)
    assert [o["ran"] for o in tout] == [o["ran"] for o in jout] == [2, 2]
    n_rows = 0
    for read_len, k in grid:
        cfg = ExperimentConfig(seq_len=600, read_len=read_len, dbg_kmer=k, kmer=8,
                               seed=1234, industry_standard=True)
        for i, seg in enumerate(store.seqs, start=1):
            path = tres_io.solutions_path(twd, i, cfg)
            assert csv_rows(path)[0] == tvel.VELVET_RESULT_COLUMNS
            cols = tres_io.load_result_columns(path)
            assert cols["sequence"] == [seg]
            assert cols["lev_dist_vs_true"].tolist() == [0]
            assert cols["contig_frac_len"].tolist() == [100.0]
            n_rows += 1
    # the last call aggregates only its own row, as the JAX command does
    out_dir = os.path.join(twd, "IndustryModel_True")
    t_all = csv_rows(os.path.join(out_dir, "results_all.csv"))
    j_all = csv_rows(os.path.join(jwd, "IndustryModel_True", "results_all.csv"))
    assert t_all[0] == j_all[0]
    assert len(t_all) - 1 == n_rows // len(grid) == len(j_all) - 1
    t_sum = csv_rows(os.path.join(out_dir, "results_summary.csv"))
    j_sum = csv_rows(os.path.join(jwd, "IndustryModel_True", "results_summary.csv"))
    assert [r[:3] + r[4:] for r in t_sum] == [r[:3] + r[4:] for r in j_sum]
    assert len(t_sum) == 1 + 4 * len(store.seqs)
