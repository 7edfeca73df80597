"""PyTorch port vs the JAX package: the diagnostics plots. The port's
utils/plots.py draws the same figures from the same host arrays (PNGs that
decode to equal pixels), study_plots forms the same groups and Welch
p-values from a study's CSVs, and `--plots` on run, study-own and study-all
writes each experiment's three figures from its own track and reads."""

import contextlib
import glob
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("matplotlib")
pytest.importorskip("scipy")

import jax.numpy as jnp  # noqa: E402
from matplotlib.image import imread  # noqa: E402

from genomeassembler_dev_tpu import cli as jcli  # noqa: E402
from genomeassembler_dev_tpu.core.encoding import encode_dna  # noqa: E402
from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.pipeline import experiments as jexp  # noqa: E402
from genomeassembler_dev_tpu.pipeline.config import ExperimentConfig as JConfig  # noqa: E402
from genomeassembler_dev_tpu.sim import segments as jseg  # noqa: E402
from genomeassembler_dev_tpu.sim.reads import probability_track as j_track  # noqa: E402
from genomeassembler_dev_tpu.utils import plots as jplots  # noqa: E402
from genomeassembler_dev_tpu_torch import cli as tcli  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import assembler as tasm  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import batch_runner  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import experiments as texp  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig  # noqa: E402
from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store  # noqa: E402
from genomeassembler_dev_tpu_torch.utils import plots as tplots  # noqa: E402

RTOL = 2e-5
SMALL = dict(seq_len=300, read_len=12, dbg_kmer=9, kmer=8, coverage_target=12.0,
             seed=1234, n_orderings=50)
CLI_ARGS = ["--device", "cpu", "--synthetic", "--seq-len", "300", "--coverage", "12",
            "--n-orderings", "50", "--total-iters", "2"]
FIGURES = ("ProbabilityTrack", "BreakpointHistogram", "ScoresVsLevDist")


def same_pixels(a: str, b: str) -> bool:
    x, y = imread(a), imread(b)
    return x.shape == y.shape and np.array_equal(x, y)


def plot_arrays():
    """A track, breakpoint positions and a results table, made from seeds."""
    rng = np.random.default_rng(3)
    track = rng.random(993).astype(np.float32) * 1e-4
    positions = rng.integers(0, 988, 3334).astype(np.int32)
    n = 40
    columns = {
        "lev_dist_vs_true": rng.integers(0, 300, n).astype(np.int32),
        "bp_score_true": rng.random(n),
        "bp_score_norm_by_len_true": rng.random(n) * 1e-3,
        "bp_score_norm_by_break_freqs_true": rng.random(n),
    }
    columns["bp_score_true"][[3, 17]] = np.nan
    return track, positions, columns


@pytest.mark.parametrize("figure", FIGURES)
def test_experiment_figures_pixel_equal_to_jax(figure, tmp_path):
    track, positions, columns = plot_arrays()
    paths = []
    for name, mod in (("port", tplots), ("jax", jplots)):
        out = str(tmp_path / name / f"{figure}.png")
        if figure == "ProbabilityTrack":
            got = mod.plot_probability_track(track, out)
        elif figure == "BreakpointHistogram":
            got = mod.plot_breakpoint_histogram(positions, 1000, out)
        else:
            got = mod.plot_score_vs_levdist(columns, out)
        assert got == out and os.path.exists(out)
        paths.append(out)
    assert same_pixels(*paths)


# -- study_plots --------------------------------------------------------------

@pytest.fixture(scope="module")
def own_studies(tmp_path_factory):
    """{"port": IndustryModel_False dir of the port's study-own (2 rows x 2,
    --device cpu), "jax": the same of JAX's run_own_study}."""
    root = tmp_path_factory.mktemp("own_studies")
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(["study-own", "--grid", "12:9,16:13", "--workdir", str(root / "port")]
                  + CLI_ARGS)
    jexp.run_own_study(str(root / "jax"), jseg.synthetic_segment_store(1234, 300, 2),
                       base=JConfig(**SMALL), grid=((12, 9), (16, 13)), total_iters=2)
    return {name: str(root / name / "IndustryModel_False") for name in ("port", "jax")}


def with_ks_rows(study_dir: str, out_dir: str) -> str:
    """A copy of the study with stat_test_KS rows added to its summary, as
    the velvet study writes them (per experiment, true and random)."""
    shutil.copytree(study_dir, out_dir)
    rng = np.random.default_rng(8)
    with open(os.path.join(out_dir, "results_summary.csv"), "a", newline="") as f:
        for read_len, dbg_kmer in ((12, 9), (16, 13)):
            for _ in range(3):
                for rand in (False, True):
                    f.write(f"{read_len},{dbg_kmer},stat_test_KS,{rng.random()!r},{rand}\n")
    return out_dir


def capture_facets(monkeypatch, module) -> list:
    """Record each _facet_boxpair call's (file name, groups, p-values), then
    draw it as usual."""
    calls = []
    draw = module._facet_boxpair

    def spy(plt, rows_by_facet, out_path, *args, **kwargs):
        pvals = kwargs.get("pvals", args[4] if len(args) > 4 else None)
        calls.append((os.path.basename(out_path),
                      {fc: [np.asarray(g, float) for g in groups]
                       for fc, groups in rows_by_facet.items()},
                      dict(pvals or {})))
        return draw(plt, rows_by_facet, out_path, *args, **kwargs)

    monkeypatch.setattr(module, "_facet_boxpair", spy)
    return calls


@pytest.mark.parametrize("summary", ["own", "with KS"])
@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("top_frac", [0.05, 0.5])
def test_study_plots_vs_jax(source, summary, top_frac, own_studies, tmp_path, monkeypatch):
    """Both packages' study_plots on one study directory (written by the
    port or by JAX): the same groups exactly, p-values within rtol 1e-12,
    and every figure of JAX's in the port's list with equal pixels."""
    study = own_studies[source]
    if summary == "with KS":
        study = with_ks_rows(study, str(tmp_path / "ks"))
    made, calls = {}, {}
    for name, mod in (("port", tplots), ("jax", jplots)):
        d = str(tmp_path / name)
        shutil.copytree(study, d)
        calls[name] = capture_facets(monkeypatch, mod)
        made[name] = mod.study_plots(d, top_frac=top_frac)
    assert [os.path.relpath(p, tmp_path / "jax") for p in made["jax"]] == \
        [os.path.relpath(p, tmp_path / "port") for p in made["port"]]
    for a, b in zip(made["port"], made["jax"]):
        assert same_pixels(a, b), a
    names = [c[0] for c in calls["port"]]
    assert names == [c[0] for c in calls["jax"]]
    assert ("KS-statistic_contigs_reference.png" in names) == (summary == "with KS")
    n_pvals = 0
    for (name, groups, pvals), (_, jgroups, jpvals) in zip(calls["port"], calls["jax"]):
        assert groups.keys() == jgroups.keys(), name
        for fc in groups:
            assert len(groups[fc]) == len(jgroups[fc]) == 2
            for g, jg in zip(groups[fc], jgroups[fc]):
                np.testing.assert_array_equal(g, jg, err_msg=f"{name} {fc}")
        assert pvals.keys() == jpvals.keys(), name
        for fc in pvals:
            np.testing.assert_allclose(pvals[fc], jpvals[fc], rtol=1e-12, atol=0)
        n_pvals += len(pvals)
    assert n_pvals >= 2  # the true-vs-random contrast of each read length at least


def test_cli_study_plots_vs_jax(own_studies, tmp_path, capsys):
    """`study-plots DIR... --top-frac` prints {"figures": [...]} as JAX's
    command does, and takes no --device: it touches no device."""
    outs = {}
    for name, main in (("port", tcli.main), ("jax", jcli.main)):
        dirs = []
        for src in ("port", "jax"):
            dirs.append(str(tmp_path / name / src))
            shutil.copytree(own_studies[src], dirs[-1])
        main(["study-plots", *dirs, "--top-frac", "0.5"])
        outs[name] = [os.path.relpath(p, tmp_path / name)
                      for p in json.loads(capsys.readouterr().out)["figures"]]
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 2 * 4
    for rel in outs["jax"]:
        assert same_pixels(str(tmp_path / "port" / rel), str(tmp_path / "jax" / rel)), rel
    with pytest.raises(SystemExit):
        tcli.main(["study-plots", own_studies["port"], "--device", "cpu"])


# -- emit_experiment_plots ----------------------------------------------------

def test_track_vs_jax_probability_track():
    segment = jseg.synthetic_genome(21, 300)
    segment = segment[:100] + "N" + segment[101:]  # a window with N has probability 0
    asm = tasm.Assembler(ExperimentConfig(**SMALL), "cpu")
    track, _ = texp.plot_inputs(asm, segment)
    jtable = load_default_query_table()
    want = np.asarray(j_track(jnp.asarray(encode_dna(segment)),
                              jnp.asarray(jtable.probs[8], jnp.float32), 8))
    assert track.dtype == np.float32 and track.shape == want.shape == (293,)
    np.testing.assert_allclose(track, want, rtol=RTOL, atol=0)
    assert (track[93:101] == 0).all() and (track[:93] > 0).all()


@pytest.mark.parametrize("batched", [False, True])
def test_redrawn_positions_are_the_experiments(batched, monkeypatch):
    """The breakpoints plotted are the experiment's own: the positions of
    its ReadSet, serial (Assembler.simulate) or batched (the runner's
    stage 1), exactly."""
    cfg = ExperimentConfig(**SMALL)
    segs = list(synthetic_segment_store(1234, 300, 3).seqs)
    drawn = []
    if batched:
        simulate = batch_runner.simulate_batch

        def spy(*args):
            drawn.append(simulate(*args))
            return drawn[-1]

        monkeypatch.setattr(batch_runner, "simulate_batch", spy)
        batch_runner.run_experiments_batched(cfg, segs, "cpu")
        (rs,) = drawn
        want = [rs.positions[b][rs.valid[b]].numpy() for b in range(len(segs))]
    else:
        simulate = tasm.Assembler.simulate

        def spy(self, genome, timer):
            drawn.append(simulate(self, genome, timer))
            return drawn[-1]

        monkeypatch.setattr(tasm.Assembler, "simulate", spy)
        asm = tasm.Assembler(cfg, "cpu")
        for seg in segs:
            asm.run_experiment(seg)
        monkeypatch.undo()
        want = [rs.positions[rs.valid].numpy() for rs in drawn]
    asm = tasm.Assembler(cfg, "cpu")
    for seg, w in zip(segs, want):
        _, got = texp.plot_inputs(asm, seg)
        assert got.dtype == np.int32 and len(got) > 0
        np.testing.assert_array_equal(got, w)


def figures_of(workdir: str, ind: int) -> list[str]:
    return sorted(os.path.basename(p).split("_SeqLen")[0] for p in
                  glob.glob(os.path.join(workdir, "results", f"exp_{ind}", "*.png")))


@pytest.mark.parametrize("command", ["run", "study-own", "study-own --batched", "study-all"])
def test_cli_plots_writes_three_figures_an_experiment(command, tmp_path, capsys):
    wd = str(tmp_path / "wd")
    argv = command.split() + ["--plots", "--workdir", wd] + CLI_ARGS
    if command != "run":
        argv += ["--grid", "12:9,16:13"]
    if "--batched" in command:
        argv += ["--seg-batch", "2"]
    tcli.main(argv)
    out = json.loads(capsys.readouterr().out)
    if command == "run":
        assert [os.path.basename(p).split("_SeqLen")[0] for p in out["plots"]] == list(FIGURES)
        assert all(os.path.exists(p) for p in out["plots"])
        assert figures_of(wd, 1) == sorted(FIGURES)
        return
    for ind in (1, 2):  # two rows: three figures a row and experiment
        assert figures_of(wd, ind) == sorted(FIGURES * 2)
    cfg = ExperimentConfig(**SMALL)
    ps = cfg.param_string()
    d = os.path.join(wd, "results", "exp_1")
    asm = tasm.Assembler(cfg, "cpu")
    seg = synthetic_segment_store(1234, 300, 2).seqs[0]
    track, positions = texp.plot_inputs(asm, seg)
    tplots.plot_probability_track(track, str(tmp_path / "track.png"))
    tplots.plot_breakpoint_histogram(positions, 300, str(tmp_path / "hist.png"))
    assert same_pixels(str(tmp_path / "track.png"), os.path.join(d, f"ProbabilityTrack{ps}.png"))
    assert same_pixels(str(tmp_path / "hist.png"), os.path.join(d, f"BreakpointHistogram{ps}.png"))


@pytest.mark.parametrize("command", ["run", "study-own", "study-all"])
def test_plots_without_matplotlib_raise_before_any_work(command, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    wd = tmp_path / "wd"
    with pytest.raises(ImportError, match="matplotlib"):
        tcli.main([command, "--plots", "--workdir", str(wd)] + CLI_ARGS)
    assert not wd.exists()
    with pytest.raises(ImportError, match="matplotlib"):
        texp.run_own_study(str(wd), synthetic_segment_store(1234, 300, 2), "cpu",
                           base=ExperimentConfig(**SMALL), total_iters=2, plots=True)
    assert not wd.exists()
