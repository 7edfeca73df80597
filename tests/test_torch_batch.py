"""PyTorch port vs the JAX package and the port's serial path: the batched
study runner (pipeline/batch_runner.py) and its stages. The batched
simulation, the union dBG over a batch, the grouped breakscore and the
per-row KS, and whole batches against Assembler.run_experiment, on
numpy-seeded inputs: integers and solution lists exact, floats at rtol
2e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.dbg.assemble import DENSE_MAX_K  # noqa: E402
from genomeassembler_dev_tpu.dbg.assemble import dedup_contigs as j_dedup_contigs  # noqa: E402
from genomeassembler_dev_tpu.ops import ks as jks  # noqa: E402
from genomeassembler_dev_tpu.pipeline import assembler as jasm  # noqa: E402
from genomeassembler_dev_tpu.pipeline.batch_runner import _walk_jit  # noqa: E402
from genomeassembler_dev_tpu.pipeline.config import ExperimentConfig as JConfig  # noqa: E402
from genomeassembler_dev_tpu.score.breakscore import breakscore as j_breakscore  # noqa: E402
from genomeassembler_dev_tpu.sim.reads import generate_reads as j_generate_reads  # noqa: E402
from genomeassembler_dev_tpu_torch.core.encoding import encode_dna  # noqa: E402
from genomeassembler_dev_tpu_torch.core.querytable import QueryTable  # noqa: E402
from genomeassembler_dev_tpu_torch.dbg.assemble import (  # noqa: E402
    contigs_from_read_codes, contigs_from_read_codes_batched)
from genomeassembler_dev_tpu_torch.ops import ks as tks  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import batch_runner  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import evaluate  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline.assembler import RESULT_COLUMNS, Assembler  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig  # noqa: E402
from genomeassembler_dev_tpu_torch.score.breakscore import breakscore as t_breakscore  # noqa: E402
from genomeassembler_dev_tpu_torch.sim.reads import (  # noqa: E402
    ReadSet, generate_reads, probability_track)
from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store  # noqa: E402

RTOL = 2e-5
INT_COLUMNS = ("sequence_len", "kmer_breaks", "lev_dist_vs_true")
# the shape of tests/test_batch_runner.py::test_matches_serial_runner
SMALL = dict(seq_len=300, coverage_target=15.0, kmer=8, seed=1234, n_orderings=200)
ROWS = [(12, 9), (40, 15)]


@pytest.fixture(scope="module")
def jtable():
    return load_default_query_table()


@pytest.fixture(scope="module")
def ttable(jtable):
    return QueryTable.from_numpy(jtable.probs, "cpu")


def segments(n=3, seed=11, repeats=False):
    return list(synthetic_segment_store(seed, 300, n, repeats=repeats).seqs)


def stack(segs):
    return torch.from_numpy(np.stack([encode_dna(s) for s in segs]))


def batch_reads(ttable, segs, read_len):
    gen = torch.Generator()
    gen.manual_seed(1234)
    return generate_reads(gen, stack(segs), ttable, read_len, 15.0)


def assert_same_columns(got, want, aligned=False):
    """Every results column: the sequences (as a list, or as a set with the
    other columns aligned by sequence), integers exact, floats at RTOL."""
    if aligned:
        row = {s: i for i, s in enumerate(want["sequence"])}
        assert set(got["sequence"]) == set(row)
        idx = [row[s] for s in got["sequence"]]
    else:
        assert got["sequence"] == want["sequence"]
        idx = list(range(len(want["sequence"])))
    for name in RESULT_COLUMNS[1:]:
        a, b = np.asarray(got[name]), np.asarray(want[name])[idx]
        if name in INT_COLUMNS:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("read_len", [12, 40])
def test_batched_sim_equals_serial(ttable, read_len):
    """Every segment of a stack draws the serial run's reads, bit for bit."""
    segs = segments(4, repeats=True)
    rs = batch_reads(ttable, segs, read_len)
    assert rs.codes.shape[:2] == (4, rs.valid.shape[1])
    for b, seg in enumerate(segs):
        gen = torch.Generator()
        gen.manual_seed(1234)
        one = generate_reads(gen, torch.from_numpy(encode_dna(seg)), ttable, read_len, 15.0)
        for name in ("codes", "valid", "positions", "track"):
            assert torch.equal(getattr(rs, name)[b], getattr(one, name)), name


@pytest.mark.parametrize("dbg_kmer,read_len", [(9, 12), (13, 16), (15, 20)])
def test_batched_contigs_vs_jax_walk(ttable, dbg_kmer, read_len):
    """One union graph over the batch gives each segment the contig set of
    JAX's vmapped walk (_walk_jit, the JAX runner's stage 2) on identical
    read codes."""
    cfg = JConfig(read_len=read_len, dbg_kmer=dbg_kmer, **SMALL)
    rs = batch_reads(ttable, segments(3, repeats=True), read_len)
    codes, valid = rs.codes.numpy(), rs.valid.numpy()
    # the JAX runner's walk statics (batch_runner.py:358-369)
    L, n_draws = cfg.seq_len, codes.shape[1]
    dedup_cap = 1 << (L - read_len + 1).bit_length()
    use_dedup = read_len <= 15 and dedup_cap <= n_draws * 2
    if dbg_kmer <= DENSE_MAX_K:
        node_cap = min(1 << max(6, (L - dbg_kmer + 1).bit_length()), 4 ** (dbg_kmer - 1))
    else:
        node_cap = 1 << max(1, cfg.contig_cap + 64 - 1).bit_length()
    out = _walk_jit(read_len, dbg_kmer, cfg.contig_cap, 2048, use_dedup, dedup_cap,
                    node_cap, None)(jnp.asarray(codes), jnp.asarray(valid))
    bufs, lens, wvalid, ovf = (np.asarray(x) for x in out[:4])
    want = [j_dedup_contigs(bufs[b], lens[b], wvalid[b], ovf[b]) for b in range(3)]
    got = contigs_from_read_codes_batched(rs.codes, rs.valid, dbg_kmer, cfg.contig_cap)
    assert got == want
    assert all(len(c) > 1 for c in got)


@pytest.mark.parametrize("dbg_kmer,read_len", [(21, 25), (31, 40)])
def test_batched_contigs_big_k(ttable, dbg_kmer, read_len):
    """k 21 packs the segment above the code; k 31 with B 3 does not fit one
    int64 and ranks (segment, code) rows. Both equal contigs_from_read_codes
    on each segment."""
    rs = batch_reads(ttable, segments(3, repeats=True), read_len)
    got = contigs_from_read_codes_batched(rs.codes, rs.valid, dbg_kmer, 600)
    for b in range(3):
        assert got[b] == contigs_from_read_codes(rs.codes[b], rs.valid[b], dbg_kmer, 600)
    with pytest.raises(ValueError, match="overflow"):
        contigs_from_read_codes_batched(rs.codes, rs.valid, dbg_kmer, 32)


def grouped_score_inputs(ttable, read_len):
    """Three segments' solutions (substrings, mutated, a pad row) and their
    own distinct reads, packed and padded to one group."""
    rng = np.random.default_rng(read_len)
    segs = segments(3, seed=5)
    rs = batch_reads(ttable, segs, read_len)
    pm, pl, rc, rn, rv = [], [], [], [], []
    for b, seg in enumerate(segs):
        sols = [seg[int(a):int(a) + int(n)] for a, n in zip(rng.integers(0, 150, 9),
                                                            rng.integers(40, 150, 9))]
        sols.append("".join(rng.choice(list("ACGT"), 90)))
        mat, lens = evaluate.pack_strings(sols, s_multiple=16, l_multiple=128)
        codes, cnts, valid = evaluate.pack_reads(rs.codes[b], rs.valid[b], 64)
        pm.append(mat), pl.append(lens), rc.append(codes.numpy()), rn.append(cnts.numpy())
        rv.append(valid.numpy())
    U = max(len(c) for c in rc)
    pad = lambda a, fill: np.concatenate([a, np.full((U - len(a),) + a.shape[1:], fill, a.dtype)])
    return (np.stack(pm), np.stack(pl), np.stack([pad(a, 0) for a in rc]),
            np.stack([pad(a, 0) for a in rn]), np.stack([pad(a, False) for a in rv]), rs)


@pytest.mark.parametrize("read_len", [12, 40])
def test_grouped_breakscore_vs_jax_vmap(jtable, ttable, read_len):
    """G segments' solutions, each against its own reads, in one call:
    jax.vmap(breakscore) over the group (40-base reads take the word keys)."""
    pm, pl, rc, rn, rv, _ = grouped_score_inputs(ttable, read_len)
    probs = np.asarray(jtable.combined, np.float32)
    j = jax.vmap(lambda a, b, c, d, e: j_breakscore(a, b, c, d, e, jnp.asarray(probs),
                                                    break_kmer=8, read_chunk=64))(
        *(jnp.asarray(x) for x in (pm, pl, rc, rn, rv)))
    t = t_breakscore(*(torch.from_numpy(x) for x in (pm, pl, rc, rn, rv, probs)), break_kmer=8)
    assert t.bp_score.shape == pl.shape
    np.testing.assert_array_equal(t.kmer_breaks.numpy(), np.asarray(j.kmer_breaks))
    np.testing.assert_array_equal(t.site_counts.numpy(), np.asarray(j.site_counts))
    for name in ("bp_score", "bp_score_norm_by_break_freqs", "bp_score_norm_by_len",
                 "path_freq"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=RTOL, err_msg=name)
    assert (t.kmer_breaks.numpy()[:, :9] > 0).all()
    # each member alone gives its own row of the group
    for g in range(pm.shape[0]):
        one = t_breakscore(*(torch.from_numpy(x[g]) for x in (pm, pl, rc, rn, rv)),
                           torch.from_numpy(probs), break_kmer=8)
        assert torch.equal(one.site_counts, t.site_counts[g])
        assert torch.equal(one.bp_score, t.bp_score[g])


def test_per_row_ks_vs_jax_vmap(ttable):
    """KS of each row against its own segment's track: jax.vmap over the
    group of batched_ks_2samp, and the shared [M] form for one segment."""
    rng = np.random.default_rng(7)
    tracks = batch_reads(ttable, segments(3), 12).track.numpy()  # [3, M]
    xs = rng.random((3, 6, 300)).astype(np.float32) * 2e-3
    xs[0, 1, :200] = 0.0  # heavy ties
    xs[1, 2, :40] = tracks[1, :40]  # ties across the two samples
    xs[2, 3, 7] = np.nan  # a row without matched reads
    j = np.asarray(jax.vmap(jks.batched_ks_2samp)(jnp.asarray(xs), jnp.asarray(tracks)))
    rows = torch.from_numpy(xs.reshape(18, 300))
    t = tks.batched_ks_2samp(rows, torch.from_numpy(tracks).repeat_interleave(6, dim=0))
    np.testing.assert_allclose(t.numpy().reshape(3, 6), j, rtol=RTOL)
    assert np.isnan(t.numpy()[15])
    one = tks.batched_ks_2samp(rows[6:12], torch.from_numpy(tracks[1]))
    assert torch.equal(one, t[6:12])


@pytest.mark.parametrize("read_len,dbg_kmer", ROWS)
def test_batched_equals_serial_runner(ttable, read_len, dbg_kmer):
    """Three segments with score groups of two (a partial last group): each
    result equals the serial Assembler's."""
    cfg = ExperimentConfig(read_len=read_len, dbg_kmer=dbg_kmer, **SMALL)
    segs = segments(3)
    batched = batch_runner.run_experiments_batched(cfg, segs, "cpu", ttable, score_group=2)
    serial = Assembler(cfg, "cpu", ttable)
    assert len(batched) == 3
    for got, seg in zip(batched, segs):
        want = serial.run_experiment(seg)
        assert list(got.columns) == RESULT_COLUMNS
        assert_same_columns(got.columns, want.columns)
        assert got.stats == want.stats
        assert "Generating sequencing reads (batched)" in got.timings


@pytest.mark.parametrize("read_len,dbg_kmer", ROWS)
def test_batched_vs_jax_on_its_read_sets(jtable, ttable, monkeypatch, read_len, dbg_kmer):
    """With the batched simulation stage returning JAX's read sets, each
    result equals JAX's Assembler.run_experiment on the same read set."""
    segs = segments(3, seed=13, repeats=True)
    read_sets = []
    for seg in segs:
        rs = j_generate_reads(jax.random.key(1234), encode_dna(seg), jtable, read_len, 15.0)
        read_sets.append(tuple(np.asarray(a) for a in (rs.codes, rs.valid, rs.positions)))

    def jax_reads(cfg, genome, table):
        codes, valid, positions = (torch.from_numpy(np.stack(a)) for a in zip(*read_sets))
        return ReadSet(codes=codes, valid=valid, positions=positions, read_len=read_len,
                       track=probability_track(genome, table.probs[8], 8))

    monkeypatch.setattr(batch_runner, "simulate_batch", jax_reads)
    kw = dict(read_len=read_len, dbg_kmer=dbg_kmer, **SMALL)
    got = batch_runner.run_experiments_batched(ExperimentConfig(**kw), segs, "cpu", ttable,
                                               score_group=2)
    jax_asm = jasm.Assembler(JConfig(**kw), jtable)
    for res, seg, read_set in zip(got, segs, read_sets):
        want = jax_asm.run_experiment(seg, read_set)
        assert_same_columns(res.columns, want.columns, aligned=True)
        assert res.stats == want.stats
        assert res.n_solutions >= 1


def test_biased_detour_runs_serial(ttable):
    """A non-standard traversal runs the serial Assembler."""
    cfg = ExperimentConfig(read_len=12, dbg_kmer=9, traversal="biased", **SMALL)
    segs = segments(2, repeats=True)
    got = batch_runner.run_experiments_batched(cfg, segs, "cpu", ttable)
    asm = Assembler(cfg, "cpu", ttable)
    for res, seg in zip(got, segs):
        assert_same_columns(res.columns, asm.run_experiment(seg).columns)
        assert "Running DBG de novo genome assembler" in res.timings


def test_batch_shapes_and_group_size(ttable, monkeypatch):
    cfg = ExperimentConfig(read_len=12, dbg_kmer=9, **SMALL)
    with pytest.raises(ValueError, match="one length"):
        batch_runner.run_experiments_batched(cfg, segments(1) + ["ACGT" * 50], "cpu", ttable)
    assert batch_runner.run_experiments_batched(cfg, [], "cpu", ttable) == []
    # the study shape: 64 solution rows of 1,152 columns, 3,584 distinct reads
    assert evaluate.group_size(8, 64, 1152, 3584, 993) == 8
    row = 16 * 69904 + 64 * (1152 + 3584)
    ks = 40 * evaluate.KS_ROWS * (69904 + 993)
    monkeypatch.setattr(evaluate, "EVAL_BUDGET_BYTES", ks + 3 * 64 * row)
    assert evaluate.group_size(8, 64, 1152, 3584, 993) == 3
    assert evaluate.group_size(8, 256, 1152, 3584, 993) == 1
