"""PyTorch port vs the JAX package: encoding, QueryTable, segments, the read
simulator and read dedup. The simulator is held on identical uniforms: both
sides draw positions from the same numbers by inverse CDF."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu.core import encoding as jenc  # noqa: E402
from genomeassembler_dev_tpu.core import querytable as jqt  # noqa: E402
from genomeassembler_dev_tpu.sim import reads as jreads  # noqa: E402
from genomeassembler_dev_tpu.sim.segments import synthetic_genome as j_genome  # noqa: E402
from genomeassembler_dev_tpu_torch.core import encoding as tenc  # noqa: E402
from genomeassembler_dev_tpu_torch.core import querytable as tqt  # noqa: E402
from genomeassembler_dev_tpu_torch.sim import reads as treads  # noqa: E402
from genomeassembler_dev_tpu_torch.sim.segments import synthetic_genome as t_genome  # noqa: E402


@pytest.fixture(scope="module")
def tables():
    return jqt.load_default_query_table(), tqt.load_default_query_table("cpu")


def test_encoding_and_segments():
    seg = j_genome(5, 500)
    assert t_genome(5, 500) == seg
    s = seg[:50] + "NacgtX"
    np.testing.assert_array_equal(tenc.encode_dna(s), jenc.encode_dna(s))
    assert tenc.INVALID == jenc.INVALID == 255
    assert tenc.decode_dna(tenc.encode_dna(seg)) == seg
    with pytest.raises(ValueError):
        tenc.decode_dna(tenc.encode_dna("ACN"))


def test_query_table(tables):
    j, t = tables
    assert (tqt.OFFSETS, tqt.TOTAL, tqt.KS) == (jqt.OFFSETS, jqt.TOTAL, jqt.KS)
    for k in jqt.KS:
        np.testing.assert_array_equal(t.probs[k].numpy(), j.probs[k])
    np.testing.assert_array_equal(t.combined.numpy(), j.combined)
    np.testing.assert_array_equal(tqt.QueryTable.from_numpy(j.probs, "cpu").combined.numpy(),
                                  j.combined)
    np.testing.assert_array_equal(tqt.QueryTable.uniform("cpu").combined.numpy(),
                                  jqt.QueryTable.uniform().combined)


def test_track_exact(tables):
    j, t = tables
    seg = j_genome(9, 400)
    seg = seg[:100] + "N" + seg[101:]
    codes = jenc.encode_dna(seg)
    jt = np.asarray(jreads.probability_track(jnp.asarray(codes),
                                             jnp.asarray(j.probs[8], jnp.float32), 8))
    tt = treads.probability_track(torch.from_numpy(codes), t.probs[8], 8).numpy()
    np.testing.assert_array_equal(tt, jt)
    assert (tt[93:101] == 0).all()


@pytest.mark.parametrize("read_len", [12, 40])
def test_positions_from_identical_uniforms(tables, read_len):
    j, t = tables
    codes = jenc.encode_dna(j_genome(21, 1000))
    key = jax.random.key(1234)
    n = jreads.n_draws_for(40.0, len(codes), read_len)
    assert treads.n_draws_for(40.0, len(codes), read_len) == n
    js = jreads.simulate_reads(key, jnp.asarray(codes), jnp.asarray(j.probs[8], jnp.float32),
                               read_len, n)
    # the same uniforms simulate_reads drew from the same key
    u = np.array(jax.random.uniform(key, (n,), dtype=jnp.float32))
    track = treads.probability_track(torch.from_numpy(codes), t.probs[8], 8)
    ts = treads.reads_from_uniforms(torch.from_numpy(u), torch.from_numpy(codes), track,
                                    read_len)
    # JAX's float32 cumsum moves a CDF step by a few ulps from the port's
    # exact float64 one: only a uniform within 1e-5 * total of a step may pick
    # a neighbouring position
    cdf = np.cumsum(track.numpy().astype(np.float64))
    x = u.astype(np.float64) * cdf[-1]
    step = np.searchsorted(cdf, x)
    near = np.minimum(np.abs(x - cdf[np.clip(step, 0, len(cdf) - 1)]),
                      np.abs(x - cdf[np.clip(step - 1, 0, len(cdf) - 1)])) < 1e-5 * cdf[-1]
    jpos, tpos = np.asarray(js.positions), ts.positions.numpy()
    same = jpos == tpos
    assert (same | near).all()
    assert same.mean() > 0.99
    np.testing.assert_array_equal(ts.valid.numpy()[same], np.asarray(js.valid)[same])
    np.testing.assert_array_equal(ts.codes.numpy()[same], np.asarray(js.codes)[same])
    assert not ts.valid.numpy().all()  # the 3' discard fired


def test_cdf_is_the_same_in_any_summation_order(tables):
    """At the velvet study's 50 kb, the float64 CDF of reads_from_uniforms
    does not depend on the order of the sums (a CUDA scan sums in blocks):
    a blocked, reversed-block sum gives the same steps and positions."""
    _, t = tables
    codes = torch.from_numpy(tenc.encode_dna(t_genome(1234, 50000)))
    track = treads.probability_track(codes, t.probs[8], 8).to(torch.float64)
    cdf = torch.cumsum(track, dim=0)
    n = track.shape[0]
    blocks = torch.cat([track, track.new_zeros(-n % 400)]).reshape(-1, 400)
    inner = torch.cumsum(blocks.flip(1), dim=1).flip(1)  # suffix sums in a block
    totals = inner[:, 0]
    offsets = torch.cat([torch.zeros(1, dtype=torch.float64),
                         torch.cumsum(totals, dim=0)[:-1]])
    blocked = (offsets[:, None] + totals[:, None] - inner + blocks).reshape(-1)[:n]
    assert torch.equal(blocked, cdf)
    u = torch.from_numpy(np.random.default_rng(0).random(20000).astype(np.float32))
    pos = treads.reads_from_uniforms(u, codes, track.to(torch.float32), 12).positions
    want = torch.searchsorted(blocked, u.to(torch.float64) * blocked[-1], right=True)
    assert torch.equal(pos.long(), want.clamp(max=n - 1))


def test_generator_simulation_is_seeded(tables):
    _, t = tables
    codes = torch.from_numpy(tenc.encode_dna(t_genome(3, 300)))
    runs = []
    for _ in range(2):
        gen = torch.Generator(device="cpu")
        gen.manual_seed(1234)
        runs.append(treads.generate_reads(gen, codes, t, 12, 15.0))
    a, b = runs
    assert a.codes.shape == (treads.n_draws_for(15.0, 300, 12), 12)
    assert torch.equal(a.codes, b.codes) and torch.equal(a.positions, b.positions)
    ok = a.valid
    starts = a.positions[ok].long()
    assert torch.equal(a.codes[ok], codes[starts[:, None] + torch.arange(12)])


def test_dedup_reads_exact():
    rng = np.random.default_rng(4)
    reads = rng.integers(0, 4, (300, 12)).astype(np.uint8)
    reads[100:200] = reads[:100]  # duplicates
    reads[7, 3] = reads[150, 0] = 255  # non-ACGT reads are dropped
    valid = rng.random(300) < 0.9
    ju, jc = jreads.dedup_reads(reads, valid)
    tu, tc = treads.dedup_reads(torch.from_numpy(reads), torch.from_numpy(valid))
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert tc.dtype == torch.int32 and int(tc.max()) > 1
    eu, ec = treads.dedup_reads(torch.from_numpy(reads), torch.zeros(300, dtype=torch.bool))
    assert eu.shape == (0, 12) and ec.shape == (0,)
