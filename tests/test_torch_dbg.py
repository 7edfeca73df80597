"""PyTorch port vs the JAX package: the dense and sparse dBG, the
pointer-doubling walk and the canonical contig set, on read sets simulated by
the JAX package. Every output here is an integer, so the comparison is
exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu.core.encoding import encode_dna  # noqa: E402
from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.dbg import assemble as jasm  # noqa: E402
from genomeassembler_dev_tpu.dbg import dense as jdense  # noqa: E402
from genomeassembler_dev_tpu.dbg.doubling import walk_contigs_doubling as j_walk  # noqa: E402
from genomeassembler_dev_tpu.dbg.graph import build_dbg, walk_starts_sparse  # noqa: E402
from genomeassembler_dev_tpu.ops.windows import kmer_window_codes as j_windows  # noqa: E402
from genomeassembler_dev_tpu.sim.reads import generate_reads  # noqa: E402
from genomeassembler_dev_tpu.sim.segments import synthetic_genome  # noqa: E402
from genomeassembler_dev_tpu_torch.dbg import assemble as tasm  # noqa: E402
from genomeassembler_dev_tpu_torch.dbg import dense as tdense  # noqa: E402
from genomeassembler_dev_tpu_torch.dbg import graph as tgraph  # noqa: E402
from genomeassembler_dev_tpu_torch.dbg.doubling import walk_contigs_doubling as t_walk  # noqa: E402

# (k, read_len, seq_len, coverage, segment seed): k 5 gives many branches
SHAPES = [(5, 8, 150, 12.0, 3), (9, 12, 300, 15.0, 4)]


@pytest.fixture(scope="module")
def table():
    return load_default_query_table()


def tt(a):
    """A tensor holding a copy of a (JAX's numpy views are read-only)."""
    return torch.tensor(np.asarray(a))


def segment(seed, seq_len):
    """A random segment with a planted 40-base repeat, so that k 9 branches."""
    g = synthetic_genome(seed, seq_len)
    half = seq_len // 2
    return g[:half] + g[20:60] + g[half : seq_len - 40]


def jax_reads(table, read_len, seq_len, coverage, seed):
    genome = encode_dna(segment(seed, seq_len))
    rs = generate_reads(jax.random.key(1234), genome, table, read_len, coverage)
    return np.asarray(rs.codes), np.asarray(rs.valid)


def windows(codes, valid, k):
    kc, kv = j_windows(jnp.asarray(codes), k)
    return np.asarray(kc), np.asarray(kv) & valid[:, None]


@pytest.mark.parametrize("k,read_len,seq_len,coverage,seed", SHAPES)
class TestAgainstJax:
    def test_contigs_dense(self, table, k, read_len, seq_len, coverage, seed):
        codes, valid = jax_reads(table, read_len, seq_len, coverage, seed)
        kc, kv = windows(codes, valid, k)
        max_len = 2 * seq_len
        jb, jl, jv, jo, jn, jnn = (np.asarray(x) for x in jdense.contigs_dense(
            jnp.asarray(kc), jnp.asarray(kv), k, max_len, 4096, 4096))
        tb, tl, tv, to, tn, tnn = tdense.contigs_dense(
            tt(kc), tt(kv), k, max_len)
        assert (tn, tnn) == (int(jn), int(jnn))
        assert tn > 1
        # walks come in ascending (branch node, char) order on both sides
        np.testing.assert_array_equal(tl.numpy(), jl[:tn])
        np.testing.assert_array_equal(tv.numpy(), jv[:tn])
        np.testing.assert_array_equal(to.numpy(), jo[:tn])
        np.testing.assert_array_equal(tb.numpy(), jb[:tn])

    def test_build_dbg_dense(self, table, k, read_len, seq_len, coverage, seed):
        codes, valid = jax_reads(table, read_len, seq_len, coverage, seed)
        kc, kv = windows(codes, valid, k)
        j = jdense.build_dbg_dense(jnp.asarray(kc), jnp.asarray(kv), k)
        t = tdense.build_dbg_dense(tt(kc), tt(kv), k)
        for name in ("presence", "in_deg", "out_deg", "branch", "succ", "pred"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)), err_msg=name)

    @pytest.mark.parametrize("short", [False, True])
    def test_walk_doubling_on_jax_graph(self, table, k, read_len, seq_len, coverage,
                                        seed, short):
        """Both walks on the same (sparse, padded) graph arrays; a short
        max_len makes the longer chains overflow."""
        max_len = k + 4 if short else 2 * seq_len
        codes, valid = jax_reads(table, read_len, seq_len, coverage, seed)
        kc, kv = windows(codes, valid, k)
        g = build_dbg(jnp.asarray(kc.reshape(-1)), jnp.asarray(kv.reshape(-1)), k)
        start, prefix, wvalid, _ = walk_starts_sparse(g, 1024)
        start = jnp.where(wvalid, start, -1)
        node_char = (g.nodes & 3).astype(jnp.uint8)
        jb, jl, jo = (np.asarray(x) for x in j_walk(
            node_char, g.succ, g.pred, g.branch, g.out_deg, start, prefix, wvalid,
            k, max_len))
        graph = [np.asarray(x) for x in (node_char, g.succ, g.pred, g.branch,
                                         g.out_deg, start, prefix, wvalid)]
        tb, tl, to = t_walk(*(tt(a.astype(np.int64) if a.dtype == np.int32 else a)
                              for a in graph), k, max_len)
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_array_equal(to.numpy(), jo)
        ok = ~jo  # an overflowed row's clamped cells are written in no set order
        np.testing.assert_array_equal(tb.numpy()[ok], jb[ok])
        assert jo.any() == short

    def test_contigs_from_read_codes(self, table, k, read_len, seq_len, coverage, seed):
        codes, valid = jax_reads(table, read_len, seq_len, coverage, seed)
        want = jasm.contigs_from_read_codes(codes, valid, k, 2 * seq_len)
        got = tasm.contigs_from_read_codes(tt(codes),
                                           tt(valid), k, 2 * seq_len)
        assert got == want
        assert len(got) > 1


def test_overflow_raises(table):
    codes, valid = jax_reads(table, 12, 300, 15.0, 4)
    with pytest.raises(ValueError, match="overflow"):
        jasm.contigs_from_read_codes(codes, valid, 9, 15)
    with pytest.raises(ValueError, match="overflow"):
        tasm.contigs_from_read_codes(tt(codes), tt(valid),
                                     9, 15)


# (k, read_len): k 11-15 take JAX's contigs_sparse, k 17-31 its contigs_big_k
SPARSE = [(11, 14), (13, 16), (15, 20), (17, 22), (21, 26), (31, 36)]


@pytest.mark.parametrize("k,read_len", SPARSE)
def test_sparse_contigs_vs_jax(table, k, read_len):
    codes, valid = jax_reads(table, read_len, 300, 15.0, 5)
    want = jasm.contigs_from_read_codes(codes, valid, k, 600)
    got = tasm.contigs_from_read_codes(tt(codes), tt(valid), k, 600)
    assert got == want
    assert len(got) > 1


def test_build_dbg_sparse_vs_jax(table):
    """The graph arrays at k 13: JAX pads them to capacity, the port sizes
    them exactly."""
    codes, valid = jax_reads(table, 16, 300, 15.0, 5)
    kc, kv = windows(codes, valid, 13)
    j = build_dbg(jnp.asarray(kc.reshape(-1)), jnp.asarray(kv.reshape(-1)), 13)
    t = tgraph.build_dbg(tt(kc), tt(kv), 13)
    assert (t.n_edges, t.n_nodes) == (int(j.n_edges), int(j.n_nodes))
    np.testing.assert_array_equal(t.edges.numpy(), np.asarray(j.edges)[: t.n_edges])
    for name in ("nodes", "in_deg", "out_deg", "branch", "succ", "pred"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name))[: t.n_nodes],
                                      err_msg=name)
    jstart, jprefix, jvalid, jn = walk_starts_sparse(j, 1024)
    tstart, tprefix, tvalid, tn = tgraph.walk_starts_sparse(t)
    assert tn == int(jn) > 1
    np.testing.assert_array_equal(tstart.numpy(), np.asarray(jstart)[:tn])
    np.testing.assert_array_equal(tprefix.numpy(), np.asarray(jprefix)[:tn])


def test_k_beyond_31_raises():
    codes = torch.zeros((2, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="31"):
        tasm.contigs_from_read_codes(codes, torch.ones(2, dtype=torch.bool), 32, 100)
