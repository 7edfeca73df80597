"""PyTorch port vs the JAX package: the breakage-biased dBG traversal
(dbg/biased.py) against JAX's three entry points and a string-level greedy
walk, and the biased Assembler path end to end on a replayed read set. Walks,
contigs, solutions, break counts and distances are compared exactly, scores
at rtol 2e-5."""

import os
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu.core.encoding import encode_dna, kmer_code  # noqa: E402
from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.dbg import biased as jbiased  # noqa: E402
from genomeassembler_dev_tpu.dbg.big_k import kmer_pair_codes  # noqa: E402
from genomeassembler_dev_tpu.dbg.dense import build_dbg_dense as j_build_dense  # noqa: E402
from genomeassembler_dev_tpu.ops.windows import kmer_window_codes as j_windows  # noqa: E402
from genomeassembler_dev_tpu.pipeline import assembler as jasm  # noqa: E402
from genomeassembler_dev_tpu.pipeline.config import ExperimentConfig as JConfig  # noqa: E402
from genomeassembler_dev_tpu.sim.reads import generate_reads  # noqa: E402
from genomeassembler_dev_tpu.sim.segments import plant_repeats, synthetic_genome  # noqa: E402
from genomeassembler_dev_tpu.utils.timers import StageTimer as JTimer  # noqa: E402
from genomeassembler_dev_tpu_torch import cli as tcli  # noqa: E402
from genomeassembler_dev_tpu_torch.core.querytable import QueryTable  # noqa: E402
from genomeassembler_dev_tpu_torch.dbg import biased as tbiased  # noqa: E402
from genomeassembler_dev_tpu_torch.dbg.assemble import dedup_contigs  # noqa: E402
from genomeassembler_dev_tpu_torch.dbg.dense import build_dbg_dense as t_build_dense  # noqa: E402
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes as t_windows  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import assembler as tasm  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline import results as res_io  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig  # noqa: E402

RTOL = 2e-5
INT_COLUMNS = ("sequence_len", "kmer_breaks", "lev_dist_vs_true")


def tt(a):
    """A tensor holding a copy of a (JAX's numpy views are read-only)."""
    return torch.tensor(np.asarray(a))


def sliding(s, k):
    return [s[i : i + k] for i in range(len(s) - k + 1)]


def repeat_reads(seed, k):
    """The reads of tests/test_biased.py: a 400-base segment with three
    planted repeats, cut into error-free reads of k + 6 bases every 2."""
    rng = np.random.default_rng(seed)
    g = plant_repeats(synthetic_genome(seed, 400), rng, n_events=3,
                      motif_len=(k + 4, k + 20))
    return [g[i : i + k + 6] for i in range(0, 400 - (k + 6), 2)]


def random_probs(seed):
    rng = np.random.default_rng(seed + 99)
    return rng.random(65536).astype(np.float32) + 1e-3


def greedy_oracle(reads, k, probs, max_len):
    """String-level biased traversal: walks start from every (branch node,
    out-edge) pair and continue through branches along the junction octamer
    of highest probability, ties to the smallest base."""
    kmers = sorted({r[i : i + k] for r in reads for i in range(len(r) - k + 1)})
    out_edges = defaultdict(set)
    in_deg = defaultdict(int)
    nodes = set()
    for km in kmers:
        p, s = km[:-1], km[1:]
        out_edges[p].add(km[-1])
        in_deg[s] += 1
        nodes.update((p, s))

    def branch(n):
        od = len(out_edges.get(n, ()))
        return od > 0 and (in_deg.get(n, 0) != 1 or od != 1)

    def greedy_next(n):
        cands = out_edges.get(n, ())
        if not cands:
            return None
        return min(cands, key=lambda c: (-probs[kmer_code(n[-7:] + c)], c))

    contigs = set()
    for n in sorted(nodes):
        if not branch(n):
            continue
        for c in sorted(out_edges[n]):
            s = n + c
            while len(s) < max_len:
                c2 = greedy_next(s[-(k - 1):])
                if c2 is None:
                    break
                s += c2
            contigs.add(s)
    return sorted(contigs)


def contig_set(buf, lens, wvalid):
    """The deduped walks, capped ones kept at their truncated length."""
    buf, lens, wvalid = (np.asarray(a) for a in (buf, lens, wvalid))
    return dedup_contigs(buf, lens, wvalid, np.zeros(len(lens), bool))


def jax_walks(reads, k, probs, max_len, entry):
    """One of JAX's three entry points on reads; returns its walk arrays cut
    to the walk count, with n_nodes (None for the dense entry point)."""
    codes = jnp.asarray(np.stack([encode_dna(r) for r in reads]))
    p = jnp.asarray(probs)
    if entry == "dense":
        kc, kv = j_windows(codes, k)
        out = jbiased.biased_contigs_dense(kc, kv, p, k, max_len, 512)
        n_nodes = None
    elif entry == "sparse":
        kc, kv = j_windows(codes, k)
        out = jbiased.biased_contigs_sparse(kc, kv, p, k, max_len, 512, node_cap=2048)
        n_nodes = int(out[5])
    else:
        hi, lo, kv = kmer_pair_codes(codes, k)
        out = jbiased.biased_contigs_big_k(hi, lo, kv, p, k, max_len, 512, node_cap=2048)
        n_nodes = int(out[5])
    n = int(out[4])
    buf, lens, wvalid, ovf = (np.asarray(a)[:n] for a in out[:4])
    return buf, lens, wvalid, ovf, n, n_nodes


def port_walks(reads, k, probs, max_len):
    codes = torch.from_numpy(np.stack([encode_dna(r) for r in reads]))
    kc, kv = t_windows(codes, k, dtype=torch.int64)
    return tbiased.biased_contigs(kc, kv, torch.from_numpy(probs), k, max_len)


# (seed, k, JAX entry point): the dense path holds k <= 10, sparse 9-15,
# big-k 17-31 (tests/test_biased.py:143-182 and both sides of each boundary)
ENTRIES = [(0, 9, "dense"), (0, 9, "sparse"), (1, 10, "dense"), (1, 10, "sparse"),
           (2, 13, "sparse"), (3, 15, "sparse"), (4, 17, "big_k"), (5, 21, "big_k")]


@pytest.mark.parametrize("seed,k,entry", ENTRIES)
def test_walks_vs_jax_and_oracle(seed, k, entry):
    reads = repeat_reads(seed, k)
    probs = random_probs(seed)
    jb, jl, jv, jo, jn, jnn = jax_walks(reads, k, probs, 500, entry)
    tb, tl, tv, to, tn, tnn = port_walks(reads, k, probs, 500)
    assert tn == jn >= 1
    if jnn is not None:
        assert tnn == jnn
    # walks come in ascending (branch node, char) order on both sides
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tb.numpy(), jb)
    got = contig_set(tb, tl, tv)
    assert got == greedy_oracle(reads, k, probs, 500)


@pytest.mark.parametrize("k", [9, 13])
def test_cap_overflow_kept(k):
    """A tail flowing into a periodic cycle: every walk through the cycle
    hits the cap; the overflow flags and buffers equal JAX's and the
    Assembler's contig step keeps the capped walks instead of raising."""
    s = "T" * 10 + "ACGTTGCATGCA" * 5
    reads = sliding(s, k + 3)
    probs = np.ones(65536, np.float32)
    entry = "dense" if k <= 10 else "sparse"
    jb, jl, jv, jo, jn, _ = jax_walks(reads, k, probs, 40, entry)
    tb, tl, tv, to, tn, _ = port_walks(reads, k, probs, 40)
    assert tn == jn and bool(to.any()) and bool(jo.any())
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tb.numpy(), jb)
    assert (tl.numpy()[to.numpy()] == 40).all()

    cfg = ExperimentConfig(seq_len=20, read_len=k + 3, dbg_kmer=k, coverage_target=10.0,
                           traversal="biased")
    asm = tasm.Assembler(cfg, "cpu")
    codes = torch.from_numpy(np.stack([encode_dna(r) for r in reads]))
    contigs = asm.contigs(codes, torch.ones(len(reads), dtype=torch.bool),
                          tasm.StageTimer("cpu", verbose=False))
    assert contigs == greedy_oracle(reads, k, probs, 40) == contig_set(tb, tl, tv)
    assert max(len(c) for c in contigs) == 40


@pytest.mark.parametrize("winner", ["A", "T", "tie"])
def test_branch_choice_and_ties(winner):
    """A lead-in, then two continuations after one 8-base context. The walk
    from the lead-in passes the branch along the more probable junction
    octamer; with equal probabilities (zero included: a zero-probability
    octamer is still a present edge) the smaller base wins on both sides."""
    k = 9
    lead, stem = "TTCA", "ACGTACGG"
    reads = (sliding(lead + stem + "ATTGCCAA", 12)
             + sliding(lead + stem + "TGGCAACC", 12))
    probs = np.full(65536, 1e-6, np.float32)
    if winner == "tie":
        probs[:] = 0.0
    else:
        probs[kmer_code(stem[1:] + winner)] = 1.0
    want = "A" if winner == "tie" else winner
    other = "T" if want == "A" else "A"
    oracle = greedy_oracle(reads, k, probs, 64)
    for entry in ("dense", "sparse"):
        jb, jl, jv, jo, _, _ = jax_walks(reads, k, probs, 64, entry)
        assert contig_set(jb, jl, jv) == oracle
    tb, tl, tv, to, _, _ = port_walks(reads, k, probs, 64)
    got = contig_set(tb, tl, tv)
    assert got == oracle
    assert any(c.startswith(lead + stem + want) for c in got)
    assert not any(lead + stem + other in c for c in got)


def test_successor_ties_take_smallest_base():
    """Four present out-edges of one node, all equal weights: the successor
    is the edge of base A (char 0); raising base G's weight makes it G."""
    p_idx = torch.zeros(4, dtype=torch.int64)
    s_idx = torch.tensor([10, 11, 12, 13])
    char = torch.tensor([3, 2, 1, 0])  # edges listed from T down to A
    oct_code = torch.tensor([0, 1, 2, 3])
    probs = torch.zeros(65536, dtype=torch.float64)
    succ = tbiased.biased_successor_edges(p_idx, s_idx, char, oct_code, 2, probs)
    assert succ.tolist() == [13, -1]
    probs[1] = 0.5  # the G edge
    succ = tbiased.biased_successor_edges(p_idx, s_idx, char, oct_code, 2, probs)
    assert succ.tolist() == [11, -1]


@pytest.mark.parametrize("probs_kind", ["random", "ones"])
def test_dense_successor_vs_jax(probs_kind):
    k = 9
    reads = repeat_reads(6, k)
    codes = np.stack([encode_dna(r) for r in reads])
    kc, kv = (np.asarray(a) for a in j_windows(jnp.asarray(codes), k))
    probs = random_probs(6) if probs_kind == "random" else np.ones(65536, np.float32)
    want = np.asarray(jbiased.biased_successor(
        j_build_dense(jnp.asarray(kc), jnp.asarray(kv), k), jnp.asarray(probs)))
    got = tbiased.biased_successor(t_build_dense(tt(kc).long(), tt(kv), k),
                                   torch.from_numpy(probs))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 10


def test_k_below_9_raises():
    codes = torch.zeros((2, 12), dtype=torch.uint8)
    kc, kv = t_windows(codes, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="dbg_kmer >= 9"):
        tbiased.biased_contigs(kc, kv, torch.ones(65536), 8, 32)
    g = t_build_dense(kc, kv, 8)
    with pytest.raises(ValueError, match="dbg_kmer >= 9"):
        tbiased.biased_successor(g, torch.ones(65536))
    with pytest.raises(ValueError, match="dbg_kmer >= 9"):
        ExperimentConfig(dbg_kmer=8, read_len=12, traversal="biased").validate()


# (seq_len, read_len, dbg_kmer, biased_max_solutions, segment seed)
EXPERIMENTS = [(400, 12, 9, 5, 33), (350, 16, 13, 256, 34), (300, 20, 17, 3, 35)]


@pytest.fixture(scope="module")
def jtable():
    return load_default_query_table()


@pytest.mark.parametrize("seq_len,read_len,dbg_kmer,max_sol,seed", EXPERIMENTS)
def test_experiment_vs_jax(jtable, seq_len, read_len, dbg_kmer, max_sol, seed):
    """A full biased experiment on one JAX-simulated read set of a segment
    with planted repeats, through both Assemblers: the contig set, the
    truncated solution list in order, and all 13 columns."""
    g = plant_repeats(synthetic_genome(seed, seq_len), np.random.default_rng(seed),
                      n_events=4)
    rs = generate_reads(jax.random.key(1234), encode_dna(g), jtable, read_len, 20.0)
    read_set = tuple(np.asarray(a) for a in (rs.codes, rs.valid, rs.positions))
    kw = dict(seq_len=seq_len, read_len=read_len, coverage_target=20.0, kmer=8,
              dbg_kmer=dbg_kmer, seed=1234, traversal="biased",
              biased_max_solutions=max_sol)
    jas = jasm.Assembler(JConfig(**kw), jtable)
    tas = tasm.Assembler(ExperimentConfig(**kw), "cpu",
                         QueryTable.from_numpy(jtable.probs, "cpu"))

    jtimer, ttimer = JTimer(False), tasm.StageTimer("cpu", verbose=False)
    jcontigs = jas.contigs(rs.codes, rs.valid, jtimer)
    trs = tas._replay_read_set(torch.from_numpy(encode_dna(g)), read_set)
    tcontigs = tas.contigs(trs.codes, trs.valid, ttimer)
    assert tcontigs == jcontigs
    sols = tas.merge(tcontigs, ttimer)
    assert sols == jas.merge(jcontigs, jtimer)
    assert sols == sorted(set(tcontigs), key=lambda s: (-len(s), s))[:max_sol]
    if max_sol < 256:
        assert len(tcontigs) > max_sol == len(sols)

    jres = jas.run_experiment(g, read_set)
    tres = tas.run_experiment(g, read_set)
    assert sorted(tres.columns["sequence"]) == sorted(sols)
    jrow = {s: i for i, s in enumerate(jres.columns["sequence"])}
    idx = [jrow[s] for s in tres.columns["sequence"]]
    for name in tasm.RESULT_COLUMNS[1:]:
        got = np.asarray(tres.columns[name])
        want = np.asarray(jres.columns[name])[idx]
        if name in INT_COLUMNS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    assert tres.stats == jres.stats


@pytest.mark.parametrize("cmd", ["run", "study-own", "study-all"])
def test_cli_traversal_reaches_assembler(cmd, tmp_path, monkeypatch, capsys):
    """--traversal and --biased-max-solutions reach every Assembler the
    command builds for the own path, and the tables hold at most that many
    solutions."""
    seen = []
    init = tasm.Assembler.__init__

    def spy(self, config, *args, **kw):
        seen.append(config)
        init(self, config, *args, **kw)

    monkeypatch.setattr(tasm.Assembler, "__init__", spy)
    args = [cmd, "--device", "cpu", "--workdir", str(tmp_path), "--seq-len", "300",
            "--coverage", "15", "--total-iters", "1", "--synthetic", "--repeat-segments",
            "--traversal", "biased", "--biased-max-solutions", "2"]
    if cmd != "run":
        args += ["--grid", "12:9,16:13"]
    tcli.main(args)
    capsys.readouterr()
    own = [c for c in seen if not c.only_kmers_from_reads]
    assert len(own) == (1 if cmd == "run" else 2)
    assert all(c.traversal == "biased" and c.biased_max_solutions == 2 for c in own)
    for c in own:
        cols = res_io.load_result_columns(res_io.solutions_path(str(tmp_path), 1, c))
        assert 1 <= len(cols["sequence"]) <= 2
    assert os.path.isdir(os.path.join(tmp_path, "results", "exp_1"))
