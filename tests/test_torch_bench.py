"""PyTorch port vs the JAX package: the headline bench's step
(genomeassembler_dev_tpu_torch/bench.py) against bench.py's composition of
JAX's building blocks (dedup_with_counts, unpack_kmer_windows,
jax.vmap(contigs_dense), weighted bincount_mxu), on identical numpy-made
read sets of B 4 segments x 300 bases (reads of 12 at coverage 40, dbg k
9): distinct reads, walks, contig letters, each segment's contig set and
the [B, 65,536] octamer counts, all exact. Then the bench's entry point at
a tiny CPU shape: its one JSON line, a failed gate, the stop without a
card, the pair-ratio arithmetic and its imports."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu.dbg.assemble import dedup_contigs as j_dedup_contigs  # noqa: E402
from genomeassembler_dev_tpu.dbg.dense import contigs_dense  # noqa: E402
from genomeassembler_dev_tpu.ops.dedup import (  # noqa: E402
    dedup_with_counts, pack_read_codes, unpack_kmer_windows)
from genomeassembler_dev_tpu.ops.mxu import bincount_mxu  # noqa: E402
from genomeassembler_dev_tpu_torch import bench  # noqa: E402
from genomeassembler_dev_tpu_torch.core.encoding import encode_dna  # noqa: E402
from genomeassembler_dev_tpu_torch.merge import native  # noqa: E402
from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers_batched_plain  # noqa: E402
from genomeassembler_dev_tpu_torch.sim.reads import n_draws_for  # noqa: E402
from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B, SEQ_LEN = 4, 300
READ_LEN, DBG_K = bench.READ_LEN, bench.DBG_K
MAX_LEN = SEQ_LEN + DBG_K
CASES = ["uniform", "repeats", "n_reads"]


def _per_segment(codes, valid):
    """bench.py:164-187, as bench.py composes it."""
    packed = pack_read_codes(codes, valid)
    ucodes, ucounts, n_u = dedup_with_counts(packed, bench.U_CAP)
    uvalid = jnp.arange(bench.U_CAP, dtype=jnp.int32) < n_u
    kc = unpack_kmer_windows(ucodes, READ_LEN, DBG_K)
    kv = jnp.broadcast_to(uvalid[:, None], kc.shape)
    buf, lens, wvalid, overflow, n_walks, _ = contigs_dense(
        kc, kv, DBG_K, MAX_LEN, bench.MAX_WALKS)
    oc = unpack_kmer_windows(ucodes, READ_LEN, 8)
    counts8 = bincount_mxu(
        oc.reshape(-1), jnp.broadcast_to(uvalid[:, None], oc.shape).reshape(-1), 4**8,
        jnp.broadcast_to(ucounts[:, None], oc.shape).reshape(-1), weight_bits=16)
    return (jnp.where(wvalid, lens, 0).sum(), n_walks, counts8, n_u,
            buf, lens, wvalid, overflow)


_jax_step = jax.jit(jax.vmap(_per_segment))


def read_set(case: str):
    """codes [B, N, 12] uint8 and valid [B, N] of numpy-drawn reads: uniform
    start positions, coverage 40, the 3' overruns invalid; "n_reads" puts an
    N (255) in ~3% of the reads."""
    store = synthetic_segment_store(7, SEQ_LEN, B, repeats=case == "repeats")
    genome = np.stack([encode_dna(s) for s in store.seqs])
    rng = np.random.default_rng(CASES.index(case))
    n = n_draws_for(40.0, SEQ_LEN, READ_LEN)
    pos = rng.integers(0, SEQ_LEN - 8 + 1, (B, n))
    idx = np.minimum(pos[..., None] + np.arange(READ_LEN), SEQ_LEN - 1)
    codes = genome[np.arange(B)[:, None, None], idx]
    if case == "n_reads":
        hit = rng.random((B, n)) < 0.03
        codes[hit, rng.integers(0, READ_LEN, int(hit.sum()))] = 255
    return codes.astype(np.uint8), pos + READ_LEN <= SEQ_LEN


@pytest.fixture(scope="module", params=CASES)
def both(request):
    codes, valid = read_set(request.param)
    jout = [np.asarray(x) for x in _jax_step(jnp.asarray(codes), jnp.asarray(valid))]
    tout = bench.bench_step(torch.from_numpy(codes), torch.from_numpy(valid), MAX_LEN)
    return codes, valid, jout, tout


def test_distinct_reads(both):
    _, _, jout, tout = both
    assert np.array_equal(tout.distinct_reads.numpy(), jout[3])


def test_walks_and_contig_letters(both):
    _, _, jout, tout = both
    assert np.array_equal(tout.walks.numpy(), jout[1])
    assert np.array_equal(tout.contig_chars.numpy(), jout[0])


def test_contig_sets(both):
    _, _, jout, tout = both
    buf, lens, wvalid, overflow = jout[4:]
    want = [j_dedup_contigs(buf[b], lens[b], wvalid[b], overflow[b]) for b in range(B)]
    assert bench.contig_sets(tout, list(range(B))) == want


def test_octamer_counts(both):
    """JAX's float32 weighted counts are exact integers; the port's are the
    plain K2 path's over every counted read's windows."""
    codes, valid, jout, tout = both
    assert tout.counts8.shape == (B, 4**8) and tout.counts8.dtype == torch.int32
    assert np.array_equal(tout.counts8.numpy(), jout[2].astype(np.int64))
    oc, ov = bench.octamer_windows(torch.from_numpy(codes), torch.from_numpy(valid))
    assert oc.shape == (B, valid.shape[1] * (READ_LEN - 8 + 1))
    assert torch.equal(count_kmers_batched_plain(oc, ov, 4**8), tout.counts8)
    assert torch.equal(tout.octamers, tout.counts8.sum(dim=1))


def test_dedup_with_counts_against_numpy():
    codes, valid = read_set("n_reads")
    seg, reads, counts = bench.dedup_with_counts(torch.from_numpy(codes),
                                                 torch.from_numpy(valid))
    shifts = 2 * np.arange(READ_LEN - 1, -1, -1)
    for b in range(B):
        keep = valid[b] & (codes[b] <= 3).all(axis=1)
        want, want_counts = np.unique((codes[b][keep].astype(np.int64) << shifts).sum(1),
                                      return_counts=True)
        m = (seg == b).numpy()
        assert np.array_equal(reads.numpy()[m], want)
        assert np.array_equal(counts.numpy()[m], want_counts)


def test_gates_hold_the_step_to_the_native_engine():
    codes, valid = (torch.from_numpy(a) for a in read_set("repeats"))
    out = bench.bench_step(codes, valid, MAX_LEN)
    assert bench.check_gates(codes, valid, out) == list(range(B))


def test_pair_ratios():
    ratios, median = bench.pair_ratios([0.40, 0.30, 0.50, 0.45, 0.35],
                                       [0.010, 0.012, 0.010, 0.009, 0.014])
    assert ratios == pytest.approx([40.0, 25.0, 50.0, 50.0, 25.0])
    assert median == 40.0
    with pytest.raises(ValueError):
        bench.pair_ratios([1.0], [1.0, 2.0])


TINY = ["--device", "cpu", "--segments", "4", "--seq-len", "300"]


@pytest.mark.parametrize("full", [False, True])
def test_lev_cases_take_their_queries_from_the_batch(monkeypatch, full):
    monkeypatch.delenv("GA_BENCH_FULL", raising=False)
    if full:
        monkeypatch.setenv("GA_BENCH_FULL", "1")
    for n_seg, S in ((4, 4), (1024, 256)):
        (nw, qs, qlen, tgt), (hw, hqs, hqlen, htgt) = bench.lev_cases(n_seg, 300, "cpu")
        assert (nw, hw) == ("NW", "HW")
        assert qs.shape == (S, 1024) and tgt.shape == (300,) and qlen.tolist() == [1024] * S
        S_hw = 2048 if full else S
        assert hqs.shape == (S_hw, 2048) and htgt.shape == (15000,)
        assert hqlen.tolist() == [2048] * S_hw
        assert int(qs.max()) <= 3 and int(htgt.max()) <= 3


def test_cpu_run_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.delenv("GA_BENCH_FULL", raising=False)
    assert bench.main(TINY) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["metric"] == "reads_per_sec_kmer_count_plus_dbg_build"
    assert payload["unit"] == "reads/s" and payload["value"] > 0
    assert payload["device"] == {"platform": "cpu"}
    extras = payload["extras"]
    assert len(extras["ratio_pairs"]) == bench.PAIRS
    assert payload["vs_baseline"] == pytest.approx(float(np.median(extras["ratio_pairs"])))
    assert set(extras) == {
        "cpu_ms_per_batch", "cpp_ms_best", "cpp_ms_range", "ratio_pairs",
        "experiments_per_sec_e2e_cold", "experiments_per_sec_e2e", "cpu_ms_per_batch_b4",
        "lev_nw_gcells_per_sec_4x1024x300", "lev_hw_gcells_per_sec_4x2048x15000",
        "lev_hw_alignments_per_sec_4x2048x15000"}
    assert not any(k.startswith("gpu_") or "pct_of" in k for k in extras)


def test_failed_gate_raises_and_prints_nothing(monkeypatch, capsys):
    count = native.count_kmers_native

    def wrong_counts(reads, k):
        counts = count(reads, k)
        counts[0] += 1
        return counts

    monkeypatch.setattr(bench.native, "count_kmers_native", wrong_counts)
    with pytest.raises(RuntimeError, match="octamer counts != native engine"):
        bench.main(TINY)
    assert capsys.readouterr().out == ""


def test_stops_without_a_card_or_a_cpu_shape(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
    with pytest.raises(SystemExit, match="shape the caller gives"):
        bench.main(["--device", "cpu"])


def test_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\nimport genomeassembler_dev_tpu_torch.bench\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] == 'genomeassembler_dev_tpu']\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
