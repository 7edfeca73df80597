"""PyTorch port vs the JAX package: the parallel layer (parallel/mesh.py,
sharding.py, table_sharding.py, scaling.py), the batched runner's mesh and
`cli bench-scaling`, on four real gloo ranks (one spawn for the module; see
tests/test_torch_spawn.py). The JAX side runs in this process on conftest's
virtual CPU devices. Inputs come from numpy seeds; simulated reads are
compared given identical read sets (the port's reads through JAX's k-mer
counter). Integers exact; sharded float scores within rtol 2e-5 of the
unsharded JAX functions; the train step at the tolerances of
tests/test_torch_models.py."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.models import breakage_model as jbm  # noqa: E402
from genomeassembler_dev_tpu.ops.edit_distance import batched_levenshtein  # noqa: E402
from genomeassembler_dev_tpu.ops.histogram import count_kmers  # noqa: E402
from genomeassembler_dev_tpu.ops.ks import batched_ks_2samp  # noqa: E402
from genomeassembler_dev_tpu.ops.windows import kmer_window_codes  # noqa: E402
from genomeassembler_dev_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from genomeassembler_dev_tpu.parallel.table_sharding import (  # noqa: E402
    make_sharded_table_lookup as j_lookup)
from genomeassembler_dev_tpu.score.breakscore import breakscore as j_breakscore  # noqa: E402
from genomeassembler_dev_tpu_torch import cli  # noqa: E402
from genomeassembler_dev_tpu_torch.core.querytable import QueryTable  # noqa: E402
from genomeassembler_dev_tpu_torch.merge import native  # noqa: E402
from genomeassembler_dev_tpu_torch.models import breakage_model as tbm  # noqa: E402
from genomeassembler_dev_tpu_torch.parallel import sharding  # noqa: E402
from genomeassembler_dev_tpu_torch.parallel.mesh import (  # noqa: E402
    AXES, axis_index, axis_size, gather, make_mesh)
from genomeassembler_dev_tpu_torch.parallel.scaling import measure_scaling  # noqa: E402
from genomeassembler_dev_tpu_torch.parallel.table_sharding import (  # noqa: E402
    make_sharded_table_lookup)
from genomeassembler_dev_tpu_torch.pipeline.assembler import RESULT_COLUMNS  # noqa: E402
from genomeassembler_dev_tpu_torch.pipeline.batch_runner import (  # noqa: E402
    run_experiments_batched)
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig  # noqa: E402
from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store  # noqa: E402
from test_torch_models import assert_grads_close, jax_params  # noqa: E402
from test_torch_spawn import run_ranks  # noqa: E402

WORLD = 4
RTOL = 2e-5
SIM = dict(read_len=12, n_draws=64, count_k=4)
BS_MESHES = ((1, 2, 2), (2, 1, 2))
LOOKUP_SHARDS = (2, 4)
TRAIN_STEPS = 3
RUNNER = dict(seq_len=300, coverage_target=15.0, kmer=8, seed=1234, n_orderings=200,
              read_len=12, dbg_kmer=9)
SCALING = ["bench-scaling", "--device", "cpu", "--devices", "1,2,4", "--seq-len", "200",
           "--draws-per-segment", "32", "--segments-per-device", "1"]


def make_inputs(table8: np.ndarray, table_combined: np.ndarray) -> dict:
    rng = np.random.default_rng(0)
    inp = {"genomes": rng.integers(0, 4, (4, 256)).astype(np.uint8),
           "seeds": np.arange(4, dtype=np.int32), "probs8": table8.astype(np.float32),
           "combined": table_combined.astype(np.float32)}
    # breakscore: reads are slices of the paths (the shape of tests/test_parallel.py)
    B, S, L, U, R = 2, 3, 64, 8, 12
    paths = rng.integers(0, 4, size=(B, S, L)).astype(np.uint8)
    rcodes = np.zeros((B, U, R), np.uint8)
    for b in range(B):
        for u in range(U):
            s, st = int(rng.integers(0, S)), int(rng.integers(0, L - R))
            rcodes[b, u] = paths[b, s, st : st + R]
    plens = np.full((B, S), L, np.int32)
    plens[1, 2] = 40  # a shorter solution
    inp["bs"] = (paths, plens, rcodes, rng.integers(1, 4, (B, U)).astype(np.int32),
                 np.array([[True] * U, [True] * (U - 2) + [False] * 2]))
    # KS and Levenshtein over seg 4
    B, S, L, W = 4, 5, 96, 60
    inp["pm"] = rng.integers(0, 4, size=(B, S, L)).astype(np.uint8)
    inp["pl"] = rng.integers(L // 2, L + 1, size=(B, S)).astype(np.int32)
    inp["gm"] = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    inp["pf"] = rng.random((B, S, 200)).astype(np.float32)
    inp["pf"][1, 3] = np.nan  # a solution with no break
    inp["tracks"] = rng.random((B, W)).astype(np.float32)
    # the table lookup: the codes of tests/test_table_sharding.py
    inp["lookup"] = {n: rng.integers(0, 65536, size=(3, 8 * n)).astype(np.int32)
                     for n in LOOKUP_SHARDS}
    inp["train"] = [(c, np.log(table8[c].astype(np.float32)))
                    for c in (rng.integers(0, 65536, 256).astype(np.int32)
                              for _ in range(TRAIN_STEPS))]
    inp["params"] = jax_params()
    inp["segments"] = list(synthetic_segment_store(11, 300, 4).seqs)
    return inp


def _cases(rank, inp):
    t = {k: torch.from_numpy(v) for k, v in inp.items() if isinstance(v, np.ndarray)}
    out = {}
    m = make_mesh(seg=2, read=2, tp=1, device_type="cpu")
    out["coords"] = [axis_index(m, a) for a in AXES]
    out["mesh read 2"] = [axis_size(make_mesh(read=2, device_type="cpu"), a) for a in AXES]
    out["subset coordinate"] = make_mesh(seg=2, device_type="cpu").get_coordinate()

    step = sharding.make_sim_count_step(m, **SIM)
    out["sim_count"] = gather(step(t["genomes"], t["seeds"], t["probs8"]), m).numpy()
    with pytest.raises(ValueError, match="not divisible by read"):
        sharding.make_sim_count_step(m, SIM["read_len"], 63, SIM["count_k"])

    bs_in = [torch.from_numpy(a) for a in inp["bs"]]
    for shape in BS_MESHES:
        mm = make_mesh(*shape, device_type="cpu")
        res = sharding.make_breakscore_step(mm)(*bs_in, t["combined"])
        out[("bs", shape)] = {k: gather(v, mm).numpy() for k, v in res.items()}

    m4 = make_mesh(seg=4, device_type="cpu")
    out["ks"] = gather(sharding.make_ks_step(m4)(t["pf"], t["tracks"]), m4).numpy()
    out["lev"] = gather(sharding.make_lev_step(m4)(t["pm"], t["pl"], t["gm"]), m4).numpy()

    mt = make_mesh(seg=2, read=1, tp=2, device_type="cpu")
    local = sharding.shard_params(mt, tbm.params_from_numpy(inp["params"], "cpu"))
    train = sharding.make_sharded_train_step(mt, tbm.adam(local, 1e-3))
    losses, grads = [], None
    for codes, target in inp["train"]:
        losses.append(float(train(local, torch.from_numpy(codes), torch.from_numpy(target))))
        if grads is None:
            grads = {n: (getattr(local, n).grad if dim is None else
                         gather(getattr(local, n).grad, mt, "tp", dim)).numpy()
                     for n, dim in sharding.TP_DIMS.items()}
    feats = tbm.one_hot_octamer(torch.from_numpy(inp["train"][0][0])).requires_grad_()
    sharding.sharded_forward(mt, local, feats).sum().backward()
    out["train"] = {"losses": losses, "grads": grads, "feats_grad": feats.grad.numpy(),
                    "params": tbm.params_to_numpy(sharding.unshard_params(mt, local))}

    for n in LOOKUP_SHARDS:
        mm = make_mesh(seg=WORLD // n, tp=n, device_type="cpu")
        probs, overflow = make_sharded_table_lookup(mm, 65536)(
            torch.from_numpy(inp["lookup"][n]), t["probs8"])
        out[("lookup", n)] = (gather(probs, mm, "tp", dim=1).numpy(), int(overflow))
    mm = make_mesh(tp=4, device_type="cpu")
    probs, overflow = make_sharded_table_lookup(mm, 65536, cap=2)(
        torch.zeros((1, 32), dtype=torch.int32), t["probs8"][block_rows(mm)])
    out["skewed"] = (gather(probs, mm, "tp", dim=1).numpy(), int(overflow))

    table = QueryTable.from_numpy(inp["probs"], "cpu")
    res = run_experiments_batched(ExperimentConfig(**RUNNER), inp["segments"], "cpu", table,
                                  score_group=2, mesh=m)
    out["runner"] = [(r.columns, r.stats) for r in res]
    try:
        run_experiments_batched(ExperimentConfig(**RUNNER), inp["segments"], "cpu", table,
                                mesh=make_mesh(seg=3, device_type="cpu"))
    except ValueError as e:
        out["seg 3"] = str(e)

    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(SCALING)
    out["bench-scaling"] = buf.getvalue()
    out["scaling points"] = measure_scaling(inp["genomes"], inp["probs8"], 12, 32, [1, 2],
                                            "cpu", count_k=4, reps=1)
    return out


def block_rows(mesh):
    """This rank's rows of the 65,536-row table over tp (the shard form)."""
    n = axis_size(mesh, "tp")
    i = axis_index(mesh, "tp")
    return slice(i * 65536 // n, (i + 1) * 65536 // n)


@pytest.fixture(scope="module")
def jtable():
    return load_default_query_table()


@pytest.fixture(scope="module")
def inputs(jtable):
    inp = make_inputs(jtable.probs[8], jtable.combined)
    inp["probs"] = {k: np.asarray(jtable.probs[k]) for k in (2, 4, 6, 8)}
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    native._load()  # built once here, not by four ranks at once
    return run_ranks(_cases, WORLD, tmp_path_factory.mktemp("gloo"), inputs)


def test_mesh_shapes(ranks):
    assert [r["coords"] for r in ranks] == [[0, 0, 0], [0, 1, 0], [1, 0, 0], [1, 1, 0]]
    assert all(r["mesh read 2"] == [2, 2, 1] for r in ranks)
    # a mesh over the first two ranks: the others are outside it
    assert [r["subset coordinate"] for r in ranks] == [(0, 0, 0), (1, 0, 0), None, None]
    assert j_make_mesh(seg=2, read=2, tp=1).shape == {"seg": 2, "read": 2, "tp": 1}


def test_sim_count_given_identical_read_sets(ranks, inputs):
    """Counts summed over the read shards equal JAX's counter on the same
    reads, which each (segment, read shard) draws from its own seed."""
    k = SIM["count_k"]
    want = np.zeros((4, 4**k), np.int64)
    for r in range(2):
        rs = sharding.simulate_read_shard(
            torch.from_numpy(inputs["genomes"]), torch.from_numpy(inputs["seeds"]),
            torch.from_numpy(inputs["probs8"]), SIM["read_len"], SIM["n_draws"] // 2, r)
        for b in range(4):
            codes, valid = kmer_window_codes(jnp.asarray(rs.codes[b].numpy()), k)
            valid = valid & jnp.asarray(rs.valid[b].numpy())[:, None]
            want[b] += np.asarray(count_kmers(codes, valid, 4**k))
    for got in ranks:
        assert got["sim_count"].dtype == np.int32
        np.testing.assert_array_equal(got["sim_count"], want)
    assert (want.sum(axis=1) > 0).all()
    # the two read shards draw different reads
    a, b = (sharding.simulate_read_shard(torch.from_numpy(inputs["genomes"][:1]),
                                         torch.tensor([0]), torch.from_numpy(inputs["probs8"]),
                                         12, 32, r).positions for r in (0, 1))
    assert not torch.equal(a, b)


@pytest.mark.parametrize("shape", BS_MESHES)
def test_breakscore_step_vs_unsharded_jax(ranks, inputs, shape):
    paths, plens, rcodes, rcounts, rvalid = inputs["bs"]
    probs = jnp.asarray(inputs["combined"])
    for got in (r[("bs", shape)] for r in ranks):
        for b in range(paths.shape[0]):
            want = j_breakscore(jnp.asarray(paths[b]), jnp.asarray(plens[b]),
                                jnp.asarray(rcodes[b]), jnp.asarray(rcounts[b]),
                                jnp.asarray(rvalid[b]), probs, read_chunk=128)
            for name in ("bp_score", "bp_score_norm_by_break_freqs", "bp_score_norm_by_len",
                         "path_freq", "site_counts"):
                np.testing.assert_allclose(got[name][b], np.asarray(getattr(want, name)),
                                           rtol=RTOL, atol=0, equal_nan=True, err_msg=name)
            np.testing.assert_array_equal(got["kmer_breaks"][b], np.asarray(want.kmer_breaks))
            assert got["kmer_breaks"].dtype == np.int32


def test_ks_and_lev_steps_vs_jax(ranks, inputs):
    for got in ranks:
        for b in range(4):
            want = np.asarray(batched_ks_2samp(jnp.asarray(inputs["pf"][b]),
                                               jnp.asarray(inputs["tracks"][b])))
            np.testing.assert_allclose(got["ks"][b], want, atol=1e-6, rtol=0, equal_nan=True)
            np.testing.assert_array_equal(got["lev"][b], np.asarray(batched_levenshtein(
                jnp.asarray(inputs["pm"][b]), jnp.asarray(inputs["pl"][b]),
                jnp.asarray(inputs["gm"][b]), mode="NW")))
        assert np.isnan(got["ks"][1, 3])


def test_dp_tp_train_step_vs_unsharded_jax(ranks, inputs):
    p = inputs["params"]
    opt = optax.adam(1e-3)
    jstep = jbm.make_train_step(opt)
    params = {k: jnp.asarray(v) for k, v in p.items()}
    state = opt.init(params)
    codes0, target0 = (jnp.asarray(a) for a in inputs["train"][0])
    jgrads = jax.grad(jbm.loss_fn)(params, codes0, target0)
    jlosses = []
    for codes, target in inputs["train"]:
        params, state, loss = jstep(params, state, jnp.asarray(codes), jnp.asarray(target))
        jlosses.append(float(loss))
    for got in (r["train"] for r in ranks):
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, atol=0)
        assert_grads_close(got["grads"], {n: np.asarray(g) for n, g in jgrads.items()})
        for n in tbm.PARAM_NAMES:
            np.testing.assert_allclose(got["params"][n], np.asarray(params[n]), atol=1e-5,
                                       rtol=0, err_msg=n)
        # the sharded forward's input gradient equals the unsharded model's
        # on the trained parameters, up to rounding: it sums the tp ranks'
        # bf16-rounded partial gradients, each within 2^-9 of its value
        feats = tbm.one_hot_octamer(torch.from_numpy(inputs["train"][0][0])).requires_grad_()
        tbm.forward(tbm.params_from_numpy(got["params"], "cpu"), feats).sum().backward()
        want = feats.grad.numpy()
        np.testing.assert_allclose(got["feats_grad"], want, rtol=0,
                                   atol=2.0**-8 * np.abs(want).max())


@pytest.mark.parametrize("n_shard", LOOKUP_SHARDS)
def test_table_lookup_vs_direct_gather(ranks, inputs, n_shard):
    """The direct gather is what tests/test_table_sharding.py holds JAX's
    lookup to on the same cases."""
    codes = inputs["lookup"][n_shard]
    for got in ranks:
        probs, overflow = got[("lookup", n_shard)]
        assert overflow == 0
        np.testing.assert_array_equal(probs, inputs["probs8"][codes])


def test_table_lookup_skewed_overflow(ranks, inputs):
    """Every code routes to shard 0 with 2 slots a bucket: JAX's overflow
    count, and NaN at the same (stable-order) positions."""
    jprobs, joverflow = j_lookup(j_make_mesh(seg=1, read=1, tp=4), 65536, cap=2)(
        jnp.zeros((1, 32), jnp.int32), jnp.asarray(inputs["probs8"]))
    for got in ranks:
        probs, overflow = got["skewed"]
        assert overflow == int(joverflow) > 0
        np.testing.assert_array_equal(np.isnan(probs), np.isnan(np.asarray(jprobs)))
        np.testing.assert_array_equal(probs[~np.isnan(probs)], inputs["probs8"][0])


def test_batched_runner_mesh_equals_no_mesh(ranks, inputs):
    """seg 2 x read 2: each rank runs its two segments, scoring through the
    read-sharded breakscore step, and returns all four results."""
    table = QueryTable.from_numpy(inputs["probs"], "cpu")
    want = run_experiments_batched(ExperimentConfig(**RUNNER), inputs["segments"], "cpu", table,
                                   score_group=2)
    for got in (r["runner"] for r in ranks):
        assert len(got) == len(want) == 4
        for (cols, stats), w in zip(got, want):
            assert list(cols) == RESULT_COLUMNS and stats == w.stats
            assert cols["sequence"] == w.columns["sequence"]
            for name in RESULT_COLUMNS[1:]:
                a, b = np.asarray(cols[name]), np.asarray(w.columns[name])
                if name in ("sequence_len", "kmer_breaks", "lev_dist_vs_true"):
                    np.testing.assert_array_equal(a, b, err_msg=name)
                else:
                    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, equal_nan=True,
                                               err_msg=name)


def test_runner_mesh_refuses_a_batch_seg_does_not_divide(ranks):
    msgs = [r["seg 3"] for r in ranks]
    assert all("not divisible by the seg axis" in m for m in msgs[:3])
    assert "not in the mesh" in msgs[3]


def test_bench_scaling_on_four_ranks(ranks):
    out = [r["bench-scaling"] for r in ranks]
    assert all(o == "" for o in out[1:])  # rank 0 prints
    pts = json.loads(out[0].strip())
    assert [p["devices"] for p in pts] == [1, 2, 4] and pts[0]["efficiency"] == 1.0
    assert all(p["reads_per_s"] > 0 and p["efficiency"] > 0 for p in pts)
    points = [r["scaling points"] for r in ranks]
    assert all(p == points[0] for p in points)  # every rank returns rank 0's points
    assert [p.n_devices for p in points[0]] == [1, 2]


def test_cli_bench_scaling_sets_up_its_own_group(capsys):
    cli.main(["bench-scaling", "--device", "cpu", "--devices", "1", "--seq-len", "200",
              "--draws-per-segment", "32", "--segments-per-device", "2"])
    pts = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [p["devices"] for p in pts] == [1] and pts[0]["efficiency"] == 1.0
    assert not torch.distributed.is_initialized()
