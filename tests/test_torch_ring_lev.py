"""PyTorch port vs the JAX package: the ring (sequence-parallel)
Levenshtein rings of ops/edit_distance_ring.py, prefix-min and Myers, NW and
HW, at 2 shards (the read axis of a seg 2 x read 2 mesh) and 4 shards, on
four real gloo ranks (one spawn for the module), against JAX's rings on
conftest's virtual CPU devices and against spec.levenshtein. Distances are
integers: exact. The inputs are those of tests/test_ring_lev.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu.ops import edit_distance_ring as jring  # noqa: E402
from genomeassembler_dev_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from genomeassembler_dev_tpu_torch.core.encoding import encode_dna  # noqa: E402
from genomeassembler_dev_tpu_torch.ops import edit_distance_ring as tring  # noqa: E402
from genomeassembler_dev_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from genomeassembler_dev_tpu_torch.spec import reference_semantics as spec  # noqa: E402
from test_torch_spawn import start_ranks  # noqa: E402

SHARDS = (2, 4)
MODES = ("NW", "HW")
RINGS = {"prefix-min": ("make_ring_levenshtein", False),
         "myers": ("make_ring_levenshtein_myers", True)}
MESHES = {2: (2, 2, 1), 4: (1, 4, 1)}  # read axis of n shards


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def case(n_shard):
    """tests/test_ring_lev.py's queries: six random ones up to the padded
    width, a prefix of the target and the target; with an empty one."""
    rng = np.random.default_rng(0)
    target = rand_dna(rng, 75)
    M = 64 * n_shard
    queries = [rand_dna(rng, int(rng.integers(1, M + 1))) for _ in range(6)]
    queries += [target[:50], target, ""]
    qmat = np.zeros((len(queries), M), np.uint8)
    qlen = np.array([len(q) for q in queries], np.int32)
    for i, q in enumerate(queries):
        if q:
            qmat[i, : len(q)] = encode_dna(q)
    return queries, target, qmat, qlen, encode_dna(target)


def _rings(rank):
    out = {}
    for n in SHARDS:
        mesh = make_mesh(*MESHES[n], device_type="cpu")
        _, _, qmat, qlen, tgt = case(n)
        args = [torch.from_numpy(a) for a in (qmat, qlen, tgt)]
        for name, (maker, _) in RINGS.items():
            for mode in MODES:
                out[(name, n, mode)] = getattr(tring, maker)(mesh, "read", mode)(*args).numpy()
        try:  # 48 query columns a shard: not whole 32-bit words
            tring.make_ring_levenshtein_myers(mesh, "read")(
                torch.zeros((2, 48 * n), dtype=torch.uint8), torch.tensor([5, 9]), args[2])
        except ValueError as e:
            out[("myers slice", n)] = str(e)
    one = make_mesh(seg=1, device_type="cpu")  # rank 0 alone: no traffic
    if one.get_coordinate() is not None:
        _, _, qmat, qlen, tgt = case(2)
        out["one shard"] = tring.make_ring_levenshtein_myers(one, "read", "HW")(
            *(torch.from_numpy(a) for a in (qmat, qlen, tgt))).numpy()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The four ranks run while this process compiles JAX's rings."""
    wait = start_ranks(_rings, 4, tmp_path_factory.mktemp("gloo"))
    jax_out = {}
    for n in SHARDS:
        mesh = j_make_mesh(seg=1, read=n, tp=1, devices=jax.devices()[:n])
        _, _, qmat, qlen, tgt = case(n)
        for name, (maker, _) in RINGS.items():
            for mode in MODES:
                fn = getattr(jring, maker)(mesh, axis="read", mode=mode)
                jax_out[(name, n, mode)] = np.asarray(fn(jnp.asarray(qmat), jnp.asarray(qlen),
                                                         jnp.asarray(tgt)))
    return wait(), jax_out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_shard", SHARDS)
@pytest.mark.parametrize("ring", list(RINGS))
def test_ring_vs_jax_and_spec(results, ring, n_shard, mode):
    ranks, jax_out = results
    queries, target, *_ = case(n_shard)
    expect = [spec.levenshtein(q, target, mode=mode) for q in queries]
    want = jax_out[(ring, n_shard, mode)]
    for got in ranks:  # every rank of both rings returns the whole answer
        got = got[(ring, n_shard, mode)]
        assert got.dtype == np.int32
        assert got.tolist() == expect
        np.testing.assert_array_equal(got[:-1], want[:-1])
    # the empty query: JAX's Myers ring returns its distance, JAX's
    # prefix-min ring 2^28 (ROADMAP Queue 3); the port's both the distance
    assert want[-1] == (expect[-1] if RINGS[ring][1] else 1 << 28)


def test_myers_ring_needs_whole_words(results):
    ranks, _ = results
    for got in ranks:
        for n in SHARDS:
            assert "local query slice 48 not a multiple of 32" in got[("myers slice", n)]


def test_one_shard_runs_without_traffic(results):
    ranks, _ = results
    queries, target, *_ = case(2)
    assert ranks[0]["one shard"].tolist() == [spec.levenshtein(q, target, "HW") for q in queries]
    assert all("one shard" not in r for r in ranks[1:])
