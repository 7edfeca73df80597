"""PyTorch port vs the JAX package: the device ensemble merge
(merge/device.py: its hash arrays, its chain state and its solutions, on
identical permutations), the ordering replay (core/rng.py), the spec merge,
the crossover table and the engine's four backends. The cases are those of
tests/test_merge_device.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu.core import rng as jrng  # noqa: E402
from genomeassembler_dev_tpu.merge import device as jdev  # noqa: E402
from genomeassembler_dev_tpu.merge import engine as jengine  # noqa: E402
from genomeassembler_dev_tpu.spec import reference_semantics as jspec  # noqa: E402
from genomeassembler_dev_tpu_torch.core import rng as trng  # noqa: E402
from genomeassembler_dev_tpu_torch.merge import device as tdev  # noqa: E402
from genomeassembler_dev_tpu_torch.merge import engine as tengine  # noqa: E402
from genomeassembler_dev_tpu_torch.merge.native import assemble_native  # noqa: E402
from genomeassembler_dev_tpu_torch.spec import reference_semantics as tspec  # noqa: E402


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def random_contigs(seed):
    rng = np.random.default_rng(seed)
    g = rand_dna(rng, 160)
    reads = [g[i : i + 15] for i in range(0, 146, 4)] + [g[-15:]]
    return jspec.get_contig_set([r[i : i + 7] for r in reads for i in range(len(r) - 6)], 7)


def dbg9_contigs():
    rng = np.random.default_rng(42)
    g = rand_dna(rng, 400)
    reads = [g[i : i + 12] for i in range(0, 389, 2)] + [g[-12:]]
    return jspec.get_contig_set([r[i : i + 9] for r in reads for i in range(4)], 9)


def c64_contigs():
    """The crossover shape: 64 tiles of 24 bases, half with a random tail."""
    rng = np.random.default_rng(7)
    base = rand_dna(rng, 1200)
    contigs, seen = [], set()
    for i in range(0, 1152, 18):
        s = base[i : i + 24]
        if rng.random() < 0.5:
            s = s[:12] + rand_dna(rng, 12)
        if s not in seen:
            seen.add(s)
            contigs.append(s)
    return contigs[:64]


def duplicate_heavy_contigs():
    """Duplicates whose suffix_k equals their prefix_k, so the equality
    guard gates merges, beside mergeable neighbours."""
    rng = np.random.default_rng(0)
    cap = "ACGTC"
    dup = cap + rand_dna(rng, 20) + cap
    other = [rand_dna(rng, 30) for _ in range(4)]
    return [dup, other[0], dup, other[1], dup, other[2], other[3]]


def c128_contigs():
    """128 overlapping 30-base tiles of a segment with a planted repeat."""
    rng = np.random.default_rng(3)
    seg = rand_dna(rng, 1500)
    seg = seg[:400] + seg[100:300] + seg[400:]
    contigs, seen = [], set()
    step = (len(seg) - 30) // 128
    for lo in range(0, len(seg) - 30, step):
        s = seg[lo : lo + 30]
        if s not in seen:
            seen.add(s)
            contigs.append(s)
    return contigs[:128]


# (contigs, dbg_kmer, seed, n_orderings): every case of tests/test_merge_device.py
CASES = {
    "simple_overlap": (lambda: ["AACGTACGG", "ACGGTTTAA"], 5, 1234, 20),
    "random_seed0": (lambda: random_contigs(0), 7, 1, 150),
    "random_seed3": (lambda: random_contigs(3), 7, 4, 150),
    "random_seed8": (lambda: random_contigs(8), 7, 9, 150),
    "duplicate_free_guard": (lambda: ["ACACAC", "CACACA"], 5, 1, 30),
    "single_contig": (lambda: ["ACGTACGT"], 5, 1234, 10),
    "chain_of_many": (lambda: ["TTAACG", "ACGGGT", "GGTCCA", "CCATTG", "TTGAAA"], 4, 7, 60),
    "dbg9_scale": (dbg9_contigs, 9, 1234, 100),
    "crossover_c64": (c64_contigs, 9, 1234, 48),
    "duplicate_heavy": (duplicate_heavy_contigs, 6, 1234, 50),
    "c128": (c128_contigs, 9, 11, 200),
}


@pytest.mark.parametrize("name", list(CASES))
def test_device_merge_vs_jax(name):
    """The hash arrays, the final chain state (alive, next, trim, eqflag) on
    identical permutations, and the solutions with the host fallback count."""
    make, k, seed, n = CASES[name]
    contigs = make()
    if len(contigs) >= 2:
        jarr = jdev._hash_arrays(contigs)
        tarr = tdev._hash_arrays(contigs)
        for a, b in zip(tarr, jarr):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        perms = jrng.shuffle_orderings(len(contigs), n, seed)
        jstate = [np.asarray(x) for x in jdev._merge_kernel(
            jnp.asarray(perms), *(jnp.asarray(a) for a in jarr), k)]
        tstate = [x.numpy() for x in tdev._merge_kernel(
            torch.from_numpy(perms).long(),
            *(torch.from_numpy(a.astype(np.int64)) for a in tarr), k)]
        for field, a, b in zip(("alive", "next", "trim", "eqflag"), tstate, jstate):
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=field)
    got = tdev.assemble_device(contigs, k, seed, n, "cpu")
    assert got == jdev.assemble_device(contigs, k, seed, n)
    if len(contigs) >= 2:
        assert tdev.assemble_device.last_n_fallback == jdev.assemble_device.last_n_fallback
    assert got == assemble_native(contigs, k, seed, n)
    if name == "duplicate_heavy":
        assert tdev.assemble_device.last_n_fallback > 0  # the guard engaged


@pytest.mark.parametrize("n_items,n_orderings,seed", [(1, 3, 0), (2, 5, 1234), (7, 40, 9),
                                                       (64, 20, 1234), (129, 3, 11)])
def test_shuffle_orderings_vs_jax(n_items, n_orderings, seed):
    np.testing.assert_array_equal(trng.shuffle_orderings(n_items, n_orderings, seed),
                                  jrng.shuffle_orderings(n_items, n_orderings, seed))
    eng_t, eng_j = trng.MT19937(seed), jrng.MT19937(seed)
    assert [eng_t.next_u32() for _ in range(700)] == [eng_j.next_u32() for _ in range(700)]


def test_spec_merge_vs_jax():
    contigs = random_contigs(3)
    assert tspec.shuffled_orderings(contigs, 5, 30) == jspec.shuffled_orderings(contigs, 5, 30)
    orderings = jspec.shuffled_orderings(contigs, 5, 30)
    for o in orderings[:5]:
        assert tspec.merge_one_ordering(o, 7) == jspec.merge_one_ordering(o, 7)
    assert tspec.assemble_solutions(orderings, 7) == jspec.assemble_solutions(orderings, 7)


def test_preferred_backend_vs_jax():
    for c in (0, 1, 8, 31, 32, 63, 64, 127, 128, 500):
        for o in (1, 1000, 9999, 10000, 20000):
            for native_ok in (True, False):
                for acc in (True, False):
                    assert (tengine.preferred_backend(c, o, native_ok, acc)
                            == jengine.preferred_backend(c, o, native_ok, acc))


@pytest.mark.parametrize("name", ["chain_of_many", "crossover_c64"])
def test_engine_backends_agree(name):
    """native, device, spec and auto give one solution list; auto asks for
    the device merge only on CUDA."""
    make, k, seed, n = CASES[name]
    contigs = make()
    want = tengine.assemble_solutions(contigs, k, seed, n, backend="spec")
    for backend in ("native", "device", "auto"):
        assert tengine.assemble_solutions(contigs, k, seed, n, backend=backend,
                                          device="cpu") == want, backend
    assert tengine.assemble_solutions(contigs, k, seed, n) == want  # default: host
    with pytest.raises(ValueError, match="unknown backend"):
        tengine.assemble_solutions(contigs, k, seed, n, backend="gpu")
    assert tengine.preferred_backend(len(contigs), 10000, True, False) == "native"


@pytest.mark.parametrize("dbg_kmer", [17, 18, 37])
def test_auto_keeps_long_overlaps_off_the_device_merge(dbg_kmer, monkeypatch):
    """The device merge packs 16 bases at a contig's ends, so it takes
    dbg_kmer up to 17 and raises above; on CUDA, auto sends a larger
    dbg_kmer (the velvet grid's rows 25:19 and 40:37, with 128 unitigs and
    more on repeat segments) to the native engine."""
    rng = np.random.default_rng(dbg_kmer)
    seg = "".join(rng.choice(list("ACGT"), 600))
    contigs = [seg[lo : lo + 60] for lo in range(0, 540, 60 - (dbg_kmer - 1))]
    asked = []

    def spy(n_contigs, n_orderings, native_ok, accelerator_ok):
        asked.append(accelerator_ok)
        return "native"

    monkeypatch.setattr(tengine, "preferred_backend", spy)
    got = tengine.assemble_solutions(contigs, dbg_kmer, 3, 40, device="cuda")
    assert asked == [dbg_kmer <= 17]
    assert got == tengine.assemble_solutions(contigs, dbg_kmer, 3, 40, backend="spec")
    if dbg_kmer > 17:
        with pytest.raises(ValueError, match="dbg_kmer <= 17"):
            tengine.assemble_solutions(contigs, dbg_kmer, 3, 40, backend="device", device="cpu")
    else:
        assert tengine.assemble_solutions(contigs, dbg_kmer, 3, 40, backend="device",
                                          device="cpu") == got
