"""PyTorch port vs the JAX package: windows, matcher, breakscore, KS,
k-mer histograms and Levenshtein, on identical numpy-made inputs. Integer outputs must agree
exactly; float outputs within rtol 2e-5 (the JAX float32 tolerance)."""

import functools
import glob
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from genomeassembler_dev_tpu.core.encoding import encode_dna  # noqa: E402
from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.ops import histogram as jhist  # noqa: E402
from genomeassembler_dev_tpu.ops import ks as jks  # noqa: E402
from genomeassembler_dev_tpu.ops import match as jmatch  # noqa: E402
from genomeassembler_dev_tpu.ops import windows as jwin  # noqa: E402
from genomeassembler_dev_tpu.ops.edit_distance import (  # noqa: E402
    batched_levenshtein as j_lev)
from genomeassembler_dev_tpu.ops.mxu import count_kmers_mxu  # noqa: E402
from genomeassembler_dev_tpu.ops.pallas.edit_distance_kernel import (  # noqa: E402
    batched_levenshtein_pallas as j_prefix_min)
from genomeassembler_dev_tpu.ops.pallas.histogram_kernel import (  # noqa: E402
    count_kmers_mxu_pallas)
from genomeassembler_dev_tpu.ops.pallas.myers_kernel import (  # noqa: E402
    batched_levenshtein_myers as j_myers)
from genomeassembler_dev_tpu.score.breakscore import breakscore as j_breakscore  # noqa: E402
from genomeassembler_dev_tpu.spec import reference_semantics as spec  # noqa: E402
from genomeassembler_dev_tpu_torch.ops import cuda_build  # noqa: E402
from genomeassembler_dev_tpu_torch.ops import histogram as thist  # noqa: E402
from genomeassembler_dev_tpu_torch.ops import ks as tks  # noqa: E402
from genomeassembler_dev_tpu_torch.ops import windows as twin  # noqa: E402
from genomeassembler_dev_tpu_torch.ops.edit_distance import (  # noqa: E402
    batched_levenshtein as t_lev, batched_levenshtein_auto as t_lev_auto)
from genomeassembler_dev_tpu_torch.ops.match import find_first_match as t_match  # noqa: E402
from genomeassembler_dev_tpu_torch.ops.myers import (  # noqa: E402
    MAX_LANES, PEQ_CODES, batched_levenshtein_myers, launch_plan)
from genomeassembler_dev_tpu_torch.ops import prefix_min as tpm  # noqa: E402
from genomeassembler_dev_tpu_torch.ops.prefix_min import (  # noqa: E402
    batched_levenshtein_prefix_min)
from genomeassembler_dev_tpu_torch.pipeline import evaluate  # noqa: E402
from genomeassembler_dev_tpu_torch.score.breakscore import breakscore as t_breakscore  # noqa: E402
from genomeassembler_dev_tpu_torch.utils import profiling  # noqa: E402

RTOL = 2e-5


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def pack(strings, L=None, pad=255):
    L = L or max(len(s) for s in strings)
    mat = np.full((len(strings), L), pad, np.uint8)
    for i, s in enumerate(strings):
        if s:
            mat[i, : len(s)] = encode_dna(s)
    return mat, np.array([len(s) for s in strings], np.int32)


class TestWindows:
    @pytest.mark.parametrize("k,dtype", [(3, torch.int32), (8, torch.int32),
                                         (12, torch.int32), (9, torch.int64)])
    def test_window_codes_and_masks(self, k, dtype):
        rng = np.random.default_rng(k)
        codes = rng.integers(0, 4, (3, 40)).astype(np.uint8)
        codes[0, 5] = codes[2, 30] = 255  # invalid bases
        jc, jv = jwin.kmer_window_codes(jnp.asarray(codes), k)
        tc, tv = twin.kmer_window_codes(torch.from_numpy(codes), k, dtype=dtype)
        assert tc.dtype == dtype
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    def test_pack_words(self):
        rng = np.random.default_rng(3)
        codes = rng.integers(0, 4, (4, 37)).astype(np.uint8)
        expect = np.asarray(jwin.pack_words(jnp.asarray(codes))).astype(np.int64)
        np.testing.assert_array_equal(twin.pack_words(torch.from_numpy(codes)).numpy(),
                                      expect)


def adversarial_match_inputs(rng, read_len):
    """Padded paths, an all-T stretch, duplicate reads, invalid read slots.
    Reads longer than the 50-120-base paths (config 1's 150 bases) get paths
    of 200-400 bases and a stretch of 170 Ts."""
    lo, hi, run = (50, 120, 40) if read_len <= 47 else (200, 401, 170)
    paths = [rand_dna(rng, int(rng.integers(lo, hi))) for _ in range(5)]
    paths[0] = paths[0][:10] + "T" * run + paths[0][10 + run:]
    reads = []
    for _ in range(24):
        r = rng.random()
        if r < 0.5:
            p = paths[int(rng.integers(len(paths)))]
            start = int(rng.integers(0, len(p) - read_len + 1))
            reads.append(p[start : start + read_len])
        elif r < 0.7:
            reads.append("T" * read_len)
        else:
            reads.append(rand_dna(rng, read_len))
    reads += reads[:4]
    pmat, plen = pack(paths, max(len(p) for p in paths) + 17)
    rmat = np.stack([encode_dna(r) for r in reads])
    rvalid = np.ones(len(reads), bool)
    rvalid[3] = rvalid[10] = False
    return pmat, plen, rmat, rvalid


class TestMatch:
    @pytest.mark.parametrize("read_len", [12, 16, 31, 32, 40, 47, 150, 155])
    def test_vs_grid_and_sorted(self, read_len):
        """One int64 key up to 31 bases, jointly ranked word tuples above:
        up to five words (150 bases), and a short fifth (155)."""
        rng = np.random.default_rng(11 + read_len)
        args = adversarial_match_inputs(rng, read_len)
        tf, tp = t_match(*(torch.from_numpy(a) for a in args))
        tf, tp = tf.numpy(), tp.numpy()
        for fn in (jmatch.find_first_match, jmatch.find_first_match_sorted):
            jf, jp = (np.asarray(x) for x in fn(*(jnp.asarray(a) for a in args)))
            np.testing.assert_array_equal(tf, jf, err_msg=fn.__name__)
            np.testing.assert_array_equal(tp, np.where(jf, jp, 0), err_msg=fn.__name__)
        assert tf.any() and not tf.all()


class TestBreakscore:
    def test_vs_jax(self):
        rng = np.random.default_rng(5)
        seg = rand_dna(rng, 160)
        paths = [seg[i:] for i in (0, 1, 2, 3, 7)] + [rand_dna(rng, 90), seg[:60]]
        reads = [seg[p : p + 12] for p in rng.integers(0, 149, 120)]
        reads += [rand_dna(rng, 12) for _ in range(5)]  # mostly unmatched
        uniq, counts = np.unique(np.stack([encode_dna(r) for r in reads]), axis=0,
                                 return_counts=True)
        pmat, plen = pack(paths + [""], 256)  # one pad row with length 0
        rvalid = np.ones(len(uniq), bool)
        rvalid[-1] = False
        probs = np.asarray(load_default_query_table().combined, np.float32)
        args = (pmat, plen, uniq.astype(np.uint8), counts.astype(np.int32), rvalid, probs)
        j = j_breakscore(*(jnp.asarray(a) for a in args), break_kmer=8)
        t = t_breakscore(*(torch.from_numpy(a) for a in args), break_kmer=8)
        np.testing.assert_array_equal(t.kmer_breaks.numpy(), np.asarray(j.kmer_breaks))
        np.testing.assert_array_equal(t.site_counts.numpy(), np.asarray(j.site_counts))
        for name in ("bp_score", "bp_score_norm_by_break_freqs", "bp_score_norm_by_len",
                     "path_freq"):
            np.testing.assert_allclose(getattr(t, name).numpy(),
                                       np.asarray(getattr(j, name)), rtol=RTOL,
                                       err_msg=name)
        assert np.isnan(t.path_freq.numpy()[-1]).all()  # the pad row


class TestKS:
    def _inputs(self):
        rng = np.random.default_rng(7)
        y = rng.random(97).astype(np.float32)
        xs = rng.random((5, 200)).astype(np.float32)
        xs[1, :150] = 0.0  # heavy ties, as real path_freq rows
        xs[2, :50] = y[:50]  # ties across the two samples
        return xs, y

    def test_unmasked_with_nan_row(self):
        xs, y = self._inputs()
        xs[3, 4] = np.nan
        j = np.asarray(jks.batched_ks_2samp(jnp.asarray(xs), jnp.asarray(y)))
        t = tks.batched_ks_2samp(torch.from_numpy(xs), torch.from_numpy(y)).numpy()
        assert np.isnan(t[3]) and np.isnan(j[3])
        np.testing.assert_allclose(t, j, rtol=RTOL)

    def test_masked(self):
        xs, y = self._inputs()
        valid = np.random.default_rng(8).random(xs.shape) < 0.6
        valid[4] = False  # no valid entries: NaN
        j = np.asarray(jks.batched_ks_2samp_masked(jnp.asarray(xs), jnp.asarray(valid),
                                                   jnp.asarray(y)))
        t = tks.batched_ks_2samp_masked(torch.from_numpy(xs), torch.from_numpy(valid),
                                        torch.from_numpy(y)).numpy()
        assert np.isnan(t[4])
        np.testing.assert_allclose(t, j, rtol=RTOL)


def sparse_ks_model(x, y, wx, wy):
    """numpy model of csrc/ks.cu for one row x [N] against its track y [M]:
    the values that are not 0.0 kept and sorted, the zeros one run, and the
    gap |#{x <= v} wx - #{y <= v} wy| in float64 at every run end of the kept
    values, of the track and of the zeros, finite values only."""
    if np.isnan(x).any():
        return np.float32(np.nan)
    kept, ys = np.sort(x[x != 0]), np.sort(y)
    n_zero, K = x.size - kept.size, kept.size
    best = 0.0
    for i, v in enumerate(kept):
        if (i + 1 < K and kept[i + 1] == v) or not np.isfinite(v):
            continue
        cx = i + 1 + (n_zero if v > 0 else 0)
        best = max(best, abs(cx * wx - np.searchsorted(ys, v, side="right") * wy))
    for j, v in enumerate(ys):
        if (j + 1 < ys.size and ys[j + 1] == v) or not np.isfinite(v):
            continue
        cx = np.searchsorted(kept, v, side="right") + (n_zero if v >= 0 else 0)
        best = max(best, abs(cx * wx - (j + 1) * wy))
    if n_zero:
        cx = np.searchsorted(kept, 0.0, side="right") + n_zero
        best = max(best, abs(cx * wx - np.searchsorted(ys, 0.0, side="right") * wy))
    return np.float32(best)


def sparse_ks_case(name):
    """(x [B, N], y [G, M]) float32: the shapes of one crafted K4 case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    N, M = 2000, 97
    y = rng.random((2, M)).astype(np.float32) * 2e-3
    x = np.zeros((4, N), np.float32)
    sites = lambda n: rng.choice(N, n, replace=False)  # noqa: E731
    for row in x:
        row[sites(40)] = rng.random(40).astype(np.float32) * 2e-3
    if name == "ties in x":
        x[:, sites(300)] = np.float32(1 / 3)
        x[1, sites(50)] = np.float32(0.25)
    elif name == "x equal to track":
        x[0, :97] = y[0]
        x[2, sites(30)] = y[1, :30]
        x[3, sites(97)] = y[1]
    elif name == "track zeros tie the zero run":
        y[:, :9] = 0.0  # windows holding a non-ACGT base
        y[1, 9:12] = -0.0
        x[1, :5] = -0.0
    elif name == "all zeros":
        x[:] = 0.0
        y[1, :3] = 0.0
    elif name == "one nonzero":
        x[:] = 0.0
        x[:, 17] = [1.0, 1e-3, y[0, 5], 1e-9]
    elif name == "nan rows":
        x[1, :] = np.nan
        x[3, 1999] = np.nan
    elif name == "dense, negative and infinite":
        x[0] = rng.random(N).astype(np.float32) - 0.5
        x[1, :10] = [np.inf, -np.inf, -1.0, -1.0, 5.0, 5.0, np.inf, -0.5, 0.0, 0.0]
        y[1, :4] = [np.inf, -np.inf, -1.0, 5.0]
    elif name == "kept count at the capacity":
        x[:] = 0.0
        cap = tks.capacity(64, N)
        for row in x:
            row[sites(cap)] = rng.random(cap).astype(np.float32)
    return x, y


SPARSE_KS_CASES = ["random", "ties in x", "x equal to track", "track zeros tie the zero run",
                   "all zeros", "one nonzero", "nan rows", "dense, negative and infinite",
                   "kept count at the capacity"]


class TestKSSparse:
    """K4 (csrc/ks.cu) cannot run here: its arithmetic (the numpy model
    above) is held against the pooled sort, which the CPU path runs, and its
    capacity, its weights and its wrapper's checks are tested alone."""

    @pytest.mark.parametrize("case", SPARSE_KS_CASES)
    def test_model_equals_pooled_sort(self, case):
        x, y = sparse_ks_case(case)
        B, G = x.shape[0], y.shape[0]
        want = tks.batched_ks_2samp(torch.from_numpy(x),
                                    torch.from_numpy(y).repeat_interleave(B // G, dim=0))
        wx, wy = tks.weights(x.shape[1], y.shape[1])
        got = np.array([sparse_ks_model(row, y[b // (B // G)], wx, wy)
                        for b, row in enumerate(x)])
        assert got.tobytes() == want.numpy().tobytes()  # bit for bit, NaN where NaN
        jax_ks = np.asarray(jax.vmap(jks.batched_ks_2samp)(
            jnp.asarray(x.reshape(G, B // G, -1)), jnp.asarray(y))).reshape(B)
        np.testing.assert_allclose(got, jax_ks, rtol=RTOL)

    @pytest.mark.parametrize("case", ["random", "nan rows", "track zeros tie the zero run"])
    def test_cpu_calls_take_the_pooled_sort(self, case):
        """CPU rows keep the pooled sort, in its shared [M] and row [B, M]
        forms; K4's wrapper refuses them and launches nothing."""
        x, y = (torch.from_numpy(a) for a in sparse_ks_case(case))
        want = tks.batched_ks_2samp(x, y.repeat_interleave(2, dim=0))
        one = tks.batched_ks_2samp(x[:2], y[0])
        assert one.numpy().tobytes() == want[:2].numpy().tobytes()
        tks.ks_2samp_sparse.launches = 0
        with pytest.raises(ValueError, match="CUDA"):
            tks.ks_2samp_sparse(x, y, 64)
        assert tks.ks_2samp_sparse.launches == 0

    def test_masked_velvet_call_is_unchanged(self):
        x, y = sparse_ks_case("random")
        valid = np.random.default_rng(3).random(x.shape) < 0.5
        got = tks.batched_ks_2samp_masked(torch.from_numpy(x), torch.from_numpy(valid),
                                          torch.from_numpy(y[0]))
        want = jks.batched_ks_2samp_masked(jnp.asarray(x), jnp.asarray(valid),
                                           jnp.asarray(y[0]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)

    @pytest.mark.parametrize("bound,N,cap", [
        (0, 69904, 32), (1, 69904, 32), (32, 69904, 32), (33, 69904, 64), (1024, 69904, 1024),
        (13824, 69904, 16384), (32768, 69904, 32768), (32769, 69904, 65536),
        (69904, 69904, 131072), (10**9, 69904, 131072), (10**9, 100, 128), (5, 100, 32)])
    def test_capacity(self, bound, N, cap):
        """Keys for the bound, capped at N: k 9's 1,024 padded distinct reads
        and 50 kb's 13,824 fit in a power of two of shared float32 keys;
        past SHARED_CAPACITY a row's keys take a global scratch row."""
        assert tks.capacity(bound, N) == cap
        assert cap >= min(bound, N) and cap & (cap - 1) == 0
        if cap <= tks.SHARED_CAPACITY:
            assert 4 * cap <= 227 * 1024 - 1024  # beside the block's static words

    def test_capacity_refuses_a_negative_bound(self):
        with pytest.raises(ValueError):
            tks.capacity(-1, 69904)

    @pytest.mark.parametrize("N,M", [(69904, 993), (69904, 49993), (7, 3), (300, 293)])
    def test_weights_are_the_pooled_sorts(self, N, M):
        """The float32 weights K4 is handed, widened, are those the pooled
        sort sums."""
        wx, wy = tks.weights(N, M)
        assert wx == (1.0 / torch.ones(1).mul(N)).item()
        assert wy == torch.full((1,), 1.0 / M, dtype=torch.float32).item()
        assert np.float32(wx) == wx and np.float32(wy) == wy

    @pytest.mark.parametrize("what,match", [
        ("x 1-D", r"\[B, N\]"), ("y 1-D", r"\[B, N\]"), ("x float64", "float32"),
        ("y float16", "float32"), ("G divides no B", "dividing B"), ("N 0", "N % 4"),
        ("N % 4 != 0", "N % 4"), ("M 0", "N % 4"), ("x strided", "contiguous"),
        ("y strided", "contiguous"), ("x off a 16-byte boundary", "16-byte"),
        ("negative bound", "bound"), ("CPU rows", "CUDA"), ("two devices", "CUDA")])
    def test_wrapper_checks(self, what, match):
        x, y = (torch.from_numpy(a) for a in sparse_ks_case("random"))
        flat = torch.zeros(x.numel() + 4)
        off = flat[1 : x.numel() + 1].view(x.shape)
        assert off.data_ptr() % 16 == 4
        bound = 64
        x, y, bound = {
            "x 1-D": (x[0], y, bound), "y 1-D": (x, y[0], bound),
            "x float64": (x.double(), y, bound), "y float16": (x, y.half(), bound),
            "G divides no B": (x[:3], y, bound), "N 0": (x[:, :0], y, bound),
            "N % 4 != 0": (x[:, :1998].contiguous(), y, bound), "M 0": (x, y[:, :0], bound),
            "x strided": (x[:, ::2], y, bound), "y strided": (x, y[:, ::2], bound),
            "x off a 16-byte boundary": (off, y, bound), "negative bound": (x, y, -1),
            "CPU rows": (x, y, bound), "two devices": (x, y.to("meta"), bound)}[what]
        with pytest.raises(ValueError, match=match):
            tks.ks_2samp_sparse(x, y, bound)

    def test_source_in_the_build_set_and_hash(self, tmp_path, monkeypatch):
        """csrc/ks.cu is one of the kernels cuda_build compiles, and its
        bytes name its library; checked without nvcc."""
        src = os.path.join(os.path.dirname(cuda_build.__file__), os.pardir, "csrc")
        assert "ks" in cuda_build.KERNELS
        assert sorted(cuda_build.KERNELS) == sorted(
            os.path.basename(p)[:-3] for p in glob.glob(os.path.join(src, "*.cu")))
        path = cuda_build.library_path("ks")
        assert os.path.basename(path).startswith("libks_") and path.endswith(".so")
        copy = tmp_path / "csrc"
        shutil.copytree(src, copy)
        monkeypatch.setattr(cuda_build, "_SRC_DIR", str(copy))
        assert cuda_build.library_path("ks") == path
        (copy / "ks.cu").write_text((copy / "ks.cu").read_text() + "\n// edited\n")
        assert cuda_build.library_path("ks") != path
        assert cuda_build.library_path("myers") == cuda_build.library_path("myers")


def _eval_counters(run):
    profiling.collect()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cols = run()
    return cols, profiling.collect().counters


class TestKSDispatchInEvaluation:
    """evaluate_group's eval.ks: the rows that got a KS and those K4 took,
    counted under tracing. K4's one call a group runs only on the card
    (chip_smoke.py [3d] holds the study runner's KS columns with it against
    the pooled sort's)."""

    @pytest.fixture(scope="class")
    def asm(self):
        from genomeassembler_dev_tpu_torch.core.querytable import (
            load_default_query_table as t_table)
        from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
        from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
        cfg = ExperimentConfig(seq_len=300, read_len=12, dbg_kmer=9, coverage_target=15.0,
                               kmer=8, seed=1234, n_orderings=50)
        return Assembler(cfg, "cpu", t_table("cpu"))

    def test_cpu_rows_take_the_pooled_sort(self, asm):
        from genomeassembler_dev_tpu_torch.sim.segments import synthetic_genome
        cols, counters = _eval_counters(lambda: asm.run_experiment(
            synthetic_genome(3, 300)).columns)
        rows = evaluate._round_up(len(cols["sequence"]), evaluate.ROW_MULTIPLE)
        assert counters["eval.ks_rows"] == rows and counters["eval.ks_kernel_rows"] == 0

    def test_velvet_profile_keeps_the_pooled_sort(self, monkeypatch):
        from genomeassembler_dev_tpu_torch.core.querytable import (
            load_default_query_table as t_table)
        from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
        from genomeassembler_dev_tpu_torch.pipeline.velvet import IndustryAssembler
        from genomeassembler_dev_tpu_torch.sim.segments import synthetic_genome

        def no_kernel(*args):
            raise AssertionError("the velvet path's masked profile went to K4")

        monkeypatch.setattr(evaluate, "ks_2samp_sparse", no_kernel)
        seg = synthetic_genome(1, 300)
        vasm = IndustryAssembler(ExperimentConfig(
            seq_len=300, read_len=12, dbg_kmer=11, coverage_target=12.0, kmer=8, seed=1234,
            n_orderings=50, industry_standard=True, velvet_n_orderings=50), "cpu", t_table("cpu"))
        _, counters = _eval_counters(lambda: vasm.run_external(
            seg, [seg[lo : lo + 100] for lo in range(0, 300, 90)]).columns)
        assert counters["eval.ks_rows"] > 0 and counters["eval.ks_kernel_rows"] == 0


class TestHistogram:
    """The cases of tests/test_pallas_kernels.py (TestPallasHistogram)."""

    @staticmethod
    def _inputs(k):
        rng = np.random.default_rng(k)
        codes = rng.integers(0, 4**k, size=(2, 700)).astype(np.int32)
        valid = rng.random((2, 700)) < 0.9
        return codes, valid

    @pytest.mark.parametrize("k", [4, 8, 9])
    def test_batched_vs_jax_and_pallas(self, k):
        codes, valid = self._inputs(k)
        thist.count_kmers_batched.launches = 0
        got = thist.count_kmers_batched(torch.from_numpy(codes).long(),
                                        torch.from_numpy(valid), 4**k)
        assert thist.count_kmers_batched.launches == 0  # CPU tensors: plain version
        assert got.dtype == torch.int32
        jargs = (jnp.asarray(codes), jnp.asarray(valid))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jhist.count_kmers_batched(*jargs, 4**k)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(count_kmers_mxu(*jargs, k)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            count_kmers_mxu_pallas(*jargs, k, chunk=256, interpret=True)))

    @pytest.mark.parametrize("k", [4, 8, 9])
    def test_flat_and_weighted_vs_jax(self, k):
        codes, valid = self._inputs(k)
        weights = np.random.default_rng(k + 1).random(codes.shape).astype(np.float32)
        jargs = (jnp.asarray(codes), jnp.asarray(valid), 4**k)
        got = thist.count_kmers(torch.from_numpy(codes), torch.from_numpy(valid), 4**k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jhist.count_kmers(*jargs)))
        got_w = thist.count_kmers(torch.from_numpy(codes), torch.from_numpy(valid), 4**k,
                                  weights=torch.from_numpy(weights))
        want_w = np.asarray(jhist.count_kmers(*jargs, weights=jnp.asarray(weights)))
        assert got_w.dtype == torch.float32
        np.testing.assert_allclose(got_w.numpy(), want_w, rtol=RTOL)

    def test_wrapper_rejects(self):
        codes = torch.zeros((2, 5), dtype=torch.int32)
        with pytest.raises(ValueError):
            thist.count_kmers_batched(codes, torch.ones((2, 4), dtype=torch.bool), 16)
        with pytest.raises(ValueError):
            thist.count_kmers_batched(codes.to("meta"),
                                      torch.ones((2, 5), dtype=torch.bool, device="meta"), 16)


def packed_histogram(codes, valid, bins, plan, vec=True):
    """numpy model of csrc/histogram.cu: each block (row, slice, part) counts
    into 16-bit halves of 32-bit words, entry i by the thread the kernel
    gives it (scalar head and tail, 4-entry groups between) and that
    thread's warp's counter copy; the copies' packed words add, then widen.
    uint32 arithmetic as on the card, so a carry would show."""
    B, N = codes.shape
    T = plan.threads
    out = np.zeros((B, bins), np.int64)
    for b in range(B):
        base = b * N
        for part in range(plan.n_parts):
            begin = part * plan.chunk
            end = min(N, begin + plan.chunk)
            head = min(end, begin + (4 - (base + begin) % 4) % 4) if vec else begin
            tail = head + 4 * ((end - head) // 4 if vec else 0)
            i = np.arange(begin, end)
            thread = np.where(i < head, i - begin,
                              np.where(i < tail, (i - head) // 4, i - tail)) % T
            copy = (thread // 32) % plan.copies
            for sl in range(plan.n_slices):
                lo = sl * plan.slice_bins
                width = min(plan.slice_bins, bins - lo)
                copy_words = 4 * -(-((width + 1) // 2) // 4)
                assert 4 * plan.copies * copy_words <= plan.shared_bytes
                u = codes[b, begin:end].astype(np.int64) - lo
                keep = valid[b, begin:end] & (u >= 0) & (u < width)
                hist = np.zeros(plan.copies * copy_words, np.uint32)
                np.add.at(hist, (copy * copy_words + (u >> 1))[keep],
                          (np.uint32(1) << (16 * (u & 1)).astype(np.uint32))[keep])
                words = hist.reshape(plan.copies, copy_words).sum(0, dtype=np.uint32)
                counts = np.stack([words & 0xFFFF, words >> 16], 1).reshape(-1)[:width]
                out[b, lo : lo + width] += counts
    return out.astype(np.int32)


# (B, N, k): the count study's four calls under study-all (B 1, read length
# 12), the TPU kernel's shape, the parts' edges and the kernel's k range
HIST_PLAN_SHAPES = [(1, 36663, 2), (1, 29997, 4), (1, 23331, 6), (1, 16665, 8),
                    (256, 16665, 8), (1, 65532, 8), (1, 65533, 8), (2, 65535, 5),
                    (2, 65536, 6), (3, 700, 9), (1, 1_000_000, 2), (1, 0, 4), (1, 5, 1)]


class TestHistogramPlan:
    """csrc/histogram.cu cannot run here: its launch plan and its packed
    counting are held against the JAX package and the plain version."""

    @pytest.mark.parametrize("B,N,k", HIST_PLAN_SHAPES)
    def test_launch_plan(self, B, N, k):
        bins = 4**k
        plan = thist.launch_plan(N, bins)
        assert plan.slice_bins == min(bins, 65536)
        assert plan.n_slices * plan.slice_bins >= bins  # every bin has a block
        assert plan.slice_bins == bins or plan.slice_bins % 4 == 0
        assert plan.n_parts * plan.chunk >= N  # every entry has a part
        assert plan.chunk <= 65535 and plan.chunk % 4 == 0  # no counter carries
        assert plan.n_parts == 1 or (plan.n_parts - 1) * plan.chunk < N  # no empty part
        assert B * plan.n_slices * plan.n_parts <= 2**31 - 1 and B <= 65535  # the grid
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.copies == (plan.threads // 32 if bins <= 1024 else 1)
        assert plan.shared_bytes <= 227 * 1024 and plan.shared_bytes % 16 == 0
        if N <= 65532:  # the count study's shapes: one part, no zeroed output
            assert plan.n_parts == 1

    @pytest.mark.parametrize("k", [2, 4, 5, 6, 8, 9])
    @pytest.mark.parametrize("case", ["random", "one bin", "int64 out of range"])
    def test_packed_model_vs_pallas_and_plain(self, k, case):
        bins = 4**k
        rng = np.random.default_rng(10 * k)
        if case == "one bin":  # a low and a high half at the most a part holds
            codes = np.array([[bins - 2] * 65532, [bins - 1] * 65532], np.int64)
            valid = np.ones(codes.shape, bool)
        else:
            codes = rng.integers(0, bins, (2, 4099)).astype(np.int64)
            valid = rng.random(codes.shape) < 0.9
        if case == "int64 out of range":
            codes[:, ::7] = rng.choice([-1, -2**40, bins, 2**40], codes[:, ::7].shape)
        plan = thist.launch_plan(codes.shape[1], bins)
        got = thist.count_kmers_batched(torch.from_numpy(codes), torch.from_numpy(valid), bins)
        assert got.dtype == torch.int32
        in_range = (codes >= 0) & (codes < bins)
        jcodes = jnp.asarray(np.where(in_range, codes, 0).astype(np.int32))
        want = np.asarray(count_kmers_mxu_pallas(jcodes, jnp.asarray(valid & in_range), k,
                                                 chunk=2048, interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)
        for vec in (True, False):
            np.testing.assert_array_equal(packed_histogram(codes, valid, bins, plan, vec), want)
        if case == "one bin":
            assert plan.n_parts == 1 and want[0, bins - 2] == want[1, bins - 1] == 65532


def pallas_test_cases():
    """The cases of tests/test_pallas_kernels.py (TestMyersLevenshtein):
    random queries, whole target and an infix; multi-word and empty ones."""
    rng = np.random.default_rng(0)
    target = rand_dna(rng, 90)
    queries = [rand_dna(rng, int(rng.integers(1, 120))) for _ in range(9)]
    queries += [target, target[10:40]]
    rng = np.random.default_rng(1)
    target2 = rand_dna(rng, 150)
    queries2 = [rand_dna(rng, 200), target2 + "ACGT" * 10, ""]
    return [(queries, target), (queries2, target2)]


class TestLevenshtein:
    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("case", [0, 1])
    def test_plain_vs_jax_scan_and_myers(self, mode, case):
        queries, target = pallas_test_cases()[case]
        qmat, qlen = pack(queries, pad=0)
        tgt = encode_dna(target)
        batched_levenshtein_myers.launches = 0
        got = t_lev_auto(torch.from_numpy(qmat), torch.from_numpy(qlen),
                         torch.from_numpy(tgt), mode=mode).numpy()
        assert batched_levenshtein_myers.launches == 0  # CPU tensors: plain DP
        np.testing.assert_array_equal(
            got, t_lev(torch.from_numpy(qmat), torch.from_numpy(qlen),
                       torch.from_numpy(tgt), mode=mode).numpy())
        jargs = (jnp.asarray(qmat), jnp.asarray(qlen), jnp.asarray(tgt))
        np.testing.assert_array_equal(got, np.asarray(j_lev(*jargs, mode=mode)))
        np.testing.assert_array_equal(
            got, np.asarray(j_myers(*jargs, mode=mode, block_b=128, interpret=True)))
        assert got.tolist() == [spec.levenshtein(q, target, mode=mode) for q in queries]

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("case", [0, 1])
    def test_prefix_min_plain_vs_jax_pallas(self, mode, case):
        queries, target = pallas_test_cases()[case]
        qmat, qlen = pack(queries, pad=0)
        tgt = encode_dna(target)
        batched_levenshtein_prefix_min.launches = 0
        got = batched_levenshtein_prefix_min(torch.from_numpy(qmat), torch.from_numpy(qlen),
                                             torch.from_numpy(tgt), mode=mode).numpy()
        assert batched_levenshtein_prefix_min.launches == 0  # CPU tensors: plain DP
        want = np.asarray(j_prefix_min(jnp.asarray(qmat), jnp.asarray(qlen),
                                       jnp.asarray(tgt), mode=mode, block_b=16,
                                       interpret=True))
        np.testing.assert_array_equal(got, want)
        assert got.tolist() == [spec.levenshtein(q, target, mode=mode) for q in queries]

    @pytest.mark.parametrize("wrapper", [batched_levenshtein_myers,
                                         batched_levenshtein_prefix_min])
    def test_wrapper_rejects_mixed_devices_and_modes(self, wrapper):
        q = torch.zeros((1, 4), dtype=torch.uint8)
        with pytest.raises(ValueError):
            wrapper(q, torch.tensor([4], dtype=torch.int32),
                    torch.zeros(3, dtype=torch.uint8), mode="SHW")
        with pytest.raises(ValueError):
            wrapper(q, torch.tensor([4], dtype=torch.int32),
                    torch.zeros(3, dtype=torch.uint8, device="meta"))


# query lengths at csrc/myers.cu's strip, warp and band edges
EDGE_LENGTHS = (0, 1, 31, 32, 33, 63, 64, 65, 1024, 1025, 8192, 8193, 16385, 50048)


def edge_case():
    """One batch that mixes the empty query, short ones and a 50 kb one, each
    a mutated run of copies of a 300-base target."""
    rng = np.random.default_rng(4)
    target = rand_dna(rng, 300)
    queries = []
    for n in EDGE_LENGTHS:
        s = list((target * (n // 300 + 1))[:n])
        for p in rng.integers(0, max(n, 1), n // 20):
            s[p] = "ACGT"[int(rng.integers(4))]
        queries.append("".join(s))
    return queries, target


def with_ns(rng, s, rate=0.05):
    """s with each base replaced by N at `rate`."""
    return "".join("N" if rng.random() < rate else ch for ch in s)


# A target and queries whose N (code 255) must match an N, as in the spec
N_TARGET = "ACGTNNACGTTACNA"
N_QUERIES = ["ACGTNNACG", "AAAAAA", "NNNN", "ACGTAAACGTTACAA"]
# JAX's Pallas Myers kernel reads a target code above 3 as A
# (genomeassembler_dev_tpu/ops/pallas/myers_kernel.py:80-82) and lets a
# query's 255 match nothing, so on these strings it differs from the spec
JAX_MYERS_ON_N = {"NW": [8, 9, 15, 0], "HW": [2, 3, 4, 0]}


@functools.lru_cache(maxsize=None)
def non_acgt_cases():
    """{name: (queries, target)} with ~5% N in queries and target: the
    strings above; seeded random queries (copies of target stretches and
    unrelated ones, some empty) against a 200-base target; queries to 3,000
    columns, wider than one band of the numpy model's small plans."""
    rng = np.random.default_rng(10)
    target = with_ns(rng, rand_dna(rng, 200))
    queries = [""]
    for _ in range(8):
        a = int(rng.integers(0, 150))
        queries.append(with_ns(rng, target[a : a + int(rng.integers(1, 120))].replace("N", "A")))
    queries += [with_ns(rng, rand_dna(rng, int(n))) for n in rng.integers(1, 260, 5)]
    queries.append(target)
    rng = np.random.default_rng(11)
    wide_target = with_ns(rng, rand_dna(rng, 150))
    wide = [with_ns(rng, (wide_target * 21)[:n]) for n in (1025, 2100, 3000)]
    return {"N strings": (N_QUERIES, N_TARGET), "N random": (queries, target),
            "N bands": (wide + [wide_target, ""], wide_target)}


def wavefront_myers(qmat, qlens, target, mode, S, lanes):
    """numpy model of csrc/myers.cu's schedule, one query at a time: a query's
    words cut into strips of S per lane; at step s word o (lane o // S, slot
    o % S) advances by character s - o, taking hin from word o-1's hout of
    step s-1: the slot before in the same lane, else the previous lane's last
    slot (a shuffle inside a warp, the parity mailbox from the warp before);
    queries wider than lanes x S words in bands, handing hout over through
    one row."""
    N, M = len(target), qmat.shape[1]
    hin0 = 0 if mode == "HW" else 1
    band_words = lanes * S
    bits = np.uint32(1) << np.arange(32, dtype=np.uint32)
    # the Peq row of each target code: 0-3, 255 (N) row 4 (the wrapper
    # refuses 4-254); row 5, no match, outside the target
    tcodes = np.minimum(np.asarray(target, np.int64), 4)
    out = []
    for row, qlen in zip(qmat, qlens):
        qlen = min(max(int(qlen), 0), M)
        if qlen == 0:
            out.append(0 if mode == "HW" else N)
            continue
        nw = (qlen - 1) // 32 + 1
        nbands = -(-nw // band_words)
        codes = np.full(nbands * band_words * 32, 5, np.int64)  # past qlen: no row
        codes[:qlen] = row[:qlen]
        bstar = (qlen - 1) & 31
        hbuf = np.zeros(N, np.int64)
        score = best = qlen
        for band in range(nbands):
            w0 = band * band_words
            used = -(-min(band_words, nw - w0) // S)
            last = band == nbands - 1
            lane = np.arange(used)
            offset = lane[:, None] * S + np.arange(S)  # [used, S]: word within the band
            cw = codes[(w0 + offset)[..., None] * 32 + np.arange(32)]
            peq = np.stack([((cw == c) * bits).sum(-1, dtype=np.uint32)
                            for c in (0, 1, 2, 3, 255)]
                           + [np.zeros((used, S), np.uint32)])  # row 5: no match
            vp = np.full((used, S), 0xFFFFFFFF, np.uint32)
            vn = np.zeros((used, S), np.uint32)
            hout = np.zeros((used, S), np.int64)  # +1, 0 or -1
            warp, wl = lane // 32, lane % 32
            mailbox = np.zeros((2, -(-used // 32)), np.int64)
            sw = nw - 1 - w0
            owner, kq = divmod(sw, S)
            for s in range(N + used * S - 1):
                i = s - offset
                ok = (i >= 0) & (i < N)
                tc = np.where(ok, tcodes[np.clip(i, 0, max(N - 1, 0))], 5)
                up = np.concatenate([[0], hout[:-1, S - 1]])
                up = np.where(wl == 0, mailbox[(s + 1) & 1][np.maximum(warp - 1, 0)], up)
                up[0] = hin0 if band == 0 else hbuf[min(s, N - 1)]
                hin = np.concatenate([up[:, None], hout[:, :-1]], axis=1)
                eq = peq[tc, lane[:, None], np.arange(S)]
                hneg = (hin < 0).astype(np.uint32)
                hpos = (hin > 0).astype(np.uint32)
                xv = eq | vn
                eq = eq | hneg
                xh = (((eq & vp) + vp) ^ vp) | eq
                ph = vn | ~(xh | vp)
                mh = vp & xh
                if last and ok[owner, kq]:
                    score += int((ph[owner, kq] >> bstar) & 1) - int((mh[owner, kq] >> bstar) & 1)
                    best = min(best, score)
                hnew = (ph >> 31).astype(np.int64) - (mh >> 31).astype(np.int64)
                ph = (ph << 1) | hpos
                mh = (mh << 1) | hneg
                vp, vn = np.where(ok, mh | ~(xv | ph), vp), np.where(ok, ph & xv, vn)
                hout = np.where(ok, hnew, hout)
                if not last and ok[used - 1, S - 1]:
                    hbuf[i[used - 1, S - 1]] = hout[used - 1, S - 1]
                tails = np.arange(31, used, 32)  # lane 31 of each warp posts
                mailbox[s & 1][tails // 32] = hout[tails, S - 1]
        out.append(best if mode == "HW" else score)
    return np.array(out, np.int32)


@functools.lru_cache(maxsize=None)
def _levenshtein_references(case, mode):
    """(qmat, qlen, target codes, JAX Pallas kernel in interpret mode, plain
    DP, spec) for one case and mode."""
    queries, target = edge_case() if case == "edges" else pallas_test_cases()[case]
    qmat, qlen = pack(queries, pad=0)
    tgt = encode_dna(target)
    jargs = (jnp.asarray(qmat), jnp.asarray(qlen), jnp.asarray(tgt))
    jax_k = np.asarray(j_myers(*jargs, mode=mode, block_b=128, interpret=True))
    plain = t_lev(torch.from_numpy(qmat), torch.from_numpy(qlen), torch.from_numpy(tgt),
                  mode=mode).numpy()
    want = np.array([spec.levenshtein(q, target, mode=mode) for q in queries], np.int32)
    return qmat, qlen, tgt, jax_k, plain, want


def _non_acgt_references(case, mode):
    """(qmat, qlen, target codes, spec) for a non_acgt_cases() case."""
    queries, target = non_acgt_cases()[case]
    qmat, qlen = pack(queries, pad=0)
    want = np.array([spec.levenshtein(q, target, mode=mode) for q in queries], np.int32)
    return qmat, qlen, encode_dna(target), want


class TestNonACGT:
    """255 (N) against 255 is a match for the spec, the plain DP, the
    prefix-min kernel's and the Myers kernel's CPU routes, and JAX's plain
    DP. JAX's Pallas Myers kernel differs: its values are asserted, so a
    change on either side shows."""

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("case", ["N strings", "N random", "N bands"])
    def test_plain_routes_and_jax_plain_vs_spec(self, case, mode):
        qmat, qlen, tgt, want = _non_acgt_references(case, mode)
        assert (tgt == 255).any() and (qmat == 255).any()
        args = (torch.from_numpy(qmat), torch.from_numpy(qlen), torch.from_numpy(tgt))
        batched_levenshtein_myers.launches = batched_levenshtein_prefix_min.launches = 0
        np.testing.assert_array_equal(t_lev(*args, mode=mode).numpy(), want)
        np.testing.assert_array_equal(batched_levenshtein_myers(*args, mode=mode).numpy(), want)
        np.testing.assert_array_equal(
            batched_levenshtein_prefix_min(*args, mode=mode).numpy(), want)
        assert batched_levenshtein_myers.launches == batched_levenshtein_prefix_min.launches == 0
        jargs = (jnp.asarray(qmat), jnp.asarray(qlen), jnp.asarray(tgt))
        np.testing.assert_array_equal(np.asarray(j_lev(*jargs, mode=mode)), want)

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    def test_jax_myers_kernel_reads_n_as_a(self, mode):
        qmat, qlen, tgt, want = _non_acgt_references("N strings", mode)
        got = np.asarray(j_myers(jnp.asarray(qmat), jnp.asarray(qlen), jnp.asarray(tgt),
                                 mode=mode, block_b=128, interpret=True))
        assert want.tolist() == {"NW": [6, 11, 12, 3], "HW": [0, 4, 2, 3]}[mode]
        assert got.tolist() == JAX_MYERS_ON_N[mode] != want.tolist()

    @pytest.mark.parametrize("where", ["query", "target"])
    def test_myers_wrapper_codes_4_to_254(self, where):
        """A target code in 4-254 is refused; a query code there matches
        nothing, in the plain DP and in the kernel's numpy model alike."""
        qmat, qlen, tgt, want = _non_acgt_references("N strings", "NW")
        qmat, tgt = qmat.copy(), tgt.copy()
        if where == "target":
            tgt[3] = 254
            with pytest.raises(ValueError, match="4-254"):
                batched_levenshtein_myers(torch.from_numpy(qmat), torch.from_numpy(qlen),
                                          torch.from_numpy(tgt))
            return
        qmat[2, 1] = 4
        qmat[0, qlen[0]:] = 7  # and the padding beyond a query's length is free
        args = (torch.from_numpy(qmat), torch.from_numpy(qlen), torch.from_numpy(tgt))
        for mode in ("NW", "HW"):
            plain = t_lev(*args, mode=mode).numpy()
            np.testing.assert_array_equal(batched_levenshtein_myers(*args, mode=mode).numpy(),
                                          plain)
            np.testing.assert_array_equal(wavefront_myers(qmat, qlen, tgt, mode, 1, 32), plain)
            # as a character that the target does not hold
            assert plain[2] == spec.levenshtein("NXNN", N_TARGET, mode=mode)


class TestMyersWavefront:
    """csrc/myers.cu cannot run here: its launch plan and its schedule are
    held against the JAX package on the CPU."""

    @pytest.mark.parametrize("B,M", [
        (512, 2048), (37, 1152), (256, 2000),  # own and biased: solutions to 2 kb
        (256, 2048),  # K1's 256 x 2048 x 50 kb HW case
        (64, 50048), (1, 50000), (256, 100096), (256, 102400),  # velvet, repeat-heavy
        *((14, n) for n in EDGE_LENGTHS if n), (1, 131072), (1, 131073), (2, 1_000_000)])
    def test_launch_plan(self, B, M):
        # B is the path's batch: the kernel runs one block a query, so the
        # plan depends on the width alone and B blocks never reach a limit
        assert B <= 2**31 - 1
        W = max(1, -(-M // 32))
        plan = launch_plan(W)
        S = plan.words_per_lane
        assert S in MAX_LANES and plan.lanes % 32 == 0
        assert plan.lanes <= MAX_LANES[S] <= 1024
        # S words of VP/VN and two hout bits a lane, ~30 registers besides
        assert 4 * S + 30 <= min(255, 65536 // MAX_LANES[S])
        # a two-slot mailbox per warp, then [S][PEQ_CODES][lanes] Peq words
        assert plan.shared_bytes == 4 * (2 * (plan.lanes // 32)
                                         + S * PEQ_CODES * plan.lanes) <= 227 * 1024
        bands = -(-W // plan.band_words)
        assert bands * plan.band_words >= W  # every word has a lane
        assert plan.lanes <= 32 * -(-W // (32 * S))  # no warp without words
        if W <= 128:  # a warp a query, no barrier, one band
            assert plan.lanes == 32 and bands == 1 and S == min(s for s in (1, 2, 4)
                                                                if W <= 32 * s)
        assert bands == 1 or plan.lanes == MAX_LANES[S]  # bands only at full width

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("case", [0, 1, "edges"])
    @pytest.mark.parametrize("S,lanes", [(1, 64), (2, 96), (4, 64), (8, 32),
                                         ("plan", None)])
    def test_schedule_vs_jax_plain_and_spec(self, S, lanes, case, mode):
        qmat, qlen, tgt, jax_k, plain, want = _levenshtein_references(case, mode)
        if S == "plan":
            plan = launch_plan(max(1, -(-qmat.shape[1] // 32)))
            S, lanes = plan.words_per_lane, plan.lanes
        got = wavefront_myers(qmat, qlen, tgt, mode, S, lanes)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jax_k, want)
        np.testing.assert_array_equal(plain, want)

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("case", ["N strings", "N random", "N bands"])
    @pytest.mark.parametrize("S,lanes", [(1, 32), (2, 32), (1, 64), ("plan", None)])
    def test_schedule_on_non_acgt_vs_spec(self, S, lanes, case, mode):
        """N matches N in the kernel's schedule too: a Peq row for 255, and
        one that matches nothing for characters outside the target."""
        qmat, qlen, tgt, want = _non_acgt_references(case, mode)
        if S == "plan":
            plan = launch_plan(max(1, -(-qmat.shape[1] // 32)))
            S, lanes = plan.words_per_lane, plan.lanes
        elif case == "N bands":
            assert -(-qmat.shape[1] // 32) > S * lanes  # several bands
        np.testing.assert_array_equal(wavefront_myers(qmat, qlen, tgt, mode, S, lanes), want)


def wavefront_prefix_min(qmat, qlens, target, mode, C, R, lanes):
    """numpy model of csrc/prefix_min.cu's schedule, one query at a time:
    lane t owns C consecutive columns and at step s computes rows
    R (s - t) + 1 .. R (s - t) + R from its own previous row and the last
    column of lane t - 1 for those rows (shuffles inside a warp, the parity
    mailbox from the warp before), masked where the lane has no row; only
    the warps up to the lane holding column qlen run (ceil(N / R) + used - 1
    steps); queries wider than lanes x C columns run in
    bands that hand their last column over through one row, read one step
    ahead. Never-written mailbox slots and hand-off entries hold poison."""
    N, M = len(target), qmat.shape[1]
    hw = mode == "HW"
    tcodes = np.asarray(target, np.int64)
    poison = -(10**6)
    band_cols = lanes * C
    out = []
    for row, qlen in zip(qmat, qlens):
        qlen = min(max(int(qlen), 0), M)
        if qlen == 0 or N == 0:
            out.append(qlen if qlen else (0 if hw else N))
            continue
        nbands = -(-qlen // band_cols)
        hbuf = np.full(N, poison, np.int64)
        for band in range(nbands):
            c0 = band * band_cols
            used = min(lanes, -(-(qlen - c0) // C))
            busy = -(-used // 32)
            last = band == nbands - 1
            gl = np.arange(32 * busy)  # the busy warps' lanes
            lane, warp = gl % 32, gl // 32
            j = c0 + gl[:, None] * C + np.arange(C) + 1  # [lanes, C] columns
            qc = np.where(j <= qlen, row[np.clip(j - 1, 0, M - 1)].astype(np.int64), 0x100)
            d = j.astype(np.int64)  # row 0
            left_prev = c0 + gl * C  # row 0 of the column left of each lane
            kq = qlen - (c0 + gl * C + 1)
            owners = np.flatnonzero(last & (kq >= 0) & (kq < C))
            best = qlen
            mailbox = np.full((2, R, busy), poison, np.int64)
            tail = np.repeat(d[:, C - 1:], R, axis=1)  # [lanes, R]
            hb_next = hbuf[np.minimum(np.arange(R), N - 1)]
            for s in range(-(-N // R) + used - 1):
                i0 = R * (s - gl) + 1
                lin = np.concatenate([np.full((1, R), poison), tail[:-1]])  # shuffles up
                lin = np.where((lane == 0)[:, None],
                               mailbox[(s + 1) & 1][:, np.maximum(warp - 1, 0)].T, lin)
                if band > 0:
                    lin[0], hb_next = hb_next, hbuf[np.minimum(i0[0] + R - 1 + np.arange(R),
                                                               N - 1)]
                else:
                    lin[0] = 0 if hw else i0[0] + np.arange(R)
                for r in range(R):
                    i = i0 + r
                    tc = tcodes[np.clip(i - 1, 0, N - 1)]
                    ok = (i >= 1) & (i <= N)
                    new = d.copy()
                    diag, left = (left_prev if r == 0 else lin[:, r - 1]).copy(), lin[:, r].copy()
                    for k in range(C):
                        up = d[:, k]
                        new[:, k] = np.minimum(left + 1,
                                               np.minimum(up + 1, diag + (qc[:, k] != tc)))
                        diag, left = up, new[:, k]
                    d = np.where(ok[:, None], new, d)
                    assert (d[ok] > poison // 2).all()
                    for o in owners:
                        if hw and ok[o]:
                            best = min(best, int(d[o, kq[o]]))
                    if not last and ok[used - 1]:
                        hbuf[i[used - 1] - 1] = d[used - 1, C - 1]
                    tail[:, r] = d[:, C - 1]
                left_prev = np.where(i0 >= 1, lin[:, R - 1], left_prev)
                mailbox[s & 1] = tail[31::32].T
        (o,) = owners
        out.append(best if hw else int(d[o, kq[o]]))
    return np.array(out, np.int32)


@functools.lru_cache(maxsize=None)
def _prefix_min_references(case, mode):
    """(qmat, qlen, target codes, the JAX prefix-min Pallas kernel in
    interpret mode, plain DP, spec) for one case and mode; "wide" holds
    queries of 16,385 and 50,048 columns against a 120-base target."""
    if case == "wide":
        rng = np.random.default_rng(9)
        target = rand_dna(rng, 120)
        queries = [(target * 418)[:n] for n in (16385, 50048)] + ["", target[5:90]]
    else:
        queries, target = pallas_test_cases()[case]
    qmat, qlen = pack(queries, pad=0)
    tgt = encode_dna(target)
    jargs = (jnp.asarray(qmat), jnp.asarray(qlen), jnp.asarray(tgt))
    jax_k = np.asarray(j_prefix_min(*jargs, mode=mode, block_b=8, interpret=True))
    plain = t_lev(torch.from_numpy(qmat), torch.from_numpy(qlen), torch.from_numpy(tgt),
                  mode=mode).numpy()
    want = np.array([spec.levenshtein(q, target, mode=mode) for q in queries], np.int32)
    return qmat, qlen, tgt, jax_k, plain, want


class TestPrefixMinWavefront:
    """csrc/prefix_min.cu cannot run here: its launch plan and its wavefront
    schedule are held against the JAX package on the CPU."""

    @pytest.mark.parametrize("M", [
        0, 1, 16 * 32, 16 * 32 + 1, 32 * 32, 32 * 32 + 1, 8192, 8193, 32 * 512, 32 * 512 + 1,
        1152, 2000, 2048,  # own and biased checks: solutions to 2 kb
        50000, 50048, 100096, 140000, 1_000_000])
    def test_launch_plan(self, M):
        plan = tpm.launch_plan(M)
        C = plan.cols_per_lane
        assert (C, plan.rows_per_step) in (tpm.ONE_BLOCK, tpm.BANDED)
        assert plan.lanes % 32 == 0 and 32 <= plan.lanes <= tpm.MAX_LANES <= 1024
        # C DP columns and C query codes a lane, ~10 a row of the step and
        # ~20 besides (ptxas: 94 and 121 registers, no spills)
        assert 2 * C + 10 * plan.rows_per_step + 20 <= min(255, 65536 // tpm.MAX_LANES)
        bands = -(-max(M, 1) // plan.band_cols)
        assert bands * plan.band_cols >= M  # every column has a lane
        assert plan.lanes <= 32 * -(-max(M, 1) // (32 * C))  # no warp without columns
        assert bands == 1 or plan.lanes == tpm.MAX_LANES  # bands only at full width

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("case", [0, 1, "wide"])
    @pytest.mark.parametrize("C,R,lanes", [(16, 4, 64), (16, 4, 96), (32, 4, 32), (8, 1, 64),
                                           ("plan", None, None)])
    def test_schedule_vs_jax_plain_and_spec(self, C, R, lanes, case, mode):
        qmat, qlen, tgt, jax_k, plain, want = _prefix_min_references(case, mode)
        if C == "plan":
            plan = tpm.launch_plan(qmat.shape[1])
            C, R, lanes = plan.cols_per_lane, plan.rows_per_step, plan.lanes
        got = wavefront_prefix_min(qmat, qlen, tgt, mode, C, R, lanes)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jax_k, want)
        np.testing.assert_array_equal(plain, want)

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    @pytest.mark.parametrize("case", ["N strings", "N bands"])
    @pytest.mark.parametrize("C,R,lanes", [(16, 4, 32), ("plan", None, None)])
    def test_schedule_on_non_acgt_vs_spec(self, C, R, lanes, case, mode):
        qmat, qlen, tgt, want = _non_acgt_references(case, mode)
        if C == "plan":
            plan = tpm.launch_plan(qmat.shape[1])
            C, R, lanes = plan.cols_per_lane, plan.rows_per_step, plan.lanes
        np.testing.assert_array_equal(wavefront_prefix_min(qmat, qlen, tgt, mode, C, R, lanes),
                                      want)

    @pytest.mark.parametrize("mode", ["NW", "HW"])
    def test_wrapper_takes_wide_queries(self, mode):
        """Widths above the old 16,384-column limit: the CPU path gives the
        plain DP's distances, and the plan covers them in bands."""
        qmat, qlen, tgt, _, _, want = _prefix_min_references("wide", mode)
        batched_levenshtein_prefix_min.launches = 0
        got = batched_levenshtein_prefix_min(torch.from_numpy(qmat), torch.from_numpy(qlen),
                                             torch.from_numpy(tgt), mode=mode)
        assert batched_levenshtein_prefix_min.launches == 0
        np.testing.assert_array_equal(got.numpy(), want)
        assert not hasattr(tpm, "MAX_WIDTH")
        plan = tpm.launch_plan(qmat.shape[1])
        assert -(-qmat.shape[1] // plan.band_cols) > 1
