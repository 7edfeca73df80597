"""The port's copy of the executable spec (spec/reference_semantics.py) vs
the JAX package's: the dBG contig set, the break site, the breakage score,
the KS statistic and the edit distance on numpy-seeded inputs. Both are
pure Python and numpy over the same tables, so results are equal exactly."""

import numpy as np
import pytest

pytest.importorskip("torch")

from genomeassembler_dev_tpu.core.querytable import load_default_query_table  # noqa: E402
from genomeassembler_dev_tpu.spec import reference_semantics as jspec  # noqa: E402
from genomeassembler_dev_tpu_torch.core.querytable import QueryTable  # noqa: E402
from genomeassembler_dev_tpu_torch.spec import reference_semantics as tspec  # noqa: E402


def rand_dna(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def reads_of(rng, genome, n, read_len):
    starts = rng.integers(0, len(genome) - read_len + 1, n)
    return [genome[s : s + read_len] for s in starts]


@pytest.mark.parametrize("k", [5, 9, 13])
def test_get_contig_set(k):
    rng = np.random.default_rng(k)
    genome = rand_dna(rng, 300)
    genome = genome[:150] + genome[40:90] + genome[150:]  # a repeat: branches
    reads = reads_of(rng, genome, 400, 16)
    kmers = [r[i : i + k] for r in reads for i in range(len(r) - k + 1)]
    got = tspec.get_contig_set(kmers, k)
    assert got == jspec.get_contig_set(kmers, k) and len(got) > 1


def test_break_site_and_kmer_code():
    path = rand_dna(np.random.default_rng(1), 40)
    for pos in range(12):
        assert tspec.break_site(path, pos, 8) == jspec.break_site(path, pos, 8)
    for s in ("A", "ACGT", "TTTTTTTT", "GATTACA"):
        assert tspec.kmer_code(s) == jspec.kmer_code(s)
    with pytest.raises(ValueError):
        tspec.kmer_code("ACNT")


def test_calc_breakscore():
    rng = np.random.default_rng(2)
    jtable = load_default_query_table()
    truth = rand_dna(rng, 120)
    paths = [truth, truth[3:90], rand_dna(rng, 60), truth[:2] + rand_dna(rng, 30)]
    reads = reads_of(rng, truth, 80, 10) + [rand_dna(rng, 10)]
    got = tspec.calc_breakscore(paths, reads, truth, 8, QueryTable.from_numpy(jtable.probs, "cpu"))
    want = jspec.calc_breakscore(paths, reads, truth, 8, jtable)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    assert np.isnan(got["path_freq"][2]).all() and got["kmer_breaks"][0] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_ks_2samp(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 20, 50).astype(float)  # ties within and across
    y = rng.integers(5, 25, 70).astype(float)
    assert tspec.ks_2samp(x, y) == jspec.ks_2samp(x, y)
    assert np.isnan(tspec.ks_2samp(x, []))


@pytest.mark.parametrize("mode", ["NW", "HW"])
def test_levenshtein(mode):
    rng = np.random.default_rng(3)
    target = rand_dna(rng, 60)
    for q in ["", "A", target, target[5:40], rand_dna(rng, 25), rand_dna(rng, 90)]:
        assert tspec.levenshtein(q, target, mode) == jspec.levenshtein(q, target, mode)
    with pytest.raises(ValueError):
        tspec.levenshtein("A", "A", "SW")
