"""String-level executable spec of the reference assembler and scorer
(mirrors genomeassembler_dev_tpu/spec/reference_semantics.py): the dBG
contig set, the ordering-ensemble merge, the breakage score, the KS
statistic and the edit distance.

Clarity over speed: pure Python and numpy. It backs `merge_backend="spec"`
and the device merge's exact collision guard (merge/device.py), and tests
hold the port's tensor code against it.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
from genomeassembler_dev_tpu_torch.core.querytable import OFFSETS, TOTAL, QueryTable
from genomeassembler_dev_tpu_torch.core.rng import MT19937, std_shuffle


def kmer_code(seq: str) -> int:
    """Big-endian integer code of a k-mer string."""
    codes = encode_dna(seq)
    if codes.size and codes.max() > 3:
        raise ValueError(f"kmer_code: non-ACGT character in {seq!r}")
    val = 0
    for c in codes:
        val = (val << 2) | int(c)
    return val


# ---------------------------------------------------------------------------
# de Bruijn graph -> contigs (ref: lib/DeNovoAssembler.cpp:85-206)
# ---------------------------------------------------------------------------


def get_contig_set(read_kmers: list[str], dbg_kmer: int) -> list[str]:
    """Canonical (sorted, deduplicated) contig set of the reference dBG.

    Reproduces get_contigs up to the shuffling step:
      * prefix/suffix split of each k-mer (cpp:94-101),
      * adjacency map prefix -> unique suffixes, multiplicity discarded
        (cpp:104-122),
      * in/out-degree balance per node (cpp:124-158),
      * branch nodes: degree != (1,1) and at least one out-edge (cpp:160-169),
      * walk from every branch node along every out-edge, appending the last
        character of each visited node, stopping at the next branch node or
        at a dead end (cpp:171-189),
      * sort + dedup (cpp:192).

    The contig *set* is independent of hash-map iteration order and of edge
    insertion order: walks only pass through (in=1, out=1) nodes, whose single
    successor is unique, and the final sort+dedup canonicalises everything.
    """
    k = dbg_kmer
    edges: dict[str, list[str]] = {}
    for km in read_kmers:
        p, s = km[: k - 1], km[1:k]
        lst = edges.setdefault(p, [])
        if s not in lst:
            lst.append(s)

    nodes = set(edges)
    for lst in edges.values():
        nodes.update(lst)
    indeg = dict.fromkeys(nodes, 0)
    outdeg = dict.fromkeys(nodes, 0)
    for p, lst in edges.items():
        outdeg[p] += len(lst)
        for s in lst:
            indeg[s] += 1

    branch = {n for n in nodes if (indeg[n] != 1 or outdeg[n] != 1) and n in edges}

    contigs = set()
    for node in branch:
        for edge in edges[node]:
            cur = edge
            path = node
            while cur not in branch:
                nxt = edges.get(cur)
                if not nxt:
                    break
                path += cur[-1]
                cur = nxt[0]
            path += cur[-1]
            contigs.add(path)
    return sorted(contigs)


# ---------------------------------------------------------------------------
# greedy overlap merge (ref: lib/DeNovoAssembler.cpp:214-305)
# ---------------------------------------------------------------------------


def shuffled_orderings(contigs: list[str], seed: int, n_orderings: int) -> list[list[str]]:
    """The reference's shuffled contig matrix (cpp:194-205): n_orderings
    std::shuffle'd copies of the canonical contig list, engine state carried
    across orderings. Own path uses 10,000, velvet path 20,000
    (lib/BreakageScorer.cpp:85-94)."""
    eng = MT19937(seed)
    out = []
    for _ in range(n_orderings):
        cp = list(contigs)
        std_shuffle(cp, eng)
        out.append(cp)
    return out


def merge_one_ordering(contigs: list[str], dbg_kmer: int) -> list[str]:
    """One ordering's greedy merge fixpoint (cpp:228-266), bit-exact:

    for k = dbg_kmer-1 .. 1:
      repeat until the contig count stops changing:
        for i ascending (skipping emptied slots):
          for j descending over the whole list:
            if str(i) != str(j) and suffix_k(i) == prefix_k(j):
              contig[i] += contig[j][k:]; contig[j] = ""
        drop emptied slots

    Note contigs[i] is re-read after every merge (its suffix changes mid-scan)
    and the i != j case with *equal strings* is skipped, both as in the C++.
    """
    contigs = list(contigs)
    for k in range(dbg_kmer - 1, 0, -1):
        changed = True
        while changed:
            before = len(contigs)
            for i in range(len(contigs)):
                if contigs[i] == "":
                    continue
                for j in range(len(contigs) - 1, -1, -1):
                    ci = contigs[i]
                    cj = contigs[j]
                    # contigs shorter than the overlap are skipped: the
                    # reference's substr would throw out_of_range there
                    # (own-path contigs are always >= dbg_kmer, so this
                    # only affects short *external* contigs); all backends
                    # share this robustness contract
                    if (ci != cj and cj != "" and len(ci) >= k and len(cj) >= k
                            and ci[-k:] == cj[:k]):
                        contigs[i] = ci + cj[k:]
                        contigs[j] = ""
            contigs = [c for c in contigs if c != ""]
            changed = before != len(contigs)
    return contigs


def assemble_solutions(contig_matrix: list[list[str]], dbg_kmer: int) -> list[str]:
    """Merge every ordering, flatten, dedup, and sort by length descending
    (cpp:214-305). The reference's final std::sort is unstable, so the order
    of equal-length solutions is unspecified there; ties are ordered
    lexicographically. The solution *set* is bit-identical."""
    flat = set()
    for contigs in contig_matrix:
        flat.update(merge_one_ordering(contigs, dbg_kmer))
    return sorted(flat, key=lambda s: (-len(s), s))


# ---------------------------------------------------------------------------
# breakage scoring (ref: lib/DeNovoAssembler.cpp:316-477)
# ---------------------------------------------------------------------------

# pos -> shrunken k-mer length at the path start (cpp:369-381)
_EDGE_SHRINK = {1: 2, 2: 4, 3: 6}


def break_site(path: str, pos: int, kmer: int) -> tuple[int, str]:
    """Breakpoint k-mer for a read matching `path` at `pos` (cpp:362-386):
    start = max(0, pos - kmer//2); an octamer unless start hits the path
    start with pos in {1,2,3}, which shrinks it to a 2/4/6-mer."""
    start = max(0, pos - kmer // 2)
    ek = 8
    if start == 0:
        ek = _EDGE_SHRINK.get(pos, 8)
    return start, path[start : start + ek]


def calc_breakscore(
    paths: list[str],
    sequencing_reads: list[str],
    true_solution: str,
    kmer: int,
    table: QueryTable,
) -> dict:
    """Reference calc_breakscore (own path, cpp:316-477).

    Per solution: exact substring search of every *distinct* read (dedup with
    counts, cpp:333-337; first occurrence only, cpp:360), break-site k-mer
    extraction with edge shrinkage, scatter-add of read multiplicities, then

      bp_score                    = sum prob * count            (cpp:407-408)
      bp_score_norm_by_break_freqs= sum prob * count/total      (cpp:411-413)
      bp_score_norm_by_len        = bp_score / len(path)        (cpp:424-426)
      kmer_breaks                 = total matched read count    (cpp:421)
      path_freq                   = count/total over all 69,904 table k-mers
                                    (NaN when no read matches,  cpp:402)
      lev_dist_vs_true            = NW edit distance            (cpp:462-464)

    path_freq is emitted in canonical combined-table order; the reference
    emits it in gtl hash-map order, which only feeds an order-invariant KS
    test (lib/DeNovoAssembler.R:419-426), so the statistic is unchanged.
    """
    probs = {k: p.cpu().numpy() for k, p in table.probs.items()}
    read_counts = Counter(sequencing_reads)
    n_rows = len(paths)
    out = {
        "sequence": list(paths),
        "sequence_len": [len(p) for p in paths],
        "bp_score": np.zeros(n_rows),
        "bp_score_norm_by_break_freqs": np.zeros(n_rows),
        "bp_score_norm_by_len": np.zeros(n_rows),
        "kmer_breaks": np.zeros(n_rows, dtype=np.int64),
        "lev_dist_vs_true": np.zeros(n_rows, dtype=np.int64),
        "path_freq": np.zeros((n_rows, TOTAL)),
    }
    for i, path in enumerate(paths):
        site_counts: Counter[str] = Counter()
        total = 0
        for read, cnt in read_counts.items():
            pos = path.find(read)
            if pos != -1:
                _, broken = break_site(path, pos, kmer)
                site_counts[broken] += cnt
                total += cnt

        score = 0.0
        norm_score = 0.0
        freq = np.zeros(TOTAL)
        for km, cnt in site_counts.items():
            prob = probs[len(km)][kmer_code(km)]
            score += prob * cnt
            norm_score += prob * (cnt / total)
            freq[OFFSETS[len(km)] + kmer_code(km)] = cnt
        out["bp_score"][i] = score
        out["bp_score_norm_by_break_freqs"][i] = norm_score
        out["bp_score_norm_by_len"][i] = score / len(path)
        out["kmer_breaks"][i] = total
        # 0/0 -> NaN matches the C++ double division when nothing matched
        out["path_freq"][i] = freq / total if total else np.nan
        out["lev_dist_vs_true"][i] = levenshtein(path, true_solution, mode="NW")
    return out


# ---------------------------------------------------------------------------
# statistics (ref: lib/DeNovoAssembler.R:419-426; edlib)
# ---------------------------------------------------------------------------


def ks_2samp(x: np.ndarray, y: np.ndarray) -> float:
    """Exact two-sample Kolmogorov-Smirnov statistic, as R's ks.test
    (lib/DeNovoAssembler.R:419-426): sup_t |F_x(t) - F_y(t)| over the pooled
    sample points, ties handled by right-continuous ECDFs."""
    x = np.sort(np.asarray(x, dtype=np.float64))
    y = np.sort(np.asarray(y, dtype=np.float64))
    if x.size == 0 or y.size == 0:
        return float("nan")
    pooled = np.concatenate([x, y])
    cdf_x = np.searchsorted(x, pooled, side="right") / x.size
    cdf_y = np.searchsorted(y, pooled, side="right") / y.size
    return float(np.abs(cdf_x - cdf_y).max())


def levenshtein(query: str, target: str, mode: str = "NW") -> int:
    """Edit distance, replicating edlib's two task modes used by the
    reference: NW (global; lib/DeNovoAssembler.cpp:46) and HW (infix: target
    prefix/suffix free; lib/BreakageScorer.cpp:46).

    Row-scan DP over the target with the prefix-min formulation
    dp_new[j] = min_{l<=j} (c[l] + (j-l)), the same recurrence the device
    kernel uses (ops/edit_distance.py)."""
    if mode not in ("NW", "HW"):
        raise ValueError(mode)
    q = np.frombuffer(query.encode(), dtype=np.uint8)
    t = np.frombuffer(target.encode(), dtype=np.uint8)
    m = q.size
    idx = np.arange(m + 1, dtype=np.int64)
    dp = idx.copy()  # row 0: distance to query prefixes
    best = dp[m]
    for i in range(1, t.size + 1):
        sub = (q != t[i - 1]).astype(np.int64)
        c = np.empty(m + 1, dtype=np.int64)
        c[0] = 0 if mode == "HW" else i
        c[1:] = np.minimum(dp[1:] + 1, dp[:-1] + sub)
        dp = np.minimum.accumulate(c - idx) + idx
        best = min(best, dp[m])
    return int(best if mode == "HW" else dp[m])
