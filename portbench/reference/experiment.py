"""The plain reference of one own-dBG experiment: from a segment and the
experiment's settings to its solutions table and stats, in NumPy and plain
PyTorch. It imports nothing of the program and takes nothing the program
made: it loads the raw probability table itself and works out again the
reads, the de Bruijn graph and its contigs, the merged solutions of every
shuffled ordering, every solution's breakage scores (true and uniform
table), its KS statistic and its Levenshtein distance to the segment.

The semantics are the reference assembler's (SahakyanLab/GenomeAssembler_dev,
lib/DeNovoAssembler.cpp, lib/GenerateReads.R, lib/DeNovoAssembler.R):

  reads     ceil(coverage * L / read_len) breakpoints drawn by inverse CDF
            over the segment's octamer probability track (float32 track,
            float64 CDF, right-sided search) from uniforms of a
            torch.Generator seeded with the experiment's seed on the run's
            device; reads overrunning the 3' end are dropped
  contigs   cpp:85-206: prefix/suffix graph of the reads' distinct k-mers,
            walks from every branch node, sorted and deduplicated
  solutions cpp:214-305: every shuffled ordering merged greedily at
            overlaps dbg_kmer-1 .. 1, the results deduplicated
  scores    cpp:316-477: the first occurrence of every distinct read, its
            break-site k-mer, multiplicities summed per site; the random
            pass uses a uniform table; KS as R's ks.test statistic; NW edit
            distance to the segment

`precision="control"` computes the float32 score dots in TF32 (operands
rounded to 10 mantissa bits, float32 sums) and the KS inputs in bfloat16:
the nearest precisions below the stated float32 with TF32 off. It is the
benchmark's control and is never used to judge a run.
"""

from __future__ import annotations

import math
import os
from collections import Counter

import numpy as np
import torch

from portbench.reference.rng import shuffle_orderings

KS = (2, 4, 6, 8)
OFFSETS = {2: 0, 4: 16, 6: 272, 8: 4368}
TOTAL = 69904
_CODE = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def codes_of(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), np.uint8)]


def kmer_code(s: str) -> int:
    v = 0
    for c in codes_of(s):
        v = (v << 2) | int(c)
    return v


def load_probs(path: str) -> dict[int, np.ndarray]:
    """The raw table (NA as NaN) with each table's NA set to its minimum,
    all four normalised jointly to sum to one; float64."""
    with np.load(path) as data:
        raw = {}
        for k in KS:
            dense = np.asarray(data[f"raw_k{k}"], np.float64)
            raw[k] = np.where(np.isnan(dense), np.nanmin(dense), dense)
    total = sum(float(raw[k].sum()) for k in KS)
    return {k: raw[k] / total for k in KS}


def default_table_path() -> str:
    return os.path.join(os.getcwd(), "data", "querytable.npz")


# -- reads ------------------------------------------------------------------


def octamer_track(segment: str, probs8: np.ndarray) -> np.ndarray:
    """float32 probability of the octamer starting at each position."""
    c = codes_of(segment).astype(np.int64)
    n = len(c) - 7
    code = np.zeros(n, np.int64)
    for j in range(8):
        code = (code << 2) | c[j : j + n]
    return probs8.astype(np.float32)[code]


def simulate_reads(segment: str, probs8: np.ndarray, read_len: int, coverage: float,
                   seed: int, device) -> list[str]:
    """The reads of the valid draws, in draw order."""
    L = len(segment)
    n = math.ceil(coverage * L / read_len)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(n, generator=gen, dtype=torch.float32, device=device).cpu().numpy()
    track = octamer_track(segment, probs8)
    cdf = np.cumsum(track.astype(np.float64))
    pos = np.searchsorted(cdf, u.astype(np.float64) * cdf[-1], side="right")
    pos = np.minimum(pos, len(track) - 1)
    return [segment[p : p + read_len] for p in pos if p + read_len <= L]


# -- de Bruijn graph --------------------------------------------------------


def contig_set(reads: list[str], k: int) -> list[str]:
    """The canonical contig set of the reads' de Bruijn graph."""
    kmers = {r[i : i + k] for r in reads for i in range(len(r) - k + 1)}
    edges: dict[str, list[str]] = {}
    for km in sorted(kmers):
        edges.setdefault(km[:-1], []).append(km[1:])
    indeg: Counter[str] = Counter()
    for lst in edges.values():
        for s in lst:
            indeg[s] += 1
    branch = {n for n, lst in edges.items() if indeg[n] != 1 or len(lst) != 1}
    contigs = set()
    for node in branch:
        for cur in edges[node]:
            path = [node]
            while cur not in branch:
                nxt = edges.get(cur)
                if not nxt:
                    break
                path.append(cur[-1])
                cur = nxt[0]
            path.append(cur[-1])
            contigs.add("".join(path))
    return sorted(contigs)


def _window_codes(c: np.ndarray, k: int) -> np.ndarray:
    """Integer code of the k-mer starting at each position of codes c."""
    n = c.size - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    out = np.zeros(n, np.int64)
    for j in range(k):
        out = (out << 2) | c[j : j + n].astype(np.int64)
    return out


def _read_keys(reads: list[str], R: int):
    """Each distinct read's integer code (reads of up to 31 bases), or None
    for longer reads, which are matched as strings."""
    if R > 31 or not reads:
        return None
    c = _CODE[np.frombuffer("".join(reads).encode(), np.uint8)].reshape(len(reads), R)
    key = np.zeros(len(reads), np.int64)
    for j in range(R):
        key = (key << 2) | c[:, j].astype(np.int64)
    return key


def _first_positions(path: str, reads: list[str], keys, R: int) -> np.ndarray:
    """The first position of each read in path, -1 where it does not occur
    (std::string::find)."""
    if keys is None:
        first: dict[str, int] = {}
        for p in range(len(path) - R + 1):
            first.setdefault(path[p : p + R], p)
        return np.array([first.get(r, -1) for r in reads], np.int64)
    win = _window_codes(codes_of(path), R)
    if win.size == 0:
        return np.full(len(reads), -1, np.int64)
    uniq, at = np.unique(win, return_index=True)  # the first window of each code
    j = np.minimum(np.searchsorted(uniq, keys), uniq.size - 1)
    return np.where(uniq[j] == keys, at[j], -1)


# -- the ordering-ensemble merge --------------------------------------------


class _Strings:
    """Interned strings: equal strings share one id. Keeps each id's
    prefix and suffix code at the overlap being merged."""

    def __init__(self, strings: list[str]):
        self.s = list(strings)
        self.ids = {s: i for i, s in enumerate(self.s)}
        self.pre = np.zeros(0, np.int64)
        self.suf = np.zeros(0, np.int64)

    def at_overlap(self, k: int) -> None:
        self.k = k
        self.pre = np.array([kmer_code(s[:k]) for s in self.s], np.int64)
        self.suf = np.array([kmer_code(s[-k:]) for s in self.s], np.int64)

    def intern(self, s: str) -> int:
        i = self.ids.get(s)
        if i is None:
            i = self.ids[s] = len(self.s)
            self.s.append(s)
            self.pre = np.append(self.pre, kmer_code(s[: self.k]))
            self.suf = np.append(self.suf, kmer_code(s[-self.k :]))
        return i


def merge_solutions(contigs: list[str], dbg_kmer: int, seed: int,
                    n_orderings: int) -> list[str]:
    """Every ordering's greedy merge, all orderings at once: for overlap k
    from dbg_kmer-1 down to 1, passes until no ordering merges; in a pass,
    slot i takes, j descending, every non-empty slot j holding another
    string whose k-prefix equals slot i's current k-suffix. Returns the
    distinct results, longest first, ties in string order."""
    C = len(contigs)
    if C == 0:
        return []
    if min(len(c) for c in contigs) < dbg_kmer:
        raise ValueError("a contig shorter than dbg_kmer")
    st = _Strings(contigs)
    slots = shuffle_orderings(C, n_orderings, seed)  # [O, C] string ids, -1 empty
    cols = np.arange(C)
    for k in range(dbg_kmer - 1, 0, -1):
        st.at_overlap(k)
        merged = True
        while merged:
            merged = False
            for i in range(C):
                rows = np.nonzero(slots[:, i] >= 0)[0]
                below = np.full(rows.size, C)  # j runs below this bound
                while rows.size:
                    sub = slots[rows]
                    cur = sub[:, i]
                    ok = ((sub >= 0) & (cols[None, :] < below[:, None])
                          & (sub != cur[:, None])
                          & (st.pre[np.maximum(sub, 0)] == st.suf[cur][:, None]))
                    has = ok.any(axis=1)
                    rows, ok, cur, below = rows[has], ok[has], cur[has], below[has]
                    if not rows.size:
                        break
                    j = C - 1 - np.argmax(ok[:, ::-1], axis=1)
                    other = slots[rows, j]
                    pairs, inv = np.unique(np.stack([cur, other], 1), axis=0,
                                           return_inverse=True)
                    new = np.array([st.intern(st.s[a] + st.s[b][k:]) for a, b in pairs],
                                   np.int64)
                    slots[rows, i] = new[inv.reshape(-1)]
                    slots[rows, j] = -1
                    below = j
                    merged = True
    out = {st.s[i] for i in np.unique(slots[slots >= 0])}
    return sorted(out, key=lambda s: (-len(s), s))


# -- scores -----------------------------------------------------------------


def _round_mantissa(x: np.ndarray, drop_bits: int) -> np.ndarray:
    """float32 values rounded to nearest even with `drop_bits` fewer
    mantissa bits (13: TF32, 16: bfloat16)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    half = (1 << (drop_bits - 1)) - 1
    b = (b + half + ((b >> drop_bits) & 1)) & ~np.uint64((1 << drop_bits) - 1)
    return (b & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def tf32(x):
    return _round_mantissa(x, 13)


def bf16(x):
    return _round_mantissa(x, 16)


def ks_statistic(x_nonzero: np.ndarray, n_zero: int, y: np.ndarray) -> float:
    """Two-sample KS statistic (R's ks.test, right-continuous ECDFs, ties
    pooled) of x = n_zero zeros and the positive values x_nonzero against
    y, computed exactly in float64 over every pooled point."""
    xs = np.sort(np.asarray(x_nonzero, np.float64))
    ys = np.sort(np.asarray(y, np.float64))
    nx = n_zero + xs.size
    pooled = np.unique(np.concatenate([xs, ys, [0.0] if n_zero else []]))
    fx = (np.searchsorted(xs, pooled, side="right")
          + np.where(pooled >= 0, n_zero, 0)) / nx
    fy = np.searchsorted(ys, pooled, side="right") / ys.size
    return float(np.abs(fx - fy).max())


def score_solutions(solutions: list[str], reads: list[str], segment: str,
                    probs: dict[int, np.ndarray], track: np.ndarray,
                    precision: str = "float64") -> dict[str, np.ndarray]:
    """Per solution, in the given order: break counts, the six bp scores,
    the KS statistic (true and random share it)."""
    counts = Counter(r for r in reads if set(r) <= set("ACGT"))
    R = len(next(iter(counts))) if counts else 0
    combined = np.concatenate([probs[k] for k in KS])
    uni = 1.0 / TOTAL
    ctl = precision == "control"
    if ctl:
        combined32 = tf32(combined.astype(np.float32))
        uni32 = tf32(np.float32(uni))
        track = bf16(track)
    n = len(solutions)
    out = {name: np.zeros(n) for name in (
        "bp", "bp_nb", "bp_nl", "rand", "rand_nb", "rand_nl", "ks")}
    out["breaks"] = np.zeros(n, np.int64)
    reads_u = list(counts)
    read_cnt = np.array([counts[r] for r in reads_u], np.float64)
    read_keys = _read_keys(reads_u, R)
    for s, path in enumerate(solutions):
        pos = _first_positions(path, reads_u, read_keys, R)
        hit = pos >= 0
        p = pos[hit]
        start = np.maximum(p - 4, 0)
        ek = np.where((start == 0) & (p >= 1) & (p <= 3), 2 * p, 8)
        code8 = _window_codes(codes_of(path), 8)
        site = code8[np.minimum(start, code8.size - 1)] >> (2 * (8 - ek))
        off = np.select([ek == 2, ek == 4, ek == 6], [OFFSETS[2], OFFSETS[4], OFFSETS[6]],
                        OFFSETS[8])
        idx, inv = np.unique(off + site, return_inverse=True)
        cnt = np.bincount(inv.reshape(-1), weights=read_cnt[hit], minlength=idx.size)
        total = float(cnt.sum())
        out["breaks"][s] = int(total)
        L = max(len(path), 1)
        if ctl:
            c32 = cnt.astype(np.float32)
            t32 = np.float32(max(total, 1.0))
            frac32 = c32 / t32
            bp = float(np.dot(tf32(c32), combined32[idx]))
            nb = float(np.dot(tf32(frac32), combined32[idx])) if total else 0.0
            rand = float(np.dot(tf32(c32), np.full(idx.size, uni32, np.float32)))
            rand_nb = (float(np.dot(tf32(frac32), np.full(idx.size, uni32, np.float32)))
                       if total else 0.0)
            freq = bf16(frac32)
        else:
            bp = float(np.dot(cnt, combined[idx]))
            nb = float(np.dot(cnt / total, combined[idx])) if total else 0.0
            rand = total * uni
            rand_nb = float(np.sum(cnt / total) * uni) if total else 0.0
            freq = cnt.astype(np.float32) / np.float32(max(total, 1.0))
        out["bp"][s], out["bp_nb"][s], out["bp_nl"][s] = bp, nb, bp / L
        out["rand"][s], out["rand_nb"][s], out["rand_nl"][s] = rand, rand_nb, rand / L
        out["ks"][s] = (ks_statistic(freq, TOTAL - idx.size, track) if total
                        else float("nan"))
    return out


def _levenshtein_rows(queries: list[str], target: str, device) -> np.ndarray:
    """NW distances by the prefix-min row DP over the target, all queries at
    once: dp_new[j] = min_{l<=j}(c[l] + j - l) with
    c[j] = min(dp[j] + 1, dp[j-1] + (q[j-1] != t[i-1])) and c[0] = i."""
    M = max(len(q) for q in queries)
    qm = np.full((len(queries), M), 254, np.uint8)
    for r, q in enumerate(queries):
        qm[r, : len(q)] = codes_of(q)
    q = torch.from_numpy(qm).to(device=device, dtype=torch.int32)
    lens = torch.tensor([len(x) for x in queries], device=device)[:, None]
    idx = torch.arange(M + 1, dtype=torch.int32, device=device)
    dp = idx[None, :].repeat(len(queries), 1)
    for i, ch in enumerate(codes_of(target).tolist(), start=1):
        sub = (q != ch).to(torch.int32)
        c_mid = torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + sub)
        c = torch.cat([torch.full_like(dp[:, :1], i), c_mid], dim=1)
        dp = torch.cummin(c - idx, dim=1).values + idx
    return dp.gather(1, lens)[:, 0].cpu().numpy().astype(np.int64)


def _levenshtein_banded(query: str, target: str) -> int:
    """NW distance in a diagonal band of half-width w, doubled until the
    distance found is at most w (then no cheaper path leaves the band)."""
    q, t = codes_of(query), codes_of(target)
    m, n = q.size, t.size
    INF = 1 << 40
    w = max(abs(m - n), 32)
    while True:
        width = 2 * w + 1
        offs = np.arange(width)
        j = offs - w  # row 0: column j = o - w
        dp = np.where((j >= 0) & (j <= m), j, INF).astype(np.int64)
        qpad = np.concatenate([q, [254]])
        for i in range(1, n + 1):
            j = i - w + offs
            inside = (j >= 0) & (j <= m)
            up = np.concatenate([dp[1:], [INF]])  # dp[i-1][j]
            sub = (qpad[np.clip(j - 1, 0, m)] != t[i - 1]).astype(np.int64)
            c = np.minimum(up + 1, dp + sub)  # dp[i-1][j-1] sits at the same offset
            c = np.where(j == 0, i, c)
            c = np.where(inside, np.minimum(c, INF), INF)
            dp = np.minimum.accumulate(c - offs) + offs
            dp = np.where(inside, dp, INF)
        d = int(dp[m - n + w])
        if d <= w or w >= max(m, n):
            return d
        w *= 2


def levenshtein_nw(queries: list[str], target: str, device) -> np.ndarray:
    if not queries:
        return np.zeros(0, np.int64)
    if len(target) <= 4096:
        return np.concatenate([_levenshtein_rows(queries[lo : lo + 4096], target, device)
                               for lo in range(0, len(queries), 4096)])
    return np.array([_levenshtein_banded(q, target) for q in queries], np.int64)


# -- one experiment ---------------------------------------------------------


def run(segment: str, cfg: dict, probs: dict[int, np.ndarray], device,
        precision: str = "float64") -> dict:
    """The experiment's outputs: {"rows": {sequence: {column: value}},
    "stats": {...}}, keyed by solution."""
    reads = simulate_reads(segment, probs[8], cfg["read_len"], cfg["coverage_target"],
                           cfg["seed"], device)
    contigs = contig_set(reads, cfg["dbg_kmer"])
    sols = merge_solutions(contigs, cfg["dbg_kmer"], cfg["seed"], cfg["n_orderings"])
    track = octamer_track(segment, probs[8])
    sc = score_solutions(sols, reads, segment, probs, track, precision)
    lev = levenshtein_nw(sols, segment, device)
    L = len(segment)
    frac = min(100.0, 100.0 * max((len(s) for s in sols), default=0) / L)
    rows = {}
    for r, s in enumerate(sols):
        rows[s] = {
            "sequence_len": len(s),
            "bp_score_true": sc["bp"][r],
            "bp_score_norm_by_break_freqs_true": sc["bp_nb"][r],
            "bp_score_norm_by_len_true": sc["bp_nl"][r],
            "kmer_breaks": int(sc["breaks"][r]),
            "lev_dist_vs_true": int(lev[r]),
            "stat_test_KS_true": sc["ks"][r],
            "contig_frac_len": frac,
            "bp_score_random": sc["rand"][r],
            "bp_score_norm_by_break_freqs_random": sc["rand_nb"][r],
            "bp_score_norm_by_len_random": sc["rand_nl"][r],
            "stat_test_KS_random": sc["ks"][r],
        }
    acgt = np.bincount(codes_of(segment)[codes_of(segment) <= 3], minlength=4)
    stats = {
        "base_composition": (acgt / L).tolist(),
        "coverage": round(len(reads) * cfg["read_len"] / L, 3),
        "nr_of_reads": len(reads),
        "genome_seq": segment,
    }
    return {"rows": rows, "stats": stats, "n_contigs": len(contigs)}
