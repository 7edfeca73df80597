"""Scoring solutions, for the serial Assembler, the batched runner and the
velvet path alike: how solutions and reads are padded, how many device
bytes one scoring call may take, how KS is cut into chunks of rows, and the
one body (evaluate_group) that runs breakscore, the random pass, KS and
Levenshtein on a group of members and reads the scores back.
"""

from __future__ import annotations

import numpy as np
import torch

from genomeassembler_dev_tpu_torch.core.encoding import INVALID, encode_dna
from genomeassembler_dev_tpu_torch.core.querytable import TOTAL, QueryTable
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev_tpu_torch.ops.ks import (
    batched_ks_2samp, batched_ks_2samp_masked, ks_2samp_sparse)
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
from genomeassembler_dev_tpu_torch.score.breakscore import BreakScores, breakscore, dot_f32
from genomeassembler_dev_tpu_torch.sim.reads import dedup_reads
from genomeassembler_dev_tpu_torch.utils.profiling import annotate, count, tracing

# solution rows and columns are padded to these multiples (a score group's
# members share their padded row count S)
ROW_MULTIPLE = 64
COL_MULTIPLE = 128
KS_ROWS = 256  # solution rows one KS pooled sort takes
# Device bytes one score group or velvet chunk may take: a quarter of an
# 80 GB H100, leaving the rest to the caching allocator's pools and the inputs.
EVAL_BUDGET_BYTES = 20 * 10**9


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_strings(strings: list[str], pad: int = INVALID, s_multiple: int = 1,
                 l_multiple: int = 1):
    """[S] strings -> ([S', L'] uint8 codes, [S'] int32 lens), both sizes
    rounded up to their multiples (the JAX version's bucket ladder served
    its jit cache). Pad rows have length 0."""
    L = _round_up(max((len(s) for s in strings), default=1), l_multiple)
    S = _round_up(max(len(strings), 1), s_multiple)
    mat = np.full((S, L), pad, np.uint8)
    lens = np.zeros(S, np.int32)
    for i, s in enumerate(strings):
        mat[i, : len(s)] = encode_dna(s)
        lens[i] = len(s)
    return mat, lens


def pad_reads(uniq: torch.Tensor, counts: torch.Tensor, multiple: int = 512):
    """Distinct reads padded to a multiple of rows; pad rows are invalid and
    carry count 0. Returns (codes [U', R], counts [U'], valid [U'])."""
    U = uniq.shape[0]
    Up = _round_up(max(U, 1), multiple)
    codes = torch.zeros((Up, uniq.shape[1]), dtype=torch.uint8, device=uniq.device)
    cnts = torch.zeros(Up, dtype=torch.int32, device=uniq.device)
    valid = torch.zeros(Up, dtype=torch.bool, device=uniq.device)
    codes[:U] = uniq
    cnts[:U] = counts
    valid[:U] = True
    return codes, cnts, valid


def pack_reads(read_codes: torch.Tensor, read_valid: torch.Tensor, read_chunk: int):
    """One segment's distinct reads, padded: (codes, counts, valid)."""
    return pad_reads(*dedup_reads(read_codes, read_valid), read_chunk)


def pack_member(solutions: list[str], read_codes: torch.Tensor, read_valid: torch.Tensor,
                read_chunk: int) -> tuple:
    """One member of a score group: (pmat, plens) on the host, padded to
    ROW_MULTIPLE rows and COL_MULTIPLE columns, then its distinct reads
    (codes, counts, valid) on their device."""
    return (pack_strings(solutions, s_multiple=ROW_MULTIPLE, l_multiple=COL_MULTIPLE)
            + pack_reads(read_codes, read_valid, read_chunk))


def group_size(score_group: int, rows: int, width: int, n_reads: int, track_len: int) -> int:
    """Members of one score group, each of at most `rows` solution rows of
    `width` columns and `n_reads` distinct reads: at most score_group, and
    few enough that the group stays under EVAL_BUDGET_BYTES. A row takes
    four float32 [TOTAL] matrices (counts, normalised counts, path_freq,
    the random pass's) and ~64 bytes a window and a read (the matcher's
    keys, sort and break sites); one KS chunk takes its pooled sort, ~40
    bytes an entry (values, two weights, the order, two float64 sums)."""
    row_bytes = 16 * TOTAL + 64 * (width + n_reads)
    ks_bytes = 40 * KS_ROWS * (TOTAL + track_len)
    return max(1, min(score_group, (EVAL_BUDGET_BYTES - ks_bytes) // (row_bytes * rows)))


def eval_chunk_rows(sol_len: int, n_reads: int, track_len: int) -> int:
    """Solutions evaluated at once, a multiple of ROW_MULTIPLE, so that one
    chunk's intermediates stay under EVAL_BUDGET_BYTES. Per solution row:
    ~64 bytes per window (the matcher's keys, sort and permutation, the
    profile), per distinct read (the [S, U] match and break-site arrays,
    int64) and per track entry (the KS pooled sort and its float64
    cumulative sums), plus four float32 count matrices over the
    69,904-entry table."""
    row_bytes = 64 * (sol_len + n_reads + track_len) + 16 * TOTAL
    return max(ROW_MULTIPLE, EVAL_BUDGET_BYTES // row_bytes // ROW_MULTIPLE * ROW_MULTIPLE)


def pack_chunks(solutions: list[str], n_reads: int, track_len: int):
    """The velvet path's solutions, packed for chunks of eval_chunk_rows
    rows: (pmat, plens, rows). A last partial chunk is filled with length-0
    rows; solutions that fit one chunk pad to ROW_MULTIPLE rows."""
    width = _round_up(max((len(s) for s in solutions), default=1), COL_MULTIPLE)
    rows = eval_chunk_rows(width, n_reads, track_len)
    pmat, plens = pack_strings(
        solutions, s_multiple=ROW_MULTIPLE if len(solutions) <= rows else rows,
        l_multiple=COL_MULTIPLE)
    return pmat, plens, rows


def random_scores(bs: BreakScores, plens: torch.Tensor, uniform: QueryTable):
    """The random pass: the same break counts against the uniform table.
    Returns (bp_score, norm_by_break_freqs, norm_by_len), each [S] (a
    group's [G, S])."""
    uni = uniform.combined.to(torch.float32)
    total = bs.kmer_breaks.to(torch.float32).clamp(min=1.0)
    bp_rand = dot_f32(bs.site_counts, uni)
    norm_breaks = torch.where(
        bs.kmer_breaks > 0, dot_f32(bs.site_counts / total[..., None], uni), 0.0)
    return bp_rand, norm_breaks, bp_rand / plens.to(torch.float32).clamp(min=1.0)


def path_prob_profile(pmat: torch.Tensor, plens: torch.Tensor, probs8: torch.Tensor):
    """The rolling octamer probability of every solution position
    (BreakageScorer.cpp:199-215): (profile [S, L-7] float32, valid [S, L-7]),
    windows past a solution's length masked out."""
    win8, valid = kmer_window_codes(pmat, 8, dtype=torch.int64)
    pos = torch.arange(win8.shape[1], device=pmat.device)
    valid = valid & (pos[None, :] + 8 <= plens[:, None])
    return probs8.to(torch.float32)[win8.clamp(max=65535)], valid


def evaluate_group(members: list[tuple], genome: torch.Tensor, track: torch.Tensor,
                   table: QueryTable, uniform: QueryTable, break_kmer: int,
                   segs: list[int] | None = None, score_rows=breakscore, mode: str = "NW",
                   profile_ks: bool = False) -> dict[str, np.ndarray]:
    """Host arrays [G, S] bp_score, bp_nb, bp_nl, kmer_breaks, bp_rand,
    bp_rand_nb, bp_rand_nl, ks and lev of G members packed as pack_member
    does, of one row count S (so each one's score dots take its own call's
    shape, score/breakscore.py::dot_f32), against segments genome[segs]
    [G, L] and tracks track[segs]. `score_rows` is breakscore or the mesh's
    read-sharded step. KS of path_freq is one K4 launch for the group on
    CUDA (ops/ks.py::ks_2samp_sparse); otherwise KS takes KS_ROWS rows at a
    time, of path_freq on the CPU or (profile_ks, the velvet path) of the
    masked octamer profile.
    Levenshtein is one Myers kernel call a member, in `mode`."""
    G = len(members)
    segs = list(range(G)) if segs is None else segs
    dev = genome.device
    with annotate("eval.pack"):
        if G == 1:  # a group of one is its member's arrays
            pm_np, pl_np, rc, rn, rv = (a[None] for a in members[0])
        else:
            S = members[0][0].shape[0]
            L = max(m[0].shape[1] for m in members)
            U = max(m[2].shape[0] for m in members)
            pm_np = np.full((G, S, L), INVALID, np.uint8)
            pl_np = np.zeros((G, S), np.int32)
            rc = torch.zeros((G, U, members[0][2].shape[1]), dtype=torch.uint8, device=dev)
            rn = torch.zeros((G, U), dtype=torch.int32, device=dev)
            rv = torch.zeros((G, U), dtype=torch.bool, device=dev)
            for gi, (pmat, plens, rcodes, rcounts, rvalid) in enumerate(members):
                pm_np[gi, :, : pmat.shape[1]] = pmat
                pl_np[gi] = plens
                rc[gi, : rcodes.shape[0]] = rcodes
                rn[gi, : rcounts.shape[0]] = rcounts
                rv[gi, : rvalid.shape[0]] = rvalid
        pm = torch.from_numpy(pm_np).to(dev)
        pl = torch.from_numpy(pl_np).to(dev)
    if tracing():
        count("eval.bases", int(pl_np.sum()))
        count("eval.cells", pm_np.size)
    G, S, L = pm.shape
    with annotate("eval.breakscore"):
        bs = score_rows(pm, pl, rc, rn, rv, table.combined, break_kmer=break_kmer)
    with annotate("eval.random"):
        rand, rand_nb, rand_nl = random_scores(bs, pl, uniform)
    with annotate("eval.ks"):
        path_freq = bs.path_freq.view(G * S, TOTAL)
        on_kernel = not profile_ks and dev.type == "cuda"
        if tracing():
            count("eval.ks_rows", G * S)
            count("eval.ks_kernel_rows", G * S if on_kernel else 0)
        if on_kernel:
            # one launch for the group, member gi against track[segs[gi]]; a
            # row is nonzero only at its distinct reads' break sites
            ks = ks_2samp_sparse(path_freq, track[segs], rc.shape[1]).view(G, S)
        else:
            # each row against its own segment's track
            row_seg = torch.tensor(segs, device=dev).repeat_interleave(S)
            rows_pm, rows_pl = pm.view(G * S, L), pl.view(G * S)
            parts = []
            for lo in range(0, G * S, KS_ROWS):
                rows, y = slice(lo, lo + KS_ROWS), track[row_seg[lo : lo + KS_ROWS]]
                if profile_ks:
                    prof, valid = path_prob_profile(rows_pm[rows], rows_pl[rows], table.probs[8])
                    parts.append(batched_ks_2samp_masked(prof, valid, y))
                else:
                    parts.append(batched_ks_2samp(path_freq[rows], y))
            ks = torch.cat(parts).view(G, S)
    with annotate("eval.levenshtein"):
        lev = torch.stack([batched_levenshtein_auto(pm[gi], pl[gi], genome[b], mode=mode)
                           for gi, b in enumerate(segs)])
    with annotate("eval.readback"):
        return {name: t.cpu().numpy() for name, t in (
            ("bp_score", bs.bp_score), ("bp_nb", bs.bp_score_norm_by_break_freqs),
            ("bp_nl", bs.bp_score_norm_by_len), ("kmer_breaks", bs.kmer_breaks),
            ("bp_rand", rand), ("bp_rand_nb", rand_nb), ("bp_rand_nl", rand_nl),
            ("ks", ks), ("lev", lev))}


def solution_columns(solutions: list[str], plens_np: np.ndarray, host: dict[str, np.ndarray],
                     seq_len: int) -> dict[str, np.ndarray | list]:
    """The own path's results table from every score of every solution
    (evaluate_group's host arrays of one member, pad rows allowed past
    len(solutions)): rows by true-table bp_score, descending and stable."""
    n_real = len(solutions)
    host = {name: a[:n_real] for name, a in host.items()}
    # own-path coverage fraction: every startpos is 0, so it is the longest
    # solution over seq_len, capped at 100%
    max_len = int(plens_np.max()) if solutions else 0
    contig_frac = min(100.0, 100.0 * max_len / seq_len)
    order = np.argsort(-host["bp_score"], kind="stable")
    return {
        "sequence": [solutions[i] for i in order],
        "sequence_len": plens_np[:n_real][order],
        "bp_score_true": host["bp_score"][order],
        "bp_score_norm_by_break_freqs_true": host["bp_nb"][order],
        "bp_score_norm_by_len_true": host["bp_nl"][order],
        "kmer_breaks": host["kmer_breaks"][order],
        "lev_dist_vs_true": host["lev"][order],
        "stat_test_KS_true": host["ks"][order],
        "contig_frac_len": np.full(n_real, contig_frac),
        "bp_score_random": host["bp_rand"][order],
        "bp_score_norm_by_break_freqs_random": host["bp_rand_nb"][order],
        "bp_score_norm_by_len_random": host["bp_rand_nl"][order],
        "stat_test_KS_random": host["ks"][order],
    }
