"""Exact read-in-solution matching (mirrors genomeassembler_dev_tpu/ops/match.py).

The first occurrence of every distinct read in every solution, as
`std::string::find` gives it. Each window of a solution gets one int64 key,
the windows of each solution are sorted once (stably, so equal keys keep
ascending positions) and every read's key is found by a batched binary
search: O((P + R) log P) per solution. This is the semantics of both JAX
functions, the compare grid `find_first_match` and the sort-merge join
`find_first_match_sorted`.

A read of up to 31 bases is its own key. A longer read is cut into words of
up to 31 bases, and the windows' and reads' word tuples are ranked jointly
(torch.unique over rows): equal tuples share a rank, and the rank is the key.

Reads [G, R, Lr] match a group of G segments in one call: the solution rows
split into G equal blocks, and each block searches its own segment's reads.
"""

from __future__ import annotations

import torch

from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes

WORD_BASES = 31  # bases in one int64 code
_NO_WINDOW = 1 << 62  # above every key: 31-base codes are < 4^31 = 2^62


def _word_keys(path_codes: torch.Tensor, read_codes: torch.Tensor):
    """Window keys [S, P] and read keys [R] of reads longer than one word;
    invalid windows (holding pad bases) get garbage keys, masked by the
    caller, and their validity comes back as the third output."""
    S, L = path_codes.shape
    Lr = read_codes.shape[1]
    P = L - Lr + 1
    win_words, read_words = [], []
    wvalid = torch.ones((S, P), dtype=torch.bool, device=path_codes.device)
    for start in range(0, Lr, WORD_BASES):
        n = min(WORD_BASES, Lr - start)
        codes, valid = kmer_window_codes(path_codes, n, dtype=torch.int64)
        win_words.append(codes[:, start : start + P].reshape(-1))
        wvalid &= valid[:, start : start + P]
        read_words.append(kmer_window_codes(read_codes[:, start : start + n], n,
                                            dtype=torch.int64)[0][:, 0])
    rows = torch.cat([torch.stack(win_words, 1), torch.stack(read_words, 1)])
    rank = torch.unique(rows, dim=0, return_inverse=True)[1]
    return rank[: S * P].view(S, P), rank[S * P :], wvalid


def find_first_match(
    path_codes: torch.Tensor,  # [S, L] base codes, pad > 3
    path_lens: torch.Tensor,  # [S]
    read_codes: torch.Tensor,  # [R, Lr] or, for G groups of S/G rows, [G, R, Lr] (pure ACGT)
    read_valid: torch.Tensor,  # [R] or [G, R] bool
):
    """Returns (found [S, R] bool, first_pos [S, R] int32; 0 where not
    found). A read matches at window p iff p + Lr <= path_len and the bases
    agree; windows holding pad bases never match. With grouped reads, rows
    g * S/G ... (g + 1) * S/G - 1 are matched against read_codes[g]."""
    S, L = path_codes.shape
    reads = read_codes.reshape((-1,) + read_codes.shape[-2:])  # [G, R, Lr]
    G, R, Lr = reads.shape
    P = L - Lr + 1
    if Lr <= WORD_BASES:
        win, wvalid = kmer_window_codes(path_codes, Lr, dtype=torch.int64)  # [S, P]
        rcode = kmer_window_codes(reads, Lr, dtype=torch.int64)[0][..., 0]  # [G, R]
    else:
        win, rcode, wvalid = _word_keys(path_codes, reads.reshape(G * R, Lr))
        rcode = rcode.view(G, R)
    pos = torch.arange(P, device=path_codes.device)
    in_range = pos[None, :] + Lr <= path_lens[:, None]
    keys = torch.where(wvalid & in_range, win, _NO_WINDOW)
    skeys, perm = torch.sort(keys, dim=1, stable=True)

    q = rcode.repeat_interleave(S // G, dim=0)  # [S, R]: each row's reads
    idx = torch.searchsorted(skeys, q)  # first window with key >= read
    idx_c = idx.clamp(max=P - 1)
    rvalid = read_valid.reshape(G, R).repeat_interleave(S // G, dim=0)
    found = (idx < P) & (skeys.gather(1, idx_c) == q) & rvalid
    first = torch.where(found, perm.gather(1, idx_c), 0).to(torch.int32)
    return found, first
