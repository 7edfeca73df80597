"""Exact read-in-solution matching (mirrors genomeassembler_dev_tpu/ops/match.py).

The first occurrence of every distinct read in every solution, as
`std::string::find` gives it. A read of up to 31 bases is one int64 code, so
each solution's window codes are sorted once (stably, so equal codes keep
ascending positions) and every read is found by a batched binary search:
O((P + R) log P) per solution. This is the semantics of both JAX functions,
the compare grid `find_first_match` and the sort-merge join
`find_first_match_sorted`.
"""

from __future__ import annotations

import torch

from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes

MAX_READ_LEN = 31  # bases in one int64 code
_NO_WINDOW = 1 << 62  # above every 31-base code (< 4^31 = 2^62)


def find_first_match(
    path_codes: torch.Tensor,  # [S, L] base codes, pad > 3
    path_lens: torch.Tensor,  # [S]
    read_codes: torch.Tensor,  # [R, Lr] base codes (pure ACGT)
    read_valid: torch.Tensor,  # [R] bool
):
    """Returns (found [S, R] bool, first_pos [S, R] int32; 0 where not
    found). A read matches at window p iff p + Lr <= path_len and the bases
    agree; windows holding pad bases never match."""
    S, L = path_codes.shape
    R, Lr = read_codes.shape
    if Lr > MAX_READ_LEN:
        raise NotImplementedError(
            f"reads of {Lr} bases need the multi-word matcher, not ported yet "
            f"(one int64 code holds {MAX_READ_LEN})")
    P = L - Lr + 1
    win, wvalid = kmer_window_codes(path_codes, Lr, dtype=torch.int64)  # [S, P]
    pos = torch.arange(P, device=path_codes.device)
    in_range = pos[None, :] + Lr <= path_lens[:, None]
    keys = torch.where(wvalid & in_range, win, _NO_WINDOW)
    skeys, perm = torch.sort(keys, dim=1, stable=True)

    rcode = kmer_window_codes(read_codes, Lr, dtype=torch.int64)[0][:, 0]  # [R]
    q = rcode[None, :].expand(S, R).contiguous()
    idx = torch.searchsorted(skeys, q)  # first window with key >= read
    idx_c = idx.clamp(max=P - 1)
    found = (idx < P) & (skeys.gather(1, idx_c) == q) & read_valid[None, :]
    first = torch.where(found, perm.gather(1, idx_c), 0).to(torch.int32)
    return found, first
