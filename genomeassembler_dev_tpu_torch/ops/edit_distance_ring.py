"""Sequence-parallel (ring) Levenshtein distance (mirrors
genomeassembler_dev_tpu/ops/edit_distance_ring.py), on torch.distributed.

The DP row is sharded across the ranks of one mesh axis: each rank owns a
contiguous slice of the query dimension. With the prefix-min row recurrence

    c[0] = row boundary,  c[j] = min(dp[j] + 1, dp[j-1] + sub_j)
    dp_new[j] = min_{l <= j} (c[l] - l) + j

a shard needs two scalars a query from its left neighbour per row: b_in,
the previous row's dp at the neighbour's last column, and k_in, the minimum
of (c[l] - l) over every column left of the shard. Rows run as a wavefront:
at step t, shard s processes row t - s, and both scalars move one ring hop a
step (`batch_isend_irecv` to (s + 1) % n inside the axis group, JAX's
ppermute). After N + n_shard steps the shards' answers meet in an
all-reduce(MIN) (JAX's pmin). A shard outside its active rows computes
nothing and only passes values on.

The Myers variant shards the query as 32-bit words (the local slice must be
a multiple of 32) and sends one horizontal-delta trit in {-1, 0, +1} a query
a step; the carry chain across a shard's words is resolved by a log2(W)
prefix composition of 2-state maps, as in JAX. Its 32-bit words live in
int64 tensors masked to 32 bits after each add, shift and complement (torch's
uint32 lacks the arithmetic).

Plain PyTorch, no kernel: each wavefront step is a Python loop iteration of
a few dozen small tensor operations, so a long target is slow (the chip run
times it in PERF.md). With one shard there is no traffic at all.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from genomeassembler_dev_tpu_torch.parallel.mesh import (
    all_reduce, axis_group, axis_index, axis_size, block)

BIG = 1 << 28
M32 = 0xFFFFFFFF
MSB = 0x80000000


class _Ring:
    """One hop a step around the ranks of a mesh axis."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.n = axis_size(mesh, axis)
        self.s = axis_index(mesh, axis)
        self.group = axis_group(mesh, axis)
        if self.group is not None:
            ranks = dist.get_process_group_ranks(self.group)
            self.next, self.prev = ranks[(self.s + 1) % self.n], ranks[(self.s - 1) % self.n]

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """x sent to the right neighbour; returns what the left one sent."""
        if self.group is None:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self.next, self.group),
               dist.P2POp(dist.irecv, out, self.prev, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def _check(mode: str) -> None:
    if mode not in ("NW", "HW"):
        raise ValueError(mode)


def make_ring_levenshtein_myers(mesh: DeviceMesh, axis: str = "read", mode: str = "NW"):
    """Returns fn(queries [B, M], query_lens [B], target [N]) -> [B] int32,
    the query dimension M sharded over `axis` in 32-bit words; every rank of
    the axis returns the whole answer."""
    _check(mode)
    ring = _Ring(mesh, axis)

    def run(queries, query_lens, target):
        B, M = queries.shape
        cols = block(M, mesh, axis)
        Ml = cols.stop - cols.start
        if Ml % 32:
            raise ValueError(f"local query slice {Ml} not a multiple of 32")
        Wl = Ml // 32
        N = target.shape[0]
        dev = queries.device
        s, first = ring.s, ring.s == 0
        qlen = query_lens.to(torch.int64)
        tgt = target.to(torch.int64)

        q = queries[:, cols].to(torch.int64).reshape(B, Wl, 32)
        weights = 1 << torch.arange(32, dtype=torch.int64, device=dev)
        peq = torch.stack([((q == c).to(torch.int64) * weights).sum(-1) for c in range(4)])

        base = s * Ml
        qm1 = torch.clamp(qlen - 1, min=0)
        owner = (qm1 >= base) & (qm1 < base + Ml)  # [B]
        wstar = torch.clamp((qm1 - base) >> 5, 0, Wl - 1)
        bstar = ((qm1 - base) & 31)[:, None]
        iota_w = torch.arange(Wl, device=dev).expand(B, Wl)
        sel_w = (iota_w == wstar[:, None]) & owner[:, None]
        top = iota_w == 0
        shifts = [1 << p for p in range(max(1, (Wl - 1).bit_length()))]

        VP = torch.full((B, Wl), M32, dtype=torch.int64, device=dev)
        VN = torch.zeros((B, Wl), dtype=torch.int64, device=dev)
        score = qlen.clone()
        best = torch.where(owner, qlen, BIG)
        hin_in = torch.zeros(B, dtype=torch.int64, device=dev)
        zero = torch.zeros(B, dtype=torch.int64, device=dev)

        def flow(eqv):
            d0 = ((((eqv & VP) + VP) & M32) ^ VP) | eqv | VN
            return d0, VN | (~(d0 | VP) & M32), VP & d0

        for t in range(1, N + ring.n + 1):
            i = t - s
            if not 1 <= i <= N:
                hin_in = ring.shift(zero)
                continue
            eq = peq.index_select(0, tgt[i - 1 : i])[0]
            # shard 0's boundary: NW hin=+1, HW hin=0; else the ring trit
            if first:
                hneg0 = torch.zeros(B, dtype=torch.bool, device=dev)
                hpos0 = torch.full((B,), mode == "NW", dtype=torch.bool, device=dev)
            else:
                hneg0, hpos0 = hin_in < 0, hin_in > 0
            D0a, HPa, HNa = flow(eq)
            D0b, HPb, HNb = flow(eq | 1)
            A = (HNa & MSB) != 0
            Bn = (HNb & MSB) != 0
            for sft in shifts:
                valid = iota_w >= sft
                A_prev = torch.roll(A, sft, dims=1) & valid
                B_prev = torch.roll(Bn, sft, dims=1) & valid
                A, Bn = torch.where(A_prev, Bn, A), torch.where(B_prev, Bn, A)
            # hout signs for both boundary hypotheses; select per query
            hout_sign = torch.where(hneg0[:, None], Bn, A)
            sw = torch.where(top, hneg0[:, None], torch.roll(hout_sign, 1, dims=1))
            D0 = torch.where(sw, D0b, D0a)
            HP = torch.where(sw, HPb, HPa)
            HN = torch.where(sw, HNb, HNa)

            hp_msb = (HP & MSB) != 0
            hn_msb = (HN & MSB) != 0
            hin_pos = torch.where(top, hpos0[:, None], torch.roll(hp_msb, 1, dims=1))
            HPs = ((HP << 1) & M32) | hin_pos.to(torch.int64)
            HNs = ((HN << 1) & M32) | sw.to(torch.int64)
            VP = HNs | (~(D0 | HPs) & M32)
            VN = HPs & D0

            dpos = ((((HP >> bstar) & 1) != 0) & sel_w).any(1)
            dneg = ((((HN >> bstar) & 1) != 0) & sel_w).any(1)
            score = score + dpos.to(torch.int64) - dneg.to(torch.int64)
            row_end = torch.where(owner, score, BIG)
            best = torch.minimum(best, row_end) if mode == "HW" else row_end
            hin_in = ring.shift(hp_msb[:, -1].to(torch.int64) - hn_msb[:, -1].to(torch.int64))

        best = all_reduce(best, mesh, axis, dist.ReduceOp.MIN)
        empty = qlen <= 0
        return torch.where(empty, 0 if mode == "HW" else N, best).to(torch.int32)

    return run


def make_ring_levenshtein(mesh: DeviceMesh, axis: str = "read", mode: str = "NW"):
    """Returns fn(queries [B, M], query_lens [B], target [N]) -> [B] int32,
    the query dimension M sharded over `axis` (M divisible by its size);
    every rank of the axis returns the whole answer. An empty query gets its
    distance, as from the Myers ring, where JAX's prefix-min ring returns
    2^28."""
    _check(mode)
    ring = _Ring(mesh, axis)

    def run(queries, query_lens, target):
        B, M = queries.shape
        cols = block(M, mesh, axis)
        Ml = cols.stop - cols.start
        N = target.shape[0]
        dev = queries.device
        s, first = ring.s, ring.s == 0
        q = queries[:, cols].to(torch.int32)
        tgt = target.to(torch.int32)
        qlen = query_lens.to(torch.int32)
        jcol = (s * Ml + 1 + torch.arange(Ml, dtype=torch.int32, device=dev)).expand(B, Ml)
        at_end = jcol == qlen[:, None]
        in_range = jcol <= qlen[:, None]

        big = torch.full((B,), BIG, dtype=torch.int32, device=dev)
        dp = torch.where(in_range, jcol, BIG)
        best = torch.where(at_end, dp, BIG).amin(dim=1)
        held_last = dp[:, -1].clone()  # row 0's boundary for the right neighbour
        b_in = k_in = big
        for t in range(1, N + ring.n + 1):
            i = t - s  # the 1-based row this shard processes now
            if not 1 <= i <= N:
                b_in, k_in = ring.shift(torch.stack([held_last, big])).unbind(0)
                continue
            sub = (q != tgt[i - 1]).to(torch.int32)
            if first:  # the row boundaries: dp_{i-1}[0] and c[0] - 0
                b_use = torch.full((B,), 0 if mode == "HW" else i - 1, dtype=torch.int32,
                                   device=dev)
                k_use = torch.full((B,), 0 if mode == "HW" else i, dtype=torch.int32,
                                   device=dev)
            else:
                b_use, k_use = b_in, k_in
            dp_left = torch.cat([b_use[:, None], dp[:, :-1]], dim=1)
            c = torch.minimum(dp + 1, dp_left + sub)
            y_scan = torch.cummin(c - jcol, dim=1).values
            dp_new = torch.minimum(y_scan, k_use[:, None]) + jcol
            dp_new = torch.where(in_range, dp_new, BIG)
            carry_out = torch.minimum(k_use, y_scan[:, -1])
            row_end = torch.where(at_end, dp_new, BIG).amin(dim=1)
            best = torch.minimum(best, row_end) if mode == "HW" else row_end
            # send the previous row's boundary (held one step) and this row's carry
            b_in, k_in = ring.shift(torch.stack([held_last, carry_out])).unbind(0)
            held_last = dp_new[:, -1]
            dp = dp_new
        best = all_reduce(best, mesh, axis, dist.ReduceOp.MIN)
        # an empty query's distance is the boundary's (JAX's ring returns BIG)
        return torch.where(qlen <= 0, 0 if mode == "HW" else N, best)

    return run
