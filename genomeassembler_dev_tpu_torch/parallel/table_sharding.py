"""Hash-sharded QueryTable lookups with all-to-all exchange (mirrors
genomeassembler_dev_tpu/parallel/table_sharding.py), on torch.distributed.

The k=8 table is only 64Ki floats, so replication is the right default. This
module is the path for tables that do NOT fit on one device (larger k,
learned models): the table is row-sharded by the code's high bits, and a
lookup routes each query code to its owning shard and the probability back
(`all_to_all_single` three times: codes, valid flags, then values).

Routing uses fixed-capacity buckets, as in JAX: each rank prepares `cap`
query slots for each destination shard, in the queries' stable order; a
query beyond its bucket's cap gets NaN, and the overflow count (summed over
the axis) tells the caller to re-run with a larger cap.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from genomeassembler_dev_tpu_torch.parallel.mesh import (
    all_reduce, axis_group, axis_index, axis_size, block)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row i of x [n_shard, cap] to shard i; returns the rows received, row
    j from shard j."""
    if group is None:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def make_sharded_table_lookup(mesh: DeviceMesh, table_size: int, axis: str = "tp",
                              cap: int | None = None):
    """Returns fn(codes [B, N], table) -> (probs [B, N/n_shard], overflow
    count). codes are the global queries, sharded over `axis` along N (each
    rank routes its own block); table is the whole table or this rank's
    [table_size/n_shard] rows. probs is this rank's block (float32, NaN for
    an overflowed query); the overflow count is summed over the axis."""
    n_shard = axis_size(mesh, axis)
    if table_size % n_shard:
        raise ValueError("table size must divide the shard count")
    rows_local = table_size // n_shard
    group = axis_group(mesh, axis)
    me = axis_index(mesh, axis)

    def lookup(codes: torch.Tensor, table: torch.Tensor):
        dev = codes.device
        if table.shape[0] == table_size:
            table = table[me * rows_local : (me + 1) * rows_local]
        elif table.shape[0] != rows_local:
            raise ValueError(f"table of {table.shape[0]} rows: neither {table_size} nor "
                             f"the shard's {rows_local}")
        local_codes = codes[:, block(codes.shape[1], mesh, axis)]
        B, Nl = local_codes.shape
        flat = local_codes.reshape(-1).to(torch.int64)
        if bool(((flat < 0) | (flat >= table_size)).any()):
            raise ValueError(f"codes outside [0, {table_size})")
        n = flat.shape[0]
        bucket_cap = cap or max(64, (2 * n) // n_shard)

        dest = flat // rows_local  # owning shard of each code
        order = torch.sort(dest, stable=True).indices
        sorted_dest = dest[order]
        seg_start = torch.searchsorted(sorted_dest, torch.arange(n_shard, device=dev))
        pos_in_bucket = torch.arange(n, device=dev) - seg_start[sorted_dest]
        slot_ok = pos_in_bucket < bucket_cap
        rows = torch.where(slot_ok, sorted_dest, 0)
        cols = torch.clamp(pos_in_bucket, max=bucket_cap - 1)
        send_codes = torch.zeros((n_shard, bucket_cap), dtype=torch.int32, device=dev)
        send_valid = torch.zeros((n_shard, bucket_cap), dtype=torch.int32, device=dev)
        send_codes[rows[slot_ok], cols[slot_ok]] = flat[order][slot_ok].to(torch.int32)
        send_valid[rows[slot_ok], cols[slot_ok]] = 1
        overflow = (~slot_ok).sum()

        # route queries to owners, gather locally, route results back
        recv_codes = _all_to_all(send_codes, group)
        recv_valid = _all_to_all(send_valid, group) != 0
        local = torch.clamp(recv_codes.long() - me * rows_local, 0, rows_local - 1)
        vals = torch.where(recv_valid, table.to(torch.float32)[local], 0.0)
        back = _all_to_all(vals, group)

        # un-bucket: the value of sorted query q is back[dest_q, pos_q]
        out = torch.empty(n, dtype=torch.float32, device=dev)
        out[order] = torch.where(slot_ok, back[rows, cols], float("nan"))
        return out.view(B, Nl), all_reduce(overflow, mesh, axis)

    return lookup
