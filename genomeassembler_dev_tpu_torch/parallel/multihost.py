"""Multi-process launch and runtime (mirrors
genomeassembler_dev_tpu/parallel/multihost.py), on torch.distributed.

One process per device, on one host or several:

    from genomeassembler_dev_tpu_torch.parallel import multihost
    multihost.initialize()          # env:// under torchrun
    mesh = multihost.global_mesh(read=2, tp=2)

`initialize` wires the ranks (NCCL for CUDA, gloo for the CPU) from the
environment torchrun sets, or from an explicit `tcp://host:port` or
`file:///path` address with a world size and a rank; the (seg, read, tp)
mesh then spans every rank with the same steps as a one-rank run.

Per-rank input pipelines: shard experiment indices with `host_segment_slice`,
write each experiment's artifacts from the rank that owns it (the file per
experiment is already the restart unit), and aggregate CSVs from any rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from genomeassembler_dev_tpu_torch.parallel.mesh import make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device_type: str = "cuda") -> None:
    """init_process_group over NCCL (device_type "cuda") or gloo ("cpu").
    Without init_method the environment decides (env://: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them). On CUDA each rank
    takes the device LOCAL_RANK, else rank modulo the host's device count.
    A failed initialisation raises."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type cuda: no CUDA device here")
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no backend for device type {device_type!r}")
    kwargs = {"init_method": init_method or "env://"}
    if world_size is not None:
        kwargs.update(world_size=world_size, rank=rank)
    if backend == "nccl":
        r = rank if rank is not None else int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", r % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, **kwargs)


def global_mesh(read: int = 1, tp: int = 1, device_type: str = "cuda"):
    """(seg, read, tp) mesh over every rank."""
    return make_mesh(read=read, tp=tp, device_type=device_type)


def host_segment_slice(n_segments: int) -> range:
    """The contiguous block of experiment indices this rank owns."""
    p = dist.get_rank() if dist.is_initialized() else 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    per = -(-n_segments // n)
    return range(p * per, min((p + 1) * per, n_segments))
