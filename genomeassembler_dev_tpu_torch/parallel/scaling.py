"""Scaling-efficiency harness (mirrors genomeassembler_dev_tpu/parallel/scaling.py).

Measures the throughput of the sharded simulate+count step at increasing
device counts and reports efficiency against linear scaling from the
smallest count. Each count n runs on a mesh over the first n ranks of the
initialised process group (the others wait); under torchrun every rank of
the world takes part, and a one-rank group measures one device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from genomeassembler_dev_tpu_torch.parallel.mesh import make_mesh
from genomeassembler_dev_tpu_torch.parallel.sharding import make_sim_count_step


@dataclass
class ScalingPoint:
    n_devices: int
    seconds: float
    reads_per_s: float
    efficiency: float  # vs the smallest measured device count


def measure_scaling(
    genomes: np.ndarray,  # [B, L] codes; B divisible by every device count
    probs_k8: np.ndarray,
    read_len: int,
    n_draws_per_seg: int,
    device_counts: list[int],
    device,
    count_k: int = 8,
    reps: int = 3,
) -> list[ScalingPoint]:
    """Every rank calls this; every rank returns rank 0's points. Steps run
    on `device` (this rank's device); times are rank 0's host clock around
    `reps` steps that end in a synchronise and a barrier of the mesh."""
    device = torch.device(device)
    B = genomes.shape[0]
    world = dist.get_world_size()
    g = torch.from_numpy(np.asarray(genomes)).to(device)
    seeds = torch.arange(B, dtype=torch.int32, device=device)
    probs = torch.as_tensor(np.asarray(probs_k8), dtype=torch.float32, device=device)
    points: list[ScalingPoint] = []
    for n in device_counts:
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} devices")
        if n > world:
            raise ValueError(f"{n} devices asked, {world} ranks in the group")
        mesh = make_mesh(seg=n, read=1, tp=1, device_type=device.type)
        if mesh.get_coordinate() is not None:
            group = mesh.get_group("seg")
            step = make_sim_count_step(mesh, read_len, n_draws_per_seg, count_k)

            def run():
                out = step(g, seeds, probs)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dist.barrier(group=group)
                return out

            run()  # warm: the kernel's build and first launch stay outside
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            dt = (time.perf_counter() - t0) / reps
            points.append(ScalingPoint(n, dt, B * n_draws_per_seg / dt, 0.0))
        dist.barrier()
    base = points[0] if points else None
    for p in points:
        p.efficiency = p.reads_per_s / (base.reads_per_s * p.n_devices / base.n_devices)
    box = [points]
    dist.broadcast_object_list(box, src=0)
    return box[0]
