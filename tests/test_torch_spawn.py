"""The harness of the port's multi-process tests: `run_ranks` (or
`start_ranks`, which returns while they run) runs a function on real gloo
ranks (torch.multiprocessing.spawn, a file:// store in
the test's tmp path, never a TCP port), joins them within a deadline and
returns each rank's result. Its own tests: two ranks through
parallel.multihost (initialize, global_mesh, host_segment_slice), and a
failing rank failing the caller."""

import os
import pickle
import time

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from genomeassembler_dev_tpu_torch.parallel import multihost  # noqa: E402

JOIN_SECONDS = 120


def _entry(rank, fn, world, store, out_dir):
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    multihost.initialize(f"file://{store}", world, rank, device_type="cpu")
    try:
        result = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def start_ranks(fn, world: int, tmp_dir, *args, timeout: float = JOIN_SECONDS):
    """Start fn(rank, *args) on `world` gloo ranks of one process group (CPU
    device) and return a function that waits for them and returns their
    return values in rank order. A rank that raises fails the caller with
    its traceback; ranks still running at the deadline are killed and the
    caller fails."""
    tmp_dir = str(tmp_dir)
    store = os.path.join(tmp_dir, "store")
    # the inputs go through a file: spawn's pipe would hold each start until
    # the child has imported fn's module and read them, one rank at a time
    with open(os.path.join(tmp_dir, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    ctx = mp.spawn(_entry, args=(fn, world, store, tmp_dir), nprocs=world, join=False)
    deadline = time.monotonic() + timeout

    def wait() -> list:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join(10)
                pytest.fail(f"{world} gloo ranks did not finish within {timeout} s")
        results = []
        for rank in range(world):
            with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results

    return wait


def run_ranks(fn, world: int, tmp_dir, *args, timeout: float = JOIN_SECONDS) -> list:
    """start_ranks(...) and wait for the results."""
    return start_ranks(fn, world, tmp_dir, *args, timeout=timeout)()


def _multihost_case(rank):
    mesh = multihost.global_mesh(read=2, device_type="cpu")
    t = torch.tensor([rank + 1])
    dist.all_reduce(t)
    return {"slice": list(multihost.host_segment_slice(10)),
            "mesh": (mesh.size(0), mesh.size(1), mesh.size(2)),
            "world": dist.get_world_size(), "sum": int(t)}


def test_two_ranks_multihost(tmp_path):
    got = run_ranks(_multihost_case, 2, tmp_path)
    # host_segment_slice: disjoint contiguous halves covering every index
    assert [g["slice"] for g in got] == [list(range(0, 5)), list(range(5, 10))]
    assert all(g["mesh"] == (1, 2, 1) and g["world"] == 2 and g["sum"] == 3 for g in got)


def test_host_segment_slice_without_a_group():
    assert not dist.is_initialized()
    assert list(multihost.host_segment_slice(3)) == [0, 1, 2]


def _failing_case(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def test_a_failing_rank_fails_the_caller(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        run_ranks(_failing_case, 2, tmp_path)
