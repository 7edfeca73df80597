"""Solution assembly (mirrors genomeassembler_dev_tpu/merge/engine.py): the
shuffled ordering ensemble -> merged, deduplicated solutions sorted by
(-length, lexicographic).

Backends: "native" (the threaded C++ engine, merge/native.py), "device" (the
ensemble on a torch device, merge/device.py), "spec" (the string-level spec)
and "auto". Auto follows the JAX package's crossover table and picks the
device merge only when the merge's device is CUDA and dbg_kmer is within the
device merge's MAX_DBG_KMER; otherwise native. There is no spec fallback: the
native engine builds or raises.
"""

from __future__ import annotations

import torch

from genomeassembler_dev_tpu_torch.merge import native
from genomeassembler_dev_tpu_torch.merge.device import MAX_DBG_KMER, assemble_device
from genomeassembler_dev_tpu_torch.spec import reference_semantics as spec
from genomeassembler_dev_tpu_torch.utils.profiling import count, tracing


def preferred_backend(n_contigs: int, n_orderings: int, native_ok: bool,
                      accelerator_ok: bool) -> str:
    """The JAX package's crossover table (measured there on a TPU v5e host,
    studies/merge_xover.log): the device merge at C >= 128 for any ordering
    count and at C >= 64 with 10,000 or more orderings; native below."""
    device_wins = n_contigs >= 128 or (n_contigs >= 64 and n_orderings >= 10000)
    if accelerator_ok and device_wins:
        return "device"
    if native_ok:
        return "native"
    return "device" if accelerator_ok and n_contigs >= 32 else "spec"


def assemble_solutions(contigs: list[str], dbg_kmer: int, seed: int,
                       n_orderings: int = 10000, backend: str = "auto",
                       n_threads: int | None = None, device="cpu") -> list[str]:
    """Merge the shuffled ordering ensemble of `contigs` into solutions,
    sorted by (-length, lexicographic). The device backend runs on
    `device`; auto takes it only where `device` is CUDA and dbg_kmer at most
    MAX_DBG_KMER (the velvet grid's rows 25:19 and 40:37 merge natively).
    While a trace records, it counts the contigs in (merge.contigs), the
    solutions out (merge.solutions) and the call under the backend it ran
    (merge.calls.<backend>)."""
    if backend == "auto":
        backend = preferred_backend(
            len(contigs), n_orderings, True,
            torch.device(device).type == "cuda" and dbg_kmer <= MAX_DBG_KMER)
    if backend == "native":
        sols = native.assemble_native(contigs, dbg_kmer, seed, n_orderings, n_threads)
    elif backend == "device":
        sols = assemble_device(contigs, dbg_kmer, seed, n_orderings, device)
    elif backend == "spec":
        sols = spec.assemble_solutions(spec.shuffled_orderings(contigs, seed, n_orderings),
                                       dbg_kmer)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if tracing():
        count(f"merge.calls.{backend}")
        count("merge.contigs", len(contigs))
        count("merge.solutions", len(sols))
    return sols
