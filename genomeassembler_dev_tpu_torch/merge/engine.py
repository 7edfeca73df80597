"""Solution assembly (mirrors genomeassembler_dev_tpu/merge/engine.py,
native backend only): the shuffled ordering ensemble -> merged,
deduplicated solutions sorted by (-length, lexicographic)."""

from __future__ import annotations

from genomeassembler_dev_tpu_torch.merge import native


def assemble_solutions(contigs: list[str], dbg_kmer: int, seed: int,
                       n_orderings: int = 10000, backend: str = "auto",
                       n_threads: int | None = None) -> list[str]:
    """"auto" is "native": the device merge and the spec fallback of the JAX
    package are not ported."""
    if backend not in ("auto", "native"):
        raise NotImplementedError(
            f"merge backend {backend!r} is not ported; use 'native'")
    return native.assemble_native(contigs, dbg_kmer, seed, n_orderings, n_threads)
