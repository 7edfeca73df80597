"""ctypes binding to the native merge/baseline engine (mirrors
genomeassembler_dev_tpu/merge/native.py).

Shares native/gadev.cpp and native/Makefile with the JAX package: the library
is built with `make -C native` at first use. There is no fallback; a missing
compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libgadev.so")

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            r = subprocess.run(["make", "-C", _NATIVE_DIR, "-s"],
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise RuntimeError(
                    f"building the native engine failed:\n{r.stderr[-2000:]}")
        lib = ctypes.CDLL(_SO_PATH)
        lib.gadev_assemble.restype = ctypes.c_void_p
        lib.gadev_assemble.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
        ]
        lib.gadev_contigs_from_reads.restype = ctypes.c_void_p
        lib.gadev_contigs_from_reads.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.gadev_breakscore.restype = None
        lib.gadev_breakscore.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.gadev_count_kmers.restype = ctypes.c_long
        lib.gadev_count_kmers.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.gadev_result_count.restype = ctypes.c_int
        lib.gadev_result_count.argtypes = [ctypes.c_void_p]
        lib.gadev_result_get.restype = ctypes.POINTER(ctypes.c_char)
        lib.gadev_result_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.gadev_result_free.restype = None
        lib.gadev_result_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _collect_results(lib, handle) -> list[str]:
    try:
        n = lib.gadev_result_count(handle)
        out = []
        ln = ctypes.c_int()
        for i in range(n):
            ptr = lib.gadev_result_get(handle, i, ctypes.byref(ln))
            out.append(ctypes.string_at(ptr, ln.value).decode())
        return out
    finally:
        lib.gadev_result_free(handle)


def assemble_native(contigs: list[str], dbg_kmer: int, seed: int,
                    n_orderings: int, n_threads: int | None = None) -> list[str]:
    """Shuffle + merge + dedup across the ordering ensemble in native code.
    Returns solutions sorted by (-length, lexicographic)."""
    lib = _load()
    n_threads = n_threads or os.cpu_count() or 1
    buf = "".join(contigs).encode()
    lens = (ctypes.c_int * len(contigs))(*[len(c) for c in contigs])
    handle = lib.gadev_assemble(buf, lens, len(contigs), dbg_kmer, seed,
                                n_orderings, n_threads)
    return _collect_results(lib, handle)


def contigs_from_reads_native(reads: list[str], dbg_kmer: int) -> list[str]:
    """Single-threaded hash-map contig construction (the cross-check for the
    device dBG)."""
    lib = _load()
    if not reads:
        return []
    read_len = len(reads[0])
    if any(len(r) != read_len for r in reads):
        raise ValueError("reads must all have one length")
    handle = lib.gadev_contigs_from_reads("".join(reads).encode(), len(reads),
                                          read_len, dbg_kmer)
    return _collect_results(lib, handle)


def breakscore_native(paths: list[str], reads: list[str],
                      probs_combined: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Single-threaded breakage scoring of raw (not deduplicated) reads:
    (bp_score float64 [S], break counts int64 [S])."""
    lib = _load()
    read_len = len(reads[0])
    if any(len(r) != read_len for r in reads):
        raise ValueError("reads must all have one length")
    plens = (ctypes.c_int * len(paths))(*[len(s) for s in paths])
    probs = np.ascontiguousarray(probs_combined, dtype=np.float64)
    scores = np.zeros(len(paths), np.float64)
    breaks = np.zeros(len(paths), np.int64)
    lib.gadev_breakscore(
        "".join(paths).encode(), plens, len(paths), "".join(reads).encode(),
        len(reads), read_len,
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        breaks.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return scores, breaks


def count_kmers_native(reads: list[str], k: int) -> np.ndarray:
    """Single-threaded rolling k-mer count over raw reads: counts [4^k]
    int64. Windows holding a non-ACGT character are skipped."""
    lib = _load()
    counts = np.zeros(4**k, dtype=np.int64)
    if not reads:
        return counts
    read_len = len(reads[0])
    if any(len(r) != read_len for r in reads):
        raise ValueError("reads must all have one length")
    lib.gadev_count_kmers(
        "".join(reads).encode(), len(reads), read_len, k,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return counts
