"""The reference assembler's shuffled contig orderings: `std::mt19937(seed)`
and libstdc++'s `std::shuffle` (GCC >= 11), with the engine state carried
across orderings (reference: lib/DeNovoAssembler.cpp:194-205).

A copy of genomeassembler_dev_tpu_torch/core/rng.py as of the benchmark's
first version, kept here so that the reference shares no code with the
program.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_U32 = 0xFFFFFFFF


class MT19937:
    """Standard 32-bit Mersenne Twister, block-generated with numpy."""

    def __init__(self, seed: int):
        state = np.empty(_N, dtype=np.uint64)
        state[0] = seed & _U32
        for i in range(1, _N):
            state[i] = (1812433253 * (state[i - 1] ^ (state[i - 1] >> np.uint64(30))) + i) & _U32
        self._state = state
        self._buf: list[int] = []
        self._pos = 0

    def _refill(self) -> None:
        old = self._state
        upper = np.uint64(_UPPER_MASK)
        lower = np.uint64(_LOWER_MASK)
        one = np.uint64(1)
        matrix_a = np.uint64(_MATRIX_A)
        # entries [0, N-M) depend only on the old state; the tail reads
        # entries already updated, so it runs one by one
        y_head = (old[: _N - _M] & upper) | (old[1 : _N - _M + 1] & lower)
        mag = np.where((y_head & one).astype(bool), matrix_a, np.uint64(0))
        new = old.copy()
        new[: _N - _M] = old[_M:] ^ (y_head >> one) ^ mag
        for i in range(_N - _M, _N):
            nxt = new[0] if i == _N - 1 else old[i + 1]
            y_i = (old[i] & upper) | (nxt & lower)
            v = new[(i + _M) % _N] ^ (y_i >> one)
            if y_i & one:
                v ^= matrix_a
            new[i] = v
        self._state = new
        t = new.copy()
        t ^= t >> np.uint64(11)
        t ^= (t << np.uint64(7)) & np.uint64(0x9D2C5680)
        t ^= (t << np.uint64(15)) & np.uint64(0xEFC60000)
        t ^= t >> np.uint64(18)
        self._buf = (t & np.uint64(_U32)).tolist()
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= len(self._buf):
            self._refill()
        v = self._buf[self._pos]
        self._pos += 1
        return v


def uniform_int(eng: MT19937, b: int) -> int:
    """libstdc++ uniform_int_distribution over [0, b] on a 32-bit engine:
    Lemire's nearly-divisionless downscaling."""
    uerange = b + 1
    product = eng.next_u32() * uerange
    low = product & _U32
    if low < uerange:
        threshold = (2**32 - uerange) % uerange
        while low < threshold:
            product = eng.next_u32() * uerange
            low = product & _U32
    return product >> 32


def std_shuffle(arr: list, eng: MT19937) -> None:
    """In-place libstdc++ std::shuffle, with its two-swaps-per-draw path for
    short ranges."""
    n = len(arr)
    if n <= 1:
        return
    if _U32 // n >= n:
        i = 1
        if n % 2 == 0:
            j = uniform_int(eng, 1)
            arr[i], arr[j] = arr[j], arr[i]
            i += 1
        while i < n:
            r = i + 1
            x = uniform_int(eng, r * (r + 1) - 1)
            p0, p1 = x // (r + 1), x % (r + 1)
            arr[i], arr[p0] = arr[p0], arr[i]
            i += 1
            arr[i], arr[p1] = arr[p1], arr[i]
            i += 1
        return
    for i in range(1, n):
        j = uniform_int(eng, i)
        arr[i], arr[j] = arr[j], arr[i]


def shuffle_orderings(n_items: int, n_orderings: int, seed: int) -> np.ndarray:
    """[n_orderings, n_items] permutations of the canonical contig list."""
    eng = MT19937(seed)
    out = np.empty((n_orderings, n_items), dtype=np.int64)
    base = list(range(n_items))
    for o in range(n_orderings):
        perm = base.copy()
        std_shuffle(perm, eng)
        out[o] = perm
    return out
