"""Replay of the C++ RNG stack used by the reference assembler (mirrors
genomeassembler_dev_tpu/core/rng.py).

The reference produces its 10,000 (own path) / 20,000 (velvet path) shuffled
contig orderings with `std::mt19937 engine(seed)` + `std::shuffle`
(ref: lib/DeNovoAssembler.cpp:194-205, lib/BreakageScorer.cpp:85-94), with the
engine state carried across orderings. Bit-identical merged solution sets
therefore require replaying, on the host, exactly:

  * the MT19937 engine (standard algorithm, 32-bit variant),
  * libstdc++'s `std::uniform_int_distribution` (Lemire nearly-divisionless
    downscaling in GCC >= 11),
  * libstdc++'s `std::shuffle`, including its two-swaps-per-draw fast path
    (`__gen_two_uniform_ints`) taken whenever urngrange/n >= n — always true
    for contig-sized ranges.

Pure numpy, as in the JAX package; the device merge (merge/device.py) draws
its orderings from here.
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
        self._buf = np.empty(0, dtype=np.uint64)
        self._pos = 0

    def _refill(self) -> None:
        # The MT19937 in-place update s[i] = s[(i+M)%N] ^ twist(s[i], s[(i+1)%N])
        # reads already-updated entries for i >= N-M (s[(i+M)%N] wraps to the
        # front) and for i == N-1 (s[(i+1)%N] is the new s[0]). Vectorise the
        # independent head [0, N-M), then run the dependent tail sequentially
        # against the partially-new array.
        old = self._state
        upper = np.uint64(_UPPER_MASK)
        lower = np.uint64(_LOWER_MASK)
        one = np.uint64(1)
        matrix_a = np.uint64(_MATRIX_A)

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
        tempered = new.copy()
        tempered ^= tempered >> np.uint64(11)
        tempered ^= (tempered << np.uint64(7)) & np.uint64(0x9D2C5680)
        tempered ^= (tempered << np.uint64(15)) & np.uint64(0xEFC60000)
        tempered ^= tempered >> np.uint64(18)
        self._buf = tempered & np.uint64(_U32)
        self._pos = 0

    def next_u32(self) -> int:
        if self._pos >= self._buf.shape[0]:
            self._refill()
        v = int(self._buf[self._pos])
        self._pos += 1
        return v


class UniformIntDistribution:
    """libstdc++ (GCC >= 11) uniform_int_distribution over [0, b] driven by a
    32-bit engine: Lemire's nearly-divisionless downscaling
    (bits/uniform_int_dist.h, _S_nd). For urngrange == 2^32-1 and any
    uerange <= 2^32-1 this is the branch libstdc++ takes."""

    @staticmethod
    def draw(eng: MT19937, b: int) -> int:
        uerange = b + 1
        if uerange > _U32:
            raise NotImplementedError("range >= 2^32 not needed for contig counts")
        product = eng.next_u32() * uerange
        low = product & _U32
        if low < uerange:
            threshold = (2**32 - uerange) % uerange
            while low < threshold:
                product = eng.next_u32() * uerange
                low = product & _U32
        return product >> 32


def _gen_two_uniform_ints(eng: MT19937, b0: int, b1: int) -> tuple[int, int]:
    x = UniformIntDistribution.draw(eng, b0 * b1 - 1)
    return x // b1, x % b1


def std_shuffle(arr: list | np.ndarray, eng: MT19937) -> None:
    """In-place libstdc++ std::shuffle (bits/stl_algo.h) for 32-bit engines
    with n*n <= 2^32-1 (always true here: contig counts are small)."""
    n = len(arr)
    if n <= 1:
        return
    urngrange = _U32
    if urngrange // n >= n:  # fast path: two swap positions per draw
        i = 1
        if n % 2 == 0:
            j = UniformIntDistribution.draw(eng, 1)
            arr[i], arr[j] = arr[j], arr[i]
            i += 1
        while i < n:
            swap_range = i + 1
            p0, p1 = _gen_two_uniform_ints(eng, swap_range, swap_range + 1)
            arr[i], arr[p0] = arr[p0], arr[i]
            i += 1
            arr[i], arr[p1] = arr[p1], arr[i]
            i += 1
        return
    for i in range(1, n):
        j = UniformIntDistribution.draw(eng, i)
        arr[i], arr[j] = arr[j], arr[i]


def shuffle_orderings(n_items: int, n_orderings: int, seed: int) -> np.ndarray:
    """Permutation matrix [n_orderings, n_items] replaying the reference's
    shuffled copies of the canonical (sorted, deduped) contig list
    (ref: lib/DeNovoAssembler.cpp:194-205). The engine state carries across
    orderings, exactly as in the C++ loop."""
    eng = MT19937(seed)
    out = np.empty((n_orderings, n_items), dtype=np.int32)
    base = list(range(n_items))
    for o in range(n_orderings):
        perm = base.copy()
        std_shuffle(perm, eng)
        out[o] = perm
    return out
