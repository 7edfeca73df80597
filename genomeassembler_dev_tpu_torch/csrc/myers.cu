// Myers/Hyyro bit-vector Levenshtein distance of B queries against one
// shared target, NW (global) or HW (infix: gaps at the target's ends free).
//
// Replaces the TPU kernel genomeassembler_dev_tpu/ops/pallas/myers_kernel.py
// (_kernel, wrapper batched_levenshtein_myers). It computes the same
// distances, including the empty-query rule (NW: N, HW: 0), but not the same
// way: the TPU kernel keeps queries on lanes and resolves the word chain by
// a log2(W) prefix of 2-state maps, which doubles the word work; here the
// words of one query run as a wavefront, each word computed once.
//
// The recurrence is Hyyro's block chain (2003, as edlib's calculateBlock):
// for target character i, word w of the query takes the horizontal delta
// hin in {-1, 0, +1} that word w-1 produced for the same character, and
// hands its own hout to word w+1. Word 0 takes the top row's delta (+1 NW,
// 0 HW).
//
// Design. A query of nw = ceil(qlen/32) words is cut into strips of S
// consecutive words, one strip per thread ("lane"): one warp for a short
// query, a block of warps for a long one. The words form a wavefront: at
// step s, word o of the query (lane o / S, slot o % S) advances by character
// i = s - o, with hin the hout that word o-1 produced one step earlier for
// the same character. So the S words of a lane are independent within a
// step (the lane's chain is one word deep and its S updates overlap), and
// only hout of a lane's last word crosses threads: by __shfl_up_sync inside
// a warp, and through a two-slot shared-memory mailbox (indexed by step
// parity) from the last lane of the warp before, with one named barrier per
// step over the query's busy warps. Every lane runs the same
// N + S x (lanes with words) - 1 steps, so the shuffles stay warp-uniform.
// Each (word, character) cell is computed from the same inputs as in the
// sequential chain, so the distances are equal bit for bit. VP/VN and the horizontal
// deltas live in registers (S is a template parameter); the match masks
// (Peq) of the lane's words, indexed by the target code, in shared memory
// laid out [word slot][code][lane] so that a warp's loads hit 32 banks; the
// lane's S characters move through a 3-bit-per-slot shift register, and the
// new one is loaded one step ahead. Equal codes match, as in the plain DP:
// A, C, G, T and the invalid base 255 (N) each have a Peq row, and a sixth,
// empty row stands for a character outside the target. The codes 4-254,
// which the encoding never produces, never reach the kernel: ops/myers.py
// refuses them, since a target code there would read the N row. A step
// where a word of the warp lies outside the target is masked; the steps
// between run unmasked. A query wider than the block's lanes x S words runs
// in bands of that many words, one after the other: the band's last word
// writes its hout for every character to a [B, N] int8 hand-off row that
// the next band's first word reads as its hin.
//
// What bounds it: instruction issue and the step's barrier. A word step is
// ~20 integer instructions (its chain of ~7 dependent ones no longer
// serialises the S words), and a step adds ~30 for the shuffle, the mailbox,
// the barrier, the character and the score: ~(20 S + 30) x warps / 4
// schedulers cycles per step for one query, ~N + nw steps. At the velvet
// shape (one real row of 1,563 words, S 8, 7 warps) that is ~350 cycles a
// step, and ~800 were measured on an H100: with two warps a scheduler the
// barrier and the shared-memory loads are not hidden. One query runs on one
// SM, so there the card's other SMs have nothing to do. Only the words up to
// the one holding row qlen-1 are built; a lane's words beyond it are
// computed on zero masks and never reach the score.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCodes = 6;  // Peq rows: A, C, G, T, 255 (N) and outside the target
constexpr uint32_t kInvalid = 255u;  // core/encoding.py's code of a non-ACGT base
constexpr uint32_t kOutside = 5u;    // the Peq row that matches nothing
constexpr uint32_t kNoChars = 0x2db6db6du;  // kOutside in every 3-bit slot

// A query's threads at S words a lane, its template's __launch_bounds__:
// S 1, 2 and 4 serve queries of up to 128 words on one warp; S 8 a block of
// up to 16 warps (wider queries run in bands), 128 registers a thread.
// ops/myers.py reads it back through gadev_myers_max_lanes.
constexpr int max_lanes(int S) { return S < 8 ? 32 : 512; }

// Barrier 1 over the first `threads` threads of the block: the warps that
// own words of the current band (the others wait at the band's end).
__device__ __forceinline__ void sync_busy_warps(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

template <int S>
__global__ void __launch_bounds__(max_lanes(S))
myers_kernel(const uint8_t* __restrict__ queries,  // [B, M]
             const int32_t* __restrict__ qlens,    // [B]
             const uint8_t* __restrict__ target,   // [N]
             int32_t* __restrict__ out,            // [B]
             int8_t* __restrict__ hbuf,            // [B, N] band hand-off, or null
             int M, int N, int hw) {
  // [2][lanes / 32] mailbox: hout of each warp's lane 31, by step parity;
  // then [S][kCodes][lanes] Peq words
  extern __shared__ uint32_t smem[];
  const int lanes = blockDim.x;  // a block a query
  const int nwarps = lanes >> 5;
  const int q = blockIdx.x;
  const int gl = threadIdx.x;  // lane within the query
  const int lane = gl & 31;
  const int warp = gl >> 5;  // warp within the query
  int* mailbox = reinterpret_cast<int*>(smem);
  uint32_t* peq = smem + 2 * nwarps + gl;
  const int qlen = min(max(qlens[q], 0), M);
  if (qlen == 0 || N == 0) {
    if (gl == 0) out[q] = qlen == 0 ? (hw ? 0 : N) : qlen;
    return;  // the whole query's threads leave together
  }
  const int nw = ((qlen - 1) >> 5) + 1;
  const int band_words = lanes * S;
  const int nbands = (nw + band_words - 1) / band_words;
  const uint32_t bstar = static_cast<uint32_t>((qlen - 1) & 31);
  const uint8_t* qrow = queries + static_cast<size_t>(q) * M;
  int8_t* hrow = hbuf ? hbuf + static_cast<size_t>(q) * N : nullptr;

  int score = qlen;  // D[0][qlen]
  int best = qlen;   // HW: minimum over columns, the top row included
  bool owner = false;  // holds the word of row qlen-1
  for (int band = 0; band < nbands; ++band) {
    const int w0 = band * band_words;
    const int used = (min(band_words, nw - w0) + S - 1) / S;  // lanes with words
    const int busy = (used + 31) >> 5;                         // warps with words
    const bool last = band == nbands - 1;
    if (warp < busy) {
      // Peq bit b of word w = (query[32w + b] == c); positions >= qlen match nothing
      uint32_t vp[S], vn[S], hp[S], hn[S];  // hout of slot k: hp +1, hn -1
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int base = 32 * (w0 + gl * S + k);
        uint32_t e0 = 0u, e1 = 0u, e2 = 0u, e3 = 0u, en = 0u;
        if (gl < used) {
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            const int p = base + b;
            const uint32_t c = p < qlen ? qrow[p] : kOutside;  // past qlen: no row bit
            const uint32_t bit = 1u << b;
            e0 |= c == 0 ? bit : 0u;
            e1 |= c == 1 ? bit : 0u;
            e2 |= c == 2 ? bit : 0u;
            e3 |= c == 3 ? bit : 0u;
            en |= c == kInvalid ? bit : 0u;
          }
        }
        uint32_t* row = peq + k * kCodes * lanes;
        row[0] = e0;
        row[lanes] = e1;
        row[2 * lanes] = e2;
        row[3 * lanes] = e3;
        row[4 * lanes] = en;
        row[kOutside * lanes] = 0u;
        vp[k] = ~0u;
        vn[k] = 0u;
        hp[k] = 0u;
        hn[k] = 0u;
      }
      const int sw = nw - 1 - w0;  // the score word within the last band
      owner = last && gl == sw / S;
      score = best = qlen;  // lanes of earlier bands count nothing
      const int kq = sw % S;
      const int first = gl * S;  // wavefront offset of the lane's slot 0
      const bool feeds = !last && gl == used - 1;  // hands hout to the next band
      const int steps = N + used * S - 1;
      const int threads = busy * 32;
      const int hin0 = hw ? 0 : 1;  // top-row delta as a code: +1 NW, 0 HW

      uint32_t chars = kNoChars;  // slot k's code in bits 3k..3k+2
      auto code_at = [&](int i) -> uint32_t {  // the Peq row of target[i]: 255 -> 4
        const uint32_t c = __ldg(target + min(max(i, 0), N - 1));
        return static_cast<unsigned>(i) < static_cast<unsigned>(N) ? min(c, 4u) : kOutside;
      };
      uint32_t c_next = code_at(-first);
      int hb_next = (gl == 0 && band > 0) ? hrow[0] : hin0;

      // one step; MASKED skips the slots whose character lies outside the target
      auto step = [&](int s, auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
        const int i0 = s - first;  // slot 0's character
        chars = (chars << 3) | c_next;
        c_next = code_at(i0 + 1);
        const int hb = hb_next;
        if (gl == 0 && band > 0) hb_next = hrow[min(i0 + 1, N - 1)];
        int up = __shfl_up_sync(kFull, static_cast<int>(hp[S - 1] | (hn[S - 1] << 1)), 1);
        if (lane == 0) up = warp == 0 ? hb : mailbox[((s + 1) & 1) * nwarps + warp - 1];
        uint32_t sp = 0u, sm = 0u;  // the score word's horizontal deltas
        bool sok = !MASKED;
#pragma unroll
        for (int k = S - 1; k >= 0; --k) {  // slot k reads slot k-1's previous hout
          const uint32_t hpi = k > 0 ? hp[k - 1] : static_cast<uint32_t>(up) & 1u;
          const uint32_t hni = k > 0 ? hn[k - 1] : static_cast<uint32_t>(up) >> 1;
          const uint32_t tc = (chars >> (3 * k)) & 7u;
          uint32_t eq = peq[(k * kCodes + static_cast<int>(tc)) * lanes];
          const uint32_t pv = vp[k];
          const uint32_t mv = vn[k];
          const uint32_t xv = eq | mv;
          eq |= hni;
          const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
          const uint32_t ph = mv | ~(xh | pv);
          const uint32_t mh = pv & xh;
          const uint32_t phs = (ph << 1) | hpi;
          const uint32_t mhs = (mh << 1) | hni;
          bool ok = true;
          if (MASKED) ok = static_cast<unsigned>(i0 - k) < static_cast<unsigned>(N);
          if (k == kq) {
            sp = ph;
            sm = mh;
            if (MASKED) sok = ok;
          }
          if (ok) {
            hp[k] = ph >> 31;
            hn[k] = mh >> 31;
            vp[k] = mhs | ~(xv | phs);
            vn[k] = phs & xv;
          }
        }
        // every lane keeps a score (branch-free); only the owner's is read
        if (sok) {
          score += static_cast<int>((sp >> bstar) & 1u) - static_cast<int>((sm >> bstar) & 1u);
          if (hw) best = min(best, score);
        }
        if (feeds) {
          const int i = i0 - (S - 1);  // the last slot's character
          if (!MASKED || static_cast<unsigned>(i) < static_cast<unsigned>(N))
            hrow[i] = static_cast<int8_t>(hp[S - 1] | (hn[S - 1] << 1));
        }
        if (busy > 1) {
          if (lane == 31) mailbox[(s & 1) * nwarps + warp] = hp[S - 1] | (hn[S - 1] << 1);
          sync_busy_warps(threads);
        }
      };
      // the warp's slots all lie inside the target from step lo to hi - 1
      const int wfirst = warp * 32 * S;
      const int lo = min(wfirst + 32 * S - 1, steps);
      const int hi = max(lo, min(wfirst + N, steps));
      int s = 0;
      for (; s < lo; ++s) step(s, std::true_type{});
      for (; s < hi; ++s) step(s, std::false_type{});
      for (; s < steps; ++s) step(s, std::true_type{});
    }
    if (nbands > 1) __syncthreads();  // the hand-off row is complete
  }
  if (owner) out[q] = hw ? best : score;
}

template <int S>
int launch(const void* queries, const void* qlens, const void* target, void* out,
           void* hbuf, int B, int M, int N, int lanes, int shared_bytes, int hw,
           cudaStream_t stream) {
  const int need = 4 * (2 * (lanes / 32) + S * kCodes * lanes);
  if (lanes <= 0 || lanes % 32 != 0 || lanes > max_lanes(S) || shared_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = myers_kernel<S>;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, lanes, shared_bytes, stream>>>(
      static_cast<const uint8_t*>(queries), static_cast<const int32_t*>(qlens),
      static_cast<const uint8_t*>(target), static_cast<int32_t*>(out),
      static_cast<int8_t*>(hbuf), M, N, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most lanes a query may take at S words a lane (0 for an S the kernel
// is not built for).
extern "C" int gadev_myers_max_lanes(int S) {
  return S == 1 || S == 2 || S == 4 || S == 8 ? max_lanes(S) : 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan the kernel is not built for. All pointers
// are device pointers on `device`, which is current during the call only
// (device_guard.cuh); the caller owns every buffer. The plan
// (ops/myers.py::launch_plan): S words a lane, `lanes` threads a query, one
// block a query (a multiple of 32, at most gadev_myers_max_lanes(S)), dynamic
// shared bytes: 4 x (2 x lanes / 32 + S x 6 x lanes) at least. `hbuf` is a
// [B, N] int8 buffer when a query can exceed lanes x S words, else null.
extern "C" int gadev_myers_launch(const void* queries, const void* qlens,
                                  const void* target, void* out, void* hbuf, int B,
                                  int M, int N, int S, int lanes, int shared_bytes,
                                  int hw, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1:
      return launch<1>(queries, qlens, target, out, hbuf, B, M, N, lanes, shared_bytes, hw, st);
    case 2:
      return launch<2>(queries, qlens, target, out, hbuf, B, M, N, lanes, shared_bytes, hw, st);
    case 4:
      return launch<4>(queries, qlens, target, out, hbuf, B, M, N, lanes, shared_bytes, hw, st);
    case 8:
      return launch<8>(queries, qlens, target, out, hbuf, B, M, N, lanes, shared_bytes, hw, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
