// Levenshtein distance of B queries against one shared target, NW (global)
// or HW (infix: gaps at the target's ends free), by the cell-by-cell DP:
//
//   D[i][0] = row boundary (NW: i, HW: 0), D[0][j] = j
//   D[i][j] = min(D[i-1][j] + 1, D[i-1][j-1] + (q[j-1] != t[i-1]), D[i][j-1] + 1)
//
// NW returns D[N][qlen]; HW the minimum over i of D[i][qlen], row 0
// included. An empty query gives N in NW and 0 in HW.
//
// Replaces the TPU kernel genomeassembler_dev_tpu/ops/pallas/
// edit_distance_kernel.py (_kernel, wrapper batched_levenshtein_pallas),
// which keeps a tile of queries on lanes and closes each row's left-to-right
// chain by a prefix minimum over log2(M) masked rolls of its wide vector
// unit. Here a row scan would cost a block barrier on every target row, so
// the rows run as a wavefront instead and no scan is needed. The arithmetic
// stays a cell DP, independent of the Myers kernel's bit vectors, so the two
// kernels check each other.
//
// What bounds it: integer operations. A cell is ~5 (the compare, the add of
// the substitution cost, two DPX add-and-min, __viaddmin_s32), and the cells
// a call needs are N x sum(qlen): at 256 x 2048 x 50,000 that is 2.6e10
// cells, ~3.9 ms at the card's issue rate (132 SMs x 128 lanes a cycle x
// 1.98 GHz). Measured on an H100 it runs at about a third of that when the
// queries fill the card; one query alone runs on one SM.
//
// Design. One block a query. Lane t (a thread) owns C consecutive columns
// of the DP row in registers and at step s computes the R target rows
// R (s - t) + 1 .. R (s - t) + R, one step behind lane t - 1. The left
// neighbours of its first column are the last column that lane t - 1
// computed for those rows at step s - 1 (and, for the first, one row up at
// step s - 2): R __shfl_up_sync a step bring them, and lane 0 of a warp
// takes them from a two-slot shared mailbox (by step parity) that lane 31
// of the warp before fills, with one named barrier a step over the query's
// busy warps. A single warp needs no barrier at all. R rows a step cut the
// step's fixed cost (characters, shuffles, mailbox, barrier) R-fold, and
// the R row chains of a lane overlap. Only the lanes up to the one that
// holds column qlen run: warps past it leave at once, so the work follows
// sum(qlen), not B x M, and a query takes ceil(N / R) + lanes - 1 steps. A
// query wider than the block's lanes x C columns runs in bands, one after
// the other: the band's last lane writes its last column for every row to
// a [B, N] int32 hand-off row that the next band's lane 0 reads, one step
// ahead, as its left boundary, so any width runs. Steps where some row of
// the warp lies outside 1..N are masked; the steps between run unmasked.
// Columns past qlen carry a pad code that matches nothing and never reach
// column qlen. The plan (ops/prefix_min.py::launch_plan) takes C 16 up to
// 8,192 columns and C 32 above, R 4; on an H100 those were the fastest of
// C 8, 16, 32 and R 1, 2, 4 at the shapes of chip_smoke.py.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLanes = 512;
constexpr int kPad = 0x100;  // the code of a column past the query: equals no target code

// Barrier 1 over the first `threads` threads of the block: the warps that
// own columns of the current band (the others wait at the band's end).
__device__ __forceinline__ void sync_busy_warps(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// d[k] for a k known only at run time, by a tree of C - 1 selects on the
// bits of k (a local array indexed at run time would leave the registers).
template <int W, int C>
__device__ __forceinline__ void fold(int (&v)[C], int k) {
  if constexpr (W >= 1) {
    const bool hi = (k & W) != 0;
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = hi ? v[j + W] : v[j];
    fold<W / 2>(v, k);
  }
}

template <int C>
__device__ __forceinline__ int pick(const int (&d)[C], int k) {
  int v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = d[j];
  fold<C / 2>(v, k);
  return v[0];
}

template <int C, int R>
__global__ void __launch_bounds__(kMaxLanes)
prefix_min_kernel(const uint8_t* __restrict__ queries,  // [B, M]
                  const int32_t* __restrict__ qlens,    // [B]
                  const uint8_t* __restrict__ target,   // [N]
                  int32_t* __restrict__ out,            // [B]
                  int32_t* __restrict__ hbuf,           // [B, N] band hand-off, or null
                  int M, int N, int hw) {
  // lane 31's last column for each of a step's R rows, by step parity
  __shared__ int mailbox[2][R][kMaxLanes / 32];
  const int lanes = blockDim.x;
  const int b = blockIdx.x;
  const int gl = threadIdx.x;  // lane within the query
  const int lane = gl & 31;
  const int warp = gl >> 5;
  const int qlen = min(max(qlens[b], 0), M);
  if (qlen == 0 || N == 0) {
    if (gl == 0) out[b] = qlen == 0 ? (hw ? 0 : N) : qlen;
    return;  // the whole query's threads leave together
  }
  const int band_cols = lanes * C;
  const int nbands = (qlen + band_cols - 1) / band_cols;
  const int row_steps = (N + R - 1) / R;  // steps a lane has rows in
  const uint8_t* qrow = queries + static_cast<size_t>(b) * M;
  int32_t* hrow = hbuf ? hbuf + static_cast<size_t>(b) * N : nullptr;

  bool owner = false;  // holds column qlen in the last band
  int kq = 0;          // its slot
  int best = qlen;     // HW: the minimum over rows, row 0 included
  int d[C];
  for (int band = 0; band < nbands; ++band) {
    const int c0 = band * band_cols;  // the column left of the band
    const int used = min(lanes, (qlen - c0 + C - 1) / C);  // lanes with columns
    const int busy = (used + 31) >> 5;                     // warps with columns
    const bool last = band == nbands - 1;
    if (warp < busy) {
      const int j0 = c0 + gl * C + 1;  // the lane's first column
      int qc[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int j = j0 + k;
        qc[k] = j <= qlen ? qrow[j - 1] : kPad;
        d[k] = j;  // row 0
      }
      kq = qlen - j0;
      owner = last && kq >= 0 && kq < C;
      const bool feeds = !last && gl == used - 1;  // hands its last column on
      const bool from_hand = gl == 0 && band > 0;
      const int steps = row_steps + used - 1;
      const int threads = busy * 32;
      int left_prev = j0 - 1;  // the column left of the lane's first, one row up
      int tail[R];             // the lane's last column after each of its R rows
      int tc_next[R], hb_next[R];
      // at step s the lane computes rows R (s - gl) + 1 .. R (s - gl) + R,
      // with target characters t[R (s - gl) + r]
#pragma unroll
      for (int r = 0; r < R; ++r) {
        tail[r] = j0 + C - 1;
        tc_next[r] = __ldg(target + min(max(r - R * gl, 0), N - 1));
        hb_next[r] = from_hand ? hrow[min(r, N - 1)] : 0;
      }

      // one step; MASKED skips the rows outside 1..N
      auto step = [&](int s, auto masked) {
        constexpr bool MASKED = decltype(masked)::value;
        const int i0 = R * (s - gl) + 1;  // the step's first row
        int tc[R], lin[R];  // lin: this step's rows of the column left of the lane's first
#pragma unroll
        for (int r = 0; r < R; ++r) {
          tc[r] = tc_next[r];
          const int t = i0 + R - 1 + r;  // the next step's character
          tc_next[r] = __ldg(target + (MASKED ? min(max(t, 0), N - 1) : min(t, N - 1)));
          lin[r] = __shfl_up_sync(kFull, tail[r], 1);
        }
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (warp > 0) {
              lin[r] = mailbox[(s + 1) & 1][r][warp - 1];
            } else if (from_hand) {
              lin[r] = hb_next[r];
              hb_next[r] = hrow[min(i0 + R - 1 + r, N - 1)];
            } else {
              lin[r] = hw ? 0 : i0 + r;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool ok = !MASKED || static_cast<unsigned>(i0 + r - 1) < static_cast<unsigned>(N);
          if (ok) {
            int diag = r == 0 ? left_prev : lin[r - 1];
            int left = lin[r];
#pragma unroll
            for (int k = 0; k < C; ++k) {
              const int up = d[k];
              const int sub = diag + (qc[k] != tc[r] ? 1 : 0);
              d[k] = __viaddmin_s32(left, 1, __viaddmin_s32(up, 1, sub));
              diag = up;
              left = d[k];
            }
            if (hw && owner) best = min(best, kq == C - 1 ? d[C - 1] : pick(d, kq));
            if (feeds) hrow[i0 + r - 1] = d[C - 1];
          }
          tail[r] = d[C - 1];
        }
        // a lane before its first row keeps row 0's left neighbour
        if (!MASKED || i0 >= 1) left_prev = lin[R - 1];
        if (busy > 1) {
          if (lane == 31) {
#pragma unroll
            for (int r = 0; r < R; ++r) mailbox[s & 1][r][warp] = tail[r];
          }
          sync_busy_warps(threads);
        }
      };
      // the warp's lanes all have R rows from step lo to hi - 1
      const int wfirst = warp * 32;
      const int lo = min(wfirst + 31, steps);
      const int hi = max(lo, min(wfirst + N / R, steps));
      int s = 0;
      for (; s < lo; ++s) step(s, std::true_type{});
      for (; s < hi; ++s) step(s, std::false_type{});
      for (; s < steps; ++s) step(s, std::true_type{});
    }
    if (nbands > 1) __syncthreads();  // the hand-off row is complete
  }
  if (owner) out[b] = hw ? best : pick(d, kq);
}

template <int C, int R>
int launch(const void* queries, const void* qlens, const void* target, void* out,
           void* hbuf, int B, int M, int N, int lanes, int hw, cudaStream_t stream) {
  if (lanes <= 0 || lanes % 32 != 0 || lanes > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  prefix_min_kernel<C, R><<<B, lanes, 0, stream>>>(
      static_cast<const uint8_t*>(queries), static_cast<const int32_t*>(qlens),
      static_cast<const uint8_t*>(target), static_cast<int32_t*>(out),
      static_cast<int32_t*>(hbuf), M, N, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most lanes (threads) a query may take, the kernel's __launch_bounds__.
extern "C" int gadev_prefix_min_max_lanes() { return kMaxLanes; }

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan the kernel is not built for. All pointers
// are device pointers on `device`, which is current during the call only
// (device_guard.cuh); the caller owns every buffer. The plan
// (ops/prefix_min.py::launch_plan): C columns a lane and R rows a step
// (16 and 4, or 32 and 4), `lanes`
// threads a query (a multiple of 32, at most gadev_prefix_min_max_lanes()),
// one block a query. `hbuf` is a [B, N] int32 buffer when a query can be
// wider than lanes x C columns, else null.
extern "C" int gadev_prefix_min_launch(const void* queries, const void* qlens,
                                       const void* target, void* out, void* hbuf, int B,
                                       int M, int N, int C, int R, int lanes, int hw,
                                       int device,
                                       void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 16 && R == 4)
    return launch<16, 4>(queries, qlens, target, out, hbuf, B, M, N, lanes, hw, st);
  if (C == 32 && R == 4)
    return launch<32, 4>(queries, qlens, target, out, hbuf, B, M, N, lanes, hw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
