// Levenshtein distance of B queries against one shared target, NW (global)
// or HW (infix: gaps at the target's ends free), by the prefix-min row DP:
//
//   c[0] = row boundary (NW: i, HW: 0)
//   c[j] = min(dp[j] + 1, dp[j-1] + (q[j-1] != t[i-1]))
//   dp_new[j] = min_{l <= j} (c[l] - l) + j
//
// Replaces the TPU kernel genomeassembler_dev_tpu/ops/pallas/
// edit_distance_kernel.py (_kernel, wrapper batched_levenshtein_pallas),
// which keeps a tile of queries on lanes and takes the prefix-min by
// log2(M) masked rolls. Here one block owns one query. Each thread keeps
// CPT consecutive columns of the DP row in registers for the whole run, and
// one row step is: the thread's own running minimum, a warp scan with
// __shfl_up_sync, one __syncthreads() to publish the warp totals, and the
// combine. Only the column left of a warp's first one crosses warps: the
// previous warp folds that column's candidate c - j into the total it
// publishes, so a row step needs a single barrier.
//
// What bounds it: the N target rows are sequential, and each costs a block
// barrier plus two chains of five shuffles, so per-row latency, not the
// card's integer rate, sets the time. One block per query fills the card
// only when B is about twice the SM count or more. The rows are computed
// over all M columns; columns beyond a query's length sit to the right of
// its answer column and never reach it. Row 0 counts in the HW minimum, and
// an empty query gives N in NW and 0 in HW.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 28;
constexpr unsigned kFull = 0xffffffffu;

template <int CPT, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
prefix_min_kernel(const uint8_t* __restrict__ queries,  // [B, M]
                  const int32_t* __restrict__ qlens,    // [B]
                  const uint8_t* __restrict__ target,   // [N]
                  int32_t* __restrict__ out,            // [B]
                  int M, int N, int hw) {
  __shared__ int warp_min[2][32];  // by row parity
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qlen = min(max(qlens[b], 0), M);
  const int j0 = 1 + tid * CPT;  // this thread's first column
  const uint8_t* q = queries + static_cast<size_t>(b) * M;

  // column j compares query character j-1; columns past M hold a pad
  int qc[CPT];
  int d[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = j0 + k;
    qc[k] = j <= M ? q[j - 1] : 0x100;
    d[k] = j;  // row 0
  }
  const int jn = j0 + CPT;  // the first column of the next thread
  const int qn = jn <= M ? q[jn - 1] : 0x100;
  const bool owner = qlen > 0 && (qlen - 1) / CPT == tid;  // holds column qlen
  const int kq = owner ? (qlen - 1) % CPT : 0;

  int best = qlen;  // HW: the minimum over rows starts with row 0
  int bprev = 0;    // dp[i-1][0]
  int tnext = N > 0 ? target[0] : 0;
  for (int i = 1; i <= N; ++i) {
    const int tc = tnext;
    if (i < N) tnext = target[i];
    const int bnd = hw ? 0 : i;

    // c and the thread's running minimum of c - j; lane 0 of a warp other
    // than the first gets its left neighbour's term through the carry
    int left = __shfl_up_sync(kFull, d[CPT - 1], 1);
    if (lane == 0) left = warp == 0 ? bprev : kInf;
    int p[CPT];
    int run = kInf;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = min(d[k] + 1, left + (qc[k] != tc ? 1 : 0));
      left = d[k];
      run = min(run, c - (j0 + k));
      p[k] = run;
    }
    int incl = run;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl = min(incl, o);
    }
    const int par = i & 1;
    if (lane == 31) {
      // c - j of the next warp's first column from its left neighbour
      const int cand = d[CPT - 1] + (qn != tc ? 1 : 0) - jn;
      warp_min[par][warp] = min(incl, cand);
    }
    __syncthreads();

    int v = lane < warp ? warp_min[par][lane] : kInf;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = min(v, __shfl_xor_sync(kFull, v, s));
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = kInf;
    excl = min(excl, min(v, bnd));  // column 0 contributes c[0] - 0
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      d[k] = min(excl, p[k]) + j0 + k;
      if (hw && owner && k == kq) best = min(best, d[k]);
    }
    bprev = bnd;
  }

  if (qlen == 0) {
    if (tid == 0) out[b] = hw ? 0 : N;
  } else if (owner) {
    int ans = 0;
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (k == kq) ans = d[k];
    out[b] = hw ? best : ans;
  }
}

template <int CPT, int MAX_THREADS>
int launch(const void* queries, const void* qlens, const void* target, void* out,
           int B, int M, int N, int hw, cudaStream_t stream) {
  const int warps = M > 0 ? (M + 32 * CPT - 1) / (32 * CPT) : 1;
  prefix_min_kernel<CPT, MAX_THREADS><<<B, 32 * warps, 0, stream>>>(
      static_cast<const uint8_t*>(queries), static_cast<const int32_t*>(qlens),
      static_cast<const uint8_t*>(target), static_cast<int32_t*>(out), M, N, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers on `device`; the caller owns every buffer.
// The widest query is 32 columns a thread times 512 threads: M <= 16,384.
extern "C" int gadev_prefix_min_launch(const void* queries, const void* qlens,
                                       const void* target, void* out, int B, int M,
                                       int N, int hw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8 * 1024) return launch<8, 1024>(queries, qlens, target, out, B, M, N, hw, s);
  return launch<32, 512>(queries, qlens, target, out, B, M, N, hw, s);
}
