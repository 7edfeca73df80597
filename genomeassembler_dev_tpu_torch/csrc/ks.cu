// K4: the two-sample Kolmogorov-Smirnov statistic of full rows whose mass
// sits mostly in one tie run at 0.0. Row b of x [B, N] is held against the
// track y[b / rows_per_y] of y [G, M], sorted ascending by the caller:
//
//   D[b] = max over the finite values v of the row and its track of
//          |#{x <= v} wx - #{y <= v} wy|,
//
// which is the pooled-sort definition of ops/ks.py: right-continuous ECDFs,
// the gap read at the end of each tie run, ties within and across the two
// samples counted once, and the same float32 weights wx = 1/N and wy = 1/M.
// A row holding a NaN gives NaN.
//
// Replaces no TPU kernel: the JAX package sorts each pooled row of N + M
// values with jnp.sort (genomeassembler_dev_tpu/ops/ks.py), and so does the
// port's plain version (ops/ks.py::_ks_from_pooled), which is this kernel's
// oracle. A breakscore row (score/breakscore.py, path_freq) has 69,904
// entries and at most one nonzero entry a distinct read, so sorting it sorts
// one long run of zeros whose place in the pooled order is known.
//
// What bounds it: bytes. Each row is read once (279,616 bytes at N 69,904),
// the sorted tracks stay in L2 and the output is one float a row; ~900 rows
// an experiment at k 9 are ~252 MB, 75 us at 3.35 TB/s.
//
// Design. One block a row. The block streams the row with 16-byte loads and
// appends each value that is not 0.0 to its keys, one atomic a warp for each
// of a load's four slots; a NaN marks the row and ends the stream. The keys,
// at most `capacity` (the caller's bound on a row's nonzero entries, capped at
// N and rounded up to a power of two; a row past it gives NaN), live in shared
// memory up to kSharedCapacity and otherwise in the row's slice of a global
// scratch buffer [B, capacity]; they are sorted by a bitonic network of the
// next power of two of their own count. Then
// every thread takes run ends: of the sorted kept values (#x <= v from the
// position, #y <= v by binary search in the track), of the track (#y <= v
// from the position, #x <= v by binary search in the keys, plus the
// zeros where v >= 0), and of the zero run. Counts times weights are exact
// in float64 (a count below 2^28 times a 24-bit weight, and both ECDFs are
// multiples of the smaller weight's last bit below 2), as are the pooled
// sort's float64 cumulative sums, so the statistic is the plain version's to
// the bit.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSharedCapacity = 32768;  // 128 KiB of float32 keys
constexpr unsigned kFull = 0xffffffffu;

// Appends v to xs when it is in the row and not 0.0 (-0.0 counts as 0.0);
// a NaN sets *has_nan instead. Every lane of the warp calls it together.
__device__ __forceinline__ void keep(float v, bool in_row, float* xs, int capacity,
                                     int* n_kept, int* has_nan) {
  const unsigned lane = threadIdx.x & 31u;
  const bool nan = in_row && v != v;
  const bool nonzero = in_row && !nan && v != 0.0f;
  if (__any_sync(kFull, nan) && lane == 0) *has_nan = 1;
  const unsigned mask = __ballot_sync(kFull, nonzero);
  if (mask == 0u) return;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (static_cast<int>(lane) == leader) base = atomicAdd(n_kept, __popc(mask));
  base = __shfl_sync(kFull, base, leader);
  if (nonzero) {
    const int idx = base + __popc(mask & ((1u << lane) - 1u));
    if (idx < capacity) xs[idx] = v;
  }
}

// Number of the n ascending values of a that are <= v (a NaN sorts last and
// is above every v).
__device__ __forceinline__ int count_le(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ double gap(int cx, double wx, int cy, double wy) {
  return fabs(static_cast<double>(cx) * wx - static_cast<double>(cy) * wy);
}

__global__ void __launch_bounds__(kThreads, 2)
ks_sparse_kernel(const float* __restrict__ x,   // [B, N], on a 16-byte boundary, N % 4 == 0
                 const float* __restrict__ ys,  // [G, M], each row ascending
                 float* __restrict__ out,       // [B]
                 float* scratch,  // [B, capacity] when capacity > kSharedCapacity
                 int N, int M, int rows_per_y, int capacity, double wx, double wy) {
  extern __shared__ float smem[];  // [capacity] when capacity <= kSharedCapacity
  __shared__ int n_kept, has_nan;
  __shared__ double warp_best[kThreads / 32];
  const size_t row = blockIdx.x;
  float* xs = capacity <= kSharedCapacity ? smem : scratch + row * capacity;  // the row's keys
  const float* xr = x + row * N;
  const float* yr = ys + (row / rows_per_y) * static_cast<size_t>(M);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    n_kept = 0;
    has_nan = 0;
  }
  __syncthreads();

  // stream the row; the loop runs a warp's 32 lanes together
  const float4* x4 = reinterpret_cast<const float4*>(xr);
  const int n4 = N >> 2;
  for (int g0 = warp * 32; g0 < n4; g0 += blockDim.x) {
    const int g = g0 + lane;
    const bool in_row = g < n4;
    const float4 v = in_row ? __ldcs(x4 + g) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    keep(v.x, in_row, xs, capacity, &n_kept, &has_nan);
    keep(v.y, in_row, xs, capacity, &n_kept, &has_nan);
    keep(v.z, in_row, xs, capacity, &n_kept, &has_nan);
    keep(v.w, in_row, xs, capacity, &n_kept, &has_nan);
    if (__shfl_sync(kFull, *static_cast<volatile int*>(&has_nan), 0)) break;
  }
  __syncthreads();
  const int K = n_kept;
  if (has_nan || K > capacity) {
    if (threadIdx.x == 0) out[row] = NAN;
    return;
  }

  // bitonic sort of the kept values, padded with +inf to P = 2^ceil(log2 K)
  int P = 1;
  while (P < K) P <<= 1;
  for (int i = K + threadIdx.x; i < P; i += blockDim.x) xs[i] = INFINITY;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (P >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // pair (i, i + j)
        const float a = xs[i], b = xs[i + j];
        if ((a > b) == ((i & k) == 0)) {
          xs[i] = b;
          xs[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  const int n_zero = N - K;
  double best = 0.0;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {  // runs of the kept values
    const float v = xs[i];
    if ((i + 1 < K && xs[i + 1] == v) || !isfinite(v)) continue;
    best = fmax(best, gap(i + 1 + (v > 0.0f ? n_zero : 0), wx, count_le(yr, M, v), wy));
  }
  for (int j = threadIdx.x; j < M; j += blockDim.x) {  // runs of the track
    const float v = __ldg(yr + j);
    if ((j + 1 < M && __ldg(yr + j + 1) == v) || !isfinite(v)) continue;
    best = fmax(best, gap(count_le(xs, K, v) + (v >= 0.0f ? n_zero : 0), wx, j + 1, wy));
  }
  if (threadIdx.x == 0 && n_zero > 0)  // the zero run, with the negative values below it
    best = fmax(best, gap(count_le(xs, K, 0.0f) + n_zero, wx, count_le(yr, M, 0.0f), wy));

  for (int d = 16; d > 0; d >>= 1) best = fmax(best, __shfl_xor_sync(kFull, best, d));
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) best = fmax(best, warp_best[w]);
    out[row] = __double2float_rn(best);
  }
}

}  // namespace

// The most keys a row keeps in shared memory (kSharedCapacity) and the
// block's threads, for ops/ks.py to check against its plan when the library
// loads.
extern "C" int gadev_ks_shared_capacity() { return kSharedCapacity; }
extern "C" int gadev_ks_threads() { return kThreads; }

// Launches one block a row on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments the kernel does not take.
// x [B, N] and ys [G, M] are float32 device pointers on `device`, which is
// current during the call only (device_guard.cuh): x on a 16-byte boundary
// with N % 4 == 0, ys sorted ascending along M, with G = B / rows_per_y; out
// is [B] float32. capacity is a power of two; above kSharedCapacity the keys
// live in scratch, a float32 device buffer [B, capacity]. wx and wy are the
// float32 weights 1/N and 1/M, widened.
extern "C" int gadev_ks_launch(const void* x, const void* ys, void* out, void* scratch, int B,
                               int N, int M, int rows_per_y, int capacity, double wx, double wy,
                               int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (B <= 0) return 0;
  const bool shared = capacity <= kSharedCapacity;
  if (N <= 0 || N % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || M <= 0 ||
      rows_per_y <= 0 || capacity <= 0 || (capacity & (capacity - 1)) != 0 ||
      (!shared && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int shared_bytes = shared ? 4 * capacity : 0;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ks_sparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ks_sparse_kernel<<<B, kThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(ys), static_cast<float*>(out),
      static_cast<float*>(scratch), N, M, rows_per_y, capacity, wx, wy);
  return static_cast<int>(cudaGetLastError());
}
