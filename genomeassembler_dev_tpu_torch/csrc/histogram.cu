// Per-row histogram of k-mer codes under a validity mask:
// counts[b, c] = #{n : valid[b, n] and codes[b, n] == c}, c in [0, bins).
//
// Replaces the TPU kernel genomeassembler_dev_tpu/ops/pallas/
// histogram_kernel.py (_kernel, wrapper count_kmers_mxu_pallas). The TPU
// kernel turns the scatter into a hi/lo one-hot matrix product because
// scatters run near-scalar there; on this card a scatter into shared memory
// is cheap, so the histogram is counted directly.
//
// What bounds it: bytes. Each code (4 or 8 bytes) and its valid byte are
// read once and each int32 count is written once; at B 256 x N 16,665, k 8
// that is 21.3 MB in and 67.1 MB out, ~26 us at 3.35 TB/s.
//
// Design. One block owns one (row, slice of at most 65,536 bins, part of
// the row). Its counters are 16 bits wide, two to a 32-bit shared word
// (bin c in the low half of word c / 2 when c is even, the high half when
// odd), so all 4^8 bins of k 8 fit one block's 128 KiB and every code is
// read and tested once; k >= 9 takes slices of 65,536 bins. A part holds at
// most 65,535 entries, so no counter carries into its neighbour. With few
// bins (up to 1,024, k <= 5) each warp counts into a copy of its own, so
// that ~37,000 codes do not serialise on 16 shared counters; the copies'
// packed words add without carry for the same reason. Codes and valid bytes
// are loaded 16 and 4 bytes at a time (four entries), int32 and int64 codes
// alike, and a code outside [0, bins) is dropped as it is read, so the
// caller makes no clamp or cast pass. The counts are widened to int32 and
// stored 16 bytes at a time: plain stores when one part covers the row (no
// zeroed output is needed), else atomic adds of the nonzero counts into a
// zeroed output. One block a part leaves an SM one block at 128 KiB, which
// the launch plan (ops/histogram.py::launch_plan) sizes.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void load4(const int32_t* p, int32_t (&c)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  c[0] = v.x;
  c[1] = v.y;
  c[2] = v.z;
  c[3] = v.w;
}

__device__ __forceinline__ void load4(const int64_t* p, int64_t (&c)[4]) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
  c[0] = a.x;
  c[1] = a.y;
  c[2] = b.x;
  c[3] = b.y;
}

// One entry into the packed counters h of bins [lo, lo + width).
template <typename T>
__device__ __forceinline__ void count(uint32_t* h, T code, uint32_t ok, int lo, int width) {
  using U = typename std::make_unsigned<T>::type;
  // codes below lo wrap to large unsigned values and drop out too
  const U u = static_cast<U>(code - static_cast<T>(lo));
  if (ok && u < static_cast<U>(width))
    atomicAdd(&h[u >> 1], 1u << (static_cast<uint32_t>(u & 1) << 4));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
histogram_kernel(const T* __restrict__ codes,         // [B, N]
                 const uint8_t* __restrict__ valid,   // [B, N] bool
                 int32_t* __restrict__ out,           // [B, bins]
                 int N, int bins, int slice_bins, int n_slices, int chunk,
                 int copies, int accumulate, int vec) {
  extern __shared__ uint4 smem[];  // [copies][copy_words] packed counters
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);
  const int slice = blockIdx.x % n_slices;
  const int part = blockIdx.x / n_slices;
  const size_t row = blockIdx.y;
  const int lo = slice * slice_bins;
  const int width = min(slice_bins, bins - lo);
  const int copy_words = (((width + 1) >> 1) + 3) & ~3;  // whole 16-byte vectors
  for (int i = threadIdx.x; i < copies * copy_words / 4; i += blockDim.x)
    smem[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  uint32_t* h = hist + ((threadIdx.x >> 5) % copies) * copy_words;
  const size_t base = row * N;
  const T* rc = codes + base;
  const uint8_t* rv = valid + base;
  const int begin = part * chunk;
  const int end = min(N, begin + chunk);
  // entries [head, head + 4 * nvec) lie on 4-entry boundaries of the whole
  // array, whose base the caller aligned (vec = 1): 16-byte code loads and
  // 4-byte valid loads
  const int head = vec ? min(end, begin + static_cast<int>((4 - (base + begin) % 4) % 4))
                       : begin;
  const int nvec = vec ? (end - head) / 4 : 0;
  const int tail = head + 4 * nvec;
  for (int i = begin + threadIdx.x; i < head; i += blockDim.x) count(h, rc[i], rv[i], lo, width);
  for (int i = tail + threadIdx.x; i < end; i += blockDim.x) count(h, rc[i], rv[i], lo, width);
  const T* vc = rc + head;
  const uint32_t* vv = reinterpret_cast<const uint32_t*>(rv + head);
  int g = threadIdx.x;
  for (; g + static_cast<int>(blockDim.x) < nvec; g += 2 * blockDim.x) {
    // two groups in flight before their atomics
    T a[4], b[4];
    load4(vc + 4 * g, a);
    load4(vc + 4 * (g + blockDim.x), b);
    const uint32_t va = __ldg(vv + g);
    const uint32_t vb = __ldg(vv + g + blockDim.x);
#pragma unroll
    for (int k = 0; k < 4; ++k) count(h, a[k], (va >> (8 * k)) & 0xffu, lo, width);
#pragma unroll
    for (int k = 0; k < 4; ++k) count(h, b[k], (vb >> (8 * k)) & 0xffu, lo, width);
  }
  if (g < nvec) {
    T a[4];
    load4(vc + 4 * g, a);
    const uint32_t va = __ldg(vv + g);
#pragma unroll
    for (int k = 0; k < 4; ++k) count(h, a[k], (va >> (8 * k)) & 0xffu, lo, width);
  }
  __syncthreads();

  // widen and store; the copies' packed words add without carry (a part
  // holds at most 65,535 entries)
  int32_t* o = out + row * bins + lo;
  if (bins % 4 == 0) {  // then width % 4 == 0 and o is 16-byte aligned
    for (int q = threadIdx.x; q < width / 4; q += blockDim.x) {
      uint32_t w0 = 0u, w1 = 0u;
      for (int c = 0; c < copies; ++c) {
        const uint2 w = *reinterpret_cast<const uint2*>(hist + c * copy_words + 2 * q);
        w0 += w.x;
        w1 += w.y;
      }
      const int4 v = make_int4(static_cast<int>(w0 & 0xffffu), static_cast<int>(w0 >> 16),
                               static_cast<int>(w1 & 0xffffu), static_cast<int>(w1 >> 16));
      if (!accumulate) {
        reinterpret_cast<int4*>(o)[q] = v;
      } else {
        if (v.x) atomicAdd(o + 4 * q, v.x);
        if (v.y) atomicAdd(o + 4 * q + 1, v.y);
        if (v.z) atomicAdd(o + 4 * q + 2, v.z);
        if (v.w) atomicAdd(o + 4 * q + 3, v.w);
      }
    }
  } else {
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
      uint32_t w = 0u;
      for (int c = 0; c < copies; ++c) w += hist[c * copy_words + (i >> 1)];
      const int v = static_cast<int>((w >> ((i & 1) << 4)) & 0xffffu);
      if (!accumulate) {
        o[i] = v;
      } else if (v) {
        atomicAdd(o + i, v);
      }
    }
  }
}

template <typename T>
int launch(const void* codes, const void* valid, void* out, int B, int N, int bins,
           int slice_bins, int n_parts, int chunk, int copies, int threads,
           int shared_bytes, int vec, cudaStream_t stream) {
  auto kernel = histogram_kernel<T>;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_slices = (bins + slice_bins - 1) / slice_bins;
  const dim3 grid(n_slices * n_parts, B);
  kernel<<<grid, threads, shared_bytes, stream>>>(
      static_cast<const T*>(codes), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(out), N, bins, slice_bins, n_slices, chunk, copies,
      n_parts > 1 ? 1 : 0, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan the kernel does not take. All pointers
// are device pointers on `device`, which is current during the call only
// (device_guard.cuh); the caller owns every buffer. The plan
// (ops/histogram.py::launch_plan): bins in slices of slice_bins (all bins,
// or a multiple of 4), each row in n_parts parts of chunk <= 65,535 entries (with
// n_parts > 1 `out` must be zeroed), `copies` counter copies (1, or one a
// warp), `threads` a block and shared_bytes of dynamic shared memory.
// code_bytes is 4 (int32 codes) or 8 (int64); vec = 1 when codes lie on a
// 16-byte and valid on a 4-byte boundary.
extern "C" int gadev_histogram_launch(const void* codes, const void* valid, void* out,
                                      int B, int N, int bins, int slice_bins, int n_parts,
                                      int chunk, int copies, int threads, int shared_bytes,
                                      int code_bytes, int vec, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.status() != cudaSuccess) return static_cast<int>(guard.status());
  if (B <= 0 || bins <= 0) return 0;
  const int copy_words = (((slice_bins + 1) / 2) + 3) & ~3;
  if (slice_bins <= 0 || (slice_bins < bins && slice_bins % 4 != 0) || n_parts <= 0 ||
      chunk < 0 || chunk > 65535 || static_cast<long long>(chunk) * n_parts < N ||
      threads <= 0 || threads % 32 != 0 || threads > kMaxThreads ||
      (copies != 1 && copies != threads / 32) ||
      shared_bytes < 4 * copies * copy_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 4)
    return launch<int32_t>(codes, valid, out, B, N, bins, slice_bins, n_parts, chunk, copies,
                           threads, shared_bytes, vec, st);
  if (code_bytes == 8)
    return launch<int64_t>(codes, valid, out, B, N, bins, slice_bins, n_parts, chunk, copies,
                           threads, shared_bytes, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
