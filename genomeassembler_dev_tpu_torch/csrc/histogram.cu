// Per-row histogram of k-mer codes under a validity mask:
// counts[b, c] = #{n : valid[b, n] and codes[b, n] == c}, c in [0, bins).
//
// Replaces the TPU kernel genomeassembler_dev_tpu/ops/pallas/
// histogram_kernel.py (_kernel, wrapper count_kmers_mxu_pallas). The TPU
// kernel turns the scatter into a hi/lo one-hot matrix product because
// scatters run near-scalar there; on this card a scatter into shared memory
// is cheap, so the histogram is counted directly.
//
// One block owns one (row, bin slice, part of the row). It zeroes a private
// slice of 32-bit counters in shared memory, streams its part of the row's
// codes and masks (coalesced), adds one per valid code that falls in its
// slice with a shared-memory atomic, and writes the slice out: a plain store
// when one part covers the whole row, an atomic add of the nonzero counters
// into a zeroed output when several parts share it. Invalid entries and
// codes outside [0, bins) are dropped.
//
// What bounds it: the codes are read once per bin slice (4 slices of 16,384
// bins at k = 8, 4^k * 4 bytes being more than the 227 KB a block can hold),
// and the [B, 4^k] int32 output is written once, so it is a streaming kernel
// bound by device memory; shared-memory atomics serialise only when many
// codes hit one counter.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int32_t* __restrict__ codes,  // [B, N]
                 const uint8_t* __restrict__ valid,  // [B, N] bool
                 int32_t* __restrict__ out,          // [B, bins]
                 int N, int bins, int slice_bins, int n_slices, int chunk,
                 int accumulate) {
  extern __shared__ uint32_t hist[];  // [slice_bins]
  const int slice = blockIdx.x % n_slices;
  const int part = blockIdx.x / n_slices;
  const size_t row = blockIdx.y;
  const int lo = slice * slice_bins;
  const int width = min(slice_bins, bins - lo);
  for (int i = threadIdx.x; i < width; i += blockDim.x) hist[i] = 0u;
  __syncthreads();

  const int32_t* rc = codes + row * N;
  const uint8_t* rv = valid + row * N;
  const int end = min(N, (part + 1) * chunk);
  for (int i = part * chunk + threadIdx.x; i < end; i += blockDim.x) {
    if (rv[i]) {
      // codes below lo wrap to large unsigned values and drop out too
      const uint32_t c = static_cast<uint32_t>(rc[i] - lo);
      if (c < static_cast<uint32_t>(width)) atomicAdd(&hist[c], 1u);
    }
  }
  __syncthreads();

  int32_t* o = out + row * bins + lo;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const int v = static_cast<int>(hist[i]);
    if (!accumulate) {
      o[i] = v;
    } else if (v) {
      atomicAdd(&o[i], v);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers on `device`; the caller owns every buffer.
// Each row is cut into n_parts parts; with n_parts > 1 `out` must be zeroed.
extern "C" int gadev_histogram_launch(const void* codes, const void* valid, void* out,
                                      int B, int N, int bins, int slice_bins,
                                      int n_parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || bins <= 0) return 0;
  const int n_slices = (bins + slice_bins - 1) / slice_bins;
  const int chunk = (N + n_parts - 1) / n_parts;
  const size_t smem = static_cast<size_t>(slice_bins) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(histogram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_slices * n_parts, B);
  histogram_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(out), N, bins, slice_bins, n_slices, chunk,
      n_parts > 1 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
