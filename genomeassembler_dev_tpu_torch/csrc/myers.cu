// Myers/Hyyro bit-vector Levenshtein distance of B queries against one
// shared target, NW (global) or HW (infix: gaps at the target's ends free).
//
// Replaces the TPU kernel genomeassembler_dev_tpu/ops/pallas/myers_kernel.py
// (_kernel, wrapper batched_levenshtein_myers). It computes the same
// distances, including the empty-query rule (NW: N, HW: 0), but not the same
// way: the TPU kernel keeps queries on lanes and resolves the word chain by
// a log2(W) prefix of 2-state maps; here one thread owns one query and runs
// the classic block chain (Hyyro 2003, as edlib does), passing the
// horizontal delta hin/hout in {-1, 0, +1} from word to word.
//
// What bounds it: about 17 dependent integer operations per 32-cell word
// and target character, on one serial chain per query, plus three 4-byte
// loads and two 4-byte stores of that word's state. With one thread per
// query the card holds only B threads (512 at the study shape), so the
// chain's latency, not the card's integer rate, sets the time. The state
// (VP/VN [W, B]) and the match masks (Peq [4, W, B]) live in scratch that
// the wrapper allocates, laid out so that neighbouring threads touch
// neighbouring words; each thread loads the next word's operands before it
// computes the current one. The target streams through shared memory in
// tiles. Only the words up to the one holding row qlen-1 are updated: bits
// above the score row never reach it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kTile = 4096;

__global__ void __launch_bounds__(kThreads)
myers_kernel(const uint8_t* __restrict__ queries,  // [B, M]
             const int32_t* __restrict__ qlens,    // [B]
             const uint8_t* __restrict__ target,   // [N]
             int32_t* __restrict__ out,            // [B]
             uint32_t* __restrict__ peq,           // [4, W, B] scratch
             uint32_t* __restrict__ vp,            // [W, B] scratch
             uint32_t* __restrict__ vn,            // [W, B] scratch
             int B, int M, int N, int W, int hw) {
  __shared__ uint8_t tile[kTile];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int qlen = b < B ? min(qlens[b], M) : 0;
  const bool active = qlen > 0;
  const int nw = active ? ((qlen - 1) >> 5) + 1 : 0;  // words to update
  const uint32_t bstar = active ? static_cast<uint32_t>((qlen - 1) & 31) : 0u;
  const size_t sB = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(W) * sB;

  // Peq[c][w] bit i = (query[32w + i] == c); positions >= qlen match nothing
  for (int w = 0; w < nw; ++w) {
    uint32_t e[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < 32; ++i) {
      const int p = 32 * w + i;
      if (p < qlen) {
        const uint32_t c = queries[static_cast<size_t>(b) * M + p];
        if (c < 4) e[c] |= 1u << i;
      }
    }
    for (int c = 0; c < 4; ++c) peq[c * plane + w * sB + b] = e[c];
    vp[w * sB + b] = ~0u;
    vn[w * sB + b] = 0u;
  }

  int score = qlen;  // D[0][qlen]
  int best = qlen;   // HW: minimum over columns, the top row included
  const int hin0 = hw ? 0 : 1;  // top-row horizontal delta
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int n = min(kTile, N - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = target[t0 + i];
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      const uint32_t tc = tile[i];
      // a target code outside 0..3 matches nothing (pipeline codes are ACGT)
      const uint32_t* eqp = tc < 4 ? peq + tc * plane : nullptr;
      int hin = hin0;
      uint32_t eq_n = eqp ? eqp[b] : 0u;
      uint32_t pv_n = vp[b];
      uint32_t mv_n = vn[b];
      for (int w = 0; w < nw; ++w) {
        uint32_t eq = eq_n;
        const uint32_t pv = pv_n;
        const uint32_t mv = mv_n;
        if (w + 1 < nw) {
          const size_t o = (w + 1) * sB + b;
          eq_n = eqp ? eqp[o] : 0u;
          pv_n = vp[o];
          mv_n = vn[o];
        }
        const uint32_t hneg = hin < 0 ? 1u : 0u;
        const uint32_t hpos = hin > 0 ? 1u : 0u;
        const uint32_t xv = eq | mv;
        eq |= hneg;
        const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
        uint32_t ph = mv | ~(xh | pv);
        uint32_t mh = pv & xh;
        if (w == nw - 1) {
          score += static_cast<int>((ph >> bstar) & 1u) -
                   static_cast<int>((mh >> bstar) & 1u);
        }
        hin = static_cast<int>(ph >> 31) - static_cast<int>(mh >> 31);
        ph = (ph << 1) | hpos;
        mh = (mh << 1) | hneg;
        const size_t o = w * sB + b;
        vp[o] = mh | ~(xv | ph);
        vn[o] = ph & xv;
      }
      if (hw) best = min(best, score);
    }
  }
  if (b < B) out[b] = active ? (hw ? best : score) : (hw ? 0 : N);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). All
// pointers are device pointers on `device`; the caller owns every buffer.
extern "C" int gadev_myers_launch(const void* queries, const void* qlens,
                                  const void* target, void* out, void* peq,
                                  void* vp, void* vn, int B, int M, int N,
                                  int W, int hw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  myers_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(queries), static_cast<const int32_t*>(qlens),
      static_cast<const uint8_t*>(target), static_cast<int32_t*>(out),
      static_cast<uint32_t*>(peq), static_cast<uint32_t*>(vp),
      static_cast<uint32_t*>(vn), B, M, N, W, hw);
  return static_cast<int>(cudaGetLastError());
}
