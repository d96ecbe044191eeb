// Level-2 compaction (K4, and K7 as its no-map mode).
//
// Replaces tpu_deflate/codec/decode_pallas.py:_compact_flat_kernel (called
// from _compact_flat_jit) and, with map_literals = 0,
// decode_pallas.py:_compact_any_kernel (called from _compact_any_jit).
// For every lane, the non-negative entries of tok (L, M) int32 move to the
// front in order, -1 fills the rest; in the flat mode each literal rank
// below 256 becomes its byte through the lane's 8 x 8-word bit planes
// (lit_planes (L, 64) int32: word b*8+w, bit j = bit b of rank 32w+j).
//
// Bound on the H100: memory traffic, one read and one write of 4 bytes
// per entry (M = NT * k1 per lane). Design: one block of 1024 threads per
// lane walks the lane in chunks of 1024 entries; a ballot and a popcount
// rank each entry within its warp, one warp scans the 32 warp counts, and
// each valid entry is stored at (lane total so far + its rank). The TPU
// kernel's log-shift rank and its 2 log2(M) displacement-move rounds over
// the whole lane are not needed.
#include "td_common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
    compact_kernel(const int* __restrict__ tok, const int* __restrict__ planes,
                   int* __restrict__ out, int M, int map_literals) {
  __shared__ uint32_t lp[64];
  __shared__ int warp_off[WARPS];
  __shared__ int chunk_total;
  const int lane = blockIdx.x;
  const int wid = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int* x = tok + (size_t)lane * M;
  int* y = out + (size_t)lane * M;
  if (map_literals && threadIdx.x < 64) lp[threadIdx.x] = (uint32_t)planes[lane * 64 + threadIdx.x];

  int done = 0;  // valid entries stored so far
  for (int base = 0; base < M; base += THREADS) {
    const int i = base + threadIdx.x;
    int v = i < M ? x[i] : -1;
    const bool valid = v >= 0;
    const uint32_t ballot = __ballot_sync(0xffffffffu, valid);
    const int rank = __popc(ballot & ((1u << lid) - 1u));
    if (lid == 0) warp_off[wid] = __popc(ballot);
    __syncthreads();
    if (wid == 0) {
      const int c = warp_off[lid];
      int incl = c;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, s);
        if (lid >= s) incl += n;
      }
      warp_off[lid] = incl - c;
      if (lid == 31) chunk_total = incl;
    }
    __syncthreads();
    if (valid) {
      if (map_literals && v < 256) {
        const int w = v >> 5, lo5 = v & 31;
        int byte = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) byte |= (int)((lp[b * 8 + w] >> lo5) & 1u) << b;
        v = byte;
      }
      y[done + warp_off[wid] + rank] = v;
    }
    done += chunk_total;
    __syncthreads();
  }
  for (int i = done + threadIdx.x; i < M; i += THREADS) y[i] = -1;
}

}  // namespace

extern "C" int td_compact(const void* tok, const void* planes, void* out, int L, int M,
                          int map_literals, void* stream) {
  compact_kernel<<<L, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<const int*>(planes), static_cast<int*>(out), M,
      map_literals);
  return (int)cudaGetLastError();
}
