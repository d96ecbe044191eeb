// Variants of the tile split's place pass (tpu_deflate_torch/csrc/
// tile_split.cu, included whole), and a probe of its phases: with a stamp
// buffer set, thread 0 of every block writes %globaltimer at the end of
// each phase of placing (TD_SPLIT_STAMP) into stamps[ticket * 8 + phase]. Built and
// driven by scripts/split_variants.py.
#include <cuda_runtime.h>

__device__ unsigned long long* g_stamps;

#define TD_SPLIT_STAMP(phase)                                              \
  do {                                                                     \
    if (threadIdx.x == 0 && g_stamps) {                                    \
      unsigned long long now;                                              \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));              \
      g_stamps[(size_t)s_ticket * 8 + (phase)] = now;                      \
    }                                                                      \
  } while (0)

#include "../tpu_deflate_torch/csrc/tile_split.cu"

// Variant v's segment length in tokens (0 for an unknown v).
extern "C" int split_variant_segment(int v) {
  switch (v) {
    case 1: return 8192;
    case 0: case 2: return 4096;
    case 3: return 2048;
    case 4: case 5: return 4096;
    default: return 0;
  }
}

// The split by variant v (see scripts/split_variants.py), scratch as
// td_tile_split's; stamps: null, or 8 uint64 a segment.
extern "C" int split_variant(int v, const void* tok, void* out, void* scratch, void* other, long long dirty, int L,
                             int K, int T, void* stamps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemcpyToSymbolAsync(g_stamps, &stamps, sizeof(stamps), 0, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  switch (v) {
    case 0: return tile_split<256, 16, 4, 4>(tok, out, scratch, other, dirty, L, K, T, s);
    case 1: return tile_split<512, 16, 4, 2>(tok, out, scratch, other, dirty, L, K, T, s);
    case 2: return tile_split<512, 8, 4, 3>(tok, out, scratch, other, dirty, L, K, T, s);
    case 3: return tile_split<256, 8, 4, 6>(tok, out, scratch, other, dirty, L, K, T, s);
    case 4: return tile_split<256, 16, 8, 4>(tok, out, scratch, other, dirty, L, K, T, s);
    case 5: return tile_split<256, 16, 16, 4>(tok, out, scratch, other, dirty, L, K, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
