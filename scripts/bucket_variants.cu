// Variants of the match finder's candidate compare (tpu_deflate_torch/csrc/
// match.cu, match_bucket_kernel), for scripts/bucket_variants.py: each writes
// the same packed matches (F, L, S) from the same links and rows. match.cu's
// kernel is variant 5 (1024 threads, two blocks an SM, the position's first
// word read once).
//
//   THREADS, TILE  a block's threads and positions (the block stages the
//                  bytes from MAX_DIST before its tile to 80 past it)
//   OWN            the position's first funnel-shifted word is read once, not
//                  at every hop
//   GLINKS         the links are read from global memory (__ldg, through L1)
//                  instead of being staged with the bytes
//   MINB           the blocks an SM that __launch_bounds__ asks room for
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIST = 32768;
constexpr int MAX_WORDS = 16;

template <bool OWN>
__device__ __forceinline__ int prefix_len(const uint32_t* row, uint32_t a0, int a, int b, int nwords) {
  const uint32_t* pa = row + (a >> 2);
  const uint32_t* pb = row + (b >> 2);
  const int sa = (a & 3) * 8, sb = (b & 3) * 8;
  int w0 = 0;
  uint32_t alo = pa[0], blo = pb[0];
  if (OWN) {
    const uint32_t bhi = pb[1];
    const uint32_t x = a0 ^ __funnelshift_r(blo, bhi, sb);
    if (x) return (__ffs(x) - 1) >> 3;
    alo = pa[1];
    blo = bhi;
    w0 = 1;
  }
  for (int w = w0; w < nwords; ++w) {
    const uint32_t ahi = pa[w + 1], bhi = pb[w + 1];
    const uint32_t x = __funnelshift_r(alo, ahi, sa) ^ __funnelshift_r(blo, bhi, sb);
    if (x) return 4 * w + ((__ffs(x) - 1) >> 3);
    alo = ahi;
    blo = bhi;
  }
  return 4 * nwords;
}

template <int THREADS, int TILE, bool OWN, bool GLINKS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    bucket_kernel(const uint16_t* __restrict__ prev, const uint8_t* __restrict__ data, int64_t* __restrict__ out,
                  int L, int S, int ks, int ws) {
  constexpr int SPAN = MAX_DIST + TILE;
  constexpr int DATA_BYTES = SPAN + 4 * MAX_WORDS + 16;
  extern __shared__ uint4 smem[];
  uint8_t* win = reinterpret_cast<uint8_t*>(smem);
  uint16_t* links = reinterpret_cast<uint16_t*>(win + DATA_BYTES);
  const int f = blockIdx.z, l = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int t1 = min(S, t0 + TILE);
  const int w0 = max(0, t0 - MAX_DIST);
  const int K = (ks >> (8 * f)) & 255;
  const int nwords = (ws >> (8 * f)) & 255;
  const uint8_t* src = data + (size_t)l * S;
  const size_t at = ((size_t)f * L + l) * S;
  const uint16_t* pr = prev + at;
  const int nb = (t1 - w0 + 4 * MAX_WORDS + 4 + 15) & ~15;
  const bool bytes16 = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int j = threadIdx.x; j < nb / 16; j += THREADS) {
    const int g = w0 + 16 * j;
    if (bytes16 && g + 16 <= S) {
      smem[j] = *reinterpret_cast<const uint4*>(src + g);
    } else {
      for (int b = 0; b < 16; ++b) win[16 * j + b] = g + b < S ? src[g + b] : 0;
    }
  }
  if (!GLINKS) {
    const int nl = t1 - w0;
    if ((reinterpret_cast<uintptr_t>(pr + w0) & 15) == 0 && (nl & 7) == 0) {
      const uint4* s8 = reinterpret_cast<const uint4*>(pr + w0);
      uint4* d8 = reinterpret_cast<uint4*>(links);
      for (int j = threadIdx.x; j < nl / 8; j += THREADS) d8[j] = s8[j];
    } else {
      for (int j = threadIdx.x; j < nl; j += THREADS) links[j] = pr[w0 + j];
    }
  }
  __syncthreads();
  const uint32_t* row = reinterpret_cast<const uint32_t*>(win);
  const int cap = 4 * nwords;
  for (int p = t0 + threadIdx.x; p < t1; p += THREADS) {
    const int a = p - w0;
    const uint32_t a0 = OWN ? __funnelshift_r(row[a >> 2], row[(a >> 2) + 1], (a & 3) * 8) : 0u;
    int blen = 0, bcand = -1, c = p;
    for (int k = 0; k < K; ++k) {
      const int d = GLINKS ? (int)__ldg(pr + c) : (int)links[c - w0];
      if (d == 0) break;
      c -= d;
      if (p - c > MAX_DIST) break;
      const int lc = prefix_len<OWN>(row, a0, a, c - w0, nwords);
      if (lc > blen) {
        blen = lc;
        bcand = c;
        if (blen == cap) break;
      }
    }
    out[at + p] = blen > 0 ? ((int64_t)(bcand + 1) | (int64_t)blen << 32) : 0;
  }
}

template <int THREADS, int TILE, bool OWN, bool GLINKS, int MINB>
int launch(const void* prev, const void* data, void* out, int L, int S, int F, int ks, int ws, cudaStream_t s) {
  constexpr int SPAN = MAX_DIST + TILE;
  const int smem = SPAN + 4 * MAX_WORDS + 16 + (GLINKS ? 0 : 2 * SPAN);
  auto kernel = bucket_kernel<THREADS, TILE, OWN, GLINKS, MINB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((S + TILE - 1) / TILE, L, F), THREADS, smem, s>>>(
      static_cast<const uint16_t*>(prev), static_cast<const uint8_t*>(data), static_cast<int64_t*>(out), L, S, ks,
      ws);
  return (int)cudaGetLastError();
}

}  // namespace

// The variants, in the order scripts/bucket_variants.py names them.
extern "C" int bucket_variant(int v, const void* prev, const void* data, void* out, int L, int S, int F, int ks,
                              int ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return launch<512, 4096, false, false, 1>(prev, data, out, L, S, F, ks, ws, s);  // the first design
    case 1: return launch<512, 4096, true, false, 1>(prev, data, out, L, S, F, ks, ws, s);
    case 2: return launch<512, 4096, false, true, 1>(prev, data, out, L, S, F, ks, ws, s);
    case 3: return launch<512, 4096, true, true, 1>(prev, data, out, L, S, F, ks, ws, s);
    case 4: return launch<1024, 4096, false, false, 2>(prev, data, out, L, S, F, ks, ws, s);
    case 5: return launch<1024, 4096, true, false, 2>(prev, data, out, L, S, F, ks, ws, s);
    case 6: return launch<256, 4096, true, true, 4>(prev, data, out, L, S, F, ks, ws, s);
    case 7: return launch<1024, 8192, true, false, 1>(prev, data, out, L, S, F, ks, ws, s);
    case 8: return launch<1024, 4096, true, true, 2>(prev, data, out, L, S, F, ks, ws, s);
    case 9: return launch<512, 4096, true, true, 4>(prev, data, out, L, S, F, ks, ws, s);
    case 10: return launch<512, 4096, true, false, 2>(prev, data, out, L, S, F, ks, ws, s);
    case 11: return launch<512, 2048, true, true, 4>(prev, data, out, L, S, F, ks, ws, s);
    default: return -1;
  }
}
