// Variants of the match finder's key kernel (csrc/match.cu:match_keys_kernel),
// timed by scripts/keys_variants.py. Each computes keys[f, l, i] exactly as
// td_match_keys does: family f's 16-bit multiplicative hash of the
// zero-extended row at i (4-byte, 3-byte or 6-byte window), or -1 where
// i >= lengths[l] or i < hstart[l].
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t HASH_MUL = 2654435761u;
constexpr uint32_t H6_MUL = 0x9E3779B1u;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int key_of(int family, uint32_t a, uint32_t b, int i, int len, int hs) {
  const uint32_t x = family == 0 ? a : family == 1 ? (a & 0xFFFFFFu) : (a ^ ((b & 0xFFFFu) * H6_MUL));
  return i < len && i >= hs ? (int)((x * HASH_MUL) >> 16) : -1;
}

__device__ __forceinline__ uint32_t byte_word(const uint8_t* row, int p, int S) {
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) x |= (p + b < S ? (uint32_t)row[p + b] : 0u) << (8 * b);
  return x;
}

// 0: the first design: a thread a position, grid (S / 256, L, F), six byte loads.
__global__ void __launch_bounds__(256) v_position(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                                                  const int* __restrict__ hstart, int* __restrict__ keys, int S,
                                                  int codes) {
  const int l = blockIdx.y;
  const int family = (codes >> (2 * blockIdx.z)) & 3;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= S) return;
  const uint8_t* row = data + (size_t)l * S;
  const uint32_t a = byte_word(row, i, S), b = byte_word(row, i + 4, S);
  keys[((size_t)blockIdx.z * gridDim.y + l) * S + i] =
      key_of(family, a, b, i, lengths[l], hstart == nullptr ? 0 : hstart[l]);
}

// 1, 2, 4: a run of 16 positions a thread: one 16-byte and one 8-byte load;
// STORE 0: four 16-byte stores a family; 1: the same, streaming (__stcs);
// 2: staged in shared memory, stored by the block 512 contiguous bytes a
// warp instruction.
template <int STORE>
__global__ void __launch_bounds__(256) v_run16(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                                               const int* __restrict__ hstart, int* __restrict__ keys, int S, int F,
                                               int codes) {
  __shared__ __align__(16) int stage[STORE == 2 ? 4096 : 4];
  __shared__ int s_len, s_hs;
  const int l = blockIdx.y;
  if (threadIdx.x == 0) {
    s_len = lengths[l];
    s_hs = hstart == nullptr ? 0 : hstart[l];
  }
  __syncthreads();
  const int base = blockIdx.x * 4096;
  const int i0 = base + threadIdx.x * 16;
  const uint8_t* row = data + (size_t)l * S;
  uint32_t w[6];
  if (i0 + 24 <= S) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + i0));
    const uint2 n = __ldg(reinterpret_cast<const uint2*>(row + i0 + 16));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w; w[4] = n.x; w[5] = n.y;
  } else {
#pragma unroll
    for (int t = 0; t < 6; ++t) w[t] = byte_word(row, i0 + 4 * t, S);
  }
  const size_t plane = (size_t)gridDim.y * S;
  for (int f = 0; f < F; ++f) {
    const int family = (codes >> (2 * f)) & 3;
    int h[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t a = __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], 8 * (j & 3));
      const uint32_t b = __funnelshift_r(w[(j >> 2) + 1], w[(j >> 2) + 2], 8 * (j & 3));
      h[j] = key_of(family, a, b, i0 + j, s_len, s_hs);
    }
    int* o = keys + f * plane + (size_t)l * S;
    if (STORE == 2) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        reinterpret_cast<int4*>(stage + threadIdx.x * 16)[q] = make_int4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                                                                         h[4 * q + 3]);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = threadIdx.x + 256 * q;  // int4 index in the block
        if (base + 4 * c < S) reinterpret_cast<int4*>(o + base)[c] = reinterpret_cast<int4*>(stage)[c];
      }
      __syncthreads();
    } else if (i0 < S) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = make_int4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        if (STORE == 1) __stcs(reinterpret_cast<int4*>(o + i0) + q, v);
        else reinterpret_cast<int4*>(o + i0)[q] = v;
      }
    }
  }
}

// 3, 5: four runs of 4 positions a thread, a warp's lanes 4 positions apart
// (512 positions a warp, 4096 a block): word loads, the next two words from
// lanes + 1 and + 2 by shuffles, one 16-byte store a family a run (512
// contiguous bytes a warp instruction); STREAM: __stcs.
template <bool STREAM>
__global__ void __launch_bounds__(256) v_warp4(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                                               const int* __restrict__ hstart, int* __restrict__ keys, int S, int F,
                                               int codes) {
  __shared__ int s_len, s_hs;
  const int l = blockIdx.y;
  if (threadIdx.x == 0) {
    s_len = lengths[l];
    s_hs = hstart == nullptr ? 0 : hstart[l];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wbase = blockIdx.x * 4096 + warp * 512;
  const uint8_t* row = data + (size_t)l * S;
  uint32_t x[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const int p = wbase + 128 * r + 4 * lane;
    x[r] = (r < 4 || lane < 2) && p < S ? __ldg(reinterpret_cast<const uint32_t*>(row + p)) : 0u;
  }
  const size_t plane = (size_t)gridDim.y * S;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t a1 = __shfl_down_sync(FULL, x[r], 1), b1 = __shfl_sync(FULL, x[r + 1], 0);
    const uint32_t a2 = __shfl_down_sync(FULL, x[r], 2), b2 = __shfl_sync(FULL, x[r + 1], (lane + 2) & 31);
    const uint32_t w0 = x[r], w1 = lane == 31 ? b1 : a1, w2 = lane >= 30 ? b2 : a2;
    const int i0 = wbase + 128 * r + 4 * lane;
    for (int f = 0; f < F; ++f) {
      const int family = (codes >> (2 * f)) & 3;
      int h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = key_of(family, __funnelshift_r(w0, w1, 8 * j), __funnelshift_r(w1, w2, 8 * j), i0 + j, s_len, s_hs);
      if (i0 < S) {
        int4* o = reinterpret_cast<int4*>(keys + f * plane + (size_t)l * S + i0);
        const int4 v = make_int4(h[0], h[1], h[2], h[3]);
        if (STREAM) __stcs(o, v);
        else *o = v;
      }
    }
  }
}

}  // namespace

// Rows 16-byte aligned and S a multiple of 4096 (the encoder's batches).
extern "C" int keys_variant(int v, const void* data, const void* lengths, const void* hstart, void* keys, int L,
                            int S, int F, int codes, void* stream) {
  if (S % 4096 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  const int* len = static_cast<const int*>(lengths);
  const int* hs = static_cast<const int*>(hstart);
  int* k = static_cast<int*>(keys);
  const dim3 grid(S / 4096, L);
  switch (v) {
    case 0: v_position<<<dim3(S / 256, L, F), 256, 0, st>>>(d, len, hs, k, S, codes); break;
    case 1: v_run16<0><<<grid, 256, 0, st>>>(d, len, hs, k, S, F, codes); break;
    case 2: v_run16<1><<<grid, 256, 0, st>>>(d, len, hs, k, S, F, codes); break;
    case 3: v_warp4<false><<<grid, 256, 0, st>>>(d, len, hs, k, S, F, codes); break;
    case 4: v_run16<2><<<grid, 256, 0, st>>>(d, len, hs, k, S, F, codes); break;
    case 5: v_warp4<true><<<grid, 256, 0, st>>>(d, len, hs, k, S, F, codes); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
