// Lane CRC-32 of resolved rows.
//
// Replaces tpu_deflate/kernels/checksum_jax.py:crc32_lanes_raw8, an XLA
// function in the reference (int8 GF(2) matrix products on the MXU). rows
// (L, W) uint8, W = 512 n with n a power of two; raw (L,) uint32 gets the
// raw CRC register (init 0, no conditioning) of each whole row, which the
// host finishes per lane (checksum_lanes.crc32_finish_leftaligned).
//
// Bound on the H100: memory traffic, one read of each byte (64 KiB per
// lane at the decode's width). Design: one block per lane, one thread per
// 512-byte chunk computes the chunk's register from 0 with slice-by-8
// tables in shared memory, then a tree combines neighbours level by
// level: left' = M_l(left) ^ right, with M_l = L^{8 * 512 * 2^l} given as
// 32 words (word j = the operator's image of bit j). The reference expands
// every byte into 8 int8 bits for a matrix product, because the TPU has no
// table lookup; the table CRC reads each byte once.
#include "td_common.cuh"

namespace {

constexpr int CHUNK = 512;
constexpr int THREADS = 128;
constexpr int MAX_CHUNKS = 1024;
constexpr uint32_t POLY = 0xEDB88320u;

__global__ void __launch_bounds__(THREADS)
    crc32_lanes_kernel(const uint8_t* __restrict__ rows, const uint32_t* __restrict__ ops,
                       uint32_t* __restrict__ raw, int width) {
  __shared__ uint32_t T[8][256];
  __shared__ uint32_t reg[MAX_CHUNKS];
  const int t = threadIdx.x;
  const int n_chunks = width / CHUNK;
  for (int b = t; b < 256; b += THREADS) {
    uint32_t c = (uint32_t)b;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ POLY : c >> 1;
    T[0][b] = c;
  }
  __syncthreads();
  for (int k = 1; k < 8; ++k) {
    for (int b = t; b < 256; b += THREADS) T[k][b] = (T[k - 1][b] >> 8) ^ T[0][T[k - 1][b] & 0xFFu];
    __syncthreads();
  }

  const uint8_t* lane = rows + (size_t)blockIdx.x * width;
  for (int c = t; c < n_chunks; c += THREADS) {
    const uint2* q = reinterpret_cast<const uint2*>(lane + (size_t)c * CHUNK);
    uint32_t r = 0;
#pragma unroll 4
    for (int i = 0; i < CHUNK / 8; ++i) {
      const uint2 w = q[i];
      const uint32_t lo = w.x ^ r, hi = w.y;
      r = T[7][lo & 0xFFu] ^ T[6][(lo >> 8) & 0xFFu] ^ T[5][(lo >> 16) & 0xFFu] ^ T[4][lo >> 24] ^
          T[3][hi & 0xFFu] ^ T[2][(hi >> 8) & 0xFFu] ^ T[1][(hi >> 16) & 0xFFu] ^ T[0][hi >> 24];
    }
    reg[c] = r;
  }
  __syncthreads();

  for (int level = 0, n = n_chunks; n > 1; ++level, n >>= 1) {
    const uint32_t* M = ops + level * 32;
    uint32_t merged[MAX_CHUNKS / 2 / THREADS];
    int m = 0;
    for (int i = t; i < n / 2; i += THREADS, ++m) {
      const uint32_t left = reg[2 * i];
      uint32_t acc = reg[2 * i + 1];
#pragma unroll 8
      for (int j = 0; j < 32; ++j) acc ^= ((left >> j) & 1u) ? M[j] : 0u;
      merged[m] = acc;
    }
    __syncthreads();
    m = 0;
    for (int i = t; i < n / 2; i += THREADS, ++m) reg[i] = merged[m];
    __syncthreads();
  }
  if (t == 0) raw[blockIdx.x] = reg[0];
}

}  // namespace

extern "C" int td_crc32_lanes(const void* rows, const void* ops, void* raw, int L, int width,
                              int levels, void* stream) {
  if (width % CHUNK != 0 || width / CHUNK > MAX_CHUNKS || levels < 1) return (int)cudaErrorInvalidValue;
  crc32_lanes_kernel<<<L, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<const uint32_t*>(ops),
      static_cast<uint32_t*>(raw), width);
  return (int)cudaGetLastError();
}
