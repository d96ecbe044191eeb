// Shared helpers of the decode kernels.
//
// The reference kernels run under XLA, whose shifts are total functions: a
// shift count outside [0, 32) gives 0 for a left or logical right shift and
// the sign fill for an arithmetic right shift. In C++ such a shift is
// undefined, so every shift whose count is computed at run time goes
// through these helpers.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace td {

constexpr int W_P = 512;     // tile width in bits
constexpr int E_WIN = 48;    // entry offsets tracked per tile
constexpr int META_W = 128;  // int32 columns of the stage-A meta row
constexpr int SENT_EOB = 127;
constexpr int SENT_ERR = 255;
constexpr int EOB_ADV = 4096;  // cursor advance of an EOB position
constexpr int ERR_ADV = 8192;  // cursor advance of an error position

__device__ __forceinline__ uint32_t shl_u(uint32_t x, int n) {
  return (unsigned)n < 32u ? x << n : 0u;
}

__device__ __forceinline__ uint32_t shr_u(uint32_t x, int n) {
  return (unsigned)n < 32u ? x >> n : 0u;
}

__device__ __forceinline__ int32_t shl_i(int32_t x, int n) {
  return (int32_t)shl_u((uint32_t)x, n);
}

__device__ __forceinline__ int32_t sar_i(int32_t x, int n) {
  return (unsigned)n < 32u ? x >> n : (x < 0 ? -1 : 0);
}

// Stage-A delta -> cursor advance: EOB and error positions jump far past
// the tile, so terminal cursors freeze and the exit classes stay disjoint.
__device__ __forceinline__ int cursor_adv(int d) {
  return d == SENT_EOB ? EOB_ADV : (d == SENT_ERR ? ERR_ADV : d);
}

}  // namespace td
