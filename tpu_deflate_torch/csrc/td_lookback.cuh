// Decoupled look-back over a lane's segments (K4 compaction, K10 emit).
//
// A kernel cuts each lane into segments, one block each, and needs every
// segment's exclusive prefix of a per-segment count over the lane. Blocks
// take their segment from an atomic ticket (lane-major), so a block only
// ever waits on segments whose blocks already run. Each (lane, segment)
// has a 64-bit status word, zero before the launch: the flag in the high
// half (0 nothing yet, FLAG_AGG the segment's own count, FLAG_PREFIX its
// inclusive prefix) and the value in the low half.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace td {

constexpr unsigned long long FLAG_AGG = 1ull << 32, FLAG_PREFIX = 2ull << 32;

// The segment's exclusive prefix in its lane, starting at init: publish
// this segment's aggregate, add the predecessors' aggregates back to the
// nearest inclusive prefix (32 segments per round, one per thread of the
// warp), publish the inclusive prefix. status points at the lane's first
// segment. Run by one whole warp.
__device__ __forceinline__ int look_back(unsigned long long* status, int seg, int agg, int init) {
  const int lid = threadIdx.x & 31;
  if (seg == 0) {
    if (lid == 0) atomicExch(&status[0], FLAG_PREFIX | (uint32_t)(init + agg));
    return init;
  }
  if (lid == 0) atomicExch(&status[seg], FLAG_AGG | (uint32_t)agg);
  int excl = 0;
  for (int top = seg - 1;; top -= 32) {
    const int j = top - lid;
    unsigned long long v = FLAG_PREFIX;  // before segment 0: nothing to add
    if (j >= 0) {
      // Segment j's block runs already (its ticket came first), so it
      // publishes; a fault that kept it from doing so traps, not hangs.
      const volatile unsigned long long* p = status + j;
      for (unsigned spins = 0; (v = *p) >> 32 == 0; ++spins)
        if (spins > (1u << 28)) __trap();
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, (v >> 32) == 2);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;  // nearest prefix in this round
    int x = lid <= stop ? (int)(uint32_t)v : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    excl += x;
    if (prefix) break;
  }
  if (lid == 0) atomicExch(&status[seg], FLAG_PREFIX | (uint32_t)(excl + agg));
  return excl;
}

}  // namespace td
