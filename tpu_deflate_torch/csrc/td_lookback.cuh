// Decoupled look-back over a lane's segments (K4 compaction, K10 emit, the
// tile split).
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

struct Plus {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// The segment's exclusive prefix in its lane, starting at init: publish
// this segment's aggregate, combine the predecessors' aggregates back to
// the nearest inclusive prefix (32 segments per round, one per thread of
// the warp), publish the inclusive prefix. op combines two values (any
// associative and commutative operation whose identity is 0; a sum by
// default). status points at the lane's first segment. Run by one whole
// warp.
template <class Op = Plus>
__device__ __forceinline__ int look_back(unsigned long long* status, int seg, int agg, int init, Op op = Op()) {
  const int lid = threadIdx.x & 31;
  if (seg == 0) {
    if (lid == 0) atomicExch(&status[0], FLAG_PREFIX | (uint32_t)op(init, agg));
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
    for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
    excl = op(excl, x);
    if (prefix) break;
  }
  if (lid == 0) atomicExch(&status[seg], FLAG_PREFIX | (uint32_t)op(excl, agg));
  return excl;
}

}  // namespace td

namespace td {

// The same look-back over a pair of values packed into 62 bits (the tile
// split's saturating byte prefix and its count of valid tokens): the flag
// in the top two bits of the status word (PAIR_AGG, PAIR_PREFIX), the
// packed value in the low 62, so one 64-bit word publishes both at once
// and needs no fence. op combines two packed values (associative and
// commutative, identity 0). Each lane of the warp reads ITEMS status words
// a round, so a round folds 32 * ITEMS predecessors and the inclusive
// prefixes, which every block publishes once it has its own, travel that
// many segments a round trip. Run by one whole warp; returns the
// segment's exclusive prefix.
constexpr unsigned long long PAIR_AGG = 1ull << 62, PAIR_PREFIX = 2ull << 62, PAIR_VALUE = PAIR_AGG - 1;

template <int ITEMS, class Op>
__device__ __forceinline__ unsigned long long look_back_pair(unsigned long long* status, int seg,
                                                             unsigned long long agg, Op op) {
  const int lid = threadIdx.x & 31;
  if (seg == 0) {
    if (lid == 0) atomicExch(&status[0], PAIR_PREFIX | agg);
    return 0;
  }
  if (lid == 0) atomicExch(&status[seg], PAIR_AGG | agg);
  unsigned long long excl = 0;
  for (int top = seg - 1;; top -= 32 * ITEMS) {
    const volatile unsigned long long* p = status + (top - lid * ITEMS);
    unsigned long long v[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) v[i] = top - lid * ITEMS - i >= 0 ? p[-i] : PAIR_PREFIX;  // all in flight
    int first = ITEMS;  // this lane's nearest inclusive prefix
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      // Segment top - lid * ITEMS - i's block runs already (its ticket came
      // first), so it publishes; a fault that kept it from doing so traps,
      // not hangs. Before segment 0 there is nothing to add.
      for (unsigned spins = 0; v[i] >> 62 == 0; v[i] = p[-i])
        if (++spins > (1u << 28)) __trap();
      if (v[i] >> 62 == 2 && first == ITEMS) first = i;
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, first < ITEMS);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;  // the lane of the nearest prefix in this round
    unsigned long long x = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (lid < stop || (lid == stop && i <= first)) x = op(x, v[i] & PAIR_VALUE);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
    excl = op(excl, x);
    if (prefix) break;
  }
  if (lid == 0) atomicExch(&status[seg], PAIR_PREFIX | op(excl, agg));
  return excl;
}

}  // namespace td
