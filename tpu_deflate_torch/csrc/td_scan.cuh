// Warp and block scans of one int per thread, in thread order: a shuffle
// scan inside each warp; for a block, one warp scans the warp totals in
// shared memory.
#pragma once

#include <cuda_runtime.h>

namespace td {

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

template <class Op>
__device__ __forceinline__ int warp_inclusive(int v, Op op) {
  const int lid = threadIdx.x & 31;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, s);
    if (lid >= s) v = op(v, n);
  }
  return v;
}

// Exclusive scan of v over a block of THREADS threads (thread 0 gets
// identity); *aggregate gets the whole block's result. scratch: THREADS /
// 32 ints of shared memory that the block's previous call did not use
// (callers alternate two buffers, which saves a third barrier). Every
// thread of the block must call it (it synchronises the block twice).
template <int THREADS, class Op>
__device__ __forceinline__ int block_exclusive(int v, Op op, int identity, int* scratch,
                                               int* aggregate) {
  constexpr int WARPS = THREADS / 32;
  static_assert(THREADS % 32 == 0 && WARPS <= 32, "a block scan takes 32..1024 threads");
  const int lid = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int incl = warp_inclusive(v, op);
  if (lid == 31) scratch[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int w = warp_inclusive(lid < WARPS ? scratch[lid] : identity, op);
    if (lid < WARPS) scratch[lid] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lid == 0) excl = identity;
  *aggregate = scratch[WARPS - 1];
  return op(wid ? scratch[wid - 1] : identity, excl);
}

}  // namespace td
