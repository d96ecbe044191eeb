// Block-wide inclusive scans of one int per thread, in thread order, for
// blocks of 1024 threads: a shuffle scan inside each warp, one warp scans
// the 32 warp totals in shared memory.
#pragma once

#include <cuda_runtime.h>

namespace td {

constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;

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

// Inclusive scan of v over the block; *aggregate gets the whole block's
// result. scratch: SCAN_WARPS ints of shared memory. Every thread of the
// block must call it (it synchronises the block).
template <class Op>
__device__ __forceinline__ int block_inclusive(int v, Op op, int identity, int* scratch,
                                               int* aggregate) {
  const int lid = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int incl = warp_inclusive(v, op);
  if (lid == 31) scratch[wid] = incl;
  __syncthreads();
  if (wid == 0) scratch[lid] = warp_inclusive(scratch[lid], op);
  __syncthreads();
  const int res = op(wid ? scratch[wid - 1] : identity, incl);
  *aggregate = scratch[SCAN_WARPS - 1];
  __syncthreads();  // scratch is free for the next call
  return res;
}

}  // namespace td
