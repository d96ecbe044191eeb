// Sweep resolve (K6): per-position literal byte or source -> final bytes.
//
// Replaces tpu_deflate/codec/resolve_pallas.py:_sweep_kernel (called from
// _sweep_jit). tail (L, 32768) int32: the resolved history before the tile
// (the previous tile's last 32 KiB, zeros at a stream start); y0, src (L,
// 65536) int32 from expand (K5). y (L, 65536) int32 gets each position's
// byte: y0 where y0 >= 0, else the byte at src (src < 0 reads
// tail[src + 32768]). status (L, 8): row 0 the residue (positions left
// unresolved, y = 0 there), row 1 the rounds of pointer doubling summed
// over blocks (a diagnostic: the TPU kernel counts its own rounds).
//
// Bound on the H100: memory traffic, 4-byte reads of tail, y0 and src
// and a 4-byte write of y per position (about 0.92 MB per lane). Design:
// one block of 1024 threads per lane keeps the tail and the tile's
// resolved bytes in 96 KiB of shared memory and walks the tile in 64
// blocks of 1024 positions, in order. Every source points backwards and
// at most 32 KiB away, so when block b runs, everything before it is a
// final byte in shared memory: a position whose source lies before the
// block reads it in one step; sources inside the block resolve by pointer
// doubling (at most log2(1024) + 1 rounds). The TPU kernel does the same
// over 2 KiB blocks, but gathers through an int8 one-hot MXU product
// because it cannot gather; here a gather is a shared-memory load.
#include "td_common.cuh"

namespace {

constexpr int N_POS = 65536;
constexpr int TAIL = 32768;
constexpr int BLK = 1024;
constexpr int MAX_ROUNDS = 11;  // pointer doubling over a 1024-position block
constexpr int SMEM_BYTES = TAIL + N_POS;

__global__ void __launch_bounds__(BLK)
    sweep_kernel(const int* __restrict__ tail, const int* __restrict__ y0,
                 const int* __restrict__ src, int* __restrict__ y, int* __restrict__ status) {
  extern __shared__ uint8_t buf[];  // [tail | tile] resolved bytes
  __shared__ int state[BLK];        // >= 0: byte; < 0: -(1 + in-block index of the source)
  __shared__ int s_unres;
  const int t = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * N_POS;
  const int* tl = tail + (size_t)blockIdx.x * TAIL;
  for (int i = t; i < TAIL; i += BLK) buf[i] = (uint8_t)tl[i];
  if (t == 0) s_unres = 0;
  __syncthreads();

  int rounds = 0, unres = 0;
  for (int b0 = 0; b0 < N_POS; b0 += BLK) {
    const int p = b0 + t;
    const int v = y0[row + p];
    const int s = src[row + p];
    int st;
    if (v >= 0)
      st = v;
    else if (s >= -TAIL && s < b0)
      st = buf[TAIL + s];  // final: the tail or an earlier block
    else if (s >= b0 && s < p)
      st = -1 - (s - b0);
    else
      st = -1 - t;  // not a backward source: stays unresolved
    state[t] = st;
    int r = 0;
    while (r < MAX_ROUNDS && __syncthreads_or(state[t] < 0)) {
      const int cur = state[t];
      const int nxt = cur < 0 ? state[-1 - cur] : cur;
      __syncthreads();
      state[t] = nxt;  // a byte, or the source's own source (doubling)
      ++r;
    }
    __syncthreads();
    int out = state[t];
    if (out < 0) {
      out = 0;
      ++unres;
    }
    buf[TAIL + p] = (uint8_t)out;
    y[row + p] = out;
    rounds += r;
    __syncthreads();
  }
  if (unres) atomicAdd(&s_unres, unres);
  __syncthreads();
  if (t < 8) status[blockIdx.x * 8 + t] = t == 0 ? s_unres : (t == 1 ? rounds : 0);
}

}  // namespace

extern "C" int td_sweep(const void* tail, const void* y0, const void* src, void* y, void* status,
                        int L, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<<<L, BLK, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tail), static_cast<const int*>(y0), static_cast<const int*>(src),
      static_cast<int*>(y), static_cast<int*>(status));
  return (int)cudaGetLastError();
}
