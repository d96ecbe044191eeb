// Encoder parse in tiles: K8 parse transfers and K9 parse replay.
//
// Replace tpu_deflate/codec/parse_pallas.py:_parse_b_kernel (called from
// parse_transfers) and _parse_d_kernel (called from parse_replay). Both read
// the steps position-major, steps (L, NT, 512) int32 (step = match run or
// 1, at most 250), which is the reference's (L, 512, NT) tile layout
// transposed.
//
// K8: out[l, t, e] (uint8) = (the position at which a walk entering tile t
// at offset e first reaches or passes 512) - 512, for e in 0..255.
// K9: out[l, 512 t + p] (bool) = the walk entering tile t at entries[l, t]
// visits p.
//
// The TPU kernels scan all 512 positions in lock step, moving every cursor
// that sits on the scan position (cur += step where cur == pos): the TPU
// has no gather. For steps >= 1 that is the serial walk cur += s[cur]; a
// step <= 0 freezes a lock-step cursor, so the walk stops after it.
//
// Bound on the H100: memory traffic, the steps read once (2 KiB a tile)
// and 256 bytes (K8) or 512 bytes (K9) written a tile; the walks are
// dependent shared-memory loads, about 512 / (mean step) of them per
// cursor. Design: one block per (lane, tile) stages the tile's steps in
// shared memory with coalesced loads. K8: thread e walks from e and
// stores its exit byte (neighbouring threads, neighbouring bytes). K9: one
// thread walks from the entry and marks flags in shared memory; the block
// then stores the 512 flags coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T_P = 512;
constexpr int E_P = 256;

__device__ __forceinline__ void load_steps(const int* __restrict__ steps, int* s) {
  const int* tile = steps + (size_t)blockIdx.x * T_P;  // blockIdx.x = lane * NT + t
  for (int i = threadIdx.x; i < T_P; i += blockDim.x) s[i] = tile[i];
}

__global__ void __launch_bounds__(E_P)
    parse_transfers_kernel(const int* __restrict__ steps, uint8_t* __restrict__ out) {
  __shared__ int s[T_P];
  load_steps(steps, s);
  __syncthreads();
  int cur = threadIdx.x;
  while (cur < T_P) {
    const int a = s[cur];
    cur += a;
    if (a <= 0) break;
  }
  out[(size_t)blockIdx.x * E_P + threadIdx.x] = (uint8_t)(cur - T_P);
}

__global__ void __launch_bounds__(E_P)
    parse_replay_kernel(const int* __restrict__ steps, const int* __restrict__ entries,
                        uint8_t* __restrict__ out) {
  __shared__ int s[T_P];
  __shared__ uint8_t flag[T_P];
  load_steps(steps, s);
  for (int i = threadIdx.x; i < T_P; i += blockDim.x) flag[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int cur = entries[blockIdx.x];
    while (cur >= 0 && cur < T_P) {
      flag[cur] = 1;
      const int a = s[cur];
      cur += a;
      if (a <= 0) break;
    }
  }
  __syncthreads();
  uint8_t* row = out + (size_t)blockIdx.x * T_P;
  for (int i = threadIdx.x; i < T_P; i += blockDim.x) row[i] = flag[i];
}

}  // namespace

extern "C" int td_parse_transfers(const void* steps, void* out, int L, int NT, void* stream) {
  parse_transfers_kernel<<<L * NT, E_P, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(steps), static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int td_parse_replay(const void* steps, const void* entries, void* out, int L, int NT,
                               void* stream) {
  parse_replay_kernel<<<L * NT, E_P, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(steps), static_cast<const int*>(entries),
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
