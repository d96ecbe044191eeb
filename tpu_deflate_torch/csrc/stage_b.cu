// Stage B (K2): per-tile transfer maps.
//
// Replaces tpu_deflate/codec/decode_pallas.py:_stage_b_kernel (called from
// _stage_b_jit). For every 512-bit tile, cursor e starts at offset e
// (0..47) and follows the stage-A deltas; out[l, t, e] (uint8) is the exit
// offset into the next tile, or 127 (EOB) / 255 (error), exactly as the
// TPU kernel's lock-step walk followed by its (L, NT, 48) transpose. As in
// decode_kernels.stage_b_plain, a delta of 0 or less stops the cursor where
// it lands (exit 0) and a hop is added without wrapping.
//
// The TPU kernel moves all 48 cursors over all 512 positions in lock step.
// Here each position's exit is computed once, from the tile's last position
// down: exit(p) is exit(p + delta[p]) while the hop stays in the tile, else
// what the hop itself gives. Each delta is read once, but the exits form a
// chain through shared memory, a load and a store per position, each
// waiting for the one before, and that chain is slow however the code
// around it is arranged.
//
// Design: a block takes a strip of 32 neighbouring tiles of one lane, one
// thread per tile, so that a row of the (L, 512, NT) layout is one 128-byte
// load per warp and every delta comes from device memory once. The 512
// positions are cut into 4 segments of 128, one warp each, which shortens
// the chain to 128 links. Each warp streams its deltas through registers,
// 16 rows a chunk with the next chunk's loads in flight, and keeps the exits
// of its last 64 positions in a ring in shared memory, so a hop of 1..63
// (every delta stage A writes but the sentinels) is one load. The ring
// starts out holding what the 64 positions past the segment give: the exit
// offset k behind the last segment, a marker 256 + k ("lands on position k
// of the next segment") behind the others. A hop of 64 or more that stays
// in the tile walks the deltas forward from where it lands. After a
// barrier, warp 0 follows each entry's markers through the next segments'
// first 64 exits and writes the tile's 48 bytes.
//
// Bound on the H100: the deltas, 2 KiB a tile read once, on the decode's
// large waves (256 x 384 tiles: 201 MB); on its small waves (4 lanes) the
// chain of 128 links per warp.
#include "td_common.cuh"

namespace {

using namespace td;

constexpr int TB = 32;                // tiles per strip: a thread each
constexpr int SEG = 128;              // positions per warp
constexpr int NSEG = W_P / SEG;       // warps per block
constexpr int RING = 64;              // exits kept per tile and warp
constexpr int CH = 16;                // delta rows per chunk in registers
constexpr int MARK = 256;             // marker base: lands in the next segment

// The exit of a cursor at n >= 512 (a hop past the tile).
__device__ __forceinline__ int leave_exit(unsigned n) {
  return n >= (unsigned)ERR_ADV ? SENT_ERR : (n >= (unsigned)EOB_ADV ? SENT_EOB : (int)min(n - W_P, 255u));
}

// The exit of position n < 512, walking the deltas (dl: this tile's column).
__device__ __noinline__ int walk_exit(const int* __restrict__ dl, unsigned n, int NT) {
  for (;;) {
    const int a = dl[(size_t)n * NT];
    if (a == SENT_EOB || a == SENT_ERR) return a;
    if (a <= 0) return 0;
    const unsigned m = n + (unsigned)a;
    if (m >= (unsigned)W_P) return leave_exit(m);
    n = m;
  }
}

// delta (L, 512, NT) int32 -> out (L, NT, 48) uint8. Grid: (ceil(NT / 32),
// L); warp s takes positions 128 s .. 128 s + 127 of tile t0 + lane.
__global__ void __launch_bounds__(32 * NSEG) stage_b_kernel(const int* __restrict__ delta,
                                                             uint8_t* __restrict__ out, int NT) {
  __shared__ uint16_t ring[NSEG][RING][TB];  // [segment][position & 63][tile]
  const int lane = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;
  const int t0 = blockIdx.x * TB;
  const bool ok = t0 + lane < NT;
  const int* dl = delta + (size_t)blockIdx.y * W_P * NT + t0 + lane;
  uint16_t(*rg)[TB] = ring[s];
  const int seed = s == NSEG - 1 ? 0 : MARK;
#pragma unroll
  for (int k = 0; k < RING; ++k) rg[k][lane] = (uint16_t)(seed + k);
  const int p0 = s * SEG;
  int cur[CH], nxt[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    cur[k] = ok ? dl[(size_t)(p0 + SEG - CH + k) * NT] : 1;
    nxt[k] = 1;
  }
#pragma unroll 1
  for (int c = SEG / CH - 1; c >= 0; --c) {
    if (c > 0) {
#pragma unroll
      for (int k = 0; k < CH; ++k) nxt[k] = ok ? dl[(size_t)(p0 + (c - 1) * CH + k) * NT] : 1;
    }
#pragma unroll
    for (int k = CH - 1; k >= 0; --k) {
      const int p = p0 + c * CH + k;
      const int a = cur[k];
      const unsigned n = (unsigned)p + (unsigned)a;
      int v = rg[n & (RING - 1)][lane];
      if ((unsigned)a - 1u >= (unsigned)(RING - 1)) {  // not a hop of 1..63
        v = (a == SENT_EOB || a == SENT_ERR) ? a
            : a <= 0                         ? 0
            : n >= (unsigned)W_P             ? leave_exit(n)
                                             : walk_exit(dl, n, NT);
      }
      rg[p & (RING - 1)][lane] = (uint16_t)v;
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) cur[k] = nxt[k];
  }
  __syncthreads();
  if (s != 0 || !ok) return;
  uint8_t* o = out + ((size_t)blockIdx.y * NT + t0 + lane) * E_WIN;
#pragma unroll
  for (int q = 0; q < E_WIN / 16; ++q) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int v = ring[0][16 * q + 4 * k + b][lane];
#pragma unroll
        for (int g = 1; g < NSEG; ++g) {
          const int u = ring[g][(v - MARK) & (RING - 1)][lane];
          v = v >= MARK ? u : v;
        }
        word |= (uint32_t)v << (8 * b);
      }
      w[k] = word;
    }
    *reinterpret_cast<uint4*>(o + 16 * q) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

}  // namespace

extern "C" int td_stage_b(const void* delta, void* out, int L, int NT, void* stream) {
  dim3 blocks((NT + TB - 1) / TB, L);
  stage_b_kernel<<<blocks, 32 * NSEG, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(delta), static_cast<uint8_t*>(out), NT);
  return (int)cudaGetLastError();
}
