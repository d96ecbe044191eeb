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
// K8 (parse_transfers_kernel): the 256 walks of a tile end in a few common
// chains after a few tokens, so one walk per entry (a thread each) repeats
// the same dependent shared loads; with literal steps of 1 a tile costs
// tens of thousands of them. Instead each of
// the tile's 512 positions gets its first hop, p + s[p] inside the tile or a
// terminal that holds the exit byte (where p + s[p] >= 512, or where
// s[p] <= 0 stops the cursor: exit (p + s[p] - 512) & 0xFF), and nine
// rounds of pointer jumping, nxt[p] <- nxt[nxt[p]], with terminals as fixed
// points, carry every position to its exit (a chain has at most 512 hops).
// One warp per tile: each thread holds 16 positions in registers (four
// groups of 4, from one 16-byte load each), the hops live in 1 KiB of
// shared memory, __syncwarp orders the rounds, and a warp stops early once
// all its positions are terminal. Bound on the H100: memory traffic, the
// steps read once (2 KiB a tile) and 256 bytes written a tile; the rounds
// are ~9 x 16 dependent shared loads per thread.
//
// K9 (parse_replay_kernel): one thread walking the chain from the entry,
// a dependent shared load per token while the rest of the block waited,
// cost as much as the chain was long (512 links for a tile of literals).
// Instead K9 reuses K8's first hops and pointer jumping and adds a 512-byte
// mark array: the entry (if it lies in [0, 512)) is marked, and in round
// r, where v[p] is p's 2^r-th successor or a terminal, every marked
// position whose v[p] is not terminal marks v[p] before the jump. After
// round r the chain's first 2^(r+1) members are marked, and every mark is
// a successor of the entry, so nothing off the chain is ever marked; a
// mark that another thread makes during a round and this thread reads in
// the same round only adds true members. The warp stops once no marked
// position has a live hop: then the entry's 2^r-th successor has left the
// tile, so the chain has at most 2^r members and all are marked. One warp
// per tile, as K8. Bound on the H100: memory traffic, the steps read once
// (2 KiB a tile) and the 512 flags written; the rounds are at most 9 of ~16
// shared loads and stores per thread, whatever the chain's length. The hops
// are added unsigned (first_hop), so a step <= 0 stops the walk after its
// position and a step near 2^31 leaves the tile, as the lock-step
// reference's int32 cursor does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T_P = 512;
constexpr int E_P = 256;

constexpr uint32_t TERM = 0x8000;  // a terminal hop; its low byte is the exit
constexpr int ROUNDS = 9;          // ceil(log2(512))

// Position p's first hop: the next position, or a terminal.
__device__ __forceinline__ uint32_t first_hop(int p, int s) {
  return (s <= 0 || s >= T_P - p) ? TERM | (((unsigned)p + (unsigned)s) & 255u) : (uint32_t)(p + s);
}

// Thread lane's first hops of tile blockIdx.x, for positions 128 k + 4 lane
// + j (k, j in 0..3): four 16-byte loads (scalar loads for a misaligned
// base).
__device__ __forceinline__ void load_first_hops(const int* __restrict__ steps, int lane, uint32_t* v) {
  const int* st = steps + (size_t)blockIdx.x * T_P;
  const bool vec = (reinterpret_cast<uintptr_t>(steps) & 15) == 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = 128 * k + 4 * lane;
    const int4 q = vec ? *reinterpret_cast<const int4*>(st + p) : make_int4(st[p], st[p + 1], st[p + 2], st[p + 3]);
    v[4 * k] = first_hop(p, q.x);
    v[4 * k + 1] = first_hop(p + 1, q.y);
    v[4 * k + 2] = first_hop(p + 2, q.z);
    v[4 * k + 3] = first_hop(p + 3, q.w);
  }
}

// The hops v of thread lane's positions into the tile's hop table.
__device__ __forceinline__ void store_hops(uint16_t* nxt, int lane, const uint32_t* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<uint2*>(nxt + 128 * k + 4 * lane) =
        make_uint2(v[4 * k] | v[4 * k + 1] << 16, v[4 * k + 2] | v[4 * k + 3] << 16);
}

// steps (n_tiles, 512) -> out (n_tiles, 256). One warp per tile; thread
// lane holds positions 128 k + 4 lane + j (k, j in 0..3).
__global__ void __launch_bounds__(32)
    parse_transfers_kernel(const int* __restrict__ steps, uint8_t* __restrict__ out) {
  __shared__ __align__(8) uint16_t nxt[T_P];
  const int lane = threadIdx.x;
  uint32_t v[16];
  load_first_hops(steps, lane, v);
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    store_hops(nxt, lane, v);
    __syncwarp();
    bool live = false;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (!(v[i] & TERM)) {
        v[i] = nxt[v[i]];
        live |= !(v[i] & TERM);
      }
    }
    if (!__any_sync(0xffffffffu, live)) break;
    __syncwarp();  // every read of this round before the next round's stores
  }
  uint8_t* o = out + (size_t)blockIdx.x * E_P;
#pragma unroll
  for (int k = 0; k < 2; ++k)
    *reinterpret_cast<uint32_t*>(o + 128 * k + 4 * lane) = (v[4 * k] & 255u) | (v[4 * k + 1] & 255u) << 8 |
                                                            (v[4 * k + 2] & 255u) << 16 | (v[4 * k + 3] & 255u) << 24;
}

// steps (n_tiles, 512), entries (n_tiles) -> out (n_tiles, 512) flags. One
// warp per tile; thread lane holds positions 128 k + 4 lane + j as in K8.
__global__ void __launch_bounds__(32)
    parse_replay_kernel(const int* __restrict__ steps, const int* __restrict__ entries,
                        uint8_t* __restrict__ out) {
  __shared__ __align__(8) uint16_t nxt[T_P];
  __shared__ __align__(4) uint8_t mark[T_P];
  const int lane = threadIdx.x;
  uint32_t v[16];
  load_first_hops(steps, lane, v);
#pragma unroll
  for (int k = 0; k < 4; ++k) *reinterpret_cast<uint32_t*>(mark + 128 * k + 4 * lane) = 0u;
  const int entry = entries[blockIdx.x];
  __syncwarp();
  if (lane == 0 && (unsigned)entry < (unsigned)T_P) mark[entry] = 1;
  __syncwarp();
#pragma unroll 1
  for (int r = 0; r < ROUNDS; ++r) {
    bool live = false;  // a marked position whose hop is live: the chain goes on
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = *reinterpret_cast<const volatile uint32_t*>(mark + 128 * k + 4 * lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (((m >> (8 * j)) & 0xFFu) && !(v[4 * k + j] & TERM)) {
          mark[v[4 * k + j]] = 1;
          live = true;
        }
      }
    }
    if (!__any_sync(0xffffffffu, live)) break;  // every chain member is marked
    store_hops(nxt, lane, v);
    __syncwarp();  // this round's marks and hops before the jump and the next round
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (!(v[i] & TERM)) v[i] = nxt[v[i]];
    __syncwarp();  // every read of this round before the next round's stores
  }
  __syncwarp();
  uint8_t* o = out + (size_t)blockIdx.x * T_P;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<uint32_t*>(o + 128 * k + 4 * lane) =
        *reinterpret_cast<const uint32_t*>(mark + 128 * k + 4 * lane);
}

}  // namespace

extern "C" int td_parse_transfers(const void* steps, void* out, int L, int NT, void* stream) {
  parse_transfers_kernel<<<L * NT, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(steps), static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int td_parse_replay(const void* steps, const void* entries, void* out, int L, int NT,
                               void* stream) {
  parse_replay_kernel<<<L * NT, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(steps), static_cast<const int*>(entries),
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
