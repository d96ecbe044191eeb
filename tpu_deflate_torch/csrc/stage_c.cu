// Stage C: each tile's entry offset from the per-tile transfer maps.
//
// Replaces tpu_deflate/codec/decode_jax_v2.py:stage_c_entries (:654, an XLA
// program jitted into the reference's wave body). Input: K2's maps (L, NT,
// 48) uint8 and each lane's entry0 (L,) int32. With
// apply(m, v) = v >= 127 ? v : v < 48 ? m[max(v, 0)] : 255,
// entries[l, 0] = entry0[l], entries[l, t + 1] = apply(map[l, t],
// entries[l, t]) and final[l] = apply(map[l, NT - 1], entries[l, NT - 1]),
// written as uint8 (the low byte) and the entries also as int32, the form
// K3 takes. Exactly decode_kernels.stage_c_plain (a Hillis-Steele scan over
// int64 copies of the maps), sentinels included.
//
// The TPU version packs four map entries a word and composes maps across
// the tile axis in a log-depth scan, because the TPU has no cheap gather.
// Here a lookup is one shared-memory load, so a lane is one block and the
// scan is a chunked serial one: the block stages a window of up to WIN
// tiles' maps in shared memory (16-byte loads, each map byte read once),
// thread k composes the 48-entry maps of its chunk of C <= 4 neighbouring
// tiles into one map (48 independent lookups a tile, held in registers),
// one thread walks the window's chunk maps from the state carried in (at
// most 128 dependent lookups), and each thread then replays its own chunk
// from its chunk's entry, staging the entries for coalesced stores. Windows
// run in order, carrying the state, so any NT >= 1 takes the same 33 KiB of
// static shared memory. A composed chunk map answers apply() for the whole
// chunk: a state of 127 or more passes every tile, one of 48..126 becomes
// 255 at the chunk's first tile, and one below 48 is looked up.
//
// Bound on the H100: the maps, 48 bytes a tile read once (the decode's
// 256 x 384 wave: 4.7 MB, 1.4 us at 3.35 TB/s); the serial walk, ~128
// dependent shared loads a window, costs a few microseconds a lane and
// overlaps across the lanes of a wave.
#include "td_common.cuh"

namespace {

using td::E_WIN;
using td::SENT_EOB;
using td::SENT_ERR;

constexpr int THREADS = 128;
constexpr int WIN = 512;  // tiles a window
static_assert((E_WIN * WIN) % 16 == 0, "a window is whole 16-byte words");

__device__ __forceinline__ int apply(const uint8_t* m, int v) {
  return v >= SENT_EOB ? v : (v < E_WIN ? (int)m[v < 0 ? 0 : v] : SENT_ERR);
}

__global__ void __launch_bounds__(THREADS)
    stage_c_kernel(const uint8_t* __restrict__ maps_g, const int* __restrict__ entry0,
                   uint8_t* __restrict__ entries, int* __restrict__ entries32,
                   uint8_t* __restrict__ final_state, int NT, int vec) {
  __shared__ __align__(16) uint8_t maps[WIN * E_WIN];
  __shared__ uint8_t chunk_maps[THREADS * E_WIN];
  __shared__ int chunk_entry[THREADS];
  __shared__ int ent[WIN];
  __shared__ int carry;

  const int k = threadIdx.x;
  const size_t lane = blockIdx.x;
  const uint8_t* src_lane = maps_g + lane * NT * E_WIN;
  if (k == 0) carry = entry0[lane];

  for (int w0 = 0; w0 < NT; w0 += WIN) {
    const int nt = min(WIN, NT - w0);
    const int C = (nt + THREADS - 1) / THREADS;
    const int nchunks = (nt + C - 1) / C;
    const uint8_t* src = src_lane + (size_t)w0 * E_WIN;
    const int nbytes = nt * E_WIN;
    if (vec) {
      for (int i = k; i < nbytes / 16; i += THREADS)
        reinterpret_cast<uint4*>(maps)[i] = reinterpret_cast<const uint4*>(src)[i];
    } else {
      for (int i = k; i < nbytes; i += THREADS) maps[i] = src[i];
    }
    __syncthreads();  // the window's maps (and the carried state) are in place

    const int t0 = k * C;
    const int t1 = min(t0 + C, nt);
    if (k < nchunks) {
      int m[E_WIN];
#pragma unroll
      for (int e = 0; e < E_WIN; ++e) m[e] = maps[t0 * E_WIN + e];
      for (int t = t0 + 1; t < t1; ++t) {
        const uint8_t* mt = maps + t * E_WIN;
#pragma unroll
        for (int e = 0; e < E_WIN; ++e) m[e] = apply(mt, m[e]);
      }
#pragma unroll
      for (int e = 0; e < E_WIN; ++e) chunk_maps[k * E_WIN + e] = (uint8_t)m[e];
    }
    __syncthreads();

    if (k == 0) {
      int s = carry;
      for (int c = 0; c < nchunks; ++c) {
        chunk_entry[c] = s;
        s = apply(chunk_maps + c * E_WIN, s);
      }
      carry = s;
    }
    __syncthreads();

    if (k < nchunks) {
      int s = chunk_entry[k];
      for (int t = t0; t < t1; ++t) {
        ent[t] = s;
        s = apply(maps + t * E_WIN, s);
      }
    }
    __syncthreads();

    uint8_t* e8 = entries + lane * NT + w0;
    int* e32 = entries32 + lane * NT + w0;
    for (int i = k; i < nt; i += THREADS) {
      const int v = ent[i] & 0xFF;
      e8[i] = (uint8_t)v;
      e32[i] = v;
    }
    __syncthreads();  // the window's buffers are read before the next window
  }
  if (k == 0) final_state[lane] = (uint8_t)carry;
}

}  // namespace

extern "C" int td_stage_c(const void* maps, const void* entry0, void* entries, void* entries32, void* final_state,
                          int L, int NT, void* stream) {
  if (L < 1 || NT < 1) return (int)cudaErrorInvalidValue;
  const int vec = (reinterpret_cast<uintptr_t>(maps) & 15) == 0;
  stage_c_kernel<<<L, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(maps), static_cast<const int*>(entry0), static_cast<uint8_t*>(entries),
      static_cast<int*>(entries32), static_cast<uint8_t*>(final_state), NT, vec);
  return (int)cudaGetLastError();
}
