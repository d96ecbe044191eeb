// Level-2 compaction (K4, and K7 as its no-map mode).
//
// Replaces tpu_deflate/codec/decode_pallas.py:_compact_flat_kernel (called
// from _compact_flat_jit) and, with map_literals = 0,
// decode_pallas.py:_compact_any_kernel (called from _compact_any_jit).
// For every lane, the non-negative entries of tok (L, M) int32 move to the
// front in order, -1 fills the rest; in the flat mode each literal rank
// below 256 becomes its byte through the lane's 8 x 8-word bit planes
// (lit_planes (L, 64) int32: word b*8+w, bit j = bit b of rank 32w+j).
//
// Bound on the H100: memory traffic, one read and one write of 4 bytes
// per entry (M = NT * k1 per lane). One 1024-thread block per lane walked
// its lane in serial chunks of 1024 entries, each a load round trip and
// three barriers: 104 chunks on 4 SMs for the decode's 4 x 1024 wave.
// Here a lane is cut into segments of SEG entries, one 256-thread block
// each: SEG = 4096 (16 entries a thread), or 1024 (4 a thread) where the
// wave has fewer than SMALL_WAVE_BLOCKS segments of 4096, so that the
// 4-lane waves fill the card too. A thread holds groups of 4 consecutive
// entries, group g of the segment at entries 4g..4g+3 with g = k * 256 +
// thread, loaded as 16-byte vectors where the rows allow it (M % 4 == 0,
// tok 16-byte aligned), so each load instruction of a warp reads 512
// contiguous bytes. One block scan of the groups' valid counts (four
// 16-bit fields in one 64-bit word) ranks the valid entries inside the
// segment; the segment's first output slot, the count of valid entries in
// the lane's earlier segments, comes from a decoupled look-back
// (td_lookback.cuh, as K10's bits). Valid entries are staged in shared
// memory at their rank and stored contiguously. The -1 padding needs no
// lane total: the k-th invalid entry of the lane, counted in order, goes
// to M - 1 - k, so a segment whose earlier segments hold I invalid entries
// writes its n invalid ones to [M - I - n, M - I). Literal ranks map
// through a 256-byte rank -> byte table that each block builds once from
// the lane's 64 plane words: one shared-memory lookup per literal.
#include "td_common.cuh"
#include "td_lookback.cuh"

namespace {

using namespace td;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMALL_WAVE_BLOCKS = 4 * 132;  // below this many 4096-entry segments: 1024

__device__ __forceinline__ unsigned long long warp_incl64(unsigned long long v) {
  const int lid = threadIdx.x & 31;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned long long n = __shfl_up_sync(0xffffffffu, v, s);
    if (lid >= s) v += n;
  }
  return v;
}

__device__ __forceinline__ int field16(unsigned long long v, int k) {
  return (int)((v >> (16 * k)) & 0xFFFFu);
}

template <int PER, bool MAP>
__global__ void __launch_bounds__(THREADS)
    compact_kernel(const int* __restrict__ tok, const int* __restrict__ planes,
                   int* __restrict__ out, unsigned long long* __restrict__ status,
                   int* __restrict__ ticket, int M, int nseg, int vec) {
  constexpr int SEG = THREADS * PER;
  constexpr int GROUPS = PER / 4;
  static_assert(PER % 4 == 0 && GROUPS <= 4, "up to four groups of 4 entries a thread");
  __shared__ int stage[SEG];
  __shared__ uint32_t lp[64];
  __shared__ uint8_t table[256];
  __shared__ unsigned long long wsum[WARPS];
  __shared__ int s_ticket, s_start;
  const int tid = threadIdx.x;
  const int lid = tid & 31;
  const int wid = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int lane = s_ticket / nseg;
  const int seg = s_ticket - lane * nseg;
  const int seg0 = seg * SEG;
  const int seg_len = min(SEG, M - seg0);
  const int* x = tok + (size_t)lane * M + seg0;
  int* y = out + (size_t)lane * M;
  if (MAP && tid < 64) lp[tid] = (uint32_t)planes[lane * 64 + tid];

  // The thread's groups; entries past the lane's end read as -1 and are
  // not counted as invalid ones.
  int v[GROUPS][4];
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const int e = 4 * (k * THREADS + tid);
    if (vec && e + 4 <= seg_len) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(x + e));
      v[k][0] = q.x;
      v[k][1] = q.y;
      v[k][2] = q.z;
      v[k][3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[k][j] = e + j < seg_len ? __ldg(x + e + j) : -1;
    }
  }
  unsigned long long cnt = 0;
#pragma unroll
  for (int k = 0; k < GROUPS; ++k)
    cnt |= (unsigned long long)((v[k][0] >= 0) + (v[k][1] >= 0) + (v[k][2] >= 0) + (v[k][3] >= 0))
           << (16 * k);
  const unsigned long long incl = warp_incl64(cnt);
  if (lid == 31) wsum[wid] = incl;
  __syncthreads();  // warp totals and the plane words ready
  if (wid == 0) {
    const unsigned long long w = warp_incl64(lid < WARPS ? wsum[lid] : 0ull);
    if (lid < WARPS) wsum[lid] = w;
  }
  if (MAP) {  // rank tid -> its byte
    const int w = tid >> 5, lo5 = tid & 31;
    uint32_t byte = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) byte |= ((lp[b * 8 + w] >> lo5) & 1u) << b;
    table[tid] = (uint8_t)byte;
  }
  __syncthreads();  // block scan and table ready
  const unsigned long long tot = wsum[WARPS - 1];
  const unsigned long long excl = (wid ? wsum[wid - 1] : 0ull) + incl - cnt;
  int agg = 0;
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) agg += field16(tot, k);
  if (wid == 0) {
    const int start = look_back(status + (size_t)lane * nseg, seg, agg, 0);
    if (lid == 0) s_start = start;
  }
  int before = 0;  // valid entries of the segment's earlier groups
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    int r = before + field16(excl, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int t = v[k][j];
      if (t >= 0) {
        if (MAP && t < 256) t = table[t];
        stage[r++] = t;
      }
    }
    before += field16(tot, k);
  }
  __syncthreads();  // staged entries and the segment's first slot ready
  const int start = s_start;
  for (int i = tid; i < agg; i += THREADS) y[start + i] = stage[i];
  const int inv_before = seg0 - start;
  const int n_inv = seg_len - agg;
  int* pad = y + (M - inv_before - n_inv);
  for (int i = tid; i < n_inv; i += THREADS) pad[i] = -1;
}

template <int PER, bool MAP>
cudaError_t launch(const int* tok, const int* planes, int* out, unsigned long long* status, int L,
                   int M, int vec, cudaStream_t stream) {
  constexpr int SEG = THREADS * PER;
  const int nseg = (M + SEG - 1) / SEG;
  compact_kernel<PER, MAP><<<L * nseg, THREADS, 0, stream>>>(
      tok, planes, out, status, reinterpret_cast<int*>(status + (size_t)L * nseg), M, nseg, vec);
  return cudaGetLastError();
}

template <int PER, bool MAP>
int occupancy() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, compact_kernel<PER, MAP>, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// scratch: L * ceil(M / 1024) status words (uint64) then the ticket
// counter, all 0 (enough for either segment size).
extern "C" int td_compact(const void* tok, const void* planes, void* out, void* scratch, int L,
                          int M, int map_literals, void* stream) {
  const auto* t = static_cast<const int*>(tok);
  const auto* p = static_cast<const int*>(planes);
  auto* o = static_cast<int*>(out);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  const int vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(tok) % 16 == 0;
  const bool small = (long long)L * ((M + 4095) / 4096) < SMALL_WAVE_BLOCKS;
  if (map_literals)
    return (int)(small ? launch<4, true>(t, p, o, status, L, M, vec, s)
                       : launch<16, true>(t, p, o, status, L, M, vec, s));
  return (int)(small ? launch<4, false>(t, p, o, status, L, M, vec, s)
                     : launch<16, false>(t, p, o, status, L, M, vec, s));
}

// Resident blocks per SM of the four variants: 1024-entry segments with
// and without the map, then 4096-entry segments with and without it.
extern "C" int td_compact_occupancy(int* out) {
  out[0] = occupancy<4, true>();
  out[1] = occupancy<4, false>();
  out[2] = occupancy<16, true>();
  out[3] = occupancy<16, false>();
  return (int)cudaGetLastError();
}
