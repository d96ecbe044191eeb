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
//
// Pull mode (compact_pull_kernel, td_compact_pull) replaces the host
// route's packed token pull, tpu_deflate/codec/decode_jax_v2.py:1385
// _pack_tokens_jit, and with the map on folds it into K4's launch: one pass
// over K3's tokens does what K4 and then the pull did in two. It splits a
// lane's entries (L, M) int32 into the literals (0..255, mapped to bytes
// where the map is on) as bytes, front-compacted with 255 after them, the
// matches (>= 256) as int32, front-compacted with -1 after them, the order
// as a bitmap (L, ceil(M / 32)) int32, and each lane's literal count.
// Entries below 0 are in neither stream. With the map on the bitmap is that
// of the compacted lane: bit k of word w is 1 where its valid entry 32w + k
// is a literal (what the pull of K4's output gave); with the map off it is
// that of the input (bit k of word w: entry 32w + k), so on front-compacted
// tokens the no-map mode is the pull alone (decode_kernels.pack_tokens).
// Bound on the H100: memory traffic, 4 bytes read and 5 + 1/8 written per
// entry; K4 and the pull in turn moved 8 + 9 1/8. The segments, groups and
// loads are K4's; a segment's two counts travel as one 62-bit pair
// (literals in the low 31 bits, matches above) through td::look_back_pair,
// whose sum is also the segment's first slot in the compacted lane; the
// padding of each stream follows K4's rule from its end, stored 16 bytes at
// a time (a 255 byte and a -1 int are both all ones). The pull takes
// 4096-entry segments from PULL_SMALL_WAVE_BLOCKS of them a wave, half K4's
// rule: with 1024-entry ones the 64 x 26624 wave took 13.4 us on an H100
// at 700 W, with 4096-entry ones 8.6 (scripts/compact_pull_variants.py).
// Each block stages its literal flags in bitmap order (the valid rank with
// the map on, the entry with it off) and its warps build the words by
// ballots. With the map on a segment's bits start at its first slot, which
// no rule aligns to a word: a word inside the segment's range is stored
// plainly, and the words at its two ends, which neighbouring segments share
// (several where the segments between hold no valid entry), are
// atomicOr'ed into a bitmap that the C entry zeroes first with one
// cudaMemsetAsync (a memset node, not a kernel launch); zero words are not
// stored at all, and the bits past the lane's count stay 0. A scratch word
// with an arrival count would spare the memset (1/32 of the tokens' bytes)
// but needs every word's writers counted, including the segments that hold
// no valid entry: the memset is the simpler way and costs no launch. With
// the map off every word lies in one segment and is stored. The lane's last
// segment writes its literal count: into row 6 of K3's (7, L) vector on the
// host route. The status words come in two halves that calls on a stream
// take in turn, each call zeroing the half the call before it used, so a
// launch needs no fill.
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

namespace {

constexpr unsigned long long PAIR_COUNT = (1ull << 31) - 1;  // the literal count's bits of a pair

// The pull takes 4096-entry segments from this many a wave (K4 from
// SMALL_WAVE_BLOCKS): its blocks carry more than K4's before their first
// store (two scans, the flags, the ballots).
constexpr int PULL_SMALL_WAVE_BLOCKS = 2 * 132;

struct PairSum {
  __device__ unsigned long long operator()(unsigned long long a, unsigned long long b) const { return a + b; }
};

// Sets bytes [0, n) of p to 0xFF (the -1 and the 255 padding alike): the
// head up to a 16-byte boundary and the tail by single bytes, the rest by
// 16-byte stores.
__device__ __forceinline__ void fill_ones(uint8_t* p, int n, int tid) {
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
  const int nvec = (n - head) >> 4;
  if (tid < head) p[tid] = 0xFF;
  int4* q = reinterpret_cast<int4*>(p + head);
  for (int i = tid; i < nvec; i += THREADS) q[i] = make_int4(-1, -1, -1, -1);
  const int done = head + (nvec << 4);
  if (tid < n - done) p[done + tid] = 0xFF;
}

template <int PER, bool MAP>
__global__ void __launch_bounds__(THREADS)
    compact_pull_kernel(const int* __restrict__ tok, const int* __restrict__ planes, int* __restrict__ bitmap,
                        uint8_t* __restrict__ lit, int* __restrict__ match, int* __restrict__ nlit,
                        unsigned long long* __restrict__ status, int* __restrict__ ticket,
                        unsigned long long* __restrict__ other, long long dirty, int M, int Mw, int nseg, int vec) {
  constexpr int SEG = THREADS * PER;
  constexpr int GROUPS = PER / 4;
  static_assert(PER % 4 == 0 && GROUPS <= 4, "up to four groups of 4 entries a thread");
  __shared__ int stage_m[SEG];
  __shared__ uint8_t stage_l[SEG];
  __shared__ uint8_t stage_f[SEG];  // literal flags in bitmap order
  __shared__ uint32_t lp[64];
  __shared__ uint8_t table[256];
  __shared__ unsigned long long wsum_l[WARPS], wsum_m[WARPS];
  __shared__ int s_ticket;
  __shared__ unsigned long long s_before;
  const int tid = threadIdx.x;
  const int lid = tid & 31;
  const int wid = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  // The call before on this stream has ended: put its status words back to 0.
  for (long long i = (long long)blockIdx.x * THREADS + tid; i < dirty; i += (long long)gridDim.x * THREADS)
    other[i] = 0;
  __syncthreads();
  const int lane = s_ticket / nseg;
  const int seg = s_ticket - lane * nseg;
  const int seg0 = seg * SEG;
  const int seg_len = min(SEG, M - seg0);
  const int* x = tok + (size_t)lane * M + seg0;
  if (MAP && tid < 64) lp[tid] = (uint32_t)planes[lane * 64 + tid];

  // The thread's groups; entries past the lane's end read as -1.
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
  unsigned long long cnt_l = 0, cnt_m = 0;
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    int nl = 0, nm = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nl += v[k][j] >= 0 && v[k][j] < 256;
      nm += v[k][j] >= 256;
    }
    cnt_l |= (unsigned long long)nl << (16 * k);
    cnt_m |= (unsigned long long)nm << (16 * k);
  }
  const unsigned long long incl_l = warp_incl64(cnt_l);
  const unsigned long long incl_m = warp_incl64(cnt_m);
  if (lid == 31) {
    wsum_l[wid] = incl_l;
    wsum_m[wid] = incl_m;
  }
  __syncthreads();  // warp totals and the plane words ready
  if (wid == 0) {
    const unsigned long long a = warp_incl64(lid < WARPS ? wsum_l[lid] : 0ull);
    const unsigned long long b = warp_incl64(lid < WARPS ? wsum_m[lid] : 0ull);
    if (lid < WARPS) {
      wsum_l[lid] = a;
      wsum_m[lid] = b;
    }
  }
  if (MAP) {  // rank tid -> its byte
    const int w = tid >> 5, lo5 = tid & 31;
    uint32_t byte = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) byte |= ((lp[b * 8 + w] >> lo5) & 1u) << b;
    table[tid] = (uint8_t)byte;
  }
  __syncthreads();  // block scans and table ready
  const unsigned long long tot_l = wsum_l[WARPS - 1], tot_m = wsum_m[WARPS - 1];
  const unsigned long long ex_l = (wid ? wsum_l[wid - 1] : 0ull) + incl_l - cnt_l;
  const unsigned long long ex_m = (wid ? wsum_m[wid - 1] : 0ull) + incl_m - cnt_m;
  int agg_l = 0, agg_m = 0;
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    agg_l += field16(tot_l, k);
    agg_m += field16(tot_m, k);
  }
  if (wid == 0) {
    const unsigned long long p = look_back_pair<2>(status + (size_t)lane * nseg, seg,
                                                   (unsigned long long)agg_m << 31 | (unsigned)agg_l, PairSum{});
    if (lid == 0) s_before = p;
  }
  int before_l = 0, before_m = 0;  // entries of each stream in the segment's earlier groups
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    int rl = before_l + field16(ex_l, k), rm = before_m + field16(ex_m, k);
    const int e = 4 * (k * THREADS + tid);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = v[k][j];
      if (MAP) {
        if (t >= 256) {
          stage_f[rl + rm] = 0;
          stage_m[rm++] = t;
        } else if (t >= 0) {
          stage_f[rl + rm] = 1;
          stage_l[rl++] = table[t];
        }
      } else {
        if (t >= 256) stage_m[rm++] = t;
        else if (t >= 0) stage_l[rl++] = (uint8_t)t;
        if (e + j < seg_len) stage_f[e + j] = t >= 0 && t < 256;
      }
    }
    before_l += field16(tot_l, k);
    before_m += field16(tot_m, k);
  }
  __syncthreads();  // staged entries and the segment's first slots ready
  const int start_l = (int)(s_before & PAIR_COUNT), start_m = (int)(s_before >> 31);
  uint8_t* yl = lit + (size_t)lane * M;
  int* ym = match + (size_t)lane * M;
  for (int i = tid; i < agg_l; i += THREADS) yl[start_l + i] = stage_l[i];
  for (int i = tid; i < agg_m; i += THREADS) ym[start_m + i] = stage_m[i];
  // The k-th entry of the lane outside a stream goes to M - 1 - k of it.
  const int out_l = seg_len - agg_l, out_m = seg_len - agg_m;
  fill_ones(yl + (M - (seg0 - start_l) - out_l), out_l, tid);
  fill_ones(reinterpret_cast<uint8_t*>(ym + (M - (seg0 - start_m) - out_m)), 4 * out_m, tid);
  // The bitmap: the segment's flags cover positions [b0, b0 + bn) of the
  // lane; word w by one ballot of a warp.
  const int b0 = MAP ? start_l + start_m : seg0;
  const int bn = MAP ? agg_l + agg_m : seg_len;
  int* yb = bitmap + (size_t)lane * Mw;
  if (bn > 0) {
    for (int w = (b0 >> 5) + wid; w <= (b0 + bn - 1) >> 5; w += WARPS) {
      const int p = (w << 5) + lid - b0;
      const uint32_t word = __ballot_sync(0xffffffffu, p >= 0 && p < bn && stage_f[p]);
      if (lid == 0) {
        if (!MAP)
          yb[w] = (int)word;
        else if (word && (w << 5) >= b0 && (w << 5) + 32 <= b0 + bn)
          yb[w] = (int)word;  // the segment's own word
        else if (word)
          atomicOr(yb + w, (int)word);  // a word shared with a neighbouring segment
      }
    }
  }
  if (seg == nseg - 1 && tid == 0) nlit[lane] = start_l + agg_l;
}

template <int PER, bool MAP>
cudaError_t launch_pull(const int* tok, const int* planes, int* bitmap, uint8_t* lit, int* match, int* nlit,
                        unsigned long long* status, unsigned long long* other, long long dirty, int L, int M,
                        int vec, cudaStream_t stream) {
  constexpr int SEG = THREADS * PER;
  const int nseg = (M + SEG - 1) / SEG;
  compact_pull_kernel<PER, MAP><<<L * nseg, THREADS, 0, stream>>>(
      tok, planes, bitmap, lit, match, nlit, status, reinterpret_cast<int*>(status + (size_t)L * nseg), other,
      dirty, M, (M + 31) / 32, nseg, vec);
  return cudaGetLastError();
}

template <int PER, bool MAP>
int pull_occupancy() {
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, compact_pull_kernel<PER, MAP>, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// tok (L, M) int32, planes (L, 64) int32 or null (the map off) -> bitmap
// (L, ceil(M / 32)) int32, lit (L, M) uint8, match (L, M) int32, nlit (L,)
// int32 (any L contiguous int32: row 6 of K3's vector on the host route).
// scratch: L * ceil(M / 1024) status words (uint64) then the ticket
// counter, all 0; other: the scratch of the call before on the stream,
// whose first `dirty` words the blocks put back to 0. With the map on the
// bitmap is zeroed first (a memset on the stream).
extern "C" int td_compact_pull(const void* tok, const void* planes, void* bitmap, void* lit, void* match,
                               void* nlit, void* scratch, void* other, long long dirty, int L, int M, void* stream) {
  const auto* t = static_cast<const int*>(tok);
  const auto* p = static_cast<const int*>(planes);
  auto* b = static_cast<int*>(bitmap);
  auto* l = static_cast<uint8_t*>(lit);
  auto* m = static_cast<int*>(match);
  auto* n = static_cast<int*>(nlit);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* o = static_cast<unsigned long long*>(other);
  auto s = static_cast<cudaStream_t>(stream);
  const int vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(tok) % 16 == 0;
  const bool small = (long long)L * ((M + 4095) / 4096) < PULL_SMALL_WAVE_BLOCKS;
  if (p) {
    const cudaError_t err = cudaMemsetAsync(b, 0, (size_t)L * ((M + 31) / 32) * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    return (int)(small ? launch_pull<4, true>(t, p, b, l, m, n, status, o, dirty, L, M, vec, s)
                       : launch_pull<16, true>(t, p, b, l, m, n, status, o, dirty, L, M, vec, s));
  }
  return (int)(small ? launch_pull<4, false>(t, p, b, l, m, n, status, o, dirty, L, M, vec, s)
                     : launch_pull<16, false>(t, p, b, l, m, n, status, o, dirty, L, M, vec, s));
}

// Resident blocks per SM of the eight variants: the compaction's, then the
// pull's, each 1024-entry segments with and without the map, then
// 4096-entry segments with and without it.
extern "C" int td_compact_occupancy(int* out) {
  out[0] = occupancy<4, true>();
  out[1] = occupancy<4, false>();
  out[2] = occupancy<16, true>();
  out[3] = occupancy<16, false>();
  out[4] = pull_occupancy<4, true>();
  out[5] = pull_occupancy<4, false>();
  out[6] = pull_occupancy<16, true>();
  out[7] = pull_occupancy<16, false>();
  return (int)cudaGetLastError();
}
