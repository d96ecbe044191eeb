// The tile split: (L, K) int32 token streams -> (L, T, N_POS) int32 tiles.
//
// Replaces tpu_deflate/codec/resolve_pallas.py:split_tiles_device (:620, an
// XLA program jitted with static T: one lax.sort of the whole stream a
// tile). Exactly resolve.split_tiles_plain: a token is valid when >= 0
// (anywhere in the stream), its run is (x >> 16) & 0x3FF for a match
// (bit 26) and 1 otherwise, and its start is the sum of the runs before it.
// Tile t holds, from slot 0: the second half of the match that straddles
// the seam t * N_POS, if any (run end - cut, the same distance), then the
// valid tokens that start in t in stream order, a match as x & 0x07FFFFFF
// and the match that straddles out of t with run cut - start; -1 fills the
// rest. Tokens that start in tile T or later, and slots past N_POS (only
// runs of 0 reach them), are dropped.
//
// Every seam t * N_POS (t = 1..T) lies in exactly one token's output [s,
// e] with s < t * N_POS <= e, the token before the first one of tile t, or
// past the lane's total; tile 0 opens at token 0. So two launches:
//
// 1. split_scan_kernel: each lane cut into segments of SEG tokens, one
//    256-thread block each by an atomic ticket (lane-major). A block stages
//    its segment in shared memory, sums its runs (a block scan), and gets
//    the runs before the segment by a decoupled look-back (td_lookback.cuh)
//    whose sum saturates at cap = T * N_POS + 1024 (min(a + b, cap) stays
//    associative, and every start below T * N_POS is exact; a lane may pass
//    2^31 bytes). The token whose output crosses seam t writes, for tile t,
//    its first token index (its own index + 1), its second half (the head
//    of t, or -1 where it ends on the seam) and, for tile t - 1, its first
//    half (or -1): unique writes, no fill. The lane's last segment writes
//    the seams past the lane's total (first index K, no head).
// 2. split_fill_kernel: one 256-thread block a (lane, tile). It reads the
//    tile's token range [first[t], first[t + 1]), 2048 tokens a round (8 a
//    thread, consecutive threads on consecutive tokens), ranks the valid
//    ones by warp ballots and one scan of the 64 (item, warp) counts, and
//    stores each at its slot; the straddler out of the tile is the range's
//    last token. Then -1 from the last slot to N_POS, 16-byte stores. Each
//    output word is written once.
//
// Bound on the H100: bytes, the tokens read once and the tiles written once
// (16 lanes x 193071 tokens at T = 16: 12.4 + 67.1 MB, 24 us at 3.35 TB/s).
// Scratch: 8 bytes a segment of 4096 tokens and 12 bytes a tile.
#include <cstdint>

#include "td_lookback.cuh"
#include "td_scan.cuh"

namespace {

constexpr int N_POS = 65536;
constexpr int MATCH = 1 << 26;
constexpr int FIELDS = 0x07FFFFFF;  // a match's flag, run and distance bits
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;  // tokens a thread of the scan
constexpr int SEG = THREADS * PER;
constexpr int FILL_PER = 8;  // tokens a thread a round of the fill

__device__ __forceinline__ int run_of(int x) { return x < 0 ? 0 : ((x & MATCH) ? (x >> 16) & 0x3FF : 1); }

// Shared-memory index of token i of a segment: one word of padding every
// 32, so that thread j reading its token j * PER + k hits bank (16 j + k +
// j / 2) % 32, a different bank for every thread of a warp.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

struct SatPlus {
  unsigned cap;
  __device__ int operator()(int a, int b) const {
    const unsigned s = (unsigned)a + (unsigned)b;
    return (int)(s < cap ? s : cap);
  }
};

__global__ void __launch_bounds__(THREADS)
    split_scan_kernel(const int* __restrict__ tok, int* __restrict__ first, int* __restrict__ head,
                      int* __restrict__ tail, unsigned long long* __restrict__ status, int* __restrict__ ticket,
                      int K, int T, int nseg, unsigned cap) {
  __shared__ int stage[SEG + SEG / 32];
  __shared__ int scan_buf[WARPS];
  __shared__ int s_ticket, s_prefix;
  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int lane = s_ticket / nseg;
  const int seg = s_ticket - lane * nseg;
  const int seg0 = seg * SEG;
  const int len = min(SEG, K - seg0);
  const int* x = tok + (size_t)lane * K + seg0;
  for (int i = tid; i < SEG; i += THREADS) stage[padded(i)] = i < len ? __ldg(x + i) : -1;
  __syncthreads();
  int v[PER];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    v[k] = stage[padded(tid * PER + k)];
    sum += run_of(v[k]);
  }
  int agg;  // the segment's runs: at most 4096 * 1023, no saturation inside
  const int excl = td::block_exclusive<THREADS>(sum, td::Sum(), 0, scan_buf, &agg);
  const SatPlus sat{cap};
  if (tid < 32) {
    const int p = td::look_back(status + (size_t)lane * nseg, seg, agg, 0, sat);
    if (tid == 0) s_prefix = p;
  }
  __syncthreads();
  const unsigned prefix = (unsigned)s_prefix;
  const unsigned TN = (unsigned)T * N_POS;
  int* f = first + (size_t)lane * (T + 1);
  int* h = head + (size_t)lane * T;
  int* tl = tail + (size_t)lane * T;
  if (seg == 0 && tid == 0) {
    f[0] = 0;
    h[0] = -1;
  }
  unsigned s = (unsigned)sat((int)prefix, excl);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int r = run_of(v[k]);
    if (s < TN) {  // then s and e are exact
      const unsigned e = s + r;
      const unsigned c = (s / N_POS + 1) * N_POS;
      if (c <= e) {  // this token crosses seam c: it ends tile t - 1 and opens t
        const int t = (int)(c / N_POS);
        const int d = v[k] & 0xFFFF;
        f[t] = seg0 + tid * PER + k + 1;
        if (t < T) h[t] = e > c ? MATCH | (int)(e - c) << 16 | d : -1;
        tl[t - 1] = e > c ? MATCH | (int)(c - s) << 16 | d : -1;
      }
    }
    s = (unsigned)sat((int)s, r);
  }
  if (seg == nseg - 1) {  // the seams past the lane's total open empty tiles
    const unsigned total = (unsigned)sat((int)prefix, agg);
    for (long long t = total / N_POS + 1 + tid; t <= T; t += THREADS) {
      f[t] = K;
      if (t < T) h[t] = -1;
      tl[t - 1] = -1;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    split_fill_kernel(const int* __restrict__ tok, const int* __restrict__ first, const int* __restrict__ head,
                      const int* __restrict__ tail, int* __restrict__ out, int K, int T) {
  constexpr int ROUND = THREADS * FILL_PER;
  __shared__ int counts[FILL_PER * WARPS];
  __shared__ int s_total;
  const int tid = threadIdx.x;
  const int lid = tid & 31;
  const int wid = tid >> 5;
  const int t = blockIdx.x;
  const int lane = blockIdx.y;
  int lo = 0, hi = 0, hd = -1, straddler = -1;
  if (K > 0) {
    lo = first[(size_t)lane * (T + 1) + t];
    hi = first[(size_t)lane * (T + 1) + t + 1];
    hd = head[(size_t)lane * T + t];
    straddler = tail[(size_t)lane * T + t];
  }
  const int* x = tok + (size_t)lane * K;
  int* o = out + ((size_t)lane * T + t) * N_POS;
  if (tid == 0 && hd >= 0) o[0] = hd;
  const unsigned below = (1u << lid) - 1;
  int base = hd >= 0;
  for (int c = lo; c < hi && base < N_POS; c += ROUND) {
    int v[FILL_PER];
    unsigned m[FILL_PER];
#pragma unroll
    for (int k = 0; k < FILL_PER; ++k) {
      const int i = c + k * THREADS + tid;
      int a = i < hi ? __ldg(x + i) : -1;
      if (i == hi - 1 && straddler >= 0) a = straddler;
      else if (a >= 0 && (a & MATCH)) a &= FIELDS;
      v[k] = a;
      m[k] = __ballot_sync(0xffffffffu, a >= 0);
      if (lid == 0) counts[k * WARPS + wid] = __popc(m[k]);
    }
    __syncthreads();
    if (wid == 0) {  // exclusive scan of the (item, warp) counts, item-major: two a lane
      const int a0 = counts[2 * lid], a1 = counts[2 * lid + 1];
      const int incl = td::warp_inclusive(a0 + a1, td::Sum());
      counts[2 * lid] = incl - a0 - a1;
      counts[2 * lid + 1] = incl - a1;
      if (lid == 31) s_total = incl;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FILL_PER; ++k) {
      if (v[k] >= 0) {
        const int r = base + counts[k * WARPS + wid] + __popc(m[k] & below);
        if (r < N_POS) o[r] = v[k];
      }
    }
    base += s_total;
    __syncthreads();  // counts and s_total are rewritten by the next round
  }
  const int n = min(base, N_POS);
  const int n4 = (n + 3) & ~3;
  if (tid < n4 - n) o[n + tid] = -1;
  int4* o4 = reinterpret_cast<int4*>(o);
  const int4 pad = make_int4(-1, -1, -1, -1);
  for (int j = n4 / 4 + tid; j < N_POS / 4; j += THREADS) o4[j] = pad;
}

static_assert(FILL_PER * WARPS == 64, "the fill's count scan takes two counts a lane of one warp");

}  // namespace

// scratch: L * ceil(K / 4096) status words (uint64) then the ticket, all 0;
// meta: L * (3 T + 1) int32 (first indices (L, T + 1), heads (L, T), first
// halves of the straddlers (L, T)), written by the first launch. K = 0
// writes -1 tiles (no scan). T * N_POS + 2^23 must stay below 2^31.
extern "C" int td_tile_split(const void* tok, void* out, void* scratch, void* meta, int L, int K, int T,
                             void* stream) {
  if (L < 1 || L > 65535 || K < 0 || T < 1 || (long long)T * N_POS + (1 << 23) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int*>(tok);
  int* first = static_cast<int*>(meta);
  int* head = first + (size_t)L * (T + 1);
  int* tail = head + (size_t)L * T;
  if (K > 0) {
    const int nseg = (K + SEG - 1) / SEG;
    const long long blocks = (long long)L * nseg;
    if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
    auto* status = static_cast<unsigned long long*>(scratch);
    split_scan_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(t, first, head, tail, status,
                                                          reinterpret_cast<int*>(status + blocks), K, T, nseg,
                                                          (unsigned)T * N_POS + 1024u);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  split_fill_kernel<<<dim3(T, L), THREADS, 0, s>>>(t, first, head, tail, static_cast<int*>(out), K, T);
  return (int)cudaGetLastError();
}
