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
// A valid token of rank r (valid tokens before it in its lane) that starts
// in tile t goes to slot r - off(t), where off(t) = base(t) - head(t): the
// rank of the tile's first token, less one where a straddler heads it. Every
// seam t * N_POS (t = 1..T) lies in exactly one token's output [s, e] with
// s < t * N_POS <= e, past the lane's total or in the token before tile t's
// first: that token has rank base(t) - 1. So one launch reads the tokens
// once and writes each output word once; its blocks take tickets, and the
// first ones place segments, the rest pad:
//
// Placing. Each lane is cut into segments of SEG tokens, a block each
// (lane-major tickets). A block stages its segment in shared memory, scans
// its runs and its valid tokens (one block scan of packed pairs), and gets
// both prefixes at once by a decoupled look-back over a pair packed in one
// 64-bit status word (td::look_back_pair: the bytes saturating at cap = T *
// N_POS + 1024, which keeps min(a + b, cap) associative and every start
// below T * N_POS exact, and the count). The crossing token of each seam in
// the segment publishes its tile's off in the lane's tile word (flag and
// value in one 64-bit word), from the prefixes alone, and writes the head
// (the straddler's second half) at slot 0. The segment opens in tile tf =
// prefix / N_POS, whose seam's crossing token lies in an earlier segment:
// the block waits for off(tf) from an earlier ticket, which publishes it
// without waiting on any tile itself, so the waits form no chain. After a
// barrier every valid token knows its slot: the block stages values and
// destinations by rank in shared memory and stores them coalesced. A
// thread whose tokens cross no seam (nearly all) takes a short path with
// one tile and one off. The crossing token of seam t + 1 publishes tile t's
// filled length n_t = min(N_POS, base(t + 1) - off(t)) in its fill word;
// the lane's last segment does so for the tile holding the lane's total and
// (0) for the tiles after it.
//
// Padding. The later tickets write -1 over [n_t, N_POS) of every tile, a
// chunk of PAD words each, lane, tile and chunk in order, each once its
// tile's fill word is published (by an earlier ticket, so the wait ends).
// They start as the placing blocks retire, so the padding, about half of
// the output on the decode's members, runs beside the placing's tail and
// spreads over the card. Designs tried (PERF.md, PR 19): a separate padding
// launch over a (chunk, tile, lane) grid; the block that ends a tile padding
// it itself (one SM's store rate); persistent blocks copying their next
// segment while placing one (the look-back then waits on segments that no
// block has started). The scratch comes in two halves that calls on a
// stream take in turn: a call finds its half zeroed and zeroes the other,
// which the call before it used, so no call needs a zero fill, a fence or a
// count of its blocks done.
//
// Bound on the H100: bytes, the tokens read once and the tiles written once
// (16 lanes x 193071 tokens at T = 16: 12.4 + 67.1 MB, 24 us at 3.35 TB/s).
// Scratch: twice 8 bytes a segment of SEG tokens and 16 bytes a tile.
#include <cstdint>

#include "td_lookback.cuh"
#include "td_scan.cuh"

#ifndef TD_SPLIT_STAMP
#define TD_SPLIT_STAMP(phase)
#endif

namespace {

constexpr int N_POS = 65536;
constexpr int MATCH = 1 << 26;
constexpr int FIELDS = 0x07FFFFFF;  // a match's flag, run and distance bits
constexpr unsigned long long COUNT = (1ull << 31) - 1;  // the count's bits of a packed pair
constexpr unsigned long long TILE_SET = 1ull << 32;  // a tile word's flag; off(t) in the low 32 bits

__device__ __forceinline__ int run_of(int x) { return x < 0 ? 0 : ((x & MATCH) ? (x >> 16) & 0x3FF : 1); }

// Shared-memory index of token i of a segment: one word of padding every
// 32, so that thread j reading its token j * PER + k (PER of 8, 16 or 32)
// hits a different bank from every other thread of its warp (16 j + k + j
// / 2 for PER = 16).
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// (bytes << 31 | count) pairs: bytes add saturating at cap, counts add.
struct PairPlus {
  unsigned long long cap;
  __device__ unsigned long long operator()(unsigned long long a, unsigned long long b) const {
    const unsigned long long bytes = (a >> 31) + (b >> 31);
    return (bytes < cap ? bytes : cap) << 31 | ((a & COUNT) + (b & COUNT));
  }
};

__device__ __forceinline__ unsigned sat(unsigned a, unsigned b, unsigned cap) {
  const unsigned s = a + b;
  return s < cap ? s : cap;
}

// Exclusive scan over the block of (bytes << 32 | count), one barrier pair:
// a thread's bytes and counts are small, so the two halves never carry
// into each other. *aggregate gets the block's sum.
template <int THREADS>
__device__ __forceinline__ unsigned long long block_exclusive_pair(unsigned long long v, unsigned long long* buf,
                                                                   unsigned long long* aggregate) {
  constexpr int WARPS = THREADS / 32;
  const int lid = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned long long incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long n = __shfl_up_sync(0xffffffffu, incl, d);
    if (lid >= d) incl += n;
  }
  if (lid == 31) buf[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    unsigned long long w = lid < WARPS ? buf[lid] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long n = __shfl_up_sync(0xffffffffu, w, d);
      if (lid >= d) w += n;
    }
    if (lid < WARPS) buf[lid] = w;
  }
  __syncthreads();
  *aggregate = buf[WARPS - 1];
  return (wid ? buf[wid - 1] : 0) + incl - v;
}

// Tile t's fill word: n_t + 1 once the token that ends tile t (or the
// lane's last segment) has its filled length n_t; 0 before.
__device__ __forceinline__ void publish_fill(unsigned long long* fill, int n) {
  atomicExch(fill, (unsigned long long)(n + 1));
}

// Copy segment seg of lane `lane` into stage (padded): 4-byte cp.async
// copies (rows need not be 16-byte aligned; no registers hold them), -1
// past the lane's K tokens; one commit group.
template <int THREADS, int PER>
__device__ __forceinline__ void load_segment(int* stage, const int* __restrict__ tok, int lane, int seg, int K) {
  constexpr int SEG = THREADS * PER;
  const int seg0 = seg * SEG;
  const int len = min(SEG, K - seg0);
  const int* x = tok + (size_t)lane * K + seg0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = k * THREADS + threadIdx.x;
    int* d = stage + padded(i);
    if (i < len)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(d)),
                   "l"(x + i)
                   : "memory");
    else
      *d = -1;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies.
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Segment seg of lane `lane` (ticket s_ticket), its tokens staged in stage
// (load_segment, waited for and behind a barrier): its valid tokens to
// their slots, the heads, the tile words of its seams and the fill words of
// the tiles it ends; stage and dst (PSEG ints each) are overwritten. See
// the file's head.
template <int THREADS, int PER, int ITEMS>
__device__ __forceinline__ void place_segment(int* stage, int* dst, int* __restrict__ out,
                                              unsigned long long* __restrict__ status,
                                              unsigned long long* __restrict__ tw,
                                              unsigned long long* __restrict__ fw, int lane, int seg, int T,
                                              int nseg, unsigned cap, int s_ticket) {
  constexpr int SEG = THREADS * PER;
  constexpr int MAX_TILES = SEG * 1023 / N_POS + 2;  // tiles a segment's tokens can start in
  __shared__ unsigned long long scan_buf[THREADS / 32];
  __shared__ int s_off[MAX_TILES];  // off(tf + i)
  __shared__ int s_count;
  __shared__ unsigned s_bytes;
  const int tid = threadIdx.x;
  TD_SPLIT_STAMP(0);
  int v[PER];
  int bytes = 0, count = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    v[k] = stage[padded(tid * PER + k)];
    bytes += run_of(v[k]);
    count += v[k] >= 0;
  }
  unsigned long long agg;  // the segment's bytes and count: at most SEG * 1023 and SEG, no saturation
  const unsigned long long ex = block_exclusive_pair<THREADS>((unsigned long long)bytes << 32 | (unsigned)count,
                                                              scan_buf, &agg);
  const int ex_bytes = (int)(ex >> 32), ex_count = (int)(uint32_t)ex;
  const int agg_bytes = (int)(agg >> 32), agg_count = (int)(uint32_t)agg;
  const unsigned TN = (unsigned)T * N_POS;
  TD_SPLIT_STAMP(1);
  if (tid < 32) {
    const unsigned long long p = td::look_back_pair<ITEMS>(
        status, seg, (unsigned long long)agg_bytes << 31 | (unsigned)agg_count, PairPlus{cap});
    if (tid == 0) {
      s_bytes = (unsigned)(p >> 31);
      s_count = (int)(p & COUNT);
    }
  }
  __syncthreads();
  TD_SPLIT_STAMP(2);
  const unsigned pb = s_bytes;
  const int pc = s_count;
  const unsigned tf = pb / N_POS;
  int* o = out + (size_t)lane * T * N_POS;
  // This thread's tokens start at s0 and end by s1; below T * N_POS and in
  // one tile, none crosses a seam (nearly every thread: a short path below).
  const unsigned s0 = sat(pb, ex_bytes, cap);
  const unsigned s1 = s0 + bytes;
  const bool inside = s1 < TN && s0 / N_POS == s1 / N_POS;

  // 1. The seams: each crossing token publishes its tile's off and head
  // (from the prefixes alone, so no tile waits on another), then the block
  // waits for off(tf).
  if (!inside) {
    unsigned s = s0;
    int r = pc + ex_count;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int run = run_of(v[k]);
      if (s < TN) {  // then s and e are exact
        const unsigned e = s + run;
        const unsigned c = (s / N_POS + 1) * N_POS;
        if (c <= e && c < TN) {  // this valid token of rank r crosses seam c, into tile t
          const int t = (int)(c / N_POS);
          const bool hd = e > c;
          const int off = r + 1 - hd;
          s_off[t - tf] = off;
          atomicExch(tw + t, TILE_SET | (uint32_t)off);
          if (hd) o[(size_t)t * N_POS] = MATCH | (int)(e - c) << 16 | (v[k] & 0xFFFF);
        }
      }
      s = sat(s, run, cap);
      r += v[k] >= 0;
    }
  }
  if (tid == 0) {
    int off = 0;  // tile 0 opens at the lane's first token
    if (pb < TN && tf > 0) {
      const volatile unsigned long long* w = tw + tf;
      unsigned long long word;
      for (unsigned spins = 0; ((word = *w) & TILE_SET) == 0; ++spins)
        if (spins > (1u << 28)) __trap();
      off = (int)(uint32_t)word;
    }
    s_off[0] = off;
  }
  __syncthreads();
  TD_SPLIT_STAMP(3);
  if (seg == nseg - 1) {  // the tile of the lane's total and the empty ones after it
    const unsigned total = sat(pb, agg_bytes, cap);
    if (total < TN) {
      const int tl = (int)(total / N_POS);
      if (tid == 0) publish_fill(fw + tl, min(N_POS, pc + agg_count - s_off[tl - tf]));
      for (int t = tl + 1 + tid; t < T; t += THREADS) publish_fill(fw + t, 0);
    }
  }

  // 2. Every valid token's value and destination, by rank; each crossing
  // token publishes the filled length of the tile it ends, n_t = min(N_POS,
  // base(t + 1) - off(t)).
  int r = ex_count;  // rank within the segment
  if (inside) {
    const int t = (int)(s0 / N_POS);
    const int base = t * N_POS + pc - s_off[t - tf];  // + r: the token's index in the lane's tiles
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int a = v[k];
      if (a >= 0) {
        stage[padded(r)] = (a & MATCH) ? a & FIELDS : a;
        dst[padded(r)] = base + r < (t + 1) * N_POS ? base + r : -1;
        ++r;
      }
    }
  } else {
    unsigned s = s0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int a = v[k];
      const int run = run_of(a);
      if (a >= 0) {
        int val = a, idx = -1;
        if (s < TN) {
          const int t = (int)(s / N_POS);
          const int off = s_off[t - tf];
          const unsigned e = s + run;
          const unsigned c = (unsigned)(t + 1) * N_POS;
          if (a & MATCH) val = c < e ? MATCH | (int)(c - s) << 16 | (a & 0xFFFF) : a & FIELDS;
          if (c <= e) publish_fill(fw + t, min(N_POS, pc + r + 1 - off));
          const int slot = pc + r - off;
          if (slot < N_POS) idx = t * N_POS + slot;
        }
        stage[padded(r)] = val;
        dst[padded(r)] = idx;
      }
      s = sat(s, run, cap);
      r += a >= 0;
    }
  }
  __syncthreads();
  TD_SPLIT_STAMP(4);
  for (int j = tid; j < agg_count; j += THREADS) {
    const int d = dst[padded(j)];
    if (d >= 0) o[d] = stage[padded(j)];
  }
  TD_SPLIT_STAMP(5);
}

// -1 over the words [max(n_t, lo), hi) of a tile, by the whole block, once
// its fill word is published (none: K = 0, n_t = 0): streaming 16-byte
// stores.
template <int THREADS>
__device__ __forceinline__ void pad_chunk(int* __restrict__ tile, const unsigned long long* __restrict__ fill,
                                          int lo, int hi, bool wait) {
  __shared__ int s_n;
  if (threadIdx.x == 0) {
    unsigned long long word = 1;  // n_t = 0
    if (wait) {
      // The fill word's segment has an earlier ticket, so it runs already
      // and publishes; a fault that kept it from doing so traps, not hangs.
      const volatile unsigned long long* w = fill;
      for (unsigned spins = 0; (word = *w) == 0; ++spins)
        if (spins > (1u << 28)) __trap();
    }
    s_n = (int)word - 1;
  }
  __syncthreads();
  lo = max(lo, s_n);
  if (lo >= hi) return;
  const int lo4 = (lo + 3) & ~3;
  if ((int)threadIdx.x < lo4 - lo) tile[lo + threadIdx.x] = -1;
  int4* t4 = reinterpret_cast<int4*>(tile);
  const int4 pad = make_int4(-1, -1, -1, -1);
  for (int j = lo4 / 4 + threadIdx.x; j < hi / 4; j += THREADS) __stcs(t4 + j, pad);
}

// tok (L, K) -> out (L, T, N_POS), every word once. Tickets 0 .. L * nseg
// - 1 place a segment each, the next L * T * (N_POS / PAD) pad a chunk of
// PAD words each (lane, tile, chunk order), each after its tile's fill
// word. scratch: L * nseg look-back words, L * T tile words, L * T fill
// words and the ticket, all 0 before the launch; other: the scratch of the
// call before on the stream, whose first `dirty` words the blocks put back
// to 0 (that call has ended). A segment is THREADS * PER tokens, PER
// consecutive ones a thread; a lane of the look-back reads ITEMS status
// words a round; MINB blocks an SM bound the registers. Dynamic shared
// memory: 2 * PSEG ints (the tokens, then the values; the destinations).
// TD_SPLIT_STAMP(phase) marks the ends of the placing phases for
// scripts/split_variants.cu's probe (nothing here).
template <int THREADS, int PER, int ITEMS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    split_kernel(const int* __restrict__ tok, int* __restrict__ out, unsigned long long* __restrict__ scratch,
                 unsigned long long* __restrict__ other, long long dirty, int L, int K, int T, int nseg,
                 unsigned cap) {
  constexpr int PAD = THREADS * 32;  // words a padding chunk: 8 16-byte stores a thread
  constexpr int PSEG = THREADS * PER + THREADS * PER / 32;
  constexpr int CHUNKS = N_POS / PAD;
  extern __shared__ int smem[];
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  const long long place = (long long)L * nseg;
  unsigned long long* tiles = scratch + place;
  unsigned long long* fills = tiles + (size_t)L * T;
  if (tid == 0) s_ticket = atomicAdd(reinterpret_cast<int*>(fills + (size_t)L * T), 1);
  for (long long i = (long long)blockIdx.x * THREADS + tid; i < dirty; i += (long long)gridDim.x * THREADS)
    other[i] = 0;
  __syncthreads();
  const int ticket = s_ticket;
  if (ticket < place) {
    const int lane = ticket / nseg, seg = ticket - lane * nseg;
    load_segment<THREADS, PER>(smem, tok, lane, seg, K);
    wait_copies();
    __syncthreads();
    place_segment<THREADS, PER, ITEMS>(smem, smem + PSEG, out, scratch + (size_t)lane * nseg,
                                       tiles + (size_t)lane * T, fills + (size_t)lane * T, lane, seg, T, nseg,
                                       cap, ticket);
  } else {
    const long long q = ticket - place;
    const long long tile = q / CHUNKS;  // lane * T + t
    const int chunk = (int)(q % CHUNKS);
    pad_chunk<THREADS>(out + tile * N_POS, fills + tile, chunk * PAD, (chunk + 1) * PAD, K > 0);
  }
}

// scratch: L * ceil(K / SEG) look-back words, L * T tile words, L * T fill
// words and the ticket (uint64), all 0; other: the scratch of the call
// before on the stream, of which the call puts `dirty` words back to 0. T *
// N_POS + 2^23 must stay below 2^31.
template <int THREADS, int PER, int ITEMS, int MINB>
int tile_split(const void* tok, void* out, void* scratch, void* other, long long dirty, int L, int K, int T,
               cudaStream_t s) {
  constexpr int SEG = THREADS * PER;
  constexpr int PAD = THREADS * 32;
  static_assert(THREADS % 32 == 0 && SEG * 1023 < (1 << 23) + 1, "a segment is whole warps, its bytes below 2^23");
  static_assert(N_POS % PAD == 0, "a tile is whole padding chunks");
  if (L < 1 || L > 65535 || K < 0 || T < 1 || (long long)T * N_POS + (1 << 23) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int nseg = (K + SEG - 1) / SEG;
  const long long tickets = (long long)L * nseg + (long long)L * T * (N_POS / PAD);
  if (tickets > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  constexpr int SMEM = 2 * (SEG + SEG / 32) * (int)sizeof(int);
  auto* kernel = split_kernel<THREADS, PER, ITEMS, MINB>;
  // The largest shared-memory carveout, so that the most blocks fit on an SM.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tickets, THREADS, SMEM, s>>>(static_cast<const int*>(tok), static_cast<int*>(out),
                                                 static_cast<unsigned long long*>(scratch),
                                                 static_cast<unsigned long long*>(other), dirty, L, K, T, nseg,
                                                 (unsigned)T * N_POS + 1024u);
  return (int)cudaGetLastError();
}

}  // namespace

// Segments of 4096 tokens (resolve.TILE_SPLIT_SEGMENT), 256 threads of 16,
// four blocks an SM, a look-back round of 128 segments: of the shapes
// scripts/split_variants.py times, the fastest on the decode's calls.
extern "C" int td_tile_split(const void* tok, void* out, void* scratch, void* other, long long dirty, int L, int K,
                             int T, void* stream) {
  return tile_split<256, 16, 4, 4>(tok, out, scratch, other, dirty, L, K, T, static_cast<cudaStream_t>(stream));
}
