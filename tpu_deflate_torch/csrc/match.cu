// The encoder's match finder: hash keys, same-hash chains, the per-family
// candidate compare, and the run and lazy selection.
//
// Replace the reference's jitted tpu_deflate/codec/encode_jax.py:_match_find
// (:144; one XLA program inside analyze_phase1 :465), with its bucket_best
// (:191) and suffix_runlen (:316), which the port ran as a chain of small
// eager PyTorch ops (~633 launches a 64-lane batch at effort 2, ~18,500 at
// effort 4). The reference evaluates its candidates in sorted space (a
// stable lax.sort groups each hash, :176-214) because dynamic gathers crawl
// on its backend; on Hopper a gather from shared memory is cheap, so the
// match finder follows zlib's head/prev chains instead, with no sort: one
// td_match_keys, one td_match_chain and one td_match_bucket for every hash
// family at once, then one td_match_select.
//
// td_match_keys (match_keys_kernel): h[f, l, i] (int32) = family f's 16-bit
// multiplicative hash of the zero-extended row's bytes i..i+3 (4-byte),
// i..i+2 (3-byte) or i..i+5 (6-byte), or -1 where i is not valid (i >=
// lengths[l], or i < hstart[l]). Every family is hashed from the same
// registers in one pass, so the row is read once for all of them. A warp
// takes 512 positions as four runs of 128, lane k positions 4k..4k+3 of
// each: one 4-byte load a run gives the lane its run's bytes, shuffles from
// lanes k + 1 and k + 2 (lanes 0 and 1 of the next run for the last two)
// give the 8 bytes the run's windows reach past it, each position's
// windows are funnel shifts of those three words, and each family's keys
// of a run leave as one 16-byte store, so a warp writes 512 contiguous
// bytes a store (streaming stores: evict first). A block (4096 positions of
// one row) reads lengths and hstart once. Where a row is not 4-byte aligned
// or S is not a multiple of 4, a lane gathers its 12 bytes one at a time
// (zeros past S) and stores its keys one at a time. Bound on the H100:
// bytes, the row read and each family's keys written once (1 + 4 F bytes a
// position). A run of 16 positions a thread, four 16-byte stores a family
// 64 bytes apart across the warp, took as long as a thread a position,
// ~2.5x the bound: the stores, not the loads, were the limit
// (scripts/keys_variants.py).
//
// td_match_chain (match_chain_kernel): prev[f, l, i] (uint16) = the
// distance back from i to the nearest earlier position of the same hash,
// or 0 where there is none within 32768 (and where h is -1). In a stably
// sorted row the k-th entry before i in its hash group is i's k-th nearest
// earlier same-hash position, so k hops along prev give the sorted-space
// candidates. One block a row (f, l) holds a head of every hash, the last
// position seen of it, and walks the row a chunk of CHAIN_CHUNK positions
// at a time. The chunk is first split stably by hash part (a hash's top
// four bits) into one list a part, by all the block's threads (a warp's
// same-part lanes from ballots on the part's bits, the counts scanned in
// shared memory); then warp w walks part w's list, 32 entries a step:
// __match_any_sync on the step's hashes gives each entry its predecessor
// inside the step (the highest peer lane below it) and the group's last
// lane, and the head gives the rest. The parts' hashes are disjoint, so the
// 16 warps walk at once without touching each other's heads. The links go
// to a stage in shared memory and leave coalesced once the chunk is walked.
// A 16-bit hash needs 65536 heads and the rows reach 98304 columns, so an
// int32 head table (256 KiB) would not fit a block; a head holds its
// position modulo 65536 (uint16, 128 KiB) and is decoded as the position
// ((p - head - 1) mod 65536) + 1 back from p, which is exact while every
// head lies less than 65536 behind p. So every CHAIN_EPOCH (16384)
// positions the block rewrites each head more than 32768 behind the
// epoch's start (of no use to any later position) to the sentinel e0 -
// 49152, which decodes to more than 32768 back for the whole epoch and is
// itself rewritten at the next epoch; the heads then span at most 49152 +
// 16383 < 65536 positions. Bound on the H100: bytes, the keys read and the
// links written once (6 bytes a position); the walk is serial within a
// part (a step's head read waits for the step before), so the time is the
// steps' latency: ~CHAIN_CHUNK / 16 / 32 steps a part a chunk on text, all
// of a chunk's steps in one part on a row of one hash. The peers and
// in-step predecessors of CHAIN_AHEAD steps are found before the first of
// their head reads, so only the reads and writes of the heads stay serial.
//
// td_match_bucket (match_bucket_kernel): for each family f and position i,
// the candidates are i's first K_f hops along prev, each 1..32768 back;
// each is compared byte by byte with position i, up to 4 nwords_f bytes of
// the row zero-extended past S, and the longest wins, ties to the nearer
// (the earlier hop). out[f, l, i] = cand + 1 | len << 32 (int64; 0 where
// no candidate matched). A block takes a tile of BUCKET_TILE positions of
// one lane and family, a thread a position at a time in position order,
// so the stores are coalesced and neighbouring threads' candidates lie
// near each other in repetitive text. The block stages what its hops and
// compares can reach in dynamic shared memory: the row's bytes from 32768
// before the tile to 80 past it (zeros past S) and the links of the same
// positions up to the tile's end (108 KiB, two blocks of 1024 threads an
// SM), so a hop is a shared-memory read and not an L2 round trip. The
// compare takes four bytes at a time (two aligned words and a funnel shift
// a side; the position's first word once for all its candidates). The hop
// loop stops at a link of 0, at the first candidate more than 32768 back
// (the hops go back in position), and once a candidate matched the whole
// cap (no later one can beat it); a compare of 0 bytes (a hash collision)
// is skipped. Bound on the H100: bytes, the row and each family's links
// read and results written once (1 + 10 F bytes a position); the work, up
// to K compares of up to 4 nwords bytes a position, depends on the data.
//
// td_match_select (match_select_kernel): a position's best of the families
// (the 3-byte one taken on the unclamped lengths, then clamped to limit =
// min(258, lengths - i), which is negative past the lane; the 6-byte one
// clamped before its compare), the RLE lanes at distances 1..4 (the suffix
// run length of data[j] == data[j - d], with j >= hstart + d where hstart is
// given, capped at 258, then at limit), the PARSE_MAX_STEP cap, the
// worthwhile-match filter, the lazy deferral (a match is deferred where the
// next position's filtered run is longer; the last column's neighbour is 0)
// and the history masks. One block takes 1024 positions of a lane: it
// stages the bytes the runs reach (1024 + 258 + the block's neighbour),
// builds each distance's equality bits with warp ballots, and reads a run
// length a word at a time from the bits (at most 10 word reads a run, where
// a byte walk took up to 258 compares); each position's filtered run goes
// to shared memory, so the lazy deferral reads its neighbour there, and the
// neighbour past the block's last position is computed by the block itself.
// Bound on the H100: bytes, ~30 a position at effort 2 (the row, two packed
// family results, use, dist, step and valid), 38 with the 6-byte family.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t HASH_MUL = 2654435761u;
constexpr uint32_t H6_MUL = 0x9E3779B1u;
constexpr int HASH_SHIFT = 16;  // 32 - HASH_BITS
constexpr int MAX_DIST = 32768;
constexpr int MAX_RUN = 258;
constexpr int PARSE_MAX_STEP = 250;
constexpr int FAR_DIST = 4096;  // a run of 3 farther back than this is not worth a token
constexpr int MAX_WORDS = 16;   // the widest compare, in 4-byte words

constexpr int KEY_THREADS = 256;
constexpr int KEY_RUNS = 4;                              // runs of 4 positions a thread, 128 apart
constexpr int KEY_WARP = 128 * KEY_RUNS;                 // positions a warp
constexpr int KEY_BLOCK = KEY_WARP * KEY_THREADS / 32;   // positions a block
constexpr int CHAIN_WALKERS = 16;                            // warps a block, one a hash part
constexpr int CHAIN_THREADS = 32 * CHAIN_WALKERS;
constexpr int CHAIN_PART_BITS = 4;                           // a hash's part: its top 4 bits
constexpr int CHAIN_CHUNK = 4096;                            // positions split and walked at a time
constexpr int CHAIN_PER = CHAIN_CHUNK / CHAIN_THREADS;       // a thread's keys a chunk
constexpr int CHAIN_AHEAD = 4;                               // steps whose peers come before their head reads
constexpr int CHAIN_EPOCH = 16384;                           // positions between two rewrites of the stale heads
constexpr int CHAIN_SENTINEL_BACK = 49152;                   // a stale head's position, before the epoch's start
constexpr int CHAIN_COUNTS = CHAIN_PER * CHAIN_WALKERS * CHAIN_WALKERS;  // [sub-step][warp][part]
constexpr int CHAIN_SMEM = 2 * 65536 + 4 * CHAIN_CHUNK + 4 * CHAIN_COUNTS + 4 * 32 + 2 * CHAIN_CHUNK;
constexpr int BUCKET_THREADS = 1024;  // two blocks an SM: 32 registers a thread
constexpr int BUCKET_TILE = 4096;                                 // positions a bucket block
constexpr int BUCKET_SPAN = MAX_DIST + BUCKET_TILE;               // positions a block stages
constexpr int BUCKET_DATA_BYTES = BUCKET_SPAN + 4 * MAX_WORDS + 16;  // and the bytes past its last
constexpr int BUCKET_SMEM = BUCKET_DATA_BYTES + 2 * BUCKET_SPAN;  // bytes, then uint16 links
constexpr int SEL_THREADS = 256;
constexpr int SEL_B = 1024;                                    // positions a select block
constexpr int SEL_PER = SEL_B / SEL_THREADS;                   // positions a thread
constexpr int SEL_WORDS = (SEL_B + 1 + MAX_RUN + 31) / 32 + 1; // equality words a distance
constexpr int SEL_STAGE = 4 + 32 * SEL_WORDS;                  // bytes from 4 before the block

__device__ __forceinline__ uint32_t byte_word(const uint8_t* row, int p, int S) {
  uint32_t x = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) x |= (p + b < S ? (uint32_t)row[p + b] : 0u) << (8 * b);
  return x;
}

// keys (F, L, S): grid (ceil(S / KEY_BLOCK), L); a warp takes KEY_WARP
// positions as KEY_RUNS runs of 128, lane k positions 4k..4k+3 of each;
// family f is bits 2f..2f+1 of codes; vec: the rows are 4-byte aligned and
// the keys' rows 16-byte aligned (S % 4 == 0).
__global__ void __launch_bounds__(KEY_THREADS)
    match_keys_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                      const int* __restrict__ hstart, int* __restrict__ keys, int S, int F, int codes, int vec) {
  __shared__ int s_len, s_hstart;
  const int l = blockIdx.y;
  if (threadIdx.x == 0) {
    s_len = lengths[l];
    s_hstart = hstart == nullptr ? 0 : hstart[l];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int wbase = blockIdx.x * KEY_BLOCK + (threadIdx.x >> 5) * KEY_WARP;
  const uint8_t* row = data + (size_t)l * S;
  int* out = keys + (size_t)l * S;
  const size_t plane = (size_t)gridDim.y * S;
  const int len = s_len, hs = s_hstart;
  uint32_t x[KEY_RUNS + 1];  // the lane's word of each run, then lanes 0 and 1 the two after the last
  if (vec) {
#pragma unroll
    for (int r = 0; r <= KEY_RUNS; ++r) {
      const int p = wbase + 128 * r + 4 * lane;
      x[r] = (r < KEY_RUNS || lane < 2) && p < S ? __ldg(reinterpret_cast<const uint32_t*>(row + p)) : 0u;
    }
  }
#pragma unroll
  for (int r = 0; r < KEY_RUNS; ++r) {
    const int i0 = wbase + 128 * r + 4 * lane;
    uint32_t w0, w1, w2;  // bytes i0..i0+3, i0+4..i0+7, i0+8..i0+11
    if (vec) {
      const uint32_t a1 = __shfl_down_sync(0xFFFFFFFFu, x[r], 1), b1 = __shfl_sync(0xFFFFFFFFu, x[r + 1], 0);
      const uint32_t a2 = __shfl_down_sync(0xFFFFFFFFu, x[r], 2);
      const uint32_t b2 = __shfl_sync(0xFFFFFFFFu, x[r + 1], (lane + 2) & 31);
      w0 = x[r];
      w1 = lane == 31 ? b1 : a1;
      w2 = lane >= 30 ? b2 : a2;
    } else {
      w0 = byte_word(row, i0, S);
      w1 = byte_word(row, i0 + 4, S);
      w2 = byte_word(row, i0 + 8, S);
    }
    for (int f = 0; f < F; ++f) {
      const int family = (codes >> (2 * f)) & 3;
      int h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a = __funnelshift_r(w0, w1, 8 * j);  // bytes i0+j..i0+j+3
        const uint32_t b = __funnelshift_r(w1, w2, 8 * j);  // bytes i0+j+4..i0+j+7
        const uint32_t y = family == 0 ? a : family == 1 ? (a & 0xFFFFFFu) : (a ^ ((b & 0xFFFFu) * H6_MUL));
        h[j] = i0 + j < len && i0 + j >= hs ? (int)((y * HASH_MUL) >> HASH_SHIFT) : -1;
      }
      int* o = out + f * plane + i0;
      if (vec) {
        if (i0 < S) __stcs(reinterpret_cast<int4*>(o), make_int4(h[0], h[1], h[2], h[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i0 + j < S) o[j] = h[j];
      }
    }
  }
}

// keys (F, L, S) -> prev (F, L, S): grid (L, F), CHAIN_SMEM bytes of
// dynamic shared memory: the heads (uint16 [65536]), the parts' lists
// (hash | offset in the chunk << 16), the counts, each part's total and
// the links' stage.
__global__ void __launch_bounds__(CHAIN_THREADS)
    match_chain_kernel(const int* __restrict__ keys, uint16_t* __restrict__ prev, int S) {
  extern __shared__ uint4 chain_smem[];
  uint32_t* head2 = reinterpret_cast<uint32_t*>(chain_smem);  // two heads a word
  uint16_t* head = reinterpret_cast<uint16_t*>(chain_smem);
  uint32_t* list = head2 + 32768;
  int* cnt = reinterpret_cast<int*>(list + CHAIN_CHUNK);
  int* total = cnt + CHAIN_COUNTS;
  uint16_t* stage = reinterpret_cast<uint16_t*>(total + 32);
  const size_t row = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * S;
  const int* kr = keys + row;
  uint16_t* pr = prev + row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int hk[CHAIN_PER];  // position c0 + threadIdx.x + CHAIN_THREADS j
#pragma unroll
  for (int j = 0; j < CHAIN_PER; ++j) {
    const int p = threadIdx.x + CHAIN_THREADS * j;
    hk[j] = p < S ? __ldg(kr + p) : -1;
  }
  for (int c0 = 0; c0 < S; c0 += CHAIN_CHUNK) {
    if (c0 % CHAIN_EPOCH == 0) {
      // Each head more than MAX_DIST behind c0 (all of them at 0) becomes
      // the sentinel c0 - CHAIN_SENTINEL_BACK, mod 65536.
      const uint32_t sentinel = (uint32_t)(c0 - CHAIN_SENTINEL_BACK) & 0xFFFFu;
      for (int j = threadIdx.x; j < 32768; j += CHAIN_THREADS) {
        const uint32_t two = head2[j];
        uint32_t lo = two & 0xFFFFu, hi = two >> 16;
        if (c0 == 0 || (int)(((uint32_t)c0 - lo - 1u) & 0xFFFFu) + 1 > MAX_DIST) lo = sentinel;
        if (c0 == 0 || (int)(((uint32_t)c0 - hi - 1u) & 0xFFFFu) + 1 > MAX_DIST) hi = sentinel;
        head2[j] = lo | hi << 16;
      }
    }
    // The split: each warp's same-part lanes a sub-step, and the count of
    // each part's keys a (sub-step, warp), lane k counting part k.
    unsigned same[CHAIN_PER];
#pragma unroll
    for (int j = 0; j < CHAIN_PER; ++j) {
      const int h = hk[j];
      const int part = h >= 0 ? h >> (16 - CHAIN_PART_BITS) : 0;
      const unsigned valid = __ballot_sync(0xFFFFFFFFu, h >= 0);
      unsigned mine = valid, counted = valid;  // lanes of my part; of part `lane`
#pragma unroll
      for (int b = 0; b < CHAIN_PART_BITS; ++b) {
        const unsigned bits = __ballot_sync(0xFFFFFFFFu, (part >> b) & 1);
        mine &= ((part >> b) & 1) ? bits : ~bits;
        counted &= ((lane >> b) & 1) ? bits : ~bits;
      }
      same[j] = mine;
      if (lane < CHAIN_WALKERS) cnt[(j * CHAIN_WALKERS + warp) * CHAIN_WALKERS + lane] = __popc(counted);
    }
    __syncthreads();
    {  // warp k: part k's counts -> exclusive offsets in (sub-step, warp) order
      int run = 0;
      for (int i0 = 0; i0 < CHAIN_PER * CHAIN_WALKERS; i0 += 32) {
        const int i = i0 + lane;
        const int v = i < CHAIN_PER * CHAIN_WALKERS ? cnt[i * CHAIN_WALKERS + warp] : 0;
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
          if (lane >= d) incl += t;
        }
        if (i < CHAIN_PER * CHAIN_WALKERS) cnt[i * CHAIN_WALKERS + warp] = run + incl - v;
        run += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      if (lane == 0) total[warp] = run;
    }
    __syncthreads();
    int start[CHAIN_WALKERS + 1];  // each part's list in `list`
    start[0] = 0;
#pragma unroll
    for (int k = 0; k < CHAIN_WALKERS; ++k) start[k + 1] = start[k] + total[k];
#pragma unroll
    for (int j = 0; j < CHAIN_PER; ++j) {
      const int h = hk[j];
      const int off = threadIdx.x + CHAIN_THREADS * j;
      if (h >= 0) {
        const int part = h >> (16 - CHAIN_PART_BITS);
        int at = cnt[(j * CHAIN_WALKERS + warp) * CHAIN_WALKERS + part] + __popc(same[j] & lower);
#pragma unroll
        for (int k = 0; k < CHAIN_WALKERS; ++k) at += k == part ? start[k] : 0;
        list[at] = (uint32_t)h | (uint32_t)off << 16;
      } else {
        stage[off] = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CHAIN_PER; ++j) {  // the next chunk's keys, loaded during the walk
      const int p = c0 + CHAIN_CHUNK + threadIdx.x + CHAIN_THREADS * j;
      hk[j] = p < S ? __ldg(kr + p) : -1;
    }
    int b0 = 0;
#pragma unroll
    for (int k = 0; k < CHAIN_WALKERS; ++k) b0 += k == warp ? start[k] : 0;
    const int n = total[warp];
    for (int s0 = 0; s0 < n; s0 += 32 * CHAIN_AHEAD) {
      // CHAIN_AHEAD steps' entries, peers and in-step predecessors first
      // (none waits on a head), then their head reads and writes in order.
      int h[CHAIN_AHEAD], q[CHAIN_AHEAD], qp[CHAIN_AHEAD];
      unsigned peers[CHAIN_AHEAD];
#pragma unroll
      for (int a = 0; a < CHAIN_AHEAD; ++a) {
        const int i = s0 + 32 * a + lane;
        const uint32_t e = i < n ? list[b0 + i] : 0u;
        h[a] = i < n ? (int)(e & 0xFFFFu) : -1;
        q[a] = c0 + (int)(e >> 16);
      }
#pragma unroll
      for (int a = 0; a < CHAIN_AHEAD; ++a) {
        peers[a] = __match_any_sync(0xFFFFFFFFu, h[a]);
        const unsigned below = peers[a] & lower;
        qp[a] = __shfl_sync(0xFFFFFFFFu, q[a], below ? 31 - __clz(below) : lane);
      }
#pragma unroll
      for (int a = 0; a < CHAIN_AHEAD; ++a) {
        const bool act = h[a] >= 0;
        int d = 0;
        if (act) {
          if (peers[a] & lower) {
            d = q[a] - qp[a];
          } else {
            const int back = (int)(((uint32_t)q[a] - head[h[a]] - 1u) & 0xFFFFu) + 1;
            d = back <= MAX_DIST ? back : 0;
          }
        }
        __syncwarp();
        if (act && (peers[a] >> lane) == 1u) head[h[a]] = (uint16_t)q[a];  // the group's last position
        __syncwarp();
        if (act) stage[q[a] - c0] = (uint16_t)d;
      }
    }
    __syncthreads();
    const int m = min(CHAIN_CHUNK, S - c0);
    if ((m & 7) == 0 && (reinterpret_cast<uintptr_t>(pr + c0) & 15) == 0) {
      for (int j = threadIdx.x; j < m / 8; j += CHAIN_THREADS)
        reinterpret_cast<uint4*>(pr + c0)[j] = reinterpret_cast<const uint4*>(stage)[j];
    } else {
      for (int j = threadIdx.x; j < m; j += CHAIN_THREADS) pr[c0 + j] = stage[j];
    }
  }
}

// Equal leading bytes (0..4 nwords) of the zero-extended row at a and b;
// a0 is the word at a (the same for every candidate of a position).
__device__ __forceinline__ int prefix_len(const uint32_t* row, uint32_t a0, int a, int b, int nwords) {
  const uint32_t* pa = row + (a >> 2);
  const uint32_t* pb = row + (b >> 2);
  const int sa = (a & 3) * 8, sb = (b & 3) * 8;
  uint32_t blo = pb[0], bhi = pb[1];
  const uint32_t x0 = a0 ^ __funnelshift_r(blo, bhi, sb);
  if (x0) return (__ffs(x0) - 1) >> 3;
  uint32_t alo = pa[1];
  blo = bhi;
  for (int w = 1; w < nwords; ++w) {
    const uint32_t ahi = pa[w + 1], bhi = pb[w + 1];
    const uint32_t x = __funnelshift_r(alo, ahi, sa) ^ __funnelshift_r(blo, bhi, sb);
    if (x) return 4 * w + ((__ffs(x) - 1) >> 3);
    alo = ahi;
    blo = bhi;
  }
  return 4 * nwords;
}

// prev (F, L, S) links, data (L, S) -> out (F, L, S) in position order: grid
// (ceil(S / BUCKET_TILE), L, F); family f's K and nwords are bits 8f..8f+7
// of ks and ws. The block stages positions [w0, t1) of its lane and family,
// w0 = max(0, t0 - MAX_DIST): their bytes (and the bytes up to
// BUCKET_DATA_BYTES past w0's window end, zeros past S) and their links.
__global__ void __launch_bounds__(BUCKET_THREADS, 2)
    match_bucket_kernel(const uint16_t* __restrict__ prev, const uint8_t* __restrict__ data,
                        int64_t* __restrict__ out, int L, int S, int ks, int ws) {
  extern __shared__ uint4 bucket_smem[];
  uint8_t* win = reinterpret_cast<uint8_t*>(bucket_smem);
  uint16_t* links = reinterpret_cast<uint16_t*>(win + BUCKET_DATA_BYTES);
  const int f = blockIdx.z, l = blockIdx.y;
  const int t0 = blockIdx.x * BUCKET_TILE;
  const int t1 = min(S, t0 + BUCKET_TILE);
  const int w0 = max(0, t0 - MAX_DIST);
  const int K = (ks >> (8 * f)) & 255;
  const int nwords = (ws >> (8 * f)) & 255;
  const uint8_t* src = data + (size_t)l * S;
  const size_t at = ((size_t)f * L + l) * S;
  const uint16_t* pr = prev + at;

  // Bytes [w0, w0 + nb), nb a multiple of 16 (zeros past S).
  const int nb = (t1 - w0 + 4 * MAX_WORDS + 4 + 15) & ~15;
  const bool bytes16 = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int j = threadIdx.x; j < nb / 16; j += BUCKET_THREADS) {
    const int g = w0 + 16 * j;
    if (bytes16 && g + 16 <= S) {
      bucket_smem[j] = *reinterpret_cast<const uint4*>(src + g);
    } else {
      for (int b = 0; b < 16; ++b) win[16 * j + b] = g + b < S ? src[g + b] : 0;
    }
  }
  // Links [w0, t1).
  const int nl = t1 - w0;
  if ((reinterpret_cast<uintptr_t>(pr + w0) & 15) == 0 && (nl & 7) == 0) {
    const uint4* s8 = reinterpret_cast<const uint4*>(pr + w0);
    uint4* d8 = reinterpret_cast<uint4*>(links);
    for (int j = threadIdx.x; j < nl / 8; j += BUCKET_THREADS) d8[j] = s8[j];
  } else {
    for (int j = threadIdx.x; j < nl; j += BUCKET_THREADS) links[j] = pr[w0 + j];
  }
  __syncthreads();

  const uint32_t* row = reinterpret_cast<const uint32_t*>(win);
  const int cap = 4 * nwords;
  for (int p = t0 + threadIdx.x; p < t1; p += BUCKET_THREADS) {
    const int a = p - w0;
    const uint32_t a0 = __funnelshift_r(row[a >> 2], row[(a >> 2) + 1], (a & 3) * 8);
    int blen = 0, bcand = -1, c = p;
    for (int k = 0; k < K; ++k) {
      const int d = links[c - w0];
      if (d == 0) break;  // no earlier position of the hash within reach
      c -= d;
      if (p - c > MAX_DIST) break;  // every later hop is farther
      const int lc = prefix_len(row, a0, a, c - w0, nwords);
      if (lc > blen) {
        blen = lc;
        bcand = c;
        if (blen == cap) break;
      }
    }
    out[at + p] = blen > 0 ? ((int64_t)(bcand + 1) | (int64_t)blen << 32) : 0;
  }
}

struct Best {
  int len, dist;
};

// A family's packed result at position p -> (length, distance; 0 without a
// candidate).
__device__ __forceinline__ Best unpack(const int64_t* q, size_t at, int p) {
  const int64_t v = q[at];
  const int64_t cand = (v & 0xFFFFFFFFll) - 1;
  return {(int)(v >> 32), cand >= 0 ? (int)(p - cand) : 0};
}

// Length of the run of set bits from bit r of bits, capped at MAX_RUN.
__device__ __forceinline__ int run_length(const uint32_t* bits, int r) {
  int w = r >> 5;
  uint32_t cur = bits[w] >> (r & 31);
  int avail = 32 - (r & 31);
  int run = 0;
  while (true) {
    const uint32_t miss = ~cur & (avail == 32 ? 0xFFFFFFFFu : (1u << avail) - 1u);
    if (miss) return min(run + __ffs(miss) - 1, MAX_RUN);
    run += avail;
    if (run >= MAX_RUN) return MAX_RUN;
    cur = bits[++w];
    avail = 32;
  }
}

// (L, S) -> use, dist, step (int32), valid (bool): grid (ceil(S / SEL_B), L).
// q6, hist and hstart may be null.
__global__ void __launch_bounds__(SEL_THREADS)
    match_select_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                        const int64_t* __restrict__ q4, const int64_t* __restrict__ q3,
                        const int64_t* __restrict__ q6, const int* __restrict__ hist,
                        const int* __restrict__ hstart, int* __restrict__ use_out,
                        int* __restrict__ dist_out, int* __restrict__ step_out,
                        bool* __restrict__ valid_out, int S, int lazy) {
  __shared__ uint8_t stage[SEL_STAGE];
  __shared__ uint32_t eq[4][SEL_WORDS];
  __shared__ int use_s[SEL_B + 1];
  const int l = blockIdx.y;
  const int b0 = blockIdx.x * SEL_B;
  const int t = threadIdx.x;
  const uint8_t* row = data + (size_t)l * S;
  const int len = lengths[l];
  const int hs = hstart ? hstart[l] : 0;

  // stage[k] = row[b0 - 4 + k] (0 outside the row; never compared there).
  for (int k = t; k < SEL_STAGE; k += SEL_THREADS) {
    const int j = b0 - 4 + k;
    stage[k] = (j >= 0 && j < S) ? row[j] : 0;
  }
  __syncthreads();
  // Bit k of eq[d - 1][w]: position j = b0 + 32 w + k equals the byte d back.
  const int lane = t & 31;
  for (int w = t >> 5; w < SEL_WORDS; w += SEL_THREADS / 32) {
    const int j = b0 + 32 * w + lane;
    const int k = 4 + 32 * w + lane;
#pragma unroll
    for (int d = 1; d <= 4; ++d) {
      const bool e = j < S && j >= d && stage[k] == stage[k - d] && (hstart == nullptr || j >= hs + d);
      const uint32_t bits = __ballot_sync(0xFFFFFFFFu, e);
      if (lane == 0) eq[d - 1][w] = bits;
    }
  }
  __syncthreads();

  // Each position's filtered run and distance, before the lazy deferral.
  auto pick = [&](int p, int& dist) -> int {
    const size_t at = (size_t)l * S + p;
    const int limit = min(MAX_RUN, len - p);
    const Best a = unpack(q4, at, p), b = unpack(q3, at, p);
    const bool take3 = b.len > a.len || (b.len == a.len && b.len > 0 && b.dist < a.dist);
    int run = min(take3 ? b.len : a.len, limit);
    dist = take3 ? b.dist : a.dist;
    if (q6) {
      Best c = unpack(q6, at, p);
      c.len = min(c.len, limit);
      if (c.len > run || (c.len == run && c.len > 0 && c.dist < dist)) {
        run = c.len;
        dist = c.dist;
      }
    }
    int rle_run = 0, rle_dist = 0;
#pragma unroll
    for (int d = 1; d <= 4; ++d) {
      const int rl = min(run_length(eq[d - 1], p - b0), limit);
      if (rl > rle_run) {
        rle_run = rl;
        rle_dist = d;
      }
    }
    if (rle_run >= 3 && (rle_run > run || (rle_run == run && rle_dist < dist))) {
      run = rle_run;
      dist = rle_dist;
    }
    run = min(run, PARSE_MAX_STEP);
    const bool good = run >= 4 || (run == 3 && dist <= FAR_DIST);
    if (!good) {
      run = 0;
      dist = 0;
    }
    return run;
  };

  int use[SEL_PER], dist[SEL_PER];
#pragma unroll
  for (int r = 0; r < SEL_PER; ++r) {
    const int p = b0 + t + r * SEL_THREADS;
    use[r] = p < S ? pick(p, dist[r]) : 0;
    use_s[t + r * SEL_THREADS] = use[r];
  }
  if (t == 0) {
    int unused;
    use_s[SEL_B] = b0 + SEL_B < S ? pick(b0 + SEL_B, unused) : 0;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < SEL_PER; ++r) {
    const int p = b0 + t + r * SEL_THREADS;
    if (p >= S) break;
    int u = use[r], d = dist[r];
    if (lazy && u > 0 && use_s[t + r * SEL_THREADS + 1] > u) u = 0;
    bool v = p < len && (hstart == nullptr || p >= hs);
    if (hist != nullptr && p < hist[l]) {
      u = 0;
      d = 0;
      v = false;
    }
    const size_t at = (size_t)l * S + p;
    use_out[at] = u;
    dist_out[at] = d;
    step_out[at] = u > 0 ? u : 1;
    valid_out[at] = v;
  }
}

}  // namespace

extern "C" int td_match_keys(const void* data, const void* lengths, const void* hstart, void* keys, int L,
                             int S, int F, int codes, void* stream) {
  const int vec = S % 4 == 0 && (reinterpret_cast<uintptr_t>(data) & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const dim3 grid((S + KEY_BLOCK - 1) / KEY_BLOCK, L);
  match_keys_kernel<<<grid, KEY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lengths), static_cast<const int*>(hstart),
      static_cast<int*>(keys), S, F, codes, vec);
  return (int)cudaGetLastError();
}

extern "C" int td_match_chain(const void* keys, void* prev, int L, int S, int F, void* stream) {
  const cudaError_t set =
      cudaFuncSetAttribute(match_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CHAIN_SMEM);
  if (set != cudaSuccess) return (int)set;
  match_chain_kernel<<<dim3(L, F), CHAIN_THREADS, CHAIN_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<uint16_t*>(prev), S);
  return (int)cudaGetLastError();
}

extern "C" int td_match_bucket(const void* prev, const void* data, void* out, int L, int S, int F, int ks, int ws,
                               void* stream) {
  const cudaError_t set =
      cudaFuncSetAttribute(match_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BUCKET_SMEM);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((S + BUCKET_TILE - 1) / BUCKET_TILE, L, F);
  match_bucket_kernel<<<grid, BUCKET_THREADS, BUCKET_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(prev), static_cast<const uint8_t*>(data), static_cast<int64_t*>(out), L, S, ks,
      ws);
  return (int)cudaGetLastError();
}

extern "C" int td_match_occupancy(int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(match_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BUCKET_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(match_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CHAIN_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], match_chain_kernel, CHAIN_THREADS, CHAIN_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], match_bucket_kernel, BUCKET_THREADS, BUCKET_SMEM);
  return (int)err;
}

extern "C" int td_match_select(const void* data, const void* lengths, const void* q4, const void* q3,
                               const void* q6, const void* hist, const void* hstart, void* use, void* dist,
                               void* step, void* valid, int L, int S, int lazy, void* stream) {
  const dim3 grid((S + SEL_B - 1) / SEL_B, L);
  match_select_kernel<<<grid, SEL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lengths), static_cast<const int64_t*>(q4),
      static_cast<const int64_t*>(q3), static_cast<const int64_t*>(q6), static_cast<const int*>(hist),
      static_cast<const int*>(hstart), static_cast<int*>(use), static_cast<int*>(dist), static_cast<int*>(step),
      static_cast<bool*>(valid), S, lazy);
  return (int)cudaGetLastError();
}
