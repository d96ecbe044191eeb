// The encoder's match finder: hash keys, the per-family candidate compare,
// and the run and lazy selection.
//
// Replace the reference's jitted tpu_deflate/codec/encode_jax.py:_match_find
// (:144; one XLA program inside analyze_phase1 :465), with its bucket_best
// (:191) and suffix_runlen (:316), which the port ran as a chain of small
// eager PyTorch ops (~633 launches a 64-lane batch at effort 2, ~18,500 at
// effort 4). The match finder is now: td_match_keys for every hash family
// at once, one stable torch.sort of all the families' rows (data movement
// standing in for the reference's lax.sort; for 128 or more rows of 32-bit
// keys PyTorch runs cub's segmented radix sort, 8 launches where a sort of
// each family's int64 keys took 29), one td_match_bucket a family, then one
// td_match_select.
//
// td_match_keys (match_keys_kernel): h[f, l, i] (int32) = family f's 16-bit
// multiplicative hash of the zero-extended row's bytes i..i+3 (4-byte),
// i..i+2 (3-byte) or i..i+5 (6-byte), or -1 where i is not valid (i >=
// lengths[l], or i < hstart[l]). A stable sort of each row groups each
// hash in a run of sorted indices, its positions ascending.
//
// td_match_bucket (match_bucket_kernel): for sorted index i, the candidates
// are the K sorted indices before it of the same hash group (h != -1) whose
// position is 1..32768 back; each is compared byte by byte with position i,
// up to 4 nwords bytes of the row zero-extended past S, and the longest
// wins, ties to the nearer (smaller k). out[l, pos] = cand + 1 | len << 32
// (int64, position order; 0 where no candidate matched). The reference
// gathers nwords window words into sorted order and shifts them K times
// (776 word compares a position at quality 1); here one thread takes one
// sorted index, reads its candidates' hashes and columns, and compares the
// bytes of the lane's row, staged in dynamic shared memory (S bytes and a
// zero tail of 68), four at a time (two aligned words and a funnel shift a
// side). The loop stops at the group's start, at the first candidate more
// than 32768 back (positions ascend in a group), and once a candidate
// matched the whole cap (no later one can beat it); a compare of 0 bytes (a
// hash collision) is skipped. Several blocks share a lane (each stages the
// row) so that 64 lanes fill the card. Bound on the H100: bytes, the sorted
// hashes, their columns and the row read once and the result written once
// (21 bytes a position, ~26 us for 64 x 65536); the work, K compares of up
// to 4 nwords bytes a position, depends on the data: on an all-zero row
// every compare matches the cap at once.
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
constexpr int BUCKET_THREADS = 512;
constexpr int SEL_THREADS = 256;
constexpr int SEL_B = 1024;                                    // positions a select block
constexpr int SEL_PER = SEL_B / SEL_THREADS;                   // positions a thread
constexpr int SEL_WORDS = (SEL_B + 1 + MAX_RUN + 31) / 32 + 1; // equality words a distance
constexpr int SEL_STAGE = 4 + 32 * SEL_WORDS;                  // bytes from 4 before the block

// Bytes of the bucket's shared row: S bytes, then zeros up to the word
// that the widest compare at position S - 1 reads last.
__host__ __device__ constexpr int bucket_smem_words(int S) { return (S + 3) / 4 + MAX_WORDS + 1; }

// keys (F, L, S): grid (ceil(S / KEY_THREADS), L, F), a thread a position;
// family f is bits 2f..2f+1 of codes.
__global__ void __launch_bounds__(KEY_THREADS)
    match_keys_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                      const int* __restrict__ hstart, int* __restrict__ keys, int S, int codes) {
  const int l = blockIdx.y;
  const int family = (codes >> (2 * blockIdx.z)) & 3;
  const int i = blockIdx.x * KEY_THREADS + threadIdx.x;
  if (i >= S) return;
  const uint8_t* row = data + (size_t)l * S;
  uint32_t b[6];
#pragma unroll
  for (int t = 0; t < 6; ++t) b[t] = i + t < S ? row[i + t] : 0u;
  const uint32_t w = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
  uint32_t x = w;
  if (family == 1) x = w & 0xFFFFFFu;
  if (family == 2) x = w ^ ((b[4] | b[5] << 8) * H6_MUL);
  const bool valid = i < lengths[l] && (hstart == nullptr || i >= hstart[l]);
  keys[((size_t)blockIdx.z * gridDim.y + l) * S + i] = valid ? (int)((x * HASH_MUL) >> HASH_SHIFT) : -1;
}

// Equal leading bytes (0..4 nwords) of the zero-extended row at a and b.
__device__ __forceinline__ int prefix_len(const uint32_t* row, int a, int b, int nwords) {
  const uint32_t* pa = row + (a >> 2);
  const uint32_t* pb = row + (b >> 2);
  const int sa = (a & 3) * 8, sb = (b & 3) * 8;
  uint32_t alo = pa[0], blo = pb[0];
  for (int w = 0; w < nwords; ++w) {
    const uint32_t ahi = pa[w + 1], bhi = pb[w + 1];
    const uint32_t x = __funnelshift_r(alo, ahi, sa) ^ __funnelshift_r(blo, bhi, sb);
    if (x) return 4 * w + ((__ffs(x) - 1) >> 3);
    alo = ahi;
    blo = bhi;
  }
  return 4 * nwords;
}

// sorted_h (L, S) stably sorted hashes, order (L, S) their columns, data
// (L, S) -> out (L, S) in position order: grid (blocks a lane, L); block g
// takes sorted indices [g chunk, (g + 1) chunk) of its lane.
__global__ void __launch_bounds__(BUCKET_THREADS)
    match_bucket_kernel(const int* __restrict__ sorted_h, const int64_t* __restrict__ order,
                        const uint8_t* __restrict__ data, int64_t* __restrict__ out, int S, int K, int nwords,
                        int chunk) {
  extern __shared__ uint32_t row[];
  const int l = blockIdx.y;
  const uint8_t* src = data + (size_t)l * S;
  uint8_t* rb = reinterpret_cast<uint8_t*>(row);
  const int nbytes = 4 * bucket_smem_words(S);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (S & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* r4 = reinterpret_cast<uint4*>(row);
    for (int j = threadIdx.x; j < S / 16; j += BUCKET_THREADS) r4[j] = s4[j];
  } else {
    for (int j = threadIdx.x; j < S; j += BUCKET_THREADS) rb[j] = src[j];
  }
  for (int j = S + threadIdx.x; j < nbytes; j += BUCKET_THREADS) rb[j] = 0;
  __syncthreads();

  const int* hr = sorted_h + (size_t)l * S;
  const int64_t* cr = order + (size_t)l * S;
  int64_t* orow = out + (size_t)l * S;
  const int cap = 4 * nwords;
  const int i0 = blockIdx.x * chunk;
  const int i1 = min(S, i0 + chunk);
  for (int i = i0 + threadIdx.x; i < i1; i += BUCKET_THREADS) {
    const int h = hr[i];
    const int pos = (int)cr[i];
    int64_t packed = 0;
    if (h != -1) {
      int blen = 0, bcand = -1;
      const int kmax = min(K, i);
      for (int k = 1; k <= kmax; ++k) {
        if (hr[i - k] != h) break;  // the group's start
        const int cand = (int)cr[i - k];
        if (pos - cand > MAX_DIST) break;  // every later candidate is farther
        const int lc = prefix_len(row, pos, cand, nwords);
        if (lc > blen) {
          blen = lc;
          bcand = cand;
          if (blen == cap) break;
        }
      }
      if (blen > 0) packed = (int64_t)(bcand + 1) | (int64_t)blen << 32;
    }
    orow[pos] = packed;
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
  const dim3 grid((S + KEY_THREADS - 1) / KEY_THREADS, L, F);
  match_keys_kernel<<<grid, KEY_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lengths), static_cast<const int*>(hstart),
      static_cast<int*>(keys), S, codes);
  return (int)cudaGetLastError();
}

extern "C" int td_match_bucket(const void* sorted_h, const void* order, const void* data, void* out, int L, int S,
                               int K, int nwords, void* stream) {
  const int smem = 4 * bucket_smem_words(S);
  cudaError_t err = cudaFuncSetAttribute(match_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, match_bucket_kernel, BUCKET_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  // Two resident blocks' worth a lane for every slot of the card, and no
  // block with fewer sorted indices than threads.
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  const int want = (2 * slots + L - 1) / L;
  const int most = (S + BUCKET_THREADS - 1) / BUCKET_THREADS;
  const int blocks = want < 1 ? 1 : (want > most ? most : want);
  const int chunk = (S + blocks - 1) / blocks;
  const dim3 grid(blocks, L);
  match_bucket_kernel<<<grid, BUCKET_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted_h), static_cast<const int64_t*>(order), static_cast<const uint8_t*>(data),
      static_cast<int64_t*>(out), S, K, nwords, chunk);
  return (int)cudaGetLastError();
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
