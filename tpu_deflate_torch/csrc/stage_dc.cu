// Stage DC (K3): replay of the true chain in every tile, level-1 token
// compaction and the per-tile summary rows.
//
// Replaces tpu_deflate/codec/decode_pallas.py:_stage_dc_kernel (called from
// _stage_dc_jit). For every tile, one cursor starts at the tile's true
// entry (>= 48 or negative: the chain never enters the tile) and walks the
// deltas. Outputs, bit for bit as the TPU kernel after its transposes:
// tokens (L, NT, k1) int32, the first k1 reached non-terminal tokens in
// stream order with -1 behind them; summary (L, 8, NT) int32, rows
// ROW_COUNT..ROW_OVERFLOW (wave_prep.py), sums wrapping like int32.
//
// One thread per tile that followed the deltas through device memory paid
// a DRAM round trip per link of the chain (a tile's rows lie NT * 4 bytes
// apart), dozens of links a tile, and its stores of neighbouring tiles lay
// k1 * 4 bytes apart. Here a block takes a strip of TB neighbouring tiles
// of one lane (TB = 32, or 8 where the wave has too few tiles to give 256
// blocks of 32, so that it still spreads over the SMs):
//
// 1. Staging. Every delta of the strip is read once, a row of the
//    (L, 512, NT) layout being one TB * 4-byte piece, and turned into its
//    first hop as it arrives: p + cursor_adv(d) where that stays in the
//    tile, else a terminal (a stop, a <= 0, ends the chain after its
//    position, and the sum is unsigned, so a delta near 2^31 leaves the
//    tile). The hop also keeps the position's class: valid (d < 127), EOB
//    (127), error (255) or none. 2 bytes a position, 1 KiB a tile, in
//    shared memory.
// 2. Reach. The tile's chain is walked from its entry through the staged
//    hops, one thread per tile: a dependent shared load a link instead of
//    a device-memory round trip. Each reached position (terminal ones
//    included) is written, with its class, over the hop table in place:
//    the n-th reached position is >= n and every later link lies past it,
//    so the list never overwrites a hop still to be read.
// 3. Emit. One warp per tile reads the list 32 entries at a time, gathers
//    the tokens of the classified positions (one independent load each,
//    all of a 128-entry chunk in flight together), ranks the valid ones by
//    a ballot prefix (the chain only moves forward: list order is stream
//    order), writes the first k1 to out[rank] and the -1 padding with
//    contiguous warp stores, and sums the summary rows by warp reductions
//    that wrap like uint32. The block writes the summary rows of its strip
//    as TB-wide coalesced rows.
// 4. Fold. One warp folds the strip's rows into the wave's per-lane vector
//    (fold_strip below): K3's epilogue, in place of a launch of its own.
//
// Marking the chain by K9's pointer jumping (a warp per tile, up to nine
// rounds over all 512 positions) and staging the tokens as well (64 KiB
// more a strip, so fewer blocks per SM) both ran slower on the H100 than
// this walk, which touches only the chain (PERF.md, section 6).
//
// Bound on the H100: memory traffic, the deltas read once (2 KiB a tile),
// the sectors of the reached tokens, and the outputs.
#include "td_common.cuh"

namespace {

using namespace td;

// ---------------------------------------------------------------------------
// The wave's summary fold: the summary rows -> the per-lane (7, L) vector.
//
// Replaces the tail of tpu_deflate/codec/decode_jax_v2.py:_run_wave_pallas_impl
// (:1331-1342, compiled into the jitted wave program of :1298) and
// _pack_small (:1363, jit). Exactly decode_kernels.wave_summary_plain: from
// the rows (L, 8, NT), vec (7, L) int32 holds per lane the sums of rows
// ROW_COUNT (row 0 of vec), ROW_EOB_HIT > 0 (1), eob_pos - eob_tok - 1 where
// an EOB was hit, else 0, with eob_pos the sum of ROW_EOB_POS + ROW_EOB_HIT
// * t * W_P (2), -err_tok - 100 where ROW_ERR_HIT sums above 0, else 0 (3),
// ROW_SIZE_SUM (4), the sum of ROW_OVERFLOW over every lane and tile > 0,
// the same in every lane (5), and nlit or 0 (6). Sums are taken in 64 bits
// and compared signed, then cut to 32 bits, as the plain version's int64.
//
// It runs as the epilogue of every block (x, l) of K3's strips x of lane l
// (or wave_fold_kernel's, on given rows), by warp 0. A block adds its
// strip's eight 64-bit partial sums to its lane's totals (fire-and-forget
// reductions), fences and counts itself done. The lane's last strip, block
// (strips - 1, l), adds its own, waits until the others are counted, reads
// the totals, writes the lane's rows, adds the lane's overflow to the
// wave's and counts the lane done: the last lane to count writes row 5 into
// every lane. A block waits only on blocks of lower index, which the card
// starts first, and at most L blocks wait, fewer than the card holds (a
// wait that never ends traps). Whoever reads a total or a count puts it
// back to 0, so the counts are zero after every launch and the next one
// needs no zero fill (the wrapper keeps them per device and stream).
// Designs tried (PERF.md, PR 19): every block learning from an atomic
// count, or from its order when it started, whether it was last; partial
// sums in slots of their own with spread counts (the polls of a 256-lane
// wave cost more). The fences are acquire-release (fence.acq_rel.gpu),
// lighter than __threadfence().
//
// counts (uint64, FOLD_STRIDE (L + 1), 0 before and after): lane l's 8 sums
// (count, eob hits, eob_pos, eob_tok, err hits, err_tok, size, overflow)
// at FOLD_STRIDE l and its strips done at FOLD_STRIDE l + 8, then the
// wave's overflow sum and its lanes done at FOLD_STRIDE L.
constexpr int FOLD_STRIDE = 16;  // words from a lane's totals to the next's: a 128-byte line each

__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// Warp 0 of block (x, l) of a grid of strips x L blocks, after the strip's
// rows are in ssum (tile t0 + i in column i).
template <int TB>
__device__ __forceinline__ void fold_strip(const uint32_t (&ssum)[8][TB], int t0, int NT, int x, int l, int strips,
                                           int L, const int* __restrict__ nlit, int* __restrict__ vec,
                                           unsigned long long* __restrict__ counts) {
  static_assert(TB <= 32, "a lane of the warp a tile");
  const int lid = threadIdx.x & 31;
  // count, eob hits, eob_pos, eob_tok, err hits, err_tok, size, overflow
  unsigned long long a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (lid < TB && t0 + lid < NT) {
    const long long hit = (int)ssum[5][lid];
    a[0] = (long long)(int)ssum[0][lid];
    a[1] = hit;
    a[2] = (long long)(int)ssum[1][lid] + hit * ((long long)(t0 + lid) * W_P);
    a[3] = (long long)(int)ssum[2][lid];
    a[4] = (long long)(int)ssum[6][lid];
    a[5] = (long long)(int)ssum[3][lid];
    a[6] = (long long)(int)ssum[4][lid];
    a[7] = (long long)(int)ssum[7][lid];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a[k] += __shfl_xor_sync(0xffffffffu, a[k], o);
  int last_lane = 0, flag = 0;
  if (lid == 0) {
    unsigned long long* acc = counts + (size_t)l * FOLD_STRIDE;
    unsigned long long* wave = counts + (size_t)L * FOLD_STRIDE;
#pragma unroll
    for (int k = 0; k < 8; ++k) atomicAdd(acc + k, a[k]);
    if (x != strips - 1) {
      fence_acq_rel();  // the sums before the count
      atomicAdd(acc + 8, 1ull);
    } else {  // the lane's last strip
      const volatile unsigned long long* done = acc + 8;
      for (unsigned spins = 0; *done != (unsigned long long)(strips - 1); ++spins)
        if (spins > (1u << 28)) __trap();
      fence_acq_rel();
      unsigned long long t[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) t[k] = atomicExch(acc + k, 0ull);
      atomicExch(acc + 8, 0ull);
      const bool eob = (long long)t[1] > 0, err = (long long)t[4] > 0;
      vec[l] = (int)t[0];
      vec[L + l] = eob;
      vec[2 * L + l] = eob ? (int)(t[2] - t[3] - 1) : 0;
      vec[3 * L + l] = err ? (int)(0ull - t[5] - 100) : 0;
      vec[4 * L + l] = (int)t[6];
      vec[6 * L + l] = nlit ? nlit[l] : 0;
      atomicAdd(wave, t[7]);
      fence_acq_rel();  // the lane's overflow before its count
      if (atomicAdd(wave + 1, 1ull) == (unsigned long long)(L - 1)) {  // the wave's last lane
        fence_acq_rel();
        last_lane = 1;
        flag = (long long)atomicExch(wave, 0ull) > 0;
        atomicExch(wave + 1, 0ull);
      }
    }
  }
  if (__shfl_sync(0xffffffffu, last_lane, 0)) {
    flag = __shfl_sync(0xffffffffu, flag, 0);
    for (int j = lid; j < L; j += 32) vec[5 * L + j] = flag;
  }
}

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t H_TERM = 0x8000;   // terminal hop
constexpr uint32_t H_POS = 0x01FF;    // target position (or the listed position)
constexpr int H_CLS_SHIFT = 12;       // class: 0 none, 1 valid, 2 EOB, 3 error
constexpr int CLS_VALID = 1, CLS_EOB = 2, CLS_ERR = 3;

// Position p's hop code: the next position or H_TERM, and the class.
__device__ __forceinline__ uint32_t hop_code(int p, int d) {
  const int a = cursor_adv(d);
  const uint32_t cls = d < SENT_EOB ? CLS_VALID : (d == SENT_EOB ? CLS_EOB : (d == SENT_ERR ? CLS_ERR : 0));
  const uint32_t nxt = (a <= 0 || (unsigned)a >= (unsigned)(W_P - p)) ? H_TERM : (uint32_t)(p + a);
  return nxt | cls << H_CLS_SHIFT;
}

struct Sums {
  uint32_t count, eob_pos, eob_tok, err_tok, size, eob_hit, err_hit;
};

// Warp: the listed positions of one tile -> its first k1 tokens and -1
// padding in out, and its sums (warp-uniform). tk: the tile's token column
// (row stride NT).
__device__ __forceinline__ Sums emit_tile(const uint16_t* __restrict__ list, int n, const int* __restrict__ tk,
                                          int NT, int* __restrict__ out, int k1, int lane) {
  Sums s = {0, 0, 0, 0, 0, 0, 0};
  const unsigned lt = (1u << lane) - 1u;
  for (int base = 0; base < n; base += 128) {
    uint32_t e[4];
    int tv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = base + 32 * k + lane;
      e[k] = j < n ? list[j] : 0u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) tv[k] = (e[k] >> H_CLS_SHIFT) ? tk[(size_t)(e[k] & H_POS) * NT] : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t cls = e[k] >> H_CLS_SHIFT;
      const bool valid = cls == CLS_VALID;
      const unsigned bal = __ballot_sync(0xffffffffu, valid);
      const uint32_t rank = s.count + __popc(bal & lt);
      if (valid && rank < (uint32_t)k1) out[rank] = tv[k];
      const int t = tv[k];
      s.size += valid ? ((t >= 0 && t < 256) ? 1u : (uint32_t)((t >> 16) & 0x3FF)) : 0u;
      s.eob_hit += cls == CLS_EOB;
      s.eob_pos += cls == CLS_EOB ? (e[k] & H_POS) : 0u;
      s.eob_tok += cls == CLS_EOB ? (uint32_t)t : 0u;
      s.err_hit += cls == CLS_ERR;
      s.err_tok += cls == CLS_ERR ? (uint32_t)t : 0u;
      s.count += __popc(bal);
    }
  }
  for (int j = (int)s.count + lane; j < k1; j += 32) out[j] = -1;
  s.size = __reduce_add_sync(0xffffffffu, s.size);
  s.eob_hit = __reduce_add_sync(0xffffffffu, s.eob_hit);
  s.eob_pos = __reduce_add_sync(0xffffffffu, s.eob_pos);
  s.eob_tok = __reduce_add_sync(0xffffffffu, s.eob_tok);
  s.err_hit = __reduce_add_sync(0xffffffffu, s.err_hit);
  s.err_tok = __reduce_add_sync(0xffffffffu, s.err_tok);
  return s;
}

// delta, token (L, 512, NT), entries (L, NT) -> tok_out (L, NT, k1),
// summ (L, 8, NT), vec (7, L) (the fold; counts as fold_strip's). Grid
// (ceil(NT / TB), L), THREADS threads.
template <int TB>
__global__ void __launch_bounds__(THREADS)
    stage_dc_kernel(const int* __restrict__ delta, const int* __restrict__ token,
                    const int* __restrict__ entries, int* __restrict__ tok_out,
                    int* __restrict__ summ, int* __restrict__ vec, unsigned long long* __restrict__ counts,
                    int NT, int k1) {
  constexpr int HW = W_P / 2 + 32 / TB;  // words of a tile's hop table (see staging)
  __shared__ uint32_t hopw[TB * HW];
  __shared__ int reach[TB];
  __shared__ uint32_t ssum[8][TB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = blockIdx.y, t0 = blockIdx.x * TB;
  const int* dl = delta + (size_t)l * W_P * NT;

  // 1. Staging: two rows a thread and step, packed into one word. A warp
  // stores TB tiles x 32 / TB row pairs; the 32 / TB words of padding per
  // tile put them in 32 distinct banks.
#pragma unroll 8
  for (int idx = tid; idx < TB * (W_P / 2); idx += THREADS) {
    const int tt = idx % TB, pp = idx / TB, t = t0 + tt;
    uint32_t code = H_TERM | H_TERM << 16;
    if (t < NT) {
      const int d0 = dl[(size_t)(2 * pp) * NT + t], d1 = dl[(size_t)(2 * pp + 1) * NT + t];
      code = hop_code(2 * pp, d0) | hop_code(2 * pp + 1, d1) << 16;
    }
    hopw[tt * HW + pp] = code;
  }
  __syncthreads();

  // 2. Reach: a thread per tile walks its chain and lists it in place.
  if (tid < TB) {
    int n = 0;
    const int e = t0 + tid < NT ? entries[(size_t)l * NT + t0 + tid] : -1;
    if ((unsigned)e < (unsigned)E_WIN) {
      uint16_t* h = reinterpret_cast<uint16_t*>(hopw + tid * HW);
      uint32_t cur = (uint32_t)e;
      for (;;) {
        const uint32_t c = h[cur];
        h[n++] = (uint16_t)((c & (3u << H_CLS_SHIFT)) | cur);
        if (c & H_TERM) break;
        cur = c & H_POS;
      }
    }
    reach[tid] = n;
  }
  __syncthreads();

  // 3. Emit, a warp per tile.
  for (int tt = warp; tt < TB; tt += WARPS) {
    const int t = t0 + tt;
    if (t >= NT) continue;
    const uint16_t* list = reinterpret_cast<const uint16_t*>(hopw + tt * HW);
    const Sums s = emit_tile(list, reach[tt], token + (size_t)l * W_P * NT + t, NT,
                             tok_out + ((size_t)l * NT + t) * k1, k1, lane);
    if (lane == 0) {
      ssum[0][tt] = s.count;
      ssum[1][tt] = s.eob_pos;
      ssum[2][tt] = s.eob_tok;
      ssum[3][tt] = s.err_tok;
      ssum[4][tt] = s.size;
      ssum[5][tt] = s.eob_hit;
      ssum[6][tt] = s.err_hit;
      ssum[7][tt] = s.count > (uint32_t)k1 ? 1u : 0u;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 8 * TB; idx += THREADS) {
    const int row = idx / TB, tt = idx % TB;
    if (t0 + tt < NT) summ[((size_t)l * 8 + row) * NT + t0 + tt] = (int)ssum[row][tt];
  }

  // 4. Fold (ssum is complete since the barrier above).
  if (warp == 0) fold_strip<TB>(ssum, t0, NT, blockIdx.x, l, gridDim.x, gridDim.y, nullptr, vec, counts);
}

// The fold alone on given rows (L, 8, NT) (with nlit (L,) or null): a
// warp a strip of TB tiles, the same epilogue as K3's.
template <int TB>
__global__ void __launch_bounds__(32)
    wave_fold_kernel(const int* __restrict__ summ, const int* __restrict__ nlit, int* __restrict__ vec,
                     unsigned long long* __restrict__ counts, int NT) {
  __shared__ uint32_t ssum[8][TB];
  const int lid = threadIdx.x, l = blockIdx.y, t0 = blockIdx.x * TB;
  if (lid < TB)
#pragma unroll
    for (int row = 0; row < 8; ++row)
      ssum[row][lid] = t0 + lid < NT ? (uint32_t)summ[((size_t)l * 8 + row) * NT + t0 + lid] : 0u;
  __syncwarp();
  fold_strip<TB>(ssum, t0, NT, blockIdx.x, l, gridDim.x, gridDim.y, nlit, vec, counts);
}

// Strips of 32 tiles where the wave has 256 blocks of them, else of 8
// (the decode's 4-lane waves: 64 and 512 blocks).
template <int TB>
int launch(const void* delta, const void* token, const void* entries, void* tok_out, void* summ, void* vec,
           void* counts, int L, int NT, int k1, cudaStream_t stream) {
  dim3 blocks((NT + TB - 1) / TB, L);
  stage_dc_kernel<TB><<<blocks, THREADS, 0, stream>>>(
      static_cast<const int*>(delta), static_cast<const int*>(token), static_cast<const int*>(entries),
      static_cast<int*>(tok_out), static_cast<int*>(summ), static_cast<int*>(vec),
      static_cast<unsigned long long*>(counts), NT, k1);
  return (int)cudaGetLastError();
}

template <int TB>
int launch_fold(const void* summ, const void* nlit, void* vec, void* counts, int L, int NT, cudaStream_t stream) {
  wave_fold_kernel<TB><<<dim3((NT + TB - 1) / TB, L), 32, 0, stream>>>(
      static_cast<const int*>(summ), static_cast<const int*>(nlit), static_cast<int*>(vec),
      static_cast<unsigned long long*>(counts), NT);
  return (int)cudaGetLastError();
}

bool wide(int L, int NT) { return (long)L * NT >= 32L * 256; }

}  // namespace

// The fold's counts: FOLD_STRIDE (L + 1) uint64, 0 before the launch and
// left 0 (fold_strip's).
extern "C" int td_stage_dc(const void* delta, const void* token, const void* entries, void* tok_out, void* summ,
                           void* vec, void* counts, int L, int NT, int k1, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > 65535 || NT < 1) return (int)cudaErrorInvalidValue;
  if (wide(L, NT)) return launch<32>(delta, token, entries, tok_out, summ, vec, counts, L, NT, k1, s);
  return launch<8>(delta, token, entries, tok_out, summ, vec, counts, L, NT, k1, s);
}

// The fold alone, strips as K3 cuts them (the edge rows' check); nlit may
// be null; counts as td_stage_dc's.
extern "C" int td_wave_summary(const void* summ, const void* nlit, void* vec, void* counts, int L, int NT,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > 65535 || NT < 1) return (int)cudaErrorInvalidValue;
  if (wide(L, NT)) return launch_fold<32>(summ, nlit, vec, counts, L, NT, s);
  return launch_fold<8>(summ, nlit, vec, counts, L, NT, s);
}
