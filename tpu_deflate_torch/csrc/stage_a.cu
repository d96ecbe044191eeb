// Stage A (K1): speculative decode of one whole symbol group at every
// payload bit position, through per-lane decode tables.
//
// Replaces tpu_deflate/codec/decode_pallas.py:_stage_a_kernel (called from
// _stage_a_jit). Same outputs bit for bit: delta (L, 512, NT) int32 = bits
// consumed (1..48), 127 at an EOB, 255 at an error; token (L, 512, NT)
// int32 = literal rank, TOKEN_MATCH_BIT | run << 16 | dist-1, -(1+len) at
// an EOB, -(100+code) at an error, with errors classified in the
// reference's serial read order.
//
// The TPU kernel decodes every position with compare ladders over the
// lane's meta row (14 steps for the litlen code, with two class/rank
// accumulators riding the same compares, 14 for the distance code, then 11
// match-plane and 5 distance-plane bit extractions), because the TPU has
// no fast gathers. Carried over as it was, that is ~100 shared-memory
// loads per position, and the shared-memory pipe bounded the kernel. Hopper
// gathers from shared memory, so the decode goes through tables:
//
// 1. stage_a_tables_kernel, one block per lane, evaluates the same ladder
//    functions at the lowest and the highest 32-bit window of every 10-bit
//    prefix and writes the lane's 1024-entry litlen table and 1024-entry
//    distance table, (L, 2048) int32. Each compare is monotone in the
//    window, so where both windows pass the same thresholds (counting those
//    whose step adds something) every window in between does too and the
//    accumulators agree; where the code is also at most 10 bits long, the
//    prefix alone fixes everything the ladder gives, and the entry holds it
//    (short). Every other prefix (codes of 11-15 bits, windows in the
//    unused region of an incomplete code) is marked long. Entries are
//    stored at the index of the prefix's bits in stream order and hold the
//    distance code's base and extra-bit count ready.
// 2. stage_a_kernel: a block takes 32 tiles x 32 byte rows of one lane
//    (8192 positions), copies the lane's tables (8 KiB) and meta row into
//    shared memory once, and decodes a short position with two table
//    gathers and a few funnel shifts of the natural (unreversed) 64-bit
//    stream window, which hand it the extra bits in place. A long position is
//    queued per warp and decoded through the ladders after the warp's 1024
//    positions, 32 at a time, so the ladders' loads run on dense warps
//    instead of stalling every warp that holds one long position.
//
// Bound on the H100: the 8 bytes written per position (the grid is one
// byte per 8 positions). Warps run along t, so every store is 128 B per
// warp; a thread takes 4 consecutive byte rows of one tile and reads the
// 12 window bytes they share once. Blocks of 8192 positions (1536 for the
// 64-lane wave of 384 tiles) balance across the SMs' block slots where
// blocks of twice the size left the last wave half empty. What limits it
// now: the short route's integer instructions and the stores (128 B
// strips of many output rows, slower than a plain fill of the same bytes)
// take about as long as each other, and they overlap only in part.
#include "td_common.cuh"

namespace {

using namespace td;

constexpr int TOKEN_MATCH_BIT = 1 << 26;
// Meta columns (tpu_deflate_torch/codec/wave_prep.py MA_*).
constexpr int MA_LLSAT = 0, MA_LLPACK = 16, MA_LLP2 = 32, MA_LLP3 = 48;
constexpr int MA_DSAT = 64, MA_DPACK = 80, MA_LLNLIVE = 96, MA_DNLIVE = 97;
constexpr int MA_DEMPTY = 98, MA_PBITS = 99, MA_EOB = 100, MA_INIT2 = 101;
constexpr int MA_INIT3 = 102, MA_MW = 104, MA_DPERM = 115;
// Reason codes (tpu_deflate.format.errors.reason_to_code), passed in.
struct ErrCodes {
  int end, reserved_len, empty_dist, reserved_dist;
};

// Decode tables (codec/decode_kernels.py TAB_*): per lane, TAB_N litlen
// entries then TAB_N distance entries, indexed by the next TAB_BITS stream
// bits in stream order (the low bits of the natural window; the ladder
// reads them reversed). Litlen entry: code length (bits 0-3), class (bits
// 4-6, K_* in the reference's order of precedence), payload (bits 16-31:
// the literal rank, else the match descriptor). Distance entry: code length
// (0-3), found (4), reserved symbol 30/31 (5), extra bits (6-9), distance
// base - 1 (16-31). Bit 15 marks a long prefix.
constexpr int TAB_BITS = 10;
constexpr int TAB_N = 1 << TAB_BITS;
constexpr int TAB_W = 2 * TAB_N;
constexpr int K_LIT = 0, K_MATCH = 1, K_EOB = 2, K_RES = 3, K_MISSING = 4;
constexpr int E_DFOUND = 1 << 4, E_DRES = 1 << 5;
constexpr int E_LONG = 1 << 15;

constexpr int A_TILES = 32;                   // tiles per block, one per lane of a warp
constexpr int A_ROWS = 4;                     // byte rows per warp
constexpr int A_WARPS = 8;
constexpr int A_THREADS = 32 * A_WARPS;
constexpr int A_BLOCK_ROWS = A_ROWS * A_WARPS;  // byte rows per block
constexpr int A_QCAP = A_ROWS * 8 * 32;       // a warp's positions
constexpr int A_WORDS = (A_ROWS + 8 + 3) / 4 + 1;  // window bytes as words, + 1 zero word

__device__ __forceinline__ uint32_t rev8(uint32_t x) { return __brev(x) >> 24; }

__device__ __forceinline__ int rev_low16(int x, int k) {
  x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555);
  x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333);
  x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F);
  x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF);
  return sar_i(x, 16 - k);
}

__device__ __forceinline__ int add_i(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }

// What the litlen ladder gives for a window; payload is the literal rank at
// a literal, else the match descriptor (run extra bits | run base - 3).
struct LitLen {
  int ln, payload;
  bool found, lit, eob, res;
};
struct Dist {
  int ln, ds;
  bool found;
};

// Litlen ladder of a reversed window (wave_prep.ladder_tables and
// class_ladder_tables); acc2/acc3 wrap like int32 in XLA. Returns the mask
// of passed thresholds that move an accumulator (a complete code's
// saturated bounds add nothing).
__device__ __forceinline__ int ll_ladder(uint32_t vR, const int* m, LitLen& o) {
  uint32_t acc = 0, acc2 = (uint32_t)m[MA_INIT2], acc3 = (uint32_t)m[MA_INIT3];
  int mask = 0;
#pragma unroll
  for (int l = 1; l < 15; ++l) {
    if (vR >= (uint32_t)m[MA_LLSAT + l]) {
      acc += (uint32_t)m[MA_LLPACK + l];
      acc2 += (uint32_t)m[MA_LLP2 + l];
      acc3 += (uint32_t)m[MA_LLP3 + l];
      if (m[MA_LLPACK + l] | m[MA_LLP2 + l] | m[MA_LLP3 + l]) mask |= 1 << l;
    }
  }
  const int a = (int)acc;
  const int cnt = a >> 20;
  o.ln = 1 + cnt;
  const int off = (a & 0xFFFFF) - shl_i(cnt, 16);
  const int lidx = add_i((int)shr_u(vR, 31 - cnt), off);
  o.found = lidx < m[MA_LLNLIVE];
  const int lnb = shl_i(o.ln, 12);
  const int lit_end = (int)((acc2 >> 16) & 0xFFFF) - lnb;
  const int res_start = (int)(acc2 & 0xFFFF) - lnb;
  const int lit_off = (int)((acc3 >> 16) & 0xFFFF) - lnb;
  const int mrank_off = (int)(acc3 & 0xFFFF) - lnb;
  o.lit = o.found && lidx < lit_end;
  o.eob = o.found && lidx == m[MA_EOB];
  o.res = o.found && lidx >= res_start;
  const int mrank = add_i(lidx, mrank_off) & 31;
  int mdesc = 0;
#pragma unroll
  for (int b = 0; b < 11; ++b) mdesc |= (int)((((uint32_t)m[MA_MW + b] >> mrank) & 1u) << b);
  o.payload = o.lit ? add_i(lidx, lit_off) : mdesc;
  return mask;
}

// Distance ladder of a reversed window; returns the mask of passed
// thresholds that move the accumulator.
__device__ __forceinline__ int d_ladder(uint32_t vD, const int* m, Dist& o) {
  uint32_t acc = 0;
  int mask = 0;
#pragma unroll
  for (int l = 1; l < 15; ++l) {
    if (vD >= (uint32_t)m[MA_DSAT + l]) {
      acc += (uint32_t)m[MA_DPACK + l];
      if (m[MA_DPACK + l]) mask |= 1 << l;
    }
  }
  const int a = (int)acc;
  const int cnt = a >> 20;
  o.ln = 1 + cnt;
  const int off = (a & 0xFFFFF) - shl_i(cnt, 16);
  const int didx = add_i((int)shr_u(vD, 31 - cnt), off);
  o.found = didx < m[MA_DNLIVE];
  const int d5 = (didx > 0 ? didx : 0) & 31;
  int ds = 0;
#pragma unroll
  for (int b = 0; b < 5; ++b) ds |= (int)((((uint32_t)m[MA_DPERM + b] >> d5) & 1u) << b);
  o.ds = ds;
  return mask;
}

// The run length after the litlen code, and the distance window behind it.
struct Run {
  bool match;
  int run_bits, run;
  uint32_t vD;
};

__device__ __forceinline__ Run run_of(uint32_t vR, uint32_t vR2, const LitLen& c) {
  Run r;
  r.match = c.found && !c.lit && !c.eob && !c.res;
  r.run_bits = r.match ? (c.payload & 7) : 0;
  const int rev = (int)shr_u(vR, 32 - c.ln - r.run_bits);
  r.run = ((c.payload >> 3) + 3) + rev_low16(rev & (shl_i(1, r.run_bits) - 1), r.run_bits);
  const int d1 = c.ln + r.run_bits;
  r.vD = shl_u(vR, d1) | shr_u(vR2, 32 - d1);
  return r;
}

__device__ __forceinline__ void finish(int pos, const LitLen& c, const Run& r, const Dist& d,
                                       int bits, bool dist_empty, ErrCodes ec, int& delta,
                                       int& token) {
  const int dist_bits = max((d.ds >> 1) - 1, 0);
  const bool reserved_dist = d.ds >= 30;
  const int dbase_m1 = d.ds < 4 ? d.ds : shl_i(2 + (d.ds & 1), dist_bits);
  const int drev = (int)shr_u(r.vD, 32 - d.ln - dist_bits);
  const int dist = dbase_m1 + 1 + rev_low16(drev & (shl_i(1, dist_bits) - 1), dist_bits);

  const int end_len = pos + c.ln;
  const int end_run = end_len + r.run_bits;  // run_bits is 0 outside match positions
  const int end_dcode = end_run + d.ln;
  const int end_all = end_dcode + dist_bits;

  // First failing read in the reference's serial order wins
  // (decode_pallas.py:254-262).
  int errc = 0;
  if (!c.found) errc = ec.end;
  else if (end_len > bits) errc = ec.end;
  else if (c.res) errc = ec.reserved_len;
  else if (r.match && end_run > bits) errc = ec.end;
  else if (r.match && dist_empty) errc = ec.empty_dist;
  else if (r.match && !d.found) errc = ec.end;
  else if (r.match && end_dcode > bits) errc = ec.end;
  else if (r.match && reserved_dist) errc = ec.reserved_dist;
  else if (r.match && end_all > bits) errc = ec.end;

  const int adv = (r.match ? end_all : end_len) - pos;
  delta = errc != 0 ? SENT_ERR : (c.eob ? SENT_EOB : adv);
  int tok = c.lit ? c.payload
                  : (TOKEN_MATCH_BIT | (min(max(r.run, 3), 258) << 16) |
                     min(max(dist - 1, 0), 65535));
  if (c.eob) tok = -(1 + c.ln);
  if (errc != 0) tok = -(100 + errc);
  token = tok;
}

// The long route: both codes through the ladders; returns (delta, token).
__device__ __noinline__ int2 decode_ladder(uint32_t vR, uint32_t vR2, int pos, const int* m,
                                           ErrCodes ec) {
  LitLen c;
  ll_ladder(vR, m, c);
  const Run r = run_of(vR, vR2, c);
  Dist d;
  d_ladder(r.vD, m, d);
  int2 out;
  finish(pos, c, r, d, m[MA_PBITS], m[MA_DEMPTY] != 0, ec, out.x, out.y);
  return out;
}

// meta (L, 128) -> tables (L, TAB_W). Block: one lane; thread i builds
// the entries of reversed prefix i, stored at the index of its stream bits.
__global__ void stage_a_tables_kernel(const int* __restrict__ meta, int* __restrict__ tables) {
  __shared__ int m[META_W];
  const int lane = blockIdx.x;
  for (int i = threadIdx.x; i < META_W; i += blockDim.x) m[i] = meta[(size_t)lane * META_W + i];
  __syncthreads();
  int* out = tables + (size_t)lane * TAB_W;
  for (int i = threadIdx.x; i < TAB_N; i += blockDim.x) {
    const uint32_t lo = (uint32_t)i << (32 - TAB_BITS);
    const uint32_t hi = lo | ((1u << (32 - TAB_BITS)) - 1u);
    const int at = (int)(__brev((uint32_t)i) >> (32 - TAB_BITS));
    LitLen a, b;
    const bool ll_same = ll_ladder(lo, m, a) == ll_ladder(hi, m, b);
    const bool ll_short = ll_same && a.ln >= 1 && a.ln <= TAB_BITS &&
                          (!a.lit || (a.payload >= 0 && a.payload <= 0xFFFF));
    const int kind = !a.found ? K_MISSING : a.res ? K_RES : a.eob ? K_EOB : a.lit ? K_LIT : K_MATCH;
    out[at] = ll_short ? (a.ln | (kind << 4) | (int)((uint32_t)a.payload << 16)) : E_LONG;
    Dist c, d;
    const bool d_same = d_ladder(lo, m, c) == d_ladder(hi, m, d);
    const bool d_short = d_same && c.ln >= 1 && c.ln <= TAB_BITS;
    const int dist_bits = max((c.ds >> 1) - 1, 0);
    const int dbase_m1 = c.ds < 4 ? c.ds : (2 + (c.ds & 1)) << dist_bits;
    out[TAB_N + at] = d_short ? (c.ln | (c.found ? E_DFOUND : 0) | (c.ds >= 30 ? E_DRES : 0) |
                                 (dist_bits << 6) | (int)((uint32_t)dbase_m1 << 16))
                              : E_LONG;
  }
}

// The short route: one position from its table entries. nlo/nhi hold
// stream bits pos..pos+63; le is the litlen entry of the low bits. Returns
// whether the position needs the long route after all (a match whose
// distance entry is long). Written as selects: the compiler keeps it free
// of branches.
__device__ __forceinline__ bool decode_short(uint32_t nlo, uint32_t nhi, int le, const int* dtab,
                                             int pos, int bits, bool dist_empty, ErrCodes ec,
                                             int& delta, int& token) {
  const int ln = le & 15;
  const int kind = (le >> 4) & 7;
  const int payload = (int)((uint32_t)le >> 16);
  const bool match = kind == K_MATCH;
  // A short code is <= 10 bits and a run has <= 7 extra bits, so every
  // field below starts within the first 28 bits.
  const int rb = match ? (payload & 7) : 0;
  const int run = (payload >> 3) + 3 + (int)(__funnelshift_r(nlo, nhi, ln) & ((1u << rb) - 1u));
  const int d1 = ln + rb;
  const int de = dtab[__funnelshift_r(nlo, nhi, d1) & (TAB_N - 1)];
  const int dln = de & 15;
  const int dbits = (de >> 6) & 15;
  const int dist = (int)((uint32_t)de >> 16) + 1 +
                   (int)(__funnelshift_r(nlo, nhi, d1 + dln) & ((1u << dbits) - 1u));
  const int end_len = pos + ln;
  const int end_run = end_len + rb;
  const int end_dcode = end_run + dln;
  const int end_all = end_dcode + dbits;
  // The reference's serial order (decode_pallas.py:254-262), last check
  // first, so that each earlier one overrides.
  int merr = end_all > bits ? ec.end : 0;
  merr = (de & E_DRES) ? ec.reserved_dist : merr;
  merr = (!(de & E_DFOUND)) | (end_dcode > bits) ? ec.end : merr;
  merr = dist_empty ? ec.empty_dist : merr;
  merr = end_run > bits ? ec.end : merr;
  int errc = match ? merr : 0;
  errc = kind == K_RES ? ec.reserved_len : errc;
  errc = (kind == K_MISSING) | (end_len > bits) ? ec.end : errc;

  const int mtok = TOKEN_MATCH_BIT | (min(max(run, 3), 258) << 16) | min(max(dist - 1, 0), 65535);
  int tk = match ? mtok : payload;
  tk = kind == K_EOB ? -(1 + ln) : tk;
  token = errc != 0 ? -(100 + errc) : tk;
  int dl = match ? end_all - pos : ln;
  dl = kind == K_EOB ? SENT_EOB : dl;
  delta = errc != 0 ? SENT_ERR : dl;
  return match & ((de & E_LONG) != 0);
}

// grid (L, 64, NT+1) uint8; meta (L, 128) int32; tables (L, TAB_W) int32;
// delta/token (L, 512, NT). Block: tiles [32 blockIdx.x, +32) and byte rows
// [32 blockIdx.y, +32) of lane blockIdx.z; warp w takes byte rows
// 32 blockIdx.y + 4w + [0, 4), lane i tile 32 blockIdx.x + i.
__global__ void __launch_bounds__(A_THREADS, 4)
    stage_a_kernel(const uint8_t* __restrict__ grid, const int* __restrict__ meta,
                   const int* __restrict__ tables, int* __restrict__ delta,
                   int* __restrict__ token, int NT, ErrCodes ec) {
  __shared__ int m[META_W];
  __shared__ __align__(16) int tab[TAB_W];
  __shared__ uint16_t queue[A_WARPS][A_QCAP];
  const int lane = blockIdx.z;
  for (int i = threadIdx.x; i < META_W; i += A_THREADS) m[i] = meta[(size_t)lane * META_W + i];
  const int4* tsrc = reinterpret_cast<const int4*>(tables + (size_t)lane * TAB_W);
  for (int i = threadIdx.x; i < TAB_W / 4; i += A_THREADS) reinterpret_cast<int4*>(tab)[i] = tsrc[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int t = blockIdx.x * A_TILES + lid;
  const bool live = t < NT;
  const int q0 = A_BLOCK_ROWS * blockIdx.y + A_ROWS * warp;
  const size_t ncol = (size_t)NT + 1;
  const uint8_t* g = grid + (size_t)lane * 64 * ncol;
  // Bytes q0..q0+A_ROWS+7 of tile t (rows past 63 spill into tile t+1), as
  // little-endian words: stream bit 8 (q0 + k) + i is bit i of byte k.
  uint32_t w[A_WORDS];
#pragma unroll
  for (int k4 = 0; k4 < A_WORDS; ++k4) {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int bi = q0 + 4 * k4 + k;
      if (4 * k4 + k < A_ROWS + 8 && live)
        x |= (uint32_t)g[(size_t)(bi & 63) * ncol + t + (bi >> 6)] << (8 * k);
    }
    w[k4] = x;
  }
  const int bits = m[MA_PBITS];
  const bool dist_empty = m[MA_DEMPTY] != 0;
  const size_t obase = (size_t)lane * W_P * NT;
  uint64_t longs = 0;  // bit 8j + r: position (row q0 + j, bit r) takes the long route
#pragma unroll
  for (int j = 0; j < A_ROWS; ++j) {
    // Stream bits from byte q0 + j on: a = bits 0..31, b = 32..63, c = 64..71.
    const int sh = 8 * (j & 3);
    const uint32_t a = __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], sh);
    const uint32_t b = __funnelshift_r(w[(j >> 2) + 1], w[(j >> 2) + 2], sh);
    const uint32_t c = __funnelshift_r(w[(j >> 2) + 2], w[(j >> 2) + 3], sh);
    const int s0 = 8 * (q0 + j);
    int* dp = delta + obase + (size_t)s0 * NT + t;
    int* tp = token + obase + (size_t)s0 * NT + t;
    const int pos0 = t * W_P + s0;
#pragma unroll
    for (int r = 0; r < 8; ++r, dp += NT, tp += NT) {
      const uint32_t nlo = __funnelshift_r(a, b, r);
      const uint32_t nhi = __funnelshift_r(b, c, r);
      const int le = tab[nlo & (TAB_N - 1)];
      int d, tk;
      const bool lng = (le & E_LONG) | decode_short(nlo, nhi, le, tab + TAB_N, pos0 + r, bits,
                                                    dist_empty, ec, d, tk);
      longs |= (uint64_t)lng << (8 * j + r);
      if (live & !lng) {  // streaming stores: the outputs are not read again here
        __stcs(dp, d);
        __stcs(tp, tk);
      }
    }
  }
  // Queue the warp's long positions, then decode them 32 at a time.
  if (!live) longs = 0;
  const int n = __popcll(longs);
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lid >= o) incl += x;
  }
  const int nq = __shfl_sync(0xffffffffu, incl, 31);
  for (int at = incl - n; longs; longs &= longs - 1, ++at)
    queue[warp][at] = (uint16_t)(((__ffsll(longs) - 1) << 5) | lid);
  __syncwarp();
  for (int i = lid; i < nq; i += 32) {
    const int e = queue[warp][i];
    const int jr = e >> 5;
    const int tq = t - lid + (e & 31);
    const int q = q0 + (jr >> 3);
    const int r = jr & 7;
    uint32_t v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int bi = q + k;
      v[k] = rev8(g[(size_t)(bi & 63) * ncol + tq + (bi >> 6)]);
    }
    // Reversed 32-bit windows: stream bit p at bit 31 of vR, p+32 of vR2.
    const uint32_t vR = (((v[0] << 24) | (v[1] << 16) | (v[2] << 8) | v[3]) << r) | (v[4] >> (8 - r));
    const uint32_t vR2 = (((v[4] << 24) | (v[5] << 16) | (v[6] << 8) | v[7]) << r) | (v[8] >> (8 - r));
    const int s = 8 * q + r;
    const int2 dt = decode_ladder(vR, vR2, tq * W_P + s, m, ec);
    delta[obase + (size_t)s * NT + tq] = dt.x;
    token[obase + (size_t)s * NT + tq] = dt.y;
  }
}

}  // namespace

extern "C" int td_stage_a_tables(const void* meta, void* tables, int L, void* stream) {
  stage_a_tables_kernel<<<L, 512, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<int*>(tables));
  return (int)cudaGetLastError();
}

extern "C" int td_stage_a(const void* grid, const void* meta, const void* tables, void* delta,
                          void* token, int L, int NT, int err_end, int err_reserved_len,
                          int err_empty_dist, int err_reserved_dist, void* stream) {
  ErrCodes ec{err_end, err_reserved_len, err_empty_dist, err_reserved_dist};
  dim3 blocks((NT + A_TILES - 1) / A_TILES, 64 / A_BLOCK_ROWS, L);
  stage_a_kernel<<<blocks, A_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(grid), static_cast<const int*>(meta),
      static_cast<const int*>(tables), static_cast<int*>(delta), static_cast<int*>(token), NT,
      ec);
  return (int)cudaGetLastError();
}
