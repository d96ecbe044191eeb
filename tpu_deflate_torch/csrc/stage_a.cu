// Stage A (K1): speculative decode of one whole symbol group at every
// payload bit position.
//
// Replaces tpu_deflate/codec/decode_pallas.py:_stage_a_kernel (called from
// _stage_a_jit). Same outputs bit for bit: delta (L, 512, NT) int32 = bits
// consumed (1..48), 127 at an EOB, 255 at an error; token (L, 512, NT)
// int32 = literal rank, TOKEN_MATCH_BIT | run << 16 | dist-1, -(1+len) at
// an EOB, -(100+code) at an error, with errors classified in the
// reference's serial read order.
//
// Bound on the H100: integer operations. Each position runs two 14-step
// compare ladders, 16 plane-word bit extractions and a few shifts, about
// 150 integer ops for 8 bytes written (the two int32 outputs); the input
// is one byte per 8 positions. Design: one thread per (lane, tile, byte
// row q) reads its 9 window bytes once and decodes the 8 bit positions of
// that byte; the lane's meta row sits in shared memory (every thread of a
// block reads the same column at the same time, a broadcast). Neighbouring
// threads take neighbouring tiles, so the byte reads and the (L, 512, NT)
// stores coalesce. The TPU kernel's roll-based byte windows are plain
// indexed loads here.
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

__device__ __forceinline__ uint32_t rev8(uint32_t x) { return __brev(x) >> 24; }

__device__ __forceinline__ int rev_low16(int x, int k) {
  x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555);
  x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333);
  x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F);
  x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF);
  return sar_i(x, 16 - k);
}

// Bounds-ladder decode of a reversed window: code length, canonical index
// and whether the index is a live code (wave_prep.ladder_tables).
__device__ __forceinline__ void ladder(uint32_t v, const int* m, int sat, int pack, int nlive,
                                       int& ln, int& idx, bool& found) {
  uint32_t acc = 0;
#pragma unroll
  for (int l = 1; l < 15; ++l)
    if (v >= (uint32_t)m[sat + l]) acc += (uint32_t)m[pack + l];
  int a = (int)acc;
  int cnt = a >> 20;
  ln = 1 + cnt;
  int off = (a & 0xFFFFF) - shl_i(cnt, 16);
  idx = (int)shr_u(v, 31 - cnt) + off;
  found = idx < m[nlive];
}

__device__ __forceinline__ void decode_position(uint32_t vR, uint32_t vR2, int pos, const int* m,
                                                ErrCodes ec, int& delta, int& token) {
  // Litlen ladder with the class/rank accumulators riding the same compare
  // (wave_prep.class_ladder_tables); acc2/acc3 wrap like int32 in XLA.
  uint32_t acc = 0, acc2 = (uint32_t)m[MA_INIT2], acc3 = (uint32_t)m[MA_INIT3];
#pragma unroll
  for (int l = 1; l < 15; ++l) {
    if (vR >= (uint32_t)m[MA_LLSAT + l]) {
      acc += (uint32_t)m[MA_LLPACK + l];
      acc2 += (uint32_t)m[MA_LLP2 + l];
      acc3 += (uint32_t)m[MA_LLP3 + l];
    }
  }
  int a = (int)acc;
  int cnt = a >> 20;
  int ln = 1 + cnt;
  int off = (a & 0xFFFFF) - shl_i(cnt, 16);
  int lidx = (int)shr_u(vR, 31 - cnt) + off;
  bool lfound = lidx < m[MA_LLNLIVE];
  int lnb = shl_i(ln, 12);
  int lit_end = (int)((acc2 >> 16) & 0xFFFF) - lnb;
  int res_start = (int)(acc2 & 0xFFFF) - lnb;
  int lit_off = (int)((acc3 >> 16) & 0xFFFF) - lnb;
  int mrank_off = (int)(acc3 & 0xFFFF) - lnb;

  bool is_lit = lfound && lidx < lit_end;
  bool is_eob = lfound && lidx == m[MA_EOB];
  bool reserved_len = lfound && lidx >= res_start;
  bool is_match = lfound && !is_lit && !is_eob && !reserved_len;

  int lit_rank = lidx + lit_off;
  int mrank = (lidx + mrank_off) & 31;
  int mdesc = 0;
#pragma unroll
  for (int b = 0; b < 11; ++b) mdesc |= (int)((((uint32_t)m[MA_MW + b] >> mrank) & 1u) << b);
  int run_bits = is_match ? (mdesc & 7) : 0;
  int pay = mdesc >> 3;  // run base - 3
  int rev = (int)shr_u(vR, 32 - ln - run_bits);
  int run = (pay + 3) + rev_low16(rev & (shl_i(1, run_bits) - 1), run_bits);
  int d1 = ln + run_bits;
  uint32_t vD = shl_u(vR, d1) | shr_u(vR2, 32 - d1);

  int dln, didx;
  bool dfound;
  ladder(vD, m, MA_DSAT, MA_DPACK, MA_DNLIVE, dln, didx, dfound);
  int d5 = (didx > 0 ? didx : 0) & 31;
  int ds = 0;
#pragma unroll
  for (int b = 0; b < 5; ++b) ds |= (int)((((uint32_t)m[MA_DPERM + b] >> d5) & 1u) << b);
  int dist_bits = max((ds >> 1) - 1, 0);
  bool reserved_dist = ds >= 30;
  int dbase_m1 = ds < 4 ? ds : shl_i(2 + (ds & 1), dist_bits);
  int drev = (int)shr_u(vD, 32 - dln - dist_bits);
  int dist = dbase_m1 + 1 + rev_low16(drev & (shl_i(1, dist_bits) - 1), dist_bits);

  int bits = m[MA_PBITS];
  bool dist_empty = m[MA_DEMPTY] != 0;
  int end_len = pos + ln;
  int end_run = end_len + run_bits;  // run_bits is 0 outside match positions
  int end_dcode = end_run + dln;
  int end_all = end_dcode + dist_bits;

  // First failing read in the reference's serial order wins
  // (decode_pallas.py:254-262).
  int errc = 0;
  if (!lfound) errc = ec.end;
  else if (end_len > bits) errc = ec.end;
  else if (reserved_len) errc = ec.reserved_len;
  else if (is_match && end_run > bits) errc = ec.end;
  else if (is_match && dist_empty) errc = ec.empty_dist;
  else if (is_match && !dfound) errc = ec.end;
  else if (is_match && end_dcode > bits) errc = ec.end;
  else if (is_match && reserved_dist) errc = ec.reserved_dist;
  else if (is_match && end_all > bits) errc = ec.end;

  int adv = (is_match ? end_all : end_len) - pos;
  delta = errc != 0 ? SENT_ERR : (is_eob ? SENT_EOB : adv);
  int tok = is_lit ? lit_rank
                   : (TOKEN_MATCH_BIT | (min(max(run, 3), 258) << 16) |
                      min(max(dist - 1, 0), 65535));
  if (is_eob) tok = -(1 + ln);
  if (errc != 0) tok = -(100 + errc);
  token = tok;
}

// grid (L, 64, NT+1) uint8; meta (L, 128) int32; delta/token (L, 512, NT).
// Block: 128 tiles of one byte row q (blockIdx.y) of one lane (blockIdx.z).
__global__ void stage_a_kernel(const uint8_t* __restrict__ grid, const int* __restrict__ meta,
                               int* __restrict__ delta, int* __restrict__ token, int NT,
                               ErrCodes ec) {
  __shared__ int m[META_W];
  const int lane = blockIdx.z;
  const int q = blockIdx.y;
  for (int i = threadIdx.x; i < META_W; i += blockDim.x) m[i] = meta[(size_t)lane * META_W + i];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= NT) return;

  const size_t ncol = (size_t)NT + 1;
  const uint8_t* g = grid + (size_t)lane * 64 * ncol;
  uint32_t b[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    int bi = q + k;  // byte q+k of tile t, spilling into tile t+1
    b[k] = rev8(g[(size_t)(bi & 63) * ncol + t + (bi >> 6)]);
  }
  uint32_t u32a = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3];
  uint32_t u32b = (b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7];
  int* dout = delta + (size_t)lane * W_P * NT + t;
  int* tout = token + (size_t)lane * W_P * NT + t;
#pragma unroll 1
  for (int r = 0; r < 8; ++r) {
    // Reversed 32-bit windows: stream bit p at bit 31 of vR, p+32 of vR2.
    uint32_t vR = (u32a << r) | (b[4] >> (8 - r));
    uint32_t vR2 = (u32b << r) | (b[8] >> (8 - r));
    const int s = 8 * q + r;
    int d, tk;
    decode_position(vR, vR2, t * W_P + s, m, ec, d, tk);
    dout[(size_t)s * NT] = d;
    tout[(size_t)s * NT] = tk;
  }
}

}  // namespace

extern "C" int td_stage_a(const void* grid, const void* meta, void* delta, void* token, int L,
                          int NT, int err_end, int err_reserved_len, int err_empty_dist,
                          int err_reserved_dist, void* stream) {
  ErrCodes ec{err_end, err_reserved_len, err_empty_dist, err_reserved_dist};
  dim3 block(128);
  dim3 blocks((NT + 127) / 128, 64, L);
  stage_a_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(grid), static_cast<const int*>(meta), static_cast<int*>(delta),
      static_cast<int*>(token), NT, ec);
  return (int)cudaGetLastError();
}
