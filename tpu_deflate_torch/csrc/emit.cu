// The emit (K10): a lane's token info -> its DEFLATE block's packed words,
// header, body and EOB, in one launch a batch; with routing on, the same
// launch also picks each lane's block strategy and swaps in the fixed codes.
//
// Replaces tpu_deflate/codec/emit_pallas.py:_emit_kernel (:67, called from
// _emit_jit) and :271 _header_eob_words (emit_device_pallas, :294), and
// with routing on tpu_deflate/codec/encode_jax.py:575 route_strategies and
// :619 _apply_route (called from _plan_codes, :909). Inputs per lane, S
// positions (S a multiple of 4): sym, flags (bit 0 token, bit 1 match),
// leb, lev, dsym, deb, dev (int32); the litlen (288) and distance (30) code
// tables packed len << 16 | revcode; H header slots (int64 values, int32
// bit counts) and the EOB (int64 value, int32 bit count). Every position
// is two slots, as in the reference's XLA emit: (litlen code | length
// extra << code length) and (distance code | distance extra << code
// length), of at most 20 and 28 bits. The header's slots sit from bit 0;
// the body's slots follow at an exclusive scan that starts at the header's
// length (the sum of its slots' bits); the EOB follows the body. Outputs:
// words (L, 22528) int32 holding uint32 bit patterns, zero-filled by the
// caller, and total_bits (L,) = header + body + EOB bits. A word index at
// or past 22528 is dropped (never written); the bit counts stay exact.
//
// Routing (ll_hist not null): each lane's stored / fixed / dynamic bit
// costs from its token histograms (288 litlen + 30 distance symbols), its
// planned code lengths, the planned header's length and its member length,
//   dynamic = header bits + sum(hist * len) + extras + ll_len[256] (EOB),
//   fixed   = 3 + sum(hist * fixed len) + extras + 7,
//   stored  = 8 * (len + 5 * ceil(len / 65535) + 1),
// in uint32 sums that wrap as the reference's int32 sums do, and the
// choice in the reference's tie order: STORED only where strictly below
// both, then FIXED only where strictly below dynamic. A lane routed FIXED
// is emitted with the fixed code tables, header bfinal | 2 in 3 bits and
// the EOB 0 in 7 bits; every other lane with its own. Segment 0's block
// writes the choice and the three costs. Nothing is written into the
// inputs.
//
// Bound on the H100: memory traffic, seven 4-byte fields read per position
// (117 MB for a batch of 64 lanes x 65536) and the words written. A lane
// is cut into segments of SEG = 4096 positions, one 512-thread block each
// (1024 blocks for 64 lanes, two resident per SM, which caps a thread at 64
// registers). A block takes its segment from an atomic ticket, puts the
// lane's own tables in shared memory and, routing, sums each symbol's
// terms (count x extra bits, x planned length, x fixed length: some 2.5 KB
// a lane, from L2 after the lane's first block) into warp partials; in
// segment 0 it sums the header slots' bits the same way. Then it issues
// the first half of its field loads (7 16-byte loads a thread: 4
// consecutive positions of each field) and crosses a barrier, behind which
// every thread folds the partials into the lane's costs and choice: each
// of a lane's 16 blocks routes the lane itself, and a block routed FIXED
// puts the fixed tables in shared memory. Then the second half of the
// loads. The routing is summed before the fields are in registers: with
// all 56 of the fields' registers live its terms spilled, and the launch
// took some 10 us longer on the H100 (PERF.md, section 6); the first
// half's loads fly during the barrier and the fold. The positions' slots
// are built with the chosen tables, and one block scan gives their offsets
// inside the segment. The slots are ORed (shared-memory atomics; slots
// hold disjoint bits, so OR is the sum) into a word buffer whose bit 0 is
// the segment's first bit, 24 KiB for the worst case of 4096 x 48 bits.
// The segment's first bit in the lane comes from a decoupled look-back over
// the lane's earlier segments (a status word per (lane, segment):
// aggregate, then inclusive prefix), so a block waits only on segments
// whose blocks already run; segment 0 starts at the header's length. The
// buffer goes out funnel-shifted to that bit: words the segment alone
// covers as plain coalesced stores, its first and last word, which
// neighbouring segments may share, with atomicOr.
//
// The header and EOB cost the blocks that place them a few atomics: warps
// 1-15 of segment 0's block place the header slots (each a low and a high
// word part at its offset from the warp partials and a warp scan) while
// warp 0 publishes the segment's prefix; the last segment's block places
// the EOB at the body's end; both with atomicOr and both before the block
// may return early. The header ends where segment 0 starts and the EOB
// starts where the body ends, so they meet only words that the segments
// write with atomicOr (a segment's first and last word) or not at all
// (past the body), never a word a segment stores plainly. Parts past the
// grid are dropped and parts of 0 are not written.
//
// The fields are not staged through cp.async or TMA. A persistent variant
// that kept the next segment's fields in flight with cp.async (a 112 KiB
// stage per block, so one block per SM) ran slower than this design on the
// H100: each segment's serial chain (table fetch, scan, look-back, stores)
// then had nothing beside it, where two resident blocks here overlap one
// block's chain with the other's loads (PERF.md, section 6).
//
// A slot is held as value | 1 << bits (one register), which needs value <
// 2^bits <= 2^31: true of every slot the encoder builds. A segment holding
// any other slot, or more bits than the buffer, is placed slot by slot with
// atomicOr into device memory once its first bit is known (the direct
// path).
#include "td_common.cuh"
#include "td_lookback.cuh"
#include "td_scan.cuh"

namespace {

using namespace td;

constexpr int EMIT_WORDS = 176 * 128;
constexpr int N_LL = 288;
constexpr int N_D = 30;
constexpr int SEG = 4096;                       // positions per segment (codec/emit.py EMIT_SEGMENT)
constexpr int E_THREADS = 512;
constexpr int E_WARPS = E_THREADS / 32;
constexpr int GROUP = SEG / 2;                  // a thread's group g holds GROUP g + 4 tid + {0..3}
constexpr int BUF_WORDS = SEG * 48 / 32 + 1;    // + 1: the funnel shift reads one past the end
constexpr int ROUTE_FIXED = 1, ROUTE_STORED = 2;

struct Fields {
  const int *sym, *flags, *leb, *lev, *dsym, *deb, *dev;
};

// Each lane's code tables, its H header slots and its EOB.
struct Block {
  const int *llc, *dc;
  const long long* hv;
  const int* hb;
  const long long* ev;
  const int* eb;
  int H;
};

// The routing's inputs and outputs; ll_hist null: routing off (every lane
// keeps its own tables, header and EOB).
struct Route {
  const int *ll_hist, *d_hist, *ll_len, *d_len, *hdr_bits, *lengths, *fix_ll, *fix_d;
  const long long* final;  // null: every lane final
  int* costs;              // (4, L): choice, dynamic, fixed and stored bits
};

// The two slots of one position: (value, bit count) each.
struct Slots {
  uint32_t va, vb;
  int ba, bb;
};

__device__ __forceinline__ Slots make_slots(int f, int sym, int leb, int lev, int dsym, int deb,
                                            int dev, const int* ll_tab, const int* d_tab) {
  Slots s;
  const bool tok = f & 1;
  const bool match = f & 2;
  const int ll = tok ? ll_tab[min(max(sym, 0), N_LL - 1)] : 0;
  const int b0 = ll >> 16;
  s.ba = b0;
  s.bb = 0;
  s.va = (uint32_t)(ll & 0xFFFF);
  s.vb = 0u;
  if (match) {
    const int dd = d_tab[min(max(dsym, 0), N_D - 1)];
    const int b2 = dd >> 16;
    s.va |= shl_u((uint32_t)lev, b0);
    s.ba += leb;
    s.vb = (uint32_t)(dd & 0xFFFF) | shl_u((uint32_t)dev, b2);
    s.bb = b2 + deb;
  }
  return s;
}

// value | 1 << bits, or 0 where the slot does not fit that form. A slot of
// 0 bits is never written, so its value is dropped.
__device__ __forceinline__ uint32_t pack_slot(uint32_t v, int b) {
  if (b == 0) return 1u;
  if (b < 0 || b > 31 || (v >> b) != 0u) return 0u;
  return v | (1u << b);
}

__device__ __forceinline__ int packed_bits(uint32_t p) { return 31 - __clz(p); }

// OR a slot's word parts into words [0, limit) of dst at bit offset off.
__device__ __forceinline__ void or_slot(uint32_t* dst, int limit, int off, uint32_t v) {
  const int w = off >> 5;
  const int sh = off & 31;
  const uint32_t lo = v << sh;
  const uint32_t hi = sh ? v >> (32 - sh) : 0u;
  if (lo && w >= 0 && w < limit) atomicOr(&dst[w], lo);
  if (hi && w + 1 >= 0 && w + 1 < limit) atomicOr(&dst[w + 1], hi);
}

// OR a header or EOB value of at most 32 bits (held in int64, as the plain
// version holds it) at bit offset off of a lane's words: low part at word
// off / 32, high part at the next; parts past the grid are dropped, parts
// of 0 skipped.
__device__ __forceinline__ void or_value(uint32_t* row, long long off, long long val) {
  const long long w = off >> 5;
  const int sh = (int)(off & 31);
  const uint32_t lo = (uint32_t)((unsigned long long)val << sh);
  const uint32_t hi = sh ? (uint32_t)(val >> (32 - sh)) : 0u;
  if (lo && w >= 0 && w < EMIT_WORDS) atomicOr(&row[w], lo);
  if (hi && w + 1 >= 0 && w + 1 < EMIT_WORDS) atomicOr(&row[w + 1], hi);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The bits of thread tid's header slots: the threads of warps 1-15 take
// H / 480 (rounded up) consecutive slots each, warp 0's none (it runs the
// look-back while they place them).
__device__ __forceinline__ int header_bits(const Block& blk, int lane, int tid) {
  if (tid < 32) return 0;
  const int per = (blk.H + E_THREADS - 33) / (E_THREADS - 32);
  const int j0 = min(blk.H, (tid - 32) * per), j1 = min(blk.H, j0 + per);
  int bits = 0;
  for (int j = j0; j < j1; ++j) bits += blk.hb[(size_t)lane * blk.H + j];
  return bits;
}

__device__ __forceinline__ int comp(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ int4 ld4(const int* p) { return __ldg(reinterpret_cast<const int4*>(p)); }

__global__ void __launch_bounds__(E_THREADS, 2)
    emit_kernel(Fields fld, Block blk, Route rt, int* __restrict__ words, int* __restrict__ total_bits,
                unsigned long long* __restrict__ status, int* __restrict__ ticket, int L, int S, int nseg) {
  __shared__ uint32_t buf[BUF_WORDS];
  __shared__ int ll_tab[N_LL];
  __shared__ int d_tab[N_D];
  __shared__ int wsum[2][E_WARPS];
  __shared__ uint32_t part[4][E_WARPS];
  __shared__ long long s_ev, s_final;
  __shared__ int s_ticket, s_start, s_direct, s_hdr, s_len, s_eob_len, s_eb;
  const int tid = threadIdx.x;
  const int lid = tid & 31;
  const int wid = tid >> 5;
  if (tid == 0) {
    s_ticket = atomicAdd(ticket, 1);
    s_direct = 0;
  }
  for (int i = tid; i < BUF_WORDS; i += E_THREADS) buf[i] = 0u;
  __syncthreads();
  const int lane = s_ticket / nseg;
  const int seg = s_ticket - lane * nseg;
  const bool routing = rt.ll_hist != nullptr;

  // Before the fields: the lane's own tables; routing, symbol tid's terms
  // (tid < 318: count x extra bits, x planned length, x fixed length; tid
  // 256's planned length is the EOB code's) and the lane's planned header
  // bits and member length (tid 318); the EOB and bfinal (tid 319); in
  // segment 0's block, the bits of the header slots of the threads of
  // warps 1-15. Each sum goes to a warp partial. No field is in a register
  // yet: beside the fields' 56 registers the routing's terms spill.
  if (tid < N_LL) ll_tab[tid] = blk.llc[lane * N_LL + tid];
  if (tid < N_D) d_tab[tid] = blk.dc[lane * N_D + tid];
  if (routing) {
    // uint32 sums wrap as the reference's int32 sums do.
    uint32_t ext = 0, dsum = 0, fsum = 0;
    if (tid < N_LL + N_D) {
      const int k = tid - N_LL;
      const uint32_t h = tid < N_LL ? rt.ll_hist[lane * N_LL + tid] : rt.d_hist[lane * N_D + k];
      const uint32_t len = tid < N_LL ? rt.ll_len[lane * N_LL + tid] : rt.d_len[lane * N_D + k];
      const uint32_t extra = tid < N_LL ? (tid >= 265 && tid <= 284 ? (uint32_t)(tid - 261) >> 2 : 0u)
                                        : (k >= 4 ? (uint32_t)((k >> 1) - 1) : 0u);
      const uint32_t flen = tid < 144 ? 8u : (tid < 256 ? 9u : (tid < 280 ? 7u : (tid < N_LL ? 8u : 5u)));
      ext = h * extra;
      dsum = h * len;
      fsum = h * flen;
      if (tid == 256) s_eob_len = (int)len;
    } else if (tid == N_LL + N_D) {
      s_hdr = rt.hdr_bits[lane];
      s_len = rt.lengths[lane];
    }
    ext = warp_sum(ext);
    dsum = warp_sum(dsum);
    fsum = warp_sum(fsum);
    if (lid == 0) {
      part[0][wid] = ext;
      part[1][wid] = dsum;
      part[2][wid] = fsum;
    }
  }
  if (tid == N_LL + N_D + 1) {
    s_eb = blk.eb[lane];
    s_ev = blk.ev[lane];
    s_final = rt.final ? rt.final[lane] : 1;
  }
  if (seg == 0) {
    const int mine = (int)warp_sum((uint32_t)header_bits(blk, lane, tid));
    if (lid == 0) part[3][wid] = (uint32_t)mine;
  }
  int4 in[2][7];
  const int* src[7] = {fld.flags, fld.sym, fld.leb, fld.lev, fld.dsym, fld.deb, fld.dev};
  const size_t row = (size_t)lane * S;
  auto load_group = [&](int g) {
    const int p = seg * SEG + g * GROUP + 4 * tid;
    const bool ok = p < S;
    const size_t i = row + (ok ? p : 0);
#pragma unroll
    for (int k = 0; k < 7; ++k) in[g][k] = ok ? ld4(src[k] + i) : make_int4(0, 0, 0, 0);
  };
  load_group(0);    // in flight across the barrier and the fold
  __syncthreads();  // own tables and the partial sums ready

  int choice = 0;
  if (routing) {
    uint32_t e = 0, ds = 0, fs = 0;
#pragma unroll
    for (int w = 0; w < E_WARPS; ++w) {
      e += part[0][w];
      ds += part[1][w];
      fs += part[2][w];
    }
    const int d = (int)((uint32_t)s_hdr + ds + e + (uint32_t)s_eob_len);
    const int f = (int)(3u + fs + e + 7u);
    // 8 * (len + 5 * ceil(len / 65535) + 1), the ceiling as a floor
    // division of len + 65534 (also for a negative len, as PyTorch's //).
    const int num = (int)((uint32_t)s_len + 65534u);
    const int q = num / 65535 - (num % 65535 != 0 && num < 0);
    const int st = (int)(8u * ((uint32_t)s_len + 5u * (uint32_t)q + 1u));
    choice = st < min(d, f) ? ROUTE_STORED : (f < d ? ROUTE_FIXED : 0);
    if (seg == 0 && tid == 0) {
      rt.costs[lane] = choice;
      rt.costs[L + lane] = d;
      rt.costs[2 * L + lane] = f;
      rt.costs[3 * L + lane] = st;
    }
  }
  const bool fixed = choice == ROUTE_FIXED;  // the same in every thread of the block
  if (fixed) {
    if (tid < N_LL) ll_tab[tid] = rt.fix_ll[tid];
    if (tid < N_D) d_tab[tid] = rt.fix_d[tid];
  }
  // The header's length: 3 bits for a FIXED lane, else the sum of its
  // slots' bits; segment 0 starts there.
  int header_len = 3;
  if (seg == 0 && !fixed) {
    header_len = 0;
#pragma unroll
    for (int w = 0; w < E_WARPS; ++w) header_len += (int)part[3][w];
  }

  load_group(1);
  if (fixed) __syncthreads();  // the fixed tables ready (a FIXED lane is a short one: rare)

  uint32_t pk[2][8];  // packed slots a, b of the 4 positions of each group
  int tot[2] = {0, 0};
  bool direct = false;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Slots s = make_slots(comp(in[g][0], k), comp(in[g][1], k), comp(in[g][2], k),
                                 comp(in[g][3], k), comp(in[g][4], k), comp(in[g][5], k),
                                 comp(in[g][6], k), ll_tab, d_tab);
      pk[g][2 * k] = pack_slot(s.va, s.ba);
      pk[g][2 * k + 1] = pack_slot(s.vb, s.bb);
      direct |= (pk[g][2 * k] == 0u) | (pk[g][2 * k + 1] == 0u);
      tot[g] += s.ba + s.bb;
    }
  }
  if (direct) s_direct = 1;

  // Block scan of the two group totals: offsets inside the segment.
  const int inc0 = warp_inclusive(tot[0], Sum());
  const int inc1 = warp_inclusive(tot[1], Sum());
  if (lid == 31) {
    wsum[0][wid] = inc0;
    wsum[1][wid] = inc1;
  }
  __syncthreads();
  if (wid == 0) {
    const int a = warp_inclusive(lid < E_WARPS ? wsum[0][lid] : 0, Sum());
    const int b = warp_inclusive(lid < E_WARPS ? wsum[1][lid] : 0, Sum());
    if (lid < E_WARPS) {
      wsum[0][lid] = a;
      wsum[1][lid] = b;
    }
  }
  __syncthreads();
  const int total0 = wsum[0][E_WARPS - 1];
  const int agg = total0 + wsum[1][E_WARPS - 1];
  const int off0 = (wid ? wsum[0][wid - 1] : 0) + inc0 - tot[0];
  const int off1 = total0 + (wid ? wsum[1][wid - 1] : 0) + inc1 - tot[1];
  const bool in_buf = !s_direct && agg <= 32 * (BUF_WORDS - 1);

  if (in_buf) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      int off = g ? off1 : off0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int b = packed_bits(pk[g][k]);
        if (b > 0) or_slot(buf, BUF_WORDS, off, pk[g][k] ^ (1u << b));
        off += b;
      }
    }
  }

  uint32_t* out = reinterpret_cast<uint32_t*>(words) + (size_t)lane * EMIT_WORDS;
  if (wid == 0) {
    const int start = look_back(status + (size_t)lane * nseg, seg, agg, header_len);
    if (lid == 0) {
      s_start = start;
      if (seg == nseg - 1) {
        // The EOB at the body's end (the fixed EOB is code 0 in 7 bits).
        const int end = start + agg;
        const int eb = fixed ? 7 : s_eb;
        if (eb > 0) or_value(out, end, fixed ? 0 : s_ev);
        total_bits[lane] = (int)((uint32_t)end + (uint32_t)eb);
      }
    }
  } else if (seg == 0 && fixed) {
    if (tid == 32) or_value(out, 0, s_final | 2);
  } else if (seg == 0) {
    // Warps 1-15 of segment 0's block place the header from bit 0 while
    // warp 0 publishes the segment's prefix: each slot at its offset (the
    // warp partials before this warp, then a warp scan of the threads'
    // bits).
    const int mine = header_bits(blk, lane, tid);
    const int incl = warp_inclusive(mine, Sum());
    long long off = incl - mine;
    for (int w = 1; w < wid; ++w) off += (int)part[3][w];
    const int per = (blk.H + E_THREADS - 33) / (E_THREADS - 32);
    const int j0 = min(blk.H, (tid - 32) * per), j1 = min(blk.H, j0 + per);
    for (int j = j0; j < j1; ++j) {
      const int b = blk.hb[(size_t)lane * blk.H + j];
      if (b > 0) or_value(out, off, blk.hv[(size_t)lane * blk.H + j]);
      off += b;
    }
  }
  __syncthreads();
  const int start = s_start;
  if (!in_buf) {
    // Slot by slot into device memory, from the fields again (the
    // registers that held them are free by now).
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int p = seg * SEG + g * GROUP + 4 * tid;
      if (p >= S) continue;
      int off = start + (g ? off1 : off0);
      const size_t i = row + p;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Slots s = make_slots(fld.flags[i + k], fld.sym[i + k], fld.leb[i + k],
                                   fld.lev[i + k], fld.dsym[i + k], fld.deb[i + k],
                                   fld.dev[i + k], ll_tab, d_tab);
        if (s.ba > 0) or_slot(out, EMIT_WORDS, off, s.va);
        if (s.bb > 0) or_slot(out, EMIT_WORDS, off + s.ba, s.vb);
        off += s.ba + s.bb;
      }
    }
    return;
  }
  if (agg <= 0) return;
  // Word k of the output, k in [0, nout), is bits [32k, 32k + 32) from the
  // segment's first word on: the buffer funnel-shifted by start & 31.
  const int sh = start & 31;
  const int w0 = start >> 5;
  const int nout = (sh + agg + 31) >> 5;
  for (int k = tid; k < nout; k += E_THREADS) {
    const int gw = w0 + k;
    if (gw < 0 || gw >= EMIT_WORDS) continue;
    const uint32_t v = __funnelshift_l(k ? buf[k - 1] : 0u, buf[k], sh);
    if (k == 0 || k == nout - 1) {
      if (v) atomicOr(&out[gw], v);
    } else {
      out[gw] = v;
    }
  }
}

}  // namespace

// Fields sym .. dev (L, S) int32; llc (L, 288), dc (L, 30) int32; hv (L, H)
// int64, hb (L, H) int32 the header slots; ev (L,) int64, eb (L,) int32
// the EOB. Routing (ll_hist not null): ll_hist, ll_len (L, 288), d_hist,
// d_len (L, 30), hdr_bits, lengths (L,) int32, the fixed tables fix_ll
// (288), fix_d (30) int32, final (L,) int64 (null: every lane final);
// costs (4, L) int32 out (choice, dynamic, fixed, stored). words (L,
// 22528) int32 zero-filled, total_bits (L,) int32 out. scratch: L * nseg
// status words (uint64) then the ticket counter, all 0.
extern "C" int td_emit(const void* sym, const void* flags, const void* leb, const void* lev, const void* dsym,
                       const void* deb, const void* dev, const void* llc, const void* dc, const void* hv,
                       const void* hb, const void* ev, const void* eb, const void* ll_hist, const void* d_hist,
                       const void* ll_len, const void* d_len, const void* hdr_bits, const void* lengths,
                       const void* fix_ll, const void* fix_d, const void* final, void* words, void* total_bits,
                       void* costs, void* scratch, int L, int S, int H, void* stream) {
  const int nseg = (S + SEG - 1) / SEG;
  Fields fld{static_cast<const int*>(sym),  static_cast<const int*>(flags),
             static_cast<const int*>(leb),  static_cast<const int*>(lev),
             static_cast<const int*>(dsym), static_cast<const int*>(deb),
             static_cast<const int*>(dev)};
  Block blk{static_cast<const int*>(llc), static_cast<const int*>(dc), static_cast<const long long*>(hv),
            static_cast<const int*>(hb),  static_cast<const long long*>(ev), static_cast<const int*>(eb), H};
  Route rt{static_cast<const int*>(ll_hist), static_cast<const int*>(d_hist), static_cast<const int*>(ll_len),
           static_cast<const int*>(d_len),   static_cast<const int*>(hdr_bits), static_cast<const int*>(lengths),
           static_cast<const int*>(fix_ll),  static_cast<const int*>(fix_d), static_cast<const long long*>(final),
           static_cast<int*>(costs)};
  auto* status = static_cast<unsigned long long*>(scratch);
  emit_kernel<<<L * nseg, E_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      fld, blk, rt, static_cast<int*>(words), static_cast<int*>(total_bits), status,
      reinterpret_cast<int*>(status + (size_t)L * nseg), L, S, nseg);
  return (int)cudaGetLastError();
}
