// Emit body (K10): a lane's token info -> packed DEFLATE body words.
//
// Replaces tpu_deflate/codec/emit_pallas.py:_emit_kernel (called from
// _emit_jit). Inputs per lane, S positions (S a multiple of 4): sym, flags
// (bit 0 token, bit 1 match), leb, lev, dsym, deb, dev (int32), the litlen
// (288) and distance (30) code tables packed len << 16 | revcode, and the
// header's bit length. Every position is two slots, as in the reference's
// XLA emit: (litlen code | length extra << code length) and (distance code
// | distance extra << code length), of at most 20 and 28 bits. The slots'
// bit offsets are an exclusive scan that starts at the header's length.
// Outputs: words (L, 22528) int32 holding uint32 bit patterns, zero-filled
// by the caller, and body_end (L,) = header bits + body bits. A word index
// at or past 22528 is dropped (never written); body_end stays exact.
//
// Bound on the H100: memory traffic, seven 4-byte fields read per position
// (117 MB for a batch of 64 lanes x 65536) and the words written. One
// block per lane, walking the lane serially, filled 64 of the 132 SMs and
// kept too few loads in flight. Here a lane is cut into segments of SEG =
// 4096 positions, one block each (1024 blocks for 64 lanes, two resident
// per SM). A thread takes 2 x 4 consecutive positions, issues its 14
// 16-byte loads (one per field and group) before it reads a code table,
// builds the positions' slots with the tables in shared memory, and one
// block scan gives the slots' offsets inside the segment. The slots are
// ORed (shared-memory atomics; slots hold disjoint bits, so OR is the sum)
// into a word buffer whose bit 0 is the segment's first bit, 24 KiB for
// the worst case of 4096 x 48 bits. The segment's first bit in the lane
// comes from a decoupled look-back over the lane's earlier segments (a
// status word per (lane, segment): aggregate, then inclusive prefix), and
// the block takes its segment from an atomic ticket, so it waits only on
// segments whose blocks already run. The buffer goes out funnel-shifted
// to that bit: words the segment alone covers as plain coalesced stores,
// its first and last word, which neighbouring segments may share, with
// atomicOr.
//
// The loads are not staged through cp.async or TMA. A persistent variant
// that kept the next segment's fields in flight with cp.async (a 112 KiB
// stage per block, so one block per SM) ran slower than this design on the
// H100: each segment's serial chain (table fetch, scan, look-back, stores)
// then had nothing beside it, where two resident blocks here overlap one
// block's chain with the other's loads (PERF.md, section 6).
//
// A slot is held as value | 1 << bits (one register), which needs value <
// 2^bits <= 2^31: true of every slot the encoder builds. A segment holding
// any other slot, or more bits than the buffer, is placed slot by slot with
// atomicOr into device memory once its first bit is known.
//
// The header and EOB (header_eob_kernel, td_header_eob) replace
// tpu_deflate/codec/emit_pallas.py:271 _header_eob_words, which the port
// built as a second (L, 22529) int64 grid, 11.5 MB a 64-lane batch, ORed
// into the body's words by some twenty eager ops. One 128-thread block a
// lane takes each header slot's bit offset by a block scan of the slot
// lengths (H = 384 slots, 3 consecutive slots a thread), places every slot
// of more than 0 bits at its offset and the EOB at the body's end, each
// as a low and a high word part, straight into K10's words with atomicOr
// (neighbouring slots share words): a part past the grid is dropped, and
// a part that is 0 (the high part of a slot that ends inside its first
// word) is not written. It writes total bits = body end + EOB bits. Bound
// on the H100: the header's bytes, some 4.6 KB a lane read and at most
// 3 KB written, about 0.2 us for a 64-lane batch; the launch dominates.
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

struct Fields {
  const int *sym, *flags, *leb, *lev, *dsym, *deb, *dev;
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

__device__ __forceinline__ int comp(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ int4 ld4(const int* p) { return __ldg(reinterpret_cast<const int4*>(p)); }

__global__ void __launch_bounds__(E_THREADS, 2)
    emit_kernel(Fields fld, const int* __restrict__ llc, const int* __restrict__ dc,
                const int* __restrict__ hdr_bits, int* __restrict__ words,
                int* __restrict__ body_end, unsigned long long* __restrict__ status,
                int* __restrict__ ticket, int S, int nseg) {
  __shared__ uint32_t buf[BUF_WORDS];
  __shared__ int ll_tab[N_LL];
  __shared__ int d_tab[N_D];
  __shared__ int wsum[2][E_WARPS];
  __shared__ int s_ticket, s_start, s_direct;
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
  for (int i = tid; i < N_LL; i += E_THREADS) ll_tab[i] = llc[lane * N_LL + i];
  if (tid < N_D) d_tab[tid] = dc[lane * N_D + tid];

  // Both groups' fields, loaded before the tables are read.
  const size_t row = (size_t)lane * S;
  int4 in[2][7];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int p = seg * SEG + g * GROUP + 4 * tid;
    const bool ok = p < S;
    const size_t i = row + (ok ? p : 0);
    const int* src[7] = {fld.flags, fld.sym, fld.leb, fld.lev, fld.dsym, fld.deb, fld.dev};
#pragma unroll
    for (int k = 0; k < 7; ++k) in[g][k] = ok ? ld4(src[k] + i) : make_int4(0, 0, 0, 0);
  }
  __syncthreads();  // code tables ready

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
  if (wid == 0) {
    const int start = look_back(status + (size_t)lane * nseg, seg, agg, hdr_bits[lane]);
    if (lid == 0) {
      s_start = start;
      if (seg == nseg - 1) body_end[lane] = start + agg;
    }
  }
  __syncthreads();
  const int start = s_start;
  uint32_t* out = reinterpret_cast<uint32_t*>(words) + (size_t)lane * EMIT_WORDS;
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

constexpr int HE_THREADS = 128;

// OR a value of at most 32 bits (held in int64, as the plain version holds
// it) at bit offset off of a lane's words: low part at word off / 32, high
// part at the next; parts past the grid are dropped, parts of 0 skipped.
__device__ __forceinline__ void or_slot(int* __restrict__ row, long long off, long long val) {
  const long long w = off >> 5;
  const int sh = (int)(off & 31);
  const uint32_t lo = (uint32_t)((unsigned long long)val << sh);
  const uint32_t hi = sh ? (uint32_t)(val >> (32 - sh)) : 0u;
  if (lo && w >= 0 && w < EMIT_WORDS) atomicOr(reinterpret_cast<unsigned*>(row + w), lo);
  if (hi && w + 1 >= 0 && w + 1 < EMIT_WORDS) atomicOr(reinterpret_cast<unsigned*>(row + w + 1), hi);
}

__global__ void __launch_bounds__(HE_THREADS)
    header_eob_kernel(const long long* __restrict__ hv, const int* __restrict__ hb, const long long* __restrict__ ev,
                      const int* __restrict__ eb, const int* __restrict__ body_end, int* __restrict__ words,
                      int* __restrict__ total_bits, int H) {
  __shared__ long long wsum[HE_THREADS / 32];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int lid = tid & 31, wid = tid >> 5;
  const int per = (H + HE_THREADS - 1) / HE_THREADS;
  const int j0 = min(H, tid * per), j1 = min(H, j0 + per);
  const int* bits = hb + (size_t)lane * H;
  const long long* vals = hv + (size_t)lane * H;
  int* row = words + (size_t)lane * EMIT_WORDS;
  long long mine = 0;
  for (int j = j0; j < j1; ++j) mine += bits[j];
  // Exclusive scan of the threads' bit counts: the offset of slot j0.
  long long incl = mine;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const long long n = __shfl_up_sync(0xffffffffu, incl, s);
    if (lid >= s) incl += n;
  }
  if (lid == 31) wsum[wid] = incl;
  __syncthreads();
  long long off = incl - mine;
  for (int w = 0; w < wid; ++w) off += wsum[w];
  for (int j = j0; j < j1; ++j) {
    const int b = bits[j];
    if (b > 0) or_slot(row, off, vals[j]);
    off += b;
  }
  if (tid == 0) {
    const int end = body_end[lane], e = eb[lane];
    if (e > 0) or_slot(row, end, ev[lane]);
    total_bits[lane] = (int)((uint32_t)end + (uint32_t)e);
  }
}

}  // namespace

// hv (L, H) int64 and hb (L, H) int32 the header slots, ev (L,) int64 and
// eb (L,) int32 the EOB, body_end (L,) int32 (K10's): the header placed
// from bit 0 and the EOB at body_end, ORed into words (L, 22528) int32 in
// place; total_bits (L,) int32 out.
extern "C" int td_header_eob(const void* hv, const void* hb, const void* ev, const void* eb, const void* body_end,
                             void* words, void* total_bits, int L, int H, void* stream) {
  header_eob_kernel<<<L, HE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(hv), static_cast<const int*>(hb), static_cast<const long long*>(ev),
      static_cast<const int*>(eb), static_cast<const int*>(body_end), static_cast<int*>(words),
      static_cast<int*>(total_bits), H);
  return (int)cudaGetLastError();
}

// scratch: L * nseg status words (uint64) then the ticket counter, all 0.
extern "C" int td_emit_body(const void* sym, const void* flags, const void* leb, const void* lev,
                            const void* dsym, const void* deb, const void* dev, const void* llc,
                            const void* dc, const void* hdr_bits, void* words, void* body_end,
                            void* scratch, int L, int S, void* stream) {
  const int nseg = (S + SEG - 1) / SEG;
  Fields fld{static_cast<const int*>(sym),  static_cast<const int*>(flags),
             static_cast<const int*>(leb),  static_cast<const int*>(lev),
             static_cast<const int*>(dsym), static_cast<const int*>(deb),
             static_cast<const int*>(dev)};
  auto* status = static_cast<unsigned long long*>(scratch);
  emit_kernel<<<L * nseg, E_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      fld, static_cast<const int*>(llc), static_cast<const int*>(dc),
      static_cast<const int*>(hdr_bits), static_cast<int*>(words), static_cast<int*>(body_end),
      status, reinterpret_cast<int*>(status + (size_t)L * nseg), S, nseg);
  return (int)cudaGetLastError();
}
