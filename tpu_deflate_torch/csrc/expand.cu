// Expand (K5): a lane's token stream -> per-position literal byte or
// match source.
//
// Replaces tpu_deflate/codec/resolve_pallas.py:_expand_kernel (called
// from _expand_jit). tok (L, 65536) int32 front-compacted tokens (-1
// padding; a literal is its byte, a match has value >= 256 with run in
// bits 16..25 and dist-1 in the low 16 bits). Outputs, as the TPU kernel's:
//   y0  (L, 65536): literal byte at literal positions, -1 at match
//       positions to resolve, 0 past the stream end and at error positions;
//   src (L, 65536): p - k d at match positions, with A the start of the
//       maximal constant-distance region holding p (a literal breaks a
//       region), q = (p - A) / d and k = max(min(q + 1, 32768 / d), 1);
//       p itself elsewhere;
//   summ (L, 8): row 0 the first error position (65536 if none), row 1
//       the total output (may exceed 65536 for corrupt input; positions
//       past 65536 are dropped), row 2 the match positions left to resolve.
// An error is a match start with dist-1 >= 0x8000 (the per-position
// distance keeps 15 bits) or a match position whose uncapped source
// A - d + (p - A) mod d lies before the available history (-hist).
//
// Bound on the H100: memory traffic, one 4-byte read per token slot and
// two 4-byte writes per position (about 0.79 MB per lane). The TPU kernel
// moves records with log-shift displacement rounds and fills runs with
// running-max scans over all positions, because it cannot scatter; its
// float32 quotients and their corrections become integer division.
//
// Design: one block of 512 threads per lane, two blocks per SM (104 KiB of
// shared memory each, so the carveout is set to its maximum). A thread
// takes 16 consecutive token slots (four 16-byte loads, the next chunk's
// in flight) or 16 consecutive positions, with a thread-serial pass inside
// and one block scan per chunk of 8192: 8 scans a pass, where a scan per
// 1024 slots cost 64. The lane's positions are done in two halves of
// 32768, so the record table is 64 KiB and two blocks share an SM. For a
// half:
//   Pass 1 (tokens): a sum scan of token sizes gives each token's start.
//   A token writes one record at its start if that lies in the half (0 =
//   none; a match (dist-1 & 0x7FFF) + 1, which is its per-position
//   distance; a literal 0x8100 | byte), a bit per oversized-distance
//   match start, and, for every 16-position boundary b of the half with
//   start < b <= start + run, its record as the cover of position b - 1
//   (`cov`): about one store per 16 positions instead of one per position.
//   The first half stops after the chunk whose tokens reach past it; the
//   second half starts from that chunk and reads to the end (the total
//   needs every size).
//   Pass 2 (positions): a thread starts from the cover of its first
//   position's predecessor, takes each record it meets, and so knows each
//   position's distance (0 at literals and past the stream) and the
//   region breaks (distance differs from the previous position's, or 0);
//   a block max-scan of each thread's last break gives A at its first
//   position. (p - A) / d is divided at most once a thread and then
//   stepped; 32768 / d only where the cap on k binds. y0 and src of a
//   position travel packed in one word through a 2 KiB stage per warp, so
//   that each store instruction writes 512 contiguous bytes (stored by the
//   thread that computed them, an instruction's 16-byte pieces lie 64 bytes
//   apart, and on an H100 the stores were then the kernel's largest
//   cost).
#include "td_common.cuh"
#include "td_scan.cuh"

namespace {

using namespace td;

constexpr int N_POS = 65536;
constexpr int W_CAP = 32768;
constexpr int THREADS = 512;
constexpr int PER = 16;                    // token slots or positions per thread and chunk
constexpr int CHUNK = THREADS * PER;       // 8192
constexpr int N_CHUNKS = N_POS / CHUNK;    // token chunks of a lane
constexpr int HALF = N_POS / 2;            // positions per half
constexpr int HALF_CHUNKS = HALF / CHUNK;  // position chunks of a half
constexpr int LIT = 0x8100;                // a literal record: LIT | byte
constexpr int SMEM_BYTES = HALF * 2 + (HALF / PER) * 2 + (HALF / 32) * 4 + CHUNK * 4;

__device__ __forceinline__ void load_chunk(const int* __restrict__ src, bool vec, int4* q) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = vec ? reinterpret_cast<const int4*>(src)[k]
               : make_int4(src[4 * k], src[4 * k + 1], src[4 * k + 2], src[4 * k + 3]);
}

// y0 (-1..255) and src (-32768..65535) of one position in one word.
__device__ __forceinline__ uint32_t pack_out(int y, int s) {
  return (uint32_t)(y + 1) << 17 | (uint32_t)(s + W_CAP);
}
__device__ __forceinline__ int out_y(uint32_t w) { return (int)(w >> 17) - 1; }
__device__ __forceinline__ int out_src(uint32_t w) { return (int)(w & 0x1FFFF) - W_CAP; }

// Where thread t's group g of four positions lies in its warp's staging
// slots: 4 t + g, with g XORed so that a store of one group by the warp,
// and a load of 32 consecutive slots, each meet every bank group four times.
__device__ __forceinline__ int swizzle(int t, int g) { return 4 * t + (g ^ ((t >> 1) & 3)); }

__device__ __forceinline__ int token_size(int v) {
  return v < 0 ? 0 : (v >= 256 ? (v >> 16) & 0x3FF : 1);
}

__global__ void __launch_bounds__(THREADS, 2)
    expand_kernel(const int* __restrict__ tok, int* __restrict__ y0, int* __restrict__ src,
                  int* __restrict__ summ, int hist) {
  extern __shared__ __align__(16) uint16_t ent[];  // HALF records
  uint16_t* cov = ent + HALF;                       // HALF / 16 covers of b - 1
  uint32_t* big = reinterpret_cast<uint32_t*>(cov + HALF / PER);
  uint4* stage = reinterpret_cast<uint4*>(big + HALF / 32);  // CHUNK packed outputs
  __shared__ int scratch[2][THREADS / 32];
  __shared__ int s_err, s_unres;
  const int t = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * N_POS;
  const int* trow = tok + row;
  const bool vec = (reinterpret_cast<uintptr_t>(tok) & 15) == 0;
  if (t == 0) {
    s_err = N_POS;
    s_unres = 0;
  }
  int parity = 0;
  int cross = N_CHUNKS;  // the chunk whose tokens reach the second half
  int pre_cross = 0;     // output bytes before it
  int total = 0;         // output bytes of the chunks read so far (the same in every thread)
  int a_carry = -1, err_pos = N_POS, unres = 0;

  for (int h = 0; h < 2; ++h) {
    const int lo = h * HALF, hi = lo + HALF;
    for (int i = t; i < HALF / 8; i += THREADS) reinterpret_cast<uint4*>(ent)[i] = make_uint4(0, 0, 0, 0);
    for (int i = t; i < HALF / 32; i += THREADS) big[i] = 0u;
    __syncthreads();

    // Pass 1: records, covers and big-distance bits of the half.
    int c = h == 0 ? 0 : cross;
    if (c < N_CHUNKS) total = h == 0 ? 0 : pre_cross;  // else the first half read every chunk
    int4 nx[4];
    if (c < N_CHUNKS) load_chunk(trow + c * CHUNK + PER * t, vec, nx);
    for (; c < N_CHUNKS; ++c) {
      int v[PER];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[4 * k] = nx[k].x;
        v[4 * k + 1] = nx[k].y;
        v[4 * k + 2] = nx[k].z;
        v[4 * k + 3] = nx[k].w;
      }
      if (c + 1 < N_CHUNKS) load_chunk(trow + (c + 1) * CHUNK + PER * t, vec, nx);
      int mine = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) mine += token_size(v[j]);
      int chunk_total;
      int start = total + block_exclusive<THREADS>(mine, Sum(), 0, scratch[parity], &chunk_total);
      parity ^= 1;
      // Padding and tokens that start past the half write nothing.
#pragma unroll
      for (int j = 0; j < PER && mine > 0 && start < hi; ++j) {
        const int x = v[j];
        const int size = token_size(x);
        if (size > 0 && start < hi) {
          const uint16_t e = x >= 256 ? (uint16_t)((x & 0x7FFF) + 1) : (uint16_t)(LIT | (x & 0xFF));
          if (start >= lo) {
            ent[start - lo] = e;
            if (x >= 256 && (x & 0xFFFF) >= 0x8000) atomicOr(&big[(start - lo) >> 5], 1u << (start & 31));
          }
          const int last = min(start + size, hi - 1);
          for (int b = max(((start >> 4) + 1) << 4, lo); b <= last; b += PER) cov[(b - lo) >> 4] = e;
        }
        start += size;
      }
      if (h == 0 && total + chunk_total >= HALF) {  // the rest starts in the second half
        cross = c;
        pre_cross = total;
        total += chunk_total;
        break;
      }
      total += chunk_total;
    }
    __syncthreads();

    // Pass 2: per position the distance, region breaks, A, y0 and src.
    for (int pc = 0; pc < HALF_CHUNKS; ++pc) {
      const int b = lo + pc * CHUNK + PER * t;
      const uint4 e0 = reinterpret_cast<const uint4*>(ent + (b - lo))[0];
      const uint4 e1 = reinterpret_cast<const uint4*>(ent + (b - lo))[1];
      const uint32_t ew[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
      const uint32_t bigs = big[(b - lo) >> 5] >> (b & 31);
      // The record covering b - 1 and its distance (-1 before position 0).
      const int before = b > 0 && b - 1 < total ? cov[(b - lo) >> 4] : 0;
      const int cd_before = b == 0 ? -1 : (before < LIT ? before : 0);

      // The thread's last region break. Past the stream every position
      // breaks; inside it only a record can: a literal, or a distance that
      // differs from the record before.
      int last_brk = b + PER - 1;
      if (b + PER - 1 < total) {
        last_brk = -1;
        int cdp = cd_before;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int e = (ew[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
          if (e) {
            const int cd = e < LIT ? e : 0;
            if (cd == 0 || cd != cdp) last_brk = b + j;
            cdp = cd;
          }
        }
      }
      int chunk_max;
      int A = max(a_carry, block_exclusive<THREADS>(last_brk, Max(), -1, scratch[parity], &chunk_max));
      parity ^= 1;
      a_carry = max(a_carry, chunk_max);

      // (p - A) = q d + r, kd = (q + 1) d; the cap on k binds only past
      // 32 KiB of a region, and only there is W_CAP / d divided.
      int cur = before, cdp = cd_before, r = 0, kd = 0;
      uint4* st = stage + (t >> 5) * 128;  // the warp's 512 positions, packed
      const int lane = t & 31;
#pragma unroll
      for (int g = 0; g < PER / 4; ++g) {
        uint32_t w[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * g + jj;
          const int p = b + j;
          const int e = (ew[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
          if (e) cur = e;
          const bool in_stream = p < total;
          const int cd = in_stream && e < LIT ? cur : 0;
          if (cd != cdp || cd == 0) {
            A = p;
            r = 0;
            kd = cd;
          } else if (j == 0) {
            const int q = (p - A) / cd;
            r = p - A - q * cd;
            kd = (q + 1) * cd;
          } else if (++r == cd) {
            r = 0;
            kd += cd;
          }
          cdp = cd;
          int yv = in_stream ? (e & 0xFF) : 0, sv = p;
          if (cd) {
            if (A - cd + r < -hist || ((bigs >> j) & 1u)) {
              yv = 0;
              err_pos = min(err_pos, p);
            } else {
              yv = -1;
              sv = p - (kd > W_CAP ? W_CAP / cd * cd : kd);
              ++unres;
            }
          }
          w[jj] = pack_out(yv, sv);
        }
        st[swizzle(lane, g)] = make_uint4(w[0], w[1], w[2], w[3]);
      }
      // Coalesced stores: instruction g writes positions 128 g + 4 lane of
      // the warp's 512, which thread 8 g + lane / 4 packed as its group
      // lane % 4.
      __syncwarp();
      const size_t wbase = row + (b - PER * lane);
#pragma unroll
      for (int g = 0; g < PER / 4; ++g) {
        const int slot = 32 * g + lane;
        const uint4 w = st[swizzle(slot >> 2, slot & 3)];
        reinterpret_cast<int4*>(y0 + wbase)[slot] =
            make_int4(out_y(w.x), out_y(w.y), out_y(w.z), out_y(w.w));
        reinterpret_cast<int4*>(src + wbase)[slot] =
            make_int4(out_src(w.x), out_src(w.y), out_src(w.z), out_src(w.w));
      }
      __syncwarp();  // the warp's reads before its next chunk's writes
    }
    __syncthreads();  // the half's tables are read before the next half clears them
  }
  if (err_pos < N_POS) atomicMin(&s_err, err_pos);
  if (unres) atomicAdd(&s_unres, unres);
  __syncthreads();
  if (t < 8) summ[blockIdx.x * 8 + t] = t == 0 ? s_err : (t == 1 ? total : (t == 2 ? s_unres : 0));
}

}  // namespace

extern "C" int td_expand(const void* tok, void* y0, void* src, void* summ, int L, int hist,
                         void* stream) {
  // The largest shared-memory carveout, so that two blocks fit on an SM.
  cudaError_t err = cudaFuncSetAttribute(expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(expand_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  expand_kernel<<<L, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<int*>(y0), static_cast<int*>(src),
      static_cast<int*>(summ), hist);
  return (int)cudaGetLastError();
}
