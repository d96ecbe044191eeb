// Encoder symbols and histograms: td_finish_analysis.
//
// Replaces tpu_deflate/codec/encode_jax.py:_finish_analysis (:372, the back
// half of the jitted analyze_phase2, :483-484). Per position of the rows
// (L, S): is_token = replay & valid (K9's bitmap and the match finder's
// mask), is_match = is_token & (use > 0); for a match, the length symbol
// of clamp(use, 3, 258) and the distance symbol of clamp(dist, 1, 32768),
// each with its extra bits and extra value (0 elsewhere; a literal's
// litlen symbol is its byte); flags = is_token | is_match << 1, the int32
// K10 takes; per lane the histograms of the tokens' litlen symbols (288
// bins) and the matches' distance symbols (30 bins). Exactly
// encode._finish_analysis_plain (with the AND and the flags), which builds
// the symbols from ~100 elementwise ops and the histograms with two int64
// bincounts.
//
// The symbols use the closed forms of the RFC 1951 tables: a length of
// 11..257 has e = floor(log2(len - 3)) - 2 extra bits and symbol 257 + 4e +
// ((len - 3) >> e), a distance of 5..32768 has e = floor(log2(d - 1)) - 1
// and symbol 2e + ((d - 1) >> e); __clz gives the logs. Every position
// costs a few integer operations, so the kernel is bound by its bytes: 11
// read (byte, use, dist, two flags) and 30 written (two flags, seven int32
// fields) a position.
//
// Design: a block of 256 threads takes SEG = 4096 positions of one row, 4
// consecutive positions a thread a step (16-byte loads and stores of the
// int32 fields, 4-byte ones of the byte fields, scalar ones where a row's
// width or a pointer is not aligned). The histograms go to shared memory,
// one sub-histogram of 318 bins per warp, so that a skewed distribution
// contends only inside a warp; a position that is not a token goes to no
// bin. At the end each bin's sum over the warps is added to the zeroed
// global (L, 288) and (L, 30) arrays with one atomicAdd where it is not
// zero. Integer sums are exact, so the result does not depend on the order
// in which the atomics land.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEPS = 4;
constexpr int SEG = THREADS * 4 * STEPS;  // positions a block
constexpr int LL_BINS = 288;
constexpr int D_BINS = 30;
constexpr int BINS = LL_BINS + D_BINS;

struct Sym {
  int sym, eb, ev;
};

// A length in [3, 258] -> (symbol, extra bits, extra value).
__device__ __forceinline__ Sym length_symbol(int run) {
  if (run <= 10) return {254 + run, 0, 0};
  if (run >= 258) return {285, 0, 0};
  const int r3 = run - 3;       // 8..254
  const int e = 29 - __clz(r3);  // floor(log2(r3)) - 2: 1..5
  const int sym = 257 + 4 * e + (r3 >> e);
  return {sym, e, run - (((((sym - 257) & 3) + 4) << e) + 3)};
}

// A distance in [1, 32768] -> (symbol, extra bits, extra value).
__device__ __forceinline__ Sym distance_symbol(int d) {
  const int d1 = d - 1;
  if (d1 < 4) return {d1, 0, 0};
  const int e = 30 - __clz(d1);  // floor(log2(d1)) - 1: 1..13
  const int sym = 2 * e + (d1 >> e);
  return {sym, e, d - ((((sym & 1) + 2) << e) + 1)};
}

struct Out {
  uint8_t* is_token;
  uint8_t* is_match;
  int* litlen_sym;
  int* len_eb;
  int* len_ev;
  int* dist_sym;
  int* dist_eb;
  int* dist_ev;
  int* flags;
};

__global__ void __launch_bounds__(THREADS)
    finish_analysis_kernel(const uint8_t* __restrict__ data, const int* __restrict__ use,
                           const int* __restrict__ dist, const uint8_t* __restrict__ replay,
                           const uint8_t* __restrict__ valid, Out o, int* __restrict__ litlen_hist,
                           int* __restrict__ dist_hist, int S, int vec) {
  __shared__ int hist[WARPS][BINS];
  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) (&hist[0][0])[i] = 0;
  __syncthreads();
  int* h = hist[threadIdx.x >> 5];
  const size_t row = (size_t)blockIdx.y * S;

  for (int step = 0; step < STEPS; ++step) {
    const int p0 = blockIdx.x * SEG + (step * THREADS + threadIdx.x) * 4;
    if (p0 >= S) break;
    const size_t i0 = row + p0;
    const bool whole = vec && p0 + 4 <= S;
    uint8_t b[4], r[4], v[4];
    int u[4], d[4];
    if (whole) {
      const uchar4 bq = *reinterpret_cast<const uchar4*>(data + i0);
      const uchar4 rq = *reinterpret_cast<const uchar4*>(replay + i0);
      const uchar4 vq = *reinterpret_cast<const uchar4*>(valid + i0);
      const int4 uq = *reinterpret_cast<const int4*>(use + i0);
      const int4 dq = *reinterpret_cast<const int4*>(dist + i0);
      b[0] = bq.x, b[1] = bq.y, b[2] = bq.z, b[3] = bq.w;
      r[0] = rq.x, r[1] = rq.y, r[2] = rq.z, r[3] = rq.w;
      v[0] = vq.x, v[1] = vq.y, v[2] = vq.z, v[3] = vq.w;
      u[0] = uq.x, u[1] = uq.y, u[2] = uq.z, u[3] = uq.w;
      d[0] = dq.x, d[1] = dq.y, d[2] = dq.z, d[3] = dq.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = p0 + j < S;
        b[j] = in ? data[i0 + j] : 0;
        r[j] = in ? replay[i0 + j] : 0;
        v[j] = in ? valid[i0 + j] : 0;
        u[j] = in ? use[i0 + j] : 0;
        d[j] = in ? dist[i0 + j] : 0;
      }
    }
    int tok[4], mat[4], ll[4], leb[4], lev[4], ds[4], deb[4], dev[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tok[j] = (r[j] != 0) & (v[j] != 0);
      mat[j] = tok[j] & (u[j] > 0);
      const Sym ls = length_symbol(min(max(u[j], 3), 258));
      const Sym dsy = distance_symbol(min(max(d[j], 1), 32768));
      ll[j] = mat[j] ? ls.sym : b[j];
      leb[j] = mat[j] ? ls.eb : 0;
      lev[j] = mat[j] ? ls.ev : 0;
      ds[j] = mat[j] ? dsy.sym : 0;
      deb[j] = mat[j] ? dsy.eb : 0;
      dev[j] = mat[j] ? dsy.ev : 0;
      if (tok[j]) atomicAdd(&h[ll[j]], 1);
      if (mat[j]) atomicAdd(&h[LL_BINS + ds[j]], 1);
    }
    if (whole) {
      *reinterpret_cast<uchar4*>(o.is_token + i0) =
          make_uchar4(tok[0], tok[1], tok[2], tok[3]);
      *reinterpret_cast<uchar4*>(o.is_match + i0) =
          make_uchar4(mat[0], mat[1], mat[2], mat[3]);
      *reinterpret_cast<int4*>(o.litlen_sym + i0) = make_int4(ll[0], ll[1], ll[2], ll[3]);
      *reinterpret_cast<int4*>(o.len_eb + i0) = make_int4(leb[0], leb[1], leb[2], leb[3]);
      *reinterpret_cast<int4*>(o.len_ev + i0) = make_int4(lev[0], lev[1], lev[2], lev[3]);
      *reinterpret_cast<int4*>(o.dist_sym + i0) = make_int4(ds[0], ds[1], ds[2], ds[3]);
      *reinterpret_cast<int4*>(o.dist_eb + i0) = make_int4(deb[0], deb[1], deb[2], deb[3]);
      *reinterpret_cast<int4*>(o.dist_ev + i0) = make_int4(dev[0], dev[1], dev[2], dev[3]);
      *reinterpret_cast<int4*>(o.flags + i0) = make_int4(tok[0] | mat[0] << 1, tok[1] | mat[1] << 1,
                                                         tok[2] | mat[2] << 1, tok[3] | mat[3] << 1);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p0 + j >= S) break;
        const size_t i = i0 + j;
        o.is_token[i] = tok[j];
        o.is_match[i] = mat[j];
        o.litlen_sym[i] = ll[j];
        o.len_eb[i] = leb[j];
        o.len_ev[i] = lev[j];
        o.dist_sym[i] = ds[j];
        o.dist_eb[i] = deb[j];
        o.dist_ev[i] = dev[j];
        o.flags[i] = tok[j] | mat[j] << 1;
      }
    }
  }
  __syncthreads();
  for (int bin = threadIdx.x; bin < BINS; bin += THREADS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += hist[w][bin];
    if (sum != 0) {
      int* dst = bin < LL_BINS ? litlen_hist + (size_t)blockIdx.y * LL_BINS + bin
                               : dist_hist + (size_t)blockIdx.y * D_BINS + (bin - LL_BINS);
      atomicAdd(dst, sum);
    }
  }
}

}  // namespace

extern "C" int td_finish_analysis(const void* data, const void* use, const void* dist, const void* replay,
                                  const void* valid, void* is_token, void* is_match, void* litlen_sym,
                                  void* len_eb, void* len_ev, void* dist_sym, void* dist_eb, void* dist_ev,
                                  void* flags, void* litlen_hist, void* dist_hist, int L, int S, void* stream) {
  if (L < 1 || L > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  const void* words[] = {use, dist, litlen_sym, len_eb, len_ev, dist_sym, dist_eb, dist_ev, flags};
  const void* bytes[] = {data, replay, valid, is_token, is_match};
  int vec = S % 4 == 0;
  for (const void* p : words) vec &= (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  for (const void* p : bytes) vec &= (reinterpret_cast<uintptr_t>(p) & 3) == 0;
  const Out o{static_cast<uint8_t*>(is_token), static_cast<uint8_t*>(is_match), static_cast<int*>(litlen_sym),
              static_cast<int*>(len_eb), static_cast<int*>(len_ev), static_cast<int*>(dist_sym),
              static_cast<int*>(dist_eb), static_cast<int*>(dist_ev), static_cast<int*>(flags)};
  const dim3 grid((S + SEG - 1) / SEG, L);
  finish_analysis_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(use), static_cast<const int*>(dist),
      static_cast<const uint8_t*>(replay), static_cast<const uint8_t*>(valid), o, static_cast<int*>(litlen_hist),
      static_cast<int*>(dist_hist), S, vec);
  return (int)cudaGetLastError();
}
