// The encoder's block routing (RT): the stored / fixed / dynamic bit costs
// of each lane, its cheapest strategy, and the fixed-code swap.
//
// Replaces tpu_deflate/codec/encode_jax.py:575 route_strategies and :619
// _apply_route (called from _plan_codes, :952 and :961), which the port ran
// as some fifty eager PyTorch ops a batch. One 128-thread block a lane
// (L, the batch's lanes) takes the five int32 dot products of the token
// histograms (288 litlen + 30 distance symbols) with the extra bits, the
// planned dynamic code lengths and the fixed code lengths, then
//   dynamic = header bits + sum(hist * len) + extras + ll_len[256] (EOB),
//   fixed   = 3 + sum(hist * fixed len) + extras + 7,
//   stored  = 8 * (len + 5 * ceil(len / 65535) + 1),
// in int32 arithmetic that wraps as the reference's does, and the choice
// in the reference's tie order: STORED only where strictly below both,
// then FIXED only where strictly below dynamic. For a lane routed FIXED
// the block then writes, in place, the fixed code tables over the lane's
// ll_codes and d_codes, header slot 0 = bfinal | 2 (3 bits), slots 1.. =
// 0 (0 bits), and the EOB = 0 (7 bits).
//
// Bound on the H100: the bytes, some 14 KB a lane (the histograms, the
// lengths and codes read, the swapped tables written), about 0.3 us for a
// 64-lane batch; the launch and the host planning around it dominate.
// The design keeps a lane's work inside one block, so the costs never
// leave registers and shared memory and the swap needs no second launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int N_LL = 288;
constexpr int N_D = 30;
constexpr int ROUTE_FIXED = 1, ROUTE_STORED = 2;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
    route_kernel(const int* __restrict__ ll_hist, const int* __restrict__ d_hist, const int* __restrict__ ll_len,
                 const int* __restrict__ d_len, const int* __restrict__ hdr_bits, const int* __restrict__ lengths,
                 int* __restrict__ ll_codes, int* __restrict__ d_codes, long long* __restrict__ hv,
                 int* __restrict__ hb, long long* __restrict__ ev, int* __restrict__ eb,
                 const int* __restrict__ fix_ll, const int* __restrict__ fix_d, const long long* __restrict__ final,
                 int* __restrict__ choice, int* __restrict__ dyn, int* __restrict__ fixed,
                 int* __restrict__ stored, int H) {
  __shared__ uint32_t part[3][WARPS];
  __shared__ int s_fixed;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  // uint32 sums wrap as the reference's int32 sums do.
  uint32_t ext = 0, dsum = 0, fsum = 0;
  for (int s = tid; s < N_LL + N_D; s += THREADS) {
    if (s < N_LL) {
      const uint32_t h = (uint32_t)ll_hist[lane * N_LL + s];
      const uint32_t extra = s >= 265 && s <= 284 ? (uint32_t)(s - 261) >> 2 : 0u;
      const uint32_t flen = s < 144 ? 8u : (s < 256 ? 9u : (s < 280 ? 7u : 8u));
      ext += h * extra;
      dsum += h * (uint32_t)ll_len[lane * N_LL + s];
      fsum += h * flen;
    } else {
      const int k = s - N_LL;
      const uint32_t h = (uint32_t)d_hist[lane * N_D + k];
      const uint32_t extra = k >= 4 ? (uint32_t)((k >> 1) - 1) : 0u;
      ext += h * extra;
      dsum += h * (uint32_t)d_len[lane * N_D + k];
      fsum += h * 5u;
    }
  }
  ext = warp_sum(ext);
  dsum = warp_sum(dsum);
  fsum = warp_sum(fsum);
  if ((tid & 31) == 0) {
    part[0][tid >> 5] = ext;
    part[1][tid >> 5] = dsum;
    part[2][tid >> 5] = fsum;
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t e = 0, ds = 0, fs = 0;
    for (int w = 0; w < WARPS; ++w) {
      e += part[0][w];
      ds += part[1][w];
      fs += part[2][w];
    }
    const int d = (int)((uint32_t)hdr_bits[lane] + ds + e + (uint32_t)ll_len[lane * N_LL + 256]);
    const int f = (int)(3u + fs + e + 7u);
    // 8 * (len + 5 * ceil(len / 65535) + 1), the ceiling as a floor
    // division of len + 65534 (also for a negative len, as PyTorch's //).
    const int len = lengths[lane];
    const int num = (int)((uint32_t)len + 65534u);
    const int q = num / 65535 - (num % 65535 != 0 && num < 0);
    const int st = (int)(8u * ((uint32_t)len + 5u * (uint32_t)q + 1u));
    const int c = st < min(d, f) ? ROUTE_STORED : (f < d ? ROUTE_FIXED : 0);
    choice[lane] = c;
    dyn[lane] = d;
    fixed[lane] = f;
    stored[lane] = st;
    s_fixed = c == ROUTE_FIXED;
  }
  __syncthreads();
  if (!s_fixed) return;
  for (int s = tid; s < N_LL; s += THREADS) ll_codes[lane * N_LL + s] = fix_ll[s];
  if (tid < N_D) d_codes[lane * N_D + tid] = fix_d[tid];
  const long long fin = final ? final[lane] : 1;
  for (int j = tid; j < H; j += THREADS) {
    hv[(size_t)lane * H + j] = j ? 0 : (fin | 2);
    hb[(size_t)lane * H + j] = j ? 0 : 3;
  }
  if (tid == 0) {
    ev[lane] = 0;
    eb[lane] = 7;
  }
}

}  // namespace

// Per lane: ll_hist, ll_len (L, 288), d_hist, d_len (L, 30), hdr_bits,
// lengths (L,) int32 in; ll_codes (L, 288), d_codes (L, 30) int32,
// header_vals (L, H) int64, header_bits (L, H) int32, eob_val (L,) int64,
// eob_bits (L,) int32 swapped in place for lanes routed FIXED, from the
// fixed tables fix_ll (288), fix_d (30) int32 and final (L,) int64 (null:
// every lane final); choice, dyn, fixed, stored (L,) int32 out.
extern "C" int td_route(const void* ll_hist, const void* d_hist, const void* ll_len, const void* d_len,
                        const void* hdr_bits, const void* lengths, void* ll_codes, void* d_codes, void* hv,
                        void* hb, void* ev, void* eb, const void* fix_ll, const void* fix_d, const void* final,
                        void* choice, void* dyn, void* fixed, void* stored, int L, int H, void* stream) {
  route_kernel<<<L, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ll_hist), static_cast<const int*>(d_hist), static_cast<const int*>(ll_len),
      static_cast<const int*>(d_len), static_cast<const int*>(hdr_bits), static_cast<const int*>(lengths),
      static_cast<int*>(ll_codes), static_cast<int*>(d_codes), static_cast<long long*>(hv), static_cast<int*>(hb),
      static_cast<long long*>(ev), static_cast<int*>(eb), static_cast<const int*>(fix_ll),
      static_cast<const int*>(fix_d), static_cast<const long long*>(final), static_cast<int*>(choice),
      static_cast<int*>(dyn), static_cast<int*>(fixed), static_cast<int*>(stored), H);
  return (int)cudaGetLastError();
}
