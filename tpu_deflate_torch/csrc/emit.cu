// Emit body (K10): a lane's token info -> packed DEFLATE body words.
//
// Replaces tpu_deflate/codec/emit_pallas.py:_emit_kernel (called from
// _emit_jit). Inputs per lane, S positions (S a multiple of 1024): sym,
// flags (bit 0 token, bit 1 match), leb, lev, dsym, deb, dev (int32), the
// litlen (288) and distance (30) code tables packed len << 16 | revcode,
// and the header's bit length. Every position is two slots, as in the
// reference's XLA emit: (litlen code | length extra << code length) and
// (distance code | distance extra << code length), of at most 20 and 28
// bits. The slots' bit offsets are an exclusive scan that starts at the
// header's length. Outputs: words (L, 22528) int32 holding uint32 bit
// patterns, and body_end (L,) = header bits + body bits. A word index at or
// past 22528 is dropped (never written); body_end stays exact.
//
// Bound on the H100: memory traffic, seven 4-byte fields read per position
// (117 MB for a batch of 64 lanes x 65536) and 90 KB of words written per
// lane. Design: one block of 1024 threads per lane, its whole word grid
// (88 KiB) and code tables in shared memory. The block walks the lane in
// chunks of 1024 positions: each thread builds its position's slots with
// table lookups, a block scan gives the offsets, and the slots' word parts
// go into the grid with shared-memory atomicOr (slots hold disjoint bits,
// so OR is the sum). The TPU kernel replaces the table gathers with
// one-hot row and column selects and the scatter with int8 bit-plane MXU
// products, because it has neither gathers nor scatters.
#include "td_common.cuh"
#include "td_scan.cuh"

namespace {

using namespace td;

constexpr int EMIT_WORDS = 176 * 128;
constexpr int SMEM_BYTES = EMIT_WORDS * 4;
constexpr int N_LL = 288;
constexpr int N_D = 30;

__device__ __forceinline__ void put_slot(uint32_t* grid, int off, uint32_t v) {
  const int w = off >> 5;
  const int sh = off & 31;
  const uint32_t lo = v << sh;
  const uint32_t hi = sh ? v >> (32 - sh) : 0u;
  if (lo && w < EMIT_WORDS) atomicOr(&grid[w], lo);
  if (hi && w + 1 < EMIT_WORDS) atomicOr(&grid[w + 1], hi);
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
    emit_kernel(const int* __restrict__ sym, const int* __restrict__ flags,
                const int* __restrict__ leb, const int* __restrict__ lev,
                const int* __restrict__ dsym, const int* __restrict__ deb,
                const int* __restrict__ dev, const int* __restrict__ llc,
                const int* __restrict__ dc, const int* __restrict__ hdr_bits,
                int* __restrict__ words, int* __restrict__ body_end, int S) {
  extern __shared__ uint32_t grid[];
  __shared__ int ll_tab[N_LL];
  __shared__ int d_tab[N_D];
  __shared__ int scratch[SCAN_WARPS];
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
  for (int i = t; i < EMIT_WORDS; i += SCAN_THREADS) grid[i] = 0u;
  for (int i = t; i < N_LL; i += SCAN_THREADS) ll_tab[i] = llc[lane * N_LL + i];
  if (t < N_D) d_tab[t] = dc[lane * N_D + t];
  __syncthreads();

  const size_t row = (size_t)lane * S;
  int carry = hdr_bits[lane];  // bit offset of the chunk's first slot
  for (int base = 0; base < S; base += SCAN_THREADS) {
    const size_t i = row + base + t;
    const int f = flags[i];
    const bool tok = f & 1;
    const bool match = f & 2;
    const int ll = tok ? ll_tab[min(max(sym[i], 0), N_LL - 1)] : 0;
    const int b0 = ll >> 16;
    int ba = b0, bb = 0;
    uint32_t va = (uint32_t)(ll & 0xFFFF), vb = 0u;
    if (match) {
      const int dd = d_tab[min(max(dsym[i], 0), N_D - 1)];
      const int b2 = dd >> 16;
      va |= shl_u((uint32_t)lev[i], b0);
      ba += leb[i];
      vb = (uint32_t)(dd & 0xFFFF) | shl_u((uint32_t)dev[i], b2);
      bb = b2 + deb[i];
    }
    const int nb = ba + bb;
    int chunk_total;
    const int off = carry + block_inclusive(nb, Sum(), 0, scratch, &chunk_total) - nb;
    carry += chunk_total;
    if (ba > 0) put_slot(grid, off, va);
    if (bb > 0) put_slot(grid, off + ba, vb);
  }
  __syncthreads();
  int* out = words + (size_t)lane * EMIT_WORDS;
  for (int i = t; i < EMIT_WORDS; i += SCAN_THREADS) out[i] = (int)grid[i];
  if (t == 0) body_end[lane] = carry;
}

}  // namespace

extern "C" int td_emit_body(const void* sym, const void* flags, const void* leb, const void* lev,
                            const void* dsym, const void* deb, const void* dev, const void* llc,
                            const void* dc, const void* hdr_bits, void* words, void* body_end,
                            int L, int S, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  emit_kernel<<<L, SCAN_THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sym), static_cast<const int*>(flags), static_cast<const int*>(leb),
      static_cast<const int*>(lev), static_cast<const int*>(dsym), static_cast<const int*>(deb),
      static_cast<const int*>(dev), static_cast<const int*>(llc), static_cast<const int*>(dc),
      static_cast<const int*>(hdr_bits), static_cast<int*>(words), static_cast<int*>(body_end), S);
  return (int)cudaGetLastError();
}
