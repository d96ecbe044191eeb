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
// two 4-byte writes per position (about 0.79 MB per lane). Design: one
// block of 1024 threads per lane, two passes of 64 chunks of 1024.
//   Pass 1: each thread takes one token slot; a block scan of token sizes
//   gives its start, and the thread writes its run's positions into a
//   64 K x 16-bit shared table (literal: 0x8000 | byte; match: dist-1 in
//   15 bits) plus a bit per oversized-distance match start.
//   Pass 2: each thread takes one position; a block max-scan of region
//   breaks (entry differs from the previous one, or not a match) gives A,
//   and q, k in integers. The TPU kernel moves records with log-shift
//   displacement rounds and fills runs with running-max scans over all
//   positions, because it cannot scatter; its float32 quotients and their
//   corrections become integer division.
#include "td_common.cuh"
#include "td_scan.cuh"

namespace {

using namespace td;

constexpr int N_POS = 65536;
constexpr int W_CAP = 32768;
constexpr int LIT_FLAG = 0x8000;
constexpr int SMEM_BYTES = N_POS * 2 + N_POS / 8;  // entry table + big-distance bits

__global__ void __launch_bounds__(SCAN_THREADS, 1)
    expand_kernel(const int* __restrict__ tok, int* __restrict__ y0, int* __restrict__ src,
                  int* __restrict__ summ, int hist) {
  extern __shared__ uint16_t ent[];
  uint32_t* big = reinterpret_cast<uint32_t*>(ent + N_POS);
  __shared__ int scratch[SCAN_WARPS];
  __shared__ int s_err, s_unres;
  const int t = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * N_POS;
  for (int i = t; i < N_POS / 32; i += SCAN_THREADS) big[i] = 0u;
  if (t == 0) {
    s_err = N_POS;
    s_unres = 0;
  }
  __syncthreads();

  // Pass 1: token starts and the per-position entry table.
  int total = 0;  // output bytes of the chunks so far (the same in every thread)
  for (int base = 0; base < N_POS; base += SCAN_THREADS) {
    const int v = tok[row + base + t];
    const bool match = v >= 256;
    const int size = v < 0 ? 0 : (match ? (v >> 16) & 0x3FF : 1);
    int chunk_total;
    const int start = total + block_inclusive(size, Sum(), 0, scratch, &chunk_total) - size;
    total += chunk_total;
    if (size > 0 && start < N_POS) {
      const uint16_t e = match ? (uint16_t)(v & 0x7FFF) : (uint16_t)(LIT_FLAG | (v & 0xFF));
      const int end = min(start + size, N_POS);
      for (int p = start; p < end; ++p) ent[p] = e;
      if (match && (v & 0xFFFF) >= 0x8000) atomicOr(&big[start >> 5], 1u << (start & 31));
    }
  }
  __syncthreads();

  // Pass 2: region starts, sources and errors.
  int a_carry = -1, err_pos = N_POS, unres = 0;
  for (int base = 0; base < N_POS; base += SCAN_THREADS) {
    const int p = base + t;
    const bool in_stream = p < total;
    const int e = in_stream ? ent[p] : LIT_FLAG;
    const bool is_match = e < LIT_FLAG;
    const bool brk = !is_match || p == 0 || ent[p - 1] != e;
    int chunk_max;
    const int A = max(a_carry, block_inclusive(brk ? p : -1, Max(), -1, scratch, &chunk_max));
    a_carry = max(a_carry, chunk_max);
    int yv = in_stream ? (e & 0xFF) : 0;
    int sv = p;
    if (is_match) {
      const int d = (e & 0x7FFF) + 1;
      const int i = p - A;
      const int q = i / d;
      const int src_mod = A - d + (i - q * d);
      const bool err = src_mod < -hist || ((big[p >> 5] >> (p & 31)) & 1u);
      if (err) {
        yv = 0;
        err_pos = min(err_pos, p);
      } else {
        yv = -1;
        sv = p - max(min(q + 1, W_CAP / d), 1) * d;
        ++unres;
      }
    }
    y0[row + p] = yv;
    src[row + p] = sv;
  }
  if (err_pos < N_POS) atomicMin(&s_err, err_pos);
  if (unres) atomicAdd(&s_unres, unres);
  __syncthreads();
  if (t < 8) summ[blockIdx.x * 8 + t] = t == 0 ? s_err : (t == 1 ? total : (t == 2 ? s_unres : 0));
}

}  // namespace

extern "C" int td_expand(const void* tok, void* y0, void* src, void* summ, int L, int hist,
                         void* stream) {
  cudaError_t err = cudaFuncSetAttribute(expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  expand_kernel<<<L, SCAN_THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<int*>(y0), static_cast<int*>(src),
      static_cast<int*>(summ), hist);
  return (int)cudaGetLastError();
}
