// Stage DC (K3): replay of the true chain in every tile, level-1 token
// compaction and the per-tile summary rows.
//
// Replaces tpu_deflate/codec/decode_pallas.py:_stage_dc_kernel (called from
// _stage_dc_jit). For every tile, one cursor starts at the tile's true
// entry (>= 48 means the chain never enters the tile) and walks the
// deltas. Outputs, bit for bit as the TPU kernel after its transposes:
// tokens (L, NT, k1) int32, the first k1 reached non-terminal tokens in
// stream order with -1 behind them; summary (L, 8, NT) int32, rows
// ROW_COUNT..ROW_OVERFLOW (wave_prep.py), sums wrapping like int32.
//
// Bound on the H100: dependent loads, one chain of about 512 / (mean bits
// per symbol) serial steps per tile. Design: one thread per (lane, tile).
// The serial walk meets reached tokens in order, so it writes the first
// k1 of them straight to their slots; the TPU kernel's reached bitmap,
// log-shift rank and collision-free displacement moves (which exist
// because Mosaic has no scatter) are not needed. Neighbouring threads take
// neighbouring tiles, so the summary stores coalesce.
#include "td_common.cuh"

namespace {

using namespace td;

__global__ void stage_dc_kernel(const int* __restrict__ delta, const int* __restrict__ token,
                                const int* __restrict__ entries, int* __restrict__ tok_out,
                                int* __restrict__ summ, int NT, int k1) {
  const int lane = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= NT) return;
  const size_t col = (size_t)lane * W_P * NT + t;
  const int* d = delta + col;
  const int* tk = token + col;
  int* out = tok_out + ((size_t)lane * NT + t) * k1;

  const int entry = entries[(size_t)lane * NT + t];
  int cur = entry < E_WIN ? entry : W_P;  // dead tile: no position is reached
  int count = 0;
  uint32_t eob_pos = 0, eob_tok = 0, err_tok = 0, size_sum = 0, eob_hit = 0, err_hit = 0;
  while ((unsigned)cur < (unsigned)W_P) {
    const int dv = d[(size_t)cur * NT];
    const int tv = tk[(size_t)cur * NT];
    if (dv == SENT_EOB) {
      eob_hit += 1;
      eob_pos += (uint32_t)cur;
      eob_tok += (uint32_t)tv;
    } else if (dv == SENT_ERR) {
      err_hit += 1;
      err_tok += (uint32_t)tv;
    } else if (dv < SENT_EOB) {
      if (count < k1) out[count] = tv;
      ++count;
      size_sum += (tv >= 0 && tv < 256) ? 1u : (uint32_t)((tv >> 16) & 0x3FF);
    }
    const int a = cursor_adv(dv);
    if (a <= 0) break;  // a cursor that does not advance freezes
    // Unsigned, so a delta near 2^31 leaves the tile (cur < 512, a < 2^31:
    // the sum does not wrap) where a signed sum would overflow.
    const unsigned nx = (unsigned)cur + (unsigned)a;
    if (nx >= (unsigned)W_P) break;
    cur = (int)nx;
  }
  for (int j = count; j < k1; ++j) out[j] = -1;

  int* s = summ + (size_t)lane * 8 * NT + t;
  s[0 * (size_t)NT] = count;
  s[1 * (size_t)NT] = (int)eob_pos;
  s[2 * (size_t)NT] = (int)eob_tok;
  s[3 * (size_t)NT] = (int)err_tok;
  s[4 * (size_t)NT] = (int)size_sum;
  s[5 * (size_t)NT] = (int)eob_hit;
  s[6 * (size_t)NT] = (int)err_hit;
  s[7 * (size_t)NT] = count > k1 ? 1 : 0;
}

}  // namespace

extern "C" int td_stage_dc(const void* delta, const void* token, const void* entries,
                           void* tok_out, void* summ, int L, int NT, int k1, void* stream) {
  dim3 block(128);
  dim3 blocks((NT + 127) / 128, L);
  stage_dc_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(delta), static_cast<const int*>(token),
      static_cast<const int*>(entries), static_cast<int*>(tok_out), static_cast<int*>(summ), NT,
      k1);
  return (int)cudaGetLastError();
}
