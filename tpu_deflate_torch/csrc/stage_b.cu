// Stage B (K2): per-tile transfer maps.
//
// Replaces tpu_deflate/codec/decode_pallas.py:_stage_b_kernel (called from
// _stage_b_jit). For every 512-bit tile, cursor e starts at offset e
// (0..47) and follows the stage-A deltas; out[l, t, e] (uint8) is the exit
// offset into the next tile, or 127 (EOB) / 255 (error), exactly as the
// TPU kernel's lock-step walk followed by its (L, NT, 48) transpose.
//
// Bound on the H100: dependent loads. A cursor's next position is its
// current delta, so each walk is a chain of about 512 / (mean bits per
// symbol) serial loads, 48 walks per tile. Design: one thread per (lane,
// tile, entry); threads of a warp take neighbouring tiles of one entry,
// so the first loads coalesce and later ones stay within a few cache
// lines of each other. The TPU kernel steps all 48 cursors over all 512
// positions in lock step (512 masked adds per cursor); the serial walk
// visits only the positions the cursor reaches.
#include "td_common.cuh"

namespace {

using namespace td;

// delta (L, 512, NT) int32 -> out (L, NT, 48) uint8. Grid: (ceil(48 NT /
// 256), L); thread index e * NT + t.
__global__ void stage_b_kernel(const int* __restrict__ delta, uint8_t* __restrict__ out, int NT) {
  const int lane = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E_WIN * NT) return;
  const int e = i / NT;
  const int t = i - e * NT;
  const int* d = delta + (size_t)lane * W_P * NT + t;
  int cur = e;
  while (cur < W_P) {
    int a = cursor_adv(d[(size_t)cur * NT]);
    cur += a;
    if (a <= 0) break;  // a cursor that does not advance freezes
  }
  int v = cur >= ERR_ADV ? SENT_ERR : (cur >= EOB_ADV ? SENT_EOB : min(max(cur - W_P, 0), 255));
  out[((size_t)lane * NT + t) * E_WIN + e] = (uint8_t)v;
}

}  // namespace

extern "C" int td_stage_b(const void* delta, void* out, int L, int NT, void* stream) {
  dim3 block(256);
  dim3 blocks((E_WIN * NT + 255) / 256, L);
  stage_b_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(delta), static_cast<uint8_t*>(out), NT);
  return (int)cudaGetLastError();
}
