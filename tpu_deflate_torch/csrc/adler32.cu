// Adler-32's two sums of one buffer (AD).
//
// Replaces tpu_deflate/kernels/checksum_jax.py:282 _adler_sums (called from
// adler32_device), which the port ran as eager PyTorch: the bytes widened to
// int64, a weight vector, a product and two sums, some 24 bytes of device
// temporaries per input byte. For n bytes d_0 .. d_{n-1} the kernel writes
// S = sum d_i and W = sum d_i ((n - i) mod 65521) as two uint64, exact: each
// product is below 2^24, so W stays below 2^63 for any n below 2^39; the
// host folds them into the checksum (kernels/checksum_lanes.py).
//
// Bound on the H100: memory traffic, one read of each byte. A grid-stride
// loop reads the buffer in 16-byte vectors (the bytes before the first
// 16-byte boundary and after the last one by scalar loads), a thread takes
// the weight of its vector's first byte with one 64-bit modulo and steps
// the other 15 down by one each; each thread keeps 64-bit sums, a block
// reduces them by shuffles and writes its partial pair. The last block to
// finish, known by an atomic ticket, adds the partials in block order and
// puts the ticket back to 0, so a call launches one kernel and no fill.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned MOD = 65521;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The weight of byte i of n: (n - i) mod 65521.
__device__ __forceinline__ unsigned weight(long long n, long long i) {
  return (unsigned)((unsigned long long)(n - i) % MOD);
}

__global__ void __launch_bounds__(THREADS)
    adler_sums_kernel(const uint8_t* __restrict__ d, long long n, long long head, long long nvec,
                      unsigned long long* __restrict__ partial, unsigned* __restrict__ ticket,
                      unsigned long long* __restrict__ out) {
  __shared__ unsigned long long ws[2][WARPS];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long gtid = (long long)blockIdx.x * THREADS + tid;
  const long long stride = (long long)gridDim.x * THREADS;
  unsigned long long s = 0, w = 0;
  // The scalar bytes: [0, head) before the first 16-byte boundary, and the
  // tail after the last whole vector.
  const long long tail = head + 16 * nvec;
  for (long long i = gtid; i < head + (n - tail); i += stride) {
    const long long j = i < head ? i : tail + (i - head);
    const unsigned b = d[j];
    s += b;
    w += (unsigned long long)b * weight(n, j);
  }
  const uint4* v = reinterpret_cast<const uint4*>(d + head);
  for (long long k = gtid; k < nvec; k += stride) {
    const uint4 q = __ldg(v + k);
    const long long i0 = head + 16 * k;
    unsigned r = weight(n, i0);  // the weight of byte i0 + j is r - j, wrapped into [0, MOD)
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    uint32_t bs = 0, bw = 0;  // below 16 * 255 and 16 * 2^24
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned b = (words[a] >> (8 * c)) & 0xFFu;
        bs += b;
        bw += b * r;
        r = r ? r - 1 : MOD - 1;
      }
    }
    s += bs;
    w += bw;
  }
  s = warp_sum(s);
  w = warp_sum(w);
  if ((tid & 31) == 0) {
    ws[0][tid >> 5] = s;
    ws[1][tid >> 5] = w;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned long long bs = 0, bw = 0;
    for (int i = 0; i < WARPS; ++i) {
      bs += ws[0][i];
      bw += ws[1][i];
    }
    partial[2 * blockIdx.x] = bs;
    partial[2 * blockIdx.x + 1] = bw;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // Every block's partial pair is written and visible: add them.
  __threadfence();
  s = w = 0;
  for (unsigned b = tid; b < gridDim.x; b += THREADS) {
    s += reinterpret_cast<volatile unsigned long long*>(partial)[2 * b];
    w += reinterpret_cast<volatile unsigned long long*>(partial)[2 * b + 1];
  }
  s = warp_sum(s);
  w = warp_sum(w);
  __syncthreads();
  if ((tid & 31) == 0) {
    ws[0][tid >> 5] = s;
    ws[1][tid >> 5] = w;
  }
  __syncthreads();
  if (tid == 0) {
    unsigned long long bs = 0, bw = 0;
    for (int i = 0; i < WARPS; ++i) {
      bs += ws[0][i];
      bw += ws[1][i];
    }
    out[0] = bs;
    out[1] = bw;
    *ticket = 0;
  }
}

}  // namespace

// Blocks of a launch over n bytes: enough to keep every SM's loads in
// flight, and no more than there are vectors for. The wrapper sizes the
// partials (2 uint64 a block) by it.
extern "C" int td_adler_blocks(long long n) {
  const long long want = (n / 16 + THREADS - 1) / THREADS;
  return (int)(want < 1 ? 1 : (want > 132 * 8 ? 132 * 8 : want));
}

// data: n > 0 bytes; partial: 2 * td_adler_blocks(n) uint64; ticket: one
// uint32, 0 (the kernel leaves it 0); out: 2 uint64, S and W.
extern "C" int td_adler_sums(const void* data, long long n, void* partial, void* ticket, void* out,
                             void* stream) {
  const auto* d = static_cast<const uint8_t*>(data);
  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  if (head > n) head = n;
  const long long nvec = (n - head) / 16;
  adler_sums_kernel<<<td_adler_blocks(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      d, n, head, nvec, static_cast<unsigned long long*>(partial), static_cast<unsigned*>(ticket),
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
