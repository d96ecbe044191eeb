// Sweep resolve (K6): per-position literal byte or source -> final bytes.
//
// Replaces tpu_deflate/codec/resolve_pallas.py:_sweep_kernel (called from
// _sweep_jit). tail (L, 32768) int32: the resolved history before the tile
// (the previous tile's last 32 KiB, zeros at a stream start); y0, src (L,
// 65536) int32 from expand (K5). y (L, 65536) int32 gets each position's
// byte: y0 where y0 >= 0, else the byte at src (src < 0 reads
// tail[src + 32768]). A source outside [p - 32768, p) (expand caps every
// back-jump at 32768, so none comes from it) leaves p unresolved. status
// (L, 8): row 0 the residue (positions left unresolved, y = 0 there), row
// 1 the rounds of pointer doubling summed over steps (a diagnostic: the
// TPU kernel counts its own rounds).
//
// Bound on the H100: memory traffic, 4-byte reads of tail, y0 and src and
// a 4-byte write of y per position (about 0.92 MB per lane). The tile is
// walked in 64 steps of 1024 positions, in order: every source points
// backwards and at most 32 KiB away, so when a step runs, everything before
// it is a final byte. The parent design (one 1024-thread block per lane)
// loaded each step's y0 and src when the step began, a device-memory round
// trip on the lane's serial path 64 times, copied the whole tail into 96
// KiB of shared memory first, and resolved in-step sources by rounds of
// pointer doubling, two barriers each. Here one 256-thread block per lane,
// a thread taking 4 consecutive positions of each step:
// - a thread loads its positions' y0 and src (16 bytes each where the rows
//   are aligned) two steps ahead into registers, so a step's loads are in
//   flight while the two steps before it resolve. Staging them through
//   shared memory with cp.async (five stages) measured slower on the H100
//   (PERF.md, section 6);
// - the tile's resolved bytes live in 64 KiB of shared memory. A source in
//   the tail is read from the tail where it is needed (a stream start has
//   none), so the tail is not copied in first. 68 KiB of shared memory a
//   block: all lanes of a 256-lane batch are resident at once;
// - a position whose source lies before the step reads its byte (from
//   shared memory, or the tail) once; one whose source is inside the step follows the chain of
//   in-step sources (their initial states: a literal byte, a final byte or
//   a pointer) for up to CHASE hops without a barrier, the thread's four
//   chains side by side. Only what is left after that takes rounds of
//   pointer doubling over the step (two barriers each), and the rounds stop
//   when nothing in the step is pending. A self pointer marks an
//   out-of-domain source; a chain that reaches one stays unresolved.
// Per step that leaves two barriers: after the step's initial states, and
// the vote on rounds, which also publishes the step's bytes to the next
// step. A step's bytes go to shared memory as one 4-byte word a thread and
// to y as one 16-byte store.
#include "td_common.cuh"

namespace {

constexpr int N_POS = 65536;
constexpr int TAIL = 32768;
constexpr int WINDOW = 32768;  // the farthest back-jump a source may take
constexpr int THREADS = 256;
constexpr int PER = 4;  // consecutive positions a thread takes in each step
constexpr int STEP = THREADS * PER;
constexpr int N_STEPS = N_POS / STEP;
constexpr int CHASE = 16;       // in-step hops followed before the doubling rounds
constexpr int MAX_ROUNDS = 11;  // pointer doubling over a 1024-position step
constexpr int SMEM_BYTES = N_POS + STEP * 4;
constexpr int VEC_IN = 1, VEC_OUT = 2;  // 16-byte aligned: y0 and src, y

// A thread's four positions of one step: y0 and src.
struct Step {
  int4 v, s;
};

__device__ __forceinline__ int4 load4(const int* p, bool vec) {
  return vec ? __ldg(reinterpret_cast<const int4*>(p))
             : make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ Step load_step(const int* y0r, const int* srcr, int b0, bool vec) {
  return {load4(y0r + b0, vec), load4(srcr + b0, vec)};
}

__device__ __forceinline__ int comp(const int4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// A thread's four positions as one word of bytes; an unresolved one is 0.
__device__ __forceinline__ uint32_t pack_bytes(const int (&cur)[PER]) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) word |= (uint32_t)(cur[j] < 0 ? 0 : cur[j] & 255) << (8 * j);
  return word;
}

__global__ void __launch_bounds__(THREADS, 2)
    sweep_kernel(const int* __restrict__ tail, const int* __restrict__ y0,
                 const int* __restrict__ src, int* __restrict__ y, int* __restrict__ status,
                 int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* bytes = smem;                              // the tile's resolved bytes
  int* state = reinterpret_cast<int*>(smem + N_POS);  // >= 0: byte; < 0: -(1 + in-step source)
  __shared__ int s_unres;
  const int t = threadIdx.x;
  const int i0 = PER * t;  // the thread's first position in a step
  const size_t row = (size_t)blockIdx.x * N_POS;
  const int* y0r = y0 + row + i0;
  const int* srcr = src + row + i0;
  const int* tl = tail + (size_t)blockIdx.x * TAIL;
  const bool vin = vec & VEC_IN;
  Step next = load_step(y0r, srcr, 0, vin);
  Step after = load_step(y0r, srcr, STEP, vin);
  if (t == 0) s_unres = 0;

  int rounds = 0, unres = 0;
  for (int s = 0; s < N_STEPS; ++s) {
    const int b0 = s * STEP;
    const Step x = next;
    next = after;
    if (s + 2 < N_STEPS) after = load_step(y0r, srcr, b0 + 2 * STEP, vin);
    // The four reads of final bytes issue together; one whose source is
    // not before the step is discarded.
    int fin[PER], cur[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = b0 + i0 + j;
      const int sj = comp(x.s, j);
      fin[j] = sj >= 0 ? bytes[sj & (N_POS - 1)]
                       : (sj >= p - WINDOW ? __ldg(tl + sj + TAIL) & 255 : 0);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = b0 + i0 + j;
      const int vj = comp(x.v, j), sj = comp(x.s, j);
      const bool before = sj >= p - WINDOW && sj < b0;  // final: the tail or an earlier step
      const bool inside = sj >= b0 && sj < p;
      // Out of domain: a self pointer, never resolved.
      cur[j] = vj >= 0 ? vj : (before ? fin[j] : -1 - (inside ? sj - b0 : i0 + j));
    }
    *reinterpret_cast<int4*>(&state[i0]) = make_int4(cur[0], cur[1], cur[2], cur[3]);
    __syncthreads();  // every initial state of the step written
    bool live[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) live[j] = cur[j] < 0;
#pragma unroll 1
    for (int h = 0; h < CHASE; ++h) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (live[j]) {
          const int nxt = state[-1 - cur[j]];
          live[j] = nxt != cur[j] && nxt < 0;  // nxt == cur: a self pointer
          cur[j] = nxt;
          any |= live[j];
        }
      }
      if (!any) break;
    }
    // A pointer that reads itself back has reached a self pointer: stuck.
    bool pend[PER], anyp = false;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      pend[j] = cur[j] < 0 && state[-1 - cur[j]] != cur[j];
      anyp |= pend[j];
    }
    // The step's bytes go to shared memory before the vote, whose barrier
    // makes them visible to the next step (a pending position's word is
    // written again after the rounds).
    uint32_t* slot = reinterpret_cast<uint32_t*>(&bytes[b0 + i0]);
    *slot = pack_bytes(cur);
    int r = 0;
    while (r < MAX_ROUNDS && __syncthreads_or(anyp)) {
      *reinterpret_cast<int4*>(&state[i0]) = make_int4(cur[0], cur[1], cur[2], cur[3]);
      __syncthreads();
      anyp = false;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (pend[j]) {
          cur[j] = state[-1 - cur[j]];  // a byte, or the source's own source (doubling)
          pend[j] = cur[j] < 0 && state[-1 - cur[j]] != cur[j];
          anyp |= pend[j];
        }
      }
      ++r;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (cur[j] < 0) {
        cur[j] = 0;
        ++unres;
      }
    }
    if (r) *slot = pack_bytes(cur);
    int* yo = y + row + b0 + i0;
    if (vec & VEC_OUT) {
      *reinterpret_cast<int4*>(yo) = make_int4(cur[0], cur[1], cur[2], cur[3]);
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j) yo[j] = cur[j];
    }
    rounds += r;
    // After rounds: the rewritten words are seen by the next step, and no
    // thread still reads the state it is about to overwrite.
    if (r) __syncthreads();
  }
  if (unres) atomicAdd(&s_unres, unres);
  __syncthreads();
  if (t < 8) status[blockIdx.x * 8 + t] = t == 0 ? s_unres : (t == 1 ? rounds : 0);
}

}  // namespace

extern "C" int td_sweep(const void* tail, const void* y0, const void* src, void* y, void* status,
                        int L, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = (a16(y0) && a16(src) ? VEC_IN : 0) | (a16(y) ? VEC_OUT : 0);
  sweep_kernel<<<L, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tail), static_cast<const int*>(y0), static_cast<const int*>(src),
      static_cast<int*>(y), static_cast<int*>(status), vec);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the sweep.
extern "C" int td_sweep_occupancy(int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, sweep_kernel, THREADS, SMEM_BYTES);
  return (int)err;
}
