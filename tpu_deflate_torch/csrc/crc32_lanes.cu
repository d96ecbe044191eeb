// Lane CRC-32 of resolved rows.
//
// Replaces tpu_deflate/kernels/checksum_jax.py:crc32_lanes_raw8, an XLA
// function in the reference (int8 GF(2) matrix products on the MXU). rows
// (L, W) uint8, W = 512 n with n a power of two up to 1024; raw (L,) uint32
// gets the raw CRC register (init 0, no conditioning) of each whole row,
// which the host finishes per lane (checksum_lanes.crc32_finish_leftaligned).
// The reference expands every byte into 8 int8 bits for a matrix product,
// because the TPU has no table lookup; the table CRC reads each byte once.
//
// One 128-thread block per lane, a thread per 512-byte chunk, filled 64 of
// the 132 SMs on the encoder's 64-lane batches; each thread's 8-byte loads
// lay 512 bytes from its neighbour's; every block rebuilt its tables behind
// barriers and combined its chunks in a tree over shared memory. Here:
//
// - A row is cut into units of 32 P bytes, P = 64 (16 for rows of 512 and
//   1024 bytes), one unit a step of a warp: lane j reads the P bytes at
//   P j of the unit (16-byte loads; the warp's loads of a step cover the
//   unit once) and folds them into its register, acc = A(acc) ^ crc(piece),
//   where crc(piece) is P / 8 slice-by-8 steps from 0 and A, the shift past
//   one unit, four byte-sliced lookups (not needed for the first step).
// - Each row's units are split over C blocks of 8 warps, S consecutive
//   units a warp, and the C blocks of a row form a thread-block cluster. C
//   doubles while the launch has fewer than 256 blocks and each warp keeps
//   two steps (checksum_lanes.kernel_split): C = 1 and 2 for the decode's
//   256- and 178-row batches of 64 KiB rows, 2 for the encoder's 64-row
//   batches (1, 2 and 4 were timed on the H100 at each batch, with the L2
//   cache cold, and these were the fastest at each). A warp's first two
//   steps are loaded before anything else.
// - Lane j's register then stands P (31 - j) bytes before the end of the
//   warp's span: each lane applies that shift as 32 select-and-XOR steps
//   over operator words (one per lane and bit, conflict-free in shared
//   memory), and a warp XOR reduction gives the span's register. The warp
//   shifts it past the rest of the row with one operator of its own
//   (checksum_lanes.warp_ops: lane b holds the image of bit b, loaded while
//   the data is in flight; lane b selects it by bit b, and a warp XOR
//   reduction applies it). The row's register is the XOR of its warps':
//   each warp writes its word into the shared memory of the cluster's first
//   block, and after a cluster barrier that block's first warp writes it.
// - The tables (slice-by-8, 8 KiB; the lane operators, 4 KiB; where a warp
//   takes more than one step, A's, 4 KiB) come from the host
//   (checksum_lanes.kernel_tables) and are copied into shared memory with
//   16-byte loads after the first step's loads are issued, so that the
//   latencies overlap.
//
// Bound on the H100: memory traffic, one read of each byte (4 MiB for the
// encoder's 64 x 64 KiB batch). The shared-memory lookups come next: one a
// byte (plus 4 a step past the first), at random banks, then the table
// copies and the cluster barrier of each block. Pieces of 16 bytes (an A
// step each) with the warps combined level by level, operators of 32 words
// for every lane read from device memory, and slice-by-4 tables held once
// per lane (conflict-free lookups, but 128 KiB of shared memory: one block
// per SM, whose table build cost more than the conflicts) ran slower
// (PERF.md, section 6).
#include <cooperative_groups.h>

#include "td_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK = 512;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNKS = 1024;
constexpr int MAX_CLUSTER = 8;
// Table words (checksum_lanes.kernel_tables): slice-by-8 [8][256], then for
// P = 16 and for P = 64: A [4][256] and the lane operators [32 bits][32
// lanes].
constexpr int T8_WORDS = 8 * 256, TA_WORDS = 4 * 256, OPL_WORDS = 32 * 32;

struct Tables {
  uint32_t t8[8][256];
  uint32_t opl[32][32];
  uint32_t ta[4][256];  // copied only where a warp takes more than one step
};

// One slice-by-8 step: the register after 8 more bytes (x, y).
__device__ __forceinline__ uint32_t step8(const Tables& T, uint32_t r, uint32_t x, uint32_t y) {
  const uint32_t lo = x ^ r;
  return T.t8[7][lo & 0xFFu] ^ T.t8[6][(lo >> 8) & 0xFFu] ^ T.t8[5][(lo >> 16) & 0xFFu] ^ T.t8[4][lo >> 24] ^
         T.t8[3][y & 0xFFu] ^ T.t8[2][(y >> 8) & 0xFFu] ^ T.t8[1][(y >> 16) & 0xFFu] ^ T.t8[0][y >> 24];
}

// Copy n words of src into dst, 16 bytes a thread and step.
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* __restrict__ src, int n, int tid) {
  for (int i = tid; i < n / 4; i += THREADS)
    reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
}

// rows (L, width) -> raw (L,). Grid: L * C blocks in clusters of C; warp w
// < wu of block rank r is warp g = r * wu + w of its row and takes the S
// units from g * S; ops: (C * wu, 32 bits) image words of each warp's shift
// from the end of its span to the end of the row.
template <int P>
__global__ void __launch_bounds__(THREADS)
    crc32_lanes_kernel(const uint8_t* __restrict__ rows, const uint32_t* __restrict__ tables,
                       const uint32_t* __restrict__ ops, uint32_t* __restrict__ raw, int width, int C,
                       int wu, int S) {
  constexpr int Q = P / 16;    // 16-byte loads a lane and step
  constexpr int U = 32 * P;    // bytes a warp step
  __shared__ __align__(16) Tables T;
  __shared__ uint32_t part[MAX_CLUSTER * WARPS];
  cg::cluster_group cluster = cg::this_cluster();
  // Arrive now, wait before the first access to another block's shared
  // memory: every block of the cluster has started by then.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int r = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const bool active = w < wu;
  const int g = r * wu + w;
  const uint4* q = reinterpret_cast<const uint4*>(rows + (size_t)row * width + (size_t)g * S * U + P * lane);
  // The first two steps' loads go out before anything else, so that the
  // warp's whole span is in flight at once where S <= 2.
  uint4 cur[Q], nxt[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    cur[i] = active ? __ldg(q + i) : make_uint4(0, 0, 0, 0);
    nxt[i] = active && S > 1 ? __ldg(q + U / 16 + i) : make_uint4(0, 0, 0, 0);
  }
  const uint32_t op = active ? __ldg(ops + g * 32 + lane) : 0u;

  constexpr int PT = T8_WORDS + (P == 64 ? TA_WORDS + OPL_WORDS : 0);  // this P's A, then lane operators
  copy_words(&T.t8[0][0], tables, T8_WORDS, tid);
  copy_words(&T.opl[0][0], tables + PT + TA_WORDS, OPL_WORDS, tid);
  if (S > 1) copy_words(&T.ta[0][0], tables + PT, TA_WORDS, tid);
  __syncthreads();

  uint32_t v = 0;
  if (active) {
    uint32_t acc = 0;
    for (int k = 0; k < S; ++k) {
      uint32_t c = 0;
#pragma unroll
      for (int i = 0; i < Q; ++i) c = step8(T, step8(T, c, cur[i].x, cur[i].y), cur[i].z, cur[i].w);
      if (k > 0)
        c ^= T.ta[0][acc & 0xFFu] ^ T.ta[1][(acc >> 8) & 0xFFu] ^ T.ta[2][(acc >> 16) & 0xFFu] ^
             T.ta[3][acc >> 24];
      acc = c;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        cur[i] = nxt[i];
        if (k + 2 < S) nxt[i] = __ldg(q + (k + 2) * (U / 16) + i);
      }
    }
    uint32_t t = 0;
#pragma unroll 8
    for (int b = 0; b < 32; ++b) t ^= ((acc >> b) & 1u) ? T.opl[b][lane] : 0u;
    v = __reduce_xor_sync(0xffffffffu, t);
    v = __reduce_xor_sync(0xffffffffu, ((v >> lane) & 1u) ? op : 0u);
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (lane == 0) cluster.map_shared_rank(part, 0)[r * WARPS + w] = v;
  cluster.sync();
  if (r == 0 && w == 0) {
    const int n = C * WARPS;
    uint32_t x = (lane < n ? part[lane] : 0u) ^ (lane + 32 < n ? part[lane + 32] : 0u);
    x = __reduce_xor_sync(0xffffffffu, x);
    if (lane == 0) raw[row] = x;
  }
}

}  // namespace

// tables: checksum_lanes.kernel_tables; ops: checksum_lanes.warp_ops of the
// split (P, C, wu, S) that checksum_lanes.kernel_split gives; rows, tables
// 16-byte aligned.
extern "C" int td_crc32_lanes(const void* rows, const void* tables, const void* ops, void* raw, int L,
                              int width, int P, int C, int wu, int S, void* stream) {
  if (L < 1 || (P != 16 && P != 64) || C < 1 || C > MAX_CLUSTER || wu < 1 || wu > WARPS || S < 1 ||
      (long)C * wu * S * 32 * P != width || width > MAX_CHUNKS * CHUNK ||
      (reinterpret_cast<uintptr_t>(rows) & 15) != 0 || (reinterpret_cast<uintptr_t>(tables) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto* r8 = static_cast<const uint8_t*>(rows);
  const auto* tab = static_cast<const uint32_t*>(tables);
  const auto* op = static_cast<const uint32_t*>(ops);
  auto* out = static_cast<uint32_t*>(raw);
  const cudaError_t err =
      P == 64 ? cudaLaunchKernelEx(&cfg, crc32_lanes_kernel<64>, r8, tab, op, out, width, C, wu, S)
              : cudaLaunchKernelEx(&cfg, crc32_lanes_kernel<16>, r8, tab, op, out, width, C, wu, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
