// Variants of the match finder's chain kernel (tpu_deflate_torch/csrc/match.cu,
// match_chain_kernel), for scripts/chain_variants.py: each writes the same
// links (F, L, S) uint16 from the same keys, and they differ in how warps
// walk a row. match.cu's kernel is variant 33 (chain_split_kernel with 16
// walkers, chunks of 4096, staged links and 4 steps ahead).
//
//   PARTS   hash parts, a block each (the heads of one part in shared memory)
//   WIDE    int32 heads holding the position (no epochs) instead of uint16
//           heads holding it modulo 65536 with a rewrite of the stale heads
//           every CHAIN_EPOCH positions
//   ONEWARP the block is the walking warp alone (it also rewrites the heads)
//   PREFETCH the next 8 steps' keys are loaded before the current 8 are walked
//   HOIST   the 8 steps' __match_any_sync calls come before their head reads
//   SHFL    the peers come from 31 shuffles up and down instead of
//           __match_any_sync
//   BUFFER  each step's links are kept in registers and stored after the 8
//           steps, not inside each step
//   NOSYNC  no __syncwarp between a step's head reads and writes: every lane
//           reads a head (volatile, no branch) and the warp's instructions are
//           left to run in order (a measurement of what the syncs cost; the
//           CUDA memory model does not promise this order)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIST = 32768;
constexpr int EPOCH = 16384;
constexpr int SENTINEL_BACK = 49152;
constexpr int U = 8;

struct Peers {
  unsigned below;  // peer lanes below this one
  bool last;       // no peer lane above
};

// The lanes holding the same key as this one (-1: none, inactive lanes
// match each other only) from BITS + 1 ballots, one per bit of the key.
template <int BITS>
__device__ __forceinline__ unsigned radix_match(int key) {
  unsigned m = __ballot_sync(0xFFFFFFFFu, key >= 0);
  if (key < 0) m = ~m;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned bb = __ballot_sync(0xFFFFFFFFu, (key >> b) & 1);
    m &= ((key >> b) & 1) ? bb : ~bb;
  }
  return m;
}

template <bool SHFL, int RADIX = 0>
__device__ __forceinline__ Peers peers_of(int key, int lane) {
  if (RADIX) {
    const unsigned m = radix_match<RADIX>(key);
    return {m & ((1u << lane) - 1u), (m >> lane) == 1u};
  }
  if (!SHFL) {
    const unsigned m = __match_any_sync(0xFFFFFFFFu, key);
    return {m & ((1u << lane) - 1u), (m >> lane) == 1u};
  }
  unsigned below = 0;
  bool last = true;
#pragma unroll
  for (int d = 1; d < 32; ++d) {
    const int up = __shfl_up_sync(0xFFFFFFFFu, key, d);
    const int down = __shfl_down_sync(0xFFFFFFFFu, key, d);
    if (lane >= d && up == key) below |= 1u << (lane - d);
    if (lane + d < 32 && down == key) last = false;
  }
  return {below, last};
}

template <int PARTS, bool WIDE, bool ONEWARP, bool PREFETCH, bool HOIST, bool SHFL, bool BUFFER = false,
          bool NOSYNC = false, int RADIX = 0>
__global__ void chain_kernel(const int* __restrict__ keys, uint16_t* __restrict__ prev, int S) {
  constexpr int HEADS = 65536 / PARTS;
  constexpr int THREADS = ONEWARP ? 32 : 128;
  __shared__ uint32_t heads_raw[WIDE ? HEADS : HEADS / 2];
  int* wide = reinterpret_cast<int*>(heads_raw);
  uint16_t* narrow = reinterpret_cast<uint16_t*>(heads_raw);
  volatile uint16_t* vnarrow = narrow;
  const int part = blockIdx.x;
  const size_t row = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * S;
  const int* kr = keys + row;
  uint16_t* pr = prev + row;
  const int lane = threadIdx.x & 31;
  const int epoch = WIDE ? S : EPOCH;
  for (int e0 = 0; e0 < S; e0 += epoch) {
    if (WIDE) {
      if (e0 == 0)
        for (int j = threadIdx.x; j < HEADS; j += THREADS) wide[j] = -MAX_DIST - 1;
    } else {
      const uint32_t sentinel = (uint32_t)(e0 - SENTINEL_BACK) & 0xFFFFu;
      for (int j = threadIdx.x; j < HEADS / 2; j += THREADS) {
        uint32_t two = heads_raw[j];
        uint32_t lo = two & 0xFFFFu, hi = two >> 16;
        if (e0 == 0 || (int)(((uint32_t)e0 - lo - 1u) & 0xFFFFu) + 1 > MAX_DIST) lo = sentinel;
        if (e0 == 0 || (int)(((uint32_t)e0 - hi - 1u) & 0xFFFFu) + 1 > MAX_DIST) hi = sentinel;
        heads_raw[j] = lo | hi << 16;
      }
    }
    if (ONEWARP) __syncwarp(); else __syncthreads();
    if (threadIdx.x < 32) {
      const int e1 = min(S, e0 + epoch);
      int hk[U], hn[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = e0 + 32 * u + lane;
        hk[u] = p < e1 ? __ldg(kr + p) : -1;
      }
      for (int base = e0; base < e1; base += 32 * U) {
        if (PREFETCH) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int p = base + 32 * (U + u) + lane;
            hn[u] = p < e1 ? __ldg(kr + p) : -1;
          }
        }
        Peers pe[U];
        if (HOIST) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int h = hk[u];
            const bool mine = h >= 0 && (h / HEADS) == part;
            pe[u] = peers_of<SHFL, RADIX>(mine ? (RADIX ? h & (HEADS - 1) : h) : -1, lane);
          }
        }
        int dv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = base + 32 * u + lane;
          const int h = hk[u];
          const bool mine = h >= 0 && (h / HEADS) == part;
          const int slot = h & (HEADS - 1);
          const Peers q = HOIST ? pe[u] : peers_of<SHFL, RADIX>(mine ? (RADIX ? h & (HEADS - 1) : h) : -1, lane);
          int d = 0;
          if (NOSYNC && !WIDE) {
            const int back = (int)(((uint32_t)p - vnarrow[slot] - 1u) & 0xFFFFu) + 1;
            const int hd = back <= MAX_DIST ? back : 0;
            d = mine ? (q.below ? lane - (31 - __clz(q.below)) : hd) : 0;
            if (mine && q.last) vnarrow[slot] = (uint16_t)p;
          } else if (mine) {
            if (q.below) {
              d = lane - (31 - __clz(q.below));
            } else if (WIDE) {
              const int back = p - wide[slot];
              d = back <= MAX_DIST ? back : 0;
            } else {
              const int back = (int)(((uint32_t)p - narrow[slot] - 1u) & 0xFFFFu) + 1;
              d = back <= MAX_DIST ? back : 0;
            }
          }
          if (!NOSYNC || WIDE) {
            __syncwarp();
            if (mine && q.last) {
              if (WIDE) wide[slot] = p; else narrow[slot] = (uint16_t)p;
            }
            __syncwarp();
          }
          if (BUFFER) {
            dv[u] = (p < e1 && (mine || (h < 0 && part == 0))) ? d : -1;
          } else if (p < e1 && (mine || (h < 0 && part == 0))) {
            pr[p] = (uint16_t)d;
          }
        }
        if (BUFFER) {
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (dv[u] >= 0) pr[base + 32 * u + lane] = (uint16_t)dv[u];
        }
        if (PREFETCH) {
#pragma unroll
          for (int u = 0; u < U; ++u) hk[u] = hn[u];
        } else if (base + 32 * U < e1) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int p = base + 32 * (U + u) + lane;
            hk[u] = p < e1 ? __ldg(kr + p) : -1;
          }
        }
      }
    }
    if (ONEWARP) __syncwarp(); else __syncthreads();
  }
}

template <int PARTS, bool WIDE, bool ONEWARP, bool PREFETCH, bool HOIST, bool SHFL, bool BUFFER = false,
          bool NOSYNC = false, int RADIX = 0>
int launch(const int* keys, uint16_t* prev, int L, int S, int F, cudaStream_t stream) {
  const dim3 grid(PARTS, L, F);
  chain_kernel<PARTS, WIDE, ONEWARP, PREFETCH, HOIST, SHFL, BUFFER, NOSYNC, RADIX>
      <<<grid, ONEWARP ? 32 : 128, 0, stream>>>(keys, prev, S);
  return (int)cudaGetLastError();
}

// Dense walk: the block's four warps first gather the positions of its hash
// part from a chunk of CHUNK positions (ballots, in position order, as a
// list of (key within the part, offset in the chunk)), then warp 0 walks only
// those, 32 list entries a step; the next chunk's keys are loaded while it
// walks.
template <int PARTS, int CHUNK, bool RADIX = false>
__global__ void __launch_bounds__(128) chain_dense_kernel(const int* __restrict__ keys, uint16_t* __restrict__ prev,
                                                          int S) {
  constexpr int HEADS = 65536 / PARTS;
  constexpr int KEY_BITS = PARTS == 4 ? 14 : PARTS == 8 ? 13 : 12;
  constexpr int WARPS = 4;
  constexpr int BALLOTS = CHUNK / WARPS / 32;
  __shared__ uint32_t heads2[HEADS / 2];
  __shared__ uint32_t list[CHUNK];
  __shared__ int counts[WARPS];
  uint16_t* head = reinterpret_cast<uint16_t*>(heads2);
  const int part = blockIdx.x;
  const size_t row = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * S;
  const int* kr = keys + row;
  uint16_t* pr = prev + row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int hk[BALLOTS];
#pragma unroll
  for (int b = 0; b < BALLOTS; ++b) {
    const int p = warp * (CHUNK / WARPS) + 32 * b + lane;
    hk[b] = p < S ? __ldg(kr + p) : -1;
  }
  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    if (c0 % EPOCH == 0) {
      const uint32_t sentinel = (uint32_t)(c0 - SENTINEL_BACK) & 0xFFFFu;
      for (int j = threadIdx.x; j < HEADS / 2; j += 128) {
        uint32_t two = heads2[j];
        uint32_t lo = two & 0xFFFFu, hi = two >> 16;
        if (c0 == 0 || (int)(((uint32_t)c0 - lo - 1u) & 0xFFFFu) + 1 > MAX_DIST) lo = sentinel;
        if (c0 == 0 || (int)(((uint32_t)c0 - hi - 1u) & 0xFFFFu) + 1 > MAX_DIST) hi = sentinel;
        heads2[j] = lo | hi << 16;
      }
    }
    unsigned m[BALLOTS];
    int cnt = 0;
#pragma unroll
    for (int b = 0; b < BALLOTS; ++b) {
      const int p = c0 + warp * (CHUNK / WARPS) + 32 * b + lane;
      const int h = hk[b];
      m[b] = __ballot_sync(0xFFFFFFFFu, h >= 0 && (h >> KEY_BITS) == part);
      cnt += __popc(m[b]);
      if (part == 0 && p < S && h < 0) pr[p] = 0;
    }
    if (lane == 0) counts[warp] = cnt;
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? counts[w] : 0;
      n += counts[w];
    }
#pragma unroll
    for (int b = 0; b < BALLOTS; ++b) {
      if ((m[b] >> lane) & 1u)
        list[off + __popc(m[b] & lower)] =
            (uint32_t)(hk[b] & (HEADS - 1)) | (uint32_t)(warp * (CHUNK / WARPS) + 32 * b + lane) << KEY_BITS;
      off += __popc(m[b]);
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < BALLOTS; ++b) {
      const int p = c0 + CHUNK + warp * (CHUNK / WARPS) + 32 * b + lane;
      hk[b] = p < S ? __ldg(kr + p) : -1;
    }
    if (warp == 0) {
      for (int s0 = 0; s0 < n; s0 += 32) {
        const bool act = s0 + lane < n;
        const uint32_t e = act ? list[s0 + lane] : 0u;
        const int k = act ? (int)(e & (HEADS - 1)) : -1;
        const int q = c0 + (int)(e >> KEY_BITS);
        const unsigned peers = RADIX ? radix_match<KEY_BITS>(k) : __match_any_sync(0xFFFFFFFFu, k);
        const unsigned below = peers & lower;
        const int qp = __shfl_sync(0xFFFFFFFFu, q, below ? 31 - __clz(below) : lane);
        int d = 0;
        if (act) {
          if (below) {
            d = q - qp;
          } else {
            const int back = (int)(((uint32_t)q - head[k] - 1u) & 0xFFFFu) + 1;
            d = back <= MAX_DIST ? back : 0;
          }
        }
        __syncwarp();
        if (act && (peers >> lane) == 1u) head[k] = (uint16_t)q;
        __syncwarp();
        if (act) pr[q] = (uint16_t)d;
      }
    }
    __syncthreads();
  }
}

template <int PARTS, int CHUNK, bool RADIX = false>
int launch_dense(const int* keys, uint16_t* prev, int L, int S, int F, cudaStream_t stream) {
  const dim3 grid(PARTS, L, F);
  chain_dense_kernel<PARTS, CHUNK, RADIX><<<grid, 128, 0, stream>>>(keys, prev, S);
  return (int)cudaGetLastError();
}

// One block a row: the heads of every hash (uint16, 128 KiB of dynamic
// shared memory) and WALKERS warps. Each chunk of CHUNK positions is first
// split stably by hash part (the hash's top bits) into one list a part, by
// all the block's threads (a thread takes positions t, t + 32 WALKERS, ...;
// the same-part lanes of a warp from ballots on the part's bits, their
// counts scanned in shared memory); then warp w walks part w's list, 32
// entries a step, __match_any_sync giving each entry's peers. The next
// chunk's keys are loaded before the walk.
template <int WALKERS, int CHUNK, bool TAGS = false, bool STAGE = false, int AHEAD = 1>
__global__ void __launch_bounds__(32 * WALKERS) chain_split_kernel(const int* __restrict__ keys,
                                                                   uint16_t* __restrict__ prev, int S) {
  constexpr int THREADS = 32 * WALKERS;
  constexpr int PART_BITS = WALKERS == 8 ? 3 : WALKERS == 16 ? 4 : 2;
  constexpr int PER = CHUNK / THREADS;  // positions a thread a chunk
  extern __shared__ uint32_t split_smem[];
  uint16_t* head = reinterpret_cast<uint16_t*>(split_smem);  // 65536
  uint8_t* tag = reinterpret_cast<uint8_t*>(split_smem + 32768);  // 65536 lane ids (TAGS)
  uint32_t* list = split_smem + 32768 + (TAGS ? 16384 : 0);  // CHUNK entries: hash | offset << 16
  int* cnt = reinterpret_cast<int*>(list + CHUNK);           // [PER][WALKERS warps][WALKERS parts]
  int* base = cnt + PER * WALKERS * WALKERS;                 // [WALKERS + 1]
  uint16_t* stage = reinterpret_cast<uint16_t*>(base + WALKERS + 4);  // CHUNK links (STAGE)
  const size_t row = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * S;
  const int* kr = keys + row;
  uint16_t* pr = prev + row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int hk[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = threadIdx.x + THREADS * j;
    hk[j] = p < S ? __ldg(kr + p) : -1;
  }
  for (int c0 = 0; c0 < S; c0 += CHUNK) {
    if (c0 % EPOCH == 0) {
      const uint32_t sentinel = (uint32_t)(c0 - SENTINEL_BACK) & 0xFFFFu;
      for (int j = threadIdx.x; j < 32768; j += THREADS) {
        uint32_t two = split_smem[j];
        uint32_t lo = two & 0xFFFFu, hi = two >> 16;
        if (c0 == 0 || (int)(((uint32_t)c0 - lo - 1u) & 0xFFFFu) + 1 > MAX_DIST) lo = sentinel;
        if (c0 == 0 || (int)(((uint32_t)c0 - hi - 1u) & 0xFFFFu) + 1 > MAX_DIST) hi = sentinel;
        split_smem[j] = lo | hi << 16;
      }
    }
    // Same-part lanes and each part's count, a warp and sub-step at a time.
    unsigned same[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int h = hk[j];
      const int part = h >= 0 ? h >> (16 - PART_BITS) : -1;
      unsigned bits[PART_BITS + 1];
      bits[PART_BITS] = __ballot_sync(0xFFFFFFFFu, h >= 0);
#pragma unroll
      for (int b = 0; b < PART_BITS; ++b) bits[b] = __ballot_sync(0xFFFFFFFFu, (part >> b) & 1);
      unsigned mine = bits[PART_BITS], theirs = bits[PART_BITS];  // lanes of my part; of part `lane`
#pragma unroll
      for (int b = 0; b < PART_BITS; ++b) {
        mine &= ((part >> b) & 1) ? bits[b] : ~bits[b];
        theirs &= ((lane >> b) & 1) ? bits[b] : ~bits[b];
      }
      same[j] = h >= 0 ? mine : 0u;
      if (lane < WALKERS) cnt[(j * WALKERS + warp) * WALKERS + lane] = __popc(theirs);
      const int p = c0 + threadIdx.x + THREADS * j;
      if (STAGE) {
        if (h < 0) stage[threadIdx.x + THREADS * j] = 0;
      } else if (h < 0 && p < S) {
        pr[p] = 0;
      }
    }
    __syncthreads();
    // Part w's counts, scanned in (sub-step, warp) order by warp w; the
    // parts' totals, scanned by thread 0.
    {
      const int k = warp;
      int run = 0;
      for (int i0 = 0; i0 < PER * WALKERS; i0 += 32) {
        const int i = i0 + lane;
        const int v = i < PER * WALKERS ? cnt[i * WALKERS + k] : 0;
        int incl = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
          if (lane >= d) incl += t;
        }
        if (i < PER * WALKERS) cnt[i * WALKERS + k] = run + incl - v;
        run += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      if (lane == 0) base[k + 1] = run;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      base[0] = 0;
      for (int k = 0; k < WALKERS; ++k) base[k + 1] += base[k];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int h = hk[j];
      if (h >= 0) {
        const int part = h >> (16 - PART_BITS);
        const int at = base[part] + cnt[(j * WALKERS + warp) * WALKERS + part] + __popc(same[j] & lower);
        list[at] = (uint32_t)h | (uint32_t)(threadIdx.x + THREADS * j) << 16;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = c0 + CHUNK + threadIdx.x + THREADS * j;
      hk[j] = p < S ? __ldg(kr + p) : -1;
    }
    const int b0 = base[warp], n = base[warp + 1] - b0;
    if (AHEAD > 1) {
      // AHEAD steps' entries, peers and in-step predecessors first, then
      // their head reads and writes in order.
      for (int s0 = 0; s0 < n; s0 += 32 * AHEAD) {
        int hs[AHEAD], qs[AHEAD], qps[AHEAD];
        unsigned ps[AHEAD];
#pragma unroll
        for (int a = 0; a < AHEAD; ++a) {
          const int i = s0 + 32 * a + lane;
          const bool act = i < n;
          const uint32_t e = act ? list[b0 + i] : 0u;
          hs[a] = act ? (int)(e & 0xFFFFu) : -1;
          qs[a] = c0 + (int)(e >> 16);
        }
#pragma unroll
        for (int a = 0; a < AHEAD; ++a) {
          ps[a] = __match_any_sync(0xFFFFFFFFu, hs[a]);
          const unsigned below = ps[a] & lower;
          qps[a] = __shfl_sync(0xFFFFFFFFu, qs[a], below ? 31 - __clz(below) : lane);
        }
#pragma unroll
        for (int a = 0; a < AHEAD; ++a) {
          const bool act = hs[a] >= 0;
          const unsigned below = ps[a] & lower;
          int d = 0;
          if (act) {
            if (below) {
              d = qs[a] - qps[a];
            } else {
              const int back = (int)(((uint32_t)qs[a] - head[hs[a]] - 1u) & 0xFFFFu) + 1;
              d = back <= MAX_DIST ? back : 0;
            }
          }
          __syncwarp();
          if (act && (ps[a] >> lane) == 1u) head[hs[a]] = (uint16_t)qs[a];
          __syncwarp();
          if (act) stage[qs[a] - c0] = (uint16_t)d;
        }
      }
    } else
    for (int s0 = 0; s0 < n; s0 += 32) {
      const bool act = s0 + lane < n;
      const uint32_t e = act ? list[b0 + s0 + lane] : 0u;
      const int k = act ? (int)(e & 0xFFFFu) : -1;
      const int q = c0 + (int)(e >> 16);
      unsigned peers;
      if (TAGS) {
        // Each lane writes its id at its hash and reads it back: a lane that
        // reads another's shares its hash. Without such a lane no entry has
        // a peer and __match_any_sync is skipped.
        if (act) tag[k] = (uint8_t)lane;
        __syncwarp();
        const bool clash = act && tag[k] != lane;
        peers = __ballot_sync(0xFFFFFFFFu, clash) ? __match_any_sync(0xFFFFFFFFu, k) : 1u << lane;
      } else {
        peers = __match_any_sync(0xFFFFFFFFu, k);
      }
      const unsigned below = peers & lower;
      const int qp = __shfl_sync(0xFFFFFFFFu, q, below ? 31 - __clz(below) : lane);
      int d = 0;
      if (act) {
        if (below) {
          d = q - qp;
        } else {
          const int back = (int)(((uint32_t)q - head[k] - 1u) & 0xFFFFu) + 1;
          d = back <= MAX_DIST ? back : 0;
        }
      }
      __syncwarp();
      if (act && (peers >> lane) == 1u) head[k] = (uint16_t)q;
      __syncwarp();
      if (act) {
        if (STAGE) stage[q - c0] = (uint16_t)d; else pr[q] = (uint16_t)d;
      }
    }
    __syncthreads();
    if (STAGE) {
      const int n16 = min(CHUNK, S - c0);
      if ((n16 & 7) == 0 && ((reinterpret_cast<uintptr_t>(pr + c0)) & 15) == 0) {
        for (int j = threadIdx.x; j < n16 / 8; j += THREADS)
          reinterpret_cast<uint4*>(pr + c0)[j] = reinterpret_cast<const uint4*>(stage)[j];
      } else {
        for (int j = threadIdx.x; j < n16; j += THREADS) pr[c0 + j] = stage[j];
      }
    }
  }
}

template <int WALKERS, int CHUNK, bool TAGS = false, bool STAGE = false, int AHEAD = 1>
int launch_split(const int* keys, uint16_t* prev, int L, int S, int F, cudaStream_t stream) {
  constexpr int PER = CHUNK / (32 * WALKERS);
  const int smem = 4 * (32768 + (TAGS ? 16384 : 0) + CHUNK + PER * WALKERS * WALKERS + WALKERS + 4) +
                   (STAGE ? 2 * CHUNK : 0);
  cudaError_t err = cudaFuncSetAttribute(chain_split_kernel<WALKERS, CHUNK, TAGS, STAGE, AHEAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chain_split_kernel<WALKERS, CHUNK, TAGS, STAGE, AHEAD><<<dim3(L, F), 32 * WALKERS, smem, stream>>>(keys, prev, S);
  return (int)cudaGetLastError();
}

}  // namespace

// The variants, in the order scripts/chain_variants.py names them.
extern "C" int chain_variant(int v, const void* keys, void* prev, int L, int S, int F, void* stream) {
  const int* k = static_cast<const int*>(keys);
  uint16_t* p = static_cast<uint16_t*>(prev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return launch<4, false, false, false, false, false>(k, p, L, S, F, s);  // the first design
    case 1: return launch<4, false, false, true, false, false>(k, p, L, S, F, s);
    case 2: return launch<4, false, false, true, true, false>(k, p, L, S, F, s);
    case 3: return launch<4, false, true, true, true, false>(k, p, L, S, F, s);
    case 4: return launch<8, true, true, true, true, false>(k, p, L, S, F, s);
    case 5: return launch<4, false, true, true, true, true>(k, p, L, S, F, s);
    case 6: return launch<8, false, true, true, true, false>(k, p, L, S, F, s);
    case 7: return launch<16, false, true, true, true, false>(k, p, L, S, F, s);
    case 8: return launch<4, false, true, true, true, false, true>(k, p, L, S, F, s);
    case 9: return launch<4, false, true, true, true, false, true, true>(k, p, L, S, F, s);
    case 10: return launch<8, false, true, true, true, false, true>(k, p, L, S, F, s);
    case 11: return launch<4, false, true, true, true, false, false, true>(k, p, L, S, F, s);
    case 12: return launch_dense<8, 2048>(k, p, L, S, F, s);
    case 13: return launch_dense<16, 2048>(k, p, L, S, F, s);
    case 14: return launch_dense<8, 4096>(k, p, L, S, F, s);
    case 15: return launch_dense<4, 2048>(k, p, L, S, F, s);
    case 16: return launch<4, false, true, true, true, false, false, false, 14>(k, p, L, S, F, s);
    case 17: return launch_dense<8, 2048, true>(k, p, L, S, F, s);
    case 18: return launch_dense<4, 2048, true>(k, p, L, S, F, s);
    case 19: return launch_dense<8, 1024, true>(k, p, L, S, F, s);
    case 20: return launch_dense<16, 2048, true>(k, p, L, S, F, s);
    case 21: return launch_split<8, 2048>(k, p, L, S, F, s);
    case 22: return launch_split<16, 2048>(k, p, L, S, F, s);
    case 23: return launch_split<16, 4096>(k, p, L, S, F, s);
    case 24: return launch_split<8, 1024>(k, p, L, S, F, s);
    case 25: return launch_split<16, 4096, true>(k, p, L, S, F, s);
    case 26: return launch_split<16, 2048, true>(k, p, L, S, F, s);
    case 27: return launch_split<8, 2048, true>(k, p, L, S, F, s);
    case 28: return launch_split<16, 4096, false, true>(k, p, L, S, F, s);
    case 29: return launch_split<16, 4096, true, true>(k, p, L, S, F, s);
    case 30: return launch_split<16, 2048, false, true>(k, p, L, S, F, s);
    case 31: return launch_split<8, 4096, false, true>(k, p, L, S, F, s);
    case 32: return launch_split<16, 4096, false, true, 2>(k, p, L, S, F, s);
    case 33: return launch_split<16, 4096, false, true, 4>(k, p, L, S, F, s);
    default: return -1;
  }
}
