// Stage C's kernel (tpu_deflate_torch/csrc/stage_c.cu) with timestamps, for
// scripts/stage_c_probe.py: thread 0 of each block writes %globaltimer (ns)
// at the block's start (0), after its ticket (1), its maps staged (2), its
// chunk maps (3), the scan (4), the look-back done (6; warp 1 publishes the
// segment's map meanwhile), the replay (7) and its stores issued (8),
// then its ticket (9), and clock64() at its start (10) and end (11). The
// kernel is otherwise the production one; keep the two in step when either
// changes.
#include <cuda_pipeline_primitives.h>

#include "td_common.cuh"
#include "td_lookback.cuh"

#define STAMPS 12
#define STAMP(i)                                                   \
  do {                                                             \
    if (threadIdx.x == 0) {                                        \
      long long t_;                                                \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));       \
      my[i] = t_;                                                  \
    }                                                              \
  } while (0)

namespace {

using td::E_WIN;
using td::FLAG_AGG;
using td::FLAG_PREFIX;
using td::SENT_EOB;
using td::SENT_ERR;

constexpr int THREADS = 128;
constexpr int MAX_SEG = 512;     // tiles a segment at most
constexpr int MAX_CHUNKS = 32;   // chunks a segment at most, 4 threads or more each
constexpr int LOOK = 32;      // predecessors a look-back round, one a lane of warp 0
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(E_WIN % 16 == 0, "a map is whole 16-byte words");

// The load is unconditional (the index clamped into the map), so the 48
// lookups of a map's entries are independent loads with no branch between
// them: a load under the branch serialised them (~1 us a scan round).
__device__ __forceinline__ int apply(const uint8_t* m, int v) {
  const int got = m[min(max(v, 0), E_WIN - 1)];
  return v >= SENT_EOB ? v : (v < E_WIN ? got : SENT_ERR);
}

// v[i] = apply(m, v[i]) for each i: all the loads first, then the selects,
// so the N loads are in flight together.
template <int N>
__device__ __forceinline__ void apply_all(const uint8_t* m, int (&v)[N]) {
  int got[N];
#pragma unroll
  for (int i = 0; i < N; ++i) got[i] = m[min(max(v[i], 0), E_WIN - 1)];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = v[i] >= SENT_EOB ? v[i] : (v[i] < E_WIN ? got[i] : SENT_ERR);
}

// Orders this thread's accesses before and after it at the device's scope
// (a release after the map's stores, an acquire after its flag is seen);
// lighter than __threadfence(), which is sequentially consistent.
__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// A segment's exit state, the segment's map applied to its entry: to its
// status word (*st) and, for a lane's last segment, to final.
__device__ __forceinline__ void publish_exit(unsigned long long* st, const uint8_t* agg, int entry,
                                             uint8_t* final) {
  const int out = apply(agg, entry);
  atomicExch(st, FLAG_PREFIX | (uint32_t)out);
  if (final != nullptr) *final = (uint8_t)out;
}

__device__ __forceinline__ void copy_map(uint8_t* to, const uint8_t* from) {
  const uint4* f = reinterpret_cast<const uint4*>(from);
  uint4* t = reinterpret_cast<uint4*>(to);
  t[0] = f[0];
  t[1] = f[1];
  t[2] = f[2];
}

// The state entering segment seg (>= 1) of a lane, by one whole warp.
// status and pub point at the lane's first segment: status[j] is 0, FLAG_AGG
// (segment j's map is in pub[j]) or FLAG_PREFIX | its exit state. win
// (LOOK maps) and acc (one map) are the warp's shared scratch.
__device__ int look_back_map(const unsigned long long* status, const uint8_t* pub, int seg, uint8_t* win,
                             uint8_t* acc) {
  const int lid = threadIdx.x & 31;
  bool composed = false;  // acc holds the maps of the rounds walked, oldest first
  for (int top = seg - 1;; top -= LOOK) {
    const int j = top - lid;
    unsigned long long v = FLAG_PREFIX;  // before segment 0: never reached, 0 publishes its exit
    if (j >= 0) {
      // Segment j's block runs already (its ticket came first), so it
      // publishes; a fault that kept it from doing so traps, not hangs.
      const volatile unsigned long long* p = status + j;
      for (unsigned spins = 0; (v = *p) >> 32 == 0; ++spins)
        if (spins > (1u << 28)) __trap();
    }
    const unsigned prefix = __ballot_sync(FULL, (v >> 32) == 2);
    const int stop = prefix ? __ffs(prefix) - 1 : LOOK;  // lanes below stop hold maps
    if (lid < stop) {
      fence_acq_rel();  // the map was written before its flag
      const uint4* from = reinterpret_cast<const uint4*>(pub + (size_t)j * E_WIN);
      uint4* to = reinterpret_cast<uint4*>(win + lid * E_WIN);
      to[0] = __ldcg(from);
      to[1] = __ldcg(from + 1);
      to[2] = __ldcg(from + 2);
    }
    __syncwarp();
    if (prefix) {
      int s = (int)__shfl_sync(FULL, (uint32_t)v, stop);
      if (lid == 0) {
        for (int i = stop - 1; i >= 0; --i) s = apply(win + i * E_WIN, s);
        if (composed) s = apply(acc, s);
      }
      return __shfl_sync(FULL, s, 0);
    }
    // No exit state among these LOOK: their maps, oldest first, go in front
    // of acc, lane e taking entries e and e + 32 (those past 48 unused).
    int y[2] = {lid, lid + 32};
    for (int i = LOOK - 1; i >= 0; --i) apply_all(win + i * E_WIN, y);
    if (composed) apply_all(acc, y);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (lid + 32 * r < E_WIN) acc[lid + 32 * r] = (uint8_t)y[r];
    __syncwarp();
    composed = true;
  }
}

// G threads a chunk (4, 8 or 16), PER = 48 / G entries a thread.
template <int G>
__global__ void __launch_bounds__(THREADS)
    stage_c_kernel(const uint8_t* __restrict__ maps_g, const int* __restrict__ entry0,
                   uint8_t* __restrict__ entries, int* __restrict__ entries32, uint8_t* __restrict__ final_state,
                   uint8_t* __restrict__ pub, unsigned long long* __restrict__ status, int* __restrict__ ticket,
                   int NT, int seg_len, int nseg, int vec, long long* __restrict__ stamps) {
  constexpr int PER = E_WIN / G;
  static_assert(PER * G == E_WIN && G >= 4, "G divides the entries");
  __shared__ __align__(16) uint8_t maps[MAX_SEG * E_WIN];
  __shared__ __align__(16) uint8_t scan[2][MAX_CHUNKS * E_WIN];
  __shared__ __align__(16) uint8_t win[LOOK * E_WIN];
  __shared__ __align__(16) uint8_t acc[E_WIN];
  __shared__ int ent[MAX_SEG];
  __shared__ int s_ticket, s_entry;

  const int k = threadIdx.x;
  long long* my = stamps + (size_t)blockIdx.x * STAMPS;
  STAMP(0);
  if (k == 0) my[10] = clock64();
  if (k == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  STAMP(1);
  const int lane = s_ticket / nseg;
  const int seg = s_ticket - lane * nseg;
  const int t_begin = seg * seg_len;
  const int nt = min(seg_len, NT - t_begin);
  const uint8_t* src = maps_g + ((size_t)lane * NT + t_begin) * E_WIN;
  const int nbytes = nt * E_WIN;
  if (vec) {  // every 16-byte copy in flight at once
    for (int i = k; i < nbytes / 16; i += THREADS) __pipeline_memcpy_async(maps + 16 * i, src + 16 * i, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
#pragma unroll 8
    for (int i = k; i < nbytes; i += THREADS) maps[i] = src[i];
  }
  __syncthreads();
  STAMP(2);

  // Chunk c of C neighbouring tiles goes to the G threads c G .. c G + G - 1,
  // thread (c, g) taking the chunk's entries g, g + G, ... (PER of them).
  const int C = (nt + MAX_CHUNKS - 1) / MAX_CHUNKS;
  const int nchunks = (nt + C - 1) / C;  // at most THREADS / G (the wrapper's G)
  const int c = k / G, g = k - c * G;
  const bool mine = c < nchunks;
  const int t0 = c * C;
  const int t1 = min(t0 + C, nt);

  // Chunk maps: the thread's entries through the chunk's tiles, a tile's
  // PER lookups issued together.
  if (mine) {
    int v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = maps[t0 * E_WIN + g + G * i];
    for (int t = t0 + 1; t < t1; ++t) apply_all(maps + t * E_WIN, v);
#pragma unroll
    for (int i = 0; i < PER; ++i) scan[0][c * E_WIN + g + G * i] = (uint8_t)v[i];
  }
  __syncthreads();
  STAMP(3);

  // Inclusive scan of the chunk maps: after the round of distance d, chunk
  // c is chunks max(c - 2d + 1, 0)..c composed; an entry is one lookup a
  // round.
  int cur = 0;
  for (int d = 1; d < nchunks; d <<= 1) {
    const uint8_t* a = scan[cur];
    uint8_t* b = scan[cur ^ 1];
    if (mine) {
      int v[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) v[i] = a[(c >= d ? c - d : c) * E_WIN + g + G * i];
      if (c >= d) apply_all(a + c * E_WIN, v);
#pragma unroll
      for (int i = 0; i < PER; ++i) b[c * E_WIN + g + G * i] = (uint8_t)v[i];
    }
    __syncthreads();
    cur ^= 1;
  }
  STAMP(4);
  const uint8_t* incl = scan[cur];
  const uint8_t* agg = incl + (nchunks - 1) * E_WIN;  // the segment's map

  unsigned long long* st = status + (size_t)lane * nseg;
  uint8_t* pub_lane = pub + (size_t)lane * nseg * E_WIN;
  if (seg > 0 && k == 32) {  // warp 1 publishes the segment's map while warp 0 looks back
    copy_map(pub_lane + (size_t)seg * E_WIN, agg);
    fence_acq_rel();  // the map before its flag
    atomicExch(st + seg, FLAG_AGG);
  }
  if (k < 32) {
    const int s = seg == 0 ? entry0[lane] : look_back_map(st, pub_lane, seg, win, acc);
    STAMP(6);
    if (k == 0) {
      s_entry = s;
      if (seg == 0) publish_exit(st, agg, s, nseg == 1 ? final_state + lane : nullptr);
    }
  }
  __syncthreads();  // and the map's flag before the exit state's
  if (seg > 0 && k == 0) publish_exit(st + seg, agg, s_entry, seg == nseg - 1 ? final_state + lane : nullptr);

  if (mine && g == 0) {  // the chunk's replay from its entry
    int s = c == 0 ? s_entry : apply(incl + (c - 1) * E_WIN, s_entry);
    for (int t = t0; t < t1; ++t) {
      ent[t] = s;
      s = apply(maps + t * E_WIN, s);
    }
  }
  __syncthreads();
  STAMP(7);

  uint8_t* e8 = entries + (size_t)lane * NT + t_begin;
  int* e32 = entries32 + (size_t)lane * NT + t_begin;
  for (int i = k; i < nt; i += THREADS) {
    const int v = ent[i] & 0xFF;
    e8[i] = (uint8_t)v;
    e32[i] = v;
  }
  __syncthreads();
  STAMP(8);
  if (k == 0) my[11] = clock64();
  if (k == 0) my[9] = s_ticket;
}

}  // namespace

extern "C" int stage_c_probe(const void* maps, const void* entry0, void* entries, void* entries32, void* final_state,
                             void* scratch, void* stamps, int L, int NT, int seg_len, void* stream) {
  if (L < 1 || NT < 1 || seg_len < 1 || seg_len > MAX_SEG) return (int)cudaErrorInvalidValue;
  const int nseg = (NT + seg_len - 1) / seg_len;
  const long long blocks = (long long)L * nseg;
  const int vec = (reinterpret_cast<uintptr_t>(maps) & 15) == 0;
  uint8_t* pub = static_cast<uint8_t*>(scratch);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(pub + blocks * E_WIN);
  int* ticket = reinterpret_cast<int*>(status + blocks);
  const int n = min(seg_len, NT);
  const int C = (n + MAX_CHUNKS - 1) / MAX_CHUNKS;
  const int nchunks = (n + C - 1) / C;
  auto kernel = nchunks <= THREADS / 16 ? stage_c_kernel<16> : nchunks <= THREADS / 8 ? stage_c_kernel<8>
                                                                                        : stage_c_kernel<4>;
  kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(maps), static_cast<const int*>(entry0), static_cast<uint8_t*>(entries),
      static_cast<int*>(entries32), static_cast<uint8_t*>(final_state), pub, status, ticket, NT, seg_len, nseg,
      vec, static_cast<long long*>(stamps));
  return (int)cudaGetLastError();
}
