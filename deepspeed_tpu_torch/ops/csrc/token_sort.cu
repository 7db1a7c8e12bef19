// token_sort.cu — stable counting sort of tokens by expert id, for Hopper.
//
// Replaces the Pallas kernel of deepspeed_tpu/ops/pallas/token_sort.py
// (`token_sort` :53, the pallas_call at :66, kernel `_token_sort_kernel`
// :35). For expert ids idx [N] (int32 or int64) and E experts:
//   pos[i]    = number of j < i with idx[j] == idx[i]   (0-based rank in
//               expert idx[i]'s queue; the dropless MoE's scatter slot)
//   counts[e] = number of i with idx[i] == e
// An id outside [0, E) as its full value (negative, or an int64 past
// int32) matches no expert: it counts nowhere and gets pos 0. All
// arithmetic is int32, so the result is bit-equal to the plain version.
//
// What bounds it on the H100: neither bytes nor operations. At the MoE
// path's N = 4096, E = 8 it moves 49 KB (int64 ids in, pos out, counts
// out), about 0.015 us at 3.35 TB/s; the time is the launch and the chain
// of dependent steps after it. So the design keeps that chain short and
// independent of N: one launch, a grid of blocks, one pass over the ids.
//
// A block takes a tile of K x 1024 tokens (K sub-tiles, 4 where the
// counts fit in shared memory, else 2 or 1: `sub_tiles`); thread t holds
// tokens t, t + 1024, ... of the tile in registers (coalesced loads).
//   1. For each sub-tile a warp finds each lane's peers (the lanes with
//      its id; an invalid token carries E) as the and of one ballot a bit
//      of the id, log2(E + 1) ballots: the lane's rank among them is
//      __popc(peers & lanemask_lt), and the lowest peer writes the warp's
//      count of that expert into column j = k * 32 + warp of cnt[j][e]
//      (the columns in token order; each warp clears its own columns
//      first, so only a __syncwarp precedes the writes). __match_any_sync
//      did the same in the first version, at a cost that grows with the
//      distinct ids in a warp: E 128 at N 4096 ran 9.0 us against 6.5 by
//      ballots (PERF.md §5).
//   2. One barrier; then a warp an expert scans its K x 32 column counts:
//      lane l holds columns l, l + 32, ... (rows S = E | 1 words apart, so
//      conflict-free), K independent shuffle scans, carried across the
//      sub-tiles. That gives every column's exclusive base in the tile and
//      the tile's count of the expert.
//   3. Across tiles, decoupled look-back (one block: nothing to do). Each
//      (tile, expert) has a 64-bit word in the wrapper's scratch, status
//      in the high half (1 the tile's aggregate, 2 its inclusive prefix)
//      and the value in the low half, so one store publishes both. The
//      scan warp publishes its aggregate (release), reads its 32 nearest
//      predecessors' words a lane each (acquire, spinning until each is
//      published), sums back to the first inclusive one, and publishes
//      its own inclusive prefix. Tiles come from an atomic ticket in
//      launch order, so a block only waits on tiles already running.
//   4. One barrier; each token's pos = its column's base + its rank. The
//      last tile writes counts. The last block to finish (a second
//      ticket, counted after every block's last read of the scratch)
//      zeroes the words and both tickets: the kernel leaves its scratch
//      as it found it, so a CUDA graph may replay it.
// The first design walked the tokens in 1024-token tiles inside one
// block, three barriers and a serial 32-step scan by E threads a tile:
// 5.71 us at the path's shape, linear in N on one SM of 132. This one
// (device time in CUDA graphs, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6):
// N 4096 E 8 3.5-3.8 us (int64 ids: one launch where the cast and the
// first kernel took 7.4-7.9); N 65 536 78-79 -> 7.1-7.7 us. Tiles of 2048
// or 1024 tokens ran slower at N 4096 (5.0-5.6) and within 15 % at
// 65 536.
// Shared memory: K x 32 x S ints; the largest E is where K = 1 fits.

#include <climits>

#include "common.cuh"

namespace dstt {
namespace token_sort {
namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSubTiles = 4;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
// scratch: word 0 the tile ticket, word 1 the blocks done (low 32 bits
// each), then one word a (tile, expert)
constexpr int kFlags = 2;

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long status, int v) {
  const unsigned long long w = status | (unsigned)v;
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// Tokens of expert e in the tiles before `tile` (a warp, uniform result),
// publishing this tile's aggregate `agg` first and its inclusive prefix
// after.
__device__ __forceinline__ int look_back(unsigned long long* flags, int tile,
                                         int e, int E, int agg, int lane) {
  unsigned long long* mine = flags + (long long)tile * E + e;
  if (tile == 0) {
    if (lane == 0) publish(mine, kPrefix, agg);
    return 0;
  }
  if (lane == 0) publish(mine, kAggregate, agg);
  int before = 0;
  for (int top = tile - 1;; top -= 32) {
    const int p = top - lane;  // lane 0 the nearest predecessor
    unsigned long long w = kPrefix;  // before tile 0: an inclusive 0
    if (p >= 0) {
      // a predecessor publishes within microseconds of its start; a wait
      // of 2^24 reads (seconds) traps, so a broken look-back fails the
      // launch instead of hanging the card
      const unsigned long long* at = flags + (long long)p * E + e;
      for (unsigned tries = 0; ((w = peek(at)) >> 32) == 0; ++tries)
        if (tries == (1u << 24)) __trap();
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, (w & kPrefix) != 0);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    int add = lane <= stop ? (int)(unsigned)w : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      add += __shfl_xor_sync(0xffffffffu, add, o);
    before += add;
    if (prefix) break;
  }
  if (lane == 0) publish(mine, kPrefix, before + agg);
  return before;
}

template <typename Id, int K>
__global__ void __launch_bounds__(kThreads)
token_sort_kernel(const Id* __restrict__ idx, int* __restrict__ pos,
                  int* __restrict__ counts, long long n, int E, int S,
                  unsigned long long* __restrict__ scratch) {
  extern __shared__ int cnt[];  // [K * 32][S]: column k * 32 + warp
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int tiles = gridDim.x;
  int tile = 0;
  if (tiles > 1) {
    if (tid == 0) s_tile = (int)atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    __syncthreads();
    tile = s_tile;
  }
  const long long first = (long long)tile * (K * kThreads) + tid;
  int id[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long i = first + (long long)k * kThreads;
    const Id v = i < n ? idx[i] : Id(-1);
    // every invalid token carries E, so none is a valid token's peer
    id[k] = v >= 0 && v < (Id)E ? (int)v : E;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int e = lane; e < E; e += 32) cnt[(k * kWarps + warp) * S + e] = 0;
  __syncwarp();
  // each lane's peers (the lanes with its key): an and of one ballot a
  // bit of the key, enough bits for 0..E
  unsigned peers[K];
#pragma unroll
  for (int k = 0; k < K; ++k) peers[k] = 0xffffffffu;
  for (int b = 0, bits = 32 - __clz(E); b < bits; ++b)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool set = (id[k] >> b) & 1;
      const unsigned m = __ballot_sync(0xffffffffu, set);
      peers[k] &= set ? m : ~m;
    }
  int rank[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    rank[k] = __popc(peers[k] & lanemask_lt);
    if (id[k] < E && rank[k] == 0)
      cnt[(k * kWarps + warp) * S + id[k]] = __popc(peers[k]);
  }
  __syncthreads();

  for (int e = warp; e < E; e += kWarps) {
    int c[K], incl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) incl[k] = c[k] = cnt[(k * kWarps + lane) * S + e];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = __shfl_up_sync(0xffffffffu, incl[k], o);
        if (lane >= o) incl[k] += t;
      }
    int run = 0;  // the tile's tokens of expert e in sub-tiles before k
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int total = __shfl_sync(0xffffffffu, incl[k], 31);
      c[k] = run + incl[k] - c[k];
      run += total;
    }
    const int before =
        tiles > 1 ? look_back(scratch + kFlags, tile, e, E, run, lane) : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) cnt[(k * kWarps + lane) * S + e] = before + c[k];
    if (tile == tiles - 1 && lane == 0) counts[e] = before + run;
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long i = first + (long long)k * kThreads;
    if (i < n)
      pos[i] = id[k] < E ? cnt[(k * kWarps + warp) * S + id[k]] + rank[k] : 0;
  }
  if (tiles > 1 && warp == 0) {
    // every warp of this block is past its look-back (the barrier above)
    unsigned done = 0;
    if (lane == 0) {
      __threadfence();
      done = atomicAdd(reinterpret_cast<unsigned*>(scratch + 1), 1u);
    }
    done = __shfl_sync(0xffffffffu, done, 0);
    if (done == (unsigned)tiles - 1) {
      __threadfence();
      const long long words = (long long)tiles * E;
      for (long long w = lane; w < words; w += 32) scratch[kFlags + w] = 0;
      if (lane == 0) scratch[0] = scratch[1] = 0;
    }
  }
}

int row_stride(int E) { return E | 1; }

size_t smem_bytes(int K, int E) {
  return sizeof(int) * (size_t)K * 32 * row_stride(E);
}

int optin_bytes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin - 64;  // the static tile index, with room to spare
}

// K: the most sub-tiles (4, 2, 1) whose counts fit; 0 if none does.
int sub_tiles(int E, int optin) {
  if (E < 1) return 0;
  for (int K = kMaxSubTiles; K >= 1; K /= 2)
    if (smem_bytes(K, E) <= (size_t)optin) return K;
  return 0;
}

template <typename Id, int K>
int launch(const void* idx, void* pos, void* counts, long long n, int E,
           void* scratch, cudaStream_t stream) {
  const long long tile = (long long)K * kThreads;
  const long long tiles = n > 0 ? (n + tile - 1) / tile : 1;
  if (tiles > INT_MAX || (tiles > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, E);
  auto kernel = token_sort_kernel<Id, K>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(int)tiles, kThreads, smem, stream>>>(
      static_cast<const Id*>(idx), static_cast<int*>(pos),
      static_cast<int*>(counts), n, E, row_stride(E),
      static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}

template <typename Id>
int launch_ids(int K, const void* idx, void* pos, void* counts, long long n,
               int E, void* scratch, cudaStream_t stream) {
  switch (K) {
    case 4: return launch<Id, 4>(idx, pos, counts, n, E, scratch, stream);
    case 2: return launch<Id, 2>(idx, pos, counts, n, E, scratch, stream);
    case 1: return launch<Id, 1>(idx, pos, counts, n, E, scratch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace token_sort
}  // namespace dstt

// The largest E the kernel takes on `device` (K = 1's counts in shared
// memory).
extern "C" int dstt_token_sort_max_experts(int device) {
  using namespace dstt::token_sort;
  const int optin = optin_bytes(device);
  int E = optin / (int)smem_bytes(1, 1);
  while (E > 0 && smem_bytes(1, E) > (size_t)optin) --E;
  return E;
}

// Tokens a block's tile holds at E experts on `device` (K x 1024), 0
// where E does not fit. A launch over n tokens is ceil(n / tile) blocks;
// with more than one it needs a scratch of 2 + blocks x E 64-bit words,
// zero at rest (each launch leaves it zero).
extern "C" int dstt_token_sort_tile(int E, int device) {
  using namespace dstt::token_sort;
  return sub_tiles(E, optin_bytes(device)) * kThreads;
}

// idx [n] (int64 if ids64, else int32) -> pos int32 [n], counts int32 [E],
// in tiles of `tile` tokens (dstt_token_sort_tile's). n >= 0, n < 2^31;
// `scratch` may be null where n <= tile. Returns cudaGetLastError().
extern "C" int dstt_token_sort(const void* idx, int ids64, void* pos,
                               void* counts, long long n, int E, int tile,
                               void* scratch, void* stream) {
  using namespace dstt::token_sort;
  if (E < 1 || n < 0 || n > INT_MAX || tile % kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = tile / kThreads;
  return ids64 ? launch_ids<long long>(K, idx, pos, counts, n, E, scratch, st)
               : launch_ids<int>(K, idx, pos, counts, n, E, scratch, st);
}
