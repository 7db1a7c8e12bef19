// token_sort.cu — stable counting sort of tokens by expert id, for Hopper.
//
// Replaces the Pallas kernel of deepspeed_tpu/ops/pallas/token_sort.py
// (`token_sort` :53, the pallas_call at :66, kernel `_token_sort_kernel`
// :35). For expert ids idx [N] int32 and E experts:
//   pos[i]    = number of j < i with idx[j] == idx[i]   (0-based rank in
//               expert idx[i]'s queue; the dropless MoE's scatter slot)
//   counts[e] = number of i with idx[i] == e
// An id outside [0, E), negative included, matches no expert: it counts
// nowhere and gets pos 0 (the TPU kernel's one-hot has no lane for it).
// All arithmetic is int32, so the result is bit-equal to the plain version.
//
// What bounds it on the H100: neither bytes nor operations. At the MoE
// path's N = 4096, E = 8 it moves 32.8 KB (idx in, pos out, counts out),
// about 0.01 us at 3.35 TB/s; the time is the launch and one block's
// serial walk over the tiles. A single block is right and simple: the
// TPU's sequential grid with its carried `counts` block becomes a loop
// over 1024-token tiles in token order inside one block of 1024 threads,
// and the running per-expert base lives in shared memory between tiles.
// It uses one SM of 132; a two-pass multi-block design (per-block counts,
// a scan, then ranks) is for when a caller's N makes the walk the cost.
//
// One tile:
//   1. each warp: __match_any_sync on the id gives the lanes with the same
//      id (its peers); __popc(peers & lanemask_lt) is the lane's rank
//      among them; the lowest peer writes the warp's count for that expert
//      to shared memory, wcount[warp][e];
//   2. one thread per expert turns wcount[.][e] into an exclusive scan over
//      the 32 warps, starting from the running base[e], and advances base[e]
//      by the tile's count;
//   3. each valid token's pos = wcount[warp][id] + its rank within the warp.
// Shared memory: (32 + 1) * E ints; the entry point refuses an E whose
// footprint exceeds what one block may opt in to.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
token_sort_kernel(const int* __restrict__ idx, int* __restrict__ pos,
                  int* __restrict__ counts, long long n, int E) {
  extern __shared__ int smem[];
  int* wcount = smem;              // [kWarps][E]
  int* base = smem + kWarps * E;   // [E] tokens seen so far per expert
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;

  for (int e = tid; e < E; e += kThreads) base[e] = 0;
  for (long long t0 = 0; t0 < n; t0 += kThreads) {
    for (int k = tid; k < kWarps * E; k += kThreads) wcount[k] = 0;
    __syncthreads();

    const long long i = t0 + tid;
    const int id = i < n ? idx[i] : -1;
    const bool valid = id >= 0 && id < E;
    // every invalid lane carries the key -1, so none is a valid lane's peer
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? id : -1);
    const int rank = __popc(peers & lanemask_lt);
    if (valid && rank == 0) wcount[warp * E + id] = __popc(peers);
    __syncthreads();

    for (int e = tid; e < E; e += kThreads) {
      int run = base[e];
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcount[w * E + e];
        wcount[w * E + e] = run;
        run += c;
      }
      base[e] = run;
    }
    __syncthreads();

    if (i < n) pos[i] = valid ? wcount[warp * E + id] + rank : 0;
    __syncthreads();   // the next tile clears wcount
  }
  for (int e = tid; e < E; e += kThreads) counts[e] = base[e];
}

size_t smem_bytes(int E) { return sizeof(int) * (size_t)(kWarps + 1) * E; }

}  // namespace

// The largest E one block can take on `device` (shared memory opt-in).
extern "C" int dstt_token_sort_max_experts(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return (int)(optin / smem_bytes(1));
}

// idx int32 [n] -> pos int32 [n], counts int32 [E]. n >= 0, E >= 1; the
// wrapper checks E against dstt_token_sort_max_experts. Returns
// cudaGetLastError().
extern "C" int dstt_token_sort(const void* idx, void* pos, void* counts,
                               long long n, int E, void* stream) {
  if (E < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(E);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        token_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  token_sort_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<int*>(pos),
      static_cast<int*>(counts), n, E);
  return (int)cudaGetLastError();
}
