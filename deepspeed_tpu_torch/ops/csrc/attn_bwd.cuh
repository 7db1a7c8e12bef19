// attn_bwd.cuh — the Hopper attention backward's building blocks, shared
// by flash_bwd.cu (the causal / full walk) and block_sparse.cu's backward
// (the visit lists): both run the same four products per pass on wgmma
// with fp32 accumulators in registers, fed by a TMA ring (sm90.cuh).
//
// A work item is one 64-row tile of one head: dq keeps Q and dO resident
// and streams K/V tiles; dk/dv keeps K and V resident and streams Q/dO
// tiles with their 64 lse and delta values. A block is one consumer
// warpgroup (the item's 64 rows) and a producer: one warp for dq (160
// threads), a warpgroup for dk/dv (256 threads), whose warps 5-7 leave
// after giving their registers to the consumers with setmaxnreg.
//
// What lives here:
//   * BwdSmem: the shared-memory layout of either pass (resident pair,
//     STAGES stages of the streamed pair, the dk/dv stages' lse / delta
//     rows, barriers); the block-sparse passes append their stage extras;
//   * init_barriers: the ring's full / empty mbarriers and the resident
//     pair's;
//   * score_pair: two score-shaped products (S = Q K^T and dP = dO V^T, or
//     their transposes S^T = K Q^T, dP^T = V dO^T), one commit group each,
//     so the softmax backward of the first overlaps the second;
//   * fragments + accumulate: a score accumulator narrowed to 16 bits as
//     the register A operand of an accumulating product (dQ += dS K, dV +=
//     P^T dO, dK += dS^T Q), the right factor read through the transposed
//     descriptor;
//   * fetch_rows / put_rows: the dk/dv producer's staging of a q tile's 64
//     lse and delta values (plain loads: a [B, H, T] row of a ragged T is
//     not 16-byte aligned for TMA), published with the stage's arrive;
//   * store_rows: a thread's two rows of an accumulator to device memory.
// A thread's accumulator element i sits at tile row (i & 2 ? r1 : r0) and
// column 8 (i >> 2) + 2 qi + (i & 1); r0 = 16 warp + lane / 4, r1 = r0 + 8,
// qi = lane % 4.
#pragma once

#include "sm90.cuh"

namespace dstt {
namespace bwd {
// Internal linkage: each kernel library that includes this header keeps
// its own copies.
namespace {

using namespace dstt::sm90;

constexpr int BT = 64;          // rows of every tile (q and k)
constexpr int STAGES = 2;       // ring stages
// dq: one consumer warpgroup and one producer warp. dk/dv: one consumer
// warpgroup and a producer warpgroup, so that setmaxnreg can move the
// producer's registers to the consumers (dK and dV take 128 of them a
// thread): two blocks fit an SM at hd 128 (64 K registers = 2 x (4 warps x
// 232 + 4 x 24) x 32).
constexpr int kDqThreads = 160, kDkvThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of either pass: the item's two resident tiles, STAGES
// stages of two streamed tiles, and (dk/dv: ROWS) the stages' 64 lse and 64
// delta values; then the barriers.
template <int HD, bool ROWS>
struct BwdSmem {
  static constexpr int P = HD / 64;                   // 64-column panels
  static constexpr int tile = P * PANEL;              // one 64-row tile
  static constexpr int res_off = 0;
  static constexpr int ring_off = 2 * tile;
  static constexpr int rows_off = ring_off + STAGES * 2 * tile;
  static constexpr int rows_bytes = ROWS ? 2 * BT * 4 : 0;   // a stage's
  static constexpr int bar_off = rows_off + STAGES * rows_bytes;
  // full[STAGES], empty[STAGES], the resident pair's full and empty; + 1024
  // for aligning the dynamic shared-memory base
  static constexpr int bar_bytes = (2 * STAGES + 2) * 8;
  static constexpr int bytes = bar_off + bar_bytes + 1024;
};

__device__ __forceinline__ void init_barriers(uint64_t* full,
                                              uint32_t arrivals) {
  uint64_t* empty = full + STAGES;
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(&full[s], arrivals);
    mbar_init(&empty[s], 128);
  }
  mbar_init(empty + STAGES, 1);          // the resident pair: full
  mbar_init(empty + STAGES + 1, 128);    // and empty
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Two score-shaped products on wgmma, one commit group each: a = A1 B1^T
// first, then b = A2 B2^T; the four 64-row tiles K-major in shared memory.
template <typename T, int HD>
__device__ __forceinline__ void score_pair(float (&a)[32], float (&b)[32],
                                           const unsigned char* A1,
                                           const unsigned char* B1,
                                           const unsigned char* A2,
                                           const unsigned char* B2) {
  fence_regs(a);
  fence_regs(b);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * PANEL + (kk % 4) * 32;
    wgmma_ss<T>(a, desc_sw128(A1 + off), desc_sw128(B1 + off), kk > 0);
  }
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * PANEL + (kk % 4) * 32;
    wgmma_ss<T>(b, desc_sw128(A2 + off), desc_sw128(B2 + off), kk > 0);
  }
  wg_commit();
}

// acc[64 x HD] += A (four 16-column register fragments) Y, Y a 64-row tile
// read through the transposed descriptor; one commit group.
template <typename T, int N>
__device__ __forceinline__ void accumulate(float (&acc)[N],
                                           const uint32_t (&a)[BT / 16][4],
                                           const unsigned char* Y) {
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_rs<T>(acc, a[kk], desc_sw128(Y + kk * 16 * 128, PANEL), 1);
  wg_commit();
}

// A score accumulator narrowed to T as the A fragments of an accumulating
// product: k slice kk is accumulator columns 16 kk .. 16 kk + 15.
template <typename T>
__device__ __forceinline__ void fragments(uint32_t (&a)[BT / 16][4],
                                          const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack2<T>(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// The dk/dv producer's lse (times `lmul`) and delta of the q rows q0 +
// lane and q0 + lane + 32 of one head's [T] rows at `row`, 0 past T: read
// before the stage's empty wait, stored after it (put_rows: lse at
// rows[0 .. 63], delta at rows[64 .. 127]).
__device__ __forceinline__ void fetch_rows(float (&lv)[2], float (&dl)[2],
                                           const float* lse,
                                           const float* delta, long long row,
                                           int q0, int lane, int T_len,
                                           float lmul) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int qpos = q0 + lane + 32 * c;
    lv[c] = qpos < T_len ? lse[row + qpos] * lmul : 0.f;
    dl[c] = qpos < T_len ? delta[row + qpos] : 0.f;
  }
}

__device__ __forceinline__ void put_rows(float* rows, const float (&lv)[2],
                                         const float (&dl)[2], int lane) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    rows[lane + 32 * c] = lv[c];
    rows[BT + lane + 32 * c] = dl[c];
  }
}

// Rows pos0 / pos1 (inside T) of a [64 x HD] fp32 accumulator, times
// `mult`, narrowed to T, to one head's rows with element stride `st`.
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* base, long long st,
                                           const float (&acc)[N], float mult,
                                           int pos0, int pos1, int qi,
                                           int T_len) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = 8 * j + 2 * qi;
    if (pos0 < T_len)
      *reinterpret_cast<uint32_t*>(base + pos0 * st + col) =
          pack2<T>(acc[4 * j] * mult, acc[4 * j + 1] * mult);
    if (pos1 < T_len)
      *reinterpret_cast<uint32_t*>(base + pos1 * st + col) =
          pack2<T>(acc[4 * j + 2] * mult, acc[4 * j + 3] * mult);
  }
}

}  // namespace
}  // namespace bwd
}  // namespace dstt
