// attn_fwd.cuh — the Hopper attention forward mainloop shared by
// flash_fwd.cu (causal / full flash attention) and block_sparse.cu's
// forward (a visit list of 64 x 64 tiles per q tile).
//
// A work item is one (64-row q tile, b, h). Two kernels run the same
// mainloop body (tile_step) with their own walk and score epilogue:
// bsa_fwd_kernel, one block per item (block-sparse), and flash_fwd_kernel,
// as many blocks as fit the card walking the items in rounds. In a block:
//   * one consumer warpgroup owning the 64 q rows, and one producer warp
//     (the last warp). The producer walks the K tiles (flash: 0 .. the
//     causal frontier; block-sparse: the tile's visit list) and keeps a ring
//     of STAGES shared-memory stages filled with TMA copies
//     (cp.async.bulk.tensor), each stage guarded by a "full" mbarrier (the
//     copies' bytes landed) and an "empty" one (every consumer thread is
//     done with it). Q is copied on barriers of its own (flash: into one
//     of two buffers, the next item's while this one finishes).
//   * Both products run on wgmma with fp32 accumulators in registers:
//     S = Q K^T is m64n64k16 with Q and K read from shared memory (K is
//     K-major: no transpose); O += P V is m64nHDk16 with P as the register
//     A operand (the S accumulator of one 16-column slice, narrowed to 16
//     bits, is the A fragment of the next product) and V read from shared
//     memory through the descriptor's transpose bit. O stays in registers
//     for the whole loop.
//   * Every 16-bit tile is stored in 64-column panels of 128-byte rows with
//     the 128-byte swizzle, as TMA writes them and as the wgmma descriptor
//     reads them (hd 64: one panel; hd 128: two, PANEL bytes apart).
//   * The online softmax runs in registers: a thread holds 2 rows x 16
//     columns of S; row max takes two quad shuffles; m and the partial row
//     sum l stay in registers (l is summed across the quad once, at the
//     end); the rescale of O is a register multiply. P is narrowed to the
//     input dtype before P V; m, l and every sum stay fp32.
//   * Rows of a tile past T arrive as zeros (TMA fills out-of-bounds rows)
//     and output rows past T are never written (flash_fwd_kernel stores O
//     through its Q buffer with TMA, which drops them).
//   * Nothing on the consumers' path reads device memory but the output
//     and lse stores: what a tile needs besides K and V arrives in its
//     stage.
//
// The two walks differ in which K tiles they visit and how they score them
// (FlashScore, SparseScore: what tile_step calls on the raw products):
//   * flash (flash_fwd_kernel): K tiles 0 .. min(n_k, causal frontier);
//     scores scaled in fp32 in the kernel, -inf where causality or T masks
//     (masks applied only on tiles that cross the diagonal or T), with the
//     all-masked guard m_use = 0; grouped-query attention reads kv head
//     h / G. Blocks walk the q tiles longest first (the last causal tile
//     first).
//   * block-sparse (bsa_fwd_kernel): the visit list of (h, q tile); the
//     producer also stages the fp32 bias tile (two 64 x 32 TMA boxes of the
//     [Bb, Hb, T, T] slab, 128-byte swizzle, broadcast dims at index 0),
//     the 64-float padding row, and the tile's first key and 4 x 4 fine
//     cells (plain loads and shared-memory stores, published by the stage's
//     arrive). Scores in the Pallas order: s (q arrives pre-scaled) + bias
//     + padding, then the finite -1e30 where the fine mask or causality
//     masks, -inf past T, m starting at -1e30; a tile that is live
//     everywhere, below the diagonal and inside T skips the masks. Blocks
//     walk (h, q tile) rows in the plan's longest-first order.
//
// The PTX wrappers (mbarriers, TMA, wgmma, the swizzled descriptor) and the
// tensor maps are sm90.cuh's, shared with the flash backward
// (flash_bwd.cu). The host side encodes one CUtensorMap per operand with
// cuTensorMapEncodeTiled, looked up at run time through
// cudaGetDriverEntryPoint (no -lcuda at link time), and passes them to the
// kernel inside a __grid_constant__ parameter struct. [B, T, H, D] views
// (any strides that are multiples of 16 bytes, e.g. a fused qkv
// projection) are 4-D maps over {D, H, T, B} with a box of {64, 1, 64, 1}.
#pragma once

#include "sm90.cuh"

namespace dstt {
namespace attn {
// Internal linkage: each kernel library that includes this header keeps
// its own copies.
namespace {

// the PTX wrappers, the persistent walk (item_of) and the tensor maps
using namespace dstt::sm90;

constexpr int BM = 64;                 // q rows of one consumer warpgroup
constexpr int BK = 64;                 // k rows of one K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;      // the block-sparse masked score

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Block-sparse: what a producer stages beside a streamed tile for the
// consumers (the forward's and dq's K/V tiles, dk/dv's Q/dO tiles): the
// tile's first row (a key; dk/dv: a query), whether it needs no mask at all
// (every cell live, below the diagonal where causal, inside T), and its
// 4 x 4 fine cells, one byte each: row-major (q cell, k cell), or for dk/dv
// transposed (k cell, q cell), so a warp's four cells are the 4 bytes at
// live[4 warp].
struct StageMeta {
  int r0;
  int plain;
  uint8_t live[16];
  int pad[2];
};

// The (q0, k0) tile's 4 x 4 cells of one head's fine mask [T/16, T/16],
// 0 past T: q cell a's four bytes (k cells 0-3) in w[a].
__device__ __forceinline__ void tile_cells(uint32_t (&w)[4],
                                           const uint8_t* fine_h, int n16,
                                           int q0, int k0) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    uint32_t x = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qa = q0 / 16 + a, kc = k0 / 16 + c;
      const uint32_t v = (qa < n16 && kc < n16)
                             ? fine_h[(long long)qa * n16 + kc] : 0;
      x |= v << (8 * c);
    }
    w[a] = x;
  }
}

// Fill a stage's StageMeta: first row r0, the (q0, k0) tile's cells w
// (tile_cells; `transposed` for dk/dv: k cell c's four bytes in word c)
// and whether the tile needs no mask. Cells move as words (a 16-bit mask
// unpacked a byte at a time cost the block-sparse forward's one producer
// thread 4-6 % on an H100; PERF.md).
__device__ __forceinline__ void fill_stage(StageMeta& m, int r0,
                                           const uint32_t (&w)[4],
                                           bool transposed, int q0, int k0,
                                           int T_len, bool causal) {
  m.r0 = r0;
  m.plain = (w[0] & w[1] & w[2] & w[3]) == 0x01010101u
            && (!causal || k0 + BK - 1 <= q0) && k0 + BK <= T_len
            && q0 + BM <= T_len;
  uint32_t* live = reinterpret_cast<uint32_t*>(m.live);
  if (transposed) {
    // the 4 x 4 byte transpose: (w0, w1) and (w2, w3) interleaved, then
    // their halves joined
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140),
                   hi01 = __byte_perm(w[0], w[1], 0x7362),
                   lo23 = __byte_perm(w[2], w[3], 0x5140),
                   hi23 = __byte_perm(w[2], w[3], 0x7362);
    live[0] = __byte_perm(lo01, lo23, 0x5410);
    live[1] = __byte_perm(lo01, lo23, 0x7632);
    live[2] = __byte_perm(hi01, hi23, 0x5410);
    live[3] = __byte_perm(hi01, hi23, 0x7632);
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a) live[a] = w[a];
  }
}

struct FwdParams {
  CUtensorMap tq, tk, tv;     // [B, T, H(kv), D] views, boxes {64, 1, 64, 1}
  CUtensorMap tbias;          // block-sparse: [Bb, Hb, T, T] fp32,
                              // box {32, 64, 1, 1}
  CUtensorMap tkvb;           // block-sparse: [B, T] fp32 padding, {64, 1}
  CUtensorMap to;             // the output, as tq
  void* o;                    // the output, and its (batch, head, time)
  long long o_sb, o_sh, o_st; // element strides
  float* lse;
  int B, H, G, T_len, n_qt;   // n_qt: 64-row q tiles per head
  float scale;                // flash: the softmax scale (block-sparse: 1)
  int causal;
  // block-sparse
  const int* counts;          // [H, n_qt]
  const int* idx;             // [H, n_qt, maxv]
  const uint8_t* fine;        // [H, T/16, T/16]
  const int* order;           // [H * n_qt] (h, q tile) rows, longest first
  int maxv;
  int has_bias, bias_b, bias_h;   // bias_b / bias_h: the slab follows b / h
  int has_kvb;
};

template <int HD, int STAGES, int QBUF>
struct Smem {
  static constexpr int P = HD / 64;                       // 64-column panels
  static constexpr int q_bytes = P * PANEL;               // one Q (and O) tile
  static constexpr int q_off = 0;                         // QBUF Q buffers
  static constexpr int k_off = q_off + QBUF * q_bytes;
  static constexpr int v_off = k_off + STAGES * P * PANEL;
  static constexpr int bias_off = v_off + STAGES * P * PANEL;
  static constexpr int bias_bytes = STAGES * 2 * PANEL;   // fp32 64 x 64
  // (kvb ring, barriers, stage metadata) follow the bias ring if any
  __host__ __device__ static constexpr int kvb_off(bool bias) {
    return bias_off + (bias ? bias_bytes : 0);
  }
  __host__ __device__ static constexpr int bar_off(bool bias) {
    return kvb_off(bias) + STAGES * 256;
  }
  __host__ __device__ static constexpr int meta_off(bool bias) {
    return bar_off(bias) + (2 * STAGES + 4) * 8;
  }
  // + 1024 for aligning the dynamic shared-memory base
  __host__ __device__ static constexpr int bytes(bool bias) {
    return meta_off(bias) + STAGES * 32 + 1024;
  }
};

// Flash work item r (0 .. B * H * n_qt - 1): its (b, h), first q row and
// K-tile count, the q tiles walked from the last (the longest causal row)
// down.
struct Item {
  int b, h, q0, n_k;
};

__device__ __forceinline__ Item flash_item(const FwdParams& p, int r) {
  Item it;
  const int bh = r % (p.B * p.H);
  const int qt = p.n_qt - 1 - r / (p.B * p.H);
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.q0 = qt * BM;
  it.n_k = (p.T_len + BK - 1) / BK;
  if (p.causal) it.n_k = min(it.n_k, (it.q0 + BM - 1) / BK + 1);
  return it;
}

// The consumer warpgroup's own barrier (the producer warp is not in it).
__device__ __forceinline__ void wg_bar() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The mainloop's body: one K/V tile (one ring stage: K at Ks, V at Vs) for
// the consumer warpgroup's 64 q rows (Q at Qs). S = Q K^T on wgmma;
// `score(sc)` (FlashScore or SparseScore) turns the raw products into the
// walk's scores in place; the online softmax updates (m, l)
// and rescales O; P, narrowed to T, is the register A operand of O += P V.
// A row masked everywhere so far (flash's -inf; block-sparse m starts at
// the finite -1e30, so never there) keeps p = 0 and alpha = 0.
template <typename T, int HD, typename Score>
__device__ __forceinline__ void tile_step(const unsigned char* Qs,
                                          const unsigned char* Ks,
                                          const unsigned char* Vs,
                                          float (&o)[HD / 2], float& m0,
                                          float& m1, float& l0, float& l1,
                                          const Score& score) {
  // S = Q K^T
  float sc[32];
  fence_regs(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int pp = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<T>(sc, desc_sw128(Qs + pp * PANEL + off),
                desc_sw128(Ks + pp * PANEL + off), kk > 0);
  }
  wg_commit();
  wg_wait0();
  fence_regs(sc);
  score(sc);

  // online softmax: rows rl0 (e < 2) and rl0 + 8 (e >= 2)
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
  const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
  const float a0 = exp2f((m0 - mu0) * kLog2e);
  const float a1 = exp2f((m1 - mu1) * kLog2e);
  m0 = mx0;
  m1 = mx1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[4 * j] = exp2f((sc[4 * j] - mu0) * kLog2e);
    sc[4 * j + 1] = exp2f((sc[4 * j + 1] - mu0) * kLog2e);
    sc[4 * j + 2] = exp2f((sc[4 * j + 2] - mu1) * kLog2e);
    sc[4 * j + 3] = exp2f((sc[4 * j + 3] - mu1) * kLog2e);
    s0 += sc[4 * j] + sc[4 * j + 1];
    s1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * a0 + s0;
  l1 = l1 * a1 + s1;
  // P narrowed to T as the A fragments of P V: k slice kk is accumulator
  // columns 16 kk .. 16 kk + 15
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack2<T>(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }

  // O += P V: one m64nHDk16 per 16-row slice of V, its 64-column panels
  // PANEL bytes apart
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<T>(o, pa[kk], desc_sw128(Vs + kk * 16 * 128, PANEL), 1);
  wg_commit();
  wg_wait0();
  fence_regs(o);
}

// The end of a work item: the quad's partial sums of l summed, then
// 1 / l of rows rl0 and rl0 + 8 in (i0, i1), and l floored (an all-masked
// row keeps O = 0 and a finite lse).
__device__ __forceinline__ void finish_rows(float& l0, float& l1, float& i0,
                                            float& i1) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  i0 = 1.f / l0;
  i1 = 1.f / l1;
}

// The two walks' score epilogues (tile_step's `score`): each turns this
// thread's raw products sc[4 j + e] (row rl0 (e < 2) or rl0 + 8, tile
// column 8 j + 2 qi + (e & 1)) into scores in place. Whether a tile needs
// its masks is tested once per tile and the masks are a template
// parameter: tested on every element instead, both forwards ran slower on
// the H100 (PERF.md).

// Flash: scaled in fp32, -inf where causality or T masks; the masks run
// only on a tile that crosses the diagonal or T (`edge`).
struct FlashScore {
  float scale;
  int T_len, k0, qpos0, qpos1, qi;
  bool causal, edge;

  template <bool MASK>
  __device__ __forceinline__ void apply(float (&sc)[32]) const {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (MASK) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * qi + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        if (kpos >= T_len || (causal && kpos > qpos)) x = -INFINITY;
      }
      sc[i] = x;
    }
  }
  __device__ __forceinline__ void operator()(float (&sc)[32]) const {
    if (edge)
      apply<true>(sc);
    else
      apply<false>(sc);
  }
};

// Block-sparse, in the Pallas order: s (q arrives pre-scaled) + bias +
// padding (both staged with the tile), then the finite -1e30 where the
// tile's fine cells (`live4`: this warp's fine row, one byte a cell) or
// causality mask, -inf past T; a `plain` tile skips the masks.
struct SparseScore {
  const float* bias;          // the stage's fp32 bias tile, swizzled
  const float* kvb;           // the stage's padding row
  uint32_t live4;
  int k0, q0, rl0, qi, T_len;
  bool plain, has_bias, has_kvb, causal;

  template <bool MASK>
  __device__ __forceinline__ void apply(float (&sc)[32]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + 2 * qi;                 // tile column
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = rl0 + 8 * half;               // tile row
        const int qpos = q0 + rl;
        float2 bias2 = make_float2(0.f, 0.f);
        if (has_bias) {
          // fp32 [64 x 32] panel cl / 32, 16-byte chunks swizzled by the
          // row: chunk ^ (row % 8)
          const int c32 = cl & 31;
          const int off = rl * 32 + (((c32 >> 2) ^ (rl & 7)) << 2)
                          + (c32 & 3);
          bias2 = *reinterpret_cast<const float2*>(
              bias + (cl >> 5) * (PANEL / 4) + off);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + cl + e;
          float x = sc[4 * j + 2 * half + e];
          if (has_bias) x += e ? bias2.y : bias2.x;
          if (has_kvb) x += kvb[cl + e];
          if (MASK) {
            const bool live = (live4 >> (8 * (j >> 1))) & 0xFF;
            if (!live || (causal && kpos > qpos)) x = kNegInf;
            if (qpos >= T_len || kpos >= T_len) x = -INFINITY;
          }
          sc[4 * j + 2 * half + e] = x;
        }
      }
    }
  }
  __device__ __forceinline__ void operator()(float (&sc)[32]) const {
    if (plain)
      apply<false>(sc);
    else
      apply<true>(sc);
  }
};

// The block-sparse forward: one block (one consumer warpgroup, 64 q rows,
// and the producer warp) per (b, h, q tile) work item, blockIdx.x in the
// plan's longest-first row order; the hardware hands a finished block's SM
// to the next. The rows' visit lists vary from 1 to ~70 tiles, which
// balance better so than in the fixed rounds of a persistent walk
// (measured). O leaves from registers, rows inside T.
template <typename T, int HD, int STAGES>
__global__ void __launch_bounds__(160, 1)
bsa_fwd_kernel(__grid_constant__ const FwdParams p) {
  using L = Smem<HD, STAGES, 1>;
  constexpr int P = L::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem + L::q_off;
  unsigned char* Ks = smem + L::k_off;
  unsigned char* Vs = smem + L::v_off;
  unsigned char* Bs = smem + L::bias_off;
  const bool has_bias = p.has_bias, has_kvb = p.has_kvb;
  float* KVBs = reinterpret_cast<float*>(smem + L::kvb_off(has_bias));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off(has_bias));
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  StageMeta* meta = reinterpret_cast<StageMeta*>(smem + L::meta_off(has_bias));

  // which (b, h, q tile): the plan's row order
  const int rank = blockIdx.x;
  const int row = p.order[rank / p.B];
  const int b = rank % p.B, h = row / p.n_qt, qt = row % p.n_qt;
  const int T_len = p.T_len;
  const int q0 = qt * BM;
  const int row_id = h * p.n_qt + qt;
  const int n_k = p.counts[row_id];
  const int* visits = p.idx + (long long)row_id * p.maxv;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---------------- producer: one thread issues every copy ----------------
    if (lane == 0) {
      mbar_expect_tx(qbar, L::q_bytes);
#pragma unroll
      for (int pp = 0; pp < P; ++pp)
        tma_load_4d(Qs + pp * PANEL, &p.tq, qbar, 64 * pp, h, q0, b);
      const int bb = p.bias_b ? b : 0, hb = p.bias_h ? h : 0;
      const uint32_t bytes = 2 * P * PANEL + (has_bias ? 2 * PANEL : 0)
                             + (has_kvb ? BK * 4 : 0);
      const int n16 = T_len / 16;
      const uint8_t* fine_h = p.fine + (long long)h * n16 * n16;
      for (int t = 0; t < n_k; ++t) {
        const int s = t % STAGES, n = t / STAGES;
        mbar_wait(&empty[s], (n & 1) ^ 1);
        const int k0 = visits[t] * BK;
        // written before the arrive below, whose release the consumers'
        // wait on full[s] acquires
        uint32_t w[4];
        tile_cells(w, fine_h, n16, q0, k0);
        fill_stage(meta[s], k0, w, false, q0, k0, T_len, p.causal);
        mbar_expect_tx(&full[s], bytes);
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
          tma_load_4d(Ks + (s * P + pp) * PANEL, &p.tk, &full[s], 64 * pp, h,
                      k0, b);
          tma_load_4d(Vs + (s * P + pp) * PANEL, &p.tv, &full[s], 64 * pp, h,
                      k0, b);
        }
        if (has_bias) {
          tma_load_4d(Bs + (s * 2) * PANEL, &p.tbias, &full[s], k0, q0, hb, bb);
          tma_load_4d(Bs + (s * 2 + 1) * PANEL, &p.tbias, &full[s], k0 + 32, q0,
                      hb, bb);
        }
        if (has_kvb) tma_load_2d(KVBs + s * BK, &p.tkvb, &full[s], k0, b);
      }
    }
  } else {
    // ---------------- consumers: one warpgroup, the tile's 64 q rows ------
    const int wl = warp, quad = lane >> 2, qi = lane & 3;
    const int rl0 = 16 * wl + quad;   // this thread's rows in the tile:
    const int qpos0 = q0 + rl0, qpos1 = qpos0 + 8;   // rl0, rl0 + 8
    const bool causal = p.causal;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    // O [64 x HD]: o[4 j + e] is row (e < 2 ? rl0 : rl0 + 8), column
    // 8 j + 2 qi + (e & 1), as one m64nHD accumulator
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

    mbar_wait(qbar, 0);

    for (int t = 0; t < n_k; ++t) {
      const int s = t % STAGES, n = t / STAGES;
      mbar_wait(&full[s], n & 1);
      const int k0 = meta[s].r0;
      // this warp's 16 rows are fine row wl of the tile
      const uint32_t live4 =
          *reinterpret_cast<const uint32_t*>(&meta[s].live[4 * wl]);
      const bool plain = meta[s].plain;
      const float* Bst = reinterpret_cast<const float*>(Bs + s * 2 * PANEL);
      const float* kvb_s = KVBs + s * BK;
      const SparseScore score{Bst, kvb_s, live4, k0, q0, rl0, qi, T_len,
                              plain, has_bias, has_kvb, causal};
      tile_step<T, HD>(Qs, Ks + s * P * PANEL, Vs + s * P * PANEL, o, m0, m1,
                       l0, l1, score);
      mbar_arrive(&empty[s]);
    }

    // epilogue: out = O / l, lse = m + log l
    float i0, i1;
    finish_rows(l0, l1, i0, i1);
    T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * qi;
      if (qpos0 < T_len)
        *reinterpret_cast<uint32_t*>(ob + (long long)qpos0 * p.o_st + col) =
            pack2<T>(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (qpos1 < T_len)
        *reinterpret_cast<uint32_t*>(ob + (long long)qpos1 * p.o_st + col) =
            pack2<T>(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
    if (qi == 0) {
      float* lrow = p.lse + ((long long)b * p.H + h) * T_len;
      if (qpos0 < T_len) lrow[qpos0] = m0 + logf(l0);
      if (qpos1 < T_len) lrow[qpos1] = m1 + logf(l1);
    }
  }
}

// The flash forward, persistent: gridDim.x blocks (as many as fit the card
// at once) walk the B * H * n_qt work items (`item_of`). The K/V ring runs
// on across items, and Q is double-buffered, so the producer fetches the
// next item's Q and first tiles while the consumers finish this one: no
// block start, barrier set-up or first load sits between two items. Each
// item's O goes back through its Q buffer (its last Q K^T is done) and a
// TMA store, which drops the rows past T.
template <typename T, int HD, int STAGES>
__global__ void __launch_bounds__(160, 1)
flash_fwd_kernel(__grid_constant__ const FwdParams p) {
  constexpr int QBUF = 2;
  using L = Smem<HD, STAGES, QBUF>;
  constexpr int P = L::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem + L::q_off;
  unsigned char* Ks = smem + L::k_off;
  unsigned char* Vs = smem + L::v_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off(false));
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;      // [2]
  uint64_t* qempty = qfull + 2;          // [2]
  const int T_len = p.T_len;
  const int n_items = p.B * p.H * p.n_qt;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&qfull[qb], 1);
      mbar_init(&qempty[qb], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---------------- producer: one thread issues every copy ----------------
    if (lane == 0) {
      const uint32_t bytes = 2 * P * PANEL;
      int t = 0;                                    // position in the ring
      for (int w = 0;; ++w) {
        const int r = item_of(w, blockIdx.x, gridDim.x);
        if (r >= n_items) break;
        const Item it = flash_item(p, r);
        const int b = it.b, h = it.h, q0 = it.q0;
        const int qb = w & 1;
        mbar_wait(&qempty[qb], ((w >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[qb], L::q_bytes);
#pragma unroll
        for (int pp = 0; pp < P; ++pp)
          tma_load_4d(Qs + qb * L::q_bytes + pp * PANEL, &p.tq, &qfull[qb],
                      64 * pp, h, q0, b);
        const int hk = h / p.G;
        for (int kt = 0; kt < it.n_k; ++kt, ++t) {
          const int s = t % STAGES, n = t / STAGES;
          mbar_wait(&empty[s], (n & 1) ^ 1);
          const int k0 = kt * BK;
          mbar_expect_tx(&full[s], bytes);
#pragma unroll
          for (int pp = 0; pp < P; ++pp) {
            tma_load_4d(Ks + (s * P + pp) * PANEL, &p.tk, &full[s], 64 * pp,
                        hk, k0, b);
            tma_load_4d(Vs + (s * P + pp) * PANEL, &p.tv, &full[s], 64 * pp,
                        hk, k0, b);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: one warpgroup, the item's 64 q rows -------
    const int wl = warp, quad = lane >> 2, qi = lane & 3;
    const int rl0 = 16 * wl + quad, rl1 = rl0 + 8;   // this thread's rows
    const bool causal = p.causal;
    const float scale = p.scale;
    int t = 0;                                        // position in the ring
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= n_items) break;
      const Item it = flash_item(p, r);
      const int b = it.b, h = it.h, q0 = it.q0;
      const int qpos0 = q0 + rl0, qpos1 = q0 + rl1;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      // O [64 x HD]: o[4 j + e] is row (e < 2 ? rl0 : rl0 + 8), column
      // 8 j + 2 qi + (e & 1), as one m64nHD accumulator
      float o[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
      const int qb = w & 1;
      mbar_wait(&qfull[qb], (w >> 1) & 1);
      unsigned char* Qg = Qs + qb * L::q_bytes;

      for (int kt = 0; kt < it.n_k; ++kt, ++t) {
        const int s = t % STAGES, n = t / STAGES;
        mbar_wait(&full[s], n & 1);
        const int k0 = kt * BK;
        const bool edge = k0 + BK > T_len || (causal && k0 + BK - 1 > q0);
        const FlashScore score{scale, T_len, k0, qpos0, qpos1, qi, causal,
                               edge};
        tile_step<T, HD>(Qg, Ks + s * P * PANEL, Vs + s * P * PANEL, o, m0,
                         m1, l0, l1, score);
        mbar_arrive(&empty[s]);
      }

      // epilogue: out = O / l, lse = m + log l; O goes to the Q buffer
      // (its last Q K^T is done), then to device memory by a TMA store,
      // which drops the rows past T
      float i0, i1;
      finish_rows(l0, l1, i0, i1);
      wg_bar();
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        // panel j / 8, 16-byte chunk j % 8 swizzled by the row
        unsigned char* pan = Qg + (j >> 3) * PANEL + 4 * qi;
        *reinterpret_cast<uint32_t*>(pan + rl0 * 128
                                     + (((j & 7) ^ (rl0 & 7)) << 4)) =
            pack2<T>(o[4 * j] * i0, o[4 * j + 1] * i0);
        *reinterpret_cast<uint32_t*>(pan + rl1 * 128
                                     + (((j & 7) ^ (rl1 & 7)) << 4)) =
            pack2<T>(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_bar();
      if (tid == 0) {
#pragma unroll
        for (int pp = 0; pp < P; ++pp)
          tma_store_4d(&p.to, Qg + pp * PANEL, 64 * pp, h, q0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      wg_bar();
      mbar_arrive(&qempty[qb]);
      if (qi == 0) {
        float* lrow = p.lse + ((long long)b * p.H + h) * T_len;
        if (qpos0 < T_len) lrow[qpos0] = m0 + logf(l0);
        if (qpos1 < T_len) lrow[qpos1] = m1 + logf(l1);
      }
    }
    // every store of this block has landed before it exits
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

// The contiguous fp32 bias [Bb, Hb, T, T] as a 4-D map {T (k), T (q), Hb,
// Bb}, box {32, 64, 1, 1} (128 bytes of k columns: the 128-byte swizzle's
// row), and the padding rows [B, T] as {T, B} with box {64, 1}.
inline int encode_bias(CUtensorMap* map, const float* bias, int Bb, int Hb,
                       int T_len) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const long long tt = (long long)T_len * T_len;
  const cuuint64_t dims[4] = {(cuuint64_t)T_len, (cuuint64_t)T_len,
                              (cuuint64_t)Hb, (cuuint64_t)Bb};
  const cuuint64_t strides[3] = {(cuuint64_t)T_len * 4, tma_stride(tt * 4, Hb),
                                 tma_stride(tt * Hb * 4, Bb)};
  const cuuint32_t box[4] = {32, BM, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                         const_cast<float*>(bias), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + (int)rc;
}

inline int encode_rows(CUtensorMap* map, const float* rows, int B, int T_len) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[1] = {tma_stride((long long)T_len * 4, B)};
  const cuuint32_t box[2] = {BK, 1};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<float*>(rows), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + (int)rc;
}

// Launch the block-sparse forward (SPARSE: one block per work item) or the
// flash forward (as many persistent blocks as fit the card at once, at
// most one per item); p's maps and fields are filled by the caller, n_qt
// included.
template <bool SPARSE, typename T, int HD, int STAGES>
int launch(const FwdParams& p, cudaStream_t stream) {
  using L = Smem<HD, STAGES, SPARSE ? 1 : 2>;
  const bool bias = SPARSE && p.has_bias;
  constexpr auto kernel = [] {
    if constexpr (SPARSE)
      return bsa_fwd_kernel<T, HD, STAGES>;
    else
      return flash_fwd_kernel<T, HD, STAGES>;
  }();
  return launch_items<kernel>(p, (long long)p.B * p.H * p.n_qt, 160,
                              L::bytes(bias), L::bytes(SPARSE), !SPARSE,
                              stream);
}

}  // namespace
}  // namespace attn
}  // namespace dstt
