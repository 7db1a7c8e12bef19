// block_sparse.cu — block-sparse flash attention: forward, dq, dk/dv. Hopper.
//
// Replaces the three Pallas kernels of
// deepspeed_tpu/ops/pallas/block_sparse_attention.py:
//   * the forward (pallas_call :515, kernel _fwd_kernel :129): out and an
//     fp32 lse over the k tiles of each (head, q tile)'s visit list;
//   * the dq pass (pallas_call :601, kernel _bwd_dq_kernel :186): dq over
//     the same lists, and dbias = ds on the visited tiles when the bias is
//     learned;
//   * the dk/dv pass (pallas_call :659, kernel _bwd_dkv_kernel :251): dk,
//     dv over the transposed lists (for each k tile, the q tiles that
//     visit it).
// GPT training and evaluation reach them through sparse_attn_fn and
// SparseSelfAttention (ops/sparse_attention.py), via the autograd function
// of ops/block_sparse_attention.py, which builds the visit lists on the
// host at these 64 x 64 tiles (int32 counts [H, n_t] and idx [H, n_t,
// maxv], and their transposes) with the uint8 fine mask [H, T/16, T/16],
// and the longest-first walks over them (row_order, col_order).
//
// What bounds it on the H100: operations (4 * D flops per live (q, k) cell
// in the forward, 6 * D in the dq pass, 8 * D in the dk/dv pass, against
// about 4-6 * T * D elements moved per head and pass, and the fp32 bias
// boxes of the visited tiles); at the op path (a learned bias shared by
// the heads) the dq pass is bound by bytes instead: it writes the dense
// fp32 dbias slab, [T, T], through one fp32 add a visited cell a head.
//
// The forward is attn_fwd.cuh's Hopper mainloop (wgmma with accumulators in
// registers, a TMA ring of K/V stages fed by a producer warp, the online
// softmax in registers) walking visit lists: one block per (64-row q tile,
// b, h) in the plan's longest-first row order; the producer stages the fp32
// bias tile (two 64 x 32 TMA boxes of the [Bb, Hb, T, T] slab, index 0 on a
// broadcast dim), the padding row, the tile's first key and its 4 x 4 fine
// cells beside K and V, and SparseScore scores them.
//
// The backward is flash_bwd.cu's design (attn_bwd.cuh, sm90.cuh) over the
// visit lists:
//   * dq: a work item is (b, h, q tile). Q and dO are resident; the K/V
//     tiles of the item's visit list stream through a ring of STAGES
//     stages, each with the fp32 bias tile (the forward's boxes), the
//     padding row and the forward's StageMeta (the tile's first key, its
//     fine cells, whether it needs no mask). S = Q K^T and dP = dO V^T on
//     wgmma (two commit groups), S scored by the forward's SparseScore,
//     then p = exp(s - lse) and ds = p (dp - delta) in registers, and dQ
//     += dS K on wgmma with K read through the transposed descriptor. dbias
//     (into the slab the wrapper zeroed) takes the fp32 ds tile through
//     shared memory and two TMA reduce-adds (cp.reduce.async.bulk.tensor,
//     the bias boxes), whether each cell has one writer (per-head slabs,
//     or one head) or one slab is shared by H > 1 heads: the additions
//     run in L2 a 128-byte line at a time, and the heads' items of one q
//     tile run at about the same time, so they meet there. (fp32 float2
//     atomics from the registers: 0.70 ms of dq at the op path against
//     0.60 so, on an H100 80GB HBM3 at 700 W; PERF.md.)
//   * dk/dv: a work item is (b, h, k tile) over the transposed lists. K and
//     V are resident; Q, dO, their 64 lse and delta values, the bias tile
//     and a StageMeta (its cells transposed) stream per stage. S^T = K Q^T
//     and dP^T = V dO^T are computed directly and scored by SparseScoreT,
//     the transposed twin of SparseScore: it reads the staged (q0, k0)
//     bias box as bias[col][row] through the 128-byte swizzle (a warp's 32
//     reads hit 32 banks), the padding of the thread's two key rows (read
//     once per item) and the fine cells transposed. dV += P^T dO and dK +=
//     dS^T Q in registers; the consumers take the producer warpgroup's
//     registers (setmaxnreg).
//   * Blocks are persistent (as many as fit the card) and walk the items
//     longest first (item_of over the plan's row_order / col_order; b
//     fastest): the global k tiles, which nearly every q tile visits, and
//     the q tiles with ~70 visits start first.
//   * The producer warp fetches a visit list 32 entries at a time (a lane
//     an entry, with its tile's fine cells: attn_fwd.cuh's tile_cells) and
//     hands them out by shuffle, so the list and mask reads are not serial
//     with the ring (lane 0 reading them in turn cost dk/dv 5 % at the
//     train path on an H100; PERF.md).
//   * Numerics follow the Pallas kernels (held by the plain _reference_bwd):
//     q arrives scaled and rounded (no scale in the exponent); scores are
//     s + bias + padding, then the finite -1e30 where the fine mask or
//     causality masks, -inf past T (rows past T load as zeros and carry lse
//     0: p = 0 there exactly); a query row whose visited keys are all padded
//     has s = lse = -1e30 and p = 1 on its visited cells, the "mean of the
//     visited V" of the forward; p and ds narrow to the input dtype before
//     their second product; fp32 statistics and accumulators; dq leaves
//     rounded, then scaled in fp32 and rounded again (JAX :614); dk gets no
//     scale (it is contracted against the scaled q, :669).
//   * bf16 and fp16, hd 64 and 128, any T that is a multiple of 16 (tiles
//     past T are zero-filled by TMA and masked).
// Budget per block: shared memory (hd 64 / 128) dq 50.8 / 100.0 KB, dk/dv
// 51.3 / 100.5 KB, + 32 KB of bias stages (and for dq a 16 KB ds tile)
// only when a bias is passed, so the train path, with no bias, fits three
// dq and two dk/dv blocks an SM at hd 64; registers: dQ (dq) or dK and dV
// (dk/dv) 32 fp32 each at hd 64, 64 at hd 128, S and dP 32 each, their
// 16-bit fragments 16 each, beside the score functors'. dq is capped at
// 128 registers at hd 64 (three blocks an SM; a few bytes spill); dk/dv's
// producer warpgroup keeps 56 at hd 64 (24 at hd 128) and hands the rest
// to the consumers (nvcc -Xptxas -v: tools/bsa_bwd_ab.py --ptxas; PERF.md).

#include "attn_fwd.cuh"
#include "attn_bwd.cuh"

namespace dstt {
namespace bsa {
namespace {

// sm90.cuh's PTX wrappers, and the backward passes' tiles, ring and
// helpers (attn_bwd.cuh)
using namespace dstt::sm90;
using namespace dstt::bwd;

constexpr int FINE = 16;

// ---------------------------------------------------------------------------
// the backward passes
// ---------------------------------------------------------------------------

struct BsaBwdParams {
  CUtensorMap tq, tk, tv, tdo;   // [B, T, H, D] views, box {64, 1, 64, 1}
  CUtensorMap tbias;             // [Bb, Hb, T, T] fp32, box {32, 64, 1, 1}
  CUtensorMap tkvb;              // dq: padding rows [B, T] fp32, box {64, 1}
  CUtensorMap tdbias;            // dq: [B, dbias_heads, T, T], as tbias
  const float* lse;              // [B, H, T] fp32, contiguous
  const float* delta;            // [B, H, T] fp32, contiguous
  const float* kvb;              // dk/dv: the padding rows, read by key
  void* g0;                      // dq (dq pass) or dk
  void* g1;                      // dv (dk/dv pass)
  long long g0_sb, g0_sh, g0_st; // element strides (batch, head, time)
  long long g1_sb, g1_sh, g1_st;
  float* dbias;                  // dq: [B, dbias_heads, T, T] fp32, or null
  const int* counts;             // [H, n_t] (dk/dv: transposed lists)
  const int* idx;                // [H, n_t, maxv]
  const uint8_t* fine;           // [H, T/16, T/16]
  const int* order;              // [H * n_t] (h, tile) rows, longest first
  int maxv, B, H, T_len, n_t, dbias_heads;
  float scale;                   // dq's softmax scale, applied at the end
  int causal, has_bias, bias_b, bias_h, has_kvb;
};

// Shared memory of either pass: flash_bwd.cu's layout (BwdSmem), then STAGES
// fp32 bias tiles when a bias is passed, the dq stages' padding rows, the
// stages' StageMeta (attn_fwd.cuh), the barriers.
template <int HD, bool DKV>
struct SparseSmem {
  using Base = BwdSmem<HD, DKV>;
  // the bias panels' 128-byte swizzle wants 1024-byte alignment
  static constexpr int bias_off = (Base::bar_off + 1023) / 1024 * 1024;
  static constexpr int bias_bytes = STAGES * 2 * PANEL;   // fp32 64 x 64
  static constexpr int kvb_bytes = DKV ? 0 : STAGES * BT * 4;
  // dq with a bias: one fp32 [64 x 64] ds tile, the source of the dbias
  // reductions
  static constexpr int ds_off = bias_off + bias_bytes;
  static constexpr int ds_bytes = DKV ? 0 : 2 * PANEL;
  __host__ __device__ static constexpr int kvb_off(bool bias) {
    return bias_off + (bias ? bias_bytes + ds_bytes : 0);
  }
  __host__ __device__ static constexpr int meta_off(bool bias) {
    return kvb_off(bias) + kvb_bytes;
  }
  __host__ __device__ static constexpr int bar_off(bool bias) {
    return meta_off(bias) + STAGES * (int)sizeof(attn::StageMeta);
  }
  // + 1024 for aligning the dynamic shared-memory base
  __host__ __device__ static constexpr int bytes(bool bias) {
    return bar_off(bias) + Base::bar_bytes + 1024;
  }
};

// Work item r: the (h, tile) row order[r / B] of batch row r % B; n is
// the row's visit count.
struct Item {
  int b, h, r0, row, n;
};

__device__ __forceinline__ Item item_at(const BsaBwdParams& p, int r) {
  Item it;
  it.row = p.order[r / p.B];
  it.b = r % p.B;
  it.h = it.row / p.n_t;
  it.r0 = (it.row % p.n_t) * BT;
  it.n = p.counts[it.row];
  return it;
}

// dk/dv's score epilogue, the transposed twin of attn_fwd.cuh's
// SparseScore: sc[4 j + e] is S^T at key row rl0 + 8 (e >> 1) and query
// column 8 j + 2 qi + (e & 1), in the Pallas order: s + bias + padding,
// then the finite -1e30 where the fine cells (`live4`: byte a is q cell a
// of this warp's k cell) or causality mask, -inf past T; a `plain` tile
// skips the masks. The staged bias tile is [q][k] (SparseScore's boxes),
// read here as bias[col][row].
struct SparseScoreT {
  const float* bias;          // the stage's fp32 bias tile, swizzled
  uint32_t live4;
  float kb0, kb1;             // the padding of the thread's two key rows
  int q0, kpos0, rl0, qi, T_len;
  bool plain, has_bias, has_kvb, causal;

  template <bool MASK>
  __device__ __forceinline__ void apply(float (&sc)[32]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * qi + (e & 1);     // tile column: a query
        const int rl = rl0 + 8 * (e >> 1);           // tile row: a key
        float x = sc[4 * j + e];
        if (has_bias) {
          // fp32 [64 x 32] panel rl / 32, row cl, 16-byte chunk
          // ((rl % 32) / 4) ^ (cl % 8)
          const int k32 = rl & 31;
          x += bias[(rl >> 5) * (PANEL / 4) + cl * 32
                    + (((k32 >> 2) ^ (cl & 7)) << 2) + (k32 & 3)];
        }
        if (has_kvb) x += (e & 2) ? kb1 : kb0;
        if (MASK) {
          const bool live = (live4 >> (8 * (j >> 1))) & 0xFF;
          const int qpos = q0 + cl, kpos = kpos0 + 8 * (e >> 1);
          if (!live || (causal && kpos > qpos)) x = attn::kNegInf;
          if (qpos >= T_len || kpos >= T_len) x = -INFINITY;
        }
        sc[4 * j + e] = x;
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

// dq's rows pos0 / pos1 (inside T): rounded to T, then scaled in fp32 and
// rounded again, as JAX scales dq after its kernel.
template <typename T, int N>
__device__ __forceinline__ void store_dq(T* base, long long st,
                                         const float (&acc)[N], float scale,
                                         int pos0, int pos1, int qi,
                                         int T_len) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = 8 * j + 2 * qi;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = half ? pos1 : pos0;
      if (pos >= T_len) continue;
      float x, y;
      unpack2<T>(pack2<T>(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]),
                 x, y);
      *reinterpret_cast<uint32_t*>(base + pos * st + col) =
          pack2<T>(x * scale, y * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// the dq pass
// ---------------------------------------------------------------------------

// Three blocks an SM at hd 64 (registers capped at 128: a few bytes
// spill; 0.42 -> 0.30 ms at the train path on an H100, PERF.md), one at
// hd 128.
template <typename T, int HD>
__global__ void __launch_bounds__(kDqThreads, HD == 64 ? 3 : 1)
bsa_bwd_dq_kernel(__grid_constant__ const BsaBwdParams p) {
  using L = SparseSmem<HD, false>;
  constexpr int P = L::Base::P, TILE = L::Base::tile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const bool has_bias = p.has_bias, has_kvb = p.has_kvb;
  unsigned char* Qs = smem + L::Base::res_off;
  unsigned char* dOs = Qs + TILE;
  unsigned char* ring = smem + L::Base::ring_off;   // stage s: K, then V
  unsigned char* Bs = smem + L::bias_off;
  float* KVBs = reinterpret_cast<float*>(smem + L::kvb_off(has_bias));
  attn::StageMeta* meta =
      reinterpret_cast<attn::StageMeta*>(smem + L::meta_off(has_bias));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off(has_bias));
  uint64_t* empty = full + STAGES;
  uint64_t* rfull = empty + STAGES;                 // Q and dO
  uint64_t* rempty = rfull + 1;
  const int T_len = p.T_len, n16 = T_len / FINE;
  const int n_items = p.B * p.H * p.n_t;
  const bool causal = p.causal;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) init_barriers(full, 1);
  __syncthreads();

  if (warp == 4) {
    // ---------------- producer: the whole warp; lane 0 issues the copies ----
    const uint32_t bytes = 2 * TILE + (has_bias ? 2 * PANEL : 0)
                           + (has_kvb ? BT * 4 : 0);
    int t = 0, wr = 0;                        // ring position, items loaded
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= n_items) break;
      const Item it = item_at(p, r);
      if (it.n == 0) continue;
      if (lane == 0) {
        mbar_wait(rempty, (wr & 1) ^ 1);
        mbar_expect_tx(rfull, 2 * TILE);
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
          tma_load_4d(Qs + pp * PANEL, &p.tq, rfull, 64 * pp, it.h, it.r0,
                      it.b);
          tma_load_4d(dOs + pp * PANEL, &p.tdo, rfull, 64 * pp, it.h, it.r0,
                      it.b);
        }
      }
      ++wr;
      const int* visits = p.idx + (long long)it.row * p.maxv;
      const uint8_t* fine_h = p.fine + (long long)it.h * n16 * n16;
      const int bb = p.bias_b ? it.b : 0, hb = p.bias_h ? it.h : 0;
      for (int c0 = 0; c0 < it.n; c0 += 32) {
        // lane u fetches visit c0 + u and its tile's fine cells
        int kt = 0;
        uint32_t w[4] = {0, 0, 0, 0};
        if (c0 + lane < it.n) {
          kt = visits[c0 + lane];
          attn::tile_cells(w, fine_h, n16, it.r0, kt * BT);
        }
        const int m = min(32, it.n - c0);
        for (int u = 0; u < m; ++u, ++t) {
          const int k0 = __shfl_sync(0xffffffffu, kt, u) * BT;
          uint32_t cl[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) cl[x] = __shfl_sync(0xffffffffu, w[x], u);
          if (lane == 0) {
            const int s = t % STAGES, n = t / STAGES;
            mbar_wait(&empty[s], (n & 1) ^ 1);
            // written before the arrive below, whose release the
            // consumers' wait on full[s] acquires
            attn::fill_stage(meta[s], k0, cl, false, it.r0, k0, T_len,
                             causal);
            mbar_expect_tx(&full[s], bytes);
            unsigned char* Ks = ring + 2 * s * TILE;
#pragma unroll
            for (int pp = 0; pp < P; ++pp) {
              tma_load_4d(Ks + pp * PANEL, &p.tk, &full[s], 64 * pp, it.h, k0,
                          it.b);
              tma_load_4d(Ks + TILE + pp * PANEL, &p.tv, &full[s], 64 * pp,
                          it.h, k0, it.b);
            }
            if (has_bias) {
              tma_load_4d(Bs + 2 * s * PANEL, &p.tbias, &full[s], k0, it.r0,
                          hb, bb);
              tma_load_4d(Bs + (2 * s + 1) * PANEL, &p.tbias, &full[s],
                          k0 + 32, it.r0, hb, bb);
            }
            if (has_kvb)
              tma_load_2d(KVBs + s * BT, &p.tkvb, &full[s], k0, it.b);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: one warpgroup, the item's 64 q rows -------
    const int qi = lane & 3;
    const int rl0 = 16 * warp + (lane >> 2), rl1 = rl0 + 8;
    int t = 0, wr = 0;
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= n_items) break;
      const Item it = item_at(p, r);
      const int q0 = it.r0, qpos0 = q0 + rl0, qpos1 = q0 + rl1;
      const long long row = ((long long)it.b * p.H + it.h) * T_len;
      // lse and delta of the thread's two rows; 0 past T, where Q and dO
      // are zero rows and the scores -inf: p = 0
      const float l0 = qpos0 < T_len ? p.lse[row + qpos0] : 0.f;
      const float l1 = qpos1 < T_len ? p.lse[row + qpos1] : 0.f;
      const float d0 = qpos0 < T_len ? p.delta[row + qpos0] : 0.f;
      const float d1 = qpos1 < T_len ? p.delta[row + qpos1] : 0.f;
      // dbias slab of this item: head h of per-head slabs, else slab 0
      const int slab = p.dbias_heads > 1 ? it.h : 0;
      // dQ [64 x HD] as one m64nHD accumulator
      float dq[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) dq[x] = 0.f;

      if (it.n > 0) {
        mbar_wait(rfull, wr & 1);
        ++wr;
        for (int v = 0; v < it.n; ++v, ++t) {
          const int s = t % STAGES, n = t / STAGES;
          mbar_wait(&full[s], n & 1);
          const unsigned char* Ks = ring + 2 * s * TILE;
          const unsigned char* Vs = Ks + TILE;
          const int k0 = meta[s].r0;
          // this warp's 16 rows are fine row `warp` of the tile
          const uint32_t live4 =
              *reinterpret_cast<const uint32_t*>(&meta[s].live[4 * warp]);
          const bool plain = meta[s].plain;
          float sc[32], dp[32];
          score_pair<T, HD>(sc, dp, Qs, Ks, dOs, Vs);  // S = Q K^T, dP = dO V^T
          wg_wait<1>();
          fence_regs(sc);
          const attn::SparseScore score{
              reinterpret_cast<const float*>(Bs + 2 * s * PANEL),
              KVBs + s * BT, live4, k0, q0, rl0, qi, T_len, plain, has_bias,
              has_kvb, causal};
          score(sc);
          // p = exp(s - lse): s - lse first, so a row whose visited keys
          // are all padded (s = lse = -1e30) gets p = 1 exactly
#pragma unroll
          for (int x = 0; x < 32; ++x)
            sc[x] = exp2f((sc[x] - ((x & 2) ? l1 : l0)) * kLog2e);
          wg_wait<0>();
          fence_regs(dp);
          if (v == it.n - 1) mbar_arrive(rempty);   // Q, dO read for good
          // ds = p (dp - delta)
#pragma unroll
          for (int x = 0; x < 32; ++x)
            dp[x] = sc[x] * (dp[x] - ((x & 2) ? d1 : d0));
          if (p.dbias) {
            // ds into the staged tile (swizzled as the bias tile's two
            // panels), then one thread adds it to dbias by two TMA
            // reductions; the previous stage's must have read it first
            float* Ds = reinterpret_cast<float*>(smem + L::ds_off);
            if (tid == 0)
              asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
            attn::wg_bar();
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int rl = half ? rl1 : rl0, c = 8 * j + 2 * qi;
                *reinterpret_cast<float2*>(
                    Ds + (c >> 5) * (PANEL / 4) + rl * 32
                    + ((((c & 31) >> 2) ^ (rl & 7)) << 2) + (c & 3)) =
                    make_float2(dp[4 * j + 2 * half],
                                dp[4 * j + 2 * half + 1]);
              }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            attn::wg_bar();
            if (tid == 0) {
              tma_reduce_add_4d(&p.tdbias, Ds, k0, q0, slab, it.b);
              tma_reduce_add_4d(&p.tdbias, Ds + PANEL / 4, k0 + 32, q0, slab,
                                it.b);
              asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
            }
          }
          // dQ += dS K, dS narrowed
          uint32_t da[BT / 16][4];
          fragments<T>(da, dp);
          accumulate<T>(dq, da, Ks);
          wg_wait<0>();
          fence_regs(dq);
          mbar_arrive(&empty[s]);
        }
      }

      T* base = static_cast<T*>(p.g0) + it.b * p.g0_sb + it.h * p.g0_sh;
      store_dq<T>(base, p.g0_st, dq, p.scale, qpos0, qpos1, qi, T_len);
    }
    // every reduction of this block has landed before it exits
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// the dk/dv pass
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kDkvThreads, 2)
bsa_bwd_dkv_kernel(__grid_constant__ const BsaBwdParams p) {
  using L = SparseSmem<HD, true>;
  constexpr int P = L::Base::P, TILE = L::Base::tile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const bool has_bias = p.has_bias, has_kvb = p.has_kvb;
  unsigned char* Ks = smem + L::Base::res_off;
  unsigned char* Vs = Ks + TILE;
  unsigned char* ring = smem + L::Base::ring_off;   // stage s: Q, then dO
  unsigned char* Bs = smem + L::bias_off;
  attn::StageMeta* meta =
      reinterpret_cast<attn::StageMeta*>(smem + L::meta_off(has_bias));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off(has_bias));
  uint64_t* empty = full + STAGES;
  uint64_t* rfull = empty + STAGES;                 // K and V
  uint64_t* rempty = rfull + 1;
  const int T_len = p.T_len, n16 = T_len / FINE;
  const int n_items = p.B * p.H * p.n_t;
  const bool causal = p.causal;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a stage is full once the 32 producer lanes have stored its lse / delta
  // and arrived (lane 0 with the TMA bytes expected) and the bytes landed
  if (tid == 0) init_barriers(full, 32);
  __syncthreads();

  if (warp >= 4) {
    // ---------------- producer: the whole of warp 4 ----------------
    // the producer warpgroup gives its registers to the consumers' (all
    // four warps take part), then warps 5-7 leave; at hd 64 the consumers
    // need 200, and 56 keep the producer's loop out of local memory
    if constexpr (HD == 64)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp > 4) return;
    const uint32_t bytes = 2 * TILE + (has_bias ? 2 * PANEL : 0);
    int t = 0, wr = 0;                        // ring position, items loaded
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= n_items) break;
      const Item it = item_at(p, r);
      if (it.n == 0) continue;
      const int k0 = it.r0;
      if (lane == 0) {
        mbar_wait(rempty, (wr & 1) ^ 1);
        mbar_expect_tx(rfull, 2 * TILE);
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
          tma_load_4d(Ks + pp * PANEL, &p.tk, rfull, 64 * pp, it.h, k0, it.b);
          tma_load_4d(Vs + pp * PANEL, &p.tv, rfull, 64 * pp, it.h, k0, it.b);
        }
      }
      ++wr;
      const int* visits = p.idx + (long long)it.row * p.maxv;
      const uint8_t* fine_h = p.fine + (long long)it.h * n16 * n16;
      const int bb = p.bias_b ? it.b : 0, hb = p.bias_h ? it.h : 0;
      const long long row = ((long long)it.b * p.H + it.h) * T_len;
      for (int c0 = 0; c0 < it.n; c0 += 32) {
        // lane u fetches visit c0 + u (a q tile) and its tile's fine cells
        int qt = 0;
        uint32_t w[4] = {0, 0, 0, 0};
        if (c0 + lane < it.n) {
          qt = visits[c0 + lane];
          attn::tile_cells(w, fine_h, n16, qt * BT, k0);
        }
        const int m = min(32, it.n - c0);
        for (int u = 0; u < m; ++u, ++t) {
          const int q0 = __shfl_sync(0xffffffffu, qt, u) * BT;
          uint32_t cl[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) cl[x] = __shfl_sync(0xffffffffu, w[x], u);
          // this stage's lse and delta, two columns a lane, read before
          // the wait; 0 past T
          float lv[2], dl[2];
          fetch_rows(lv, dl, p.lse, p.delta, row, q0, lane, T_len, 1.f);
          const int s = t % STAGES, n = t / STAGES;
          mbar_wait(&empty[s], (n & 1) ^ 1);
          put_rows(reinterpret_cast<float*>(smem + L::Base::rows_off
                                            + s * L::Base::rows_bytes),
                   lv, dl, lane);
          if (lane == 0) {
            attn::fill_stage(meta[s], q0, cl, true, q0, k0, T_len, causal);
            mbar_expect_tx(&full[s], bytes);
            unsigned char* Qs = ring + 2 * s * TILE;
#pragma unroll
            for (int pp = 0; pp < P; ++pp) {
              tma_load_4d(Qs + pp * PANEL, &p.tq, &full[s], 64 * pp, it.h, q0,
                          it.b);
              tma_load_4d(Qs + TILE + pp * PANEL, &p.tdo, &full[s], 64 * pp,
                          it.h, q0, it.b);
            }
            if (has_bias) {
              tma_load_4d(Bs + 2 * s * PANEL, &p.tbias, &full[s], k0, q0, hb,
                          bb);
              tma_load_4d(Bs + (2 * s + 1) * PANEL, &p.tbias, &full[s],
                          k0 + 32, q0, hb, bb);
            }
          } else {
            mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: one warpgroup, the item's 64 key rows -----
    if constexpr (HD == 64)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int qi = lane & 3;
    const int rl0 = 16 * warp + (lane >> 2), rl1 = rl0 + 8;
    int t = 0, wr = 0;
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= n_items) break;
      const Item it = item_at(p, r);
      const int k0 = it.r0, kpos0 = k0 + rl0, kpos1 = k0 + rl1;
      // the padding of the thread's two key rows, once per item
      const float* kvb_b = has_kvb ? p.kvb + (long long)it.b * T_len
                                   : nullptr;
      const float kb0 = kvb_b && kpos0 < T_len ? kvb_b[kpos0] : 0.f;
      const float kb1 = kvb_b && kpos1 < T_len ? kvb_b[kpos1] : 0.f;
      // dK, dV [64 x HD], each one m64nHD accumulator
      float dk[HD / 2], dv[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) {
        dk[x] = 0.f;
        dv[x] = 0.f;
      }

      if (it.n > 0) {
        mbar_wait(rfull, wr & 1);
        ++wr;
        for (int v = 0; v < it.n; ++v, ++t) {
          const int s = t % STAGES, n = t / STAGES;
          mbar_wait(&full[s], n & 1);
          const unsigned char* Qs = ring + 2 * s * TILE;
          const unsigned char* dOs = Qs + TILE;
          const float* rows = reinterpret_cast<const float*>(
              smem + L::Base::rows_off + s * L::Base::rows_bytes);
          const int q0 = meta[s].r0;
          // this warp's 16 key rows are k cell `warp` of the tile
          const uint32_t live4 =
              *reinterpret_cast<const uint32_t*>(&meta[s].live[4 * warp]);
          const bool plain = meta[s].plain;
          float sc[32], dp[32];
          score_pair<T, HD>(sc, dp, Ks, Qs, Vs, dOs);   // S^T, dP^T
          wg_wait<1>();
          fence_regs(sc);
          const SparseScoreT score{
              reinterpret_cast<const float*>(Bs + 2 * s * PANEL), live4, kb0,
              kb1, q0, kpos0, rl0, qi, T_len, plain, has_bias, has_kvb,
              causal};
          score(sc);
          // p^T = exp(s^T - lse[col]), lse of the stage's 64 queries
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j
                                                              + 2 * qi);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] = exp2f((sc[4 * j + e] - ((e & 1) ? l.y : l.x))
                                    * kLog2e);
          }
          wg_wait<0>();                               // dP^T done
          fence_regs(dp);
          if (v == it.n - 1) mbar_arrive(rempty);     // K, V read for good
          // dS^T = P^T (dP^T - delta[col]); then dV += P^T dO and dK +=
          // dS^T Q with P^T and dS^T narrowed
          const float* dl = rows + BT;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 d = *reinterpret_cast<const float2*>(dl + 8 * j
                                                              + 2 * qi);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * j + e] = sc[4 * j + e]
                              * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
          }
          uint32_t pa[BT / 16][4], da[BT / 16][4];
          fragments<T>(pa, sc);
          fragments<T>(da, dp);
          accumulate<T>(dv, pa, dOs);
          accumulate<T>(dk, da, Qs);
          wg_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          mbar_arrive(&empty[s]);
        }
      }

      T* kb = static_cast<T*>(p.g0) + it.b * p.g0_sb + it.h * p.g0_sh;
      store_rows<T>(kb, p.g0_st, dk, 1.f, kpos0, kpos1, qi, T_len);
      T* vb = static_cast<T*>(p.g1) + it.b * p.g1_sb + it.h * p.g1_sh;
      store_rows<T>(vb, p.g1_st, dv, 1.f, kpos0, kpos1, qi, T_len);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The forward: attn_fwd.cuh's mainloop over the visit lists, one 64-row q
// tile (one consumer warpgroup) per block, two stages of K, V, bias tile,
// padding row and the tile's fine cells (a third stage measured no faster).
template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, const float* bias, const float* kvb,
               const int* counts, const int* idx, const uint8_t* fine,
               const int* order, int B, int H, int T_len, int maxv,
               const long long* st, long long bias_sb, long long bias_sh,
               int causal, cudaStream_t stream) {
  attn::FwdParams p{};
  int rc = encode_heads<T>(&p.tq, q, B, H, T_len, HD,
                           st[0], st[1], st[2]);
  if (!rc) rc = encode_heads<T>(&p.tk, k, B, H, T_len, HD,
                                st[3], st[4], st[5]);
  if (!rc) rc = encode_heads<T>(&p.tv, v, B, H, T_len, HD,
                                st[6], st[7], st[8]);
  if (!rc) rc = encode_heads<T>(&p.to, o, B, H, T_len, HD,
                                st[9], st[10], st[11]);
  if (!rc && bias)
    rc = attn::encode_bias(&p.tbias, bias, bias_sb ? B : 1, bias_sh ? H : 1,
                           T_len);
  if (!rc && kvb) rc = attn::encode_rows(&p.tkvb, kvb, B, T_len);
  if (rc) return rc;
  p.lse = lse;
  p.o = o;
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_st = st[11];
  p.B = B;
  p.H = H;
  p.G = 1;
  p.T_len = T_len;
  p.n_qt = (T_len + BT - 1) / BT;
  p.scale = 1.f;
  p.causal = causal;
  p.counts = counts;
  p.idx = idx;
  p.fine = fine;
  p.order = order;
  p.maxv = maxv;
  p.has_bias = bias != nullptr;
  p.bias_b = bias_sb != 0;
  p.bias_h = bias_sh != 0;
  p.has_kvb = kvb != nullptr;
  return attn::launch<true, T, HD, 2>(p, stream);
}

// Launch one backward pass: as many persistent blocks as fit the card at
// once (with or without a bias), at most one per item.
template <bool DKV, typename T, int HD>
int launch_bwd(const BsaBwdParams& p, cudaStream_t stream) {
  using L = SparseSmem<HD, DKV>;
  constexpr auto kernel = [] {
    if constexpr (DKV)
      return bsa_bwd_dkv_kernel<T, HD>;
    else
      return bsa_bwd_dq_kernel<T, HD>;
  }();
  return launch_items<kernel>(p, (long long)p.B * p.H * p.n_t,
                              DKV ? kDkvThreads : kDqThreads,
                              L::bytes(p.has_bias), L::bytes(true), true,
                              stream);
}

template <bool DKV, typename T, int HD>
int run_bwd(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* g0, void* g1,
            float* dbias, const float* bias, const float* kvb,
            const int* counts, const int* idx, const uint8_t* fine,
            const int* order, int B, int H, int T_len, int maxv,
            const long long* st, long long bias_sb, long long bias_sh,
            int dbias_heads, float scale, int causal, cudaStream_t stream) {
  BsaBwdParams p{};
  int rc = encode_heads<T>(&p.tq, q, B, H, T_len, HD, st[0], st[1], st[2]);
  if (!rc) rc = encode_heads<T>(&p.tk, k, B, H, T_len, HD,
                                st[3], st[4], st[5]);
  if (!rc) rc = encode_heads<T>(&p.tv, v, B, H, T_len, HD,
                                st[6], st[7], st[8]);
  if (!rc) rc = encode_heads<T>(&p.tdo, dout, B, H, T_len, HD,
                                st[9], st[10], st[11]);
  if (!rc && bias)
    rc = attn::encode_bias(&p.tbias, bias, bias_sb ? B : 1, bias_sh ? H : 1,
                           T_len);
  if (!rc && kvb && !DKV) rc = attn::encode_rows(&p.tkvb, kvb, B, T_len);
  if (!rc && dbias) rc = attn::encode_bias(&p.tdbias, dbias, B, dbias_heads,
                                           T_len);
  if (rc) return rc;
  p.lse = lse;
  p.delta = delta;
  p.kvb = kvb;
  p.g0 = g0;
  p.g1 = g1;
  p.g0_sb = st[12];
  p.g0_sh = st[13];
  p.g0_st = st[14];
  p.g1_sb = st[15];
  p.g1_sh = st[16];
  p.g1_st = st[17];
  p.dbias = dbias;
  p.dbias_heads = dbias_heads;
  p.counts = counts;
  p.idx = idx;
  p.fine = fine;
  p.order = order;
  p.maxv = maxv;
  p.B = B;
  p.H = H;
  p.T_len = T_len;
  p.n_t = (T_len + BT - 1) / BT;
  p.scale = scale;
  p.causal = causal;
  p.has_bias = bias != nullptr;
  p.bias_b = bias_sb != 0;
  p.bias_h = bias_sh != 0;
  p.has_kvb = kvb != nullptr;
  return launch_bwd<DKV, T, HD>(p, stream);
}

}  // namespace
}  // namespace bsa
}  // namespace dstt

// q / k / v / o / do / dq / dk / dv: [B, *, H, D] tensors in any layout whose
// last dim is contiguous and whose other strides are multiples of 16 bytes,
// 16-byte aligned; `strides` (host memory, 18 entries) holds their (batch,
// head, time) element strides: q, k, v, then o (forward), do, dq (dq pass)
// or do, dk, dv (dk/dv pass). lse and delta [B, H, T] fp32 contiguous.
// bias: fp32, row-major [T, T] slabs at element offset b * bias_sb + h *
// bias_sh, or null; kvb: [B, T] fp32 additive padding row, or null. counts
// [H, T/64 rounded up] and idx [H, ..., maxv] int32 visit lists (transposed
// for dk/dv), fine uint8 [H, T/16, T/16], order int32 [H * T/64 rounded
// up]: the (h, tile) rows longest list first (the plan's row_order; dk/dv:
// col_order). dbias: null, or [B, dbias_heads, T, T] fp32 zeroed by the
// caller. dtype: 1 bfloat16, 2 float16; D 64 or 128. Each returns
// cudaGetLastError(), or 10000 + the CUresult of a failed tensor-map
// encode.
extern "C" int dstt_bsa_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, const float* bias,
                            const float* kvb, const int* counts,
                            const int* idx, const uint8_t* fine,
                            const int* order, int B, int H, int T_len, int D,
                            int maxv, const long long* strides,
                            long long bias_sb, long long bias_sh, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(T, HD) dstt::bsa::launch_fwd<T, HD>(                              \
    q, k, v, o, lse, bias, kvb, counts, idx, fine, order, B, H, T_len, maxv, \
    strides, bias_sb, bias_sh, causal, s)
  if (dtype == 1 && D == 64) return FWD(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return FWD(__nv_bfloat16, 128);
  if (dtype == 2 && D == 64) return FWD(__half, 64);
  if (dtype == 2 && D == 128) return FWD(__half, 128);
#undef FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstt_bsa_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, float* dbias,
                               const float* bias, const float* kvb,
                               const int* counts, const int* idx,
                               const uint8_t* fine, const int* order, int B,
                               int H, int T_len, int D, int maxv,
                               const long long* strides, long long bias_sb,
                               long long bias_sh, int dbias_heads,
                               float scale, int causal, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, HD) dstt::bsa::run_bwd<false, T, HD>(                          \
    q, k, v, dout, lse, delta, dq, nullptr, dbias, bias, kvb, counts, idx,  \
    fine, order, B, H, T_len, maxv, strides, bias_sb, bias_sh, dbias_heads, \
    scale, causal, s)
  if (dtype == 1 && D == 64) return DQ(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return DQ(__nv_bfloat16, 128);
  if (dtype == 2 && D == 64) return DQ(__half, 64);
  if (dtype == 2 && D == 128) return DQ(__half, 128);
#undef DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstt_bsa_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dk, void* dv,
                                const float* bias, const float* kvb,
                                const int* countsT, const int* idxT,
                                const uint8_t* fine, const int* orderT, int B,
                                int H, int T_len, int D, int maxv,
                                const long long* strides, long long bias_sb,
                                long long bias_sh, int causal, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, HD) dstt::bsa::run_bwd<true, T, HD>(                          \
    q, k, v, dout, lse, delta, dk, dv, nullptr, bias, kvb, countsT, idxT,   \
    fine, orderT, B, H, T_len, maxv, strides, bias_sb, bias_sh, 0, 1.f,     \
    causal, s)
  if (dtype == 1 && D == 64) return DKV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return DKV(__nv_bfloat16, 128);
  if (dtype == 2 && D == 64) return DKV(__half, 64);
  if (dtype == 2 && D == 128) return DKV(__half, 128);
#undef DKV
  return (int)cudaErrorInvalidValue;
}
