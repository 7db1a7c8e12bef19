// flash_bwd.cu — flash-attention backward (dq, and dk / dv), Hopper.
//
// Replaces the two Pallas backward kernels of
// deepspeed_tpu/ops/pallas/flash_attention.py, both driven by _flash_bwd
// (:278):
//   * the dq pass (pallas_call :297, kernel _bwd_dq_kernel :176):
//       dq = scale * sum_k ds k,  ds = p (dp - delta),  p = exp(s - lse),
//       dp = do v^T, s = scale * q k^T;
//   * the dk/dv pass (pallas_call :323, kernel _bwd_dkv_kernel :226):
//       dv = sum_q p^T do,  dk = scale * sum_q ds^T q.
// The training step reaches them through the autograd function of
// ops/flash_attention.py (the port of _flash_vjp_bwd :369 and
// _flash_lse_vjp_bwd :429). delta = rowsum(do * o) - dlse comes in from the
// wrapper (fp32, [B, H, T]); lse is the forward's ([B, H, T], fp32).
//
// What bounds it on the H100: operations at training lengths (6 * D flops
// per causal (q, k) pair in the dq pass, 8 * D in the dk/dv pass, against
// about 5-6 * T * D elements moved per head and pass). Both passes keep the
// T x T probabilities out of device memory and run every product on wgmma
// with fp32 accumulators in registers, on the forward's building blocks
// (sm90.cuh) and the pass-level helpers it shares with block_sparse.cu's
// backward (attn_bwd.cuh):
//   * Two passes, no atomics. A work item is one 64-row tile of one head:
//       - dq: (q tile, b, h). Q and dO are the item's resident tiles; the
//         K/V tiles stream from 0 to the causal frontier;
//       - dk/dv: (k tile, b, kv head hk). K and V are resident; the Q/dO
//         tiles stream, for each of the G query heads of hk in turn, from
//         the first q tile that reaches this k tile to the last, so
//         grouped-query attention sums dk / dv over the group in registers
//         and writes [B, T, Hkv, D] once.
//   * A block is one consumer warpgroup (the item's 64 rows) and one
//     producer warp (dk/dv: the first warp of a producer warpgroup that
//     gives its registers to the consumers with setmaxnreg, so that two
//     blocks fit an SM at hd 128). The producer keeps a ring of STAGES
//     stages filled with TMA copies (128-byte swizzle, full / empty
//     mbarriers) and brings each item's resident pair on barriers of its
//     own; the consumers release the resident pair as soon as its last
//     product has read it, so the next item's copies overlap this one's
//     end. Blocks are persistent (as many as fit the card) and walk the
//     items longest first: the last q tile first (dq), k tile 0 first
//     (dk/dv).
//   * Every product has one of the forward's two forms (sm90.cuh):
//     score-shaped, m64n64k16 from shared memory (S = Q K^T, dP = dO V^T;
//     S^T = K Q^T, dP^T = V dO^T: the dk/dv pass computes the transposes
//     directly, so nothing is transposed in the kernel), and accumulating,
//     m64nHDk16 with the left factor as a register fragment of a score
//     accumulator narrowed to 16 bits and the right one read through the
//     transposed descriptor (dQ += dS K; dV += P^T dO, dK += dS^T Q). So
//     K (dq) and Q, dO (dk/dv) are each read both ways from one tile.
//   * The softmax backward runs in registers: p = exp2(s scale log2e -
//     lse log2e), ds = p (dp - delta). The dq pass reads lse and delta of
//     its two rows a thread once per item; in the dk/dv pass the columns
//     are queries, so the producer stages each q tile's 64 lse and delta
//     values beside Q and dO (plain loads: a [B, H, T] row of a ragged T is
//     not 16-byte aligned for TMA) and publishes them with the stage's
//     arrive (the full barrier counts the 32 producer lanes and the TMA
//     bytes).
//   * Overlap inside a stage: the two score products are two commit
//     groups, and p is computed while dP is still on the tensor cores.
//     Between stages, the SM's other block (two a SM in both passes at
//     hd 128) fills the tensor cores while one computes its softmax.
//   * Masks run only on tiles that cross the diagonal or T (a template
//     parameter, as the forward's FlashScore): causality (kpos > qpos) and
//     columns past T give p = 0. Rows past T arrive as zeros (TMA's
//     out-of-bounds fill) and are never written.
//   * Rounding follows the Pallas kernels: p in fp32, p narrowed to the
//     input dtype before dv += p^T do, ds narrowed before dq += ds k and
//     dk += ds^T q, fp32 accumulators, scale applied to dq and dk once at
//     the end.
//   * Strides are passed per tensor (TMA maps over [B, T, H, D] views, the
//     fused qkv projection read in place); the gradients are written from
//     registers in the layout the wrapper allocated.
// Budget per block, hd 128: shared memory 97 KB (dq: Q, dO and two K/V
// stages) and 98 KB (dk/dv: K, V and two Q/dO/lse/delta stages);
// registers per consumer thread: dQ 64 fp32 + S, dP 32 each (dq), dK, dV
// 64 each + S^T, dP^T 32 each (dk/dv). nvcc -Xptxas -v
// (tools/attn_bwd_ab.py --ptxas) and the counts' effect are in PERF.md.
//
// Later work: 128-row items (two consumer warpgroups sharing each stage)
// and the next stage's score products issued under this one's softmax.

#include "attn_bwd.cuh"

namespace dstt {
namespace bwd {
namespace {

using namespace dstt::sm90;

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;    // [B, T, H(kv), D] views, box {64, 1, 64, 1}
  const float* lse;               // [B, H, T] fp32, contiguous
  const float* delta;             // [B, H, T] fp32, contiguous
  void* g0;                       // dq (dq pass) or dk
  void* g1;                       // dv (dk/dv pass)
  long long g0_sb, g0_sh, g0_st;  // element strides (batch, head, time)
  long long g1_sb, g1_sh, g1_st;
  int B, H, G, T_len, n_t;        // G: query heads a kv head; n_t: tiles
  float scale;
  int causal;
};

// dq work item r (0 .. B * H * n_t - 1): the q tiles walked from the last
// (the longest causal row) down.
struct DqItem {
  int b, h, q0, n_k;
};

__device__ __forceinline__ DqItem dq_item(const BwdParams& p, int r) {
  DqItem it;
  const int bh = r % (p.B * p.H);
  const int qt = p.n_t - 1 - r / (p.B * p.H);
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.q0 = qt * BT;
  it.n_k = p.causal ? qt + 1 : p.n_t;
  return it;
}

// dk/dv work item r (0 .. B * Hkv * n_t - 1): k tile 0 (the longest causal
// walk) first; q tiles qt0 .. n_t - 1 of each of the G query heads.
struct DkvItem {
  int b, hk, k0, qt0;
};

__device__ __forceinline__ DkvItem dkv_item(const BwdParams& p, int r) {
  DkvItem it;
  const int hkv = p.H / p.G;
  const int bh = r % (p.B * hkv);
  const int kt = r / (p.B * hkv);
  it.b = bh / hkv;
  it.hk = bh % hkv;
  it.k0 = kt * BT;
  it.qt0 = p.causal ? kt : 0;
  return it;
}

// A thread's accumulator element i sits at tile row (i & 2 ? r1 : r0) and
// column 8 (i >> 2) + 2 qi + (i & 1); r0 = 16 warp + lane / 4, r1 = r0 + 8.

// dq pass: p = exp2(s scale log2e - lse log2e) in place, lse of the
// thread's two rows (l0, l1) in log2 units; where MASK, 0 at keys past T
// and (causal) above the diagonal.
template <bool MASK>
__device__ __forceinline__ void dq_probs(float (&sc)[32], float sl2, float l0,
                                         float l1, int k0, int qpos0,
                                         int qpos1, int qi, int T_len,
                                         bool causal) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = exp2f(fmaf(sc[i], sl2, -((i & 2) ? l1 : l0)));
    if (MASK) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * qi + (i & 1);
      const int qpos = (i & 2) ? qpos1 : qpos0;
      if (kpos >= T_len || (causal && kpos > qpos)) x = 0.f;
    }
    sc[i] = x;
  }
}

// dk/dv pass: the same on S^T, whose columns are queries: lse (log2 units)
// of the stage's 64 columns from shared memory; where MASK, 0 at queries
// past T and (causal) where the key (row) follows the query.
template <bool MASK>
__device__ __forceinline__ void dkv_probs(float (&sc)[32], const float* lse2,
                                          float sl2, int q0, int kpos0,
                                          int kpos1, int qi, int T_len,
                                          bool causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * qi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float x = exp2f(fmaf(sc[i], sl2, -((e & 1) ? l.y : l.x)));
      if (MASK) {
        const int qpos = q0 + 8 * j + 2 * qi + (e & 1);
        const int kpos = (e & 2) ? kpos1 : kpos0;
        if (qpos >= T_len || (causal && kpos > qpos)) x = 0.f;
      }
      sc[i] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// the dq pass
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_kernel(__grid_constant__ const BwdParams p) {
  using L = BwdSmem<HD, false>;
  constexpr int P = L::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem + L::res_off;
  unsigned char* dOs = Qs + L::tile;
  unsigned char* ring = smem + L::ring_off;     // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* rfull = empty + STAGES;             // Q and dO
  uint64_t* rempty = rfull + 1;
  const int T_len = p.T_len;
  const int n_items = p.B * p.H * p.n_t;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) init_barriers(full, 1);
  __syncthreads();

  if (warp == 4) {
    // ---------------- producer: one thread issues every copy ----------------
    if (lane == 0) {
      int t = 0;                                    // position in the ring
      for (int w = 0;; ++w) {
        const int r = item_of(w, blockIdx.x, gridDim.x);
        if (r >= n_items) break;
        const DqItem it = dq_item(p, r);
        mbar_wait(rempty, (w & 1) ^ 1);
        mbar_expect_tx(rfull, 2 * L::tile);
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
          tma_load_4d(Qs + pp * PANEL, &p.tq, rfull, 64 * pp, it.h, it.q0,
                      it.b);
          tma_load_4d(dOs + pp * PANEL, &p.tdo, rfull, 64 * pp, it.h, it.q0,
                      it.b);
        }
        const int hk = it.h / p.G;
        for (int kt = 0; kt < it.n_k; ++kt, ++t) {
          const int s = t % STAGES, n = t / STAGES;
          mbar_wait(&empty[s], (n & 1) ^ 1);
          unsigned char* Ks = ring + 2 * s * L::tile;
          mbar_expect_tx(&full[s], 2 * L::tile);
#pragma unroll
          for (int pp = 0; pp < P; ++pp) {
            tma_load_4d(Ks + pp * PANEL, &p.tk, &full[s], 64 * pp, hk,
                        kt * BT, it.b);
            tma_load_4d(Ks + L::tile + pp * PANEL, &p.tv, &full[s], 64 * pp,
                        hk, kt * BT, it.b);
          }
        }
      }
    }
  } else {
    // ---------------- consumers: one warpgroup, the item's 64 q rows -------
    const int qi = lane & 3;
    const int rl0 = 16 * warp + (lane >> 2), rl1 = rl0 + 8;
    const bool causal = p.causal;
    const float sl2 = p.scale * kLog2e;
    int t = 0;                                      // position in the ring
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= n_items) break;
      const DqItem it = dq_item(p, r);
      const int qpos0 = it.q0 + rl0, qpos1 = it.q0 + rl1;
      const long long row = ((long long)it.b * p.H + it.h) * T_len;
      // lse (in log2 units) and delta of the thread's two rows; 0 past T,
      // where Q and dO are zero rows: p = 1, dp = 0, ds = 0
      const float l0 = qpos0 < T_len ? p.lse[row + qpos0] * kLog2e : 0.f;
      const float l1 = qpos1 < T_len ? p.lse[row + qpos1] * kLog2e : 0.f;
      const float d0 = qpos0 < T_len ? p.delta[row + qpos0] : 0.f;
      const float d1 = qpos1 < T_len ? p.delta[row + qpos1] : 0.f;
      // dQ [64 x HD] as one m64nHD accumulator
      float dq[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) dq[x] = 0.f;
      mbar_wait(rfull, w & 1);

      for (int kt = 0; kt < it.n_k; ++kt, ++t) {
        const int s = t % STAGES, n = t / STAGES;
        mbar_wait(&full[s], n & 1);
        const unsigned char* Ks = ring + 2 * s * L::tile;
        const unsigned char* Vs = Ks + L::tile;
        float sc[32], dp[32];
        score_pair<T, HD>(sc, dp, Qs, Ks, dOs, Vs);   // S = Q K^T, dP = dO V^T
        wg_wait<1>();
        fence_regs(sc);
        const int k0 = kt * BT;
        if (k0 + BT > T_len || (causal && k0 + BT - 1 > it.q0))
          dq_probs<true>(sc, sl2, l0, l1, k0, qpos0, qpos1, qi, T_len, causal);
        else
          dq_probs<false>(sc, sl2, l0, l1, k0, qpos0, qpos1, qi, T_len,
                          causal);
        wg_wait<0>();
        fence_regs(dp);
        if (kt == it.n_k - 1) mbar_arrive(rempty);  // Q, dO read for good
        // ds = p (dp - delta), narrowed: the A fragments of dQ += dS K
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dp[i] = sc[i] * (dp[i] - ((i & 2) ? d1 : d0));
        uint32_t da[BT / 16][4];
        fragments<T>(da, dp);
        accumulate<T>(dq, da, Ks);
        wg_wait<0>();
        fence_regs(dq);
        mbar_arrive(&empty[s]);
      }

      T* base = static_cast<T*>(p.g0) + it.b * p.g0_sb + it.h * p.g0_sh;
      store_rows<T>(base, p.g0_st, dq, p.scale, qpos0, qpos1, qi, T_len);
    }
  }
}

// ---------------------------------------------------------------------------
// the dk/dv pass
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kDkvThreads, 2)
flash_bwd_dkv_kernel(__grid_constant__ const BwdParams p) {
  using L = BwdSmem<HD, true>;
  constexpr int P = L::P;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem + L::res_off;
  unsigned char* Vs = Ks + L::tile;
  unsigned char* ring = smem + L::ring_off;     // stage s: Q, then dO
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* rfull = empty + STAGES;             // K and V
  uint64_t* rempty = rfull + 1;
  const int T_len = p.T_len;
  const int n_items = p.B * (p.H / p.G) * p.n_t;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a stage is full once the 32 producer lanes have stored its lse / delta
  // and arrived (lane 0 with the TMA bytes expected) and the bytes landed
  if (tid == 0) init_barriers(full, 32);
  __syncthreads();

  if (warp >= 4) {
    // ---------------- producer: the whole of warp 4 ----------------
    // the producer warpgroup gives its registers to the consumers' (all
    // four warps take part), then warps 5-7 leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp > 4) return;
    int t = 0;                                      // position in the ring
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= n_items) break;
      const DkvItem it = dkv_item(p, r);
      if (lane == 0) {
        mbar_wait(rempty, (w & 1) ^ 1);
        mbar_expect_tx(rfull, 2 * L::tile);
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
          tma_load_4d(Ks + pp * PANEL, &p.tk, rfull, 64 * pp, it.hk, it.k0,
                      it.b);
          tma_load_4d(Vs + pp * PANEL, &p.tv, rfull, 64 * pp, it.hk, it.k0,
                      it.b);
        }
      }
      const int n_q = p.n_t - it.qt0;
      for (int i = 0; i < p.G * n_q; ++i, ++t) {
        const int h = it.hk * p.G + i / n_q;
        const int q0 = (it.qt0 + i % n_q) * BT;
        const long long row = ((long long)it.b * p.H + h) * T_len;
        // this stage's lse (log2 units) and delta, two columns a lane, read
        // before the wait; 0 past T
        float lv[2], dl[2];
        fetch_rows(lv, dl, p.lse, p.delta, row, q0, lane, T_len, kLog2e);
        const int s = t % STAGES, n = t / STAGES;
        mbar_wait(&empty[s], (n & 1) ^ 1);
        put_rows(reinterpret_cast<float*>(smem + L::rows_off
                                          + s * L::rows_bytes),
                 lv, dl, lane);
        if (lane == 0) {
          unsigned char* Qs = ring + 2 * s * L::tile;
          mbar_expect_tx(&full[s], 2 * L::tile);
#pragma unroll
          for (int pp = 0; pp < P; ++pp) {
            tma_load_4d(Qs + pp * PANEL, &p.tq, &full[s], 64 * pp, h, q0,
                        it.b);
            tma_load_4d(Qs + L::tile + pp * PANEL, &p.tdo, &full[s], 64 * pp,
                        h, q0, it.b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---------------- consumers: one warpgroup, the item's 64 key rows -----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int qi = lane & 3;
    const int rl0 = 16 * warp + (lane >> 2), rl1 = rl0 + 8;
    const bool causal = p.causal;
    const float sl2 = p.scale * kLog2e;
    int t = 0;                                      // position in the ring
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= n_items) break;
      const DkvItem it = dkv_item(p, r);
      const int kpos0 = it.k0 + rl0, kpos1 = it.k0 + rl1;
      // dK, dV [64 x HD], each one m64nHD accumulator, summed over the
      // G x q-tile walk
      float dk[HD / 2], dv[HD / 2];
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) {
        dk[x] = 0.f;
        dv[x] = 0.f;
      }
      mbar_wait(rfull, w & 1);

      const int n_q = p.n_t - it.qt0, n_st = p.G * n_q;
      for (int i = 0; i < n_st; ++i, ++t) {
        const int s = t % STAGES, n = t / STAGES;
        mbar_wait(&full[s], n & 1);
        const unsigned char* Qs = ring + 2 * s * L::tile;
        const unsigned char* dOs = Qs + L::tile;
        const float* rows = reinterpret_cast<const float*>(
            smem + L::rows_off + s * L::rows_bytes);
        float sc[32], dp[32];
        score_pair<T, HD>(sc, dp, Ks, Qs, Vs, dOs);   // S^T, dP^T
        wg_wait<1>();
        fence_regs(sc);
        const int q0 = (it.qt0 + i % n_q) * BT;
        if (q0 + BT > T_len || (causal && q0 < it.k0 + BT - 1))
          dkv_probs<true>(sc, rows, sl2, q0, kpos0, kpos1, qi, T_len, causal);
        else
          dkv_probs<false>(sc, rows, sl2, q0, kpos0, kpos1, qi, T_len,
                           causal);
        wg_wait<0>();                               // dP^T done
        fence_regs(dp);
        if (i == n_st - 1) mbar_arrive(rempty);     // K, V read for good
        // dS^T = P^T (dP^T - delta[col]); then dV += P^T dO and dK += dS^T Q
        // with P^T and dS^T narrowed
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

      T* kb = static_cast<T*>(p.g0) + it.b * p.g0_sb + it.hk * p.g0_sh;
      store_rows<T>(kb, p.g0_st, dk, p.scale, kpos0, kpos1, qi, T_len);
      T* vb = static_cast<T*>(p.g1) + it.b * p.g1_sb + it.hk * p.g1_sh;
      store_rows<T>(vb, p.g1_st, dv, 1.f, kpos0, kpos1, qi, T_len);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Launch one pass: as many persistent blocks as fit the card at once, at
// most one per item.
template <bool DKV, typename T, int HD>
int launch(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = BwdSmem<HD, DKV>::bytes;
  constexpr auto kernel = [] {
    if constexpr (DKV)
      return flash_bwd_dkv_kernel<T, HD>;
    else
      return flash_bwd_dq_kernel<T, HD>;
  }();
  const long long items =
      (long long)p.B * (DKV ? p.H / p.G : p.H) * p.n_t;
  return launch_items<kernel>(p, items, DKV ? kDkvThreads : kDqThreads,
                              smem, smem, true, stream);
}

template <bool DKV, typename T, int HD>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* g0, void* g1, int B,
        int H, int Hkv, int T_len, const long long* st, float scale,
        int causal, cudaStream_t stream) {
  BwdParams p{};
  int rc = encode_heads<T>(&p.tq, q, B, H, T_len, HD, st[0], st[1], st[2]);
  if (!rc) rc = encode_heads<T>(&p.tk, k, B, Hkv, T_len, HD,
                                st[3], st[4], st[5]);
  if (!rc) rc = encode_heads<T>(&p.tv, v, B, Hkv, T_len, HD,
                                st[6], st[7], st[8]);
  if (!rc) rc = encode_heads<T>(&p.tdo, dout, B, H, T_len, HD,
                                st[9], st[10], st[11]);
  if (rc) return rc;
  p.lse = lse;
  p.delta = delta;
  p.g0 = g0;
  p.g1 = g1;
  p.g0_sb = st[12];
  p.g0_sh = st[13];
  p.g0_st = st[14];
  p.g1_sb = st[15];
  p.g1_sh = st[16];
  p.g1_st = st[17];
  p.B = B;
  p.H = H;
  p.G = H / Hkv;
  p.T_len = T_len;
  p.n_t = (T_len + BT - 1) / BT;
  p.scale = scale;
  p.causal = causal;
  return launch<DKV, T, HD>(p, stream);
}

template <bool DKV>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* g0, void* g1, int B,
             int H, int Hkv, int T_len, int D, const long long* st,
             float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(T, HD) run<DKV, T, HD>(q, k, v, dout, lse, delta, g0, g1, B, H, \
                                   Hkv, T_len, st, scale, causal, s)
  if (dtype == 1 && D == 64) return RUN(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return RUN(__nv_bfloat16, 128);
  if (dtype == 2 && D == 64) return RUN(__half, 64);
  if (dtype == 2 && D == 128) return RUN(__half, 128);
#undef RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace bwd
}  // namespace dstt

// q / do / dq [B, *, H, D] and k / v / dk / dv [B, *, Hkv, D] in any layout
// whose last dim is contiguous and whose other strides are multiples of 16
// bytes, 16-byte aligned. `strides` (host memory) holds 18 element strides,
// (batch, head, time) for q, k, v, do, then dq (dq pass; the last three are
// unused) or dk, dv (dk/dv pass). lse and delta [B, H, T] fp32 contiguous.
// dtype: 1 bfloat16, 2 float16. Each returns cudaGetLastError(), or 10000 +
// the CUresult of a failed tensor-map encode.
extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int B, int H,
                                 int Hkv, int T_len, int D,
                                 const long long* strides, float scale,
                                 int causal, int dtype, void* stream) {
  return dstt::bwd::dispatch<false>(q, k, v, dout, lse, delta, dq, nullptr,
                                    B, H, Hkv, T_len, D, strides, scale,
                                    causal, dtype, stream);
}

extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int B, int H, int Hkv, int T_len, int D,
                                  const long long* strides, float scale,
                                  int causal, int dtype, void* stream) {
  return dstt::bwd::dispatch<true>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                   Hkv, T_len, D, strides, scale, causal,
                                   dtype, stream);
}
