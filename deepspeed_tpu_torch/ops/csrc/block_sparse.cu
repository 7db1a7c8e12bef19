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
// of ops/block_sparse_attention.py.
//
// What bounds it on the H100: operations (4 * D flops per live (q, k) cell
// in the forward, 6 * D in the dq pass, 8 * D in the dk/dv pass, against
// about 4 * T * D elements moved per head and pass).
//
// The forward is attn_fwd.cuh's Hopper mainloop (wgmma with accumulators in
// registers, a TMA ring of K/V stages fed by a producer warp, the online
// softmax in registers) walking visit lists:
//   * one block per (64-row q tile, b, h) with one consumer warpgroup; the
//     producer walks the tile's visit list (int32 [H, n_tiles, max_visits]
//     plus counts, built on the host at these 64 x 64 tiles), so dead tiles
//     are neither loaded nor computed, and stages the fp32 bias tile (TMA
//     box at (q0, k0) of the [Bb, Hb, T, T] slab, index 0 on a broadcast
//     dim) and the padding row beside K and V; the 4 x 4 fine cells are a
//     plain load;
//   * blocks walk the (h, q tile) rows in the plan's longest-first order
//     (`order`, a permutation sorted by visit count), so the rows with ~70
//     visits do not start behind those with one.
// The backward passes are still a pre-Hopper design (flash_bwd.cu's wgmma /
// TMA passes, the same products over a causal walk, are the model for
// their redesign), with the visit list as the loop:
//   * one thread block (4 warps) per (64-row tile, b * h); its loop walks
//     the tile's visit list (dk/dv: the transposed lists). The TPU's
//     sequential grid axis becomes that loop: no atomics, except for a
//     head-shared learned bias (below);
//   * each warp owns a 16-row strip for every product (nvcuda::wmma
//     16x16x16, bf16/fp16 in, fp32 accumulation) and for the elementwise
//     work between them;
//   * masks are read straight from device memory by index: the 16-token
//     fine mask (uint8 [H, T/16, T/16]; the tile's 4 x 4 cells staged in
//     shared memory), the fp32 bias [Bb, Hb, T, T] through batch / head
//     strides (0 where it broadcasts, so a batched [B, T, T] mask is one
//     more stride), and the additive key-padding row [B, T].
// No one-hot selection matmuls, no bias copy blocked per tile, no VMEM
// budget. All three kernels:
//   * follow the Pallas kernels' numerics: scores masked with the finite
//     -1e30 (a query row whose visited keys are all padded takes the mean
//     of its visited V, as there), m starting at -1e30, p and ds narrowed
//     to the input dtype before their second product, fp32 statistics and
//     accumulators. q arrives scaled and rounded by the wrapper; dq leaves
//     rounded, then scaled in fp32 and rounded again (JAX :614); dk gets no
//     scale (it is contracted against the scaled q, :669);
//   * take any T that is a multiple of 16: cells past T get -inf (p = 0),
//     rows past T load as zeros and are never written;
//   * dbias (only when the wrapper asks): [B, Hb, T, T] fp32, zeroed by the
//     wrapper; a block writes ds on its visited cells. With per-head slabs
//     (Hb == H) each cell has one writer and a plain store does. With one
//     slab shared by H > 1 heads, blocks of different heads run at once and
//     add into the same cells: fp32 atomicAdd. The alternative, per-head
//     slabs summed afterwards, would hold H times the dense [T, T] output
//     (3.2 GB at T 8192, H 12) where the atomics need nothing extra; their
//     order changes only the last bits of a sum of H terms.
// Shared memory, hd 128: 113 KB (forward, with a bias), 154 KB (dq) and
// 187 KB (dk/dv).
// Later work: the backward passes on the same Hopper design (wgmma, TMA,
// register accumulators); a persistent forward fed by a dynamic work
// queue (fixed rounds of rows balanced worse than the hardware's own
// block scheduling).

#include "attn_fwd.cuh"


#include <mma.h>

namespace {

using namespace dstt;
using namespace nvcuda;

constexpr int BT = 64, FINE = 16, FPT = BT / FINE, kWarps = 4,
              kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

// Element strides (batch, head, time) of q, k, v, then o (forward), do and
// dq (dq pass) or do, dk, dv (dk/dv pass), passed to the kernel by value.
struct Strides {
  long long s[18];
};

// Both backward passes: four 16-bit [64, HD] tiles (the block's resident
// pair and the streamed pair), two fp32 [64, 64] score tiles (S and dP),
// two 16-bit [64, 64] tiles (P and dS), the streamed rows' lse / delta,
// the padding row and fine cells, and two fp32 [64, HD] accumulators (dq
// uses one). Every offset is a multiple of 32 bytes, as wmma requires.
template <int HD>
struct BwdLayout {
  static constexpr int LDH = HD + 8;
  static constexpr int LDS = BT + 4;
  static constexpr int LDP = BT + 8;
  static constexpr int LDA = HD + 4;   // fp32 accumulator rows
  static constexpr size_t tile16 = BT * LDH * 2;
  static constexpr size_t a_off = 0;
  static constexpr size_t b_off = a_off + tile16;
  static constexpr size_t c_off = b_off + tile16;
  static constexpr size_t d_off = c_off + tile16;
  static constexpr size_t s_off = d_off + tile16;
  static constexpr size_t dp_off = s_off + BT * LDS * 4;
  static constexpr size_t p_off = dp_off + BT * LDS * 4;
  static constexpr size_t ds_off = p_off + BT * LDP * 2;
  static constexpr size_t l_off = ds_off + BT * LDP * 2;
  static constexpr size_t dl_off = l_off + BT * 4;
  static constexpr size_t kb_off = dl_off + BT * 4;
  static constexpr size_t f_off = kb_off + BT * 4;
  static constexpr size_t acc1_off = f_off + 32;
  static constexpr size_t acc2_off = acc1_off + BT * LDA * 4;
  static constexpr size_t bytes_dq = acc2_off;
  static constexpr size_t bytes_dkv = acc2_off + BT * LDA * 4;
};

// Stage rows r0 .. r0+63 of one head ([T, HD] with row stride `st`) into
// shared memory with row pitch LDH = HD + 8; rows at or past T are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int r0, int T_len, int tid) {
  constexpr int VEC = 8, VPR = HD / VEC, LDH = HD + 8;
  for (int i = tid; i < BT * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T_len)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// The (q tile at q0, k tile at k0) fine cells, Fs[qa * FPT + kc] (0 past
// T), and, when `kvb_b` is given, the k tile's padding row Kb (0 past T).
__device__ __forceinline__ void load_meta(uint8_t* Fs, float* Kb,
                                          const uint8_t* fine_h, int n16,
                                          int q0, int k0,
                                          const float* kvb_b, int T_len,
                                          int tid) {
  if (tid < FPT * FPT) {
    const int a = q0 / FINE + tid / FPT, c = k0 / FINE + tid % FPT;
    Fs[tid] = (a < n16 && c < n16) ? fine_h[(long long)a * n16 + c] : 0;
  }
  if (kvb_b)
    for (int i = tid; i < BT; i += kThreads)
      Kb[i] = k0 + i < T_len ? kvb_b[k0 + i] : 0.f;
}

// Rows r0 .. r0+63 of one head's lse and delta ([T] fp32 each); 0 past T.
__device__ __forceinline__ void load_rows(float* l_dst, float* d_dst,
                                          const float* lse, const float* delta,
                                          int r0, int T_len, int tid) {
  for (int i = tid; i < BT; i += kThreads) {
    const bool in = r0 + i < T_len;
    l_dst[i] = in ? lse[r0 + i] : 0.f;
    d_dst[i] = in ? delta[r0 + i] : 0.f;
  }
}

// The score of cell (qpos, kpos) from its raw product s = (scaled q) . k,
// in the Pallas kernels' order: + bias, + padding row, then NEG_INF where
// the fine layout (or, causal, the future) masks it. Cells past T belong to
// no tile of the layout: -inf, so p = 0 there exactly.
__device__ __forceinline__ float masked_score(float s, int qpos, int kpos,
                                              int T_len, bool live,
                                              const float* bias_bh, float kb,
                                              bool has_kpm, int causal) {
  if (qpos >= T_len || kpos >= T_len) return -INFINITY;
  if (bias_bh) s += bias_bh[(long long)qpos * T_len + kpos];
  if (has_kpm) s += kb;
  if (!live || (causal && kpos > qpos)) s = kNegInf;
  return s;
}

// Out[strip of 16 rows, 64 cols] (fp32, row stride LDS) = A[strip] B^T over
// HD, with A and B both [64, HD] 16-bit tiles (row pitch LDH).
template <typename T, int HD>
__device__ __forceinline__ void strip_abt(float* out, const T* A, const T* B,
                                          int row0) {
  constexpr int LDH = HD + 8, LDS = BT + 4;
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
    wmma::fill_fragment(sf, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
      wmma::load_matrix_sync(af, A + row0 * LDH + 16 * kk, LDH);
      wmma::load_matrix_sync(bf, B + 16 * j * LDH + 16 * kk, LDH);
      wmma::mma_sync(sf, af, bf, sf);
    }
    wmma::store_matrix_sync(out + row0 * LDS + 16 * j, sf, LDS,
                            wmma::mem_row_major);
  }
}

// Acc[strip, HD] (fp32, row stride LDA) += P[strip, 64] (16-bit, row stride
// BT + 8) . B[64, HD] (16-bit tile): O += P V, dq += ds k, dv += p^T do,
// dk += ds^T q.
template <typename T, int HD, int LDA>
__device__ __forceinline__ void strip_acc(float* acc, const T* P, const T* B,
                                          int row0) {
  constexpr int LDH = HD + 8, LDP = BT + 8;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
    wmma::load_matrix_sync(of, acc + row0 * LDA + 16 * j, LDA,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pf;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(pf, P + row0 * LDP + 16 * kk, LDP);
      wmma::load_matrix_sync(bf, B + 16 * kk * LDH + 16 * j, LDH);
      wmma::mma_sync(of, pf, bf, of);
    }
    wmma::store_matrix_sync(acc + row0 * LDA + 16 * j, of, LDA,
                            wmma::mem_row_major);
  }
}

// Write a warp's strip of an fp32 accumulator (row stride LDA) to rows
// r0 + row0 .. (masked at T) of one head: rounded to T, then (mult != 1)
// scaled in fp32 and rounded again, as JAX scales dq after its kernel.
template <typename T, int HD, int LDA>
__device__ __forceinline__ void store_strip(T* dst, long long st,
                                            const float* acc, float mult,
                                            int r0, int row0, int T_len,
                                            int lane) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    if (r0 + row >= T_len) continue;
    T* out = dst + (long long)(r0 + row) * st;
    for (int d = lane; d < HD; d += 32)
      out[d] = from_f<T>(to_f(from_f<T>(acc[row * LDA + d])) * mult);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  float* __restrict__ dbias, const float* __restrict__ bias,
                  const float* __restrict__ kvb,
                  const int* __restrict__ counts, const int* __restrict__ idx,
                  const uint8_t* __restrict__ fine, int H, int T_len,
                  int maxv, const Strides strides, long long bias_sb,
                  long long bias_sh, int dbias_heads, float scale,
                  int causal) {
  using L = BwdLayout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::a_off);
  T* dOs = reinterpret_cast<T*>(smem + L::b_off);
  T* Ks = reinterpret_cast<T*>(smem + L::c_off);
  T* Vs = reinterpret_cast<T*>(smem + L::d_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* dSs = reinterpret_cast<T*>(smem + L::ds_off);
  float* Ls = reinterpret_cast<float*>(smem + L::l_off);
  float* Dl = reinterpret_cast<float*>(smem + L::dl_off);
  float* Kb = reinterpret_cast<float*>(smem + L::kb_off);
  uint8_t* Fs = smem + L::f_off;
  float* dQa = reinterpret_cast<float*>(smem + L::acc1_off);

  const long long* st = strides.s;
  const int qt = blockIdx.x, q0 = qt * BT, n16 = T_len / FINE;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rows = ((long long)b * H + h) * T_len;
  const T* kb = k + b * st[3] + h * st[4];
  const T* vb = v + b * st[6] + h * st[7];
  const float* bias_bh = bias ? bias + b * bias_sb + h * bias_sh : nullptr;
  const float* kvb_b = kvb ? kvb + (long long)b * T_len : nullptr;
  const uint8_t* fine_h = fine + (long long)h * n16 * n16;
  float* dbias_bh = dbias
      ? dbias + ((long long)b * dbias_heads + (dbias_heads > 1 ? h : 0))
                    * T_len * T_len
      : nullptr;
  const bool atomic = dbias_heads == 1 && H > 1;
  const int row_id = h * gridDim.x + qt;
  const int n_visit = counts[row_id];
  const int* visits = idx + (long long)row_id * maxv;

  load_tile<T, HD>(Qs, q + b * st[0] + h * st[1], st[2], q0, T_len, tid);
  load_tile<T, HD>(dOs, dout + b * st[9] + h * st[10], st[11], q0, T_len, tid);
  load_rows(Ls, Dl, lse + rows, delta + rows, q0, T_len, tid);
  for (int i = tid; i < BT * HD; i += kThreads) dQa[(i / HD) * L::LDA + i % HD] = 0.f;

  const int row0 = 16 * warp;
  for (int t = 0; t < n_visit; ++t) {
    const int k0 = visits[t] * BT;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<T, HD>(Ks, kb, st[5], k0, T_len, tid);
    load_tile<T, HD>(Vs, vb, st[8], k0, T_len, tid);
    load_meta(Fs, Kb, fine_h, n16, q0, k0, kvb_b, T_len, tid);
    __syncthreads();

    strip_abt<T, HD>(Ss, Qs, Ks, row0);    // S  = Q K^T
    strip_abt<T, HD>(dPs, dOs, Vs, row0);  // dP = dO V^T
    __syncwarp();

    // ds = p (dp - delta), p = exp(s - lse); each lane two columns
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r, qpos = q0 + row;
      const uint8_t* frow = Fs + (row / FINE) * FPT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half, kpos = k0 + c;
        const float s = masked_score(Ss[row * L::LDS + c], qpos, kpos, T_len,
                                     frow[c / FINE], bias_bh, Kb[c],
                                     kvb_b != nullptr, causal);
        const float p = expf(s - Ls[row]);
        const float ds = p * (dPs[row * L::LDS + c] - Dl[row]);
        if (dbias_bh && qpos < T_len && kpos < T_len) {
          float* cell = dbias_bh + (long long)qpos * T_len + kpos;
          if (atomic)
            atomicAdd(cell, ds);
          else
            *cell = ds;
        }
        dSs[row * L::LDP + c] = from_f<T>(ds);
      }
    }
    __syncwarp();

    strip_acc<T, HD, L::LDA>(dQa, dSs, Ks, row0);  // dQ += dS K
    __syncwarp();
  }
  store_strip<T, HD, L::LDA>(dq + b * st[12] + h * st[13], st[14], dQa, scale,
                             q0, row0, T_len, lane);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, const float* __restrict__ bias,
                   const float* __restrict__ kvb,
                   const int* __restrict__ countsT,
                   const int* __restrict__ idxT,
                   const uint8_t* __restrict__ fine, int H, int T_len,
                   int maxv, const Strides strides, long long bias_sb,
                   long long bias_sh, int causal) {
  using L = BwdLayout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::a_off);
  T* Vs = reinterpret_cast<T*>(smem + L::b_off);
  T* Qs = reinterpret_cast<T*>(smem + L::c_off);
  T* dOs = reinterpret_cast<T*>(smem + L::d_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);
  T* dSs = reinterpret_cast<T*>(smem + L::ds_off);
  float* Ls = reinterpret_cast<float*>(smem + L::l_off);
  float* Dl = reinterpret_cast<float*>(smem + L::dl_off);
  float* Kb = reinterpret_cast<float*>(smem + L::kb_off);
  uint8_t* Fs = smem + L::f_off;
  float* dKa = reinterpret_cast<float*>(smem + L::acc1_off);
  float* dVa = reinterpret_cast<float*>(smem + L::acc2_off);

  const long long* st = strides.s;
  const int kt = blockIdx.x, k0 = kt * BT, n16 = T_len / FINE;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rows = ((long long)b * H + h) * T_len;
  const T* qb = q + b * st[0] + h * st[1];
  const T* db = dout + b * st[9] + h * st[10];
  const float* bias_bh = bias ? bias + b * bias_sb + h * bias_sh : nullptr;
  const float* kvb_b = kvb ? kvb + (long long)b * T_len : nullptr;
  const uint8_t* fine_h = fine + (long long)h * n16 * n16;
  const int col_id = h * gridDim.x + kt;
  const int n_visit = countsT[col_id];
  const int* visits = idxT + (long long)col_id * maxv;

  load_tile<T, HD>(Ks, k + b * st[3] + h * st[4], st[5], k0, T_len, tid);
  load_tile<T, HD>(Vs, v + b * st[6] + h * st[7], st[8], k0, T_len, tid);
  if (kvb_b)
    for (int i = tid; i < BT; i += kThreads)
      Kb[i] = k0 + i < T_len ? kvb_b[k0 + i] : 0.f;
  for (int i = tid; i < BT * HD; i += kThreads) {
    dKa[(i / HD) * L::LDA + i % HD] = 0.f;
    dVa[(i / HD) * L::LDA + i % HD] = 0.f;
  }

  const int row0 = 16 * warp;
  for (int t = 0; t < n_visit; ++t) {
    const int q0 = visits[t] * BT;
    __syncthreads();  // the previous tile's Q/dO reads are done
    load_tile<T, HD>(Qs, qb, st[2], q0, T_len, tid);
    load_tile<T, HD>(dOs, db, st[11], q0, T_len, tid);
    load_rows(Ls, Dl, lse + rows, delta + rows, q0, T_len, tid);
    load_meta(Fs, Kb, fine_h, n16, q0, k0, nullptr, T_len, tid);
    __syncthreads();

    strip_abt<T, HD>(Ss, Ks, Qs, row0);    // S^T  = K Q^T
    strip_abt<T, HD>(dPs, Vs, dOs, row0);  // dP^T = V dO^T
    __syncwarp();

    // rows are keys, columns queries
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r, kpos = k0 + row;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half, qpos = q0 + c;
        const float s = masked_score(Ss[row * L::LDS + c], qpos, kpos, T_len,
                                     Fs[(c / FINE) * FPT + row / FINE],
                                     bias_bh, Kb[row], kvb_b != nullptr,
                                     causal);
        const float p = expf(s - Ls[c]);
        Ps[row * L::LDP + c] = from_f<T>(p);
        dSs[row * L::LDP + c] = from_f<T>(p * (dPs[row * L::LDS + c] - Dl[c]));
      }
    }
    __syncwarp();

    strip_acc<T, HD, L::LDA>(dVa, Ps, dOs, row0);  // dV += P^T dO
    strip_acc<T, HD, L::LDA>(dKa, dSs, Qs, row0);  // dK += dS^T Q
    __syncwarp();
  }
  store_strip<T, HD, L::LDA>(dk + b * st[12] + h * st[13], st[14], dKa, 1.f,
                             k0, row0, T_len, lane);
  store_strip<T, HD, L::LDA>(dv + b * st[15] + h * st[16], st[17], dVa, 1.f,
                             k0, row0, T_len, lane);
}

Strides copy_strides(const long long* strides) {
  Strides st;
  for (int i = 0; i < 18; ++i) st.s[i] = strides[i];
  return st;
}

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
  using namespace dstt::attn;
  FwdParams p{};
  int rc = encode_heads<T>(&p.tq, q, B, H, T_len, HD,
                           st[0], st[1], st[2]);
  if (!rc) rc = encode_heads<T>(&p.tk, k, B, H, T_len, HD,
                                st[3], st[4], st[5]);
  if (!rc) rc = encode_heads<T>(&p.tv, v, B, H, T_len, HD,
                                st[6], st[7], st[8]);
  if (!rc) rc = encode_heads<T>(&p.to, o, B, H, T_len, HD,
                                st[9], st[10], st[11]);
  if (!rc && bias)
    rc = encode_bias(&p.tbias, bias, bias_sb ? B : 1, bias_sh ? H : 1, T_len);
  if (!rc && kvb) rc = encode_rows(&p.tkvb, kvb, B, T_len);
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
  return launch<true, T, HD, 2>(p, stream);
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, float* dbias,
              const float* bias, const float* kvb, const int* counts,
              const int* idx, const uint8_t* fine, int B, int H, int T_len,
              int maxv, const Strides& st, long long bias_sb,
              long long bias_sh, int dbias_heads, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = BwdLayout<HD>::bytes_dq;
  cudaFuncSetAttribute(bsa_bwd_dq_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((T_len + BT - 1) / BT, B * H);
  bsa_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), dbias, bias, kvb, counts, idx, fine, H, T_len,
      maxv, st, bias_sb, bias_sh, dbias_heads, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               const float* bias, const float* kvb, const int* countsT,
               const int* idxT, const uint8_t* fine, int B, int H, int T_len,
               int maxv, const Strides& st, long long bias_sb,
               long long bias_sh, int causal, cudaStream_t stream) {
  const size_t smem = BwdLayout<HD>::bytes_dkv;
  cudaFuncSetAttribute(bsa_bwd_dkv_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((T_len + BT - 1) / BT, B * H);
  bsa_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), bias, kvb, countsT, idxT,
      fine, H, T_len, maxv, st, bias_sb, bias_sh, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q / k / v / o / do / dq / dk / dv: [B, *, H, D] tensors in any layout whose
// last dim is contiguous; `strides` (host memory, 18 entries) holds their
// (batch, head, time) element strides: q, k, v, then o (forward), do, dq
// (dq pass) or do, dk, dv (dk/dv pass). lse and delta [B, H, T] fp32
// contiguous. bias: fp32, row-major [T, T] slabs at element offset
// b * bias_sb + h * bias_sh, or null; kvb: [B, T] fp32 additive padding row,
// or null. counts [H, T/64 rounded up] and idx [H, ..., maxv] int32 visit
// lists (transposed for dk/dv), fine uint8 [H, T/16, T/16]. dbias: null, or
// [B, dbias_heads, T, T] fp32 zeroed by the caller. dtype: 1 bfloat16,
// 2 float16; D 64 or 128. Each returns cudaGetLastError().
extern "C" int dstt_bsa_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, const float* bias,
                            const float* kvb, const int* counts,
                            const int* idx, const uint8_t* fine,
                            const int* order, int B, int H, int T_len, int D,
                            int maxv, const long long* strides,
                            long long bias_sb, long long bias_sh, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(T, HD) launch_fwd<T, HD>(q, k, v, o, lse, bias, kvb, counts, idx, \
                                     fine, order, B, H, T_len, maxv, strides, \
                                     bias_sb, bias_sh, causal, s)
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
                               const uint8_t* fine, int B, int H, int T_len,
                               int D, int maxv, const long long* strides,
                               long long bias_sb, long long bias_sh,
                               int dbias_heads, float scale, int causal,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = copy_strides(strides);
#define DQ(T, HD) launch_dq<T, HD>(q, k, v, dout, lse, delta, dq, dbias, bias, \
                                   kvb, counts, idx, fine, B, H, T_len, maxv, \
                                   st, bias_sb, bias_sh, dbias_heads, scale,  \
                                   causal, s)
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
                                const uint8_t* fine, int B, int H, int T_len,
                                int D, int maxv, const long long* strides,
                                long long bias_sb, long long bias_sh,
                                int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = copy_strides(strides);
#define DKV(T, HD) launch_dkv<T, HD>(q, k, v, dout, lse, delta, dk, dv, bias, \
                                     kvb, countsT, idxT, fine, B, H, T_len,  \
                                     maxv, st, bias_sb, bias_sh, causal, s)
  if (dtype == 1 && D == 64) return DKV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return DKV(__nv_bfloat16, 128);
  if (dtype == 2 && D == 64) return DKV(__half, 64);
  if (dtype == 2 && D == 128) return DKV(__half, 128);
#undef DKV
  return (int)cudaErrorInvalidValue;
}
