// flash_fwd.cu — flash-attention forward (out and row log-sum-exp), Hopper.
//
// Replaces the Pallas forward of deepspeed_tpu/ops/pallas/flash_attention.py:
// _flash_fwd (:133, kernel _fwd_kernel :50), reached by generate()'s prefill
// through the dispatch program "flash". The backward kernels (:297, :323)
// are not ported yet.
//
// What bounds it on the H100: operations at long T (4 * T^2 * D flops per
// head against 4 * T * D elements moved), memory at short T. The design
// keeps the T x T scores out of device memory and puts both products on the
// tensor cores:
//   * one thread block (4 warps) per (q tile of BQ = 64 rows, b * h); a loop
//     over K/V tiles of BK = 64 rows takes the place of the TPU's
//     sequential grid axis, and stops at the causal frontier, so fully
//     masked tiles are neither loaded nor computed;
//   * each warp owns a 16-row strip of the q tile for both products
//     (S = Q K^T and O += P V, nvcuda::wmma 16x16x16 bf16/fp16 with fp32
//     accumulation) and for the online softmax between them, so only the
//     K/V tile loads need the whole block to synchronise;
//   * the softmax statistics m / l stay in fp32 registers, the running
//     output O in fp32 shared memory; P is narrowed to the input dtype for
//     the P V product, as the Pallas kernel does;
//   * the ragged edge of any T is masked in the kernel (no T % 128 rule):
//     rows past T load as zeros and are never written.
// Tiles are sized for shared memory (~70 KB at hd 64, ~110 KB at hd 128:
// two blocks per SM), not for the TPU's 512 x 512 VMEM blocks.
// Grouped-query attention reads kv head h / G; no K/V repeat is
// materialized. Strides are passed per tensor, so [B, T, H, D] views of a
// fused qkv projection are read in place.
//
// Later work: wgmma/TMA with a producer warp, and q tiles of 128 rows.

#include "common.cuh"

#include <mma.h>

namespace {

using namespace dstt;
using namespace nvcuda;

constexpr int BQ = 64, BK = 64, kWarps = 4, kThreads = 32 * kWarps;

template <int HD>
struct Layout {
  static constexpr int LDH = HD + 8;   // 16-bit Q / K / V rows (elements)
  static constexpr int LDS = BK + 4;   // fp32 score rows
  static constexpr int LDP = BK + 8;   // 16-bit probability rows
  static constexpr int LDO = HD + 4;   // fp32 output rows
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + BQ * LDH * 2;
  static constexpr size_t v_off = k_off + BK * LDH * 2;
  static constexpr size_t s_off = v_off + BK * LDH * 2;
  static constexpr size_t p_off = s_off + BQ * LDS * 4;
  static constexpr size_t o_off = p_off + BQ * LDP * 2;
  static constexpr size_t bytes = o_off + BQ * LDO * 4;
};

// Stage rows r0 .. r0+63 of one head ([T, HD] with row stride `st`) into
// shared memory; rows at or past T are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int r0, int T_len, int tid) {
  constexpr int VEC = 8, VPR = HD / VEC, LDH = Layout<HD>::LDH;
  for (int i = tid; i < 64 * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T_len)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int G, int T_len,
                 long long q_sb, long long q_sh, long long q_st,
                 long long k_sb, long long k_sh, long long k_st,
                 long long v_sb, long long v_sh, long long v_st,
                 long long o_sb, long long o_sh, long long o_st,
                 float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  load_tile<T, HD>(Qs, q + b * q_sb + h * q_sh, q_st, q0, T_len, tid);
  for (int i = tid; i < BQ * HD; i += kThreads) Os[(i / HD) * L::LDO + i % HD] = 0.f;
  float m_r[16], l_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
  }

  int kt_end = (T_len + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int row0 = 16 * warp;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<T, HD>(Ks, kb, k_st, k0, T_len, tid);
    load_tile<T, HD>(Vs, vb, v_st, k0, T_len, tid);
    __syncthreads();

    // S[strip] = Q[strip] K^T
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
        wmma::load_matrix_sync(af, Qs + row0 * L::LDH + 16 * kk, L::LDH);
        wmma::load_matrix_sync(bf, Ks + 16 * j * L::LDH + 16 * kk, L::LDH);
        wmma::mma_sync(sf, af, bf, sf);
      }
      wmma::store_matrix_sync(Ss + row0 * L::LDS + 16 * j, sf, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the strip's 16 rows; each lane holds two columns
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r, qpos = q0 + row;
      const int c0 = k0 + lane, c1 = c0 + 32;
      float s0 = Ss[row * L::LDS + lane] * scale;
      float s1 = Ss[row * L::LDS + lane + 32] * scale;
      if (c0 >= T_len || (causal && c0 > qpos)) s0 = -INFINITY;
      if (c1 >= T_len || (causal && c1 > qpos)) s1 = -INFINITY;
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(s0, s1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // all masked
      const float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);
      const float alpha = expf(m_r[r] - m_use);
      l_r[r] = l_r[r] * alpha + warp_sum(p0 + p1);
      m_r[r] = m_new;
      Ps[row * L::LDP + lane] = from_f<T>(p0);
      Ps[row * L::LDP + lane + 32] = from_f<T>(p1);
      for (int d = lane; d < HD; d += 32) Os[row * L::LDO + d] *= alpha;
    }
    __syncwarp();

    // O[strip] += P[strip] V
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Os + row0 * L::LDO + 16 * j, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + row0 * L::LDP + 16 * kk, L::LDP);
        wmma::load_matrix_sync(vf, Vs + 16 * kk * L::LDH + 16 * j, L::LDH);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Os + row0 * L::LDO + 16 * j, of, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r, qpos = q0 + row;
    if (qpos >= T_len) continue;
    const float l = fmaxf(l_r[r], 1e-30f);
    T* orow = o + b * o_sb + h * o_sh + (long long)qpos * o_st;
    for (int d = lane; d < HD; d += 32) orow[d] = from_f<T>(Os[row * L::LDO + d] / l);
    if (lane == 0) lse[((long long)b * H + h) * T_len + qpos] = m_r[r] + logf(l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int G, int T_len, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes;
  cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((T_len + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, G, T_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int D, const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int H, int G, int T_len, const long long* st,
              float scale, int causal, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, lse, B, H, G, T_len, st, scale, causal, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, lse, B, H, G, T_len, st, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q / o [B, *, H, D] and k / v [B, *, Hkv, D] in any layout whose last dim is
// contiguous: `strides` holds (batch, head, time) element strides for q, k,
// v, o in that order. lse [B, H, T] fp32. dtype: 1 bfloat16, 2 float16.
// Returns cudaGetLastError().
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int Hkv,
                              int T_len, int D, const long long* strides,
                              float scale, int causal, int dtype,
                              void* stream) {
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(D, q, k, v, o, lse, B, H, G, T_len,
                                    strides, scale, causal, s);
  if (dtype == 2)
    return launch_hd<__half>(D, q, k, v, o, lse, B, H, G, T_len, strides,
                             scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
