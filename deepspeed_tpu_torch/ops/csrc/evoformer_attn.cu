// evoformer_attn.cu — Evoformer attention forward (two additive biases), Hopper.
//
// Replaces the Pallas forward of deepspeed_tpu/ops/pallas/evoformer_attn.py:
// _evo_fwd_pallas (pallas_call :98, kernel _evo_fwd_kernel :37), behind
// the public op evoformer_attention (ops/evoformer_attn.py): attention over
// q/k/v [B, N, S, H, D] with a key-mask bias [B, N, 1, 1, S] and a pair
// bias [B, 1, H, S, S], the [B, N, H, S, S] logits never materialized.
//
// Numerics: fp32 throughout, as the Pallas kernel computes q.k^T, p and p.V
// all in fp32 (:43-59): q is widened and scaled in fp32 (never narrowed),
// and both products are fp32 FMAs on the CUDA cores. No tensor-core path:
// bf16 would narrow P, and TF32 keeps ~10 mantissa bits. The output is
// rounded once, to q's dtype. Softmax statistics start at -1e30, as there;
// keys past S get -inf (p = 0).
//
// What bounds it on the H100: operations at the AlphaFold shapes (S 256,
// D 32: 4 * S * D flops per query against ~8 * D bytes) on the fp32 units
// (67 Tflop/s), not the tensor cores. The design:
//   * one block (128 threads) per (64-query tile, b * n * h); the loop over
//     64-key tiles takes the place of the TPU's fori_loop, with K and V
//     staged in shared memory as fp32;
//   * an 8 x 16 thread grid: thread (ty, tx) computes the 8 x 4 scores of
//     rows 8 ty .. 8 ty + 7 and columns tx + 16 j, so each shared-memory
//     read of q feeds 4 FMAs and each read of k feeds 8;
//   * the online softmax reduces a row across the 16 threads that share it
//     (shuffles within half a warp), P goes to shared memory, and the same
//     thread grid accumulates O [8 rows, D / 16 columns] in registers;
//   * the mask and pair biases are read from device memory by index, with
//     batch / row / head strides that are 0 where they broadcast;
//   * q / k / v / o are read and written in place in the op's [B, N, S, H,
//     D] layout through element strides: no transposes.
// Shared memory: (2 * (D + 1) + D + 65) * 64 * 4 bytes (41 KB at D 32,
// 115 KB at D 128). Later work: a bf16x3 tensor-core split of both products.

#include "common.cuh"

namespace {

using namespace dstt;

constexpr int BQ = 64, BK = 64, kThreads = 128;
constexpr float kNegInf = -1e30f;

// (batch, row, seq, head) element strides of q, k, v, o.
struct Strides {
  long long s[16];
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long s_st, int r0, int S,
                                          float mult, int tid) {
  for (int i = tid; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < S ? to_f(src[(long long)(r0 + r) * s_st + c]) * mult : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
evo_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               const float* __restrict__ mask, const float* __restrict__ pair,
               int N, int S, int H, const Strides strides, long long mask_sb,
               long long mask_sn, long long pair_sb, long long pair_sh,
               float scale) {
  constexpr int LD = D + 1, LDP = BK + 1, DJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [64][D + 1], scaled
  float* Ks = Qs + BQ * LD;         // [64][D + 1]
  float* Vs = Ks + BK * LD;         // [64][D]
  float* Ps = Vs + BK * D;          // [64][65]

  const long long* st = strides.s;
  const int bnh = blockIdx.y, h = bnh % H, n = (bnh / H) % N, b = bnh / (H * N);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + b * st[0] + n * st[1] + h * st[3];
  const T* kb = k + b * st[4] + n * st[5] + h * st[7];
  const T* vb = v + b * st[8] + n * st[9] + h * st[11];
  const float* mask_bn = mask ? mask + b * mask_sb + n * mask_sn : nullptr;
  const float* pair_bh = pair ? pair + b * pair_sb + h * pair_sh : nullptr;

  load_tile<T, D>(Qs, qb, st[2], q0, S, scale, tid);
  float o_acc[8][DJ], m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o_acc[i][j] = 0.f;
  }

  const int n_kt = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K / V / P reads are done
    load_tile<T, D>(Ks, kb, st[6], k0, S, 1.f, tid);
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      Vs[r * D + c] = k0 + r < S ? to_f(vb[(long long)(k0 + r) * st[10] + c]) : 0.f;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = Qs[(8 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 8 * ty + i, qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = -INFINITY;
        if (qpos < S && kpos < S) {
          x = s[i][j];
          if (mask_bn) x += mask_bn[kpos];
          if (pair_bh) x += pair_bh[(long long)qpos * S + kpos];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[row * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_r[i] = l_r[i] * alpha + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) o_acc[i][j] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by one half warp

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = Ps[(8 * ty + i) * LDP + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) o_acc[i][j] = fmaf(p, vv[j], o_acc[i][j]);
      }
    }
  }

  T* ob = o + b * st[12] + n * st[13] + h * st[15];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + 8 * ty + i;
    if (qpos >= S) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long long)qpos * st[14] + tx + 16 * j] = from_f<T>(o_acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const float* mask, const float* pair, int B, int N, int S, int H,
           const Strides& st, long long mask_sb, long long mask_sn,
           long long pair_sb, long long pair_sh, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BQ * (D + 1) + BK * D + BQ * (BK + 1)) * 4;
  cudaFuncSetAttribute(evo_fwd_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((S + BQ - 1) / BQ, B * N * H);
  evo_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), mask, pair, N, S, H, st,
      mask_sb, mask_sn, pair_sb, pair_sh, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             const float* mask, const float* pair, int B, int N, int S, int H,
             const Strides& st, long long mask_sb, long long mask_sn,
             long long pair_sb, long long pair_sh, float scale,
             cudaStream_t s) {
#define EVO(HD) launch<T, HD>(q, k, v, o, mask, pair, B, N, S, H, st, mask_sb, \
                              mask_sn, pair_sb, pair_sh, scale, s)
  if (D == 32) return EVO(32);
  if (D == 64) return EVO(64);
  if (D == 128) return EVO(128);
#undef EVO
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q / k / v / o [B, N, S, H, D] in any layout whose last dim is contiguous:
// `strides` (host memory) holds 16 element strides, (batch, row, seq, head)
// for q, k, v, o in that order. mask: fp32 [S] rows at element offset
// b * mask_sb + n * mask_sn, or null; pair: fp32 row-major [S, S] slabs at
// b * pair_sb + h * pair_sh, or null (a stride is 0 where the bias
// broadcasts). dtype: 0 float32, 1 bfloat16, 2 float16; D 32, 64 or 128.
// Returns cudaGetLastError().
extern "C" int dstt_evoformer_fwd(const void* q, const void* k, const void* v,
                                  void* o, const float* mask,
                                  const float* pair, int B, int N, int S,
                                  int H, int D, const long long* strides,
                                  long long mask_sb, long long mask_sn,
                                  long long pair_sb, long long pair_sh,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st;
  for (int i = 0; i < 16; ++i) st.s[i] = strides[i];
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, mask, pair, B, N, S, H, st, mask_sb,
                           mask_sn, pair_sb, pair_sh, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, mask, pair, B, N, S, H, st,
                                   mask_sb, mask_sn, pair_sb, pair_sh, scale,
                                   s);
  if (dtype == 2)
    return launch_d<__half>(D, q, k, v, o, mask, pair, B, N, S, H, st,
                            mask_sb, mask_sn, pair_sb, pair_sh, scale, s);
  return (int)cudaErrorInvalidValue;
}
