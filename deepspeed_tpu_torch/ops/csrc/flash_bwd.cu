// flash_bwd.cu — flash-attention backward (dq, and dk / dv), Hopper.
//
// Replaces the two Pallas backward kernels of
// deepspeed_tpu/ops/pallas/flash_attention.py, both driven by _flash_bwd:
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
// about 4 * T * D elements moved per head and pass). The design keeps the
// T x T probabilities out of device memory and puts all four products of a
// tile on the tensor cores (nvcuda::wmma 16x16x16, bf16/fp16 in, fp32
// accumulation), as flash_fwd.cu does for the forward:
//   * Two passes, no atomics. The TPU carries dq (or dk/dv) in VMEM scratch
//     across a sequential grid axis; here a loop inside one thread block
//     takes that axis' place:
//       - dq: one block (4 warps) per (q tile of 64 rows, b * h) walks the
//         K/V tiles and stops at the causal frontier;
//       - dk/dv: one block per (k tile of 64 rows, b * kv head) walks the q
//         tiles from the first one that reaches its k tile, for each of the
//         G query heads of its kv head in turn, so grouped-query attention
//         sums dk/dv over the group in the block's fp32 accumulators and
//         writes [B, T, Hkv, D] directly.
//   * Each warp owns a 16-row strip of the block's tile for every product
//     and for the elementwise softmax backward between them, so only the
//     tile loads synchronise the whole block.
//   * Rounding follows the Pallas kernels: p = exp(s - lse) in fp32, p
//     narrowed to the input dtype before dv += p^T do, ds narrowed before
//     dq += ds k and dk += ds^T q, fp32 accumulators, sm_scale applied to
//     dq and dk once at the end.
//   * The ragged edge of any T is masked in the kernel (no T % 128 rule):
//     rows past T load as zeros, their p is 0, and they are never written.
//   * Strides are passed per tensor, so [B, T, H, D] views of the fused qkv
//     projection are read in place, and the gradients are written in the
//     layout the wrapper allocated.
// Shared memory, hd 128: 154 KB (dq) and 187 KB (dk/dv), one block per SM;
// tiles are sized for shared memory, not for the TPU's 512 x 512 VMEM
// blocks. Later work: wgmma/TMA, accumulators in registers, 128-row tiles.

#include "common.cuh"

#include <mma.h>

namespace {

using namespace dstt;
using namespace nvcuda;

constexpr int BT = 64, kWarps = 4, kThreads = 32 * kWarps;  // tile rows

// Element strides (batch, head, time) of q, k, v, do, then dq (dq pass) or
// dk, dv (dk/dv pass), passed to the kernel by value.
struct Strides {
  long long s[18];
};

// Shared-memory layout common to both passes: four 16-bit [64, HD] tiles
// (the block's resident pair and the streamed pair), two fp32 [64, 64]
// score tiles (S and dP), two 16-bit [64, 64] tiles (P and dS), two fp32
// [64, HD] accumulators (dq uses one), and the streamed rows' lse / delta.
template <int HD>
struct Layout {
  static constexpr int LDH = HD + 8;   // 16-bit [64, HD] rows (elements)
  static constexpr int LDS = BT + 4;   // fp32 score rows
  static constexpr int LDP = BT + 8;   // 16-bit probability rows
  static constexpr int LDA = HD + 4;   // fp32 accumulator rows
  static constexpr size_t tile16 = BT * LDH * 2;
  static constexpr size_t a_off = 0;                 // resident tile 1
  static constexpr size_t b_off = a_off + tile16;    // resident tile 2
  static constexpr size_t c_off = b_off + tile16;    // streamed tile 1
  static constexpr size_t d_off = c_off + tile16;    // streamed tile 2
  static constexpr size_t s_off = d_off + tile16;
  static constexpr size_t dp_off = s_off + BT * LDS * 4;
  static constexpr size_t p_off = dp_off + BT * LDS * 4;
  static constexpr size_t ds_off = p_off + BT * LDP * 2;
  static constexpr size_t l_off = ds_off + BT * LDP * 2;
  static constexpr size_t dl_off = l_off + BT * 4;
  static constexpr size_t acc1_off = dl_off + BT * 4;
  static constexpr size_t acc2_off = acc1_off + BT * LDA * 4;
  static constexpr size_t bytes_dq = acc2_off;
  static constexpr size_t bytes_dkv = acc2_off + BT * LDA * 4;
};

// Stage rows r0 .. r0+63 of one head ([T, HD] with row stride `st`) into
// shared memory; rows at or past T are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int r0, int T_len, int tid) {
  constexpr int VEC = 8, VPR = HD / VEC, LDH = Layout<HD>::LDH;
  for (int i = tid; i < BT * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T_len)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
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

// Out[strip of 16 rows, 64 cols] (fp32, row stride LDS) = A[strip] B^T over
// HD, with A and B both [64, HD] 16-bit tiles: the score-shaped products
// S = Q K^T, dP = dO V^T (dq pass) and S^T = K Q^T, dP^T = V dO^T (dk/dv).
template <typename T, int HD>
__device__ __forceinline__ void strip_abt(float* out, const T* A, const T* B,
                                          int row0) {
  using L = Layout<HD>;
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
    wmma::fill_fragment(sf, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
      wmma::load_matrix_sync(af, A + row0 * L::LDH + 16 * kk, L::LDH);
      wmma::load_matrix_sync(bf, B + 16 * j * L::LDH + 16 * kk, L::LDH);
      wmma::mma_sync(sf, af, bf, sf);
    }
    wmma::store_matrix_sync(out + row0 * L::LDS + 16 * j, sf, L::LDS,
                            wmma::mem_row_major);
  }
}

// Acc[strip, HD] (fp32, row stride LDA) += P[strip, 64] (16-bit, row stride
// LDP) . B[64, HD] (16-bit tile): dq += ds k, dv += p^T do, dk += ds^T q.
template <typename T, int HD>
__device__ __forceinline__ void strip_acc(float* acc, const T* P, const T* B,
                                          int row0) {
  using L = Layout<HD>;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
    wmma::load_matrix_sync(of, acc + row0 * L::LDA + 16 * j, L::LDA,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pf;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(pf, P + row0 * L::LDP + 16 * kk, L::LDP);
      wmma::load_matrix_sync(bf, B + 16 * kk * L::LDH + 16 * j, L::LDH);
      wmma::mma_sync(of, pf, bf, of);
    }
    wmma::store_matrix_sync(acc + row0 * L::LDA + 16 * j, of, L::LDA,
                            wmma::mem_row_major);
  }
}

// Write a warp's strip of an fp32 accumulator, times `mult`, narrowed to T,
// to rows r0 + row0 .. (masked at T) of one head with row stride `st`.
template <typename T, int HD>
__device__ __forceinline__ void store_strip(T* dst, long long st,
                                            const float* acc, float mult,
                                            int r0, int row0, int T_len,
                                            int lane) {
  using L = Layout<HD>;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    if (r0 + row >= T_len) continue;
    T* out = dst + (long long)(r0 + row) * st;
    for (int d = lane; d < HD; d += 32) out[d] = from_f<T>(acc[row * L::LDA + d] * mult);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int G, int T_len, const Strides strides,
                    float scale, int causal) {
  using L = Layout<HD>;
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
  float* dQa = reinterpret_cast<float*>(smem + L::acc1_off);

  const long long* st = strides.s;
  const int q0 = blockIdx.x * BT;
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rows = ((long long)b * H + h) * T_len;
  const T* kb = k + b * st[3] + hk * st[4];
  const T* vb = v + b * st[6] + hk * st[7];

  load_tile<T, HD>(Qs, q + b * st[0] + h * st[1], st[2], q0, T_len, tid);
  load_tile<T, HD>(dOs, dout + b * st[9] + h * st[10], st[11], q0, T_len, tid);
  load_rows(Ls, Dl, lse + rows, delta + rows, q0, T_len, tid);
  for (int i = tid; i < BT * HD; i += kThreads) dQa[(i / HD) * L::LDA + i % HD] = 0.f;

  int kt_end = (T_len + BT - 1) / BT;
  if (causal) kt_end = min(kt_end, (q0 + BT - 1) / BT + 1);
  const int row0 = 16 * warp;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<T, HD>(Ks, kb, st[5], k0, T_len, tid);
    load_tile<T, HD>(Vs, vb, st[8], k0, T_len, tid);
    __syncthreads();

    strip_abt<T, HD>(Ss, Qs, Ks, row0);    // S  = Q K^T
    strip_abt<T, HD>(dPs, dOs, Vs, row0);  // dP = dO V^T
    __syncwarp();

    // ds = p (dp - delta), p = exp(scale s - lse); each lane two columns
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r, qpos = q0 + row;
      const float l = Ls[row], dl = Dl[row];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half, kpos = k0 + c;
        const bool valid = qpos < T_len && kpos < T_len && (!causal || kpos <= qpos);
        const float p = valid ? expf(Ss[row * L::LDS + c] * scale - l) : 0.f;
        dSs[row * L::LDP + c] = from_f<T>(p * (dPs[row * L::LDS + c] - dl));
      }
    }
    __syncwarp();

    strip_acc<T, HD>(dQa, dSs, Ks, row0);  // dQ += dS K
    __syncwarp();
  }
  store_strip<T, HD>(dq + b * st[12] + h * st[13], st[14], dQa, scale, q0,
                     row0, T_len, lane);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int G, int T_len,
                     const Strides strides, float scale, int causal) {
  using L = Layout<HD>;
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
  float* dKa = reinterpret_cast<float*>(smem + L::acc1_off);
  float* dVa = reinterpret_cast<float*>(smem + L::acc2_off);

  const long long* st = strides.s;
  const int k0 = blockIdx.x * BT;
  const int Hkv = H / G;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  load_tile<T, HD>(Ks, k + b * st[3] + hk * st[4], st[5], k0, T_len, tid);
  load_tile<T, HD>(Vs, v + b * st[6] + hk * st[7], st[8], k0, T_len, tid);
  for (int i = tid; i < BT * HD; i += kThreads) {
    dKa[(i / HD) * L::LDA + i % HD] = 0.f;
    dVa[(i / HD) * L::LDA + i % HD] = 0.f;
  }

  // causal: q tiles wholly before this k tile see none of it
  const int qt_begin = causal ? k0 / BT : 0;
  const int qt_end = (T_len + BT - 1) / BT;
  const int row0 = 16 * warp;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long rows = ((long long)b * H + h) * T_len;
    const T* qb = q + b * st[0] + h * st[1];
    const T* db = dout + b * st[9] + h * st[10];
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's Q/dO reads are done
      load_tile<T, HD>(Qs, qb, st[2], q0, T_len, tid);
      load_tile<T, HD>(dOs, db, st[11], q0, T_len, tid);
      load_rows(Ls, Dl, lse + rows, delta + rows, q0, T_len, tid);
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
          const bool valid = qpos < T_len && kpos < T_len && (!causal || kpos <= qpos);
          const float p = valid ? expf(Ss[row * L::LDS + c] * scale - Ls[c]) : 0.f;
          Ps[row * L::LDP + c] = from_f<T>(p);
          dSs[row * L::LDP + c] = from_f<T>(p * (dPs[row * L::LDS + c] - Dl[c]));
        }
      }
      __syncwarp();

      strip_acc<T, HD>(dVa, Ps, dOs, row0);  // dV += P^T dO
      strip_acc<T, HD>(dKa, dSs, Qs, row0);  // dK += dS^T Q
      __syncwarp();
    }
  }
  store_strip<T, HD>(dk + b * st[12] + hk * st[13], st[14], dKa, scale, k0,
                     row0, T_len, lane);
  store_strip<T, HD>(dv + b * st[15] + hk * st[16], st[17], dVa, 1.f, k0,
                     row0, T_len, lane);
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int G, int T_len, const Strides& st, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes_dq;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((T_len + BT - 1) / BT, B * H);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, G, T_len, st, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int G, int T_len, const Strides& st,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes_dkv;
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((T_len + BT - 1) / BT, B * (H / G));
  flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, G, T_len, st, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q / do / dq [B, *, H, D] and k / v / dk / dv [B, *, Hkv, D] in any layout
// whose last dim is contiguous. `strides` (host memory) holds 18 element
// strides, (batch, head, time) for q, k, v, do, then dq (dq pass; the last
// three are unused) or dk, dv (dk/dv pass). lse and delta [B, H, T] fp32 contiguous. dtype: 1 bfloat16,
// 2 float16. Each returns cudaGetLastError().
extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int B, int H,
                                 int Hkv, int T_len, int D,
                                 const long long* strides, float scale,
                                 int causal, int dtype, void* stream) {
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st;
  for (int i = 0; i < 18; ++i) st.s[i] = strides[i];
#define DQ(T, HD) launch_dq<T, HD>(q, k, v, dout, lse, delta, dq, B, H, G, \
                                   T_len, st, scale, causal, s)
  if (dtype == 1 && D == 64) return DQ(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return DQ(__nv_bfloat16, 128);
  if (dtype == 2 && D == 64) return DQ(__half, 64);
  if (dtype == 2 && D == 128) return DQ(__half, 128);
#undef DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int B, int H, int Hkv, int T_len, int D,
                                  const long long* strides, float scale,
                                  int causal, int dtype, void* stream) {
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st;
  for (int i = 0; i < 18; ++i) st.s[i] = strides[i];
#define DKV(T, HD) launch_dkv<T, HD>(q, k, v, dout, lse, delta, dk, dv, B, H, \
                                     G, T_len, st, scale, causal, s)
  if (dtype == 1 && D == 64) return DKV(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return DKV(__nv_bfloat16, 128);
  if (dtype == 2 && D == 64) return DKV(__half, 64);
  if (dtype == 2 && D == 128) return DKV(__half, 128);
#undef DKV
  return (int)cudaErrorInvalidValue;
}
