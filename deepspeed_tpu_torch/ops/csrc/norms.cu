// norms.cu — row LayerNorm and RMSNorm with an optional residual add, for
// Hopper.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/norms.py:
//   * fused_layer_norm (:43, pallas_call :54, kernel _ln_kernel :21);
//   * fused_rms_norm   (:69, pallas_call :79, kernel _rms_kernel :30).
//
// Layout: x, residual, out [rows, D] contiguous in one dtype (code 0 =
// float32, 1 = bfloat16, 2 = float16); scale, bias f32 [D] (the wrapper
// widens them). Numerics, in the order of the plain versions in
// ops/norms.py (the build has no --use_fast_math, and every product and sum
// is rounded on its own, as PyTorch's separate ops round them):
//   s    = x + residual, rounded to x's dtype   (JAX adds before the call)
//   mean = fp32(sum(s) * (1/D))                 the sum in fp64
//   var  = fp32(sum((s - mean)^2) * (1/D))      fp64 sum of fp32 squares,
//                                               second pass
//   y    = (s - mean) * (1 / sqrtf(var + eps)) * scale + bias
//   RMS:  y = s * (1 / sqrtf(fp32(sum(s^2) * (1/D)) + eps)) * scale
//   out  = y rounded once to x's dtype
// The row sums accumulate in fp64 and each statistic is rounded to fp32
// once, so it is the correctly rounded fp32 value whatever the order of
// the sum; sqrt and the division are IEEE. The kernel and its plain version
// therefore agree bit for bit. (Summed in fp32, two summation orders put
// the statistics ~1e-7 apart, and an fp32 output a few steps apart.)
//
// What bounds it on the H100: memory — a row is read once and written once
// with a few operations per element (at [4096, 768] bf16, 12.6 MB, 3.8 us
// at 3.35 TB/s). So the design touches device memory once each way: one
// warp per row, 16-byte loads (8 bf16/fp16 or 4 fp32 per lane, neighbouring
// lanes on neighbouring addresses), the row kept in registers as NV
// 16-byte vectors per lane between the passes (NV = 4, 16, 32 or, for
// fp32, 64: the smallest that covers the row; D <= 8192, beyond which the
// wrapper raises), warp-shuffle sums, four rows per 128-thread block. The
// fp64 adds (two an element) stay far below the memory time.
// Known limit: at NV = 64 (fp32 rows above 4096) the cache spills to local
// memory, which stays in L1/L2.

#include "common.cuh"

namespace {

using namespace dstt;

constexpr int kWarpsPerBlock = 4;

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) f[j] = to_f(e[j]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) e[j] = from_f<T>(f[j]);
  return raw;
}

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int NV>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
            const float* __restrict__ scale, const float* __restrict__ bias,
            T* __restrict__ out, long long rows, int D, float eps, int rms) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = D / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  const uint4* rr = res ? reinterpret_cast<const uint4*>(res + row * D)
                        : nullptr;
  uint4 cache[NV];
  float f[VEC], g[VEC];
  const double inv_d = 1.0 / (double)D;

  // pass 1: load (+ residual, rounded to T), the row sum (or sum of squares)
  double acc = 0.0;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * 32 + lane;
    if (c < nvec) {
      cache[v] = xr[c];
      if (rr) {
        unpack<T>(cache[v], f);
        unpack<T>(rr[c], g);
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = __fadd_rn(f[j], g[j]);
        cache[v] = pack<T>(f);
      }
      unpack<T>(cache[v], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc += rms ? (double)__fmul_rn(f[j], f[j]) : (double)f[j];
    }
  }
  const float stat = (float)(warp_sum_f64(acc) * inv_d);

  float mean = 0.f, rstd;
  if (rms) {
    rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(stat, eps)));
  } else {
    mean = stat;
    // pass 2 (registers): the centred sum of squares
    double sq = 0.0;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (v * 32 + lane < nvec) {
        unpack<T>(cache[v], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = __fsub_rn(f[j], mean);
          sq += (double)__fmul_rn(d, d);
        }
      }
    }
    const float var = (float)(warp_sum_f64(sq) * inv_d);
    rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  }

  // pass 3: normalise, scale (+ bias), one rounding to T, one store
  uint4* outr = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c = v * 32 + lane;
    if (c < nvec) {
      unpack<T>(cache[v], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int col = c * VEC + j;
        const float y = __fmul_rn(rms ? f[j] : __fsub_rn(f[j], mean), rstd);
        const float ys = __fmul_rn(y, scale[col]);
        f[j] = rms ? ys : __fadd_rn(ys, bias[col]);
      }
      outr[c] = pack<T>(f);
    }
  }
}

template <typename T, int NV>
int launch(const void* x, const void* res, const float* scale,
           const float* bias, void* out, long long rows, int D, float eps,
           int rms, cudaStream_t stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  norm_kernel<T, NV><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), scale, bias,
      static_cast<T*>(out), rows, D, eps, rms);
  return (int)cudaGetLastError();
}

template <typename T>
int norm_t(const void* x, const void* res, const float* scale,
           const float* bias, void* out, long long rows, int D, float eps,
           int rms, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (D < VEC || D % VEC || D > 8192 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const int per_lane = (D / VEC + 31) / 32;
  if (per_lane <= 4) return launch<T, 4>(x, res, scale, bias, out, rows, D, eps, rms, st);
  if (per_lane <= 16) return launch<T, 16>(x, res, scale, bias, out, rows, D, eps, rms, st);
  if (per_lane <= 32) return launch<T, 32>(x, res, scale, bias, out, rows, D, eps, rms, st);
  // only fp32 rows above 4096 need 64 vectors a lane
  if constexpr (sizeof(T) == 4)
    return launch<T, 64>(x, res, scale, bias, out, rows, D, eps, rms, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [rows, D] (dtype code as above), res [rows, D] or NULL, scale f32 [D],
// bias f32 [D] (ignored when rms != 0), out [rows, D] -> out. Pointers
// 16-byte aligned, D a multiple of 16 / sizeof(dtype), 1 <= D <= 8192,
// rows >= 1. Returns cudaGetLastError().
extern "C" int dstt_norm(const void* x, const void* res, const void* scale,
                         const void* bias, void* out, long long rows, int D,
                         float eps, int rms, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0: return norm_t<float>(x, res, s, b, out, rows, D, eps, rms, st);
    case 1: return norm_t<__nv_bfloat16>(x, res, s, b, out, rows, D, eps, rms, st);
    case 2: return norm_t<__half>(x, res, s, b, out, rows, D, eps, rms, st);
  }
  return (int)cudaErrorInvalidValue;
}
