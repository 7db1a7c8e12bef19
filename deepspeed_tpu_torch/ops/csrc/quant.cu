// quant.cu — groupwise symmetric int8 / packed int4 quantize and dequantize,
// for Hopper.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/quant.py:
//   * quantize_int8 (:53, kernel _quant_kernel :25) and dequantize_int8
//     (:170, kernel _dequant_kernel :37);
//   * quantize_int4 (:111, kernel _quant4_kernel :81) and dequantize_int4
//     (:145, kernel _dequant4_kernel :98).
// One source; the bit width is a template parameter (qmax 127 or 7).
//
// Layout: x [rows, D] contiguous; q int8 [rows, D] (int8) or [rows, D/2]
// (int4, two values a byte); scales f32 [rows, D/g], one per group of g
// consecutive elements of a row.
//
// Numerics, bit-exact with the plain versions in ops/quant.py (the build
// has no --use_fast_math, so `/` is IEEE division):
//   scale = fmaxf(amax, 1e-8f) / qmax      never a multiply by 1/qmax
//   q     = clamp(rintf(x / scale), -qmax, qmax)
//           (rintf rounds half to even, as torch.round and jnp.round do)
//   int4: biased nibbles q + 8 in [1, 15], lo nibble = even index; the
//         packed byte is read back as uint8 before the >> 4, since a signed
//         shift would drag the sign bit in
//   dequant: float(q) * scale in fp32, narrowed once to the output dtype
//
// What bounds it on the H100: memory. Each element is read once and written
// once with a handful of operations, far below the card's ridge point. So
// the design makes one pass over the data, reading each row twice (the
// second read hits L1/L2) and no intermediate in device memory:
//   quantize   one 128-thread block per row; pass 1 gives each group to a
//              warp, whose lanes stride the group and reduce |max| with a
//              shuffle; the scales go to shared memory and to the output;
//              pass 2 quantizes the row (or packs its byte pairs) with
//              neighbouring threads on neighbouring elements;
//   dequantize a 2-D grid (column tiles x rows), one element (or one packed
//              byte) per thread, scales loaded as scalars: a row of D/g
//              floats need not be 16-byte aligned (D/g = 1 when g = D).
// Known limit: a row is one block, so a row of D = 64 (the K/V pool write)
// leaves most of a block's threads idle; several rows per block is the
// later fix.

#include "common.cuh"

namespace {

using namespace dstt;

constexpr int kThreads = 128;

template <int BITS>
__device__ __forceinline__ int quant1(float x, float scale) {
  constexpr float QMAX = BITS == 8 ? 127.f : 7.f;
  const float r = rintf(x / scale);
  return (int)fminf(fmaxf(r, -QMAX), QMAX);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, int D, int g) {
  constexpr float QMAX = BITS == 8 ? 127.f : 7.f;
  extern __shared__ float ss[];  // [D / g] this row's scales
  const long long row = blockIdx.x;
  const int ng = D / g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + row * D;

  for (int gi = warp; gi < ng; gi += kThreads / 32) {
    float m = 0.f;
    for (int j = lane; j < g; j += 32) m = fmaxf(m, fabsf(to_f(xr[gi * g + j])));
    m = warp_max(m);
    if (lane == 0) {
      const float scale = fmaxf(m, 1e-8f) / QMAX;
      ss[gi] = scale;
      s[row * ng + gi] = scale;
    }
  }
  __syncthreads();

  if (BITS == 8) {
    int8_t* qr = q + row * D;
    for (int j = threadIdx.x; j < D; j += kThreads)
      qr[j] = (int8_t)quant1<8>(to_f(xr[j]), ss[j / g]);
  } else {
    int8_t* qr = q + row * (D / 2);
    for (int j = threadIdx.x; j < D / 2; j += kThreads) {
      const int e = 2 * j;  // a byte's two elements may lie in two groups
      const unsigned lo = quant1<4>(to_f(xr[e]), ss[e / g]) + 8;
      const unsigned hi = quant1<4>(to_f(xr[e + 1]), ss[(e + 1) / g]) + 8;
      qr[j] = (int8_t)(uint8_t)(lo | (hi << 4));
    }
  }
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  T* __restrict__ out, long long rows, int D, int g) {
  const int ng = D / g;
  const int j = blockIdx.x * kThreads + threadIdx.x;  // element or byte
  const int width = BITS == 8 ? D : D / 2;
  if (j >= width) return;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* sr = s + row * ng;
    if (BITS == 8) {
      out[row * D + j] = from_f<T>((float)q[row * D + j] * sr[j / g]);
    } else {
      const unsigned b = (uint8_t)q[row * width + j];
      const int e = 2 * j;
      out[row * D + e] = from_f<T>((float)((int)(b & 0xF) - 8) * sr[e / g]);
      out[row * D + e + 1] =
          from_f<T>((float)((int)(b >> 4) - 8) * sr[(e + 1) / g]);
    }
  }
}

template <typename T>
int quantize_t(const void* x, void* q, void* s, long long rows, int D, int g,
               int bits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (D / g);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = bits == 8 ? quantize_kernel<T, 8> : quantize_kernel<T, 4>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kernel<<<(unsigned)rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), D, g);
  return (int)cudaGetLastError();
}

template <typename T>
int dequantize_t(const void* q, const void* s, void* out, long long rows,
                 int D, int g, int bits, cudaStream_t stream) {
  const int width = bits == 8 ? D : D / 2;
  const dim3 grid((width + kThreads - 1) / kThreads,
                  (unsigned)(rows < 65535 ? rows : 65535));
  auto kernel = bits == 8 ? dequantize_kernel<T, 8> : dequantize_kernel<T, 4>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<T*>(out), rows, D, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, D] (dtype: 0 float32, 1 bfloat16, 2 float16) -> q int8 [rows, D]
// (bits 8) or [rows, D/2] (bits 4), scales f32 [rows, D/g]. The caller
// guarantees rows >= 1, D % g == 0 and, for bits 4, D even. Returns
// cudaGetLastError().
extern "C" int dstt_quantize(const void* x, void* q, void* s, long long rows,
                             int D, int g, int bits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return quantize_t<float>(x, q, s, rows, D, g, bits, st);
    case 1: return quantize_t<__nv_bfloat16>(x, q, s, rows, D, g, bits, st);
    case 2: return quantize_t<__half>(x, q, s, rows, D, g, bits, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The inverse: q and scales as above -> out [rows, D] in `dtype`.
extern "C" int dstt_dequantize(const void* q, const void* s, void* out,
                               long long rows, int D, int g, int bits,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return dequantize_t<float>(q, s, out, rows, D, g, bits, st);
    case 1: return dequantize_t<__nv_bfloat16>(q, s, out, rows, D, g, bits, st);
    case 2: return dequantize_t<__half>(q, s, out, rows, D, g, bits, st);
  }
  return (int)cudaErrorInvalidValue;
}
