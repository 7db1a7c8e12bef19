// norms.cu — row LayerNorm and RMSNorm with an optional residual add, for
// Hopper.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/norms.py:
//   * fused_layer_norm (:43, pallas_call :54, kernel _ln_kernel :21);
//   * fused_rms_norm   (:69, pallas_call :79, kernel _rms_kernel :30).
//
// Layout: x [rows, D] contiguous (dtype code 0 = float32, 1 = bfloat16,
// 2 = float16); residual [rows, D] of any of the three, or NULL; out
// [rows, D] in TO, the promoted dtype of x and the residual (x's without
// one; bf16 + fp16 -> fp32, as jnp and torch promote); scale and bias [D]
// in one of the three dtypes, read as they are and widened here; any
// 1 <= D <= kMaxDim. Numerics, in the order of the plain versions in
// ops/norms.py (the build has no --use_fast_math, and every product and
// sum is rounded on its own, as PyTorch's separate ops round them):
//   s    = x + residual in fp32, rounded to TO   (JAX adds before the call)
//   mean = fp32(sum(s) * (1/D))                  the sum in fp64
//   var  = fp32(sum((s - mean)^2) * (1/D))       fp64 sum of fp32 squares,
//                                                second pass
//   y    = (s - mean) * (1 / sqrtf(var + eps)) * scale + bias
//   RMS:  y = s * (1 / sqrtf(fp32(sum(s^2) * (1/D)) + eps)) * scale
//   out  = y rounded once to TO
// The row sums accumulate in fp64 (kParts independent partial sums a
// thread, then a fixed tree) and each statistic is rounded to fp32 once,
// so it is the correctly rounded fp32 value whatever the order of the
// sum; sqrt and the division are IEEE. The kernel and its plain version
// therefore agree bit for bit.
//
// What bounds it on the H100: memory. A row is read once and written once
// with a few operations per element (at [4096, 768] bf16, 12.6 MB, 3.8 us
// at 3.35 TB/s). Two kernels, picked by the row's width:
//   * warp_rows (rows of at most kWarpMaxBytes of TO, 2 KB):
//     one warp per row, several rows per warp (a persistent grid of
//     4-warp blocks), 16-byte loads (neighbouring lanes on neighbouring
//     addresses), the row held in registers between the passes as NV
//     16-byte vectors a lane (NV = 2 or 4: no spill), warp-shuffle sums.
//   * block_rows (wider rows, rows whose width or start is not 16-byte
//     aligned, a residual of another dtype): one block per row, a
//     persistent grid, each block walking its rows through a ring of
//     `slots` (2-4) shared-memory slots filled by 1-D bulk asynchronous
//     copies (sm90.cuh bulk_load) that one thread issues. Each thread
//     reads its 16-byte groups of the row from the slot once, into
//     registers (NVB = 2 groups a thread, 8 past 2048 groups a row; at
//     most kBlockThreads threads), and the slot takes the block's next
//     row as soon as the first sum's barrier has passed, so that row's
//     copy runs under this row's passes 2 and 3. A block sum takes one
//     barrier (two buffers of warp sums in turn). A row that a bulk copy
//     cannot take (16-byte sizes and addresses), or whose slot would not
//     fit twice in shared memory, is read from device memory directly
//     (`slots` 0), by 16-byte vectors where the row allows them and by
//     masked elements where it does not.
// Both read scale and bias in their own dtype, by 8-32-byte loads that L1
// keeps (every block of an SM reads the same [D] vectors). The fp64 adds
// (two an element for LayerNorm) and conversions stay below the memory
// time; kParts partial sums keep their chains short.

#include <type_traits>

#include "sm90.cuh"

namespace dstt {
namespace norms {
namespace {

using namespace dstt::sm90;

constexpr int kWarpThreads = 128;      // warp_rows: 4 rows at a time a block
// widest warp_rows row, NV 4: at 3-4 KB rows block_rows is faster on an
// H100 (PERF.md §5)
constexpr int kWarpMaxBytes = 2048;
constexpr int kParts = 4;              // independent fp64 partial sums
constexpr int kBlockThreads = 1024;    // block_rows' widest block
constexpr int kRingBytes = 32 * 1024;  // the ring a block aims at
constexpr int kMaxSlots = 4;
// the widest row the entry point takes: block_rows holds at most 8
// 16-byte groups a thread in registers, 32768 fp32 elements a row
constexpr int kMaxDim = 32768;

template <typename A, typename B> struct Promote { using T = float; };
template <typename A> struct Promote<A, A> { using T = A; };

// G consecutive elements of T, loaded and stored as one 8-, 16- or
// 32-byte access.
template <typename T, int G>
struct alignas(G * sizeof(T) < 16 ? G * sizeof(T) : 16) Pack {
  T e[G];
};

struct Args {
  const void* x;
  const void* res;
  const void* scale;
  const void* bias;
  void* out;
  long long rows;
  int D;
  float eps;
  int rms;
  int pdtype;       // scale / bias dtype code
  int vec;          // block_rows: every group a whole aligned vector
  int slots;        // block_rows: ring slots (0: direct reads)
  int x_bytes;      // block_rows: D * sizeof(TX), the slot's x part
  int slot_bytes;   // block_rows: x part + residual part
};

template <typename T, int G>
__device__ __forceinline__ void widen(const Pack<T, G>& p, float (&f)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j) f[j] = to_f(p.e[j]);
}

template <typename T, int G>
__device__ __forceinline__ Pack<T, G> narrow_to(const float (&f)[G]) {
  Pack<T, G> p;
#pragma unroll
  for (int j = 0; j < G; ++j) p.e[j] = from_f<T>(f[j]);
  return p;
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// The pack of G elements at p (aligned to the pack). A plain load: the
// `__ldg` overloads of the 16-bit types are inline asm without `volatile`,
// which the compiler may hoist above the bounds check that guards them
// (an out-of-bounds read that faults where a tensor ends a segment).
template <typename T, int G>
__device__ __forceinline__ Pack<T, G> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, G>*>(p);
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double sum_parts(const double (&acc)[kParts]) {
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The sum over a block (blockDim.x a multiple of 32), the same in every
// thread, with one barrier: each warp's sum goes to `red` (32 doubles),
// and every warp adds them up in the same tree. Consecutive calls take
// turns between two `red` buffers: a call's barrier is what keeps the one
// before it from being overwritten while it is read.
__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum_f64(v);
  if (blockDim.x == 32) return v;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum_f64(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0);
}

__device__ __forceinline__ float inv_std(float var, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// f(TP{}) for the scale / bias dtype code: pass 3 compiled once per type.
template <typename F>
__device__ __forceinline__ void by_param_type(int code, F&& f) {
  switch (code) {
    case 0: f(float{}); break;
    case 1: f(__nv_bfloat16{}); break;
    default: f(__half{}); break;
  }
}

// y of one element: (s - mean) * rstd * scale + bias, or s * rstd * scale
__device__ __forceinline__ float norm_one(float s, float mean, float rstd,
                                          float sc, float b, int rms) {
  const float ys = __fmul_rn(__fmul_rn(rms ? s : __fsub_rn(s, mean), rstd),
                             sc);
  return rms ? ys : __fadd_rn(ys, b);
}

// ---------------------------------------------------------------------------
// warp_rows: a warp per row, the row in registers
// ---------------------------------------------------------------------------

// Pass 3 of warp_rows with scale / bias of type TP: normalise, scale
// (+ bias), one rounding to T, one 16-byte store a group.
template <typename T, typename TP, int G, int NV>
__device__ __forceinline__ void warp_store(const Pack<T, G> (&c)[NV],
                                           int lane, int ng, float mean,
                                           float rstd, const Args& a,
                                           T* __restrict__ outr) {
  const TP* __restrict__ sp = static_cast<const TP*>(a.scale);
  const TP* __restrict__ bp = static_cast<const TP*>(a.bias);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int g = v * 32 + lane;
    if (g < ng) {
      float f[G], sc[G], b[G];
      widen(c[v], f);
      widen(load_pack<TP, G>(sp + g * G), sc);
      if (!a.rms) widen(load_pack<TP, G>(bp + g * G), b);
#pragma unroll
      for (int j = 0; j < G; ++j)
        f[j] = norm_one(f[j], mean, rstd, sc[j], a.rms ? 0.f : b[j], a.rms);
      reinterpret_cast<Pack<T, G>*>(outr)[g] = narrow_to<T>(f);
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kWarpThreads)
warp_rows(const Args a) {
  constexpr int G = 16 / sizeof(T);
  constexpr int kWarps = kWarpThreads / 32;
  const int lane = threadIdx.x & 31;
  const int D = a.D, ng = D / G;
  const double inv_d = 1.0 / (double)D;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < a.rows; row += step) {
    const T* xr = static_cast<const T*>(a.x) + row * D;
    Pack<T, G> c[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int g = v * 32 + lane;
      if (g < ng) c[v] = load_pack<T, G>(xr + g * G);
    }
    if (a.res) {
      // s = x + residual, rounded to T (all loads issued before the adds)
      const T* rr = static_cast<const T*>(a.res) + row * D;
      Pack<T, G> r[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int g = v * 32 + lane;
        if (g < ng) r[v] = load_pack<T, G>(rr + g * G);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v * 32 + lane < ng) {
          float f[G], h[G];
          widen(c[v], f);
          widen(r[v], h);
#pragma unroll
          for (int j = 0; j < G; ++j) f[j] = __fadd_rn(f[j], h[j]);
          c[v] = narrow_to<T>(f);
        }
      }
    }
    // pass 1: the row sum (or sum of squares)
    double acc[kParts] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (v * 32 + lane < ng) {
        float f[G];
        widen(c[v], f);
#pragma unroll
        for (int j = 0; j < G; ++j)
          acc[j % kParts] += a.rms ? (double)__fmul_rn(f[j], f[j])
                                   : (double)f[j];
      }
    }
    const float stat = (float)(warp_sum_f64(sum_parts(acc)) * inv_d);
    float mean = 0.f, rstd;
    if (a.rms) {
      rstd = inv_std(stat, a.eps);
    } else {
      mean = stat;
      // pass 2 (registers): the centred sum of squares
      double sq[kParts] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (v * 32 + lane < ng) {
          float f[G];
          widen(c[v], f);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float d = __fsub_rn(f[j], mean);
            sq[j % kParts] += (double)__fmul_rn(d, d);
          }
        }
      }
      rstd = inv_std((float)(warp_sum_f64(sum_parts(sq)) * inv_d), a.eps);
    }
    T* outr = static_cast<T*>(a.out) + row * D;
    by_param_type(a.pdtype, [&](auto p) {
      warp_store<T, decltype(p), G, NV>(c, lane, ng, mean, rstd, a, outr);
    });
  }
}

// ---------------------------------------------------------------------------
// block_rows: a block per row, the row in registers, rows through a ring of
// shared-memory slots
// ---------------------------------------------------------------------------

// s of group g (columns g*G .. g*G+G-1, the first n of them in the row):
// one vector access per operand where `vec` (every group whole and
// aligned), else element by element; invalid elements read 0.
template <typename TX, typename TR, typename TO, int G>
__device__ __forceinline__ void load_s(const TX* xr, const TR* rr, int g,
                                       int n, bool vec, float (&f)[G]) {
  if (vec) {
    widen(load_pack<TX, G>(xr + g * G), f);
    if (rr) {
      float h[G];
      widen(load_pack<TR, G>(rr + g * G), h);
#pragma unroll
      for (int j = 0; j < G; ++j) f[j] = round_to<TO>(__fadd_rn(f[j], h[j]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float v = 0.f;
      if (j < n) {
        v = to_f(xr[g * G + j]);
        if (rr) v = round_to<TO>(__fadd_rn(v, to_f(rr[g * G + j])));
      }
      f[j] = v;
    }
  }
}

// Pass 3 of block_rows with scale / bias of type TP: the thread's groups
// (NVB in registers) normalised, scaled (+ bias), rounded to TO once and
// stored, a 16-byte store a group (element by element where the group is
// not a whole aligned vector).
template <typename TO, typename TP, int G, int NVB>
__device__ __forceinline__ void block_store(const Pack<TO, G> (&c)[NVB],
                                            int ng, float mean, float rstd,
                                            const Args& a,
                                            TO* __restrict__ outr) {
  const TP* __restrict__ sp = static_cast<const TP*>(a.scale);
  const TP* __restrict__ bp = static_cast<const TP*>(a.bias);
#pragma unroll
  for (int v = 0; v < NVB; ++v) {
    const int g = v * blockDim.x + threadIdx.x;
    if (g >= ng) break;
    const int n = min(G, a.D - g * G);
    float f[G];
    widen(c[v], f);
    if (a.vec) {
      float sc[G], b[G];
      widen(load_pack<TP, G>(sp + g * G), sc);
      if (!a.rms) widen(load_pack<TP, G>(bp + g * G), b);
#pragma unroll
      for (int j = 0; j < G; ++j)
        f[j] = norm_one(f[j], mean, rstd, sc[j], a.rms ? 0.f : b[j], a.rms);
      reinterpret_cast<Pack<TO, G>*>(outr)[g] = narrow_to<TO>(f);
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < n) {
          const int col = g * G + j;
          outr[col] = from_f<TO>(norm_one(
              f[j], mean, rstd, to_f(sp[col]), a.rms ? 0.f : to_f(bp[col]),
              a.rms));
        }
      }
    }
  }
}

// Issue the bulk copies of `row` into ring slot `slot` (one thread).
template <typename TX, typename TR>
__device__ __forceinline__ void fetch_row(const Args& a, long long row,
                                          unsigned char* slot_base,
                                          uint64_t* bar) {
  const uint32_t xb = (uint32_t)a.x_bytes;
  const uint32_t rb = a.res ? (uint32_t)(a.slot_bytes - a.x_bytes) : 0u;
  mbar_expect_tx(bar, xb + rb);
  bulk_load(slot_base, static_cast<const TX*>(a.x) + row * a.D, xb, bar);
  if (a.res)
    bulk_load(slot_base + xb, static_cast<const TR*>(a.res) + row * a.D, rb,
              bar);
}

// Thread t holds groups t, t + blockDim.x, ... (at most NVB) of every row
// it takes part in: it reads them once (pass 1, from the ring slot or from
// device memory), after which the slot takes the block's next row while
// passes 2 and 3 run on registers.
template <typename TX, typename TR, int NVB>
__global__ void __launch_bounds__(kBlockThreads, 1)
block_rows(const Args a) {
  using TO = typename Promote<TX, TR>::T;
  constexpr int G = 16 / sizeof(TO);
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, S = a.slots;
  const int ng = (D + G - 1) / G;
  const double inv_d = 1.0 / (double)D;
  unsigned char* ring = smem;
  double* red = reinterpret_cast<double*>(ring + S * a.slot_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 64);

  if (S > 0 && threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < S; ++s) {
      const long long row = blockIdx.x + (long long)s * gridDim.x;
      if (row < a.rows) fetch_row<TX, TR>(a, row, ring + s * a.slot_bytes,
                                          &full[s]);
    }
  }
  __syncthreads();

  const bool vec = a.vec;
  int it = 0, k = 0;   // rows and block sums so far
  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x, ++it) {
    const TX* xr;
    const TR* rr = nullptr;
    const int slot = S > 0 ? it % S : 0;
    if (S > 0) {
      mbar_wait(&full[slot], (uint32_t)((it / S) & 1));
      xr = reinterpret_cast<const TX*>(ring + slot * a.slot_bytes);
      if (a.res)
        rr = reinterpret_cast<const TR*>(ring + slot * a.slot_bytes +
                                         a.x_bytes);
    } else {
      xr = static_cast<const TX*>(a.x) + row * D;
      if (a.res) rr = static_cast<const TR*>(a.res) + row * D;
    }
    // pass 1: the thread's groups into registers (s rounded to TO), the
    // row sum (or sum of squares)
    Pack<TO, G> c[NVB];
    double acc[kParts] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int v = 0; v < NVB; ++v) {
      const int g = v * blockDim.x + threadIdx.x;
      if (g < ng) {
        float f[G];
        load_s<TX, TR, TO, G>(xr, rr, g, min(G, D - g * G), vec, f);
        c[v] = narrow_to<TO>(f);
#pragma unroll
        for (int j = 0; j < G; ++j)
          acc[j % kParts] += a.rms ? (double)__fmul_rn(f[j], f[j])
                                   : (double)f[j];
      }
    }
    const float stat =
        (float)(block_sum(sum_parts(acc), red + 32 * (k++ & 1)) * inv_d);
    // every thread has read its groups of the slot: it takes the next row
    if (S > 0 && threadIdx.x == 0) {
      const long long next = row + (long long)S * gridDim.x;
      if (next < a.rows)
        fetch_row<TX, TR>(a, next, ring + slot * a.slot_bytes, &full[slot]);
    }
    float mean = 0.f, rstd;
    if (a.rms) {
      rstd = inv_std(stat, a.eps);
    } else {
      mean = stat;
      // pass 2 (registers): the centred sum of squares, invalid elements
      // left out
      double sq[kParts] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int v = 0; v < NVB; ++v) {
        const int g = v * blockDim.x + threadIdx.x;
        if (g < ng) {
          const int n = min(G, D - g * G);
          float f[G];
          widen(c[v], f);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float d = __fsub_rn(f[j], mean);
            if (j < n) sq[j % kParts] += (double)__fmul_rn(d, d);
          }
        }
      }
      rstd = inv_std((float)(block_sum(sum_parts(sq), red + 32 * (k++ & 1)) *
                             inv_d),
                     a.eps);
    }
    TO* outr = static_cast<TO*>(a.out) + row * D;
    by_param_type(a.pdtype, [&](auto p) {
      block_store<TO, decltype(p), G, NVB>(c, ng, mean, rstd, a, outr);
    });
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int NV>
int launch_warp(const Args& a, cudaStream_t st) {
  constexpr int kRows = kWarpThreads / 32;   // rows a block at a time
  return launch_items<warp_rows<T, NV>>(a, (a.rows + kRows - 1) / kRows,
                                        kWarpThreads, 0, 0, true, st);
}

template <typename TX, typename TR, int NVB>
int launch_block(Args a, int ng, bool bulk, cudaStream_t st) {
  int dev = 0, smem_optin = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&smem_optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc != cudaSuccess) return (int)rc;
  const int D = a.D;
  // NVB groups a thread at most: 32 .. kBlockThreads threads
  int threads = (ng + NVB - 1) / NVB;
  threads = (threads + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads;
  const int tail = 64 * 8 + kMaxSlots * 8 + 128;     // red, barriers, slack
  a.slots = 0;
  a.x_bytes = D * (int)sizeof(TX);
  a.slot_bytes = a.x_bytes + (a.res ? D * (int)sizeof(TR) : 0);
  if (bulk && 2LL * a.slot_bytes + tail <= smem_optin) {
    const int s = kRingBytes / a.slot_bytes;   // 2 .. kMaxSlots slots
    a.slots = s < 2 ? 2 : (s > kMaxSlots ? kMaxSlots : s);
  }
  return launch_items<block_rows<TX, TR, NVB>>(
      a, a.rows, threads, a.slots * a.slot_bytes + tail, smem_optin, true,
      st);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TX, typename TR>
int run(Args a, cudaStream_t st) {
  using TO = typename Promote<TX, TR>::T;
  constexpr int G = 16 / sizeof(TO);
  const int D = a.D;
  const bool ptrs = aligned16(a.x) && aligned16(a.out) &&
                    aligned16(a.scale) && aligned16(a.bias) &&
                    (!a.res || aligned16(a.res));
  a.vec = ptrs && D % G == 0;
  if constexpr (std::is_same<TX, TR>::value) {
    const long long row_bytes = (long long)D * sizeof(TO);
    if (a.vec && row_bytes <= kWarpMaxBytes) {
      if (row_bytes <= 32 * 16 * 2) return launch_warp<TX, 2>(a, st);
      return launch_warp<TX, 4>(a, st);
    }
  }
  const bool bulk = a.vec && ((long long)D * sizeof(TX)) % 16 == 0 &&
                    (!a.res || ((long long)D * sizeof(TR)) % 16 == 0);
  // the row in registers: two groups a thread, or eight for rows of more
  // than 2 x kBlockThreads groups
  const int ng = (D + G - 1) / G;
  if (ng <= 2 * kBlockThreads)
    return launch_block<TX, TR, 2>(a, ng, bulk, st);
  return launch_block<TX, TR, 8>(a, ng, bulk, st);
}

template <typename TX>
int by_residual(const Args& a, int res_dtype, cudaStream_t st) {
  if (!a.res) return run<TX, TX>(a, st);
  switch (res_dtype) {
    case 0: return run<TX, float>(a, st);
    case 1: return run<TX, __nv_bfloat16>(a, st);
    case 2: return run<TX, __half>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace norms
}  // namespace dstt

// x [rows, D] (dtype code as above), res [rows, D] (res_dtype) or NULL,
// scale and bias [D] (param_dtype; bias ignored when rms != 0), out
// [rows, D] in the promoted dtype of x and res -> out. 1 <= D <= kMaxDim,
// rows >= 1, every pointer aligned to its element. Returns
// cudaGetLastError() of the launch.
extern "C" int dstt_norm(const void* x, const void* res, const void* scale,
                         const void* bias, void* out, long long rows, int D,
                         float eps, int rms, int x_dtype, int res_dtype,
                         int param_dtype, void* stream) {
  using namespace dstt::norms;
  if (D < 1 || D > kMaxDim || rows < 1 || param_dtype < 0 ||
      param_dtype > 2)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.res = res;
  a.scale = scale;
  a.bias = bias;
  a.out = out;
  a.rows = rows;
  a.D = D;
  a.eps = eps;
  a.rms = rms;
  a.pdtype = param_dtype;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return by_residual<float>(a, res_dtype, st);
    case 1: return by_residual<__nv_bfloat16>(a, res_dtype, st);
    case 2: return by_residual<__half>(a, res_dtype, st);
  }
  return (int)cudaErrorInvalidValue;
}
