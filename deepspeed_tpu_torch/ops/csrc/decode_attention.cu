// decode_attention.cu — single-token attention over a KV cache, for Hopper.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/decode_attention.py:
//   * decode_attention (:108, kernel _decode_kernel :77) — contiguous cache
//     k/v [B, Hkv, M, hd];
//   * paged_decode_attention (:194, kernel _paged_decode_kernel :180) — a
//     paged pool k/v [N, Hkv, block, hd] addressed through block tables
//     [B, nb].
// One source, two addressing modes (KvAddr below) sharing one online-softmax
// body, as the Pallas kernels share _online_softmax_tile (:42).
//
// What bounds it on the H100: memory. A step reads each row's live K/V
// prefix once, 2 * (pos+1) * Hkv * hd elements, and does about one multiply-
// add per element read — far below the ~295 flop/byte ridge of the card. So
// the design moves only the live prefix and keeps nothing else in device
// memory: one thread block per (row b, kv head) holds the G query heads of
// its group, walks tiles of TILE positions up to pos[b] only (never the
// allocated M or the whole table), stages each K/V tile in shared memory
// with 16-byte loads, and keeps m / l / acc in fp32 shared memory. Any M,
// any pool block size and any G >= 1 work: addressing is per position, not
// per 128-row tile. A row whose table points only at the trash block
// (pos 0) reads one row of it and never faults; pos is clamped to the
// cache's capacity.
//
// Known limit: the grid is B * Hkv blocks — 96 at gpt2-125m decode with 8
// slots, fewer than the 132 SMs. Splitting each row's prefix across blocks
// (split-K with a second combine pass) is the later fix.

#include "common.cuh"

namespace {

using namespace dstt;

constexpr int kThreads = 128;

// Element offset of the [hd] K/V row at logical position p of (row b, kv
// head h). Contiguous: ((b*Hkv + h)*M + p) * HD. Paged: the row's table
// names the physical block of logical block p / bs.
struct KvAddr {
  const int* table;  // [B, nb] block tables; null for the contiguous cache
  int nb, bs, Hkv, M;
  __device__ __forceinline__ long long row(int b, int h, int p, int hd) const {
    if (table == nullptr) return ((long long)(b * Hkv + h) * M + p) * hd;
    const long long phys = table[(long long)b * nb + p / bs];
    return ((phys * Hkv + h) * bs + p % bs) * hd;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   const int* __restrict__ pos, KvAddr addr, int G,
                   int capacity, float scale) {
  constexpr int TILE = 4096 / HD;      // 64 positions at hd 64, 32 at hd 128
  constexpr int LD = HD + 1;           // padded rows: conflict-free walks
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = HD / VEC;        // 16-byte vectors per row
  extern __shared__ float smem[];
  float* ks = smem;                    // [TILE][LD]
  float* vs = ks + TILE * LD;          // [TILE][LD]
  float* qs = vs + TILE * LD;          // [G][HD]
  float* acc = qs + G * HD;            // [G][HD]
  float* sc = acc + G * HD;            // [G][TILE] scores, then probabilities
  float* m_s = sc + G * TILE;          // [G] running max
  float* l_s = m_s + G;                // [G] running denominator
  float* a_s = l_s + G;                // [G] this tile's rescale factor

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qrow = ((long long)b * addr.Hkv + h) * G * HD;
  const int len = min(pos[b] + 1, capacity);

  for (int i = tid; i < G * HD; i += kThreads) {
    qs[i] = to_f(q[qrow + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);
    __syncthreads();  // previous tile fully consumed (and q staged)
    for (int i = tid; i < TILE * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * VEC;
      float kf[VEC], vf[VEC];
      if (r < n) {
        const long long off = addr.row(b, h, t0 + r, HD) + c;
        load16(k + off, kf);
        load16(v + off, vf);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[r * LD + c + j] = kf[j];
        vs[r * LD + c + j] = vf[j];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * TILE; i += kThreads) {
      const int g = i / TILE, r = i % TILE;
      float s = -INFINITY;
      if (r < n) {
        float d = 0.f;
#pragma unroll 16
        for (int j = 0; j < HD; ++j) d += qs[g * HD + j] * ks[r * LD + j];
        s = d * scale;
      }
      sc[i] = s;
    }
    __syncthreads();

    // online-softmax statistics: one warp per query head of the group
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sg = sc + g * TILE;
      float mx = -INFINITY;
      for (int r = lane; r < TILE; r += 32) mx = fmaxf(mx, sg[r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);  // finite: position t0 is live
      float sum = 0.f;
      for (int r = lane; r < TILE; r += 32) {
        const float p = expf(sg[r] - m_new);
        sg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      const float* p = sc + g * TILE;
      float a = acc[i] * a_s[g];
      for (int r = 0; r < n; ++r) a += p[r] * vs[r * LD + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const float l = fmaxf(l_s[i / HD], 1e-30f);
    out[qrow + i] = from_f<T>(acc[i] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* pos, KvAddr addr, int B, int G, int capacity,
           float scale, cudaStream_t stream) {
  constexpr int TILE = 4096 / HD;
  const size_t smem =
      sizeof(float) * (2 * TILE * (HD + 1) + 2 * G * HD + G * TILE + 3 * G);
  cudaFuncSetAttribute(decode_attn_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  decode_attn_kernel<T, HD><<<dim3(addr.Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), pos, addr, G, capacity,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              const int* pos, KvAddr addr, int B, int G, int capacity,
              float scale, cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, out, pos, addr, B, G, capacity, scale, stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, pos, addr, B, G, capacity, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, hd], out [B, H, hd]; pos [B] int32. table == null: k/v are the
// contiguous cache [B, Hkv, M, hd] and `m_or_bs` is M. Otherwise k/v are the
// pool [N, Hkv, bs, hd], table is [B, nb] int32 and `m_or_bs` is bs.
// dtype: 0 float32, 1 bfloat16, 2 float16. Returns cudaGetLastError().
extern "C" int dstt_decode_attention(const void* q, const void* k,
                                     const void* v, void* out, const int* pos,
                                     const int* table, int B, int H, int Hkv,
                                     int hd, int m_or_bs, int nb, float scale,
                                     int dtype, void* stream) {
  KvAddr addr{table, nb, m_or_bs, Hkv, m_or_bs};
  const int capacity = table == nullptr ? m_or_bs : nb * m_or_bs;
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(hd, q, k, v, out, pos, addr, B, G, capacity, scale, s);
    case 1: return launch_hd<__nv_bfloat16>(hd, q, k, v, out, pos, addr, B, G, capacity, scale, s);
    case 2: return launch_hd<__half>(hd, q, k, v, out, pos, addr, B, G, capacity, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
