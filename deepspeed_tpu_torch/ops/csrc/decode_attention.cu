// decode_attention.cu — single-token attention over a KV cache, for Hopper.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/decode_attention.py:
//   * decode_attention (:108, kernel _decode_kernel :77) — contiguous cache
//     k/v [B, Hkv, M, hd];
//   * paged_decode_attention (:194, kernel _paged_decode_kernel :180) — a
//     paged pool k/v [N, Hkv, block, hd] addressed through block tables
//     [B, nb];
//   * paged_decode_attention_quant (:304, kernel _paged_decode_quant_kernel
//     :260) — the same over the int8 pool: int8 k/v plus f32 scales
//     [N, Hkv, block, hd/g], one per group of g elements of a K/V vector.
// One source, two addressing modes (KvAddr below) and two K/V element types
// sharing one online-softmax body, as the Pallas kernels share
// _online_softmax_tile (:42). The int8 mode dequantizes each K/V tile while
// staging it into shared memory, in the order of dequantize_kv
// (inference/quantization.py): int8 -> fp32 x the group's scale (loaded as a
// scalar) -> narrowed to q's dtype -> back to fp32. fp K/V never exists in
// device memory, and a step reads the live prefix's int8 bytes plus its
// scales: at g = hd about 0.53 of the bf16 pool's bytes.
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

#include <type_traits>

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

// T: q / out dtype. KV: the K/V element type — T, or int8_t with per-group
// f32 scales ksc / vsc ([..., HD / ng] rows beside the payload rows).
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const float* __restrict__ ksc,
                   const float* __restrict__ vsc, int ng, T* __restrict__ out,
                   const int* __restrict__ pos, KvAddr addr, int G,
                   int capacity, float scale) {
  constexpr int TILE = 4096 / HD;      // 64 positions at hd 64, 32 at hd 128
  constexpr int LD = HD + 1;           // padded rows: conflict-free walks
  constexpr int VEC = 16 / sizeof(KV);
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
        const long long row = addr.row(b, h, t0 + r, HD);
        load16(k + row + c, kf);
        load16(v + row + c, vf);
        if constexpr (std::is_same<KV, int8_t>::value) {
          const long long srow = row / HD * ng;
          const int gs = HD / ng;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            kf[j] = to_f(from_f<T>(kf[j] * ksc[srow + (c + j) / gs]));
            vf[j] = to_f(from_f<T>(vf[j] * vsc[srow + (c + j) / gs]));
          }
        }
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

// The K/V operands of one launch: payload pointers, and for the int8 pool
// the scale pointers and the number of scale groups per K/V vector.
struct KvData {
  const void *k, *v;
  const float *ksc, *vsc;
  int ng;
};

template <typename T, typename KV, int HD>
int launch(const void* q, KvData kv, void* out, const int* pos, KvAddr addr,
           int B, int G, int capacity, float scale, cudaStream_t stream) {
  constexpr int TILE = 4096 / HD;
  const size_t smem =
      sizeof(float) * (2 * TILE * (HD + 1) + 2 * G * HD + G * TILE + 3 * G);
  cudaFuncSetAttribute(decode_attn_kernel<T, KV, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  decode_attn_kernel<T, KV, HD><<<dim3(addr.Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kv.k),
      static_cast<const KV*>(kv.v), kv.ksc, kv.vsc, kv.ng,
      static_cast<T*>(out), pos, addr, G, capacity, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch_hd(int hd, const void* q, KvData kv, void* out, const int* pos,
              KvAddr addr, int B, int G, int capacity, float scale,
              cudaStream_t stream) {
  if (hd == 64)
    return launch<T, KV, 64>(q, kv, out, pos, addr, B, G, capacity, scale, stream);
  if (hd == 128)
    return launch<T, KV, 128>(q, kv, out, pos, addr, B, G, capacity, scale, stream);
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
  KvData kv{k, v, nullptr, nullptr, 0};
  const int capacity = table == nullptr ? m_or_bs : nb * m_or_bs;
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float, float>(hd, q, kv, out, pos, addr, B, G, capacity, scale, s);
    case 1: return launch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, kv, out, pos, addr, B, G, capacity, scale, s);
    case 2: return launch_hd<__half, __half>(hd, q, kv, out, pos, addr, B, G, capacity, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8 pool: k/v int8 [N, Hkv, bs, hd], k_scale/v_scale f32
// [N, Hkv, bs, ng] with hd % ng == 0; q, out, pos, table and dtype as above
// (dtype is q's). Returns cudaGetLastError().
extern "C" int dstt_paged_decode_attention_quant(
    const void* q, const void* k, const void* v, const float* k_scale,
    const float* v_scale, void* out, const int* pos, const int* table, int B,
    int H, int Hkv, int hd, int bs, int nb, int ng, float scale, int dtype,
    void* stream) {
  if (ng < 1 || hd % ng) return (int)cudaErrorInvalidValue;
  KvAddr addr{table, nb, bs, Hkv, bs};
  KvData kv{k, v, k_scale, v_scale, ng};
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float, int8_t>(hd, q, kv, out, pos, addr, B, G, nb * bs, scale, s);
    case 1: return launch_hd<__nv_bfloat16, int8_t>(hd, q, kv, out, pos, addr, B, G, nb * bs, scale, s);
    case 2: return launch_hd<__half, int8_t>(hd, q, kv, out, pos, addr, B, G, nb * bs, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
