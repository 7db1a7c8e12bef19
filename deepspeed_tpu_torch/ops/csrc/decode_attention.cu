// decode_attention.cu — single-token attention over a KV cache, for Hopper.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/decode_attention.py:
//   * decode_attention (:108, kernel _decode_kernel :77) — contiguous cache
//     k/v [B, Hkv, M, hd]: `paged_decode_kernel` with no table. The cache is
//     a pool [N = B, Hkv, bs = M, hd] in which row b owns one block, block
//     b: the pool's address ((phys * Hkv + h) * bs + p % bs) * hd with phys
//     = b and bs = M is the cache's ((b * Hkv + h) * M + p) * hd, so a tile
//     is one page segment and no table is read;
//   * paged_decode_attention (:194, kernel _paged_decode_kernel :180) — a
//     paged pool k/v [N, Hkv, block, hd] addressed through block tables
//     [B, nb]: `paged_decode_kernel`;
//   * paged_decode_attention_quant (:304, kernel _paged_decode_quant_kernel
//     :260) — the same over the int8 pool: int8 k/v plus f32 scales
//     [N, Hkv, block, hd/g], one per group of g elements of a K/V vector:
//     `paged_decode_kernel` with int8 K/V.
// The int8 pool is dequantized in the order of dequantize_kv
// (inference/quantization.py): int8 -> fp32 x the group's scale -> narrowed
// to q's dtype -> back to fp32, so the kernel attends over the values its
// plain version does. fp K/V never exists in device memory, and a step
// reads the live prefix's int8 bytes plus its scales: at g = hd about 0.53
// of the bf16 pool's bytes.
//
// What bounds them on the H100: memory. A step reads each row's live K/V
// prefix once, 2 * (pos+1) * Hkv * hd elements, and does about one
// multiply-add per element read — far below the ~295 flop/byte ridge of the
// card. So the kernels move only the live prefix, and the question is how
// many of its bytes are in flight at once; the fp32 CUDA cores keep up with
// the bf16 pool (the int8 pool's dequantization is the exception, below).
//
// paged_decode_kernel (flash-decoding): each row's live prefix is split
// across the card. A work item is (row b, kv head h, chunk c) of `chunk`
// positions, from the wrapper's split_plan (shapes only: pos is read on the
// device, never on the host): a power of two >= 64, 128 at the serving
// shape, 512 at the long-context one, so that the items make about one
// wave of the card's block slots. The grid is B * Hkv * ceil(capacity /
// chunk); a block whose chunk starts at or past min(pos[b] + 1, capacity)
// exits at once. Each of the four warps streams its own tiles of the chunk
// (2 KB of 16-bit K: 16 rows at hd 64, 8 at hd 128; warp w takes tiles w,
// w + 4, ...) through a ring of two stages: lane 0 issues one 1-D bulk copy
// (sm90.cuh bulk_load) of K, of V (and of the int8 scales) a page segment
// onto the stage's mbarrier, the chunk's table entries read a lane each
// beside pos (none for the contiguous cache), so the next tile lands while
// this one is computed. A lane takes 8 elements of a row for every dtype
// (hd 64: 8 lanes a row, 4 rows a warp instruction); q sits in registers (fp32); a row's dot products are
// summed over its lanes by shuffles; the softmax is online per warp and
// tile (exp2 of log2e-scaled scores); each lane accumulates P·V for its 8
// elements in fp32 registers for every head of the pass (P stays fp32).
// The warps merge in shared memory; a chunk writes its partial (m, l,
// acc[G][hd]) in fp32 to the wrapper's scratch, or, the row's only live
// chunk, its output directly. The last of a (b, h)'s live chunks to finish
// (a ticket: one atom.acq_rel.inc by thread 0, which wraps the counter
// back to 0 for the next call or graph replay) merges the partials, read
// back through L2 eight chunks at a time over all its threads. Any pool
// block size, capacity and G >= 1 (passes of 1, 4 or 8 heads; above 8 the
// chunk is streamed again), hd 64 / 128 and the three dtypes; a row whose
// table points only at the trash block (pos 0) reads one row of it; pos is
// clamped to the capacity. Up to GQ 4 the kernel is held to 128 registers
// (four blocks an SM).
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6, device time under
// CUDA graphs): generate()'s contiguous decode 7.79 µs, SDPA with the
// prefix mask 17.66 (the first design, a block per (row, kv head) walking
// its prefix in series, 36.12); the contiguous long-context shape at
// 1.40x its byte bound. The serving shape runs at ~3.8x its byte bound,
// held by the launch, two dependent reads (pos, the table), DRAM latency
// and the merge's global round trips (~2 µs); the bf16 long-context shape
// at 1.37x; the int8 pool at long context by the dequantization in
// registers (~3.4x: some nine operations an element at GQ 4). A cluster
// of a row's chunks meeting in distributed shared memory ran slower
// (whole clusters fit fewer blocks at once).

#include <climits>
#include <type_traits>

#include "sm90.cuh"

// ---------------------------------------------------------------------------
// paged_decode_kernel: each row's prefix split into chunks
// ---------------------------------------------------------------------------

namespace dstt {
namespace paged {
namespace {

using namespace dstt::sm90;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;       // a warp's ring of tiles
constexpr int kVec = 8;          // K/V elements of a row a lane takes
constexpr int kMaxSmem = 232448; // the H100's opt-in shared memory a block

struct Params {
  const void *q, *k, *v;
  const float *ksc, *vsc;  // int8 pool: [N, Hkv, bs, ng] scales; else null
  void* out;               // [B, H, HD]
  const int* pos;          // [B]
  const int* table;        // [B, nb]; null: the contiguous cache (nb 1)
  float* part;             // [items, G, HD] sums, then [items, G] (m, l)
  unsigned* tickets;       // [B * Hkv], 0 at rest
  int Hkv, G, bs, nb, ng, lgs, chunk, nch, capacity;
  int sc_bulk;             // the scales' segments are whole 16 bytes
  float scale;             // sm_scale * log2(e): scores in the exp2 domain
};

// The physical block of row b's logical block pg: the row's table entry,
// or, for the contiguous cache [B, Hkv, M, hd] (a pool of B blocks of M
// rows, no table), block b itself.
__device__ __forceinline__ long long page(const Params& p, int b, int pg) {
  return p.table ? (long long)p.table[(long long)b * p.nb + pg] : b;
}

// x and y narrowed to T (two at a time) and widened back
template <typename T>
__device__ __forceinline__ void narrow2(float& x, float& y) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const float2 f = __bfloat1622float2(__floats2bfloat162_rn(x, y));
    x = f.x;
    y = f.y;
  } else if constexpr (std::is_same<T, __half>::value) {
    const float2 f = __half22float2(__floats2half2_rn(x, y));
    x = f.x;
    y = f.y;
  }
}

// The kVec K or V elements of a row at `p` as fp32. int8: exact int ->
// float (the bits of 2^23 + (b + 128), less 2^23 + 128), times the
// element's group scale from the row's staged scales `sc` (group = (col +
// j) >> lgs; one scale serves the lane where a group spans >= 8 elements),
// narrowed to T and widened back, as dequantize_kv.
template <typename T, typename KV>
__device__ __forceinline__ void kv_row(const KV* p, const float* sc, int lgs,
                                       int col, float (&f)[kVec]) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      f[j] = __int_as_float(__byte_perm(w[j >> 2], 0x4B000000u,
                                        0x7440u + (j & 3))) - 8388736.f;
    if (lgs >= 3) {  // one group spans the lane's elements
      const float s = sc[col >> lgs];
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] *= s;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] *= sc[(col + j) >> lgs];
    }
#pragma unroll
    for (int j = 0; j < kVec; j += 2) narrow2<T>(f[j], f[j + 1]);
  } else {
    load16(p, f);
    if constexpr (sizeof(KV) == 4) load16(p + 4, f + 4);
  }
}

// One block per (row b, kv head h, chunk c), item (b * Hkv + h) * nch + c.
// T: q / out dtype; KV: T or int8_t; GQ: query heads a pass (1, 4 or 8,
// the absent ones zero). Up to GQ 4 the kernel is held to 128 registers,
// four blocks an SM (the int8 one would take 159), so that split_plan's
// chunks of the long-context shape (512 items) are one wave.
template <typename T, typename KV, int HD, int GQ>
__global__ void __launch_bounds__(kThreads, GQ <= 4 ? 4 : 2)
paged_decode_kernel(const __grid_constant__ Params p) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int LPP = HD / kVec;       // lanes a row (8 or 16)
  constexpr int PPW = 32 / LPP;        // rows a warp instruction
  constexpr int TILE = 1024 / HD;      // rows a tile: 2 KB of 16-bit K
  constexpr int IT = TILE / PPW;       // instructions a tile
  constexpr int LG_HD = HD == 64 ? 6 : 7;
  static_assert(IT * PPW == TILE && TILE * HD == 1024, "tiling");

  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // each warp streams its tiles through its own ring: kStages stages of
  // K [TILE][HD], V [TILE][HD] (int8: then K, V scales [TILE][ng]); the
  // ring holds the warp's sums at the end
  const int stage_bytes =
      2 * TILE * HD * (int)sizeof(KV) + (kInt8 ? 8 * TILE * p.ng : 0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp * kStages;
  unsigned char* ring = smem + 128 + warp * kStages * stage_bytes;
  int* last = reinterpret_cast<int*>(smem + 64);

  const int bh = blockIdx.x / p.nch, c = blockIdx.x - bh * p.nch;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int start = c * p.chunk;
  // the table entries of the pages this chunk can touch, loaded beside pos
  // (lane i: page first + i)
  const int first = start / p.bs;
  const int span = min(p.nb - 1, (start + p.chunk - 1) / p.bs) - first + 1;
  long long phys0 = 0;
  if (lane < span) phys0 = page(p, b, first + lane);
  const int pb = p.pos[b];
  const int len = pb < 0 ? 0 : min(pb, p.capacity - 1) + 1;
  const int nlive = max(1, (len + p.chunk - 1) / p.chunk);
  if (c >= nlive) return;
  const int n = max(0, min(p.chunk, len - start));  // live rows of the chunk
  const int ntiles = (n + TILE - 1) / TILE;
  const int ntw = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  const int ru = p.ng >= 4 ? 1 : 4 / max(p.ng, 1);  // scale rows a 16 bytes

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // the copies of the warp's i-th tile into the stage of its use-th use of
  // the ring: one bulk copy of K, of V (and of their scales) a page
  // segment, one table lookup a segment (lane pg - first's register, else
  // a load); all lanes walk the segments, lane 0 issues
  auto issue = [&](int i, int use) {
    const int lo = start + (warp + i * kWarps) * TILE;
    const int hi = start + min(n, (warp + i * kWarps + 1) * TILE);
    uint64_t* full = &bar[use % kStages];
    unsigned char* st = ring + (use % kStages) * stage_bytes;
    KV* ks = reinterpret_cast<KV*>(st);
    KV* vs = ks + TILE * HD;
    float* kss = reinterpret_cast<float*>(vs + TILE * HD);
    float* vss = kss + TILE * p.ng;
    uint32_t bytes = 0;
    for (int q0 = lo; q0 < hi;) {
      const int run = min(p.bs - q0 % p.bs, hi - q0);
      bytes += 2 * run * HD * sizeof(KV);
      if (kInt8 && p.sc_bulk)
        bytes += 8 * ((run + ru - 1) / ru * ru) * p.ng;
      q0 += run;
    }
    if (lane == 0) mbar_expect_tx(full, bytes);
    for (int q0 = lo; q0 < hi;) {
      const int pg = q0 / p.bs, off = q0 - pg * p.bs;
      const int run = min(p.bs - off, hi - q0);
      const int rel = pg - first;
      const long long ph = __shfl_sync(0xffffffffu, phys0, rel & 31);
      if (lane == 0) {
        const long long phys = rel < 32 ? ph : page(p, b, pg);
        const long long row = (phys * p.Hkv + h) * p.bs + off;
        const int rr = q0 - lo;
        const uint32_t kvb = run * HD * sizeof(KV);
        bulk_load(ks + rr * HD, static_cast<const KV*>(p.k) + row * HD, kvb,
                  full);
        bulk_load(vs + rr * HD, static_cast<const KV*>(p.v) + row * HD, kvb,
                  full);
        if (kInt8 && p.sc_bulk) {
          const uint32_t sb = 4 * ((run + ru - 1) / ru * ru) * p.ng;
          bulk_load(kss + rr * p.ng, p.ksc + row * p.ng, sb, full);
          bulk_load(vss + rr * p.ng, p.vsc + row * p.ng, sb, full);
        }
      }
      q0 += run;
    }
  };

  const int sl = lane % LPP, pp = lane / LPP;  // 8-element slice, row
  const T* qrow = static_cast<const T*>(p.q) + (long long)bh * p.G * HD;
  T* orow = static_cast<T*>(p.out) + (long long)bh * p.G * HD;
  float* pacc = p.part + ((long long)bh * p.nch + c) * p.G * HD;
  float2* pml = reinterpret_cast<float2*>(p.part + (long long)gridDim.x *
                                                       p.G * HD);
  int u = 0;  // the warp's uses of its ring so far (over the passes)
  for (int g0 = 0; g0 < p.G; g0 += GQ) {
    if (g0 > 0 && lane == 0)  // the rings held the sums: generic writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int j = 0; j < min(kStages, ntw); ++j) issue(j, u + j);
    float qf[GQ][kVec];
#pragma unroll
    for (int gi = 0; gi < GQ; ++gi) {
      if (g0 + gi < p.G) {
        const T* qp = qrow + (g0 + gi) * HD + sl * kVec;
        load16(qp, qf[gi]);
        if constexpr (sizeof(T) == 4) load16(qp + 4, qf[gi] + 4);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) qf[gi][j] = 0.f;
      }
    }
    float m[GQ], l[GQ], acc[GQ][kVec];
#pragma unroll
    for (int gi = 0; gi < GQ; ++gi) {
      m[gi] = -INFINITY;
      l[gi] = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[gi][j] = 0.f;
    }

    for (int i = 0; i < ntw; ++i, ++u) {
      const int rt = (warp + i * kWarps) * TILE;  // the tile's first row
      unsigned char* st = ring + (u % kStages) * stage_bytes;
      const KV* ks = reinterpret_cast<const KV*>(st);
      const KV* vs = ks + TILE * HD;
      float* kss = reinterpret_cast<float*>(const_cast<KV*>(vs) + TILE * HD);
      float* vss = kss + TILE * p.ng;
      mbar_wait(&bar[u % kStages], (uint32_t)((u / kStages) & 1));
      if (kInt8 && !p.sc_bulk) {  // the scales by plain loads
        const int lng = LG_HD - p.lgs;
        const int rows = min(TILE, n - rt);
        for (int e = lane; e < (rows << lng); e += 32) {
          const int lp = start + rt + (e >> lng), pg = lp / p.bs;
          const long long at =
              ((page(p, b, pg) * p.Hkv + h) * p.bs + (lp - pg * p.bs)) *
                  p.ng + (e & (p.ng - 1));
          kss[e] = p.ksc[at];
          vss[e] = p.vsc[at];
        }
        __syncwarp();
      }
      float sc[IT][GQ];
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int r = it * PPW + pp;
        float kf[kVec];
        kv_row<T, KV>(ks + r * HD + sl * kVec, kss + r * p.ng, p.lgs,
                      sl * kVec, kf);
#pragma unroll
        for (int gi = 0; gi < GQ; ++gi) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < kVec; ++j) d = fmaf(qf[gi][j], kf[j], d);
#pragma unroll
          for (int o = LPP / 2; o > 0; o >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          sc[it][gi] = rt + r < n ? d * p.scale : -INFINITY;
        }
      }
#pragma unroll
      for (int gi = 0; gi < GQ; ++gi) {
        float mt = sc[0][gi];
#pragma unroll
        for (int it = 1; it < IT; ++it) mt = fmaxf(mt, sc[it][gi]);
#pragma unroll
        for (int o = LPP; o < 32; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float mn = fmaxf(m[gi], mt);  // finite: row rt is live
        const float alpha = exp2f(m[gi] - mn);
        m[gi] = mn;
        l[gi] *= alpha;
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[gi][j] *= alpha;
#pragma unroll
        for (int it = 0; it < IT; ++it) {
          const float pr = exp2f(sc[it][gi] - mn);
          sc[it][gi] = pr;
          l[gi] += pr;
        }
      }
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int r = it * PPW + pp;
        if (rt + r < n) {  // rows past n hold whatever the stage held
          float vf[kVec];
          kv_row<T, KV>(vs + r * HD + sl * kVec, vss + r * p.ng, p.lgs,
                        sl * kVec, vf);
#pragma unroll
          for (int gi = 0; gi < GQ; ++gi)
#pragma unroll
            for (int j = 0; j < kVec; ++j)
              acc[gi][j] = fmaf(sc[it][gi], vf[j], acc[gi][j]);
        }
      }
      __syncwarp();  // the stage is read: refill it
      if (i + kStages < ntw) issue(i + kStages, u + kStages);
    }
    // the warp's sums over its rows (lanes of one slice), into its ring
    // (idle now: every copy issued was waited for), then the four warps
    // merged
    float* wsum = reinterpret_cast<float*>(ring);  // [GQ][HD], [GQ] (m, l)
#pragma unroll
    for (int gi = 0; gi < GQ; ++gi) {
#pragma unroll
      for (int o = LPP; o < 32; o <<= 1) {
        l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], o);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          acc[gi][j] += __shfl_xor_sync(0xffffffffu, acc[gi][j], o);
      }
      if (pp == 0) {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          wsum[gi * HD + sl * kVec + j] = acc[gi][j];
      }
      if (lane == 0) {
        wsum[GQ * HD + 2 * gi] = m[gi];
        wsum[GQ * HD + 2 * gi + 1] = l[gi];
      }
    }
    __syncthreads();
    for (int e = tid; e < GQ * HD; e += kThreads) {
      const int gi = e >> LG_HD, d = e & (HD - 1), g = g0 + gi;
      if (g >= p.G) break;
      const float* ws[kWarps];
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ws[w] = reinterpret_cast<const float*>(smem + 128 +
                                               w * kStages * stage_bytes);
        mx = fmaxf(mx, ws[w][GQ * HD + 2 * gi]);
      }
      float L = 0.f, A = 0.f;
      if (mx != -INFINITY) {  // else no live row (pos < 0): out 0
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float e2 = exp2f(ws[w][GQ * HD + 2 * gi] - mx);
          L = fmaf(ws[w][GQ * HD + 2 * gi + 1], e2, L);
          A = fmaf(ws[w][gi * HD + d], e2, A);
        }
      }
      if (nlive == 1) {
        orow[g * HD + d] = from_f<T>(A / fmaxf(L, 1e-30f));
      } else {
        pacc[g * HD + d] = A;
        if (d == 0)
          pml[((long long)bh * p.nch + c) * p.G + g] = make_float2(mx, L);
      }
    }
    __syncthreads();  // the rings are the next pass's
  }
  if (nlive == 1) return;

  // the last of the (b, h)'s live chunks merges their partials into out:
  // a task is (head, 4 elements); each round of up to kThreads tasks
  // spreads its chunks over the threads left (chunk cc to group cc %
  // groups), and the groups meet in shared memory
  __syncthreads();
  if (tid == 0) {
    // release: the block's partial (every thread's, ordered before by the
    // barrier) before the ticket; acquire: the others' after it
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(p.tickets + bh), "r"(nlive - 1)
                 : "memory");
    *last = old == (unsigned)(nlive - 1);
  }
  __syncthreads();
  if (!*last) return;
  const float* ra = p.part + (long long)bh * p.nch * p.G * HD;
  const float2* rml = pml + (long long)bh * p.nch * p.G;
  float* red = reinterpret_cast<float*>(smem + 128);  // [kThreads][6]
  const int tasks = p.G * (HD / 4);
  for (int base = 0; base < tasks; base += kThreads) {
    const int nt = min(kThreads, tasks - base);
    const int groups = kThreads / nt;
    const int task = base + tid % nt, grp = tid / nt;
    const int g = task / (HD / 4), d = (task % (HD / 4)) * 4;
    float mx = -INFINITY, L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grp < groups) {
      // eight chunks' loads in flight, then their merge
      for (int c0 = grp; c0 < nlive; c0 += 8 * groups) {
        float2 ml[8];
        float4 a[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int cc = c0 + k * groups;
          if (cc < nlive) {
            ml[k] = __ldcg(rml + cc * p.G + g);
            a[k] = __ldcg(reinterpret_cast<const float4*>(
                ra + ((long long)cc * p.G + g) * HD + d));
          } else {
            ml[k] = make_float2(-INFINITY, 0.f);
            a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          // mn is finite: chunk c0 is live and has a row
          const float mn = fmaxf(mx, ml[k].x);
          const float e0 = exp2f(mx - mn), e1 = exp2f(ml[k].x - mn);
          L = L * e0 + ml[k].y * e1;
          A.x = A.x * e0 + a[k].x * e1;
          A.y = A.y * e0 + a[k].y * e1;
          A.z = A.z * e0 + a[k].z * e1;
          A.w = A.w * e0 + a[k].w * e1;
          mx = mn;
        }
      }
      float* r6 = red + 6 * tid;
      r6[0] = mx;
      r6[1] = L;
      r6[2] = A.x;
      r6[3] = A.y;
      r6[4] = A.z;
      r6[5] = A.w;
    }
    __syncthreads();
    if (tid < nt) {
      float M = -INFINITY;
      for (int k = 0; k < groups; ++k) M = fmaxf(M, red[6 * (k * nt + tid)]);
      float S = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < groups; ++k) {
        const float* r6 = red + 6 * (k * nt + tid);
        const float e = exp2f(r6[0] - M);  // a group without chunks: 0
        S = fmaf(r6[1], e, S);
#pragma unroll
        for (int x = 0; x < 4; ++x) o[x] = fmaf(r6[2 + x], e, o[x]);
      }
      const float Ls = fmaxf(S, 1e-30f);
      T* dst = orow + g * HD + d;
#pragma unroll
      for (int x = 0; x < 4; ++x) dst[x] = from_f<T>(o[x] / Ls);
    }
    __syncthreads();
  }
}

template <typename T, typename KV, int HD, int GQ>
int paged_launch(const Params& p, long long items, cudaStream_t stream) {
  constexpr int TILE = 1024 / HD;
  const int stage = 2 * TILE * HD * (int)sizeof(KV) +
                    (std::is_same<KV, int8_t>::value ? 8 * TILE * p.ng : 0);
  const int smem = 128 + kWarps * kStages * stage;
  // the warps' sums and the combine's groups reuse the rings
  if (kStages * stage < (GQ * HD + 2 * GQ) * 4 || smem < 128 + 24 * kThreads)
    return (int)cudaErrorInvalidValue;
  return launch_items<paged_decode_kernel<T, KV, HD, GQ>>(
      p, items, kThreads, smem, kMaxSmem, false, stream);
}

template <typename T, typename KV>
int paged_dispatch(const Params& p, int hd, long long items,
                   cudaStream_t stream) {
  const int gq = p.G == 1 ? 1 : p.G <= 4 ? 4 : 8;
#define DSTT_PAGED(HD_, GQ_) \
  if (hd == HD_ && gq == GQ_) return paged_launch<T, KV, HD_, GQ_>(p, items, stream)
  DSTT_PAGED(64, 1);
  DSTT_PAGED(64, 4);
  DSTT_PAGED(64, 8);
  DSTT_PAGED(128, 1);
  DSTT_PAGED(128, 4);
  DSTT_PAGED(128, 8);
#undef DSTT_PAGED
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace paged
}  // namespace dstt

// Decode attention over the paged pool: k/v [N, Hkv, bs, hd] in q's dtype
// (ng 0), or int8 with f32 scales k_scale / v_scale [N, Hkv, bs, ng] (ng a
// power of two dividing hd). q / out [B, H, hd]; pos [B], table [B, nb]
// int32. table null: k/v are the contiguous cache [B, Hkv, M, hd], bs = M
// and nb = 1 (row b's one page is block b). part: fp32 scratch of B * Hkv * n_chunks * (H / Hkv) * (hd + 2)
// floats; tickets: B * Hkv unsigned counters, 0 at rest (the kernel leaves
// them 0). chunk: positions a work item, a multiple of 64; n_chunks =
// ceil(nb * bs / chunk). dtype: 0 float32, 1 bfloat16, 2 float16. Returns
// cudaGetLastError().
extern "C" int dstt_paged_decode(const void* q, const void* k, const void* v,
                                 const float* k_scale, const float* v_scale,
                                 void* out, const int* pos, const int* table,
                                 float* part, unsigned* tickets, int B, int H,
                                 int Hkv, int hd, int bs, int nb, int ng,
                                 int chunk, int n_chunks, float scale,
                                 int dtype, void* stream) {
  using namespace dstt::paged;
  const long long capacity = (long long)nb * bs;
  if (B < 1 || Hkv < 1 || H % Hkv || bs < 1 || nb < 1 ||
      (table == nullptr && nb != 1) ||
      capacity > INT_MAX / 2 || chunk < 64 || chunk % 64 ||
      n_chunks != (capacity + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, k_scale, v_scale, out, pos, table, part, tickets,
           Hkv, H / Hkv, bs, nb, ng, 0, chunk, n_chunks, (int)capacity, 0,
           (float)(scale * 1.4426950408889634)};
  if (ng) {
    if (ng < 0 || hd % ng || (ng & (ng - 1))) return (int)cudaErrorInvalidValue;
    while ((ng << p.lgs) < hd) ++p.lgs;  // group size hd / ng = 2^lgs
    // whole 16-byte scale segments: 4 / ng rows divide the block, and the
    // scales start 16-byte aligned
    p.sc_bulk = (ng >= 4 || bs % (4 / ng) == 0) &&
                reinterpret_cast<uintptr_t>(k_scale) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(v_scale) % 16 == 0;
  }
  const long long items = (long long)B * Hkv * n_chunks;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (ng ? 1 : 0)) {
    case 0: return paged_dispatch<float, float>(p, hd, items, s);
    case 1: return paged_dispatch<float, int8_t>(p, hd, items, s);
    case 2: return paged_dispatch<__nv_bfloat16, __nv_bfloat16>(p, hd, items, s);
    case 3: return paged_dispatch<__nv_bfloat16, int8_t>(p, hd, items, s);
    case 4: return paged_dispatch<__half, __half>(p, hd, items, s);
    case 5: return paged_dispatch<__half, int8_t>(p, hd, items, s);
  }
  return (int)cudaErrorInvalidValue;
}
