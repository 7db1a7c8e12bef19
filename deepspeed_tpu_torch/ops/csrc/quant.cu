// quant.cu — groupwise symmetric int8 / packed int4 quantize and dequantize,
// for Hopper.
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/pallas/quant.py:
//   * quantize_int8 (:53, kernel _quant_kernel :25) and dequantize_int8
//     (:170, kernel _dequant_kernel :37); quantize_int8 also as the int8
//     KV pool's cache write, which the JAX package leaves to XLA
//     (deepspeed_tpu/models/gpt.py: quantize_kv, then .at[blk, :, off].set);
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
// once with a handful of operations, far below the card's ridge point.
//   quantize   quantize_int8 and quantize_int4 (dense), and the int8
//              pool's cache write of a layer's K and V in one launch:
//              quantize_vec_kernel. A lane takes a unit of 8 elements (one
//              16-byte load of bf16 / fp16, two of fp32) and keeps it in
//              registers: x is read once. A group of g elements is a team
//              of g / 8 lanes (a power of two >= it, up to 32; above g 256
//              a lane takes 2 or 4 units), whose amax is an xor shuffle
//              over the team; g dividing 8 reduces inside the unit. The
//              team's first lane writes the scale; each lane stores its
//              unit's payload as one word (8 bytes at int8; 8 nibbles, 4
//              bytes, at int4), so a warp's stores are one run. The dense
//              quantize gives a warp 4 tiles of 32 units with all loads
//              issued first; the pool write one tile, and reads positions
//              and the table in the kernel, so one launch replaces the
//              table gather, `//`, `%`, two quantizes and four index
//              writes (26.5 -> 2.9 µs of device time at the serving
//              shape, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6). wte
//              [50304, 768] g 64, int8: 154.9 -> 52.6-53.7 µs, 1.49-1.52x
//              its byte bound; int4 154.1 -> 53.1-53.4 µs, 1.80x. Both
//              widths take the same time: their reads of x hold them
//              (~1.5 TB/s). 1, 2, 8 or 16 units a lane, 128-thread blocks,
//              streaming loads, units held raw in registers, and an exact
//              quotient from the group's reciprocal (two fma corrections)
//              in place of the divisions measured no faster (PERF.md §5).
//              Groups the vector path cannot take (g neither dividing 8
//              nor a multiple of 8, g > 1024, an unaligned x):
//              quantize_kernel, one 128-thread block per row; pass 1 gives
//              each group to a warp, whose lanes stride the group and
//              reduce |max| with a shuffle; the scales go to shared memory
//              and to the output; pass 2 quantizes the row (or packs its
//              byte pairs, whose two elements may lie in two groups: g 7)
//              with neighbouring threads on neighbouring elements, reading
//              the row a second time from L1/L2.
//   dequantize flat and vectorised. Groups lie along the last dim and
//              D % g == 0, so a leaf is one flat array: out[i] = q[i] *
//              s[i / g] (int8); byte j holds elements 2j and 2j + 1 (int4).
//              One launch takes up to kMaxLeaves leaves (a model layer's),
//              each with its own length and g, passed by value in the
//              kernel's __grid_constant__ parameters. The work is cut into
//              units, the elements of one 16-byte output vector (8 into
//              bf16 / fp16, 4 into fp32: 8 or 4 payload bytes for int8, 4
//              or 2 for int4), and the units into tiles of 1024 within one
//              leaf, one block a tile (not persistent: the block scheduler
//              overlaps one block's stores with the next blocks' loads).
//              A block reads its leaf's fields once; thread t takes units
//              t, t + 256, t + 512, t + 768 of the tile, so a warp's
//              payload loads and its 16-byte stores are each one
//              contiguous run, and issues their loads and scales before
//              it converts any. Ints become floats exactly by the
//              magic-number trick (the bits of 2^23 + b, less 2^23 + the
//              bias), are multiplied by the scale in fp32 and narrowed two
//              at a time (cvt.rn.bf16x2 / f16x2). Where g is a multiple of
//              the unit one scale serves the unit (its index a shift, or a
//              32-bit division); otherwise (g 7: an int4 byte spans two
//              groups) each element takes its own, by a running group
//              index. The elements after a leaf's last whole unit are a
//              scalar tail; a leaf whose payload is not aligned to its unit
//              (a slice of a stacked leaf can start anywhere) is scalar
//              throughout. Stores keep the default cache policy: a layer's
//              dense leaves (14 MB at gpt2-125m) fit the 50 MB L2, and the
//              matmuls read them next. Against a persistent grid-stride
//              walk with double-buffered batches (PERF.md §5): 8–13 %
//              faster at wte, −6 to +2 % at a layer; 8 units a thread spill
//              and run up to 56 % slower.

#include <climits>
#include <type_traits>

#include "sm90.cuh"

namespace dstt {
namespace quant {
namespace {

using namespace dstt::sm90;

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

// ---------------------------------------------------------------------------
// quantize, vectorised: the dense [rows, D] (int8 and int4) and the int8
// K/V pool write
// ---------------------------------------------------------------------------

constexpr int kVecThreads = 256;
constexpr int kVecUnits = 4;    // tiles a warp of the dense quantize (R 1)
constexpr int kVecMaxGroup = 1024;  // 32 lanes x 4 units of 8 elements

// The tiling of one launch. A unit is 8 consecutive elements of a row (one
// 16-byte load of bf16 / fp16, two of fp32; 8 payload bytes, 4 at int4).
// A tiling group is gt = max(g, 8) elements (gu = gt / 8 units, spg = gt /
// g scales). A team of T = 2^lgT lanes (a power of two >= gu, at most 32)
// takes a group, its lane j unit j (R > 1 units a lane: units j, j + 32,
// ...); a tile is the 32 / T groups of one warp instruction.
struct Tiling {
  long long groups;   // tiling groups of the launch
  int g, lgg;         // the quant group; log2(g) where g < 8
  int gt, gu, spg, lgT;
};

// Dense x [rows, D] -> q [rows, D] (int4: [rows, D / 2]), s [rows, D / g]:
// group G of the flat array starts at element G * gt (payload byte G * gt
// at int8, G * gt / 2 at int4), its scales at G * spg.
struct DenseSite {
  static constexpr bool kOneTile = false;  // KT tiles a warp
  Tiling t;
  const void* x;
  int8_t* q;
  float* s;
  struct At {
    long long G;
  };
  __device__ __forceinline__ At at(long long G) const { return {G}; }
  __device__ __forceinline__ int tensor(const At&) const { return 0; }
  __device__ __forceinline__ const void* x_of(int) const { return x; }
  __device__ __forceinline__ int8_t* q_of(int) const { return q; }
  __device__ __forceinline__ float* s_of(int) const { return s; }
  __device__ __forceinline__ long long src(const At& a) const {
    return a.G * t.gt;
  }
  __device__ __forceinline__ bool dst(const At& a, long long& d,
                                      long long& sd) const {
    d = a.G * t.gt;
    sd = a.G * t.spg;
    return true;
  }
};

// The int8 pool write: K, V [B, C, Hkv, D] (each (b, c) row of Hkv * D
// elements contiguous, b and c strided) -> the pool's payload [N, Hkv, bs,
// D] and scales [N, Hkv, bs, D / g] at (table[b, pos / bs], h, pos % bs),
// pos = positions[b, c]. Groups below per = B * C * Hkv * gpr are K's, the
// rest V's; gpr tiling groups a (b, c, h) row. The host keeps the group
// count below 2^31, so the indices divide in 32 bits (a 64-bit division is
// a called routine: the first design, all in 64 bits, took 9 µs at the
// serving shape). A warp takes one tile (the serving shape's 192 groups
// spread over 48 warps).
struct PoolSite {
  static constexpr bool kOneTile = true;
  Tiling t;
  const void* x[2];
  long long sb[2], sc[2];     // element strides of b and c
  const void* pos;            // [B, C], int32 or int64
  const void* table;          // [B, nb], int32 or int64
  int pos64, table64;
  int8_t* q[2];
  float* s[2];
  unsigned per, C, Hkv, gpr;  // groups a tensor; C; Hkv; groups a row
  int D, ng, bs, nb;
  struct At {
    unsigned bc, h, gr;       // row (b * C + c, h), group in the row
    int ti;                   // 0 K, 1 V
  };
  __device__ __forceinline__ At at(long long G) const {
    At a;
    unsigned u = (unsigned)G;
    a.ti = u >= per;
    if (a.ti) u -= per;
    const unsigned r = u / gpr;
    a.gr = u - r * gpr;
    a.bc = r / Hkv;
    a.h = r - a.bc * Hkv;
    return a;
  }
  __device__ __forceinline__ int tensor(const At& a) const { return a.ti; }
  __device__ __forceinline__ const void* x_of(int ti) const { return x[ti]; }
  __device__ __forceinline__ int8_t* q_of(int ti) const { return q[ti]; }
  __device__ __forceinline__ float* s_of(int ti) const { return s[ti]; }
  __device__ __forceinline__ long long src(const At& a) const {
    const unsigned b = a.bc / C, c = a.bc - b * C;
    return b * sb[a.ti] + c * sc[a.ti] + (long long)a.h * D +
           (long long)a.gr * t.gt;
  }
  __device__ __forceinline__ bool dst(const At& a, long long& d,
                                      long long& sd) const {
    const long long p = pos64 ? static_cast<const long long*>(pos)[a.bc]
                              : static_cast<const int*>(pos)[a.bc];
    // a position before 0 or past the table (the scheduler admits none)
    // is skipped: the kernel never writes outside the pool
    if (p < 0 || p >= (long long)nb * bs) return false;
    const unsigned lb = (unsigned)p / bs;
    const long long e = (long long)(a.bc / C) * nb + lb;
    const long long phys = table64 ? static_cast<const long long*>(table)[e]
                                   : static_cast<const int*>(table)[e];
    const long long row = (phys * Hkv + a.h) * bs + ((unsigned)p - lb * bs);
    d = row * D + (long long)a.gr * t.gt;
    sd = row * ng + (long long)a.gr * t.spg;
    return true;
  }
};

template <typename T>
__device__ __forceinline__ void load_unit(const T* p, float (&f)[8]) {
  load16(p, f);
  if constexpr (sizeof(T) == 4) load16(p + 4, f + 4);
}

// four quantized values' low bytes as one word (byte k = value k)
__device__ __forceinline__ uint32_t pack4(const int* n) {
  return __byte_perm(__byte_perm(n[0], n[1], 0x0040),
                     __byte_perm(n[2], n[3], 0x0040), 0x5410);
}

// eight int4 values in [-7, 7] as one word of biased nibbles q + 8: byte j
// = (value 2j + 8) | (value 2j + 1 + 8) << 4, the even element in the low
// nibble (nibble k = value k)
__device__ __forceinline__ uint32_t pack8_nibbles(const int* n) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) w |= (uint32_t)(n[k] + 8) << (4 * k);
  return w;
}

// One launch quantizes `t.groups` tiling groups: warp w of block k takes
// tiles (k KT + i) 8 + w, i < KT, and issues all its loads before any
// arithmetic (KT x R units in flight a lane). A group's amax is the max
// over its lanes' units by an xor shuffle over the team; where g < 8 a
// unit holds 8 / g groups, each reduced in registers. The team's first
// lane writes the scales; each lane stores its unit's payload as one
// word, 8 bytes at int8 and 4 (8 nibbles) at int4 (a warp's stores one
// contiguous run where gu is a power of two). Numerics as quantize_kernel,
// bit for bit: scale = fmaxf(amax, 1e-8f) / qmax (IEEE division), q =
// clamp(rintf(x / scale), -qmax, qmax), qmax 127 or 7.
template <typename T, int BITS, int R, typename Site>
__global__ void __launch_bounds__(kVecThreads)
quantize_vec_kernel(const __grid_constant__ Site site) {
  constexpr int KT = Site::kOneTile || R > 1 ? 1 : kVecUnits;
  constexpr float QMAX = BITS == 8 ? 127.f : 7.f;
  const Tiling& tl = site.t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int TS = 1 << tl.lgT;  // lanes a team
  const int team = lane >> tl.lgT, j0 = lane & (TS - 1);
  long long G[KT];
  typename Site::At at[KT];
  bool live[KT][R];
  float x[KT][R][8];
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const long long tile =
        ((long long)blockIdx.x * KT + i) * (kVecThreads / 32) + warp;
    G[i] = (tile << (5 - tl.lgT)) + team;
    const bool in = G[i] < tl.groups;
    at[i] = site.at(in ? G[i] : 0);
    const T* xs = static_cast<const T*>(site.x_of(site.tensor(at[i])));
    const long long base = site.src(at[i]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = j0 + 32 * r;
      live[i][r] = in && j < tl.gu;
      if (live[i][r]) {
        load_unit(xs + base + 8 * j, x[i][r]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[i][r][e] = 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    long long d = 0, sd = 0;
    const bool to = G[i] < tl.groups && site.dst(at[i], d, sd);
    const int ti = site.tensor(at[i]);
    int8_t* qd = site.q_of(ti);
    float* sdst = site.s_of(ti);
    // each element's scale: its group's amax over the lane's units (g < 8:
    // over its g elements of the unit), then over the team
    float sc[R][8];
    if (tl.g >= 8) {
      float m = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(x[i][r][e]));
      for (int o = 1; o < TS; o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float s = fmaxf(m, 1e-8f) / QMAX;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) sc[r][e] = s;
      if (to && j0 == 0) sdst[sd] = s;
    } else {
      float a[8], m[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = a[e] = fabsf(x[i][0][e]);
      if (tl.g >= 2) {
#pragma unroll
        for (int e = 0; e < 8; ++e) m[e] = fmaxf(a[e], a[e ^ 1]);
      }
      if (tl.g >= 4) {
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = m[e];
#pragma unroll
        for (int e = 0; e < 8; ++e) m[e] = fmaxf(a[e], a[e ^ 2]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[0][e] = fmaxf(m[e], 1e-8f) / QMAX;
        if (to && (e & (tl.g - 1)) == 0) sdst[sd + (e >> tl.lgg)] = sc[0][e];
      }
    }
    if (!to) continue;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!live[i][r]) continue;
      // clamped before the round-to-nearest-even conversion: the same
      // integer as quantize_kernel's rintf, clamp, cast (NaN -> -qmax)
      int n[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        n[e] = __float2int_rn(
            fminf(fmaxf(x[i][r][e] / sc[r][e], -QMAX), QMAX));
      const int j = j0 + 32 * r;
      if constexpr (BITS == 8) {
        *reinterpret_cast<uint2*>(qd + d + 8 * j) =
            make_uint2(pack4(n), pack4(n + 4));
      } else {
        *reinterpret_cast<uint32_t*>(qd + d / 2 + 4 * j) = pack8_nibbles(n);
      }
    }
  }
}

// The vector tiling of n elements in rows of D at group g, and the units
// a lane takes of a group (R: 1, 2 or 4); 0 where the vector path cannot
// take g: it takes g dividing 8, or g a multiple of 8 up to 32 x 4 units.
int vec_tiling(Tiling& t, long long n, int D, int g) {
  if (D % 8 || g < 1 || D % g) return 0;
  if (g < 8 ? 8 % g : g % 8 || g > kVecMaxGroup) return 0;
  t.g = g;
  t.lgg = 0;
  while (g < 8 && (1 << t.lgg) < g) ++t.lgg;
  t.gt = g < 8 ? 8 : g;
  t.gu = t.gt / 8;
  t.spg = t.gt / g;
  t.groups = n / t.gt;
  t.lgT = 0;
  while ((1 << t.lgT) < t.gu && t.lgT < 5) ++t.lgT;
  return t.gu <= 32 ? 1 : t.gu <= 64 ? 2 : 4;
}

template <typename T, int BITS, typename Site>
int vec_launch(const Site& site, int R, cudaStream_t stream) {
  const long long per_tile = 32 >> site.t.lgT;
  const long long tiles = (site.t.groups + per_tile - 1) / per_tile;
  const long long per_block =
      (kVecThreads / 32) * (Site::kOneTile || R > 1 ? 1 : kVecUnits);
  const long long blocks = (tiles + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  if (R == 1)
    quantize_vec_kernel<T, BITS, 1, Site>
        <<<(int)blocks, kVecThreads, 0, stream>>>(site);
  else if (R == 2)
    quantize_vec_kernel<T, BITS, 2, Site>
        <<<(int)blocks, kVecThreads, 0, stream>>>(site);
  else
    quantize_vec_kernel<T, BITS, 4, Site>
        <<<(int)blocks, kVecThreads, 0, stream>>>(site);
  return (int)cudaGetLastError();
}

// The dense quantize: the vector body where it takes g and x is 16-byte
// aligned and q aligned to a unit's payload word (8 bytes, 4 at int4),
// else the row body, the only kernel for those inputs (g 7: an int4 byte
// spans two groups; g 12; views that start off a 16-byte boundary).
template <typename T, int BITS>
int quantize_dense_t(const void* x, void* q, void* s, long long rows, int D,
                     int g, cudaStream_t stream) {
  DenseSite site{};
  const int R = vec_tiling(site.t, rows * D, D, g);
  if (R == 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % (BITS == 8 ? 8 : 4))
    return quantize_t<T>(x, q, s, rows, D, g, BITS, stream);
  site.x = x;
  site.q = static_cast<int8_t*>(q);
  site.s = static_cast<float*>(s);
  return vec_launch<T, BITS>(site, R, stream);
}

// ---------------------------------------------------------------------------
// dequantize
// ---------------------------------------------------------------------------

constexpr int kMaxLeaves = 32;   // leaves one launch takes
constexpr int kDqThreads = 256;

enum Mode : int {
  kOneScale = 0,    // units, one scale each (g a multiple of the unit)
  kPerElement = 1,  // units, a scale an element
  kScalar = 2,      // element by element: an unaligned payload or output
};

// A unit is the elements of one 16-byte output vector: E = 16 / sizeof(T)
// elements, PB = E x BITS / 8 payload bytes (int8: 8 into bf16 / fp16, 4
// into fp32; int4: 4 or 2).
struct Leaf {
  const int8_t* q;   // payload
  const float* s;    // scales, one per group of g elements
  void* out;         // n elements of the output dtype
  long long n;       // output elements
  long long first;   // the leaf's first tile in the launch
  long long nvec;    // whole units (vector modes)
  int g;
  int gv;            // g / E (kOneScale)
  int gv_shift;      // log2(gv) where gv is a power of two, else -1
  int mode;
};

struct ManyParams {
  Leaf leaf[kMaxLeaves];
  long long tiles;
  int n_leaves;
};

// One element by its flat index e: a tail, a scalar leaf.
template <typename T, int BITS>
__device__ __forceinline__ void dequant1(const int8_t* q, const float* s,
                                         T* out, int g, long long e) {
  int v;
  if (BITS == 8) {
    v = q[e];
  } else {
    const unsigned b = (uint8_t)q[e >> 1];
    v = (int)((e & 1) ? b >> 4 : b & 0xFu) - 8;
  }
  out[e] = from_f<T>((float)v * s[e / g]);
}

// A unit's PB payload bytes (PB-byte aligned), as one or two words.
template <int PB>
__device__ __forceinline__ uint2 load_unit(const int8_t* p) {
  if constexpr (PB == 8) {
    return *reinterpret_cast<const uint2*>(p);
  } else if constexpr (PB == 4) {
    return make_uint2(*reinterpret_cast<const uint32_t*>(p), 0u);
  } else {
    return make_uint2(*reinterpret_cast<const uint16_t*>(p), 0u);
  }
}

// The E ints of a unit as floats, exactly. int8 (element k = byte k): the
// bits of 2^23 + (b + 128), less 2^23 + 128. int4 (element k = nibble k:
// byte j's low nibble is element 2j): the bits of 2^23 + nibble, less
// 2^23 + 8.
template <int BITS, int E>
__device__ __forceinline__ void to_floats(uint2 w, float* f) {
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (BITS == 8) {
      const uint32_t u = (k < 4 ? w.x : w.y) ^ 0x80808080u;
      f[k] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + (k & 3))) -
             8388736.f;
    } else {
      f[k] = __int_as_float(0x4B000000u | ((w.x >> (4 * k)) & 0xFu)) -
             8388616.f;
    }
  }
}

// Unit k of a leaf (elements k E ...): payload `w`, and scale `sc` where one
// serves the unit (`one`), else a scale an element by a running group
// index; stored as one 16-byte vector.
template <typename T, int BITS>
__device__ __forceinline__ void dequant_unit(T* out, const float* s, int g,
                                             bool one, long long k, uint2 w,
                                             float sc) {
  constexpr int E = 16 / sizeof(T);
  const long long e0 = k * E;
  float f[E];
  to_floats<BITS, E>(w, f);
  if (one) {
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] *= sc;
  } else {
    long long gi = e0 / g;
    int r = (int)(e0 - gi * g);
    sc = s[gi];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      f[j] *= sc;
      if (++r == g && j + 1 < E) {
        r = 0;
        sc = s[++gi];
      }
    }
  }
  T* dst = out + e0;
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack2<T>(f[0], f[1]), pack2<T>(f[2], f[3]),
                   pack2<T>(f[4], f[5]), pack2<T>(f[6], f[7]));
  }
}

constexpr int kTileUnits = 4;   // units a thread: a tile is 1024 units

// One block a tile of one leaf: thread t takes units t, t + 256, ... of
// the tile (a warp's loads and 16-byte stores contiguous), issuing their
// payload and scale loads before it converts any.
template <typename T, int BITS>
__global__ void __launch_bounds__(kDqThreads)
dequantize_kernel(__grid_constant__ const ManyParams p) {
  constexpr int E = 16 / sizeof(T), PB = E * BITS / 8, U = kTileUnits;
  const long long t = blockIdx.x;
  int li = 0;
  while (li + 1 < p.n_leaves && t >= p.leaf[li + 1].first) ++li;
  const Leaf& L = p.leaf[li];
  const int8_t* q = L.q;
  const float* s = L.s;
  T* out = static_cast<T*>(L.out);
  const long long n = L.n, nvec = L.nvec;
  const int g = L.g, gv = L.gv, shift = L.gv_shift, mode = L.mode;
  const long long k0 = (t - L.first) * (kDqThreads * U) + threadIdx.x;
  if (mode == kScalar) {
    for (int j = 0; j < U; ++j) {
      const long long k = k0 + (long long)j * kDqThreads;
      for (long long e = k * E; e < (k + 1) * E && e < n; ++e)
        dequant1<T, BITS>(q, s, out, g, e);
    }
    return;
  }
  uint2 w[U];
  float sc[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long k = k0 + (long long)j * kDqThreads;
    if (k < nvec) {
      w[j] = load_unit<PB>(q + k * PB);
      if (mode == kOneScale)
        sc[j] = s[shift >= 0 ? (unsigned)k >> shift : (unsigned)k / gv];
    }
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long k = k0 + (long long)j * kDqThreads;
    if (k < nvec)
      dequant_unit<T, BITS>(out, s, g, mode == kOneScale, k, w[j], sc[j]);
    else if (k == nvec)  // the tail after the last whole unit
      for (long long e = k * E; e < n; ++e) dequant1<T, BITS>(q, s, out, g, e);
  }
}

// A leaf's plan: whole units where its output is 16-byte aligned and its
// payload PB-byte aligned (then a tail unit for the elements after the
// last whole one), else scalar units; returns its tiles.
template <typename T, int BITS>
long long plan_leaf(Leaf& L, long long first) {
  constexpr int E = 16 / sizeof(T), PB = E * BITS / 8;
  const bool aligned = reinterpret_cast<uintptr_t>(L.out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(L.q) % PB == 0;
  L.first = first;
  L.gv = L.g / E;
  L.gv_shift = -1;
  for (int b = 0; b < 31; ++b)
    if (L.gv == (1 << b)) L.gv_shift = b;
  L.nvec = aligned ? L.n / E : 0;
  // a unit index past 32 bits would need a 64-bit division; no leaf that
  // fits the card gets there, but the per-element path would take it
  L.mode = !aligned                                         ? kScalar
           : L.g % E == 0 && L.nvec < (1LL << 32)           ? kOneScale
                                                            : kPerElement;
  const long long units = (L.n + E - 1) / E;
  return (units + kDqThreads * kTileUnits - 1) / (kDqThreads * kTileUnits);
}

template <typename T, int BITS>
int dequantize_t(int n_leaves, const void* const* q, const void* const* s,
                 void* const* out, const long long* n, const int* g,
                 cudaStream_t stream) {
  ManyParams p{};
  p.n_leaves = n_leaves;
  for (int i = 0; i < n_leaves; ++i) {
    Leaf& L = p.leaf[i];
    L.q = static_cast<const int8_t*>(q[i]);
    L.s = static_cast<const float*>(s[i]);
    L.out = out[i];
    L.n = n[i];
    L.g = g[i];
    const long long tiles = plan_leaf<T, BITS>(L, p.tiles);
    p.tiles += tiles;
  }
  return launch_items<dequantize_kernel<T, BITS>>(p, p.tiles, kDqThreads, 0,
                                                  0, false, stream);
}

template <typename T>
int dequantize_bits(int n_leaves, const void* const* q, const void* const* s,
                    void* const* out, const long long* n, const int* g,
                    int bits, cudaStream_t stream) {
  return bits == 8 ? dequantize_t<T, 8>(n_leaves, q, s, out, n, g, stream)
                   : dequantize_t<T, 4>(n_leaves, q, s, out, n, g, stream);
}

}  // namespace
}  // namespace quant
}  // namespace dstt

// x [rows, D] (dtype: 0 float32, 1 bfloat16, 2 float16) -> q int8 [rows, D]
// (bits 8) or [rows, D/2] (bits 4), scales f32 [rows, D/g]. The caller
// guarantees rows >= 1, D % g == 0 and, for bits 4, D even. Both widths
// take the vector body where D % 8 == 0, g divides 8 or is a multiple of
// 8 up to 1024, x is 16-byte aligned and q 8-byte (int8) or 4-byte (int4)
// aligned; every other input the row body. Returns cudaGetLastError().
extern "C" int dstt_quantize(const void* x, void* q, void* s, long long rows,
                             int D, int g, int bits, int dtype, void* stream) {
  using namespace dstt::quant;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (bits == 8) {
    switch (dtype) {
      case 0: return quantize_dense_t<float, 8>(x, q, s, rows, D, g, st);
      case 1: return quantize_dense_t<__nv_bfloat16, 8>(x, q, s, rows, D, g, st);
      case 2: return quantize_dense_t<__half, 8>(x, q, s, rows, D, g, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0: return quantize_dense_t<float, 4>(x, q, s, rows, D, g, st);
    case 1: return quantize_dense_t<__nv_bfloat16, 4>(x, q, s, rows, D, g, st);
    case 2: return quantize_dense_t<__half, 4>(x, q, s, rows, D, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8 pool's cache write for one layer, K and V in one launch: k, v
// [B, C, Hkv, D] in `dtype` (element strides kb / kc, vb / vc of b and c;
// each (b, c) row of Hkv * D elements contiguous); positions [B, C] and
// table [B, nb] int32 or int64 (pos64, table64); the pool's payload kq /
// vq int8 [N, Hkv, bs, D] and scales ks / vs f32 [N, Hkv, bs, D / g].
// Token (b, c)'s K and V rows quantize into (table[b, pos / bs], h, pos %
// bs) as quantize_int8 does (bit for bit); a position whose block is past
// the table is skipped. x and its strides must keep 16-byte units, the
// payload 8-byte ones, and g must divide 8 or be a multiple of 8 (at most
// 1024). Returns cudaGetLastError().
extern "C" int dstt_quantize_kv_write(
    const void* k, const void* v, long long kb, long long kc, long long vb,
    long long vc, const void* pos, int pos64, const void* table, int table64,
    void* kq, void* vq, void* ks, void* vs, int B, int C, int Hkv, int D,
    int g, int bs, int nb, int dtype, void* stream) {
  using namespace dstt::quant;
  if (dtype < 0 || dtype > 2 || B < 1 || C < 1 || Hkv < 1 || bs < 1 ||
      nb < 1)
    return (int)cudaErrorInvalidValue;
  PoolSite site{};
  const long long rows = (long long)B * C * Hkv;
  const int R = vec_tiling(site.t, 2 * rows * D, D, g);
  const long long esize = dtype == 0 ? 4 : 2;
  const long long strides[4] = {kb, kc, vb, vc};
  bool ok = R > 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(kq) % 8 == 0 &&
            reinterpret_cast<uintptr_t>(vq) % 8 == 0;
  for (long long st : strides) ok = ok && (st * esize) % 16 == 0;
  if (!ok || site.t.groups >= INT_MAX) return (int)cudaErrorInvalidValue;
  site.x[0] = k;
  site.x[1] = v;
  site.sb[0] = kb;
  site.sc[0] = kc;
  site.sb[1] = vb;
  site.sc[1] = vc;
  site.pos = pos;
  site.pos64 = pos64;
  site.table = table;
  site.table64 = table64;
  site.q[0] = static_cast<int8_t*>(kq);
  site.q[1] = static_cast<int8_t*>(vq);
  site.s[0] = static_cast<float*>(ks);
  site.s[1] = static_cast<float*>(vs);
  site.C = C;
  site.Hkv = Hkv;
  site.D = D;
  site.gpr = D / site.t.gt;
  site.per = (unsigned)(rows * site.gpr);
  site.ng = D / g;
  site.bs = bs;
  site.nb = nb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return vec_launch<float, 8>(site, R, st);
    case 1: return vec_launch<__nv_bfloat16, 8>(site, R, st);
    case 2: return vec_launch<__half, 8>(site, R, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The inverse, for `n_leaves` (1 to 32) leaves in one launch: leaf i's
// payload q[i] (n[i] int8, or n[i] / 2 packed bytes for bits 4) and scales
// s[i] (n[i] / g[i] floats) -> out[i], n[i] elements in `dtype`. The caller
// guarantees n[i] >= 1, n[i] % g[i] == 0 and, for bits 4, n[i] even.
// Returns cudaGetLastError().
extern "C" int dstt_dequantize_many(int n_leaves, const void* const* q,
                                    const void* const* s, void* const* out,
                                    const long long* n, const int* g,
                                    int bits, int dtype, void* stream) {
  using namespace dstt::quant;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((bits != 8 && bits != 4) || n_leaves < 1 || n_leaves > kMaxLeaves)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_leaves; ++i)
    if (n[i] < 1 || g[i] < 1 || n[i] % g[i] != 0 || (bits == 4 && n[i] % 2))
      return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return dequantize_bits<float>(n_leaves, q, s, out, n, g, bits, st);
    case 1:
      return dequantize_bits<__nv_bfloat16>(n_leaves, q, s, out, n, g, bits,
                                            st);
    case 2: return dequantize_bits<__half>(n_leaves, q, s, out, n, g, bits, st);
  }
  return (int)cudaErrorInvalidValue;
}
