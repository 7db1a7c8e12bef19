// evoformer_attn.cu — Evoformer attention forward (two additive biases), Hopper.
//
// Replaces the Pallas forward of deepspeed_tpu/ops/pallas/evoformer_attn.py:
// _evo_fwd_pallas (pallas_call :98, kernel _evo_fwd_kernel :37), behind
// the public op evoformer_attention (ops/evoformer_attn.py): attention over
// q/k/v [B, N, S, H, D] with a key-mask bias [B, N, 1, 1, S] and a pair
// bias [B, 1, H, S, S], the [B, N, H, S, S] logits never materialized.
//
// Numerics are the Pallas kernel's (:43-59): fp32 scores, fp32 softmax
// statistics (m from -1e30, keys past S at -inf) and an fp32 P, one
// rounding, to q's dtype, at the end. For bf16 and fp16 both products run
// on the tensor cores, fp32-accurate:
//   * S = Q K^T: q and k are exact in their 16-bit type, so one wgmma with
//     fp32 accumulators gives the exact products; sm_scale is applied to S
//     in fp32 after the product, then the mask and pair biases are added
//     in the reference's order (s * scale + mask + pair).
//   * O += P V: V is exact in 16 bits, P is fp32. P is split in registers
//     into kPieces = 3 pieces of V's type, each one wgmma_rs into the same
//     fp32 accumulator. bf16: p0 = p truncated to its top 8 bits, p1 = (p
//     - p0) truncated, p2 = p - p0 - p1, which has at most 8 bits: p0 + p1
//     + p2 == p exactly, the pieces taken with a byte permute (cheaper
//     than rounding conversions). fp16: p0 = rn(p), p1 = rn(p - p0), p2 =
//     rn(p - p0 - p1); below p ~ 2^-2 the later pieces are subnormal
//     (fp16's normal range ends at 2^-14), which keeps p to an absolute
//     2^-24 per key, far below an fp16 output's step. Two pieces (16
//     bits) were measured too: ~10 % faster, but the share of outputs
//     bit-equal to the plain version's fell from 0.9995 to 0.995
//     (truncated pieces; 0.998 rounded), under chip_smoke's 0.999 floor
//     (PERF.md). The row sum l is summed from the fp32 p.
// fp32 inputs take the SIMT kernel below (namespace simt: fp32 FMAs on the
// CUDA cores, 1-D grid); it is never reached for bf16 or fp16. A
// tensor-core fp32 path would split both operands (or take 3xTF32 with V
// transposed in shared memory); fp32 runs in no path of the port.
//
// What bounds it on the H100, at the AlphaFold shapes (S 256, hd 32, 8 or
// 4 heads, N 128 or 256 rows): per score, 4 hd = 128 flops of products
// against ~12-16 fp32 ALU operations (scale, the two bias adds, max,
// subtract, exp argument, sum, the split into three pieces) and one
// exponential (ex2.approx, ~2 ulp). At the MSA-row shape that is 67 M
// exponentials a call (~17 us on the special-function units at
// ~3.9e12/s), ~1 G ALU operations (~30 us at the fp32 rate), 17 Gflop of
// 16-bit products on the tensor cores (S once, P V once per piece: ~17 us
// at 989 Tflop/s), and 68 MB of q, k, v, out and the biases (~20 us at
// 3.35 TB/s: chip_smoke's bound_ms, by bytes). No one of them dominates;
// the design keeps the bytes at their floor and lets several blocks an SM
// overlap the rest. Measured (PERF.md, tools/evo_ab.py): the loop body is
// ~505 SASS instructions a thread per 64 x 64 tile, an issue bound of
// ~35 us at the MSA-row shape, and the kernel takes ~3x that (~5x the
// bound): a warpgroup's chain (S product, softmax, the twelve P V
// products) is serial, and three
// warpgroups an SM (128 registers each) do not hide its latencies.
// Later work: overlap one tile's P V with the next tile's softmax (about
// 170 registers: two blocks an SM).
//
// The design:
//   * The pair bias [B, H, S, S] is shared by all N MSA rows, and is the
//     largest stream if read per row (N H S^2 elements). A work item is
//     (b, h, 64-query tile, a group of >= kGroup = 8 MSA rows): the producer
//     stages the item's pair slab [64, S] once, in the bias's own dtype
//     (no fp32 copy: widened in registers as the reference's astype), and
//     the consumers run the group's rows one after another against it. So
//     the pair bias moves from device memory or L2 once per group. A slab
//     wider than the window (64 KB: 512 bf16 / 256 fp32 keys) is staged in
//     chunks of that many keys, then once per row and chunk.
//   * A block is one consumer warpgroup (the tile's 64 query rows) and one
//     producer warp, persistent over the items (item_of), several blocks
//     an SM (3 at hd 32): while one computes its softmax another's
//     products run. The grid is 1-D: any B * N * H. The launch sizes the
//     groups (>= 8 rows) so that the items fill the blocks that fit the
//     card in as few rounds as it can: at the paths' shapes 384 items of
//     10-11 rows for 396 block slots (groups of 8 left a second round of
//     116 items).
//   * The producer keeps a 2-stage ring of K and V tiles (TMA, 5-D tensor
//     maps over {D, H, S, N, B}: the op's layout read in place with any
//     strides that are multiples of 16 bytes) and the stage's 64 key-mask
//     values (plain loads in the mask's dtype, widened, published by the
//     stage's 32 arrivals, as flash_bwd.cu stages lse / delta); Q of each
//     row is double-buffered on barriers of its own, the pair window on
//     its own pair (wfull / wempty).
//   * Tiles of 16-bit elements are 64-row panels: hd 64 / 128 as 128-byte
//     rows with the 128-byte swizzle (one or two panels), hd 32 as 64-byte
//     rows with the 64-byte swizzle (sm90.cuh's desc_sw64, a 32-column TMA
//     box): S is m64n64k16 from shared memory (2 k steps at hd 32), O +=
//     P V is m64n{32,64,128}k16 with P as the register operand and V read
//     through the transposed descriptor.
//   * The pair window is TMA boxes of 64 rows x 128 bytes (64 bf16 / fp16
//     keys or 32 fp32 keys) with the 128-byte swizzle, so a warp's reads of
//     8 rows x 4 column pairs hit 32 banks. A pair row of S elements is
//     16-byte aligned only when S * itemsize % 16 == 0: otherwise (S 100
//     in fp16, say) the producer warp stages the window with plain loads
//     into the same swizzled layout, published by its 32 arrivals.
//   * Masks run only on a row's last key tile where it crosses S (-inf
//     past S); rows past S arrive as zeros and are never written. The
//     score epilogue is a template on (edge, pair), tested once per tile.
//   * O leaves from registers, two elements a store, in the op's layout.
//   * Kernels live in dstt::evo / dstt::simt: nvcc gives a file's unnamed
//     namespaces one name, and sm90.cuh's sits in it.
// Shared memory at hd 32, S 256, bf16 pair: Q 2 x 4 KB, ring 2 x 8 KB,
// window 32 KB, ~58 KB a block.

#include "sm90.cuh"

namespace dstt {
namespace evo {
namespace {

using namespace dstt::sm90;

constexpr int BM = 64, BK = 64;          // query rows / keys of a tile
constexpr int STAGES = 2;                // K/V ring stages
constexpr int kThreads = 160;            // consumer warpgroup + producer warp
constexpr int kGroup = 8;                // least MSA rows of a work item
constexpr int kPieces = 3;               // 16-bit pieces of P
constexpr int kWindowBytes = 64 * 1024;  // the pair window's capacity
constexpr int kBox = 64 * 128;           // one 64-row x 128-byte window box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;        // the softmax max's start

// 2^x on the special-function unit (exp2f adds range handling that the
// softmax, whose arguments are <= 0 and whose results below 2^-126 are
// noise, does not need)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct EvoParams {
  CUtensorMap tq, tk, tv;        // 5-D {D, H, S, N, B}
  CUtensorMap tpair;             // 4-D {S, S, Hp, Bp}, box {128 B, 64, 1, 1}
  void* o;                       // out, element strides (b, n, s, h)
  long long o_sb, o_sn, o_ss, o_sh;
  const void* mask;              // [S] rows at b * mask_sb + n * mask_sn
  long long mask_sb, mask_sn;
  const void* pair;              // [S, S] slabs at b * pair_sb + h * pair_sh
  long long pair_sb, pair_sh;
  int mask_dtype;                // 0 fp32, 1 bf16, 2 fp16, -1 no mask
  int has_pair, pair_tma;        // pair_tma: the window comes by TMA
  int B, N, S, H;
  int n_qt, n_k, n_groups, n_items;
  int kc_tiles, n_chunks;        // key tiles a window chunk, chunks a row
  float scale;
};

// Shared memory: two Q buffers, the ring (K then V a stage), the stages'
// mask values, the barriers, then the pair window (size set at launch).
template <int HD>
struct Layout {
  static constexpr int RB = HD * 2 >= 128 ? 128 : 64;  // bytes a panel row
  static constexpr int NP = HD * 2 / RB;               // panels a tile
  static constexpr int PANEL_B = 64 * RB;
  static constexpr int KPR = RB / 32;                  // k16 steps a row
  static constexpr int TILE = NP * PANEL_B;            // 64 rows x HD
  static constexpr int q_off = 0;
  static constexpr int ring_off = 2 * TILE;
  static constexpr int mask_off = ring_off + STAGES * 2 * TILE;
  static constexpr int bar_off = mask_off + STAGES * BK * 4;
  static constexpr int win_off = (bar_off + (2 * STAGES + 6) * 8 + 1023)
                                 / 1024 * 1024;
  __device__ static uint64_t desc(const void* p, uint32_t lbo = PANEL_B) {
    if constexpr (RB == 128)
      return desc_sw128(p, lbo);
    else
      return desc_sw64(p, lbo);
  }
};

struct Item {
  int b, h, q0, n0, rows;
};

// Work item r: q tiles of one (b, h, row group) are neighbours, so blocks
// running at once share the group's K and V in L2. The N rows split into
// n_groups groups of floor or ceil(N / n_groups) >= kGroup rows.
__device__ __forceinline__ Item evo_item(const EvoParams& p, int r) {
  Item it;
  const int qt = r % p.n_qt;
  int rest = r / p.n_qt;
  const int g = rest % p.n_groups;
  rest /= p.n_groups;
  it.h = rest % p.H;
  it.b = rest / p.H;
  it.q0 = qt * BM;
  it.n0 = (int)((long long)g * p.N / p.n_groups);
  it.rows = (int)((long long)(g + 1) * p.N / p.n_groups) - it.n0;
  return it;
}

// Byte offset of (row r, column c) in a window of 128-byte-row boxes of
// PT, 128-byte swizzle: the box c / (128 / size), its 16-byte chunk
// XOR-ed with the row, as TMA writes it.
template <typename PT>
__device__ __forceinline__ int win_byte(int r, int c) {
  constexpr int PER = 128 / sizeof(PT);
  const int byte = (c % PER) * (int)sizeof(PT);
  return (c / PER) * kBox + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4)
         + (byte & 15);
}

// Two neighbouring pair values of tile row r, tile columns 8 j + 2 qi and
// 8 j + 2 qi + 1 (win_byte's layout), widened; Wt is the window box that
// holds the tile's first key. j is a compile-time constant in the
// unrolled score loop, so each read is an XOR and an add.
template <typename PT>
__device__ __forceinline__ float2 tile_pair(const unsigned char* Wt, int r,
                                            int j, int qi) {
  if constexpr (std::is_same<PT, float>::value) {
    // 32 keys a box: box j / 4, 16-byte chunk 2 (j % 4) + qi / 2
    const int chunk = 2 * (j & 3) + (qi >> 1);
    return *reinterpret_cast<const float2*>(
        Wt + (j >> 2) * kBox + r * 128 + ((chunk ^ (r & 7)) << 4)
        + 8 * (qi & 1));
  } else {
    // 64 keys a box: chunk j
    float x, y;
    unpack2<PT>(*reinterpret_cast<const uint32_t*>(
                    Wt + r * 128 + ((j ^ (r & 7)) << 4) + 4 * qi),
                x, y);
    return make_float2(x, y);
  }
}

__device__ __forceinline__ float mask_value(const EvoParams& p, long long i) {
  if (p.mask_dtype == 0) return static_cast<const float*>(p.mask)[i];
  if (p.mask_dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p.mask)[i]);
  return __half2float(static_cast<const __half*>(p.mask)[i]);
}

// The producer's window load for the chunk of keys [c0, c0 + nt * 64) of
// item `it`: by TMA (lane 0 issues the boxes; boxes wholly past S are not
// issued) or, for a pair whose rows TMA cannot read, by the warp's plain
// loads into the same swizzled layout. Every lane arrives on wfull.
template <typename PT>
__device__ __forceinline__ void load_window(const EvoParams& p,
                                            unsigned char* W, uint64_t* wfull,
                                            const Item& it, int c0, int nt,
                                            int lane) {
  constexpr int PER = 128 / sizeof(PT);
  const int bb = p.pair_sb ? it.b : 0, hb = p.pair_sh ? it.h : 0;
  if (p.pair_tma) {
    if (lane == 0) {
      const int boxes = nt * BK / PER;
      int live = 0;
      for (int j = 0; j < boxes; ++j) live += c0 + j * PER < p.S;
      mbar_expect_tx(wfull, live * kBox);
      for (int j = 0; j < live; ++j)
        tma_load_4d(W + j * kBox, &p.tpair, wfull, c0 + j * PER, it.q0, hb,
                    bb);
    } else {
      mbar_arrive(wfull);
    }
    return;
  }
  const PT* slab = static_cast<const PT*>(p.pair) + bb * p.pair_sb
                   + hb * p.pair_sh;
  const int cols = nt * BK, S = p.S;
  for (int i = lane; i < BM * cols; i += 32) {
    const int r = i / cols, c = i % cols;
    const int qpos = it.q0 + r, kpos = c0 + c;
    PT v;
    if (qpos < S && kpos < S)
      v = slab[(long long)qpos * S + kpos];
    else
      v = PT(0.f);
    *reinterpret_cast<PT*>(W + win_byte<PT>(r, c)) = v;
  }
  mbar_arrive(wfull);
}

// One K/V tile for the consumer warpgroup's 64 query rows: S = Q K^T on
// wgmma, the scores (s * scale + mask + pair, -inf past S where EDGE), the
// online softmax in registers, P split into kPieces 16-bit pieces, O +=
// piece V for each. A thread holds rows rl0 (e < 2) and rl0 + 8 of its
// accumulators, columns 8 j + 2 qi + (e & 1).
template <typename T, int HD, typename PT, bool EDGE, bool PAIR>
__device__ __forceinline__ void evo_tile(const unsigned char* Qs,
                                         const unsigned char* Ks,
                                         const unsigned char* Vs,
                                         const float* mrow,
                                         const unsigned char* Wt, int k0,
                                         int S, float scale, int rl0, int qi,
                                         float (&o)[HD / 2], float& m0,
                                         float& m1, float& l0, float& l1) {
  using L = Layout<HD>;
  float sc[32];
  fence_regs(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / L::KPR) * L::PANEL_B + (kk % L::KPR) * 32;
    wgmma_ss<T>(sc, L::desc(Qs + off), L::desc(Ks + off), kk > 0);
  }
  wg_commit();
  wg_wait0();
  fence_regs(sc);

  // scores, in the reference's order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * qi;
    const float2 mk = *reinterpret_cast<const float2*>(mrow + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x = __fmul_rn(sc[4 * j + 2 * half], scale) + mk.x;
      float y = __fmul_rn(sc[4 * j + 2 * half + 1], scale) + mk.y;
      if (PAIR) {
        const float2 pb = tile_pair<PT>(Wt, rl0 + 8 * half, j, qi);
        x += pb.x;
        y += pb.y;
      }
      if (EDGE) {
        if (k0 + col >= S) x = -INFINITY;
        if (k0 + col + 1 >= S) y = -INFINITY;
      }
      sc[4 * j + 2 * half] = x;
      sc[4 * j + 2 * half + 1] = y;
    }
  }

  // online softmax: rows rl0 (e < 2) and rl0 + 8 (e >= 2); m starts at the
  // finite -1e30 and every tile has a key inside S, so no -inf reaches m
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float a0 = ex2((m0 - mx0) * kLog2e);
  const float a1 = ex2((m1 - mx1) * kLog2e);
  m0 = mx0;
  m1 = mx1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[4 * j] = ex2((sc[4 * j] - mx0) * kLog2e);
    sc[4 * j + 1] = ex2((sc[4 * j + 1] - mx0) * kLog2e);
    sc[4 * j + 2] = ex2((sc[4 * j + 2] - mx1) * kLog2e);
    sc[4 * j + 3] = ex2((sc[4 * j + 3] - mx1) * kLog2e);
    s0 += sc[4 * j] + sc[4 * j + 1];
    s1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * a0 + s0;
  l1 = l1 * a1 + s1;

  // P in kPieces pieces of T, each the A fragments of a P V product: k
  // slice kk is accumulator columns 16 kk .. 16 kk + 15; sc keeps the
  // remainder
  uint32_t pa[kPieces][BK / 16][4];
#pragma unroll
  for (int pc = 0; pc < kPieces; ++pc)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[8 * kk + 2 * e];
        float& y = sc[8 * kk + 2 * e + 1];
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          // truncated pieces: p0 + p1 + p2 == p exactly
          const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
          pa[pc][kk][e] = __byte_perm(xb, yb, 0x7632);
          if (pc + 1 < kPieces) {
            x -= __uint_as_float(xb & 0xFFFF0000u);
            y -= __uint_as_float(yb & 0xFFFF0000u);
          }
        } else {
          const uint32_t u = pack2<T>(x, y);
          pa[pc][kk][e] = u;
          if (pc + 1 < kPieces) {
            float ux, uy;
            unpack2<T>(u, ux, uy);
            x -= ux;
            y -= uy;
          }
        }
      }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }

  // O += piece V, the smallest piece first
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int pc = kPieces - 1; pc >= 0; --pc)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<T>(o, pa[pc][kk], L::desc(Vs + kk * 16 * L::RB), 1);
  wg_commit();
  wg_wait0();
  fence_regs(o);
}

template <typename T, int HD, typename PT>
__global__ void __launch_bounds__(kThreads, HD == 32 ? 3 : 2)
evo_fwd_kernel(__grid_constant__ const EvoParams p) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem + L::q_off;
  unsigned char* ring = smem + L::ring_off;       // stage s: K, then V
  float* masks = reinterpret_cast<float*>(smem + L::mask_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;               // [2]
  uint64_t* qempty = qfull + 2;                   // [2]
  uint64_t* wfull = qempty + 2;
  uint64_t* wempty = wfull + 1;
  unsigned char* W = smem + L::win_off;
  const int S = p.S, n_k = p.n_k, kc = p.kc_tiles;
  const bool has_pair = p.has_pair, per_row = p.n_chunks > 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);     // the producer's lanes (and the bytes)
      mbar_init(&empty[s], 128);
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&qfull[qb], 1);
      mbar_init(&qempty[qb], 128);
    }
    mbar_init(wfull, 32);
    mbar_init(wempty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---------------- producer: the whole of warp 4 ----------------
    int t = 0, qn = 0, wn = 0;     // ring position, Q loads, window loads
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= p.n_items) break;
      const Item it = evo_item(p, r);
      for (int i = 0; i < it.rows; ++i, ++qn) {
        const int n = it.n0 + i, qb = qn & 1;
        if (lane == 0) {
          mbar_wait(&qempty[qb], ((qn >> 1) & 1) ^ 1);
          mbar_expect_tx(&qfull[qb], L::TILE);
#pragma unroll
          for (int pp = 0; pp < L::NP; ++pp)
            tma_load_5d(Qs + qb * L::TILE + pp * L::PANEL_B, &p.tq,
                        &qfull[qb], 64 * pp, it.h, it.q0, n, it.b);
        }
        const long long mrow = it.b * p.mask_sb + n * p.mask_sn;
        for (int kt = 0; kt < n_k; ++kt, ++t) {
          const int s = t % STAGES, ph = (t / STAGES) & 1;
          // this stage's mask values, two a lane, read before the wait
          float mv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = kt * BK + lane + 32 * c;
            mv[c] = p.mask_dtype >= 0 && kpos < S ? mask_value(p, mrow + kpos)
                                                  : 0.f;
          }
          mbar_wait(&empty[s], ph ^ 1);
          masks[s * BK + lane] = mv[0];
          masks[s * BK + lane + 32] = mv[1];
          if (lane == 0) {
            unsigned char* Ks = ring + s * 2 * L::TILE;
            mbar_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
            for (int pp = 0; pp < L::NP; ++pp) {
              tma_load_5d(Ks + pp * L::PANEL_B, &p.tk, &full[s], 64 * pp,
                          it.h, kt * BK, n, it.b);
              tma_load_5d(Ks + L::TILE + pp * L::PANEL_B, &p.tv, &full[s],
                          64 * pp, it.h, kt * BK, n, it.b);
            }
          } else {
            mbar_arrive(&full[s]);
          }
          // the pair window chunk that opens at this tile: once an item,
          // or once a row and chunk for a slab wider than the window
          if (has_pair && kt % kc == 0 && (per_row || i == 0)) {
            mbar_wait(wempty, (wn & 1) ^ 1);
            load_window<PT>(p, W, wfull, it, kt * BK, min(kc, n_k - kt),
                            lane);
            ++wn;
          }
        }
      }
    }
  } else {
    // ---------------- consumers: one warpgroup, the tile's 64 rows -------
    const int qi = lane & 3;
    const int rl0 = 16 * warp + (lane >> 2), rl1 = rl0 + 8;
    const float scale = p.scale;
    const bool edge_last = S % BK != 0;
    int t = 0, qn = 0, wn = 0;
    for (int w = 0;; ++w) {
      const int r = item_of(w, blockIdx.x, gridDim.x);
      if (r >= p.n_items) break;
      const Item it = evo_item(p, r);
      const int qpos0 = it.q0 + rl0, qpos1 = it.q0 + rl1;
      for (int i = 0; i < it.rows; ++i, ++qn) {
        const int n = it.n0 + i, qb = qn & 1;
        float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
        float o[HD / 2];
#pragma unroll
        for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
        mbar_wait(&qfull[qb], (qn >> 1) & 1);
        const unsigned char* Qg = Qs + qb * L::TILE;
        int c0 = 0;
        for (int kt = 0; kt < n_k; ++kt, ++t) {
          const int s = t % STAGES, ph = (t / STAGES) & 1;
          if (has_pair && kt % kc == 0) {
            c0 = kt * BK;
            if (per_row || i == 0) {
              mbar_wait(wfull, wn & 1);
              ++wn;
            }
          }
          mbar_wait(&full[s], ph);
          const unsigned char* Ks = ring + s * 2 * L::TILE;
          const unsigned char* Vs = Ks + L::TILE;
          const float* mrow = masks + s * BK;
          const int k0 = kt * BK;
          // the window box that holds this tile's first key
          const unsigned char* Wt =
              W + (k0 - c0) / (128 / (int)sizeof(PT)) * kBox;
          const bool edge = edge_last && kt == n_k - 1;
#define EVO_TILE(E, P)                                                     \
  evo_tile<T, HD, PT, E, P>(Qg, Ks, Vs, mrow, Wt, k0, S, scale, rl0, qi, o, \
                            m0, m1, l0, l1)
          if (has_pair) {
            if (edge)
              EVO_TILE(true, true);
            else
              EVO_TILE(false, true);
          } else {
            if (edge)
              EVO_TILE(true, false);
            else
              EVO_TILE(false, false);
          }
#undef EVO_TILE
          mbar_arrive(&empty[s]);
          // the window is done with at its chunk's end (per row and chunk)
          // or at the item's last row
          if (has_pair && (kt == n_k - 1 || (kt + 1) % kc == 0)
              && (per_row || i == it.rows - 1))
            mbar_arrive(wempty);
        }
        mbar_arrive(&qempty[qb]);

        // out = O / l, rows inside S, in q's dtype
        float i0, i1;
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        i0 = 1.f / fmaxf(l0, 1e-30f);
        i1 = 1.f / fmaxf(l1, 1e-30f);
        T* ob = static_cast<T*>(p.o) + it.b * p.o_sb + n * p.o_sn
                + it.h * p.o_sh;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + 2 * qi;
          if (qpos0 < S)
            *reinterpret_cast<uint32_t*>(ob + qpos0 * p.o_ss + col) =
                pack2<T>(o[4 * j] * i0, o[4 * j + 1] * i0);
          if (qpos1 < S)
            *reinterpret_cast<uint32_t*>(ob + qpos1 * p.o_ss + col) =
                pack2<T>(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
        }
      }
    }
  }
}

// The pair [Bp, Hp, S, S] (contiguous rows, slab strides pair_sb / pair_sh,
// 0 where it broadcasts) as a 4-D map {S (k), S (q), Hp, Bp}, box {128
// bytes of keys, 64, 1, 1}, 128-byte swizzle.
template <typename PT>
int encode_pair(CUtensorMap* map, const void* pair, int Bp, int Hp, int S,
                long long sb, long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  constexpr int es = sizeof(PT);
  const cuuint64_t dims[4] = {(cuuint64_t)S, (cuuint64_t)S, (cuuint64_t)Hp,
                              (cuuint64_t)Bp};
  const cuuint64_t strides[3] = {(cuuint64_t)S * es, tma_stride(sh * es, Hp),
                                 tma_stride(sb * es, Bp)};
  const cuuint32_t box[4] = {128 / es, BM, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt =
      std::is_same<PT, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : std::is_same<PT, __nv_bfloat16>::value
          ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
          : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult rc = fn(map, dt, 4, const_cast<void*>(pair), dims, strides,
                         box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + (int)rc;
}

// Launch: the row groups sized for the blocks that fit the card at once
// (the fewest rows any block walks: rounds x rows a group), then as many
// persistent blocks as that many rounds need, every block walking the
// same number of items.
template <typename T, int HD, typename PT>
int launch(EvoParams p, cudaStream_t stream) {
  using L = Layout<HD>;
  const int win = p.has_pair ? p.kc_tiles * BK * BM * (int)sizeof(PT) : 0;
  const int smem = L::win_off + win + 1024;
  auto kernel = evo_fwd_kernel<T, HD, PT>;
  // per device: the attribute (set once, to the most any launch asks) and
  // the blocks an SM at the last shared-memory size
  static int sms_of[64] = {}, smem_of[64] = {}, per_sm_of[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              L::win_off + kWindowBytes + 1024);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms_of[dev],
                                  cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (smem_of[dev] != smem) {
    int per_sm = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kThreads, smem);
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    smem_of[dev] = smem;
    per_sm_of[dev] = per_sm;
  }
  const long long slots = (long long)per_sm_of[dev] * sms_of[dev];
  const long long tiles = (long long)p.B * p.H * p.n_qt;
  long long best = -1;
  for (int ng = 1; ng <= (p.N >= 2 * kGroup ? p.N / kGroup : 1); ++ng) {
    const long long cost = (tiles * ng + slots - 1) / slots
                           * ((p.N + ng - 1) / ng);
    if (best < 0 || cost < best) {
      best = cost;
      p.n_groups = ng;
    }
  }
  const long long items = tiles * p.n_groups;
  if (items > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  p.n_items = (int)items;
  const long long rounds = (p.n_items + slots - 1) / slots;
  const int blocks = (int)((p.n_items + rounds - 1) / rounds);
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int run(const void* q, const void* k, const void* v, void* o,
        const void* mask, const void* pair, int B, int N, int S, int H,
        const long long* st, long long mask_sb, long long mask_sn,
        long long pair_sb, long long pair_sh, int mask_dtype, int pair_dtype,
        float scale, cudaStream_t stream) {
  EvoParams p{};
  int rc = encode_5d<T>(&p.tq, q, B, N, S, H, HD, st[0], st[1], st[2], st[3]);
  if (!rc) rc = encode_5d<T>(&p.tk, k, B, N, S, H, HD, st[4], st[5], st[6],
                             st[7]);
  if (!rc) rc = encode_5d<T>(&p.tv, v, B, N, S, H, HD, st[8], st[9], st[10],
                             st[11]);
  if (rc) return rc;
  const int pair32 = pair_dtype == 0;
  const int es = pair32 ? 4 : 2;
  p.has_pair = pair != nullptr;
  if (p.has_pair) {
    // the window by TMA where every row and slab starts 16-byte aligned
    p.pair_tma = (long long)S * es % 16 == 0
                 && reinterpret_cast<uintptr_t>(pair) % 16 == 0
                 && pair_sb * es % 16 == 0 && pair_sh * es % 16 == 0;
    if (p.pair_tma) {
      const int Bp = pair_sb ? B : 1, Hp = pair_sh ? H : 1;
      rc = pair32 ? encode_pair<float>(&p.tpair, pair, Bp, Hp, S, pair_sb,
                                       pair_sh)
                  : encode_pair<T>(&p.tpair, pair, Bp, Hp, S, pair_sb,
                                   pair_sh);
      if (rc) return rc;
    }
  }
  p.o = o;
  p.o_sb = st[12];
  p.o_sn = st[13];
  p.o_ss = st[14];
  p.o_sh = st[15];
  p.mask = mask;
  p.mask_sb = mask_sb;
  p.mask_sn = mask_sn;
  p.mask_dtype = mask ? mask_dtype : -1;
  p.pair = pair;
  p.pair_sb = pair_sb;
  p.pair_sh = pair_sh;
  p.B = B;
  p.N = N;
  p.S = S;
  p.H = H;
  p.n_qt = (S + BM - 1) / BM;
  p.n_k = (S + BK - 1) / BK;
  if ((long long)B * N * H == 0) return 0;
  p.kc_tiles = kWindowBytes / (BK * BM * es);
  if (p.kc_tiles > p.n_k) p.kc_tiles = p.n_k;
  p.n_chunks = (p.n_k + p.kc_tiles - 1) / p.kc_tiles;
  p.scale = scale;
  if (p.has_pair && pair32) return launch<T, HD, float>(p, stream);
  return launch<T, HD, T>(p, stream);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             const void* mask, const void* pair, int B, int N, int S, int H,
             const long long* st, long long mask_sb, long long mask_sn,
             long long pair_sb, long long pair_sh, int mask_dtype,
             int pair_dtype, float scale, cudaStream_t s) {
#define EVO(HD) run<T, HD>(q, k, v, o, mask, pair, B, N, S, H, st, mask_sb, \
                           mask_sn, pair_sb, pair_sh, mask_dtype,             \
                           pair_dtype, scale, s)
  if (D == 32) return EVO(32);
  if (D == 64) return EVO(64);
  if (D == 128) return EVO(128);
#undef EVO
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace evo

// ---------------------------------------------------------------------------
// fp32 inputs: fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------
//
// One block (128 threads) per (64-query tile, b * n * h) on a 1-D grid; the
// loop over 64-key tiles takes the place of the TPU's fori_loop, with K and
// V staged in shared memory. An 8 x 16 thread grid: thread (ty, tx)
// computes the 8 x 4 scores of rows 8 ty .. 8 ty + 7 and columns tx + 16 j;
// the online softmax reduces a row across the 16 threads that share it, P
// goes to shared memory, and the same grid accumulates O [8 rows, D / 16
// columns] in registers. q is scaled in fp32 before the product; the fp32
// biases are read from device memory by index.
namespace simt {
namespace {

constexpr int BQ = 64, BK = 64, kThreads = 128;
constexpr float kNegInf = -1e30f;

// (batch, row, seq, head) element strides of q, k, v, o.
struct Strides {
  long long s[16];
};

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long s_st, int r0, int S,
                                          float mult, int tid) {
  for (int i = tid; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < S ? src[(long long)(r0 + r) * s_st + c] * mult : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
evo_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    const float* __restrict__ mask,
                    const float* __restrict__ pair, int N, int S, int H,
                    int n_qt, const Strides strides, long long mask_sb,
                    long long mask_sn, long long pair_sb, long long pair_sh,
                    float scale) {
  constexpr int LD = D + 1, LDP = BK + 1, DJ = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [64][D + 1], scaled
  float* Ks = Qs + BQ * LD;         // [64][D + 1]
  float* Vs = Ks + BK * LD;         // [64][D]
  float* Ps = Vs + BK * D;          // [64][65]

  const long long* st = strides.s;
  const long long bnh = blockIdx.x / n_qt;
  const int h = bnh % H, n = (bnh / H) % N, b = bnh / ((long long)H * N);
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + b * st[0] + n * st[1] + h * st[3];
  const float* kb = k + b * st[4] + n * st[5] + h * st[7];
  const float* vb = v + b * st[8] + n * st[9] + h * st[11];
  const float* mask_bn = mask ? mask + b * mask_sb + n * mask_sn : nullptr;
  const float* pair_bh = pair ? pair + b * pair_sb + h * pair_sh : nullptr;

  load_tile<D>(Qs, qb, st[2], q0, S, scale, tid);
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
    load_tile<D>(Ks, kb, st[6], k0, S, 1.f, tid);
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      Vs[r * D + c] = k0 + r < S ? vb[(long long)(k0 + r) * st[10] + c] : 0.f;
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

  float* ob = o + b * st[12] + n * st[13] + h * st[15];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + 8 * ty + i;
    if (qpos >= S) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long long)qpos * st[14] + tx + 16 * j] = o_acc[i][j] / l;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const float* mask, const float* pair, int B, int N, int S, int H,
           const Strides& st, long long mask_sb, long long mask_sn,
           long long pair_sb, long long pair_sh, float scale,
           cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BQ * (D + 1) + BK * D + BQ * (BK + 1)) * 4;
  cudaFuncSetAttribute(evo_fwd_fp32_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int n_qt = (S + BQ - 1) / BQ;
  const long long blocks = (long long)n_qt * B * N * H;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  evo_fwd_fp32_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), mask, pair, N, S,
      H, n_qt, st, mask_sb, mask_sn, pair_sb, pair_sh, scale);
  return (int)cudaGetLastError();
}

int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             const void* mask, const void* pair, int B, int N, int S, int H,
             const long long* strides, long long mask_sb, long long mask_sn,
             long long pair_sb, long long pair_sh, float scale,
             cudaStream_t s) {
  Strides st;
  for (int i = 0; i < 16; ++i) st.s[i] = strides[i];
  const float* m = static_cast<const float*>(mask);
  const float* pb = static_cast<const float*>(pair);
#define EVO(HD) launch<HD>(q, k, v, o, m, pb, B, N, S, H, st, mask_sb, \
                           mask_sn, pair_sb, pair_sh, scale, s)
  if (D == 32) return EVO(32);
  if (D == 64) return EVO(64);
  if (D == 128) return EVO(128);
#undef EVO
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace simt
}  // namespace dstt

// q / k / v / o [B, N, S, H, D] with a contiguous last dim: `strides` (host
// memory) holds 16 element strides, (batch, row, seq, head) for q, k, v, o
// in that order; for bf16 / fp16 the others are multiples of 16 bytes
// and the bases 16-byte aligned (the TMA maps). mask: [S] rows at element
// offset b * mask_sb + n * mask_sn, or null; pair: row-major [S, S] slabs
// at b * pair_sb + h * pair_sh, or null (a stride is 0 where the bias
// broadcasts). dtype, mask_dtype, pair_dtype: 0 float32, 1 bfloat16, 2
// float16; for fp32 q both biases are fp32, otherwise the mask is any of
// the three and the pair q's dtype or fp32. D 32, 64 or 128. Returns
// cudaGetLastError(), or 10000 + the CUresult of a failed tensor-map
// encode.
extern "C" int dstt_evoformer_fwd(const void* q, const void* k, const void* v,
                                  void* o, const void* mask, const void* pair,
                                  int B, int N, int S, int H, int D,
                                  const long long* strides, long long mask_sb,
                                  long long mask_sn, long long pair_sb,
                                  long long pair_sh, int mask_dtype,
                                  int pair_dtype, float scale, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((mask && mask_dtype != 0) || (pair && pair_dtype != 0))
      return (int)cudaErrorInvalidValue;
    return dstt::simt::dispatch(D, q, k, v, o, mask, pair, B, N, S, H,
                                strides, mask_sb, mask_sn, pair_sb, pair_sh,
                                scale, s);
  }
  if (pair && pair_dtype != 0 && pair_dtype != dtype)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return dstt::evo::dispatch<__nv_bfloat16>(
        D, q, k, v, o, mask, pair, B, N, S, H, strides, mask_sb, mask_sn,
        pair_sb, pair_sh, mask_dtype, pair_dtype, scale, s);
  if (dtype == 2)
    return dstt::evo::dispatch<__half>(
        D, q, k, v, o, mask, pair, B, N, S, H, strides, mask_sb, mask_sn,
        pair_sb, pair_sh, mask_dtype, pair_dtype, scale, s);
  return (int)cudaErrorInvalidValue;
}
