// sm90.cuh — the Hopper building blocks of the attention kernels
// (attn_fwd.cuh's two forwards; the flash and block-sparse backward
// passes, through attn_bwd.cuh; the Evoformer forward) and of the norms'
// row ring (norms.cu): PTX wrappers for mbarriers, TMA copies (tensor
// loads, stores, reduce-adds; 1-D bulk loads) and wgmma, the
// shared-memory descriptor that matches TMA's 128-byte swizzle, and the
// host side that launches the kernels over their work items and encodes
// [B, T, H, D] views as tensor maps.
//
// Tiles of 16-bit elements sit in shared memory as 64-column panels of 64
// rows x 128 bytes (PANEL bytes each, 1024-byte aligned), with the 128-byte
// swizzle, as a TMA copy of one {64, 1, 64, 1} box writes them and as the
// wgmma descriptor reads them. One tile is read two ways:
//   * K-major (the reduction runs along the 128-byte rows): the A or B
//     operand of a score-shaped product X Y^T, k slice kk at
//     panel kk / 4, byte offset 32 (kk % 4);
//   * transposed (the reduction runs down the rows): the B operand of an
//     accumulating product P Y, k slice kk at row 16 kk, the next
//     64-column panel `lbo` = PANEL bytes on.
// A 32-column tile of 16-bit elements (head dim 32) is one panel of 64
// rows x 64 bytes with the 64-byte swizzle instead (`desc_sw64`, a TMA box
// of 32 columns, `encode_5d`): the same two reads, with 512-byte 8-row
// core groups.
#pragma once

#include <cuda.h>
#include <type_traits>

#include "common.cuh"

namespace dstt {
namespace sm90 {
// Internal linkage: each kernel library that includes this header keeps
// its own copies.
namespace {

constexpr int PANEL = 64 * 128;        // one [64 rows x 128 B] swizzled panel
// a failed tensor-map encode returns kEncodeError + its CUresult
constexpr int kEncodeError = 10000;

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of `parity` has completed. A wait that has not
// completed after 2^26 tries (seconds; a stage takes microseconds) traps,
// so a broken ring fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile("{\n\t.reg .pred P1;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, P1;\n\t}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// 1-D bulk copy of `bytes` from device memory to shared memory, completing
// on `bar` (whose phase expects the bytes: mbar_expect_tx). Both addresses
// 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)),
         "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// dst (a box of the tensor map at the coordinates) += the shared-memory
// tile at src, an fp32 reduction in L2 (bulk group: commit, then wait for
// the read before src is written again).
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// wgmma shared-memory descriptor of 128-byte-swizzled panels (base 1024-
// byte aligned): address >> 4; the leading byte offset `lbo`; the stride
// byte offset 1024 (the next 8-row core group: along M/N for a K-major
// operand, along K for a transposed one); layout type 1 = 128-byte
// swizzle. The leading offset is unused for K-major operands at k16 and
// for a 64-wide transposed operand; a 128-wide transposed one steps to its
// second 64-column panel by it.
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo = 1024) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// The same for panels of 64-byte rows with the 64-byte swizzle (layout type
// 2): 8-row core groups 512 bytes apart (base 512-byte aligned); `lbo`
// steps a transposed operand to its next 32-column panel.
__device__ __forceinline__ uint64_t desc_sw64(const void* p,
                                              uint32_t lbo = 512) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(512 >> 4) << 32)
         | (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running (groups finish
// in the order they were committed).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait0() { wg_wait<0>(); }

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define DSTT_ACC16                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define DSTT_ACC16_OPS(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d[64 x 32] += A[64 x 16] (registers) B[16 x 32], B N-major in shared
// memory (transpose bit set).
#define DSTT_WGMMA_RS32(TY)                                                \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %21, 0;\n\t"          \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
               DSTT_ACC16 ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n\t}\n"\
               : DSTT_ACC16_OPS(d)                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(accumulate))

#define DSTT_ACC32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define DSTT_ACC32_OPS(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
  "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
  "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
#define DSTT_WGMMA_SS(TY)                                                  \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"          \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
               DSTT_ACC32 ", %32, %33, p, 1, 1, 0, 0;\n\t}\n"              \
               : DSTT_ACC32_OPS(d)                                         \
               : "l"(da), "l"(db), "r"(accumulate))

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64], B N-major in shared
// memory (transpose bit set).
#define DSTT_WGMMA_RS(TY)                                                  \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"          \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
               DSTT_ACC32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}\n"\
               : DSTT_ACC32_OPS(d)                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(accumulate))

#define DSTT_ACC64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"
#define DSTT_ACC64_OPS(d)                                                  \
  DSTT_ACC32_OPS(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),         \
  "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),         \
  "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),         \
  "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
  "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 128] += A[64 x 16] (registers) B[16 x 128], B N-major in shared
// memory: two 64-column panels, `lbo` bytes apart.
#define DSTT_WGMMA_RS128(TY)                                               \
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"          \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "\
               DSTT_ACC64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}\n"\
               : DSTT_ACC64_OPS(d)                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    DSTT_WGMMA_SS("bf16");
  } else {
    DSTT_WGMMA_SS("f16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    DSTT_WGMMA_RS32("bf16");
  } else {
    DSTT_WGMMA_RS32("f16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    DSTT_WGMMA_RS("bf16");
  } else {
    DSTT_WGMMA_RS("f16");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    DSTT_WGMMA_RS128("bf16");
  } else {
    DSTT_WGMMA_RS128("f16");
  }
}

#undef DSTT_WGMMA_SS
#undef DSTT_WGMMA_RS32
#undef DSTT_WGMMA_RS
#undef DSTT_WGMMA_RS128
#undef DSTT_ACC64_OPS
#undef DSTT_ACC64
#undef DSTT_ACC32_OPS
#undef DSTT_ACC32
#undef DSTT_ACC16_OPS
#undef DSTT_ACC16

// Two fp32 values narrowed to T, packed low (x) and high (y) into 32 bits.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The two fp32 values of a pack2 word, widened back.
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t u, float& x, float& y) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    x = __uint_as_float(u << 16);
    y = __uint_as_float(u & 0xFFFF0000u);
  } else {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u));
    x = f.x;
    y = f.y;
  }
}

// The i-th work item of persistent block `blk` among `nblk`: rounds of
// nblk items, walked forward and backward in turn, so that the longest
// items (first in the walk) spread over the blocks.
__device__ __forceinline__ int item_of(int i, int blk, int nblk) {
  return i * nblk + ((i & 1) ? nblk - 1 - blk : blk);
}

// ---------------------------------------------------------------------------
// host side: launches
// ---------------------------------------------------------------------------

// Launch `Kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) over `items` work items: as many persistent blocks as fit the
// card at once, at most one per item, or (`persistent` false) one block per
// item. Once per device it sets the kernel's shared-memory attribute to
// `smem_max`, the most any of its launches asks for; how many blocks fit is
// found once per (threads, smem) and remembered for the last kFits pairs
// asked on the device (a kernel's callers repeat a few shapes: a bias or
// none, a norm's row width).
template <auto Kernel, typename Params>
int launch_items(const Params& p, long long items, int threads, int smem,
                 int smem_max, bool persistent, cudaStream_t stream) {
  struct Fit {
    int threads, smem, grid;
  };
  constexpr int kFits = 4;
  static Fit fits[64][kFits] = {};
  static int found[64] = {};   // pairs found on the device so far
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  int grid = 0;
  for (const Fit& f : fits[dev])
    if (f.grid > 0 && f.threads == threads && f.smem == smem) grid = f.grid;
  if (grid == 0) {
    if (found[dev] == 0)
      rc = cudaFuncSetAttribute(Kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_max);
    int per_sm = 0, sms = 0;
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                         threads, smem);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return (int)rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = per_sm * sms;
    fits[dev][found[dev]++ % kFits] = Fit{threads, smem, grid};
  }
  if (items == 0) return 0;
  const int blocks = (int)(!persistent || items < grid ? items : grid);
  Kernel<<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// An extent-1 dimension's stride is never stepped; TMA still wants a
// positive multiple of 16 bytes there.
inline cuuint64_t tma_stride(long long bytes, long long extent) {
  return extent > 1 ? static_cast<cuuint64_t>(bytes) : 16;
}

// 4-D map over {D, H, T, B} of a [B, T, H, D]-indexed view with element
// strides (sb, sh, st), box {64, 1, 64, 1}, 128-byte swizzle: one 64-column
// panel of 64 rows per copy, out-of-bounds rows filled with zeros.
template <typename T>
int encode_heads(CUtensorMap* map, const void* base, int B, int Hx, int T_len,
                 int D, long long sb, long long sh, long long st) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)T_len,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {tma_stride(sh * 2, Hx),
                                 tma_stride(st * 2, T_len),
                                 tma_stride(sb * 2, B)};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult rc = fn(map, dt, 4, const_cast<void*>(base), dims, strides,
                         box,
                         estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + (int)rc;
}

// 5-D map over {D, H, S, N, B} of a [B, N, S, H, D]-indexed view with
// element strides (sb, sn, ss, sh), box {D2, 1, 64, 1, 1} with D2 = min(D,
// 64) columns (128 or 64 bytes): one 64-row panel per copy, with the 128-
// or the 64-byte swizzle to match, out-of-bounds rows filled with zeros.
template <typename T>
int encode_5d(CUtensorMap* map, const void* base, int B, int N, int S, int H,
              int D, long long sb, long long sn, long long ss, long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[4] = {tma_stride(sh * 2, H), tma_stride(ss * 2, S),
                                 tma_stride(sn * 2, N), tma_stride(sb * 2, B)};
  const cuuint32_t cols = D < 64 ? D : 64;
  const cuuint32_t box[5] = {cols, 1, 64, 1, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult rc = fn(map, dt, 5, const_cast<void*>(base), dims, strides,
                         box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeError + (int)rc;
}

}  // namespace
}  // namespace sm90
}  // namespace dstt
