// flash_fwd.cu — flash-attention forward (out and row log-sum-exp), Hopper.
//
// Replaces the Pallas forward of deepspeed_tpu/ops/pallas/flash_attention.py:
// _flash_fwd (:143, kernel _fwd_kernel :50), reached by generate()'s prefill
// through the dispatch program "flash" and by every training step of the
// dense and MoE GPTs. Its backward kernels (:297, :323) are flash_bwd.cu,
// which reads the lse written here.
//
// What bounds it on the H100: operations at long T (4 * T^2 * D flops per
// head, halved by causality, against 4 * T * D elements moved), memory at
// short T. The design (attn_fwd.cuh) keeps the T x T scores out of device
// memory and puts both products on wgmma with the accumulators in
// registers:
//   * persistent blocks (as many as fit the card: two per SM at hd 128,
//     with 98 KB of shared memory each) walk the (64-row q tile, b, h)
//     items; one consumer warpgroup owns the 64 rows, and one producer
//     warp keeps a ring of two K/V stages and a second Q buffer in flight
//     with TMA, so the copies overlap the products and the next item's
//     loads the end of this one; O leaves through shared memory by a TMA
//     store;
//   * the K loop stops at the causal frontier: fully masked tiles are
//     neither loaded nor computed, and the masks run only on the tiles
//     that cross the diagonal or T;
//   * the scale is applied to fp32 S in the kernel; the online softmax
//     runs in registers (two quad shuffles per row max); P is narrowed to
//     the input dtype for the P V product, as the Pallas kernel does;
//   * blocks walk the q tiles longest first (the last causal tile first),
//     so the longest rows do not start last;
//   * the ragged edge of any T is masked in the kernel (no T % 128 rule):
//     rows past T load as zeros (TMA's out-of-bounds fill) and are never
//     written.
// Grouped-query attention reads kv head h / G; no K/V repeat is
// materialized. Each of q, k, v is described to TMA by its own strides, so
// [B, T, H, D] views of a fused qkv projection are read in place.
//
// The q tile is 64 rows. A 128-row tile (two consumer warpgroups sharing
// each K/V stage: half the K/V reads, one block per SM) measured slower at
// every path shape on the H100 (PERF.md).
//
// Later work: the L2 reads of K/V (each 64-row q tile reads the K/V tiles
// again; at long T the copies alone take most of the kernel's time, and a
// TMA multicast across a cluster of q tiles would share them), the next
// tile's Q K^T issued under this tile's softmax (tried, slower as
// written), setmaxnreg. The backward kernels (flash_bwd.cu) read the lse
// written here and are built on the same wgmma / TMA blocks (sm90.cuh).

#include "attn_fwd.cuh"

namespace {

using namespace dstt::attn;

// Two K/V stages: a third costs the hd-128 tile its second block per SM
// (32 KB more shared memory than the 98 KB of two) and measured slower.
constexpr int STAGES = 2;

template <typename T, int HD>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int Hkv, int T_len,
                 const long long* st, float scale, int causal,
                 cudaStream_t stream) {
  FwdParams p{};
  int rc = encode_heads<T>(&p.tq, q, B, H, T_len, HD,
                           st[0], st[1], st[2]);
  if (!rc) rc = encode_heads<T>(&p.tk, k, B, Hkv, T_len, HD,
                                st[3], st[4], st[5]);
  if (!rc) rc = encode_heads<T>(&p.tv, v, B, Hkv, T_len, HD,
                                st[6], st[7], st[8]);
  if (!rc) rc = encode_heads<T>(&p.to, o, B, H, T_len, HD,
                                st[9], st[10], st[11]);
  if (rc) return rc;
  p.lse = lse;
  p.o = o;
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_st = st[11];
  p.B = B;
  p.H = H;
  p.G = H / Hkv;
  p.T_len = T_len;
  p.n_qt = (T_len + BM - 1) / BM;
  p.scale = scale;
  p.causal = causal;
  return launch<false, T, HD, STAGES>(p, stream);
}

template <typename T>
int launch_hd(int D, const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int H, int Hkv, int T_len,
              const long long* st, float scale, int causal,
              cudaStream_t stream) {
  if (D == 64)
    return launch_flash<T, 64>(q, k, v, o, lse, B, H, Hkv, T_len, st, scale,
                               causal, stream);
  if (D == 128)
    return launch_flash<T, 128>(q, k, v, o, lse, B, H, Hkv, T_len, st, scale,
                                causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q / o [B, *, H, D] and k / v [B, *, Hkv, D] in any layout whose last dim is
// contiguous and whose other strides are multiples of 16 bytes: `strides`
// holds (batch, head, time) element strides for q, k, v, o in that order.
// lse [B, H, T] fp32. dtype: 1 bfloat16, 2 float16. Returns
// cudaGetLastError(), or 10000 + the CUresult of a failed tensor-map encode.
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int Hkv,
                              int T_len, int D, const long long* strides,
                              float scale, int causal, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Hkv, T_len,
                                    strides, scale, causal, s);
  if (dtype == 2)
    return launch_hd<__half>(D, q, k, v, o, lse, B, H, Hkv, T_len, strides,
                             scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

