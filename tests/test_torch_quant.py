"""The PyTorch port's quantized serving held to the JAX package's: the
groupwise int8 / packed-int4 quantizers, the int8 paged pool and its decode
kernel, weight-only quantized trees, and quantized serving end to end, on
the same numpy-seeded inputs and weights, fp32 on the CPU.

On a CPU tensor each kernel wrapper of the port runs its plain version, so
these tests hold those plain versions — the numerics the CUDA kernels are
checked against bit for bit on the card by `chip_smoke.py` — to the JAX
package: its jnp scheme (`quantize_kv`, `quantize_tensor`) and its Pallas
kernels in interpret mode, as tests/test_quant_serving.py runs them.

Tolerances: int payloads exactly equal; scales at rtol 1e-6 (the Pallas
interpret path may fuse the /qmax differently and land ~1 ulp away);
dequantized values at rtol 1e-6; the int8 decode kernel at 2e-5 (fp32,
different summation orders), as the JAX package holds its own kernel;
served greedy tokens identical.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.inference.engine import init_inference as jax_init
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.pallas import quant as jpq
from deepspeed_tpu_torch.inference import quantization as tq
from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.scheduler import Request
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import quant as tqo

LIVELY = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                        vocab_size=256, dtype=jnp.float32, remat=False,
                        tie_embeddings=False)
CONF = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True,
        "kv_block_size": 16, "max_out_tokens": 64}
TRACE = (5, 11, 3, 8, 14, 2, 31, 17)
SCALE_RTOL = 1e-6


def _mk_mesh():
    mesh_mod._CURRENT_MESH = None
    mesh_mod._CURRENT_SPEC = None
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _port_spec(jspec, jcfg=LIVELY, params=None, **over):
    kw = dict(n_layer=jcfg.n_layer, n_head=jcfg.n_head,
              d_model=jcfg.d_model, max_seq_len=jcfg.max_seq_len,
              vocab_size=jcfg.vocab_size,
              tie_embeddings=jcfg.tie_embeddings, dtype="float32", **over)
    if params is None:
        params = jspec.params
    params = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return tgpt.make_gpt_decode_model(tgpt.GPTConfig(**kw), name="tiny",
                                      params=params)


def _engines(jax_over=None, port_over=None, **port_cfg):
    """(JAX engine, port engine) over the same weights."""
    _mk_mesh()
    jspec = jgpt.make_gpt_decode_model(cfg=LIVELY, name="tiny")
    return (jax_init(model=jspec, config={**CONF, **(jax_over or {})}),
            init_inference(_port_spec(jspec, **port_cfg),
                           config={**CONF, **(port_over or {})},
                           device="cpu"))


def _port_engine(**over):
    return _engines(port_over=over)[1]


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, LIVELY.vocab_size, (n,)).astype(np.int32)
            for n in lens]


# ----------------------------------------------------------------------
# the quantizers: K7 (int8) and K8 (packed int4)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("group", [64, 32, 16])
def test_int8_quantizers_match_jax(group):
    """quantize_int8 / quantize_kv / quantize_tensor(bits=8): the port's
    payload equals JAX's jnp scheme and its Pallas kernel byte for byte."""
    x = _normal(np.random.default_rng(group), 8, 256)
    tq8, ts8 = tqo.quantize_int8(torch.from_numpy(x), group)
    qp, sp = jpq.quantize_int8(jnp.asarray(x), group)
    qj, sj = jq.quantize_kv(jnp.asarray(x), group)
    t = jq.quantize_tensor(jnp.asarray(x), bits=8, group_size=group)
    tk, tks = tq.quantize_kv(torch.from_numpy(x), group)
    tt = tq.quantize_tensor(torch.from_numpy(x), bits=8, group_size=group)
    assert tq8.dtype == torch.int8 and tuple(ts8.shape) == (8, 256 // group)
    for ref_q, ref_s in ((qp, sp), (qj, sj), (t.q, t.scale)):
        np.testing.assert_array_equal(tq8.numpy(), np.asarray(ref_q))
        np.testing.assert_allclose(ts8.numpy(), np.asarray(ref_s),
                                   rtol=SCALE_RTOL)
    for q, s in ((tk, tks), (tt.q, tt.scale)):
        assert torch.equal(q, tq8) and torch.equal(s, ts8)


@pytest.mark.parametrize("group", [64, 16])
def test_int4_quantizers_match_jax(group):
    """quantize_int4 / quantize_tensor(bits=4): the same packed BYTES as
    JAX's jnp packing and its Pallas kernel (biased nibbles, lo = even)."""
    x = _normal(np.random.default_rng(100 + group), 4, 128)
    tq4, ts4 = tqo.quantize_int4(torch.from_numpy(x), group)
    qp, sp = jpq.quantize_int4(jnp.asarray(x), group)
    t = jq.quantize_tensor(jnp.asarray(x), bits=4, group_size=group)
    assert tuple(tq4.shape) == (4, 64) and tq4.dtype == torch.int8
    for ref_q, ref_s in ((qp, sp), (t.q, t.scale)):
        np.testing.assert_array_equal(tq4.numpy(), np.asarray(ref_q))
        np.testing.assert_allclose(ts4.numpy(), np.asarray(ref_s),
                                   rtol=SCALE_RTOL)
    tt = tq.quantize_tensor(torch.from_numpy(x), bits=4, group_size=group)
    assert torch.equal(tt.q, tq4) and torch.equal(tt.scale, ts4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantizers_match_jax(bits, dtype):
    """Every dequantize of the port against JAX's on the same payload and
    scales: the Pallas kernel, dequantize_tensor and (int8) dequantize_kv."""
    rng = np.random.default_rng(bits)
    x = jnp.asarray(_normal(rng, 6, 128))
    jdt = getattr(jnp, dtype)
    t = jq.quantize_tensor(x.astype(jdt), bits=bits, group_size=32)
    q, s = np.array(t.q), np.array(t.scale)
    tdt = getattr(torch, dtype)
    port = (tqo.dequantize_int8 if bits == 8 else tqo.dequantize_int4)(
        torch.from_numpy(q), torch.from_numpy(s), tdt, 32)
    pal = (jpq.dequantize_int8 if bits == 8 else jpq.dequantize_int4)(
        t.q, t.scale, jdt, 32)
    refs = [pal, jq.dequantize_tensor(t)]
    if bits == 8:
        refs.append(jq.dequantize_kv(t.q, t.scale, jdt))
    pt = tq.dequantize_tensor(tq.QuantizedTensor(
        q=torch.from_numpy(q), scale=torch.from_numpy(s), bits=bits,
        group_size=32, shape=(6, 128), dtype=tdt))
    assert port.dtype == tdt and torch.equal(pt, port)
    for ref in refs:
        np.testing.assert_allclose(port.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=SCALE_RTOL, atol=1e-7)


# dequantize_many's leaves: (shape, g, index of the slice of a stacked leaf
# or None) — g 7 (an int4 byte spans two groups), 32 and 64, and a slice
DEQUANT_MANY_LEAVES = (((6, 14), 7, None), ((5, 96), 32, None),
                       ((4, 128), 64, None), ((3, 10, 64), 32, 1))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dequantize_many_matches_its_leaves_and_jax(bits, dtype):
    """The grouped dequantize's plain version (a CPU call) equals
    dequantize_reference leaf by leaf, and JAX's dequantize_tensor of the
    same quantized leaves within SCALE_RTOL, over leaves of mixed g, a
    slice of a stacked leaf and int4 bytes that span two groups; a leaf
    into fp32, bf16 or fp16."""
    rng = np.random.default_rng(20 + bits)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    leaves, refs = [], []
    for shape, g, index in DEQUANT_MANY_LEAVES:
        t = jq.quantize_tensor(jnp.asarray(_normal(rng, *shape)).astype(jdt),
                               bits=bits, group_size=g)
        q, s = torch.from_numpy(np.array(t.q)), torch.from_numpy(
            np.array(t.scale))
        ref = np.asarray(jq.dequantize_tensor(t).astype(jnp.float32))
        if index is not None:
            q, s, ref = q[index], s[index], ref[index]
        leaves.append((q, s, tdt, g, bits))
        refs.append(ref)
    outs = tqo.dequantize_many(leaves)
    assert len(outs) == len(leaves)
    for out, leaf, ref in zip(outs, leaves, refs):
        assert out.dtype == tdt
        assert torch.equal(out, tqo.dequantize_reference(*leaf))
        np.testing.assert_allclose(out.float().numpy(), ref,
                                   rtol=SCALE_RTOL, atol=1e-7)


@pytest.mark.parametrize("bits", [8, 4])
def test_layer_dequantizes_to_the_layer_of_jaxs_whole_tree(bits):
    """`_layer` on a weight-quantized tree (its leaves dequantized
    together, one launch on the card) equals layer i of the JAX package's
    whole-tree dequantize (`dequantize_param_tree`, the wrap_fn_dequant
    view), leaf by leaf."""
    jcfg = jgpt.GPTConfig(n_layer=3, n_head=4, d_model=128, max_seq_len=64,
                          vocab_size=256, dtype=jnp.float32, remat=False)
    rng = np.random.default_rng(30 + bits)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(_normal(rng, *a.shape) * 0.02),
        jgpt.init_gpt_params(jcfg, seed=0))
    jtree, _ = jq.quantize_param_tree(jparams, bits=bits, group_size=32,
                                      min_size=256)   # the biases too
    jdense = jq.dequantize_param_tree(jtree)["blocks"]
    ttree = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    quantized = [k for k, v in ttree["blocks"].items()
                 if isinstance(v, tq.QuantizedTensor)]
    assert len(quantized) == 8
    for i in range(jcfg.n_layer):
        layer = tgpt._layer(ttree, i)
        assert sorted(layer) == sorted(jdense)
        for name, leaf in layer.items():
            assert not isinstance(leaf, tq.QuantizedTensor), name
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(jdense[name][i]),
                                       rtol=SCALE_RTOL, atol=1e-7,
                                       err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("call,match", [
    (lambda: tq.quantize_tensor(torch.ones(4, 100), bits=8, group_size=64),
     "does not tile into groups"),
    (lambda: tq.quantize_tensor(torch.ones(4, 7), bits=4, group_size=7),
     "two values per byte"),
    (lambda: tq.quantize_tensor(torch.ones(4, 100), bits=2, group_size=4),
     "bits must be 4 or 8"),
    (lambda: tq.quantize_kv(torch.ones(2, 3, 16), 5), "does not tile"),
    (lambda: tqo.quantize_int8(torch.ones(2, 48), 32), "does not tile"),
    (lambda: tqo.quantize_int4(torch.ones(2, 9), 3), "must be even"),
], ids=["non_tiling_group", "odd_int4", "bits_2", "kv_group", "kernel_group",
        "kernel_odd_int4"])
def test_quantizer_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ----------------------------------------------------------------------
# the int8 pool write: K7 fused with the scatter, one launch a layer
# ----------------------------------------------------------------------


def _kv_write_inputs(rng, B, C, Hkv, hd, g, bs, nb, inactive=0):
    """K/V [B, C, Hkv, hd], shuffled tables (the first `inactive` rows
    all-trash at position 0), distinct positions a row (consecutive for
    C > 1, as a prefill chunk) and a random int8 pool, as numpy arrays."""
    N = B * nb + 1
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(
        B, nb).astype(np.int32)
    cap = nb * bs
    if C == 1:
        pos = rng.integers(0, cap, (B, 1))
    else:
        pos = rng.integers(0, cap - C + 1, (B, 1)) + np.arange(C)[None]
    tables[:inactive], pos[:inactive] = 0, 0
    pool = {n: rng.integers(-127, 128, (N, Hkv, bs, hd)).astype(np.int8)
            for n in ("k", "v")}
    pool.update({f"{n}_scale": rng.random((N, Hkv, bs, hd // g)).astype(
        np.float32) for n in ("k", "v")})
    return (_normal(rng, B, C, Hkv, hd), _normal(rng, B, C, Hkv, hd),
            tables, pos.astype(np.int32), pool)


@pytest.mark.parametrize("group", [16, 32, 64])
@pytest.mark.parametrize("C, inactive", [(1, 2), (24, 0)],
                         ids=["decode", "prefill_chunk"])
def test_kv_write_matches_jax_quantize_and_scatter(C, inactive, group):
    """The port's int8 pool write (`quantize_kv_write`, its plain version
    on the CPU) against the JAX package's cache write on the same numpy K,
    V, tables and positions (`quantize_kv`, then `.at[blk, :, off].set` of
    payload and scales, deepspeed_tpu/models/gpt.py's paged attention
    half): all four pool tensors bit-equal outside the trash block, where
    inactive rows collide."""
    rng = np.random.default_rng(40 + C + group)
    B, Hkv, hd, bs, nb = 5, 2, 64, 16, 3
    k, v, tables, pos, pool = _kv_write_inputs(rng, B, C, Hkv, hd, group,
                                               bs, nb, inactive)
    blk = np.take_along_axis(tables, pos // bs, axis=1)
    off = pos % bs
    want = {n: jnp.asarray(a) for n, a in pool.items()}
    for name, x in (("k", k), ("v", v)):
        q, sc = jq.quantize_kv(jnp.asarray(x), group)
        want[name] = want[name].at[blk, :, off, :].set(q)
        want[f"{name}_scale"] = want[f"{name}_scale"].at[blk, :, off, :].set(
            sc)
    got = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tq.quantize_kv_write(got, torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(tables), torch.from_numpy(pos))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got[name].numpy()[1:],
                                      np.asarray(want[name])[1:],
                                      err_msg=name)
        assert not np.array_equal(got[name].numpy(), pool[name])


def _pool_for(hd=64, g=32, **bad):
    rng = np.random.default_rng(3)
    k, v, tables, pos, pool = _kv_write_inputs(rng, 2, 1, 2, hd, g, 16, 2)
    t = {n: torch.from_numpy(a) for n, a in pool.items()}
    t.update(bad)
    return t, torch.from_numpy(k), torch.from_numpy(v), \
        torch.from_numpy(tables), torch.from_numpy(pos)


@pytest.mark.parametrize("bad, match", [
    ({"k": torch.zeros(5, 2, 16, 64)}, "expected int8"),
    ({"v": torch.zeros(5, 2, 16, 32, dtype=torch.int8)}, "expected int8"),
    ({"k_scale": torch.zeros(5, 2, 16, 2, dtype=torch.float16)},
     "expected float32"),
    ({"v_scale": torch.zeros(5, 2, 16, 3)}, "expected float32"),
    ({"k_scale": torch.zeros(5, 2, 8, 2), "v_scale": torch.zeros(5, 2, 8, 2)},
     "expected float32"),
], ids=["payload_dtype", "payload_shape", "scale_dtype", "scale_groups",
        "scale_shape"])
def test_kv_write_refuses_a_pool_it_cannot_hold(bad, match):
    pool, k, v, tables, pos = _pool_for(**bad)
    with pytest.raises(ValueError, match=match):
        tq.quantize_kv_write(pool, k, v, tables, pos)


class _Cuda:
    """A CUDA-like tensor with shape, strides and dtype, for the write's
    host side: nothing reaches a card."""

    def __init__(self, shape, dtype, strides=None, ptr=4096):
        self.shape, self.dtype = torch.Size(shape), dtype
        self._strides = strides or torch.empty(shape, device="meta").stride()
        self.device, self.is_cuda, self.ptr = torch.device("cuda", 0), True, ptr

    def dim(self):
        return len(self.shape)

    def stride(self, i):
        return self._strides[i]

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()

    def data_ptr(self):
        return self.ptr

    def is_contiguous(self):
        return True

    def contiguous(self):
        return self


def test_kv_write_is_one_launch_on_the_projections_views(monkeypatch):
    """On CUDA tensors the write is one launch of `dstt_quantize_kv_write`
    (counted as quantize_int8), handed the K/V views of the fused qkv
    projection with their strides, int64 positions, int32 tables and the
    group size: no copy, gather or scatter on the host side."""
    from deepspeed_tpu_torch.ops import op_builder
    calls = []

    class Entry:
        argtypes = restype = None

        def __call__(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(op_builder, "load", lambda name: type(
        "Lib", (), {"dstt_quantize_kv_write": Entry()}))
    monkeypatch.setattr(op_builder, "stream_ptr", lambda device: None)
    op_builder.LAUNCHES.clear()
    B, C, H, Hkv, hd, g, N, bs, nb = 8, 1, 12, 12, 64, 16, 17, 512, 2
    row = (H + 2 * Hkv) * hd
    k = _Cuda((B, C, Hkv, hd), torch.bfloat16, (C * row, row, hd, 1), 16 * 96)
    v = _Cuda((B, C, Hkv, hd), torch.bfloat16, (C * row, row, hd, 1), 16 * 192)
    pool = [_Cuda((N, Hkv, bs, hd), torch.int8) for _ in range(2)] + \
        [_Cuda((N, Hkv, bs, hd // g), torch.float32) for _ in range(2)]
    tables = _Cuda((B, nb), torch.int32)
    pos = _Cuda((B, C), torch.int64)
    tqo.quantize_kv_write(k, v, tables, pos, *pool)
    assert dict(op_builder.LAUNCHES) == {"quantize_int8": 1}
    (args,) = calls
    assert args[:6] == (16 * 96, 16 * 192, C * row, row, C * row, row)
    assert args[7] is True and args[9] is False
    assert args[14:21] == (B, C, Hkv, hd, g, bs, nb)
    assert args[21] == op_builder.dtype_code(torch.bfloat16)
    # g 12 (head_dim 96): a group neither divides 8 nor is a multiple of 8
    k96, v96 = (_Cuda((B, C, Hkv, 96), torch.bfloat16) for _ in range(2))
    with pytest.raises(ValueError, match="groups dividing 8"):
        tqo.quantize_kv_write(
            k96, v96, tables, pos,
            *[_Cuda((N, Hkv, bs, 96), torch.int8) for _ in range(2)],
            *[_Cuda((N, Hkv, bs, 8), torch.float32) for _ in range(2)])
    assert len(calls) == 1


class _CudaX(_Cuda):
    """A CUDA-like dense input the quantize wrapper takes to its launch."""

    def numel(self):
        return int(np.prod(self.shape))

    def new_empty(self, shape, dtype):
        return _CudaX(shape, dtype, ptr=id(shape))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape, g", [((6, 768), 64), ((5, 14), 7),
                                      ((2, 3, 96), 12)])
def test_dense_quantize_is_one_launch_at_either_width(bits, shape, g,
                                                      monkeypatch):
    """On a CUDA tensor `quantize` at 4 bits, as at 8, is one launch of
    `dstt_quantize` (counted as quantize_int4 / quantize_int8), handed x's
    pointer, rows, D, g, the bit width and the dtype's code; the library
    picks the vector or the row body inside that one launch. q is
    [..., D / 2] int8 at 4 bits, scales [..., D / g] float32."""
    from deepspeed_tpu_torch.ops import op_builder
    calls = []

    class Entry:
        argtypes = restype = None

        def __call__(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(op_builder, "load", lambda name: type(
        "Lib", (), {"dstt_quantize": Entry()}))
    monkeypatch.setattr(op_builder, "stream_ptr", lambda device: None)
    monkeypatch.setattr(tqo, "quantize_reference", None)
    op_builder.LAUNCHES.clear()
    x = _CudaX(shape, torch.bfloat16, ptr=16 * 64)
    q, s = tqo.quantize(x, g, bits)
    assert dict(op_builder.LAUNCHES) == {f"quantize_int{bits}": 1}
    (args,) = calls
    D = shape[-1]
    rows = int(np.prod(shape)) // D
    assert args[0] == 16 * 64 and args[3:8] == (
        rows, D, g, bits, op_builder.dtype_code(torch.bfloat16))
    assert (tuple(q.shape), q.dtype) == (
        shape[:-1] + (D // 2 if bits == 4 else D,), torch.int8)
    assert (tuple(s.shape), s.dtype) == (shape[:-1] + (D // g,),
                                         torch.float32)


# ----------------------------------------------------------------------
# K6: decode attention over the int8 pool
# ----------------------------------------------------------------------


@pytest.mark.parametrize("group", [32, 64])
def test_paged_decode_quant_matches_pallas_and_its_oracle(group):
    """The shuffled physical mapping with a row parked on the trash block
    only (tests/test_quant_serving.py's kernel case)."""
    rng = np.random.default_rng(11)
    B, H, Hkv, hd, bm, N = 4, 8, 4, 64, 128, 12
    q = _normal(rng, B, H, hd)
    kq, ks = jq.quantize_kv(jnp.asarray(_normal(rng, N, Hkv, bm, hd)), group)
    vq, vs = jq.quantize_kv(jnp.asarray(_normal(rng, N, Hkv, bm, hd)), group)
    bt = np.asarray([[7, 2, 10], [1, 9, 4], [3, 5, 8], [0, 0, 0]], np.int32)
    pos = np.asarray([5, 200, 383, 0], np.int32)
    from deepspeed_tpu.ops.pallas.decode_attention import (
        paged_decode_attention_quant, paged_decode_attention_quant_reference)
    jo = paged_decode_attention_quant(jnp.asarray(q), kq, vq, ks, vs,
                                      jnp.asarray(bt), jnp.asarray(pos))
    jref = paged_decode_attention_quant_reference(
        jnp.asarray(q), {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs},
        jnp.asarray(bt), jnp.asarray(pos))
    t = {n: torch.from_numpy(np.asarray(a)) for n, a in
         (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))}
    to = tda.paged_decode_attention_quant(
        torch.from_numpy(q), t["k"], t["v"], t["k_scale"], t["v_scale"],
        torch.from_numpy(bt), torch.from_numpy(pos))
    tref = tda.paged_decode_attention_quant_reference(
        torch.from_numpy(q), t, torch.from_numpy(bt), torch.from_numpy(pos))
    assert torch.equal(to, tref)
    for ref in (jo, jref):
        np.testing.assert_allclose(to.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


def test_int8_pool_layout_and_zero_init():
    cfg = tgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=512,
                         vocab_size=256, dtype="float32")
    pool = tgpt.init_paged_kv_pool(cfg, 9, 16, torch.int8)
    assert pool["k"].dtype == torch.int8
    assert tuple(pool["k_scale"].shape) == (2, 9, 4, 16, 1)   # g = head_dim
    assert pool["k_scale"].dtype == torch.float32
    pool8 = tgpt.init_paged_kv_pool(cfg, 9, 16, torch.int8, kv_group_size=8)
    assert tuple(pool8["v_scale"].shape) == (2, 9, 4, 16, 2)
    with pytest.raises(ValueError, match="does not tile head_dim"):
        tgpt.init_paged_kv_pool(cfg, 9, 16, torch.int8, kv_group_size=5)
    assert not any(t.any() for t in pool.values())
    # the same layout as the JAX pool, leaf for leaf
    jpool = jgpt.init_paged_kv_pool(LIVELY, 9, 16, jnp.int8, kv_group_size=8)
    assert sorted(jpool) == sorted(pool8)
    for name, leaf in pool8.items():
        assert tuple(leaf.shape) == jpool[name].shape
        assert str(leaf.dtype).replace("torch.", "") == str(jpool[name].dtype)
    # a trash-block read dequantizes to exact zeros
    out = tda.paged_decode_attention_quant(
        torch.ones(1, 4, 16), *(pool[n][0] for n in
                                ("k", "v", "k_scale", "v_scale")),
        torch.zeros(1, 1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32))
    assert not out.any()


# ----------------------------------------------------------------------
# weight-only quantized trees
# ----------------------------------------------------------------------


def test_quantize_param_tree_matches_jax_leaf_for_leaf():
    """The same quantized leaf set — the stacked [L, D] block biases
    included, since the exclude rule matches the leaf PATH — the same stats
    and identical payload and scale bytes."""
    jcfg = jgpt.GPTConfig(n_layer=16, n_head=4, d_model=256, max_seq_len=64,
                          vocab_size=256, dtype=jnp.float32, remat=False)
    # random everywhere, so the quantized biases are not zeros
    rng = np.random.default_rng(7)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(_normal(rng, *a.shape) * 0.02),
        jgpt.init_gpt_params(jcfg, seed=0))
    jtree, jstats = jq.quantize_param_tree(jparams, bits=8, group_size=64)
    ttree, tstats = tq.quantize_param_tree(
        tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
        bits=8, group_size=64)
    assert tstats == jstats
    for name in ("attn_qkv_b", "attn_out_b", "mlp_up_b", "mlp_out_b"):
        assert isinstance(ttree["blocks"][name], tq.QuantizedTensor), name
    assert not isinstance(ttree["blocks"]["ln1_bias"], tq.QuantizedTensor)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {n: v for k in tree
                    for n, v in flat(tree[k], f"{prefix}{k}/").items()}
        return {prefix.rstrip("/"): tree}

    jflat, tflat = flat(jtree), flat(ttree)
    assert sorted(jflat) == sorted(tflat)
    for name, leaf in tflat.items():
        ref = jflat[name]
        assert isinstance(leaf, tq.QuantizedTensor) == \
            isinstance(ref, jq.QuantizedTensor), name
        if isinstance(leaf, tq.QuantizedTensor):
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q))
            np.testing.assert_allclose(leaf.scale.numpy(),
                                       np.asarray(ref.scale), rtol=SCALE_RTOL)
            assert leaf.shape == tuple(ref.shape)
    dense = tq.dequantize_param_tree(ttree)
    np.testing.assert_allclose(
        dense["blocks"]["mlp_up_w"].numpy(),
        np.asarray(jq.dequantize_param_tree(jtree)["blocks"]["mlp_up_w"]),
        rtol=SCALE_RTOL, atol=1e-7)


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_jax_carries_a_quantized_tree_and_logits_match(bits):
    """A JAX engine's quantized resident tree moves across byte for byte;
    on it the port's dequantize-on-use model gives the JAX wrap_fn_dequant
    view's logits, and generate() the same tokens."""
    je, _ = _engines(jax_over={"quant": {"enabled": True, "bits": bits,
                                         "group_size": 16}})
    tspec = _port_spec(None, params=je.params)
    te = init_inference(tspec, config=dict(CONF), device="cpu")
    jleaf = je.params["blocks"]["mlp_up_w"]
    tleaf = te.params["blocks"]["mlp_up_w"]
    assert isinstance(tleaf, tq.QuantizedTensor) and tleaf.bits == bits
    np.testing.assert_array_equal(tleaf.q.numpy(), np.asarray(jleaf.q))
    np.testing.assert_array_equal(tleaf.scale.numpy(),
                                  np.asarray(jleaf.scale))
    toks = np.random.default_rng(3).integers(0, 256, (2, 9))
    jl, _ = je.forward(toks)
    tl, _ = te.forward(toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    prompts = _prompts(1, (5, 11, 3))
    np.testing.assert_array_equal(
        te.generate(prompts, max_new_tokens=8, stop_on_eos=False),
        je.generate(prompts, max_new_tokens=8, stop_on_eos=False))


# ----------------------------------------------------------------------
# quantized serving end to end
# ----------------------------------------------------------------------


def _run_both(je, te, quantization, window=1):
    prompts = _prompts(1, TRACE)
    kw = dict(max_slots=3, max_context=64, prefill_chunk=16,
              decode_steps_per_sync=window, quantization=quantization)
    jres = je.serving(**kw).run(
        [JaxRequest(uid=i, tokens=p, max_new_tokens=3 + i % 5,
                    stop_on_eos=False) for i, p in enumerate(prompts)])
    serving = te.serving(**kw)
    tres = serving.run([Request(uid=i, tokens=p, max_new_tokens=3 + i % 5,
                                stop_on_eos=False)
                        for i, p in enumerate(prompts)])
    assert sorted(tres) == list(range(len(prompts)))
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tres[i].tokens, jres[i].tokens)
    assert serving.allocator.num_free == serving.allocator.capacity
    return prompts, tres, serving


@pytest.mark.parametrize("forced_kernel", [False, True],
                         ids=["gather", "kernel_route"])
def test_int8_kv_serving_tokens_identical_to_jax(forced_kernel):
    """The ragged trace over the int8 pool: identical greedy tokens to JAX
    serving on the same weights, through the dequantizing gather and
    through the int8 kernel's program (its plain version on the CPU)."""
    je, te = _engines(use_flash_attention=True if forced_kernel else None)
    _, _, serving = _run_both(je, te, {"kv_cache_dtype": "int8",
                                       "kv_group_size": 8})
    assert tuple(serving.pool["k_scale"].shape) == (2, serving.pool[
        "k"].shape[1], 4, 16, 2)
    assert serving.stats()["quantization"] == {
        "kv_cache_dtype": "int8", "weights": "off", "kv_group_size": 8}


@pytest.mark.parametrize("weights", ["int8", "int4"])
def test_weight_only_serving_matches_generate_and_jax(weights):
    je, te = _engines()
    quant = {"weights": weights, "weight_group_size": 16}
    prompts, tres, serving = _run_both(je, te, quant, window=4)
    stats = serving.weight_quant_stats
    assert stats["quantized"] > 0
    assert stats["ratio"] > (2.0 if weights == "int8" else 3.0)
    assert serving.stats()["quantization"]["weight_quant"] == stats
    for i, p in enumerate(prompts):
        ref = te.generate(p[None], max_new_tokens=3 + i % 5,
                          stop_on_eos=False)[0]
        np.testing.assert_array_equal(tres[i].tokens, ref)


def test_enable_weight_quant_is_idempotent_and_refuses_a_conflict():
    engine = _port_engine(quant={"enabled": True, "bits": 8,
                                 "group_size": 16})
    stats = engine.quant_stats
    assert stats is not None and stats["quantized"] > 0
    serving = engine.serving(max_slots=2, max_context=64,
                             quantization={"weights": "int8",
                                           "weight_group_size": 16})
    assert serving.weight_quant_stats == stats
    assert engine.enable_weight_quant(8, 16) is stats
    with pytest.raises(ValueError, match="already quantized"):
        engine.serving(max_slots=2, max_context=64,
                       quantization={"weights": "int4",
                                     "weight_group_size": 16})
    with pytest.raises(ValueError, match="already quantized"):
        engine.enable_weight_quant(8, 32)
    with pytest.raises(ValueError, match="unknown serving.quantization"):
        _port_engine().serving(max_slots=2, max_context=64,
                               quantization={"weights": "int2"})


def test_int8_generate_cache_refused():
    engine = _port_engine(kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="paged-pool serving feature"):
        engine.generate(np.asarray([[1, 2, 3]], np.int32), max_new_tokens=2)
    # the engine-level int8 selects the int8 pool for serving
    serving = engine.serving(max_slots=2, max_context=64, prefill_chunk=16)
    assert serving.kv_quant and serving.pool["k"].dtype == torch.int8


@pytest.mark.parametrize("bad", ["int16", "uint8", "int4"])
def test_integer_kv_dtypes_other_than_int8_refused(bad):
    with pytest.raises(ValueError, match="KV-cache dtype"):
        _port_engine().serving(max_slots=2, max_context=64,
                               quantization={"kv_cache_dtype": bad})


def test_quantized_pool_contract_is_checked():
    """A model spec whose init_paged_pool lacks the quantized form gets the
    contract pointer, not a bare TypeError."""
    engine = _port_engine()
    spec = engine.model_spec
    engine.model_spec = dataclasses.replace(
        spec, init_paged_pool=lambda n, bs, dtype, device="cpu":
        spec.init_paged_pool(n, bs, dtype, device=device))
    with pytest.raises(ValueError, match="quantized-pool contract"):
        engine.serving(max_slots=2, max_context=64,
                       quantization={"kv_cache_dtype": "int8"})


# the check chip_smoke.py holds quantize_int4 to on the card, and its
# planted fault
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("shape, g", [((50, 768), 64), ((9, 16), 4)])
def test_chip_smoke_int4_fault_swaps_one_units_nibbles(shape, g):
    """chip_smoke's planted int4 fault (`_swap_unit_nibbles`) changes the
    4 bytes of exactly one unit of 8 elements, each byte's two nibbles
    exchanged (the even element moved to the high nibble), so the
    bit-exact comparison with the plain version fails; swapping twice
    restores it."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32))
    q, _ = tqo.quantize_reference(x, g, 4)
    fault = chip_smoke._swap_unit_nibbles(q)
    assert fault.shape == q.shape and fault.dtype == torch.int8
    diff = (fault != q).reshape(-1).nonzero().reshape(-1)
    assert diff.numel() > 0 and int(diff[-1]) - int(diff[0]) < 4
    unit = int(diff[0]) // 4
    b = q.reshape(-1)[4 * unit:4 * unit + 4].view(torch.uint8).int()
    got = fault.reshape(-1)[4 * unit:4 * unit + 4].view(torch.uint8).int()
    assert torch.equal(got, ((b & 0xF) << 4) | (b >> 4))
    assert not torch.equal(fault, q)
    assert torch.equal(chip_smoke._swap_unit_nibbles(fault, unit), q)
