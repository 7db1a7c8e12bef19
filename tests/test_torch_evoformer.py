"""The PyTorch port's Evoformer attention held to the JAX package's
`evoformer_attention`: no bias, the key-mask bias, the pair bias, both,
broadcast biases, the triangle-attention pattern, the q / k / v / mask /
pair gradients, and the bad-shape and duplicate refusals — the cases of
tests/test_evoformer.py.

Inputs come from numpy seeds. The JAX op runs its Pallas forward in
interpret mode on the CPU (its backward is jnp); the port runs its kernel's
plain version (`csrc/evoformer_attn.cu` is checked against it on the card
by chip_smoke.py) and its plain backward. Everything is fp32: outputs and
gradients at rtol = atol = 2e-5 (the two sum in other orders).
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.evoformer_attn import \
    evoformer_attention as jax_evoformer
from deepspeed_tpu_torch.ops import evoformer_attn as tevo
from deepspeed_tpu_torch.ops import op_builder

# the checks chip_smoke.py holds the kernel to on the card
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = dict(rtol=2e-5, atol=2e-5)
B, N, S, H, D = 1, 3, 16, 2, 8


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _mask(shape, seed):
    return np.where(_rand(shape, seed) > 0, 0.0, -1e9).astype(np.float32)


def _qkv(seed=0, shape=(B, N, S, H, D)):
    return tuple(_rand(shape, seed + i) for i in range(3))


BIAS_CASES = {
    "none": lambda: [],
    "mask": lambda: [_mask((B, N, 1, 1, S), 3)],
    "pair": lambda: [_rand((B, 1, H, S, S), 4)],
    "both": lambda: [_mask((B, N, 1, 1, S), 5), _rand((B, 1, H, S, S), 6)],
    "pair_then_mask": lambda: [_rand((B, 1, H, S, S), 7),
                               _mask((B, N, 1, 1, S), 8)],
}


@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_forward_matches_jax(case):
    q, k, v = _qkv()
    biases = BIAS_CASES[case]()
    want = jax_evoformer(*map(jnp.asarray, (q, k, v)),
                         biases=[jnp.asarray(b) for b in biases])
    op_builder.LAUNCHES.clear()
    got = tevo.evoformer_attention(
        *map(torch.from_numpy, (q, k, v)),
        biases=[torch.from_numpy(b) for b in biases])
    assert sum(op_builder.LAUNCHES.values()) == 0
    assert got.shape == (B, N, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_is_the_plain_version():
    q, k, v = _qkv(1)
    biases = [torch.from_numpy(b) for b in BIAS_CASES["both"]()]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(
        tevo.evoformer_attention(tq, tk, tv, biases=biases),
        tevo.evoformer_attention_reference(tq, tk, tv, biases=biases),
        rtol=0, atol=0)


@pytest.mark.parametrize("shapes", [
    ((2, N, 1, 1, S), (2, 1, H, S, S)),        # full
    ((1, N, 1, 1, S), (1, 1, H, S, S)),        # shared over the batch
    ((2, 1, 1, 1, S), (2, 1, 1, S, S)),        # over rows / heads
], ids=["full", "batch-broadcast", "row-head-broadcast"])
def test_gradients_match_jax(shapes):
    """dq, dk, dv, dmask and dpair against jax.grad; broadcast biases get
    their gradients summed back to their own shapes."""
    q, k, v = _qkv(9, (2, N, S, H, D))
    mask = _rand(shapes[0], 11)
    pair = _rand(shapes[1], 12)
    g = _rand((2, N, S, H, D), 13)

    def f(q, k, v, m, p):
        return jnp.sum(jax_evoformer(q, k, v, biases=[m, p]) * g)
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (q, k, v, mask, pair)))
    ins = [torch.from_numpy(x).requires_grad_(True)
           for x in (q, k, v, mask, pair)]
    out = tevo.evoformer_attention(*ins[:3], biases=ins[3:])
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, a, w in zip(("q", "k", "v", "mask", "pair"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_mask_only_gradient_matches_jax():
    q, k, v = _qkv(14)
    mask = _rand((B, N, 1, 1, S), 15)

    def f(m):
        return jnp.sum(jax_evoformer(*map(jnp.asarray, (q, k, v)),
                                     biases=[m]) ** 2)
    want = jax.grad(f)(jnp.asarray(mask))
    tm = torch.from_numpy(mask).requires_grad_(True)
    out = tevo.evoformer_attention(*map(torch.from_numpy, (q, k, v)),
                                   biases=[tm])
    got, = torch.autograd.grad((out ** 2).sum(), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_triangle_attention_pattern():
    """Triangle attention on a pair activation [B, I, I, H, D]: rows of the
    pair matrix attend along J with a per-head triangle bias — the N = I
    case of the op."""
    Bt, I, Ht, Dt = 1, 4, 2, 8
    q, k, v = (_rand((Bt, I, I, Ht, Dt), 21 + i) for i in range(3))
    tri = _rand((Bt, 1, Ht, I, I), 24)
    want = jax_evoformer(*map(jnp.asarray, (q, k, v)),
                         biases=[jnp.asarray(tri)])
    got = tevo.evoformer_attention(*map(torch.from_numpy, (q, k, v)),
                                   biases=[torch.from_numpy(tri)])
    assert got.shape == (Bt, I, I, Ht, Dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("biases,match", [
    ([(B, N, H, S, S)], "unsupported bias shape"),
    ([(B, N, S, S)], "5-D"),
    ([(B, N, 1, 1, S), (B, N, 1, 1, S)], "duplicate mask"),
    ([(B, 1, H, S, S), (B, 1, H, S, S)], "duplicate pair"),
], ids=["full-bias", "4-d", "two-masks", "two-pairs"])
def test_refuses_what_jax_refuses(biases, match):
    q, k, v = _qkv(30)
    arrays = [_rand(s, 31 + i) for i, s in enumerate(biases)]
    with pytest.raises(ValueError, match=match):
        jax_evoformer(*map(jnp.asarray, (q, k, v)),
                      biases=[jnp.asarray(a) for a in arrays])
    with pytest.raises(ValueError, match=match):
        tevo.evoformer_attention(*map(torch.from_numpy, (q, k, v)),
                                 biases=[torch.from_numpy(a) for a in arrays])


def test_refuses_a_bias_that_does_not_broadcast():
    q, k, v = _qkv(40)
    with pytest.raises(ValueError, match="broadcast"):
        tevo.evoformer_attention(*map(torch.from_numpy, (q, k, v)), biases=[
            torch.zeros(B, N + 1, 1, 1, S)])


# ----------------------------------------------------------------------
# the kernel's host side (no kernel runs) and the chunked backward
# ----------------------------------------------------------------------

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong,
            "const long long*": ctypes.POINTER(ctypes.c_longlong)}


def test_argtypes_match_the_c_signature():
    """`_ARGTYPES` declares each parameter of `dstt_evoformer_fwd` with the
    ctypes type its C type needs (a pointer never as a 32-bit int), in
    order."""
    text = (Path(tevo.__file__).parent / "csrc" / "evoformer_attn.cu") \
        .read_text()
    m = re.search(r'extern "C" int dstt_evoformer_fwd\(([^)]*)\)', text)
    assert m, "dstt_evoformer_fwd not found"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    ctypes_of = [_C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
                 for p in params]
    assert tevo._ARGTYPES == ctypes_of


class _FakeEntry:
    """Stands in for the library's entry point: records each call."""
    argtypes = restype = None

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_kernel(monkeypatch):
    entry = _FakeEntry()

    class _Lib:
        dstt_evoformer_fwd = entry
    monkeypatch.setattr(op_builder, "load", lambda name: _Lib)
    monkeypatch.setattr(op_builder, "stream_ptr", lambda device: None)
    return entry


def _bf16(shape, seed, dtype=torch.bfloat16):
    return torch.from_numpy(_rand(shape, seed)).to(dtype)


@pytest.mark.parametrize("pair_dtype, in_place, code", [
    (torch.bfloat16, True, 1), (torch.float32, True, 0),
    (torch.float16, False, 0)], ids=["bf16", "fp32", "fp16-widened"])
def test_launch_reads_biases_in_their_own_dtype(fake_kernel, pair_dtype,
                                                in_place, code):
    """Under bf16 q the kernel takes the mask in its dtype and the pair in
    q's dtype or fp32: those pass in place (no .float() pass, no copy);
    another pair dtype is widened to fp32."""
    q, k, v = (_bf16((B, N, S, H, 32), 50 + i) for i in range(3))
    mask = _bf16((B, N, S), 53)
    pair = _bf16((B, H, S, S), 54, pair_dtype)
    tevo._launch(q, k, v, mask, pair, 0.125)
    (a,), = [fake_kernel.calls]
    assert a[4] == mask.data_ptr() and a[16] == 1
    assert (a[5] == pair.data_ptr()) == in_place and a[17] == code
    assert a[19] == 1 and fake_kernel.argtypes == tevo._ARGTYPES


@pytest.mark.parametrize("view", ["fused", "odd_stride"])
def test_launch_copies_only_views_tma_cannot_read(fake_kernel, view):
    """q / k / v as views of one [B, N, S, 3, H, D] tensor pass in place
    (strides multiples of 16 bytes); a view whose head stride is 36
    elements (72 bytes) is made contiguous before the library is loaded."""
    D = 32
    if view == "fused":
        base = _bf16((B, N, S, 3, H, D), 60)
        q, k, v = base.unbind(3)
    else:
        base = _bf16((B, N, S, H, D + 4), 60)[..., :D]
        q = k = v = base
    tevo._launch(q, k, v, None, None, 0.125)
    (a,), = [fake_kernel.calls]
    strides = list(a[11])
    if view == "fused":
        assert a[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert strides[:4] == list(q.stride()[:4])
    else:
        assert a[0] != q.data_ptr() and strides[:4] == [
            N * S * H * D, S * H * D, H * D, D]
    assert a[4] is None and a[5] is None


def test_kernel_operands_take_any_row_count_and_refuse_odd_heads():
    """B * N * H above 65 535 is taken (the persistent walk); a head dim
    outside {32, 64, 128} and S 0 are still refused (meta tensors: no
    data, no kernel)."""
    big = torch.empty((1, 8200, 16, 8, 32), dtype=torch.bfloat16,
                      device="meta")
    tevo.check_kernel_operands(big, big, big)
    for shape in ((1, 2, 16, 2, 16), (1, 2, 16, 2, 96), (1, 2, 0, 2, 32)):
        t = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="kernel takes|out of range"):
            tevo.check_kernel_operands(t, t, t)


def _bwd_case(seed, shapes):
    q, k, v = (torch.from_numpy(x) for x in _qkv(seed, (2, 5, S, H, D)))
    mask = torch.from_numpy(_rand(shapes[0], seed + 3))[:, :, 0, 0]
    pair = torch.from_numpy(_rand(shapes[1], seed + 4))[:, 0]
    g = torch.from_numpy(_rand((2, 5, S, H, D), seed + 5))
    return q, k, v, mask, pair, g


@pytest.mark.parametrize("shapes", [
    ((2, 5, 1, 1, S), (2, 1, H, S, S)),
    ((1, 5, 1, 1, S), (1, 1, 1, S, S))], ids=["full", "broadcast"])
def test_chunked_backward_equals_the_per_row_loop(shapes):
    """Recomputing the attention all 5 MSA rows at once (or 2 at a time)
    gives the per-row loop's gradients within fp32 order noise."""
    args = _bwd_case(70, shapes)
    per_row = tevo._backward(*args, 0.3, rows=1)
    for rows in (2, 5):
        for name, a, b in zip(("q", "k", "v", "mask", "pair"),
                              tevo._backward(*args, 0.3, rows=rows),
                              per_row):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {rows}")


def test_chunked_backward_matches_jax():
    """Chunks of 2 of 5 rows (the last one short) against jax.grad."""
    q, k, v, mask, pair, g = _bwd_case(80, ((2, 5, 1, 1, S),
                                            (2, 1, H, S, S)))

    def f(*xs):
        return jnp.sum(jax_evoformer(*xs[:3], biases=[
            xs[3][:, :, None, None], xs[4][:, None]]) * g.numpy())
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, mask, pair)))
    got = tevo._backward(q, k, v, mask, pair, g, 1.0 / D ** 0.5, rows=2)
    for name, a, w in zip(("q", "k", "v", "mask", "pair"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_backward_chunk_keeps_its_bound():
    """At the evoformer phase's shapes the chunk's fp32 intermediates stay
    under BWD_CHUNK_BYTES (32 and 64 rows of 128 and 256), and a row wider
    than the bound still runs one row at a time."""
    for (Bq, Nq, Sq, Hq), rows in (((1, 128, 256, 8), 32),
                                   ((1, 256, 256, 4), 64)):
        assert tevo.bwd_rows(Bq, Nq, Sq, Hq) == rows
        assert tevo._BWD_LIVE * rows * Bq * Hq * Sq * Sq * 4 \
            <= tevo.BWD_CHUNK_BYTES
    assert tevo.bwd_rows(1, 4, 8192, 8) == 1


def _fault_case(dtype=torch.bfloat16):
    rng = np.random.default_rng(90)
    Bf, Nf, Sf, Hf, Df = 1, 4, 192, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (Bf, Nf, Sf, Hf, Df)).astype(np.float32)).to(dtype)
        for _ in range(3))
    mask = torch.from_numpy(np.where(rng.random((Bf, Nf, 1, 1, Sf)) < 0.1,
                                     -1e9, 0.0).astype(np.float32))
    pair = torch.from_numpy(rng.standard_normal(
        (Bf, 1, Hf, Sf, Sf)).astype(np.float32))
    biases = [mask.to(dtype), pair.to(dtype)]
    return q, k, v, biases


@pytest.mark.parametrize("fault", ["dropped_tile", "narrowed_p"])
def test_planted_faults_fail_the_kernel_checks(fault):
    """chip_smoke.py's planted faults, on the CPU: the plain forward with
    one key tile dropped exceeds the one-step tolerance; with P narrowed
    to one bf16 piece its bit-equal share falls below EVO_BIT_EQUAL_MIN;
    the plain forward itself passes both."""
    q, k, v, biases = _fault_case()
    ref = tevo.evoformer_attention_reference(q, k, v, biases)
    tol = chip_smoke._evo_tol(ref, q.dtype)
    err, share = chip_smoke._evo_readings(
        chip_smoke._evo_plain_fault(q, k, v, biases, fault), ref)
    if fault == "dropped_tile":
        assert err > tol
    else:
        assert share < chip_smoke.EVO_BIT_EQUAL_MIN
    assert chip_smoke._evo_readings(ref, ref) == (0.0, 1.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_check_sees_a_narrowed_p_beyond_the_paths(dtype):
    """chip_smoke's `_evo_check` at a case beyond the paths' shapes, on the
    CPU: it holds a 16-bit output to its dtype's bit-equal floor, plants P
    narrowed to one piece of V's type on the same inputs and requires the
    floor to reject it; an output computed that way fails the check while
    staying within the one-step tolerance, and the plain output passes."""
    q, k, v, biases = _fault_case(dtype)
    ref = tevo.evoformer_attention_reference(q, k, v, biases)
    check = chip_smoke._evo_check(None, q, k, v, biases, ref, ref)
    floor = chip_smoke.EVO_EDGE_BIT_EQUAL_MIN[str(dtype)]
    assert check["ok"] and check["bit_equal_min"] == floor
    assert check["faults"]["narrowed_p"]["bit_equal_share"] < floor
    narrowed = chip_smoke._evo_plain_fault(q, k, v, biases, "narrowed_p")
    assert narrowed.dtype == dtype
    bad = chip_smoke._evo_check(None, q, k, v, biases, narrowed, ref)
    assert not bad["ok"] and bad["max_abs_err"] <= bad["tol"]


def test_bit_equal_share_passes_the_pallas_kernel():
    """The same measure holds the JAX package's Pallas forward (interpret
    mode, fp32 inside, q scaled before its product) to the port's plain
    version above EVO_BIT_EQUAL_MIN: it flags a narrowed P, not another
    sound fp32 order of operations."""
    q, k, v, biases = _fault_case()
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    want = jax_evoformer(*map(as_jax, (q, k, v)),
                         biases=[as_jax(b) for b in biases])
    got = tevo.evoformer_attention_reference(q, k, v, biases)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))) \
        .to(torch.bfloat16)
    _, share = chip_smoke._evo_readings(got, want)
    assert share >= chip_smoke.EVO_BIT_EQUAL_MIN, share
