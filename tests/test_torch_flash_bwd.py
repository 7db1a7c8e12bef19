"""The PyTorch port's flash-attention backward held to the JAX package's
Pallas backward kernels (`_bwd_dq_kernel`, `_bwd_dkv_kernel`, run in
interpret mode on the CPU, as tests/test_torch_kernels.py runs the forward).

On CPU tensors the port's autograd function runs the plain forward and the
plain backward (`flash_attention_bwd_reference`) — the numerics the CUDA
kernels (`ops/csrc/flash_bwd.cu`) are checked against on the card by
`chip_smoke.py`. The JAX side is `jax.vjp` of `flash_attention_with_lse`,
whose custom VJP is the pair of Pallas kernels.

Tolerance: fp32 on both sides with different summation orders (the Pallas
kernels sum dq / dk / dv over 128-row tiles, the plain version in one
einsum): rtol = atol = 1e-4 on gradients whose entries reach ~10.
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

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import op_builder

TOL = dict(rtol=1e-4, atol=1e-4)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _port_grads(q, k, v, do, dlse, causal, sm_scale, layout):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                            sm_scale=sm_scale, layout=layout)
    outputs, cots = [out], [torch.from_numpy(do)]
    if dlse is not None:
        outputs.append(lse)
        cots.append(torch.from_numpy(dlse))
    return [g.numpy() for g in torch.autograd.grad(outputs, (tq, tk, tv),
                                                   cots)]


def _jax_grads(fn, q, k, v, do, dlse):
    (out, lse), vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v))
    dl = jnp.zeros_like(lse) if dlse is None else jnp.asarray(dlse)
    return [np.asarray(g) for g in vjp((jnp.asarray(do), dl))]


@pytest.mark.parametrize("sm_scale", [None, 1.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 256])
def test_flash_backward_matches_pallas_vjp(T, causal, sm_scale):
    rng = np.random.default_rng(T + 3 * causal + 5 * (sm_scale is None))
    q, k, v, do = (_normal(rng, 2, 2, T, 64) for _ in range(4))
    want = _jax_grads(lambda a, b, c: flash_attention_with_lse(
        a, b, c, causal=causal, sm_scale=sm_scale), q, k, v, do, None)
    got = _port_grads(q, k, v, do, None, causal, sm_scale, "BHTD")
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_folds_the_lse_cotangent_like_pallas(causal):
    """A nonzero lse cotangent enters as delta' = delta - dlse, as
    `_flash_lse_vjp_bwd` folds it (ring attention's backward needs it)."""
    rng = np.random.default_rng(20 + causal)
    q, k, v, do = (_normal(rng, 2, 2, 128, 64) for _ in range(4))
    dlse = _normal(rng, 2, 2, 128)
    want = _jax_grads(lambda a, b, c: flash_attention_with_lse(
        a, b, c, causal=causal), q, k, v, do, dlse)
    got = _port_grads(q, k, v, do, dlse, causal, None, "BHTD")
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_flash_backward_gqa_sums_over_the_group_like_repeated_kv():
    """2 kv heads for 4 query heads in the model's [B, T, H, D] layout: the
    port's dk / dv [B, T, Hkv, D] equal the JAX kernel's on repeated k / v,
    summed by `jnp.repeat`'s transpose; with an lse cotangent."""
    rng = np.random.default_rng(30)
    B, T, H, Hkv, D = 2, 128, 4, 2, 64
    q, do = _normal(rng, B, T, H, D), _normal(rng, B, T, H, D)
    k, v = _normal(rng, B, T, Hkv, D), _normal(rng, B, T, Hkv, D)
    dlse = _normal(rng, B, H, T)
    bhtd = lambda x: jnp.swapaxes(x, 1, 2)

    def jax_fn(a, b, c):
        out, lse = flash_attention_with_lse(
            bhtd(a), jnp.repeat(bhtd(b), H // Hkv, axis=1),
            jnp.repeat(bhtd(c), H // Hkv, axis=1), causal=True)
        return bhtd(out), lse

    want = _jax_grads(jax_fn, q, k, v, do, dlse)
    got = _port_grads(q, k, v, do, dlse, True, None, "BTHD")
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_cpu_autograd_runs_the_plain_backward_and_launches_nothing():
    """Tensors that require grad go through the autograd function on the
    CPU too: its backward is `flash_attention_bwd_reference` on the saved
    (out, lse), bit for bit, and no kernel is built or launched."""
    rng = np.random.default_rng(31)
    q, k, v, do = (torch.from_numpy(_normal(rng, 1, 37, 4, 64))
                   for _ in range(4))
    op_builder.LAUNCHES.clear()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = tfa.flash_attention_with_lse(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    want = tfa.flash_attention_bwd_reference(q, k, v, out.detach(),
                                             lse.detach(), do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sum(op_builder.LAUNCHES.values()) == 0


# ----------------------------------------------------------------------
# the kernels' host side (no card needed: the launches are replaced) and
# the row measure chip_smoke.py holds the kernels to on the card
# ----------------------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               REPO / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B_, T_, H_, HKV_, D_ = 2, 40, 4, 2, 64


def _bwd_operands():
    """The backward launch's operands as the autograd function hands them
    over: [B, H, T, D] views of one fused [B, T, (H + 2 Hkv) D] bf16
    projection (q, k, v), do and lse / delta [B, H, T] fp32."""
    qkv = torch.zeros(B_, T_, (H_ + 2 * HKV_) * D_, dtype=torch.bfloat16)
    q, k, v = qkv.split([H_ * D_, HKV_ * D_, HKV_ * D_], dim=-1)
    q, k, v = (x.reshape(B_, T_, -1, D_).transpose(1, 2) for x in (q, k, v))
    do = torch.zeros(B_, T_, H_, D_, dtype=torch.bfloat16).transpose(1, 2)
    rows = torch.zeros(B_, H_, T_)
    return dict(qh=q, kh=k, vh=v, doh=do, lse=rows, delta=rows.clone())


def _bad(case, ops):
    """`ops` with one operand the tensor maps (or the kernels' lse / delta
    reads) cannot take."""
    ops = dict(ops)
    if case == "q_row_stride_not_16_bytes":
        ops["qh"] = torch.zeros(B_, H_, T_, D_ + 4,
                                dtype=torch.bfloat16)[..., :D_]
    elif case == "k_base_not_16_bytes":
        flat = torch.zeros(B_ * T_ * HKV_ * D_ + 8, dtype=torch.bfloat16)
        ops["kh"] = flat[4:4 + B_ * T_ * HKV_ * D_].reshape(
            B_, T_, HKV_, D_).transpose(1, 2)
    elif case == "v_expanded_heads":
        ops["vh"] = torch.zeros(B_, 1, T_, D_, dtype=torch.bfloat16) \
            .expand(B_, HKV_, T_, D_)
    elif case == "q_last_dim_strided":
        ops["qh"] = torch.zeros(B_, H_, T_, 2 * D_,
                                dtype=torch.bfloat16)[..., ::2]
    elif case == "lse_not_contiguous":
        ops["lse"] = torch.zeros(B_, T_, H_).transpose(1, 2)
    elif case == "lse_shape":
        ops["lse"] = torch.zeros(B_, H_, T_ + 1)
    elif case == "lse_dtype":
        ops["lse"] = torch.zeros(B_, H_, T_, dtype=torch.bfloat16)
    elif case == "delta_shape":
        ops["delta"] = torch.zeros(B_, HKV_, T_)
    elif case == "delta_not_contiguous":
        ops["delta"] = torch.zeros(B_, H_, 2 * T_)[..., ::2]
    else:
        raise ValueError(case)
    return ops


@pytest.mark.parametrize("need", [(True, False), (False, True)],
                         ids=["dq", "dkv"])
@pytest.mark.parametrize("case", [
    "q_row_stride_not_16_bytes", "k_base_not_16_bytes", "v_expanded_heads",
    "q_last_dim_strided", "lse_not_contiguous", "lse_shape", "lse_dtype",
    "delta_shape", "delta_not_contiguous"])
def test_backward_launch_refuses_what_the_kernels_cannot_read(
        case, need, monkeypatch):
    """Handed a q/k/v view its tensor maps cannot describe (a stride that
    is not a multiple of 16 bytes or is 0, a misaligned base, a strided
    last dim) or an lse / delta that is not a contiguous fp32 [B, H, T]
    tensor, `_launch_bwd` raises ValueError before any kernel library is
    requested, for either pass."""

    def load(name):
        raise AssertionError(f"kernel library {name} requested")

    monkeypatch.setattr(op_builder, "load", load)
    with pytest.raises(ValueError):
        tfa._launch_bwd(**_bad(case, _bwd_operands()), sm_scale=0.125,
                        causal=True, need_dq=need[0], need_dkv=need[1])


def _record_launches(monkeypatch):
    calls = []

    def kernel(source, symbol):
        assert source == "flash_bwd"
        return lambda *a: calls.append((symbol, a)) or 0

    monkeypatch.setattr(tfa, "_kernel", kernel)
    monkeypatch.setattr(op_builder, "stream_ptr", lambda device: None)
    return calls


@pytest.mark.parametrize("need", [(True, False), (False, True), (True, True)],
                         ids=["dq", "dkv", "both"])
def test_backward_launch_hands_each_pass_its_operands(need, monkeypatch):
    """One launch a pass asked for, each with (B, H, Hkv, T, D), the 18
    (batch, head, time) element strides in the C order (q, k, v, do, then
    dq or dk, dv), the scale, causal, the dtype code; the gradients are
    [B, H(kv), T, D] views of [B, T, H(kv), D] tensors of their own."""
    calls = _record_launches(monkeypatch)
    ops = _bwd_operands()
    op_builder.LAUNCHES.clear()
    dq, dk, dv = tfa._launch_bwd(**ops, sm_scale=0.125, causal=True,
                                 need_dq=need[0], need_dkv=need[1])
    want = [s for flag, s in zip(need, ("dstt_flash_bwd_dq",
                                        "dstt_flash_bwd_dkv")) if flag]
    assert [c[0] for c in calls] == want
    assert (dq is not None) == need[0]
    assert (dk is not None) == (dv is not None) == need[1]

    def bht(x):
        return [x.stride(0), x.stride(1), x.stride(2)]

    inputs = [s for x in ("qh", "kh", "vh", "doh") for s in bht(ops[x])]
    for symbol, a in calls:
        n_ptr = 7 if symbol == "dstt_flash_bwd_dq" else 8
        assert a[0] == ops["qh"].data_ptr() and a[3] == ops["doh"].data_ptr()
        assert a[4] == ops["lse"].data_ptr()
        assert a[5] == ops["delta"].data_ptr()
        assert a[n_ptr:n_ptr + 5] == (B_, H_, HKV_, T_, D_)
        strides = list(a[n_ptr + 5])
        assert len(strides) == 18 and strides[:12] == inputs
        grads = [dq] if symbol == "dstt_flash_bwd_dq" else [dk, dv]
        assert [g.data_ptr() for g in grads] == list(a[6:n_ptr])
        assert strides[12:12 + 3 * len(grads)] == \
            [s for g in grads for s in bht(g)]
        assert a[n_ptr + 6:n_ptr + 9] == (0.125, 1, 1)
    for g, h in ((dq, H_), (dk, HKV_), (dv, HKV_)):
        if g is not None:
            assert g.shape == (B_, h, T_, D_)
            assert g.transpose(1, 2).is_contiguous()
    assert op_builder.LAUNCHES["flash_attention_bwd_dq"] == int(need[0])
    assert op_builder.LAUNCHES["flash_attention_bwd_dkv"] == int(need[1])


def test_backward_launch_copies_a_do_it_cannot_read_in_place(monkeypatch):
    """A do whose rows are not 16-byte aligned is handed to the kernels as
    a copy with the same values that the tensor maps can describe, not
    refused; q / k / v are never copied."""
    calls = _record_launches(monkeypatch)
    checked = []
    check = tfa.check_kernel_operands

    def record(q, k, v, extra=(), layout="BHTD"):
        checked.append(dict(extra))
        return check(q, k, v, extra, layout)

    monkeypatch.setattr(tfa, "check_kernel_operands", record)
    ops = _bwd_operands()
    odd = torch.arange(B_ * H_ * T_ * (D_ + 4), dtype=torch.float32) \
        .reshape(B_, H_, T_, D_ + 4).to(torch.bfloat16)[..., :D_]
    ops["doh"] = odd
    tfa._launch_bwd(**ops, sm_scale=0.125, causal=False, need_dq=True,
                    need_dkv=False)
    (_, a), = calls
    (extra,), do = checked, checked[0]["do"]
    assert do.data_ptr() == a[3] != odd.data_ptr()
    assert torch.equal(do, odd) and tfa._kernel_layout_ok(do)
    assert list(a[12])[9:12] == [do.stride(0), do.stride(1), do.stride(2)]
    assert a[0] == ops["qh"].data_ptr() and a[1] == ops["kh"].data_ptr()
    assert a[-3] == 0                        # causal off


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "const long long*": ctypes.POINTER(ctypes.c_longlong)}


@pytest.mark.parametrize("source, symbol", [
    ("flash_fwd.cu", "dstt_flash_fwd"),
    ("flash_bwd.cu", "dstt_flash_bwd_dq"),
    ("flash_bwd.cu", "dstt_flash_bwd_dkv")])
def test_argtypes_match_the_c_signatures(source, symbol):
    """`_ARGTYPES` declares each parameter of the extern "C" entry point
    with the ctypes type its C type needs (a pointer never as a 32-bit
    int), in order."""
    text = (Path(tfa.__file__).parent / "csrc" / source).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, f"{symbol} not found in {source}"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    ctypes_of = [_C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
                 for p in params]
    assert tfa._ARGTYPES[symbol] == ctypes_of


def _dropped_tile_case(causal):
    rng = np.random.default_rng(40 + causal)
    B, T, H, Hkv, D = 1, 256, 4, 2, 64
    q, do = (torch.from_numpy(_normal(rng, B, T, H, D)) for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, B, T, Hkv, D)) for _ in range(2))
    out, lse = tfa.flash_attention_reference(q, k, v, causal)
    return (q, k, v, out, lse, do, None, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fault", ["first_tile", "diagonal_tile"])
def test_row_measure_sees_a_dropped_tile_on_the_plain_versions(fault,
                                                               causal):
    """chip_smoke.py's planted faults, on the plain versions: the plain
    backward with q tile 2 missing k tile 0 (or its diagonal tile 2) is
    farther than SPARSE_ROW_TOL from the plain backward, row by row, in
    dq, dk and dv (GQA 2: dk / dv summed over the group)."""
    args = _dropped_tile_case(causal)
    ref = tfa.flash_attention_bwd_reference(*args)
    bad = chip_smoke._flash_dropped_bwd(2, 0 if fault == "first_tile" else 2,
                                        *args)
    for name, g, r in zip(("dq", "dk", "dv"), bad, ref):
        row = chip_smoke._row_err(g, r)
        assert row > chip_smoke.SPARSE_ROW_TOL, (name, row)
    # the patch is undone: the plain backward is itself again
    again = tfa.flash_attention_bwd_reference(*args)
    for g, r in zip(again, ref):
        assert torch.equal(g, r)


def test_row_measure_passes_the_pallas_backward():
    """The same measure holds the JAX package's Pallas backward (interpret
    mode) to the port's plain backward well inside SPARSE_ROW_TOL: it
    flags a missing tile, not a sound kernel's other summation order."""
    q, k, v, out, lse, do, _, causal = _dropped_tile_case(True)
    rep = q.shape[2] // k.shape[2]
    bhtd = lambda x: jnp.swapaxes(x, 1, 2)

    def jax_fn(a, b, c):
        o, l = flash_attention_with_lse(
            bhtd(a), jnp.repeat(bhtd(b), rep, axis=1),
            jnp.repeat(bhtd(c), rep, axis=1), causal=causal)
        return bhtd(o), l

    want = _jax_grads(jax_fn, q.numpy(), k.numpy(), v.numpy(), do.numpy(),
                      None)
    got = tfa.flash_attention_bwd_reference(q, k, v, out, lse, do, None,
                                            causal)
    for g, w in zip(got, want):
        assert chip_smoke._row_err(g, torch.from_numpy(np.array(w))) \
            < chip_smoke.SPARSE_ROW_TOL / 10
