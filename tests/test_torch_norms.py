"""The port's fused LayerNorm / RMSNorm held to the JAX package's Pallas op
(`deepspeed_tpu/ops/pallas/norms.py`, in interpret mode, as its own tests
run it) at the widths and dtypes the CUDA kernel takes beyond the first
port's: rows that are not a multiple of 16 bytes (D 100; D 1000 in bf16),
a width past the old 8192 limit (12288), residuals of another dtype (the
output in the promoted dtype, as JAX's `x + residual` before its call
gives it) and bf16 / fp16 scale and bias. On the CPU the wrappers run
their plain versions, the numerics chip_smoke.py holds the kernel to on
the card. Inputs come from numpy seeds. Tolerance: fp32 outputs atol
1e-5; 16-bit outputs one output-dtype step at max|ref| (the fp32
statistics differ only in their summation order, and the output is
rounded once).

chip_smoke.py's norms check is held here too, on plain versions: the
sound version passes it, and both planted faults it must reject (a row's
last 16-byte vector left out of the statistics, a ring slot read stale)
fail it. The wrapper's ctypes declaration is held to the kernel's C
signature.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import norms as jnorms
from deepspeed_tpu_torch.ops import norms as tnorms
from deepspeed_tpu_torch.ops import op_builder

# the check chip_smoke.py holds the kernel to on the card
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# rows, D, x dtype, residual dtype, scale / bias dtype
CASES = {
    "d100_bf16": (6, 100, "bfloat16", None, "float32"),
    "d1000_bf16_residual": (5, 1000, "bfloat16", "bfloat16", "float32"),
    "d1000_fp32_residual": (5, 1000, "float32", "float32", "float32"),
    "d12288_bf16": (3, 12288, "bfloat16", None, "float32"),
    "bf16_x_fp32_residual": (8, 256, "bfloat16", "float32", "float32"),
    "fp16_x_bf16_residual": (8, 96, "float16", "bfloat16", "float32"),
    "fp32_x_fp16_residual": (4, 40, "float32", "float16", "float32"),
    "bf16_parameters": (8, 768, "bfloat16", None, "bfloat16"),
    "fp16_parameters_fp32_x": (4, 64, "float32", None, "float16"),
    "d1": (7, 1, "float32", None, "float32"),
}


def _inputs(rows, D, dtype, res_dtype, param_dtype, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, D)).astype(np.float32)
    r = rng.normal(size=(rows, D)).astype(np.float32) if res_dtype else None
    scale = (1 + 0.1 * rng.normal(size=D)).astype(np.float32)
    bias = (0.1 * rng.normal(size=D)).astype(np.float32)
    return x, r, scale, bias


@pytest.mark.parametrize("op", ["layer", "rms"])
@pytest.mark.parametrize("case", list(CASES))
def test_norm_matches_the_pallas_op(case, op):
    """Each op against the Pallas kernel in interpret mode on the same
    inputs, each tensor in its case's dtype: the output dtype is the
    promoted dtype of x and the residual in both packages."""
    rows, D, dtype, res_dtype, param_dtype = CASES[case]
    x, r, scale, bias = _inputs(rows, D, dtype, res_dtype, param_dtype)

    def j(a, t):
        return None if a is None else jnp.asarray(a, getattr(jnp, t))

    def t(a, dt):
        return None if a is None else torch.from_numpy(a).to(
            getattr(torch, dt))
    jr, tr = j(r, res_dtype or dtype), t(r, res_dtype or dtype)
    op_builder.LAUNCHES.clear()
    if op == "layer":
        want = jnorms.fused_layer_norm(j(x, dtype), j(scale, param_dtype),
                                       j(bias, param_dtype), 1e-5, jr,
                                       interpret=True)
        got = tnorms.fused_layer_norm(t(x, dtype), t(scale, param_dtype),
                                      t(bias, param_dtype), 1e-5, tr)
    else:
        want = jnorms.fused_rms_norm(j(x, dtype), j(scale, param_dtype), 1e-5,
                                     jr, interpret=True)
        got = tnorms.fused_rms_norm(t(x, dtype), t(scale, param_dtype), 1e-5,
                                    tr)
    assert sum(op_builder.LAUNCHES.values()) == 0
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert tuple(got.shape) == (rows, D)
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if got.dtype == torch.float32 else \
        torch.finfo(got.dtype).eps * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_a_residual_of_another_dtype_promotes_as_jax_does():
    """bf16 + fp16 -> fp32, bf16 + fp32 -> fp32, fp32 + fp16 -> fp32 in
    both packages; the residual is added in that dtype before the norm."""
    for a, b in (("bfloat16", "float16"), ("bfloat16", "float32"),
                 ("float32", "float16"), ("float16", "float16")):
        want = jnp.promote_types(getattr(jnp, a), getattr(jnp, b))
        got = tnorms.fused_rms_norm(torch.ones(2, 8, dtype=getattr(torch, a)),
                                    torch.ones(8),
                                    residual=torch.ones(
                                        2, 8, dtype=getattr(torch, b)))
        assert str(got.dtype).split(".")[-1] == str(jnp.dtype(want))


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
def test_chip_smoke_norm_check_rejects_both_planted_faults(rms):
    """chip_smoke's norms check on plain versions at [288, 4096] bf16 (the
    block-row kernel's width, rows past two rounds of its fault grid): the
    sound version passes; a row's last 16-byte vector left out of the
    statistics and a ring's second slot read stale both fail it."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(288, 4096)).astype(
        np.float32)).bfloat16()
    scale = torch.from_numpy((1 + 0.1 * rng.normal(size=4096)).astype(
        np.float32)).bfloat16()
    bias = torch.from_numpy((0.1 * rng.normal(size=4096)).astype(
        np.float32)).bfloat16()
    if rms:
        plain = lambda x, r: tnorms.rms_norm_reference(x, scale, 1e-5, r)
    else:
        plain = lambda x, r: tnorms.layer_norm_reference(x, scale, bias, 1e-5,
                                                         r)
    ref = plain(x, None)
    sound = tnorms.fused_rms_norm(x, scale) if rms else \
        tnorms.fused_layer_norm(x, scale, bias)
    assert chip_smoke._norm_check("fused_layer_norm", "cpu", sound, ref,
                                  [])["ok"]
    for fault, bad in (
            ("last_vector", chip_smoke._norm_fault_last_vector(
                x, scale, bias, None, rms)),
            ("stale_slot", chip_smoke._norm_fault_stale_slot(plain, x, None))):
        row = chip_smoke._norm_check("fused_layer_norm", "cpu", bad, ref, [],
                                     fault=fault)
        assert row["seen"], (fault, row)


def test_norm_check_sees_the_last_vector_fault_at_each_sweep_case():
    """At every chip_smoke NORM_SWEEP case (plain versions, the case's
    shape, dtypes and residual; a few rows of the widest ones), the sound
    version passes chip_smoke's norms check and the last-vector fault
    fails it, as the card's run requires; the bf16 residual at the main
    shape (the warp-row kernel's residual add) among them."""
    rng = np.random.default_rng(6)
    assert ("gpt2_125m_res", 4096, 768, "bfloat16", "bfloat16") in \
        chip_smoke.NORM_SWEEP
    for case, rows, D, dtype, res_dtype in chip_smoke.NORM_SWEEP:
        rows = min(rows, max(16, (1 << 22) // D))

        def randn(*shape, dt=dtype):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(getattr(torch, dt))
        x = randn(rows, D)
        r = randn(rows, D, dt=res_dtype) if res_dtype else None
        scale, bias = 1 + 0.1 * randn(D), 0.1 * randn(D)
        for rms in (False, True):
            ref = tnorms.rms_norm_reference(x, scale, 1e-5, r) if rms else \
                tnorms.layer_norm_reference(x, scale, bias, 1e-5, r)
            sound = tnorms.fused_rms_norm(x, scale, 1e-5, r) if rms else \
                tnorms.fused_layer_norm(x, scale, bias, 1e-5, r)
            assert chip_smoke._norm_check(case, "cpu", sound, ref, [])["ok"]
            bad = chip_smoke._norm_fault_last_vector(x, scale, bias, r, rms)
            row = chip_smoke._norm_check(case, "cpu", bad, ref, [],
                                         fault="last_vector")
            assert row["seen"], (case, rms, row)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}


def test_argtypes_match_the_c_signature():
    """`_ARGTYPES` declares each parameter of `dstt_norm` with the ctypes
    type its C type needs (a pointer never as a 32-bit int), in order."""
    text = (Path(tnorms.__file__).parent / "csrc" / "norms.cu").read_text()
    m = re.search(r'extern "C" int dstt_norm\(([^)]*)\)', text)
    assert m, "dstt_norm not found"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    ctypes_of = [_C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
                 for p in params]
    assert tnorms._ARGTYPES == ctypes_of
