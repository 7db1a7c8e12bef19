"""A/B of the fused LayerNorm / RMSNorm kernel built from several source
directories (copies of `deepspeed_tpu_torch/ops/csrc`, e.g. the parent
commit's), checked and timed in turns on one CUDA card beside
`F.layer_norm` / `F.rms_norm`.

    python tools/norms_ab.py DIR [DIR ...] [--reps N] [--ptxas]

With --ptxas, first prints for each directory what nvcc's `-Xptxas -v`
says of each kernel of its `norms.cu`. Then, for each case of
chip_smoke.NORM_SWEEP (bf16 unless noted, scale and bias in x's dtype)
and each op, it checks each directory's kernel against the plain version
(max abs error against one output-dtype step at max|ref|, and the share
of output elements bit-equal to it) and times, for each directory and
the library call:
  * device time alone, the calls in CUDA graphs replayed in turns
    (`chip_smoke.graph_ms_turns`), rotating over input sets that move
    chip_smoke.NORM_COLD_BYTES between two uses of one, so no input is
    read from L2 (`graph_ms`);
  * the profiler's kernel time a call and the kernels' names and launches
    a call, over the same rotation (`device_ms`, `kernels`);
  * the host's time a call, calls enqueued back to back (`host_ms`);
  * eager calls timed in turns (`eager_ms`, `chip_smoke.median_ms_turns`).
A directory whose entry point is the older one (fp32 scale and bias
only, D a multiple of 16 bytes and at most 8192, one dtype) is timed as
its kernel alone on parameters widened beforehand (`<dir>`) and as its
wrapper called it, widening bf16 / fp16 parameters on every call
(`<dir>:wrapper`); cases outside its contract print "unsupported". To
A/B another crossover between the warp-row and block-row kernels, give a
copy with another `kWarpMaxBytes`. Prints one JSON line per (case, op,
variant) and the card's name and power limit. Run from the repo's root; it needs the
CUDA toolkit and a card.
"""

import argparse
import ctypes
import json
import pathlib
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from attn_fwd_ab import _ptxas, _use  # noqa: E402  (this directory)
from deepspeed_tpu_torch.ops import norms  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

# the older entry point: fp32 scale / bias, one dtype code
_OLD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
_OLD_MAX_DIM = 8192


def _old_signature(src):
    return "param_dtype" not in (pathlib.Path(src) / "norms.cu").read_text()


def _old_takes(x, residual):
    vec = 16 // x.element_size()
    D = x.shape[-1]
    return D % vec == 0 and D <= _OLD_MAX_DIM and (
        residual is None or residual.dtype == x.dtype)


def _old_launch(lib, x, scale32, bias32, residual, rms):
    """The older entry point (its wrapper's launch, parameters already
    fp32)."""
    fn = lib.dstt_norm
    if fn.argtypes is None:
        fn.argtypes = _OLD_ARGTYPES
        fn.restype = ctypes.c_int
    D = x.shape[-1]
    out = torch.empty_like(x)
    rc = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
            scale32.data_ptr(), bias32.data_ptr(), out.data_ptr(),
            x.numel() // D, D, 1e-5, int(rms), op_builder.dtype_code(x.dtype),
            op_builder.stream_ptr(x.device))
    op_builder.check(rc, "dstt_norm (older entry point)")
    return out


def _variants(dirs, libs, op, scale, bias):
    """(label, fn(x, residual)) for each timed variant of `op`."""
    rms = op == "fused_rms_norm"
    out = []

    def new_call(lib):
        def call(x, residual):
            op_builder._LIBS["norms"] = lib
            if rms:
                return norms.fused_rms_norm(x, scale, 1e-5, residual)
            return norms.fused_layer_norm(x, scale, bias, 1e-5, residual)
        return call

    for src in dirs:
        lib = libs[src]
        if _old_signature(src):
            s32, b32 = scale.float(), bias.float()
            out.append((src, lambda x, residual, lib=lib, s32=s32, b32=b32:
                        _old_launch(lib, x, s32, b32, residual, rms)))
            out.append((src + ":wrapper",
                        lambda x, residual, lib=lib: _old_launch(
                            lib, x, scale.float().contiguous(),
                            bias.float().contiguous(), residual, rms)))
        else:
            out.append((src, new_call(lib)))
    D = scale.shape[0]
    if rms:
        out.append(("library", lambda x, residual: F.rms_norm(
            x if residual is None else x + residual, (D,), scale, 1e-5)))
    else:
        out.append(("library", lambda x, residual: F.layer_norm(
            x if residual is None else x + residual, (D,), scale, bias,
            1e-5)))
    return out


def _check(fn, x, residual, scale, bias, rms):
    out = fn(x, residual)
    ref = norms.rms_norm_reference(x, scale, 1e-5, residual) if rms else \
        norms.layer_norm_reference(x, scale, bias, 1e-5, residual)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = torch.finfo(ref.dtype).eps * ref.float().abs().max().item()
    return {"max_abs_err": err, "tol": tol, "ok": err <= tol
            and out.dtype == ref.dtype,
            "bit_equal_share": (out == ref).float().mean().item()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("norms_ab: no CUDA card")
    smi = cs.phase_device()["nvidia_smi"]
    if args.ptxas:
        for src in args.dirs:
            print(json.dumps({"dir": src, "ptxas": _ptxas(src, "norms.cu")}),
                  flush=True)
    libs = {}
    for src in args.dirs:
        _use(src)
        libs[src] = op_builder.load("norms")
    rng = np.random.default_rng(0)
    for case, rows, D, dtype, res_dtype in cs.NORM_SWEEP:
        sets, scale, bias = cs._norm_sets(rng, rows, D, dtype, res_dtype)
        x0, r0 = sets[0]["x"], sets[0]["residual"]
        for op in ("fused_layer_norm", "fused_rms_norm"):
            rms = op == "fused_rms_norm"
            b_ms, b_by = cs._norm_bound(rows, D, x0, r0, scale, rms)
            variants = []
            for label, fn in _variants(args.dirs, libs, op, scale, bias):
                src = label.split(":")[0]
                if src in libs and _old_signature(src) \
                        and not _old_takes(x0, r0):
                    print(json.dumps({"case": case, "op": op,
                                      "variant": label,
                                      "unsupported": True}), flush=True)
                    continue
                info = {"case": case, "op": op, "variant": label,
                        "shape": [rows, D], "dtype": dtype,
                        "residual": res_dtype, "sets": len(sets),
                        "bound_ms": b_ms, "bound_by": b_by}
                if label != "library":
                    info["check"] = _check(fn, x0, r0, scale, bias, rms)
                variants.append((info, cs._Rotating(fn, sets)))
            fns = [rot for _, rot in variants]
            inner = len(sets) * max(1, round(20 / len(sets)))
            graph = cs.graph_ms_turns(fns, inner=inner, reps=args.reps)
            eager = cs.median_ms_turns(fns, inner=len(sets))
            for (info, rot), g, e in zip(variants, graph, eager):
                dev, kernels = cs._device_ms(rot, calls=max(10, len(sets)))
                info.update(graph_ms=g, eager_ms=e, device_ms=dev,
                            kernels=kernels, host_ms=cs._host_ms(rot),
                            graph_bound_factor=g / b_ms)
                print(json.dumps(info), flush=True)
            del variants, fns
        del sets
        torch.cuda.empty_cache()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
