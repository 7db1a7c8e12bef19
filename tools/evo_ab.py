"""A/B of the Evoformer attention forward kernel built from several source
directories (copies of `deepspeed_tpu_torch/ops/csrc`, e.g. the parent
commit's or one with a changed constant), checked and timed in turns on
one CUDA card.

    python tools/evo_ab.py DIR [DIR ...] [--rounds N] [--ptxas] [--sass]

With --ptxas, first prints for each directory what nvcc's `-Xptxas -v`
says of each kernel of its `evoformer_attn.cu` (registers, spills, shared
memory), built with `op_builder.NVCC_FLAGS`. With --sass, after the
rounds, prints for each directory the SASS (`cuobjdump -sass` of its
library) instruction count of the bf16 / hd 32 kernel with a bf16 pair
(the paths' instance), and of its first tile body: the instructions from
the first wgmma (HGMMA) of S = Q K^T through the last of that tile's
P V products. Each round walks the directories in order; for each it
builds that directory's `evoformer_attn.cu` (`op_builder`, the library
under DIR/out) and, in the first round, checks it against the plain
version with chip_smoke's own checks (`_evo_check`: the one-step
tolerance, the bit-equal share's floor, the planted faults; a failing
check is printed, not raised) at the two path shapes of
chip_smoke.EVO_CASES and, for a directory whose kernel takes biases in
their own dtype, at chip_smoke.EVO_EDGE_CASES too; then it times device
time alone
(CUDA graphs, `chip_smoke.graph_ms`) of one call at each path shape. A
directory whose entry point has the older signature (fp32 biases; the
parent of the Hopper redesign) is called with the biases widened to fp32
beforehand, as its wrapper did: its time is the kernel's alone, and the
widening pass is timed apart (`widen_graph_ms`). Prints one JSON line per
(directory, case) with the median over the rounds and each round's time,
then SDPA's device time with the summed bias at the same shapes. Run from
the repo's root; it needs the CUDA toolkit and a card.
"""

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from attn_fwd_ab import _ptxas, _use  # noqa: E402  (this directory)
from deepspeed_tpu_torch.ops import evoformer_attn as evo  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

# the older entry point: fp32 mask / pair pointers, no bias dtype codes
_OLD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_longlong] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _sass(src):
    """Instruction counts of the paths' kernel instance in `src`'s built
    library: the whole kernel, and its first tile body (2 + 3 x 4 HGMMA
    with kPieces 3, 2 + 2 x 4 with 2)."""
    lib, = (pathlib.Path(src) / "out").glob("libevoformer_attn_*.so")
    cuobjdump = pathlib.Path(op_builder.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    pieces = int(re.search(r"constexpr int kPieces = (\d+);", (
        pathlib.Path(src) / "evoformer_attn.cu").read_text()).group(1))
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0]
        if "evo_fwd_kernelI13__nv_bfloat16Li32ES3_" not in name:
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", func)
        mma = [i for i, t in enumerate(ins) if "HGMMA" in t]
        last = mma[1 + 4 * pieces]
        return {"kernel": len(ins), "tile_body": last - mma[0] + 1}
    return None


def _old_signature(src):
    text = (pathlib.Path(src) / "evoformer_attn.cu").read_text()
    return "mask_dtype" not in text


def _old_launch(q, k, v, mask32, pair32, scale):
    """The older entry point on fp32 biases (widened by the caller)."""
    fn = op_builder.load("evoformer_attn").dstt_evoformer_fwd
    if fn.argtypes is None:
        fn.argtypes = _OLD_ARGTYPES
        fn.restype = ctypes.c_int
    B, N, S, H, D = q.shape
    out = torch.empty_like(q)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:4]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            mask32.data_ptr(), pair32.data_ptr(), B, N, S, H, D,
            (ctypes.c_longlong * 16)(*strides),
            *evo._bias_strides(mask32, 2), *evo._bias_strides(pair32, 2),
            float(scale), op_builder.dtype_code(q.dtype),
            op_builder.stream_ptr(q.device))
    op_builder.check(rc, "evoformer_attention (older entry point)")
    return out


def _call(src, q, k, v, biases):
    """A launch of `src`'s kernel on these operands (no autograd)."""
    B, N, S, H, D = q.shape
    mask, pair = evo._parse_biases(biases, B, N, S, H)
    scale = 1.0 / D ** 0.5
    if _old_signature(src):
        mask32, pair32 = mask.float().contiguous(), pair.float().contiguous()
        return lambda: _old_launch(q, k, v, mask32, pair32, scale)
    return lambda: evo._launch(q, k, v, mask, pair, scale)


def _checks(src, rng):
    """chip_smoke's checks (`_evo_check`) of `src`'s kernel at the path
    shapes and, for a kernel that takes biases in their own dtype, at
    EVO_EDGE_CASES."""
    rows = []
    cases = [(path, dict(shape)) for path, shape in cs.EVO_CASES.items()]
    if not _old_signature(src):
        cases += [(None, dict(shape)) for shape in cs.EVO_EDGE_CASES]
    for path, kw in cases:
        q, k, v, biases = cs._evo_case(rng, **kw)
        out = _call(src, q, k, v, biases)()
        ref = evo.evoformer_attention_reference(q, k, v, biases)
        torch.cuda.synchronize()
        rows.append(cs._evo_check(path, q, k, v, biases, out, ref))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("evo_ab: no CUDA card")
    if args.ptxas:
        for src in args.dirs:
            print(json.dumps({"dir": src,
                              "ptxas": _ptxas(src, "evoformer_attn.cu")}),
                  flush=True)
    rng = np.random.default_rng(0)
    ops = {path: cs._evo_case(rng, **shape)
           for path, shape in cs.EVO_CASES.items()}
    times, broken = {}, set()
    for rnd in range(args.rounds):
        for src in args.dirs:
            if src in broken:
                continue
            _use(src)
            try:
                op_builder.build_all(["evoformer_attn"])
            except RuntimeError as e:         # a variant that does not build
                print(json.dumps({"dir": src, "build_error": str(e)[-3000:]}),
                      flush=True)
                broken.add(src)
                continue
            if rnd == 0:
                print(json.dumps({"dir": src, "checks": _checks(
                    src, np.random.default_rng(1))}), flush=True)
            for path, (q, k, v, biases) in ops.items():
                times.setdefault((src, path), []).append(
                    cs.graph_ms(_call(src, q, k, v, biases)))
    for (src, path), ts in times.items():
        print(json.dumps({"dir": src, "case": path,
                          "graph_ms": statistics.median(ts), "rounds": ts}))
    if args.sass:
        for src in args.dirs:
            if src not in broken and not _old_signature(src):
                print(json.dumps({"dir": src, "sass": _sass(src)}))
    extra = {}
    for path, (q, k, v, biases) in ops.items():
        B, N, S, H, D = q.shape
        mask, pair = evo._parse_biases(biases, B, N, S, H)
        sq, sk, sv = (x.permute(0, 1, 3, 2, 4).reshape(B * N, H, S, D)
                      .contiguous() for x in (q, k, v))
        summed = (mask[:, :, None, None, :] + pair[:, None]) \
            .expand(B, N, H, S, S).reshape(B * N, H, S, S).contiguous()
        extra[path] = {
            "sdpa_graph_ms": cs.graph_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=summed)),
            "widen_graph_ms": cs.graph_ms(lambda: (
                mask.float().contiguous(), pair.float().contiguous()))}
    print(json.dumps({"yardsticks": extra}))


if __name__ == "__main__":
    main()
