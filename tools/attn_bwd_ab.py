"""A/B of the flash-attention backward kernels (dq, dk/dv) built from
several source directories (copies of `deepspeed_tpu_torch/ops/csrc` with a
change), checked and timed in turns on one CUDA card.

    python tools/attn_bwd_ab.py DIR [DIR ...] [--rounds N] [--ptxas]

With --ptxas, first prints for each directory what nvcc's `-Xptxas -v`
says of each kernel of its `flash_bwd.cu` (registers, spills, shared
memory), built with `op_builder.NVCC_FLAGS`. Then each round walks the
directories in order; for each it builds that directory's `flash_fwd.cu`
and `flash_bwd.cu` (`op_builder`, the libraries under DIR/out), checks the
pair against the plain backward at chip_smoke's cases (`_backward_case`:
the two training paths' shapes and BWD_EDGE_CASES, each gradient within
BWD_REL_TOL of max|ref| and row by row within SPARSE_ROW_TOL; first round
only), and times device time alone (CUDA graphs, `chip_smoke.graph_ms`) of
dq, dk/dv and the pair at the train (B 12, T 512, H 12, hd 128) and
moe_train (B 8, T 512, H 12, hd 64) shapes, causal, bf16. Prints one JSON
line per (directory, case) with the median over the rounds and each
round's time, then SDPA's backward at those shapes as device time
(`chip_smoke._device_ms`). Run from the repo's root; it needs the CUDA
toolkit and a card.
"""

import argparse
import json
import pathlib
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from attn_fwd_ab import _ptxas, _use  # noqa: E402  (this directory)
from deepspeed_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

SHAPES = {"train": dict(B=12, T=512, H=12, Hkv=12, D=128, causal=True),
          "moe_train": dict(B=8, T=512, H=12, Hkv=12, D=64, causal=True)}


def _operands(rng, shape):
    """The kernels' own arguments at `shape`: [B, H, T, D] views of one
    fused projection, do, the forward's lse, delta, the softmax scale."""
    q, k, v, causal = cs._flash_case(rng, **shape)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
    do = torch.randn_like(out)
    qh, kh, vh, doh, oh = (x.transpose(1, 2) for x in (q, k, v, do, out))
    delta = (doh.float() * oh.float()).sum(-1).contiguous()
    return qh, kh, vh, doh, lse, delta, 1.0 / shape["D"] ** 0.5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attn_bwd_ab: no CUDA card")
    if args.ptxas:
        for src in args.dirs:
            print(json.dumps({"dir": src,
                              "ptxas": _ptxas(src, "flash_bwd.cu")}),
                  flush=True)
    rng = np.random.default_rng(0)
    ops = {n: _operands(rng, s) for n, s in SHAPES.items()}
    times, broken = {}, set()
    for rnd in range(args.rounds):
        for src in args.dirs:
            if src in broken:
                continue
            _use(src)
            try:
                op_builder.build_all(["flash_fwd", "flash_bwd"])
            except RuntimeError as e:         # a variant that does not build
                print(json.dumps({"dir": src, "build_error": str(e)[-3000:]}),
                      flush=True)
                broken.add(src)
                continue
            if rnd == 0:
                checks = []
                cases = [(s, False) for s in SHAPES.values()] \
                    + [(s, False) for s in cs.BWD_EDGE_CASES] \
                    + [(dict(B=2, T=333, H=16, Hkv=4, D=128, causal=True),
                        True)]
                for shape, dlse in cases:
                    cs._backward_case(np.random.default_rng(1), checks, shape,
                                      dlse)
                print(json.dumps({"dir": src, "checks": [
                    {k: c[k] for k in ("kernel", "shape", "max_abs_err",
                                       "tol", "row_err")}
                    for c in checks]}), flush=True)
            for name, (qh, kh, vh, doh, lse, delta, sm) in ops.items():
                for what, need in (("dq", (True, False)),
                                   ("dkv", (False, True)),
                                   ("pair", (True, True))):
                    times.setdefault((src, name, what), []).append(
                        cs.graph_ms(lambda: fa._launch_bwd(
                            qh, kh, vh, doh, lse, delta, sm, True, *need)))
    for (src, name, what), ts in times.items():
        print(json.dumps({"dir": src, "case": name, "kernel": what,
                          "graph_ms": statistics.median(ts), "rounds": ts}))
    sdpa = {}
    for name, (qh, kh, vh, doh, _, _, _) in ops.items():
        sq, sk, sv = (x.contiguous().requires_grad_(True)
                      for x in (qh, kh, vh))
        sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        sdo = doh.contiguous()
        ms, kernels = cs._device_ms(lambda: torch.autograd.grad(
            sout, (sq, sk, sv), sdo, retain_graph=True))
        sdpa[name] = {"device_ms": ms, "backend": sout.grad_fn.name(),
                      "kernels": kernels}
    print(json.dumps({"sdpa_backward": sdpa}))


if __name__ == "__main__":
    main()
