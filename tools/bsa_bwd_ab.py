"""A/B of the block-sparse attention backward kernels (dq, dk/dv) built
from several source directories (copies of `deepspeed_tpu_torch/ops/csrc`,
e.g. the parent's from `git archive`, and the change's), checked and timed
in turns on one CUDA card.

    python tools/bsa_bwd_ab.py DIR [DIR ...] [--rounds N] [--ptxas]

With --ptxas, first prints for each directory what nvcc's `-Xptxas -v`
says of each kernel of its `block_sparse.cu` (registers, spills, shared
memory), built with `op_builder.NVCC_FLAGS`. Then each round walks the
directories in order; for each it builds that directory's `block_sparse.cu`
(`op_builder`, the library under DIR/out), checks the forward, dq and dk/dv
kernels (and dbias) against their plain versions at chip_smoke's sparse
cases (`_sparse_cases` and the paths' `_sparse_paths`, row by row within
SPARSE_ROW_TOL; first round only, printed, not raised), and times device
time alone (CUDA graphs, `chip_smoke.graph_ms`) of dq, dk/dv and the pair at
the two paths' shapes (sparse_train: B 1, H 12, T 8192, hd 64, the Fixed
layout, causal; sparse_op: the same, not causal, a learned head-shared
[T, T] bias and 100 padded keys, where dq is also timed without its
dbias). A directory whose backward entry points predate the walk orders
(they take no `order` argument) is called as its wrapper called them; that
shim (ORDER_ARG, `_without_orders`, `_kernel_without_orders`) is kept only
so that the parent-vs-change reading of the redesign recorded in PERF.md
can be reproduced from the parent's `git archive`, and goes with the next
change to these entry points.
Prints one JSON line per (directory, case, kernel) with the median over the
rounds and each round's time, then SDPA's backward at the paths' shapes as
device time (`chip_smoke._device_ms`). Run from the repo's root; it needs
the CUDA toolkit and a card.
"""

import argparse
import json
import pathlib
import re
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from attn_fwd_ab import _ptxas, _use  # noqa: E402  (this directory)
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

_KERNEL = bsa._kernel
ORDER_ARG = 13          # the backward entry points' `order` pointer


def _without_orders(src):
    """Whether DIR's backward entry points take no walk order (the design
    before the orders: the wrapper passed the fine mask, then B)."""
    text = (pathlib.Path(src) / "block_sparse.cu").read_text()
    m = re.search(r'extern "C" int dstt_bsa_bwd_dq\(([^)]*)\)', text)
    return m is not None and "order" not in m.group(1)


def _kernel_without_orders(symbol):
    """bsa._kernel for such a directory: the backward entry points with the
    `order` argument dropped from the call and from their argtypes."""
    fn = getattr(op_builder.load("block_sparse"), symbol)
    if symbol == "dstt_bsa_fwd":
        return _KERNEL(symbol)
    if fn.argtypes is None:
        types = bsa._ARGTYPES[symbol]
        fn.argtypes = types[:ORDER_ARG] + types[ORDER_ARG + 1:]
        fn.restype = bsa.ctypes.c_int
    return lambda *a: fn(*a[:ORDER_ARG], *a[ORDER_ARG + 1:])


def _select(src):
    _use(src)
    bsa._kernel = _kernel_without_orders if _without_orders(src) \
        else _KERNEL


def _checks(src):
    """chip_smoke's row-by-row checks of the three kernels at its sparse
    cases and the paths' shapes; a failing case is recorded, not raised."""
    rng = np.random.default_rng(1)
    checks, failed = [], []
    cases = [(*x[:5], 16, *x[5:]) for x in cs._sparse_cases(rng)] \
        + [(*x[:5], 16, *x[5:]) for x in cs._sparse_paths(rng)]
    for case, q, k, v, layout, block, causal, kw in cases:
        try:
            cs._sparse_check(rng, checks, case, q, k, v, layout, block,
                             causal, **kw)
        except AssertionError as e:
            failed.append(str(e))
    return {"dir": src, "failed": failed, "checks": [
        {k: c[k] for k in ("kernel", "case", "output", "row_err", "ok")}
        for c in checks]}


def _operands(rng):
    """Each path's backward arguments (`_launch_bwd`'s), with the saved
    (out, lse) of the plain forward, so every directory times the same
    inputs; and SDPA's backward over the dense mask on them."""
    ops = {}
    for path, q, k, v, layout, causal, kw in cs._sparse_paths(rng):
        plan = bsa._layout_plan(layout, q.shape[1], q.shape[2], 16, causal)
        bias, kvb, scale = bsa._operands(q, plan, None, kw.get("bias"),
                                         kw.get("kpm"))
        qs = (q.float() * scale).to(q.dtype)
        out, lse = bsa._reference_fwd(qs, k, v, plan, bias, kvb, causal)
        do = torch.from_numpy(rng.standard_normal(q.shape).astype(
            np.float32)).to("cuda", q.dtype)
        delta = (do.float() * out.float()).sum(-1).contiguous()
        bwd = (qs, k, v, do, lse, delta, plan, bias, kvb, causal, scale,
               bias is not None)
        live, _ = plan.token_masks(causal, "cuda")
        mask = torch.where(live[None], 0.0, float("-inf"))
        if bias is not None:
            mask = mask + bias
        if kvb is not None:
            mask = mask + kvb[:, None, None, :]
        sq, sk, sv = (x.contiguous().requires_grad_(True) for x in (q, k, v))
        sout = F.scaled_dot_product_attention(sq, sk, sv,
                                              attn_mask=mask.to(q.dtype),
                                              scale=scale)
        sdo = do.contiguous()
        ops[path] = (bwd, lambda sout=sout, sq=sq, sk=sk, sv=sv, sdo=sdo:
                     torch.autograd.grad(sout, (sq, sk, sv), sdo,
                                         retain_graph=True),
                     sout.grad_fn.name())
    return ops


def _timed(bwd):
    """(kernel, call) pairs of one path: dq, dk/dv, the pair, and where the
    bias is learned, dq without its dbias."""
    calls = [("dq", lambda: bsa._launch_bwd(*bwd, True, False)),
             ("dkv", lambda: bsa._launch_bwd(*bwd[:-1], False, False, True)),
             ("pair", lambda: bsa._launch_bwd(*bwd))]
    if bwd[-1]:
        calls.append(("dq_no_dbias",
                      lambda: bsa._launch_bwd(*bwd[:-1], False, True, False)))
    return calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bsa_bwd_ab: no CUDA card")
    if args.ptxas:
        for src in args.dirs:
            print(json.dumps({"dir": src,
                              "ptxas": _ptxas(src, "block_sparse.cu")}),
                  flush=True)
    ops = _operands(np.random.default_rng(0))
    times, broken = {}, set()
    for rnd in range(args.rounds):
        for src in args.dirs:
            if src in broken:
                continue
            _select(src)
            try:
                op_builder.build_all(["block_sparse"])
            except RuntimeError as e:         # a variant that does not build
                print(json.dumps({"dir": src, "build_error": str(e)[-3000:]}),
                      flush=True)
                broken.add(src)
                continue
            if rnd == 0:
                print(json.dumps(_checks(src)), flush=True)
            for path, (bwd, _, _) in ops.items():
                for what, fn in _timed(bwd):
                    times.setdefault((src, path, what), []).append(
                        cs.graph_ms(fn, inner=5))
    bsa._kernel = _KERNEL
    for (src, path, what), ts in times.items():
        print(json.dumps({"dir": src, "case": path, "kernel": what,
                          "graph_ms": statistics.median(ts), "rounds": ts}))
    sdpa = {}
    for path, (_, fn, backend) in ops.items():
        ms, kernels = cs._device_ms(fn)
        sdpa[path] = {"device_ms": ms, "backend": backend,
                      "kernels": kernels}
    print(json.dumps({"sdpa_backward": sdpa}))


if __name__ == "__main__":
    main()
