"""A/B of the quantize and dequantize kernels built from several source
directories (copies of `deepspeed_tpu_torch/ops/csrc`, e.g. the parent
commit's), checked and timed in turns on one CUDA card: first row 7 (the
int8 pool write and wte's quantize_int8), then the dequantize kernels
(int8 and int4); then rows 8 and 13 (quantize_int4, token_sort) through
each directory in turns, and rows 4–7 (decode, paged decode, int8 paged
decode, quantize_int8) through the last directory's build, as device time
at their paths' shapes (rows 4–6 in detail: `tools/decode_ab.py`).

    python tools/quant_ab.py DIR [DIR ...] [--reps N] [--ptxas] [--no-others]
        [--no-dequantize]

Row 7: at the quantized serving path's shape (chip_smoke.KV_WRITE_SERVE:
8 slots, 12 kv heads of 64, g 64, bf16 K/V as views of the qkv
projection, int64 positions, 512-row blocks), one layer's K/V write as
the parent's model made it ("sequence": the table gather, `//`, `%`, two
`quantize` calls through the directory's `dstt_quantize` and four index
writes) and, where the directory's library has `dstt_quantize_kv_write`,
as one fused launch ("fused"): each checked bit for bit against the plain
sequence on every block but the trash block, then timed in turns (device
time in CUDA graphs, the profiler's kernels and launches a call, host
time a call). Then quantize_int8 of wte [50304, 768] g 64 through each
directory (bit-exact, device time in turns, inputs rotated past L2).

With --ptxas, first prints for each directory what nvcc's `-Xptxas -v`
says of each kernel of its `quant.cu`. Then, for each bit width and each
dequantize a gpt2-125m model step makes (`chip_smoke.DEQUANT_SHAPES`: the
LM head's table, each block leaf, the embedding rows, the prefill's K/V
gather; g 64 into bf16), one layer's leaves ("layer") and one model step's
dequantization ("model_step": 12 layers, the wte and wpe rows, the head),
it checks each directory's output bit for bit against the plain version
and times, for each directory and for `q.to(bfloat16)` on the same
payloads (`copy`, the elementwise yardstick):
  * device time alone, the calls in CUDA graphs replayed in turns
    (`chip_smoke.graph_ms_turns`), rotating over input sets that move
    chip_smoke.NORM_COLD_BYTES between two uses of one (the 12 layers in
    turn for "layer"), so no input is read from L2 but the launch-bound
    biases' and rows' (`graph_ms`);
  * the profiler's kernel time a call and the kernels' names and launches
    a call (`device_ms`, `kernels`);
  * the host's time a call, calls enqueued back to back (`host_ms`);
  * eager calls timed in turns (`eager_ms`).
At wte it also times what the card reaches at the dense table's bytes:
`zero_()` of the bf16 output (writes only, "wte_write_only") and a bf16
copy of it ("wte_bf16_copy"), each against its own byte bound.
A directory whose library has no grouped entry point (`dstt_dequantize`
only) is called one leaf a launch through that entry, with the checks,
the two `contiguous()` and the allocation its wrapper made: "layer" is
then eight launches and "model_step" 99, as its `_layer` made them.
Rows 8 and 13 (`_rows_8_13`), each directory's build in turns, device
time in CUDA graphs, the inputs rotated past L2, bit-exact against the
plain version first: quantize_int4 at wte [50304, 768] and mlp_up_w
[768, 3072] (bf16, g 64) and the int4 engine's whole build
(`quant_generate_build`: `quantize_param_tree` over a gpt2-125m tree,
its 10 launches); token_sort at the dropless path's N 4096, E 8 with
int64 ids as the path holds them (the bound counts 8 bytes an id), with
int32 ids, at N 65 536 and at E 128. A directory whose token_sort
library has no `dstt_token_sort_tile` (the single-block kernel) is
called as its wrapper called it: int64 ids cast to int32 first.
Prints one JSON line per (bits, shape, variant), then one per row 8 / 13
case and directory, then one per other kernel, then the card's name and
power limit. Run from the repo's root; it needs the CUDA toolkit and a
card.
"""

import argparse
import ctypes
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from attn_fwd_ab import _ptxas, _use  # noqa: E402  (this directory)
from deepspeed_tpu_torch.inference.quantization import (  # noqa: E402
    QuantizedTensor, dense, quantize_param_tree)
from deepspeed_tpu_torch.models import gpt  # noqa: E402
from deepspeed_tpu_torch.ops import decode_attention as da  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder, quant  # noqa: E402
from deepspeed_tpu_torch.ops import token_sort as ts  # noqa: E402

# the one-leaf entry point of libraries without `dstt_dequantize_many`
_OLD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
    ctypes.c_int] * 4 + [ctypes.c_void_p]


def _old_dequantize(lib, q, s, dtype, g, bits):
    """One leaf through the one-leaf entry point, as its wrapper called
    it: the checks, both contiguous(), an allocation, the ctypes call."""
    fn = lib.dstt_dequantize
    if fn.argtypes is None:
        fn.argtypes = _OLD_ARGTYPES
        fn.restype = ctypes.c_int
    what = f"dequantize_int{bits}"
    D = quant._check_dequantize(q, s, dtype, g, bits, what)
    q, s = q.contiguous(), s.contiguous()
    out = torch.empty(q.shape[:-1] + (D,), dtype=dtype, device=q.device)
    rc = fn(q.data_ptr(), s.data_ptr(), out.data_ptr(),
            q.numel() // q.shape[-1], D, g, bits,
            op_builder.dtype_code(dtype), op_builder.stream_ptr(q.device))
    op_builder.check(rc, what)
    return out


def _calls(lib):
    """(one leaf, a layer, dense) of a directory's library."""
    if hasattr(lib, "dstt_dequantize_many"):
        def single(q, s, dtype, g, bits):
            op_builder._LIBS["quant"] = lib
            return quant.dequantize(q, s, dtype, g, bits)

        def layer(tree, i):
            op_builder._LIBS["quant"] = lib
            return gpt._layer(tree, i)

        def dense_(t):
            op_builder._LIBS["quant"] = lib
            return dense(t)
        return single, layer, dense_

    def single(q, s, dtype, g, bits):
        return _old_dequantize(lib, q, s, dtype, g, bits)

    def dense_(t):
        if not isinstance(t, QuantizedTensor):
            return t
        return _old_dequantize(lib, t.q, t.scale, t.dtype, t.group_size,
                               t.bits)

    def layer(tree, i):
        return {k: dense_(v[i]) for k, v in tree["blocks"].items()}
    return single, layer, dense_


def _same(a, b):
    if isinstance(a, (list, tuple)):
        return all(_same(x, y) for x, y in zip(a, b)) and len(a) == len(b)
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)
    return bool(torch.equal(a, b))


def _cold_sets(per_set):
    """Input sets of `per_set` bytes that move chip_smoke.NORM_COLD_BYTES
    between two uses of one (at most 64): rotated, none is read from L2."""
    return int(min(64, max(1, -(-cs.NORM_COLD_BYTES // per_set))))


def _time(label, bits, rows, variants, n_sets, nbytes, n, reps):
    """Time `variants` ((name, rotating call) pairs) in turns: device time
    in CUDA graphs, eager, the profiler's kernels, host time; print one
    line each, beside the byte bound of `nbytes`."""
    b_ms, b_by = cs.bound(nbytes, n, cs.FP32_FLOPS)
    fns = [fn for _, fn in variants]
    inner = n_sets * max(1, round(20 / n_sets))
    graph = cs.graph_ms_turns(fns, inner=inner, reps=reps)
    eager = cs.median_ms_turns(fns, inner=n_sets)
    for (name, rot), g, e in zip(variants, graph, eager):
        dev, kernels = cs._device_ms(rot, calls=max(10, n_sets))
        info = {"bits": bits, "case": label, "variant": name,
                "shape": rows, "sets": n_sets, "bytes": nbytes,
                "bound_ms": b_ms, "bound_by": b_by, "graph_ms": g,
                "eager_ms": e, "device_ms": dev, "kernels": kernels,
                "host_ms": cs._host_ms(rot), "graph_bound_factor": g / b_ms}
        print(json.dumps(info), flush=True)


def _write_ab(dirs, libs, reps):
    """Row 7 at the serve path's write and at wte, each directory in
    turns (see the module's docstring)."""
    rng = np.random.default_rng(7)
    case = cs.KV_WRITE_SERVE
    k, v, tables, pos, pool = cs._kv_write_args(rng, case)
    bs, g = pool["k"].shape[2], case["hd"] // pool["k_scale"].shape[-1]
    names = cs._POOL_NAMES

    def sequence(lib):
        def call(pool):
            op_builder._LIBS["quant"] = lib
            blk = torch.gather(tables.long(), 1, (pos // bs).long())
            off = pos % bs
            for name, x in (("k", k), ("v", v)):
                qt, st = quant.quantize(x, g, 8)
                pool[name][blk, :, off] = qt
                pool[f"{name}_scale"][blk, :, off] = st
        return call

    def fused(lib):
        def call(pool):
            op_builder._LIBS["quant"] = lib
            quant.quantize_kv_write(k, v, tables, pos,
                                    *(pool[n] for n in names))
        return call
    ref = {n: t.clone() for n, t in pool.items()}
    quant.quantize_kv_write_reference(k, v, tables, pos,
                                      *(ref[n] for n in names))
    variants = []
    for src in dirs:
        made = [("sequence", sequence(libs[src]))]
        if hasattr(libs[src], "dstt_quantize_kv_write"):
            made.append(("fused", fused(libs[src])))
        for kind, fn in made:
            got = {n: t.clone() for n, t in pool.items()}
            fn(got)
            torch.cuda.synchronize()
            checks = []
            cs._kv_write_check(checks, f"{src} {kind}", got, ref)
            variants.append((f"{src}#{kind}", cs._Rotating(fn, [
                dict(pool={n: t.clone() for n, t in pool.items()})
                for _ in range(8)])))
    b_ms, b_by = cs._kv_write_bound(case)
    fns = [fn for _, fn in variants]
    graph = cs.graph_ms_turns(fns, inner=16, reps=reps)
    host = [[] for _ in fns]
    for _ in range(7):
        for fn, h in zip(fns, host):
            h.append(cs._host_ms(fn))
    for (name, rot), gms, h in zip(variants, graph, host):
        dev, kernels = cs._device_ms(rot, calls=16)
        print(json.dumps({
            "case": "kv_write", "variant": name,
            "shape": {n: x for n, x in case.items()}, "bound_ms": b_ms,
            "bound_by": b_by, "graph_ms": gms, "device_ms": dev,
            "kernels": kernels, "launches": sum(kernels.values()),
            "host_ms": float(np.median(h))}), flush=True)
    del variants, fns
    # wte's quantize_int8 (the serving engine's build), inputs rotated
    sets = [dict(x=torch.from_numpy(rng.standard_normal(
        (50304, 768)).astype(np.float32)).to("cuda", torch.bfloat16))
        for _ in range(3)]
    qr, sr = quant.quantize_reference(sets[0]["x"], 64)
    rots = []
    for src in dirs:
        def wte(x, lib=libs[src]):
            op_builder._LIBS["quant"] = lib
            return quant.quantize(x, 64, 8)
        qk, sk = wte(**sets[0])
        if not (torch.equal(qk, qr) and torch.equal(sk, sr)):
            raise AssertionError(f"{src} wte: kernel != plain version")
        rots.append(cs._Rotating(wte, sets))
    n = 50304 * 768
    b_ms, b_by = cs.bound(n * 2 + n + n // 64 * 4, 4 * n, cs.FP32_FLOPS)
    graph = cs.graph_ms_turns(rots, inner=6, reps=reps)
    for src, rot, gms in zip(dirs, rots, graph):
        dev, kernels = cs._device_ms(rot, calls=6)
        print(json.dumps({
            "case": "wte", "kernel": "quantize_int8", "variant": src,
            "shape": [50304, 768], "group": 64, "bound_ms": b_ms,
            "bound_by": b_by, "graph_ms": gms,
            "graph_bound_factor": gms / b_ms, "device_ms": dev,
            "kernels": kernels}), flush=True)
    del sets, rots
    torch.cuda.empty_cache()


def _dequant_ab(dirs, libs, bits, reps):
    bf16, g = torch.bfloat16, cs.DEQUANT_GROUP
    gen = torch.Generator(device="cuda").manual_seed(bits)
    calls = {src: _calls(libs[src]) for src in dirs}
    for label, shape in cs.DEQUANT_SHAPES:
        if label == "kv_gather" and bits == 4:
            continue
        sets = cs._dequant_sets(gen, shape, bits)
        ref = quant.dequantize_reference(sets[0]["q"], sets[0]["s"], bf16, g,
                                         bits)
        variants = []
        for src in dirs:
            single = calls[src][0]
            fn = (lambda q, s, single=single: single(q, s, bf16, g, bits))
            if not _same(fn(**sets[0]), ref):
                raise AssertionError(f"{src} int{bits} {label}: kernel != "
                                     f"plain version")
            variants.append((src, cs._Rotating(fn, sets)))
        variants.append(("copy", cs._Rotating(lambda q, s: q.to(bf16),
                                              sets)))
        n = int(np.prod(shape))
        _time(label, bits, list(shape), variants, len(sets),
              cs._dequant_bytes(n, g, bits), n, reps)
        if label == "wte" and bits == 8:
            # what the card writes, and copies, at the dense table's bytes
            outs = [dict(o=torch.empty(shape, dtype=bf16, device="cuda"),
                         src=torch.randn(shape, generator=gen,
                                         device="cuda").to(bf16))
                    for _ in sets]
            _time("wte_write_only", bits, list(shape), [("zero_", cs._Rotating(
                lambda o, src: o.zero_(), outs))], len(outs), 2 * n, n, reps)
            _time("wte_bf16_copy", bits, list(shape), [("copy_", cs._Rotating(
                lambda o, src: o.copy_(src), outs))], len(outs), 4 * n, n,
                reps)
            del outs
        del sets, variants
    tree = cs._dequant_tree(bits, gen)
    blocks = tree["blocks"]
    layer_n = [int(np.prod(v)) for v in cs.DEQUANT_LAYER.values()]
    layer_bytes = sum(cs._dequant_bytes(k, g, bits) for k in layer_n)
    ref = {k: quant.dequantize_reference(v[3].q, v[3].scale, bf16, g, bits)
           for k, v in blocks.items()}
    sets = [{"i": i} for i in range(12)]
    variants = []
    for src in dirs:
        layer = calls[src][1]
        if not _same(layer(tree, 3), ref):
            raise AssertionError(f"{src} int{bits} layer: kernel != plain "
                                 f"version")
        variants.append((src, cs._Rotating(
            lambda i, layer=layer: layer(tree, i), sets)))
    variants.append(("copy", cs._Rotating(
        lambda i: [blocks[k][i].q.to(bf16) for k in blocks], sets)))
    _time("layer", bits, "8 leaves", variants, len(sets), layer_bytes,
          sum(layer_n), reps)
    tokens = torch.randint(0, 50304, (8, 1), generator=gen, device="cuda")
    positions = torch.randint(0, 1024, (8, 1), generator=gen, device="cuda")
    variants = [(src, cs._Rotating(cs._dequant_step(
        tree, tokens, positions, calls[src][1], calls[src][2]), [{}]))
        for src in dirs]
    wte = tree["wte"]
    variants.append(("copy", cs._Rotating(
        lambda: [t.q.to(bf16) for t in blocks.values()] + [wte.q.to(bf16)],
        [{}])))
    step_bytes = 12 * layer_bytes + 2 * cs._dequant_bytes(8 * 768, g, bits) \
        + cs._dequant_bytes(50304 * 768, g, bits)
    _time("model_step", bits, "12 layers, wte and wpe rows, the head",
          variants, 1, step_bytes, 12 * sum(layer_n) + 2 * 8 * 768
          + 50304 * 768, reps)
    del tree, blocks, wte, variants
    torch.cuda.empty_cache()


def _others(reps):
    """Rows 4-7 at their paths' shapes (chip_smoke's kernels phase), the
    inputs rotated past L2: device time in CUDA graphs, eager, host, the
    profiler's kernels; bounds as chip_smoke's rows count them."""
    rng = np.random.default_rng(0)
    lens = [100, 250, 431, 600]
    serve_pos = [150, 0, 400, 640, 1000, 0, 260, 520]
    cases = []
    # row 4: generate()'s decode over the 1024-row cache, mid-generation
    sh = dict(B=4, H=12, Hkv=12, hd=64, M=1024, pos=[n + 16 for n in lens])
    sets = [dict(zip(("q", "kc", "vc", "pos"),
                     cs._decode_args(rng, sh).values()))
            for _ in range(_cold_sets(2 * 4 * 12 * 1024 * 64 * 2))]
    live = sum(p + 1 for p in sh["pos"])
    cases.append(("decode_attention", "generate", sets,
                  lambda q, kc, vc, pos: da.decode_attention(q, kc, vc, pos),
                  cs.bound(2 * live * 12 * 64 * 2 + 2 * 4 * 12 * 64 * 2,
                           4 * live * 12 * 64, cs.FP32_FLOPS)))
    # row 5: the serving engine's paged decode, 8 slots, 512-row blocks
    sh = dict(B=8, H=12, Hkv=12, hd=64, bs=512, nb=2, pos=serve_pos)
    sets = [dict(zip(("q", "kp", "vp", "tables", "pos"),
                     cs._paged_case(rng, **sh)))
            for _ in range(_cold_sets(2 * 17 * 12 * 512 * 64 * 2))]
    live = sum(p + 1 for p in serve_pos)
    cases.append(("paged_decode_attention", "serve", sets,
                  lambda q, kp, vp, tables, pos: da.paged_decode_attention(
                      q, kp, vp, tables, pos),
                  cs.bound(2 * live * 12 * 64 * 2 + 2 * 8 * 12 * 64 * 2
                           + 16 * 4, 4 * live * 12 * 64, cs.FP32_FLOPS)))
    # row 6: the same over the int8 pool, g 64
    sets = []
    for _ in range(_cold_sets(2 * 17 * 12 * 512 * (64 + 4))):
        q, pool, tables, pos = cs._quant_pool_case(rng, g=64, **sh)
        sets.append(dict(q=q, k=pool["k"], v=pool["v"], ks=pool["k_scale"],
                         vs=pool["v_scale"], tables=tables, pos=pos))
    cases.append(("paged_decode_attention_quant", "quant_serve", sets,
                  lambda q, k, v, ks, vs, tables, pos:
                  da.paged_decode_attention_quant(q, k, v, ks, vs, tables,
                                                  pos),
                  cs.bound(2 * live * 12 * (64 + 4) + 2 * 8 * 12 * 64 * 2
                           + 16 * 4, 4 * live * 12 * 64, cs.FP32_FLOPS)))
    # row 7: the weights' wte (the K/V pool write: `_write_ab`)
    for bits, path, (rows, D) in ((8, "quant_serve_build", (50304, 768)),):
        nbytes = rows * D * 2 + rows * D * bits // 8 + rows * D // 64 * 4
        sets = [dict(x=torch.from_numpy(rng.standard_normal(
            (rows, D)).astype(np.float32)).to("cuda", torch.bfloat16))
            for _ in range(_cold_sets(nbytes))]
        cases.append((f"quantize_int{bits}", path, sets,
                      lambda x, bits=bits: quant.quantize(x, 64, bits),
                      cs.bound(nbytes, 4 * rows * D, cs.FP32_FLOPS)))
    for name, path, sets, fn, (b_ms, b_by) in cases:
        rot = cs._Rotating(fn, sets)
        inner = len(sets) * max(1, round(20 / len(sets)))
        (g,) = cs.graph_ms_turns([rot], inner=inner, reps=reps)
        dev, kernels = cs._device_ms(rot, calls=max(10, len(sets)))
        print(json.dumps({
            "kernel": name, "path": path, "sets": len(sets),
            "bound_ms": b_ms, "bound_by": b_by, "graph_ms": g,
            "eager_ms": cs.median_ms(rot, inner=len(sets)),
            "device_ms": dev, "kernels": kernels,
            "host_ms": cs._host_ms(rot), "graph_bound_factor": g / b_ms}),
            flush=True)
        del rot, sets


def _old_token_sort(lib):
    """The single-block library's sort as its wrapper called it: the ids
    cast to int32 (a launch for int64 ids), then one launch."""
    fn = lib.dstt_token_sort
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def sort(idx, E):
        idx32 = idx.to(torch.int32).contiguous()
        n = idx32.shape[0]
        pos = torch.empty(n, dtype=torch.int32, device=idx.device)
        counts = torch.empty(E, dtype=torch.int32, device=idx.device)
        rc = fn(idx32.data_ptr(), pos.data_ptr(), counts.data_ptr(), n, E,
                op_builder.stream_ptr(idx.device))
        op_builder.check(rc, "token_sort")
        return pos, counts
    return sort


def _sort_of(lib):
    """A directory's sort: through the wrapper with that library and its
    own tile choices (a variant may take fewer sub-tiles a block)."""
    if not hasattr(lib, "dstt_token_sort_tile"):
        return _old_token_sort(lib)
    tiles = {}

    def sort(idx, E):
        op_builder._LIBS["token_sort"] = lib
        ts._TILE = tiles
        return ts.token_sort(idx, E)
    return sort


def _ab_rows(label, kernel, variants, sets, b_ms, b_by, reps, check):
    """Each directory's call of one case (`variants`: (dir, fn)), checked by
    `check` on the first set, then timed in turns over the rotated sets:
    device time in CUDA graphs, the profiler's kernels a call, host time.
    One JSON line a directory."""
    rots = []
    for src, fn in variants:
        check(src, fn(**sets[0]))
        rots.append(cs._Rotating(fn, sets))
    inner = len(sets) * max(1, round(20 / len(sets)))
    graph = cs.graph_ms_turns(rots, inner=inner, reps=reps)
    for (src, _), rot, gms in zip(variants, rots, graph):
        dev, kernels = cs._device_ms(rot, calls=max(10, len(sets)))
        print(json.dumps({
            "kernel": kernel, "case": label, "variant": src,
            "sets": len(sets), "bound_ms": b_ms, "bound_by": b_by,
            "graph_ms": gms, "graph_bound_factor": gms / b_ms,
            "device_ms": dev, "kernels": kernels,
            "launches": sum(kernels.values()),
            "host_ms": cs._host_ms(rot)}), flush=True)
    del rots


def _rows_8_13(dirs, libs, reps):
    """Rows 8 and 13 through each directory in turns (the module's
    docstring)."""
    rng = np.random.default_rng(8)

    def quant4(lib):
        def call(x):
            op_builder._LIBS["quant"] = lib
            return quant.quantize(x, 64, 4)
        return call
    for label, (rows, D) in (("wte", (50304, 768)),
                             ("mlp_up_w", (768, 3072))):
        nbytes = rows * D * 2 + rows * D // 2 + rows * D // 64 * 4
        sets = [dict(x=torch.from_numpy(rng.standard_normal(
            (rows, D)).astype(np.float32)).to("cuda", torch.bfloat16))
            for _ in range(_cold_sets(nbytes))]
        want = quant.quantize_reference(sets[0]["x"], 64, 4)

        def check(src, got, want=want, label=label):
            if not _same(list(got), list(want)):
                raise AssertionError(f"{src} int4 {label}: kernel != plain "
                                     f"version")
        _ab_rows(label, "quantize_int4", [(src, quant4(libs[src]))
                                          for src in dirs], sets,
                 *cs.bound(nbytes, 4 * rows * D, cs.FP32_FLOPS), reps, check)
        del sets
    # the int4 engine's build: quantize_param_tree over gpt2-125m's leaves
    tree = cs._weight_tree(torch.Generator(device="cuda").manual_seed(4))
    leaves = [*tree["blocks"].values(), tree["wte"], tree["wpe"]]
    n = sum(x.numel() for x in leaves)
    want = [t for x in leaves for t in quant.quantize_reference(x, 64, 4)]

    def build(lib):
        def call():
            op_builder._LIBS["quant"] = lib
            return quantize_param_tree(tree, bits=4, group_size=64)[0]
        return call

    def check_build(src, got):
        flat = [t for leaf in [*got["blocks"].values(), got["wte"],
                               got["wpe"]] for t in (leaf.q, leaf.scale)]
        if not _same(flat, want):
            raise AssertionError(f"{src} quant_generate_build: kernel != "
                                 f"plain version")
    _ab_rows("quant_generate_build", "quantize_int4",
             [(src, build(libs[src])) for src in dirs], [{}],
             *cs.bound(n * 2 + n // 2 + n // 64 * 4, 4 * n, cs.FP32_FLOPS),
             reps, check_build)
    del tree, leaves, want
    torch.cuda.empty_cache()
    # row 13: the dropless layer's sort and beyond it
    sort_libs = {}
    for src in dirs:
        _use(src)
        sort_libs[src] = op_builder.load("token_sort")
    for label, n, E, dtype in (("path_int64", 4096, 8, torch.int64),
                               ("path_int32", 4096, 8, torch.int32),
                               ("n65536", 65536, 8, torch.int32),
                               ("e128", 4096, 128, torch.int32)):
        sets = [dict(idx=torch.from_numpy(rng.integers(0, E, n)).to(
            "cuda", dtype)) for _ in range(64)]
        want = ts.token_sort_reference(sets[0]["idx"], E)

        def check(src, got, want=want, label=label):
            if not _same(list(got), list(want)):
                raise AssertionError(f"{src} token_sort {label}: kernel != "
                                     f"plain version")
        id_bytes = 8 if dtype == torch.int64 else 4
        variants = [(src, lambda idx, sort=_sort_of(sort_libs[src]), E=E:
                     sort(idx, E)) for src in dirs]
        _ab_rows(label, "token_sort", variants, sets,
                 *cs.bound(id_bytes * n + 4 * n + 4 * E, n * E,
                           cs.FP32_FLOPS), reps, check)
        del sets


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-others", action="store_true")
    ap.add_argument("--no-dequantize", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("quant_ab: no CUDA card")
    smi = cs.phase_device()["nvidia_smi"]
    if args.ptxas:
        for src in args.dirs:
            print(json.dumps({"dir": src, "ptxas": _ptxas(src, "quant.cu")}),
                  flush=True)
    libs = {}
    for src in args.dirs:
        _use(src)
        libs[src] = op_builder.load("quant")
    _write_ab(args.dirs, libs, args.reps)
    if not args.no_dequantize:
        for bits in (8, 4):
            _dequant_ab(args.dirs, libs, bits, args.reps)
    if not args.no_others:
        _rows_8_13(args.dirs, libs, args.reps)
        _use(args.dirs[-1])
        op_builder._LIBS["quant"] = libs[args.dirs[-1]]
        _others(args.reps)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
