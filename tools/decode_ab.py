"""A/B of the decode kernels (PERF.md rows 4, 5 and 6) built from several
source directories (copies of `deepspeed_tpu_torch/ops/csrc`, e.g. the
parent commit's from `git archive`), checked and timed in turns on one CUDA
card, with SDPA at row 4's shape; then, optionally, end-to-end tokens/s of
two whole trees in turns.

    python tools/decode_ab.py DIR [DIR ...] [--reps N] [--ptxas]
        [--chunks C[,C ...]] [--trees A B --turns N]

Cases (`CASES`): "serve" (row 5, chip_smoke.PAGED_SERVE: gpt2-125m's
serving decode, 8 slots, 12 heads of 64, 512-row blocks, table width 2),
"quant_serve" (row 6, the same over the int8 pool, g 64), "long" and
"long_int8" (chip_smoke.PAGED_LONG: Llama-3-8B's attention, 32 query heads
over 8 kv heads of 128, 8 rows at position 4095, bf16 and the int8 pool at
g 64), "generate" (row 4, generate()'s decode over a 1024-row cache:
chip_smoke.DECODE_GENERATE) and "long_contiguous" (row 4 at Llama-3-8B's
attention, 8 rows at position 4095 of a 4096-row cache:
chip_smoke.DECODE_LONG).
Each directory's kernel is first checked against the plain version
(chip_smoke's `_paged_check` / `TOL`), then all are timed in turns: device
time of CUDA graphs of the wrapper replayed in turns, the inputs rotated
past the 50 MB L2 (`graph_ms`; `chip_smoke.graph_ms_turns`), the
profiler's kernels a call (`kernels`), and the wrapper's host time a call
(`host_ms`, calls enqueued back to back, the variants in turns, the
median of 7 rounds), beside the bound as chip_smoke
counts it. A directory whose paged kernel ends in the last chunk's combine
is also built without it (`DIR#nocombine`: every chunk writes its partial
and stops; its output is not checked): the difference is the combine's
share of the device time. `--chunks` times the last directory's kernel at
other chunk sizes too (`DIR#chunkC`). Each DIR is called through the
wrappers of its own tree where a decode_attention.py sits beside it (a
`git archive` of another commit's deepspeed_tpu_torch/ops, e.g. the
parent's), else through this tree's.
SDPA's device time at row 4's generate shape is timed beside row 4 there.

With `--trees A B`, then runs `python chip_smoke.py
build,generate,serve,quant,moe` in each tree in turns (A B B A, `--turns`
times) and prints each run's generate, serve, quant_generate,
quant_serve, moe_generate and moe_serve tokens/s.

Prints one JSON line per (case, variant), then the card's name and power
limit. Run from the repo's root; it needs the CUDA toolkit and a card.
"""

import argparse
import importlib.util
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from attn_fwd_ab import _ptxas, _use  # noqa: E402  (this directory)
from deepspeed_tpu_torch.ops import decode_attention as da  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

CASES = {"serve": cs.PAGED_SERVE, "quant_serve": dict(cs.PAGED_SERVE, g=64),
         "long": cs.PAGED_LONG, "long_int8": dict(cs.PAGED_LONG, g=64)}
ROW4_CASES = {"generate": cs.DECODE_GENERATE,
              "long_contiguous": cs.DECODE_LONG}
# the line that ends a chunk's work where it is the row's only live chunk;
# "return" there for every chunk leaves the combine out
_COMBINE_CUT = ("  if (nlive == 1) return;\n", "  return;\n")
def _wrappers(src):
    """The decode wrappers' module of `src`'s tree: the decode_attention.py
    beside a csrc directory (a `git archive` of another commit's
    deepspeed_tpu_torch/ops), else this tree's."""
    py = pathlib.Path(src).parent / "decode_attention.py"
    if not py.exists():
        return da
    spec = importlib.util.spec_from_file_location(
        f"decode_attention_{len(_MODULES)}", py)
    mod = _MODULES[src] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_MODULES = {}


def _call(lib, mod, chunk=None):
    """The paged wrapper (both pools) of module `mod` through `lib`, the
    split at `chunk` positions where given."""
    plan = getattr(mod, "split_plan", None)

    def call(**kw):
        op_builder._LIBS["decode_attention"] = lib
        if chunk is not None:
            mod.split_plan = lambda cap, rows: (chunk, -(-cap // chunk))
        try:
            if "k_scale" in kw:
                return mod.paged_decode_attention_quant(**kw)
            return mod.paged_decode_attention(**kw)
        finally:
            mod.split_plan = plan
    return call


def _nocombine(src):
    """A copy of `src` whose paged kernel stops after its partial, or None
    where the kernel has no such combine."""
    text = (pathlib.Path(src) / "decode_attention.cu").read_text()
    if _COMBINE_CUT[0] not in text:
        return None
    dst = pathlib.Path(src).parent / (pathlib.Path(src).name + "_nocombine")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("out"))
    (dst / "decode_attention.cu").write_text(text.replace(*_COMBINE_CUT))
    return str(dst)


def _libs(dirs, chunks):
    """[(variant name, call, checked)] for every directory (and its
    combine-less copy), and the last one at each of `chunks`."""
    variants = []
    for src in dirs:
        mod = _wrappers(src)
        _use(src)
        lib = op_builder.load("decode_attention")
        variants.append((src, _call(lib, mod), True))
        cut = _nocombine(src)
        if cut is not None:
            _use(cut)
            variants.append((f"{src}#nocombine",
                             _call(op_builder.load("decode_attention"), mod),
                             False))
    if chunks:
        mod = _wrappers(dirs[-1])
        _use(dirs[-1])
        lib = op_builder.load("decode_attention")
        variants += [(f"{dirs[-1]}#chunk{c}", _call(lib, mod, c), True)
                     for c in chunks]
    return variants


def _time_case(label, case, variants, reps):
    rng = np.random.default_rng(0)
    sets = cs._paged_sets(rng, case)
    name = "paged_decode_attention_quant" if "g" in case else \
        "paged_decode_attention"
    plain = da.paged_decode_attention_quant_reference if "g" in case else \
        da.paged_decode_attention_reference
    kw = sets[0]
    ref = plain(**({"q": kw["q"], "pool_l": {
        "k": kw["k_pool"], "v": kw["v_pool"], "k_scale": kw["k_scale"],
        "v_scale": kw["v_scale"]}, "block_tables": kw["block_tables"],
        "pos": kw["pos"]} if "g" in case else kw))
    checks = []
    for vname, call, checked in variants:
        if checked:
            out = call(**kw)
            torch.cuda.synchronize()
            cs._paged_check(checks, name, f"{label} {vname}", out, ref)
    rots = [cs._Rotating(call, sets) for _, call, _ in variants]
    inner = len(sets) * max(1, round(20 / len(sets)))
    graph = cs.graph_ms_turns(rots, inner=inner, reps=reps)
    host = _host_turns(rots)
    b_ms, b_by = cs._paged_bound(case)
    for (vname, _, checked), rot, g, hst in zip(variants, rots, graph, host):
        dev, kernels = cs._device_ms(rot, calls=max(10, len(sets)))
        err = next((c["max_abs_err"] for c in checks
                    if c["case"] == f"{label} {vname}"), None)
        print(json.dumps({
            "case": label, "kernel": name, "variant": vname,
            "shape": {k: v for k, v in case.items() if k != "pos"},
            "sets": len(sets), "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by, "graph_ms": g, "graph_bound_factor": g / b_ms,
            "device_ms": dev, "kernels": kernels, "host_ms": hst}),
            flush=True)
    del sets, rots


def _host_turns(fns, rounds=7, calls=50):
    """Median host time of one call of each fn (`chip_smoke._host_ms`: calls
    enqueued back to back), the fns taken in turns `rounds` times."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, t in zip(fns, times):
            t.append(cs._host_ms(fn, calls=calls))
    return [statistics.median(t) for t in times]


def _time_row4(label, dirs, reps):
    """Row 4 through each directory's wrappers at one of ROW4_CASES, in
    turns, and at the generate shape SDPA with the prefix mask."""
    case = ROW4_CASES[label]
    rng = np.random.default_rng(1)
    per_set = 2 * case["B"] * case["Hkv"] * case["M"] * case["hd"] * 2
    sets = []
    for _ in range(int(min(8, max(2, -(-cs.NORM_COLD_BYTES // per_set))))):
        kw = cs._decode_args(rng, case)
        mask = (torch.arange(case["M"], device="cuda")[None, :]
                <= kw["pos"][:, None].long())[:, None, None, :]
        sets.append(dict(q=kw["q"], kc=kw["k"], vc=kw["v"], pos=kw["pos"],
                         mask=mask))
    calls = []
    for src in dirs:
        mod = _MODULES.get(src, da)
        _use(src)
        lib = op_builder.load("decode_attention")

        def row4(q, kc, vc, pos, mask, lib=lib, mod=mod):
            op_builder._LIBS["decode_attention"] = lib
            return mod.decode_attention(q, kc, vc, pos)
        calls.append((src, row4))
    if case["H"] == case["Hkv"]:
        calls.append(("sdpa", lambda q, kc, vc, pos, mask:
                      F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                                     attn_mask=mask)))
    kw = sets[0]
    ref = da.decode_attention_reference(kw["q"], kw["kc"], kw["vc"],
                                        kw["pos"])
    rots = [cs._Rotating(fn, sets) for _, fn in calls]
    inner = len(sets) * max(1, round(16 / len(sets)))
    graph = cs.graph_ms_turns(rots, inner=inner, reps=reps)
    host = _host_turns(rots)
    b_ms, b_by = cs._decode_bound(case)
    for (vname, fn), rot, g, hst in zip(calls, rots, graph, host):
        out = fn(**kw).reshape(ref.shape)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        dev, kernels = cs._device_ms(rot, calls=max(10, len(sets)))
        print(json.dumps({
            "case": label, "kernel": "decode_attention",
            "variant": vname, "shape": {k: v for k, v in case.items()
                                        if k != "pos"},
            "sets": len(sets), "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by, "graph_ms": g, "graph_bound_factor": g / b_ms,
            "device_ms": dev, "kernels": kernels, "host_ms": hst}),
            flush=True)


def _tokens(trees, turns):
    """chip_smoke's generate and serving phases in each tree in turns (A B
    B A ...): generate, serve, quant_generate, quant_serve, moe_generate
    and moe_serve tokens/s of each run."""
    order = []
    for _ in range(turns):
        order += [trees[0], trees[1], trees[1], trees[0]]
    failed = []
    for tree in order:
        run = subprocess.run(
            [sys.executable, "chip_smoke.py",
             "build,generate,serve,quant,moe"], cwd=tree,
            capture_output=True, text=True)
        got = {"tree": tree, "rc": run.returncode}
        for line in run.stdout.splitlines():
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if not isinstance(obj, dict):
                continue
            if obj.get("phase") in ("generate", "serve"):
                got[obj["phase"]] = obj["tokens_per_s"]
            elif obj.get("phase") == "quant":
                got["quant_generate"] = obj["generate_int4"]["tokens_per_s"]
                got["quant_serve"] = obj["serve"]["tokens_per_s"]
            elif obj.get("phase") == "moe":
                got["moe_generate"] = obj["generate"]["tokens_per_s"]
                got["moe_serve"] = obj["serve"]["tokens_per_s"]
        if run.returncode:
            got["stderr"] = run.stderr[-2000:]
            failed.append(tree)
        print(json.dumps(got), flush=True)
    if failed:
        raise SystemExit(f"decode_ab: chip_smoke failed in {failed}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--chunks", default="")
    ap.add_argument("--trees", nargs=2)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("decode_ab: no CUDA card")
    smi = cs.phase_device()["nvidia_smi"]
    if args.ptxas:
        for src in args.dirs:
            print(json.dumps({"dir": src, "ptxas": _ptxas(
                src, "decode_attention.cu")}), flush=True)
    chunks = [int(c) for c in args.chunks.split(",") if c]
    variants = _libs(args.dirs, chunks)
    for label, case in CASES.items():
        _time_case(label, case, variants, args.reps)
        torch.cuda.empty_cache()
    for label in ROW4_CASES:
        _time_row4(label, args.dirs, args.reps)
        torch.cuda.empty_cache()
    if args.trees:
        _tokens(args.trees, args.turns)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
