"""A/B of the two attention forward kernels built from several source
directories (copies of `deepspeed_tpu_torch/ops/csrc` with a change),
timed in turns on one CUDA card.

    python tools/attn_fwd_ab.py DIR [DIR ...] [--rounds N]

Each round walks the directories in order; for each it builds that
directory's `flash_fwd.cu` and `block_sparse.cu` (`op_builder`, the
libraries under DIR/out), checks the flash forward against its plain
version (chip_smoke's absolute tolerance), and times device time alone (CUDA
graphs, `chip_smoke.graph_ms`): the flash forward at its three path
shapes (generate B 4 T 600 hd 64, train B 12 T 512 hd 128, moe_train B 8
T 512 hd 64; causal, bf16) and the block-sparse forward at the sparse
paths' shape (sparse_train: B 1, H 12, T 8192, hd 64, the Fixed
unidirectional layout, causal; sparse_op: the same layout with a learned
[T, T] bias and 100 padded keys). Prints one JSON line per (directory,
case) with the median over the rounds, each round's time and, for the
block-sparse cases, the largest difference from the first directory's
output; then SDPA's device time at the flash shapes. Run from the repo's
root; it needs the CUDA toolkit and a card.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa  # noqa: E402
from deepspeed_tpu_torch.ops import flash_attention as fa  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    FixedSparsityConfig  # noqa: E402

FLASH_SHAPES = {"generate": dict(B=4, T=600, H=12, Hkv=12, D=64),
                "train": dict(B=12, T=512, H=12, Hkv=12, D=128),
                "moe_train": dict(B=8, T=512, H=12, Hkv=12, D=64)}
SPARSE_T = 8192


def _use(src):
    op_builder.CSRC = pathlib.Path(src)
    op_builder.BUILD_DIR = pathlib.Path(src) / "out"
    op_builder._LIBS.clear()


def _ptxas(src, source):
    """nvcc's -Xptxas -v lines (registers, spills, shared memory of each
    kernel) for the file `source` in `src`, built with
    `op_builder.NVCC_FLAGS`."""
    out = pathlib.Path(src) / "out"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [op_builder.nvcc_path(), *op_builder.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", str(out / "ptxas.so"), str(pathlib.Path(src) / source)]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode:
        return [f"nvcc exit {log.returncode}", log.stderr[-3000:]]
    return [line.strip() for line in (log.stdout + log.stderr).splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attn_fwd_ab: no CUDA card")
    rng = np.random.default_rng(0)
    flash = {n: cs._flash_case(rng, **s, causal=True)
             for n, s in FLASH_SHAPES.items()}
    refs = {n: fa.flash_attention_reference(q, k, v)[0]
            for n, (q, k, v, _) in flash.items()}
    layout = FixedSparsityConfig(
        num_heads=12, block=16, num_local_blocks=256, num_global_blocks=8,
        attention="unidirectional").make_layout(SPARSE_T)
    sq, sk, sv = (torch.from_numpy(rng.standard_normal(
        (1, SPARSE_T, 12, 64)).astype(np.float32)).to(
            "cuda", torch.bfloat16).transpose(1, 2) for _ in range(3))
    rpe = torch.from_numpy((rng.standard_normal((SPARSE_T, SPARSE_T))
                            * 0.5).astype(np.float32)).cuda()
    kpm = torch.ones(1, SPARSE_T, dtype=torch.bool, device="cuda")
    kpm[0, -100:] = False
    sparse = {
        "sparse_train": lambda: bsa.block_sparse_attention(
            sq, sk, sv, layout, block=16, causal=True),
        "sparse_op": lambda: bsa.block_sparse_attention(
            sq, sk, sv, layout, block=16, bias=rpe, key_padding_mask=kpm)}
    times, diffs, first = {}, {}, {}
    for _ in range(args.rounds):
        for src in args.dirs:
            _use(src)
            for name, (q, k, v, _) in flash.items():
                out = fa.flash_attention(q, k, v)
                err = (out.float() - refs[name].float()).abs().max().item()
                if not err <= cs.TOL["flash_attention"]:
                    raise AssertionError(f"{src} {name}: flash err {err}")
                times.setdefault((src, name), []).append(
                    cs.graph_ms(lambda: fa.flash_attention(q, k, v)))
            for name, fn in sparse.items():
                out = fn().float()
                base = first.setdefault(name, out)
                diffs[src, name] = max(diffs.get((src, name), 0.0),
                                       (out - base).abs().max().item())
                times.setdefault((src, name), []).append(
                    cs.graph_ms(fn, inner=5))
    for (src, name), ts in times.items():
        print(json.dumps({"dir": src, "case": name,
                          "graph_ms": statistics.median(ts), "rounds": ts,
                          "max_diff_to_first": diffs.get((src, name))}))
    print(json.dumps({"sdpa_graph_ms": {
        n: cs.graph_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)) for n, (q, k, v, _) in flash.items()}}))


if __name__ == "__main__":
    main()
