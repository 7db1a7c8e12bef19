"""What holds the dense quantize at wte: the card's reads of x.

    python tools/quant_reads.py [DIR] [--rounds N]

On one CUDA card, over 3 bf16 [50304, 768] sets (wte's shape) rotated so
that no input is read from L2, times as CUDA-graph device time in turns
(`chip_smoke.graph_ms_turns`), `--rounds` times (default 2):
  * library calls that read the same 77 MB: a row amax, an fp32 row sum,
    and a cast to int8 (which also writes 38.6 MB);
  * quantize_int8 and quantize_int4 (g 64) built from DIR, a copy of
    `deepspeed_tpu_torch/ops/csrc` (default: the package's own);
  * the same from a copy of DIR whose vector body computes each unit's
    payload but does not store it ("nostore", a text cut of `quant.cu`
    written under `build/quant_reads/`): if it runs as long as the
    quantize, the reads of x hold it, not its stores.
Prints one JSON line per case and round (device ms and the bytes it
moves over that time), then the card's name and power limit. Run from
the repo's root; it needs the CUDA toolkit and a card.
"""

import argparse
import json
import pathlib
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from attn_fwd_ab import _use  # noqa: E402  (this directory)
from deepspeed_tpu_torch.ops import op_builder, quant  # noqa: E402

# the vector body's payload store, and what the "nostore" copy puts there:
# the payload still computed (kept live by a store that never happens)
STORE = """      if constexpr (BITS == 8) {
        *reinterpret_cast<uint2*>(qd + d + 8 * j) =
            make_uint2(pack4(n), pack4(n + 4));
      } else {
        *reinterpret_cast<uint32_t*>(qd + d / 2 + 4 * j) = pack8_nibbles(n);
      }"""
NO_STORE = """      const uint32_t w = BITS == 8 ? pack4(n) ^ pack4(n + 4)
                                   : pack8_nibbles(n);
      if (w == 0x12345678u)
        *reinterpret_cast<uint32_t*>(qd + d / 2 + 4 * j) = w;"""


def _copies(src):
    """(DIR copied, DIR copied and cut) under build/quant_reads/, where
    their libraries are built."""
    out = []
    for name, cut in (("change", False), ("nostore", True)):
        dst = pathlib.Path("build/quant_reads") / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns("out"))
        text = (dst / "quant.cu").read_text()
        if cut:
            if text.count(STORE) != 1:
                sys.exit("quant_reads: the payload store of quant.cu's "
                         "vector body is not where this tool cuts it")
            (dst / "quant.cu").write_text(text.replace(STORE, NO_STORE))
        out.append((name, dst))
    return out


def _quantize(lib, bits):
    def call(x):
        op_builder._LIBS["quant"] = lib
        return quant.quantize(x, 64, bits)
    return call


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?", default=str(op_builder.CSRC))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("quant_reads: no CUDA card")
    smi = cs.phase_device()["nvidia_smi"]
    libs = {}
    for name, src in _copies(args.dir):
        _use(src)
        libs[name] = op_builder.load("quant")
    rng = np.random.default_rng(0)
    sets = [dict(x=torch.from_numpy(rng.standard_normal(
        (50304, 768)).astype(np.float32)).to("cuda", torch.bfloat16))
        for _ in range(3)]
    n = 50304 * 768
    scales = n // 64 * 4
    cases = [
        ("amax_rows", lambda x: torch.amax(x, dim=-1), 2 * n),
        ("sum_rows_fp32", lambda x: x.sum(dim=-1, dtype=torch.float32),
         2 * n),
        ("to_int8", lambda x: x.to(torch.int8), 3 * n),
        ("int8", _quantize(libs["change"], 8), 3 * n + scales),
        ("int4", _quantize(libs["change"], 4), 2 * n + n // 2 + scales),
        ("int8_nostore", _quantize(libs["nostore"], 8), 2 * n + scales),
        ("int4_nostore", _quantize(libs["nostore"], 4), 2 * n + scales)]
    for rnd in range(args.rounds):
        ms = cs.graph_ms_turns([cs._Rotating(fn, sets) for _, fn, _ in cases],
                               inner=6, reps=10)
        for (name, _, nbytes), t in zip(cases, ms):
            print(json.dumps({"round": rnd, "case": name, "graph_ms": t,
                              "bytes": nbytes,
                              "TB_per_s": nbytes / t / 1e9}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
