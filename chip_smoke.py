#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py            # every phase; exit 0 only if all pass

Phases, one JSON line each:
  device   the card (nvidia-smi name + power limit); fails without CUDA;
  build    nvcc builds every kernel source in ops/csrc/, all in parallel;
  kernels  each kernel against its plain PyTorch version on the card at the
           shapes its paths give it (generate/serve: gpt2-125m, H=12,
           hd=64, bf16; train: gpt2-760m, B 12, T 512, H 12, hd 128,
           causal) and at hd 128 / G=4 / ragged T; the backward kernels
           also at hd 64, GQA 4 with ragged T and an lse cotangent,
           non-causal, and in fp16; the int8 paged decode at the serve
           shape with groups 64 and 32, on a shuffled table with an
           all-trash row and at hd 128 / GQA 4 (one bf16 step of each
           element, and 1e-2); quantize and
           dequantize (int8, int4) bit-exact at the K/V pool-write shape
           and the largest weights (wte, mlp_up_w); with medians of
           CUDA-event timings of the kernel, its plain version and, where
           one PyTorch call computes the same function, that call
           (library_ms); token_sort bit-exact at the dropless path's shape
           (N 4096, E 8), E 64 and 128, N 65 536, an odd N, all ids equal,
           ids out of range and negative, int64 ids; fused_layer_norm /
           fused_rms_norm within one output-dtype step at [4096, 768] bf16
           with and without a residual, [4096, 4096] fp16, [37, 1000] fp32;
  norms    the public norm ops at [4096, 768] bf16: one launch each;
  generate init_inference -> generate() on gpt2-125m at full width and
           depth (random weights from a numpy seed), bf16: launch counts,
           prefill and first-decode logits held against the port's fp32
           CPU run of the same weights and tokens, tokens/s;
  serve    ServingEngine on the same model: 16 ragged requests through 8
           slots over the paged pool; completion, one paged-decode launch
           per layer per decode step, drained
           pool, the served tokens' agreement with generate() on the same
           prompts, requests/s and tokens/s;
  quant    quantized serving on the same model, four paths, each with
           exact launch counts of its own: (a) the engine.serving build
           with int8 weights (one quantize_int8 per quantized leaf), then
           the int8 KV pool and int8 weights over the serve phase's 16
           requests — completion, drained pool, one int8 paged decode per
           layer per decode step, two quantize_int8 per layer per model
           step for the K/V writes, the WOQ dequantize_int8 count derived
           from the quantized tree; the served tokens' agreement with the
           same engine's generate(), quantized weights byte-equal to the
           port's CPU quantization of the same bf16-rounded weights,
           prefill and first-decode logits (the decode over each pool)
           against that CPU engine; (b) init_inference(quant int4) (one
           quantize_int4 per quantized leaf), then generate() on the
           generate phase's prompts — flash per prefill, decode per decode
           step, WOQ dequantize_int4 per model step, payload equality and
           prefill / first-decode logits against the CPU run; weight and
           pool bytes, peak device memory of the build and of the timed
           run apart, requests/s and tokens/s;
  train    initialize() -> train_batch() on gpt2-760m at full width and
           depth (24 layers, d_model 1536, 12 heads of 128, random weights
           from a numpy seed): AdamW, bf16 without master weights, clipping
           1.0, ZeRO 1, micro-batch 12, seq 512, gas 2, remat
           nothing_saveable. One warm-up step, then 3 timed steps on one
           batch: finite falling loss, no overflow, exact launch counts
           (flash forward 2 x 24 x gas per step — forward and remat
           recompute — and 24 x gas per backward kernel), seconds per step,
           tokens/s and MFU; then the first step's loss and every
           parameter's gradient at 2 layers, bf16 on the card against the
           port's fp32 CPU run of the same weights and batch;
  moe      moe-gpt-125m-e8 (docs/parallelism.md:76: 12 layers, d_model
           768, 8 experts in every second block, capacity factor 1.25)
           at full width and depth, bf16, random weights from a numpy seed,
           four paths: (a) initialize() -> train_batch() (the bench MoE
           lane's engine config, micro-batch 8, seq 512, gas 2; 1 warm-up
           + 3 timed steps): finite falling loss, the moe/* metrics, exact
           flash launches (12 x gas per step each, no remat), tokens/s,
           MFU on the active parameters, the dense twin's step; then the
           2-layer loss and gradients against the CPU twin on the tokens
           routed alike; (b) generate() on the generate phase's prompts:
           exact launches, prefill / first-decode logits against the CPU
           twin on the rows routed alike in every MoE layer; (c) the
           serving engine on the serve trace: completion, drained pool,
           exact paged-decode launches, agreement with (b)'s generate();
           (d) the dropless moe.layer.MoE on x [8, 512, 768]: one
           token_sort launch, counts and unique slots, the per-token
           argmax oracle, finite gradients. Each MoE layer's top-1 routes
           on the card and the CPU twin are recorded by wrapping the
           port's routing functions from here, and their per-layer share
           alike is held to a floor;
  profile  (opt-in, after the phases it reads) torch.profiler over the same
           generate() call, serving runs (bf16, quantized, MoE) and one
           train_batch (gpt2-760m, MoE): kernel time on the card by class
           and the card's idle share of the unprofiled wall time.
A comma-separated phase list as the one argument runs those phases only
(the device phase always runs), e.g. `build,train,profile`,
`build,kernels,quant` or `build,kernels,moe`. Then the
card's name and power limit, the `kernels` summary line (one row per
kernel and path that runs it — the flash forward has generate,
quant_generate and train rows; quantize_int8 a quant_serve row, the K/V
writes, and a quant_serve_build row, the weights — with `launches`
counted from 0 just before that path's run and read just after, and
times at that path's shape), and as the last
line `{"ok": true, "device": {...}}`. Any failure exits non-zero
and prints no result line. It imports no JAX and nothing of deepspeed_tpu.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16
# tensor-core rate, fp32 rate outside the tensor cores (the decode and quant
# kernels do their arithmetic there).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# kernel vs plain version, bf16 on the card. Flash narrows P to bf16 before
# the P @ V product (as the TPU kernel does); decode keeps P in fp32.
# Quantize and dequantize are bit-exact.
TOL = {"flash_attention": 2e-2, "decode_attention": 1e-2,
       "paged_decode_attention": 1e-2, "paged_decode_attention_quant": 1e-2}
# The int8 paged decode dequantizes K/V exactly as its plain version does
# (int8 x fp32 scale, narrowed to bf16) and both sum in fp32, so the two
# fp32 results differ only by summation order before the one rounding of the
# output to bf16. That rounding can land them one bf16 step apart, at most
# 2^-7 of the element; QUANT_DECODE_ATOL covers the fp32 order noise. Each
# element must stay within that, besides TOL's 1e-2 on the largest error.
QUANT_DECODE_REL, QUANT_DECODE_ATOL = 2.0 ** -7, 1e-5
# backward kernels vs the fp32 plain backward on the same bf16 inputs and
# saved (out, lse), as max abs error over the reference's largest |entry|:
# the kernels narrow p and ds to bf16 (relative 2^-9 each) before the
# products and round the gradient to bf16 once; sums are fp32
BWD_REL_TOL = 2e-2
# gpt2-125m logits, bf16 on the card vs fp32 on the CPU (logit std ~0.5)
LOGIT_TOL = 6e-2
# share of served tokens equal to generate()'s on the same prompts (bf16)
SERVE_AGREE_MIN = 0.9
# training parity, 2 layers of gpt2-760m: bf16 on the card against fp32 on
# the CPU from the same bf16-rounded weights. The card rounds activations
# and matmul inputs to bf16 (relative 2^-9 each) and sums in fp32; at
# init the loss is ~ln(50304) = 10.8 and each logit moves by ~1e-3, so the
# mean loss by far less than LOSS_TOL. Each gradient leaf passes through
# the head, two blocks and the attention kernels' bf16 p and ds: its
# relative error ||card - cpu|| / ||cpu|| stays within GRAD_REL_TOL.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
# quant phase (a): share of tokens served over the int8 pool (int8 weights)
# equal to generate()'s on the same engine, which keeps K/V in bf16. Int8
# K/V moves each element by up to half a step (1/254 of its vector's
# |max|), about twice bf16's relative rounding, so near-tied argmaxes flip
# more often than in the serve phase (floor 0.9 there), and a flip changes
# the rest of that request.
QUANT_SERVE_AGREE_MIN = 0.8
# logits of the quantized engines, bf16 on the card vs fp32 on the CPU from
# the same bf16-rounded weights (quantized to the same bytes): LOGIT_TOL's
# bf16 error, plus int8 K/V that may round a bf16 and an fp32 value one
# step apart, plus (int4) the weights' bf16 narrowing after dequantization
QUANT_LOGIT_TOL = 1e-1

# the training main path: the bench headline lane's config
# (bench.py:220-228) on gpt2-760m at full width and depth, at gas 2
TRAIN_MODEL, TRAIN_MBS, TRAIN_SEQ, TRAIN_GAS, TRAIN_STEPS = \
    "gpt2-760m", 12, 512, 2, 3
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": TRAIN_MBS,
    "gradient_accumulation_steps": TRAIN_GAS,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                              "weight_decay": 0.1}},
    "bf16": {"enabled": True, "master_weights": False},
    "gradient_clipping": 1.0,
    "zero_optimization": {"stage": 1},
    "steps_per_print": 10**9,
}

# the MoE phase: moe-gpt-125m-e8, the MoE config of docs/parallelism.md:76
# (GPTConfig's defaults: 12 heads of 64, d_ff 3072, vocab 50304), trained
# with the bench MoE lane's engine config (bench.py:1753-1758) at
# micro-batch 8, seq 512, gas 2
MOE_MODEL = "moe-gpt-125m-e8"
MOE_CFG = dict(n_layer=12, d_model=768, num_experts=8, moe_freq=2,
               capacity_factor=1.25)
MOE_MBS, MOE_SEQ, MOE_GAS, MOE_STEPS = 8, 512, 2, 3
MOE_TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": MOE_MBS,
    "gradient_accumulation_steps": MOE_GAS,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 1},
    "steps_per_print": 10**9,
}
# share of tokens whose top-1 expert is the same on the card (bf16) and in
# the CPU twin (fp32), per MoE layer. Gate logits have std 0.554 (gate_w
# std 0.02 over d_model 768 of a LayerNorm'd input); the top-two gap of 8
# such logits is below d with probability ~2.5·d. The card computes the
# gate product in bf16 and rounds each logit to bf16 (steps of 2^-8..2^-7
# at the top logits, where a tie takes the lower index) on a residual
# stream that carries bf16 error: ~1 % of tokens per layer route
# otherwise. The floor is five times that.
ROUTE_AGREE_MIN = 0.95
# the dropless layer (bf16 expert FFN: products rounded to bf16 after fp32
# sums, GELU on bf16, the gate weight in bf16) against the per-token argmax
# oracle computed in fp32 from the same bf16 inputs and the same routes:
# each element within 2^-6 of the oracle's largest |entry|, about four bf16
# roundings of the largest output
DROPLESS_REL_TOL = 2.0 ** -6

REPLACES = {
    "paged_decode_attention_quant":
        "deepspeed_tpu/ops/pallas/decode_attention.py:339",
    "quantize_int8": "deepspeed_tpu/ops/pallas/quant.py:64",
    "quantize_int4": "deepspeed_tpu/ops/pallas/quant.py:128",
    "dequantize_int4": "deepspeed_tpu/ops/pallas/quant.py:156",
    "dequantize_int8": "deepspeed_tpu/ops/pallas/quant.py:179",
    "flash_attention": "deepspeed_tpu/ops/pallas/flash_attention.py:143",
    "flash_attention_bwd_dq":
        "deepspeed_tpu/ops/pallas/flash_attention.py:297",
    "flash_attention_bwd_dkv":
        "deepspeed_tpu/ops/pallas/flash_attention.py:323",
    "decode_attention": "deepspeed_tpu/ops/pallas/decode_attention.py:156",
    "paged_decode_attention":
        "deepspeed_tpu/ops/pallas/decode_attention.py:234",
    "fused_layer_norm": "deepspeed_tpu/ops/pallas/norms.py:54",
    "fused_rms_norm": "deepspeed_tpu/ops/pallas/norms.py:79",
    "token_sort": "deepspeed_tpu/ops/pallas/token_sort.py:66",
}
SOURCES = {
    "flash_attention": "deepspeed_tpu_torch/ops/csrc/flash_fwd.cu",
    "flash_attention_bwd_dq": "deepspeed_tpu_torch/ops/csrc/flash_bwd.cu",
    "flash_attention_bwd_dkv": "deepspeed_tpu_torch/ops/csrc/flash_bwd.cu",
    "decode_attention": "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
    "paged_decode_attention":
        "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
    "paged_decode_attention_quant":
        "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
    "quantize_int8": "deepspeed_tpu_torch/ops/csrc/quant.cu",
    "quantize_int4": "deepspeed_tpu_torch/ops/csrc/quant.cu",
    "dequantize_int4": "deepspeed_tpu_torch/ops/csrc/quant.cu",
    "dequantize_int8": "deepspeed_tpu_torch/ops/csrc/quant.cu",
    "fused_layer_norm": "deepspeed_tpu_torch/ops/csrc/norms.cu",
    "fused_rms_norm": "deepspeed_tpu_torch/ops/csrc/norms.cu",
    "token_sort": "deepspeed_tpu_torch/ops/csrc/token_sort.cu",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps=15, inner=5, warmup=3):
    """Median over `reps` CUDA-event-timed runs of `inner` calls each."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes, flops, peak=BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    from deepspeed_tpu_torch.ops import op_builder
    t0 = time.perf_counter()
    libs = op_builder.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v.name) for k, v in libs.items()}})


def _flash_case(rng, B, T, H, Hkv, D, causal, dtype="bfloat16"):
    import torch
    # q/k/v as [B, T, H, D] views of one fused projection, as the model
    # hands them to the kernel
    qkv = torch.from_numpy(rng.standard_normal(
        (B, T, (H + 2 * Hkv) * D)).astype(np.float32)).to(
            "cuda", getattr(torch, dtype))
    q, k, v = qkv.split([H * D, Hkv * D, Hkv * D], dim=-1)
    return (q.reshape(B, T, H, D), k.reshape(B, T, Hkv, D),
            v.reshape(B, T, Hkv, D), causal)


def _decode_case(rng, B, H, Hkv, hd, M, pos):
    import torch

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16)
    return (randn(B, H, hd), randn(B, Hkv, M, hd), randn(B, Hkv, M, hd),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def _paged_case(rng, B, H, Hkv, hd, bs, nb, pos):
    import torch
    N = B * nb + 1
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    tables = perm[:B * nb].reshape(B, nb)
    live = [p > 0 for p in pos]
    tables[~np.asarray(live)] = 0          # inactive rows: trash block only

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16)
    return (randn(B, H, hd), randn(N, Hkv, bs, hd), randn(N, Hkv, bs, hd),
            torch.tensor(tables, device="cuda"),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(0)
    results, checks = {}, []

    def check(name, shape, out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(np.isfinite(err) and err <= TOL[name])
        checks.append({"kernel": name, "shape": shape, "max_abs_err": err,
                       "tol": TOL[name], "ok": ok})
        if not ok:
            raise AssertionError(f"{name} {shape}: max abs err {err} > "
                                 f"{TOL[name]}")
        return err

    # --- flash forward: its two paths' shapes — generate()'s prefill (4
    # prompts padded to 600, gpt2-125m heads) and the train step
    # (gpt2-760m) — then hd 128 / GQA 4 / ragged T, both masks
    for shape, path in ((dict(B=4, T=600, H=12, Hkv=12, D=64, causal=True),
                         "generate"),
                        (dict(B=12, T=512, H=12, Hkv=12, D=128, causal=True),
                         "train"),
                        (dict(B=8, T=512, H=12, Hkv=12, D=64, causal=True),
                         "moe_train"),
                        (dict(B=2, T=333, H=16, Hkv=4, D=128, causal=True),
                         None),
                        (dict(B=2, T=200, H=8, Hkv=2, D=128, causal=False),
                         None)):
        q, k, v, causal = _flash_case(rng, **shape)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                               layout="BTHD")
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                    layout="BTHD")
        torch.cuda.synchronize()
        err = check("flash_attention", shape, out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= 1e-2:
            raise AssertionError(f"flash lse err {lse_err}")
        if path is None:
            continue
        B, T, H, D = q.shape
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pairs = B * H * T * (T + 1) / 2
        nbytes = 4 * B * T * H * D * 2 + B * H * T * 4
        b_ms, b_by = bound(nbytes, 4 * D * pairs)
        results["flash_attention", path] = dict(
            max_abs_err=err,
            ms=median_ms(lambda: fa.flash_attention(q, k, v)),
            plain_ms=median_ms(lambda: fa.flash_attention_reference(
                q, k, v)), bound_ms=b_ms, bound_by=b_by,
            library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)))

    # --- contiguous decode: main path = generate()'s decode over the
    # 1024-row cache (600 + 32 rounded to 512-blocks), mid-generation
    lens = [100, 250, 431, 600]
    for shape, main in (
            (dict(B=4, H=12, Hkv=12, hd=64, M=1024,
                  pos=[n + 16 for n in lens]), True),
            (dict(B=8, H=32, Hkv=8, hd=128, M=2000,
                  pos=[0, 1, 63, 64, 700, 1999, 1500, 5]), False)):
        q, kc, vc, pos = _decode_case(rng, **shape)
        out = da.decode_attention(q, kc, vc, pos)
        ref = da.decode_attention_reference(q, kc, vc, pos)
        torch.cuda.synchronize()
        err = check("decode_attention", {k_: v_ for k_, v_ in shape.items()
                                         if k_ != "pos"}, out, ref)
        if not main:
            continue
        B, H, hd = q.shape
        Hkv = kc.shape[1]
        live = sum(p + 1 for p in shape["pos"])
        nbytes = 2 * live * Hkv * hd * 2 + 2 * B * H * hd * 2
        b_ms, b_by = bound(nbytes, 4 * live * H * hd, FP32_FLOPS)
        mask = (torch.arange(kc.shape[2], device="cuda")[None, :]
                <= pos[:, None].long())[:, None, None, :]
        results["decode_attention", "generate"] = dict(
            max_abs_err=err,
            ms=median_ms(lambda: da.decode_attention(q, kc, vc, pos)),
            plain_ms=median_ms(lambda: da.decode_attention_reference(
                q, kc, vc, pos)), bound_ms=b_ms, bound_by=b_by,
            library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask)))

    # --- paged decode: main path = ServingEngine's decode over 8 slots,
    # 512-row blocks, table width 2; then 16-row blocks, hd 128, GQA 4
    for shape, main in (
            (dict(B=8, H=12, Hkv=12, hd=64, bs=512, nb=2,
                  pos=[150, 0, 400, 640, 1000, 0, 260, 520]), True),
            (dict(B=6, H=16, Hkv=4, hd=128, bs=16, nb=40,
                  pos=[0, 15, 16, 333, 639, 100]), False)):
        q, kp, vp, tables, pos = _paged_case(rng, **shape)
        out = da.paged_decode_attention(q, kp, vp, tables, pos)
        ref = da.paged_decode_attention_reference(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        err = check("paged_decode_attention",
                    {k_: v_ for k_, v_ in shape.items() if k_ != "pos"},
                    out, ref)
        if not main:
            continue
        B, H, hd = q.shape
        Hkv = kp.shape[1]
        live = sum(p + 1 for p in shape["pos"])
        nbytes = 2 * live * Hkv * hd * 2 + 2 * B * H * hd * 2 \
            + tables.numel() * 4
        b_ms, b_by = bound(nbytes, 4 * live * H * hd, FP32_FLOPS)
        results["paged_decode_attention", "serve"] = dict(
            max_abs_err=err,
            ms=median_ms(lambda: da.paged_decode_attention(
                q, kp, vp, tables, pos)),
            plain_ms=median_ms(lambda: da.paged_decode_attention_reference(
                q, kp, vp, tables, pos)), bound_ms=b_ms, bound_by=b_by,
            library_ms=None)
    # the int4 generate() path and MoE-GPT's generate() run the same
    # prefill and decode shapes, MoE-GPT's serving the serve phase's
    for name in ("flash_attention", "decode_attention"):
        for path in ("quant_generate", "moe_generate"):
            results[name, path] = results[name, "generate"]
    results["paged_decode_attention", "moe_serve"] = \
        results["paged_decode_attention", "serve"]
    results.update(_backward_kernels(rng, checks))
    results.update(_quant_kernels(rng, checks))
    results.update(_token_sort_kernel(rng, checks))
    results.update(_norm_kernels(rng, checks))
    emit({"phase": "kernels", "checks": checks,
          "main_path": {f"{name}/{path}": row
                        for (name, path), row in results.items()}})
    return results


def _backward_kernels(rng, checks):
    """The dq and dk/dv kernels through the autograd path (q/k/v strided
    views of one fused projection, as the model hands them over) against
    the plain backward on the same inputs and saved (out, lse): at the
    two training paths' shapes (gpt2-760m: H 12, hd 128, B 12, T 512;
    moe-gpt-125m-e8: H 12, hd 64, B 8, T 512; causal), at hd 64 / T 600,
    at GQA 4 with a ragged T and an lse cotangent, non-causal, and at GQA 4
    with a ragged T in fp16. The forward of each case is held against its
    plain version too. Then each kernel alone timed at each path's
    shape."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    results = {}
    for shape, path, with_dlse in (
            (dict(B=12, T=512, H=12, Hkv=12, D=128, causal=True), "train",
             False),
            (dict(B=8, T=512, H=12, Hkv=12, D=64, causal=True), "moe_train",
             False),
            (dict(B=4, T=600, H=12, Hkv=12, D=64, causal=True), None, False),
            (dict(B=2, T=333, H=16, Hkv=4, D=128, causal=True), None, True),
            (dict(B=2, T=200, H=8, Hkv=2, D=64, causal=False), None, False),
            (dict(B=2, T=333, H=16, Hkv=4, D=128, causal=True,
                  dtype="float16"), None, False)):
        q, k, v, causal = _flash_case(rng, **shape)
        for t in (q, k, v):
            t.requires_grad_(True)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        do = torch.randn_like(out)
        dlse = torch.randn_like(lse) if with_dlse else None
        grads = torch.autograd.grad(
            (out, lse) if with_dlse else (out,), (q, k, v),
            (do, dlse) if with_dlse else (do,))
        qd, kd, vd = (x.detach() for x in (q, k, v))
        ref_out, ref_lse = fa.flash_attention_reference(qd, kd, vd, causal)
        ref = fa.flash_attention_bwd_reference(
            qd, kd, vd, out.detach(), lse.detach(), do, dlse, causal)
        torch.cuda.synchronize()
        fwd_err = (out.detach().float() - ref_out.float()).abs().max().item()
        lse_err = (lse.detach() - ref_lse).abs().max().item()
        if not (fwd_err <= TOL["flash_attention"] and lse_err <= 1e-2):
            raise AssertionError(f"flash forward {shape}: out err {fwd_err}"
                                 f", lse err {lse_err}")
        errs = {}
        for name, idx in (("flash_attention_bwd_dq", (0,)),
                          ("flash_attention_bwd_dkv", (1, 2))):
            err = max((grads[i].float() - ref[i].float()).abs().max().item()
                      for i in idx)
            scale = max(ref[i].float().abs().max().item() for i in idx)
            ok = bool(np.isfinite(err) and err <= BWD_REL_TOL * scale)
            checks.append({"kernel": name, "shape": shape,
                           "lse_cotangent": with_dlse,
                           "forward_max_abs_err": fwd_err,
                           "max_abs_err": err,
                           "ref_max_abs": scale,
                           "tol": BWD_REL_TOL * scale, "ok": ok})
            if not ok:
                raise AssertionError(f"{name} {shape}: max abs err {err} > "
                                     f"{BWD_REL_TOL} x {scale}")
            errs[name] = err
        if path is None:
            continue
        B, T, H, D = q.shape
        qh, kh, vh, doh = (x.detach().transpose(1, 2) for x in (q, k, v, do))
        oh = out.detach().transpose(1, 2)
        lse_d = lse.detach()
        delta = (doh.float() * oh.float()).sum(-1).contiguous()
        sm = 1.0 / D ** 0.5
        pairs = B * H * T * (T + 1) / 2
        plain_ms = median_ms(lambda: fa.flash_attention_bwd_reference(
            q.detach(), k.detach(), v.detach(), out.detach(), lse_d, do,
            None, True), reps=5, inner=1)
        # the yardstick: SDPA's own backward over one SDPA forward
        sq, sk, sv = (x.contiguous().requires_grad_(True)
                      for x in (qh, kh, vh))
        sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        sdo = doh.contiguous()
        library_ms = median_ms(lambda: torch.autograd.grad(
            sout, (sq, sk, sv), sdo, retain_graph=True))
        tile = B * T * H * D * 2          # one bf16 [B, T, H, D] tensor
        rows = B * H * T * 4              # one fp32 [B, H, T] row vector
        for name, need, flops, nbytes in (
                ("flash_attention_bwd_dq", (True, False), 6 * D * pairs,
                 5 * tile + 2 * rows),         # q k v do -> dq; lse delta
                ("flash_attention_bwd_dkv", (False, True), 8 * D * pairs,
                 6 * tile + 2 * rows)):        # q k v do -> dk dv
            b_ms, b_by = bound(nbytes, flops)
            results[name, path] = dict(
                max_abs_err=errs[name],
                ms=median_ms(lambda: fa._launch_bwd(
                    qh, kh, vh, doh, lse_d, delta, sm, True, *need)),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)
    return results


def _quant_pool_case(rng, B, H, Hkv, hd, bs, nb, g, pos, tables=None):
    """An int8 pool (quantized with the plain version from fp32 normals),
    bf16 q, shuffled block tables (inactive rows: trash block only)."""
    import torch
    from deepspeed_tpu_torch.ops import quant
    N = B * nb + 1 if tables is None else int(np.max(tables)) + 1
    if tables is None:
        tables = rng.permutation(np.arange(1, N)).astype(np.int32)[
            :B * nb].reshape(B, nb)
        tables[np.asarray(pos) == 0] = 0
    pool = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal((N, Hkv, bs, hd)).astype(
            np.float32)).cuda()
        pool[name], pool[name + "_scale"] = quant.quantize_reference(x, g)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    return (q, pool, torch.tensor(np.asarray(tables, np.int32), device="cuda"),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def _quant_kernels(rng, checks):
    """The int8 paged decode and the four quantize / dequantize kernels
    against their plain versions on the card, then timed: the paged decode
    at the quantized serve path's shape (8 slots, bs 512, hd 64, g 64),
    quantize_int8 at its per-step shape (the K/V pool write, 8 slots x 12
    heads of 64), dequantize_int8 and the int4 pair at wte [50304, 768]
    (the LM head's table, dequantized every model step) — each with every
    shape's times under `by_shape`."""
    import torch
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import quant
    results = {}
    for shape, main in (
            (dict(B=8, H=12, Hkv=12, hd=64, bs=512, nb=2, g=64,
                  pos=[150, 0, 400, 640, 1000, 0, 260, 520]), True),
            (dict(B=8, H=12, Hkv=12, hd=64, bs=512, nb=2, g=32,
                  pos=[150, 0, 400, 640, 1000, 0, 260, 520]), False),
            (dict(B=4, H=8, Hkv=4, hd=64, bs=128, nb=3, g=32,
                  pos=[5, 200, 383, 0],
                  tables=[[7, 2, 10], [1, 9, 4], [3, 5, 8], [0, 0, 0]]),
             False),
            (dict(B=6, H=16, Hkv=4, hd=128, bs=16, nb=40, g=32,
                  pos=[0, 15, 16, 333, 639, 100]), False)):
        q, pool, tables, pos = _quant_pool_case(rng, **shape)
        args = (q, pool["k"], pool["v"], pool["k_scale"], pool["v_scale"],
                tables, pos)
        out = da.paged_decode_attention_quant(*args)
        plain = da.paged_decode_attention_quant_reference
        ref = plain(q, pool, tables, pos)
        torch.cuda.synchronize()
        name = "paged_decode_attention_quant"
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        steps = (diff / (QUANT_DECODE_REL * ref.float().abs()
                         + QUANT_DECODE_ATOL)).max().item()
        ok = bool(np.isfinite(err) and err <= TOL[name] and steps <= 1.0)
        label = {k: v for k, v in shape.items() if k not in ("pos", "tables")}
        checks.append({"kernel": name, "shape": label, "max_abs_err": err,
                       "tol": TOL[name], "max_err_over_bf16_step": steps,
                       "ok": ok})
        if not ok:
            raise AssertionError(f"{name} {label}: max abs err {err}, "
                                 f"{steps} of a bf16 step")
        if not main:
            continue
        B, H, hd = q.shape
        Hkv, ng = pool["k"].shape[1], pool["k_scale"].shape[-1]
        live = sum(p + 1 for p in shape["pos"])
        nbytes = 2 * live * Hkv * (hd + 4 * ng) + 2 * B * H * hd * 2 \
            + tables.numel() * 4
        b_ms, b_by = bound(nbytes, 4 * live * H * hd, FP32_FLOPS)
        results[name, "quant_serve"] = dict(
            shape=label, max_abs_err=err,
            ms=median_ms(lambda: da.paged_decode_attention_quant(*args)),
            plain_ms=median_ms(lambda: plain(q, pool, tables, pos)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # quantize / dequantize: bit-exact, payload and scales
    timed = {}
    for (rows, D), g, dtype, label in (
            ((96, 64), 64, torch.bfloat16, "kv_write"),
            ((96, 64), 32, torch.float16, None),
            ((50304, 768), 64, torch.bfloat16, "wte"),
            ((768, 3072), 64, torch.bfloat16, "mlp_up_w"),
            ((40, 14), 7, torch.float32, None)):    # a byte spans two groups
        x = torch.from_numpy(rng.standard_normal((rows, D)).astype(
            np.float32)).to("cuda", dtype)
        for bits in (8, 4):
            qk, sk = (quant.quantize_int8 if bits == 8
                      else quant.quantize_int4)(x, g)
            qr, sr = quant.quantize_reference(x, g, bits)
            dk = (quant.dequantize_int8 if bits == 8
                  else quant.dequantize_int4)(qr, sr, dtype, g)
            dr = quant.dequantize_reference(qr, sr, dtype, g, bits)
            torch.cuda.synchronize()
            exact = bool(torch.equal(qk, qr) and torch.equal(sk, sr)
                         and torch.equal(dk, dr))
            checks.append({"kernel": f"quantize/dequantize_int{bits}",
                           "shape": [rows, D], "group": g,
                           "dtype": str(dtype), "bit_exact": exact,
                           "ok": exact})
            if not exact:
                raise AssertionError(f"int{bits} [{rows}, {D}] g {g}: "
                                     f"kernel != plain version")
            if label is None:
                continue
            payload = rows * D * bits // 8
            nbytes = rows * D * x.element_size() + payload + rows * D // g * 4
            b_ms, b_by = bound(nbytes, 4 * rows * D, FP32_FLOPS)
            for name, fn, plain in (
                    (f"quantize_int{bits}",
                     lambda: (quant.quantize_int8 if bits == 8
                              else quant.quantize_int4)(x, g),
                     lambda: quant.quantize_reference(x, g, bits)),
                    (f"dequantize_int{bits}",
                     lambda: (quant.dequantize_int8 if bits == 8
                              else quant.dequantize_int4)(qr, sr, dtype, g),
                     lambda: quant.dequantize_reference(qr, sr, dtype, g,
                                                        bits))):
                timed.setdefault(name, {})[label] = dict(
                    shape=[rows, D], group=g, max_abs_err=0.0,
                    ms=median_ms(fn), plain_ms=median_ms(plain),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # quantize_int8 runs on two paths: the K/V pool write of every model
    # step, and the int8 weights' quantization when the serving engine is
    # built; quantize_int4 only at the int4 engine's build
    for name, path, label in (("quantize_int8", "quant_serve", "kv_write"),
                              ("quantize_int8", "quant_serve_build", "wte"),
                              ("dequantize_int8", "quant_serve", "wte"),
                              ("quantize_int4", "quant_generate_build", "wte"),
                              ("dequantize_int4", "quant_generate", "wte")):
        results[name, path] = dict(timed[name][label],
                                   by_shape=timed[name])
    return results


def _token_sort_kernel(rng, checks):
    """token_sort against its plain version, bit for bit: at the dropless
    path's shape (N 4096 = 8 x 512 tokens, E 8), at E 64 and 128, at
    N 65 536, at an odd N, with every id equal, with ids out of range and
    negative, and from int64 ids; then timed at the path's shape."""
    import torch
    from deepspeed_tpu_torch.ops import token_sort as ts
    results = {}
    cases = (("path", rng.integers(0, 8, 4096), 8),
             ("e64", rng.integers(0, 64, 4096), 64),
             ("e128", rng.integers(0, 128, 4096), 128),
             ("n65536", rng.integers(0, 8, 65536), 8),
             ("odd_n", rng.integers(0, 8, 4097), 8),
             ("all_equal", np.full(4096, 5), 8),
             ("out_of_range", rng.integers(-5, 13, 4096), 8),
             ("int64", rng.integers(0, 8, 3001), 8))
    for label, ids, E in cases:
        dtype = torch.int64 if label == "int64" else torch.int32
        idx = torch.from_numpy(np.asarray(ids)).to("cuda", dtype)
        pos, counts = ts.token_sort(idx, E)
        ref_pos, ref_counts = ts.token_sort_reference(idx, E)
        torch.cuda.synchronize()
        exact = bool(torch.equal(pos, ref_pos)
                     and torch.equal(counts, ref_counts))
        checks.append({"kernel": "token_sort", "case": label,
                       "n": int(idx.numel()), "experts": E,
                       "dtype": str(dtype), "bit_exact": exact, "ok": exact})
        if not exact:
            raise AssertionError(f"token_sort {label}: kernel != plain "
                                 f"version")
        if label != "path":
            continue
        n = idx.numel()
        # ids in, ranks out, counts out; one compare per token and expert
        b_ms, b_by = bound(4 * n + 4 * n + 4 * E, n * E, FP32_FLOPS)
        results["token_sort", "moe_dropless"] = dict(
            shape={"n": n, "experts": E}, max_abs_err=0.0,
            ms=median_ms(lambda: ts.token_sort(idx, E)),
            plain_ms=median_ms(lambda: ts.token_sort_reference(idx, E)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return results


NORM_MAIN = (4096, 768)        # the norms path's shape: [8 x 512, d_model]


def _norm_kernels(rng, checks):
    """fused_layer_norm / fused_rms_norm against their plain versions:
    [4096, 768] bf16 with and without a residual, [4096, 4096] fp16 and a
    ragged [37, 1000] fp32. Tolerance: one step of the output dtype at the
    output's largest |entry| (eps x max|ref|): the statistics are fp32 in
    both versions and only their summation order differs, so the two fp32
    results lie a fraction of an fp32 step apart before the one rounding
    to the output dtype, which can put them one step apart. Then each op
    timed at [4096, 768] bf16 without a residual, with F.layer_norm /
    F.rms_norm as the library call."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import norms
    results = {}

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
    for (rows, D), dtype, residual in ((NORM_MAIN, torch.bfloat16, False),
                                       (NORM_MAIN, torch.bfloat16, True),
                                       ((4096, 4096), torch.float16, True),
                                       ((37, 1000), torch.float32, True)):
        x = randn(rows, D).to(dtype)
        res = randn(rows, D).to(dtype) if residual else None
        scale, bias = 1 + 0.1 * randn(D), 0.1 * randn(D)
        for name, fn, plain, args in (
                ("fused_layer_norm", norms.fused_layer_norm,
                 norms.layer_norm_reference, (x, scale, bias)),
                ("fused_rms_norm", norms.fused_rms_norm,
                 norms.rms_norm_reference, (x, scale))):
            out = fn(*args, residual=res)
            ref = plain(*args, residual=res)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = torch.finfo(dtype).eps * ref.float().abs().max().item()
            ok = bool(np.isfinite(err) and err <= tol and out.dtype == dtype)
            checks.append({"kernel": name, "shape": [rows, D],
                           "dtype": str(dtype), "residual": residual,
                           "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                raise AssertionError(f"{name} [{rows}, {D}] {dtype}: max abs "
                                     f"err {err} > {tol}")
            if (rows, D) != NORM_MAIN or residual:
                continue
            # x in, out out (scale, bias f32); ~8 fp32 operations an element
            nbytes = 2 * rows * D * x.element_size() + 2 * D * 4
            b_ms, b_by = bound(nbytes, 8 * rows * D, FP32_FLOPS)
            s16, b16 = scale.to(dtype), bias.to(dtype)
            if name == "fused_layer_norm":
                lib = lambda: F.layer_norm(x, (D,), s16, b16, 1e-5)
            else:
                lib = (lambda: F.rms_norm(x, (D,), s16, 1e-5)) \
                    if hasattr(F, "rms_norm") else None
            results[name, "norms"] = dict(
                shape=[rows, D], max_abs_err=err,
                ms=median_ms(lambda: fn(*args)),
                plain_ms=median_ms(lambda: plain(*args)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=median_ms(lib) if lib else None)
    return results


def phase_norms(state):
    """The public norm ops as a user calls them, at [4096, 768] bf16
    (LayerNorm after a residual add, RMSNorm without): one launch each,
    finite outputs of x's shape and dtype within one bf16 step of the plain
    versions."""
    import torch
    from deepspeed_tpu_torch.ops import norms
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    rng = np.random.default_rng(6)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16)
    x, res = randn(*NORM_MAIN), randn(*NORM_MAIN)
    scale, bias = randn(NORM_MAIN[1]), randn(NORM_MAIN[1])
    LAUNCHES.clear()
    ln = norms.fused_layer_norm(x, scale, bias, 1e-5, residual=res)
    rms = norms.fused_rms_norm(x, scale, 1e-5)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    _expect("norms", counts, {"fused_layer_norm": 1, "fused_rms_norm": 1})
    errs = {}
    for name, out, ref in (
            ("fused_layer_norm", ln,
             norms.layer_norm_reference(x, scale, bias, 1e-5, res)),
            ("fused_rms_norm", rms, norms.rms_norm_reference(x, scale, 1e-5))):
        if out.shape != x.shape or out.dtype != x.dtype \
                or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: output {out.shape} {out.dtype} "
                                 f"not finite or misshapen")
        errs[name] = (out.float() - ref.float()).abs().max().item()
        tol = torch.finfo(x.dtype).eps * ref.float().abs().max().item()
        if errs[name] > tol:
            raise AssertionError(f"{name}: err {errs[name]} > {tol}")
    emit({"phase": "norms", "shape": list(NORM_MAIN), "dtype": "bfloat16",
          "launches": counts, "max_abs_err": errs})
    return counts


def _expect(path, counts, want):
    """A path's launch counts, exactly."""
    if counts != want:
        raise AssertionError(f"{path} launches {counts} != {want}")


def _ragged_prompts(rng, lens, vocab):
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def phase_generate(state):
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.gpt import (GPT2_CONFIGS,
                                                make_gpt_decode_model)
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    cfg = GPT2_CONFIGS["gpt2-125m"]
    t0 = time.perf_counter()
    spec = make_gpt_decode_model(cfg, name="gpt2-125m", seed=0)
    engine = init_inference(spec, config={
        "dtype": "bfloat16", "kv_cache_dtype": "bfloat16", "greedy": True})
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    lens = [100, 250, 431, 600]
    prompts = _ragged_prompts(rng, lens, cfg.vocab_size)
    new = 32
    engine.generate(prompts, max_new_tokens=2, stop_on_eos=False)  # warm-up

    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new, stop_on_eos=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    L = cfg.n_layer
    if counts.get("flash_attention") != L:
        raise AssertionError(f"flash launches {counts} != {L} per prefill")
    if counts.get("decode_attention") != L * (new - 1):
        raise AssertionError(f"decode launches {counts} != {L} x "
                             f"{new - 1} steps")
    if out.shape != (4, new) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"generate output {out.shape} out of range")

    # logits: bf16 on the card vs the port's fp32 CPU run, same weights and
    # tokens (the CPU side decodes the token the card chose)
    import dataclasses
    cpu_spec = make_gpt_decode_model(
        dataclasses.replace(cfg, dtype=torch.float32), name="gpt2-125m",
        params=spec.params)
    cpu = init_inference(cpu_spec, config={
        "dtype": "float32", "kv_cache_dtype": "float32"}, device="cpu")
    padded, plens = engine._pad_ragged(prompts)
    errs = {}
    with torch.inference_mode():
        logits, cache = engine.forward(padded)
        rows = torch.arange(4, device="cuda")
        last = logits[rows, torch.as_tensor(plens, device="cuda").long() - 1]
        tok = last.argmax(-1).to(torch.int32)
        pos = torch.as_tensor(plens, device="cuda").long()
        dec, _ = spec.decode_fn(engine.params, tok, pos, cache)
        c_logits, c_cache = cpu.forward(padded)
        c_last = c_logits[torch.arange(4), torch.as_tensor(plens).long() - 1]
        c_dec, _ = cpu_spec.decode_fn(cpu.params, tok.cpu(), pos.cpu(),
                                      c_cache)
    for name, a, b in (("prefill", last, c_last), ("decode", dec, c_dec)):
        a = a.float().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} logits not finite")
        errs[name] = (a - b).abs().max().item()
        if errs[name] > LOGIT_TOL:
            raise AssertionError(f"{name} logits err {errs[name]} > "
                                 f"{LOGIT_TOL}")
    emit({"phase": "generate", "model": "gpt2-125m", "dtype": "bfloat16",
          "batch": 4, "prompt_lens": lens, "max_new_tokens": new,
          "setup_s": setup_s, "seconds": dt, "tokens_per_s": 4 * new / dt,
          "launches": counts, "logit_max_abs_err": errs,
          "logit_tol": LOGIT_TOL,
          "logit_ref_std": float(c_last.float().std())})
    state.update(spec=spec, engine=engine, prompts=prompts, generate_s=dt,
                 n_layer=L)
    return counts


def phase_serve(state):
    import torch
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    engine = state["engine"]
    serving = engine.serving(max_slots=8, max_context=1024)
    rng = np.random.default_rng(2)
    lens = rng.integers(100, 601, 16).tolist()
    prompts = _ragged_prompts(rng, lens, 50304)
    new = 32
    serving.run([Request(uid="warm", tokens=prompts[0], max_new_tokens=2,
                         stop_on_eos=False)])
    reqs = [Request(uid=i, tokens=p, max_new_tokens=new, stop_on_eos=False)
            for i, p in enumerate(prompts)]
    engine_layers = state["n_layer"]
    steps0 = serving.stats()["decode_steps"]
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serving.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    if sorted(res) != list(range(16)) or any(
            len(r.tokens) != new or r.finish_reason != "length"
            for r in res.values()):
        raise AssertionError("not every request completed with its budget")
    # every layer of every decode step of this run through the kernel (a
    # decode call runs `window` model steps)
    steps = (serving.stats()["decode_steps"] - steps0) * serving.window
    if steps <= 0 or counts.get("paged_decode_attention") != \
            engine_layers * steps:
        raise AssertionError(f"paged-decode launches {counts} != "
                             f"{engine_layers} x {steps} decode steps")
    if serving.allocator.num_free != serving.allocator.capacity:
        raise AssertionError("blocks leaked after draining")
    # the served tokens against generate() on the same prompts: in bf16 a
    # near-tied argmax may flip between the paged and contiguous paths, so
    # the check is a floor on the share of equal tokens, not identity
    ref = engine.generate(prompts, max_new_tokens=new, stop_on_eos=False)
    agree = float(np.mean([res[i].tokens == ref[i] for i in range(16)]))
    if not agree >= SERVE_AGREE_MIN:
        raise AssertionError(f"served tokens agree with generate() on "
                             f"{agree:.3f} < {SERVE_AGREE_MIN}")
    state.update(serve_prompts=prompts, serve_s=dt)
    emit({"phase": "serve", "requests": 16, "slots": 8, "max_context": 1024,
          "prompt_lens": lens, "max_new_tokens": new, "seconds": dt,
          "requests_per_s": 16 / dt, "tokens_per_s": 16 * new / dt,
          "launches": counts, "token_agreement_with_generate": agree,
          "stats": serving.stats()})
    return counts


def _quantized_leaves(tree, prefix=""):
    """{path: QuantizedTensor} of a weight-only quantized tree."""
    from deepspeed_tpu_torch.inference.quantization import QuantizedTensor
    if isinstance(tree, dict):
        return {n: t for k in sorted(tree)
                for n, t in _quantized_leaves(tree[k], f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree} if isinstance(tree, QuantizedTensor) \
        else {}


def _same_quantized_bytes(card, cpu):
    """Every quantized leaf of the card engine's tree equal, payload and
    scales, to the CPU engine's quantization of the same weights."""
    a, b = _quantized_leaves(card), _quantized_leaves(cpu)
    if sorted(a) != sorted(b):
        raise AssertionError(f"quantized leaf sets differ: {sorted(a)} vs "
                             f"{sorted(b)}")
    bad = [n for n in a if not (torch_equal(a[n].q, b[n].q)
                                and torch_equal(a[n].scale, b[n].scale))]
    if bad:
        raise AssertionError(f"card quantization differs from the CPU's: "
                             f"{bad}")
    return len(a)


def torch_equal(x, y):
    import torch
    return bool(torch.equal(x.cpu(), y.cpu()))


def _dequant_per_step(params, n_layer):
    """dequantize launches of one model step over a quantized tree: each
    quantized block leaf once per layer, wte / wpe rows in the embedding,
    the LM-head table (wte when tied, else lm_head) once."""
    leaves = _quantized_leaves(params)
    block = sum(n.startswith("blocks/") for n in leaves)
    embed = sum(n in leaves for n in ("wte", "wpe"))
    head = int(("lm_head" if "lm_head" in params else "wte") in leaves)
    return n_layer * block + embed + head


def _cpu_twin(cfg, spec, config):
    """The port on the CPU in fp32 from the card engine's bf16-rounded
    weights, with the same config."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.gpt import make_gpt_decode_model
    from deepspeed_tpu_torch.utils.tree import tree_cast
    params = tree_cast(tree_cast(spec.params, torch.bfloat16), torch.float32)
    cpu_spec = make_gpt_decode_model(
        dataclasses.replace(cfg, dtype=torch.float32), name=spec.name,
        params=params)
    return init_inference(cpu_spec, config={
        **config, "dtype": "float32", "kv_cache_dtype": "float32"},
        device="cpu")


def _paged_logits(serving, prompt, token=None):
    """The serving engine's prefill over blocks 1..nb of its (drained)
    pool, chunk by chunk as its scheduler runs it, then one decode step
    over that pool: (logits at the prompt's last token, the decode step's
    logits, the token decoded). The step decodes `token`, or the prefill's
    argmax when it is None."""
    import torch
    spec, dev = serving.engine.model_spec, serving.engine.device
    table = torch.arange(1, serving.nb + 1, dtype=torch.int32,
                         device=dev)[None]
    n = len(prompt)
    with torch.inference_mode():
        for start in range(0, n, serving.chunk):
            chunk = np.zeros((1, serving.chunk), np.int64)
            seg = prompt[start:start + serving.chunk]
            chunk[0, :len(seg)] = seg
            final = start + serving.chunk >= n
            last = n - 1 - start if final else serving.chunk - 1
            logits, serving.pool = spec.prefill_paged_fn(
                serving.engine.params, torch.as_tensor(chunk, device=dev),
                torch.tensor([start], device=dev),
                torch.tensor([last], device=dev), serving.pool, table)
        if token is None:
            token = int(logits[0].argmax())
        dec, serving.pool = spec.decode_paged_fn(
            serving.engine.params,
            torch.tensor([token], dtype=torch.int32, device=dev),
            torch.tensor([n], device=dev), serving.pool, table)
    return logits[0].float().cpu(), dec[0].float().cpu(), token


def phase_quant(state):
    """Quantized serving on gpt2-125m at full width and depth, bf16: (a)
    the int8 KV pool with int8 weights through ServingEngine, (b) int4
    weights through generate(). Four paths, each with its launches counted
    from 0 just before it and read just after: each engine's build (where
    the weights are quantized) and each timed run."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.models.gpt import (GPT2_CONFIGS,
                                                make_gpt_decode_model)
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    cfg = GPT2_CONFIGS["gpt2-125m"]
    L = cfg.n_layer
    spec = state.get("spec") or make_gpt_decode_model(cfg, name="gpt2-125m",
                                                      seed=0)
    base = {"dtype": "bfloat16", "kv_cache_dtype": "bfloat16",
            "greedy": True}
    quantization = {"kv_cache_dtype": "int8", "weights": "int8"}
    out = {"phase": "quant", "model": "gpt2-125m", "dtype": "bfloat16"}
    counts = {}

    def expect(path, want):
        if counts[path] != want:
            raise AssertionError(f"{path} launches {counts[path]} != {want}")

    # --- (a) int8 KV pool + int8 weights through the serving engine
    rng = np.random.default_rng(2)          # the serve phase's trace
    lens = rng.integers(100, 601, 16).tolist()
    prompts = _ragged_prompts(rng, lens, cfg.vocab_size)
    new = 32
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    engine = init_inference(spec, config=base)
    serving = engine.serving(max_slots=8, max_context=1024,
                             quantization=quantization)
    torch.cuda.synchronize()
    counts["quant_serve_build"] = dict(LAUNCHES)
    peak_build = torch.cuda.max_memory_allocated()
    n_q = serving.weight_quant_stats["quantized"]
    expect("quant_serve_build", {"quantize_int8": n_q})
    serving.run([Request(uid="warm", tokens=prompts[0], max_new_tokens=2,
                         stop_on_eos=False)])
    reqs = [Request(uid=i, tokens=p, max_new_tokens=new, stop_on_eos=False)
            for i, p in enumerate(prompts)]
    st0 = serving.stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = serving.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts["quant_serve"] = dict(LAUNCHES)
    peak_run = torch.cuda.max_memory_allocated()
    if sorted(res) != list(range(16)) or any(
            len(r.tokens) != new or r.finish_reason != "length"
            for r in res.values()):
        raise AssertionError("quant serve: not every request completed")
    if serving.allocator.num_free != serving.allocator.capacity:
        raise AssertionError("quant serve: blocks leaked after draining")
    # this run's model steps: prefill chunks, and decode calls of `window`
    # model steps each
    st = serving.stats()
    prefills = st["prefill_chunks"] - st0["prefill_chunks"]
    decodes = (st["decode_steps"] - st0["decode_steps"]) * serving.window
    per_step = _dequant_per_step(engine.params, L)
    want = {"paged_decode_attention_quant": L * decodes,
            "quantize_int8": 2 * L * (prefills + decodes),
            "dequantize_int8": per_step * (prefills + decodes)
            + 2 * L * prefills}
    if prefills <= 0 or decodes <= 0:
        raise AssertionError(f"quant serve ran {prefills} prefill chunks "
                             f"and {decodes} decode steps")
    expect("quant_serve", want)
    ref = engine.generate(prompts, max_new_tokens=new, stop_on_eos=False)
    agree = float(np.mean([res[i].tokens == ref[i] for i in range(16)]))
    if not agree >= QUANT_SERVE_AGREE_MIN:
        raise AssertionError(f"quant serve tokens agree with generate() on "
                             f"{agree:.3f} < {QUANT_SERVE_AGREE_MIN}")
    # the CPU twin: same bf16-rounded weights, quantized to the same bytes;
    # prefill logits of one single-chunk and one two-chunk prompt, then the
    # first decode step over each engine's int8 pool (the card's through
    # the int8 paged-decode kernel) on the token the card chose
    cpu = _cpu_twin(cfg, spec, base)
    cpu_serving = cpu.serving(max_slots=1, max_context=1024,
                              quantization=quantization)
    n_same = _same_quantized_bytes(engine.params, cpu.params)
    errs, ref_std = {"prefill": [], "decode": []}, []
    for prompt in _ragged_prompts(np.random.default_rng(5), [300, 600],
                                  cfg.vocab_size):
        a_pre, a_dec, tok = _paged_logits(serving, prompt)
        b_pre, b_dec, _ = _paged_logits(cpu_serving, prompt, tok)
        for name, a, b in (("prefill", a_pre, b_pre),
                           ("decode", a_dec, b_dec)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"quant serve {name} logits not finite")
            errs[name].append((a - b).abs().max().item())
        ref_std.append(b_pre.std().item())
    if max(max(e) for e in errs.values()) > QUANT_LOGIT_TOL:
        raise AssertionError(f"quant serve logits err {errs} > "
                             f"{QUANT_LOGIT_TOL}")
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in serving.pool.values())
    bf16_pool_bytes = 2 * serving.pool["k"].numel() * 2
    out["serve"] = {
        "quantization": quantization, "requests": 16, "slots": 8,
        "max_context": 1024, "prompt_lens": lens, "max_new_tokens": new,
        "seconds": dt, "requests_per_s": 16 / dt,
        "tokens_per_s": 16 * new / dt, "launches": counts["quant_serve"],
        "launches_expected": want,
        "launch_basis": {"prefill_chunks": prefills,
                         "decode_model_steps": decodes,
                         "dequantize_per_model_step": per_step},
        "build_launches": counts["quant_serve_build"],
        "token_agreement_with_generate": agree,
        "agree_min": QUANT_SERVE_AGREE_MIN,
        "quant_stats": serving.weight_quant_stats,
        "quantized_leaves_equal_to_cpu": n_same,
        "logit_max_abs_err": errs, "logit_tol": QUANT_LOGIT_TOL,
        "logit_ref_std": ref_std,
        "pool_bytes_int8": pool_bytes,
        "pool_bytes_bf16_same_blocks": bf16_pool_bytes,
        "pool_ratio": bf16_pool_bytes / pool_bytes,
        "allocated_before_bytes": mem0, "peak_build_bytes": peak_build,
        "peak_run_bytes": peak_run, "stats": st}
    state.update(quant_serving=serving, quant_prompts=prompts, quant_s=dt)
    del cpu, cpu_serving

    # --- (b) int4 weights through generate()
    qconf = {**base, "quant": {"enabled": True, "bits": 4, "group_size": 64}}
    lens4 = [100, 250, 431, 600]              # the generate phase's prompts
    prompts4 = _ragged_prompts(np.random.default_rng(1), lens4,
                               cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    LAUNCHES.clear()
    eng4 = init_inference(spec, config=qconf)
    torch.cuda.synchronize()
    counts["quant_generate_build"] = dict(LAUNCHES)
    peak4_build = torch.cuda.max_memory_allocated()
    n_q4 = eng4.quant_stats["quantized"]
    expect("quant_generate_build", {"quantize_int4": n_q4})
    eng4.generate(prompts4, max_new_tokens=2, stop_on_eos=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out4 = eng4.generate(prompts4, max_new_tokens=new, stop_on_eos=False)
    torch.cuda.synchronize()
    dt4 = time.perf_counter() - t0
    counts["quant_generate"] = dict(LAUNCHES)
    peak4_run = torch.cuda.max_memory_allocated()
    # one prefill and new - 1 decode steps, each a model step
    want4 = {"flash_attention": L, "decode_attention": L * (new - 1),
             "dequantize_int4": _dequant_per_step(eng4.params, L) * new}
    expect("quant_generate", want4)
    if out4.shape != (4, new) or out4.min() < 0 \
            or out4.max() >= cfg.vocab_size:
        raise AssertionError(f"int4 generate output {out4.shape} out of "
                             f"range")
    cpu4 = _cpu_twin(cfg, spec, qconf)
    n_same4 = _same_quantized_bytes(eng4.params, cpu4.params)
    padded, plens = eng4._pad_ragged(prompts4)
    errs4 = {}
    with torch.inference_mode():
        logits, cache = eng4.forward(padded)
        last = logits[torch.arange(4, device="cuda"),
                      torch.as_tensor(plens, device="cuda").long() - 1]
        tok = last.argmax(-1).to(torch.int32)
        pos = torch.as_tensor(plens, device="cuda").long()
        dec, _ = eng4.model_spec.decode_fn(eng4.params, tok, pos, cache)
        c_logits, c_cache = cpu4.forward(padded)
        c_last = c_logits[torch.arange(4), torch.as_tensor(plens).long() - 1]
        c_dec, _ = cpu4.model_spec.decode_fn(cpu4.params, tok.cpu(),
                                             pos.cpu(), c_cache)
    for name, a, b in (("prefill", last, c_last), ("decode", dec, c_dec)):
        a = a.float().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"int4 {name} logits not finite")
        errs4[name] = (a - b).abs().max().item()
    if max(errs4.values()) > QUANT_LOGIT_TOL:
        raise AssertionError(f"int4 generate logits err {errs4} > "
                             f"{QUANT_LOGIT_TOL}")
    out["generate_int4"] = {
        "batch": 4, "prompt_lens": lens4, "max_new_tokens": new,
        "seconds": dt4, "tokens_per_s": 4 * new / dt4,
        "launches": counts["quant_generate"], "launches_expected": want4,
        "build_launches": counts["quant_generate_build"],
        "quant_stats": eng4.quant_stats,
        "quantized_leaves_equal_to_cpu": n_same4,
        "logit_max_abs_err": errs4, "logit_tol": QUANT_LOGIT_TOL,
        "logit_ref_std": float(c_last.float().std()),
        "allocated_before_bytes": mem0, "peak_build_bytes": peak4_build,
        "peak_run_bytes": peak4_run}
    emit(out)
    return counts


def phase_train(state):
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS, make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    cfg = GPT2_CONFIGS[TRAIN_MODEL]       # remat nothing_saveable: default
    t0 = time.perf_counter()
    engine, *_ = initialize(model=make_gpt_model(cfg, name=TRAIN_MODEL,
                                                 seed=0),
                            config=TRAIN_CONFIG)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_MBS * TRAIN_GAS, TRAIN_SEQ + 1))).cuda()}
    losses = [float(engine.train_batch(batch))]             # warm-up

    LAUNCHES.clear()
    step_s, overflow = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch))  # the read waits for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        overflow.append(bool(engine._last_metrics["overflow"]))
    counts = dict(LAUNCHES)
    L = cfg.n_layer
    want = {"flash_attention": 2 * L * TRAIN_GAS * TRAIN_STEPS,
            "flash_attention_bwd_dq": L * TRAIN_GAS * TRAIN_STEPS,
            "flash_attention_bwd_dkv": L * TRAIN_GAS * TRAIN_STEPS}
    if counts != want:
        raise AssertionError(f"train launches {counts} != {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    if any(overflow):
        raise AssertionError(f"overflow in a timed step: {overflow}")
    n_params = tree_num_params(engine.state.params)
    sec = statistics.median(step_s)
    tokens_per_s = TRAIN_MBS * TRAIN_GAS * TRAIN_SEQ / sec
    parity = _train_parity(cfg)
    emit({"phase": "train", "model": TRAIN_MODEL, "n_layer": L,
          "n_params": n_params, "config": TRAIN_CONFIG, "seq": TRAIN_SEQ,
          "remat": cfg.remat_policy if cfg.remat else None,
          "setup_s": setup_s, "losses": losses, "step_s": step_s,
          "seconds_per_step": sec, "tokens_per_s": tokens_per_s,
          "mfu": 6 * n_params * tokens_per_s / BF16_FLOPS,
          "mfu_basis": "6 x params x tokens/s over 989e12 flop/s, the H100 "
                       "SXM dense bf16 peak from NVIDIA's data sheet",
          "launches": counts, "parity": parity})
    state.update(train_engine=engine, train_batch=batch, train_s=sec)
    return counts


def _train_parity(cfg):
    """The first step's loss and every parameter's gradient at 2 layers of
    the training model, B 2, T 512: the engine on the card in bf16 against
    the engine on the CPU in fp32, from the same (bf16-rounded) weights and
    batch."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import init_gpt_params, make_gpt_model
    from deepspeed_tpu_torch.utils.tree import tree_cast, tree_leaves
    small = dataclasses.replace(cfg, n_layer=2)
    params = tree_cast(tree_cast(init_gpt_params(small, seed=1),
                                 torch.bfloat16), torch.float32)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, TRAIN_SEQ + 1))
    config = {**TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 1}
    name = f"{TRAIN_MODEL}-2-layers"
    card, *_ = initialize(model=make_gpt_model(small, name=name,
                                               params=params), config=config)
    cpu, *_ = initialize(
        model=make_gpt_model(dataclasses.replace(small, dtype=torch.float32),
                             name=name, params=params),
        config={**config, "bf16": {"enabled": False}}, device="cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    g_card, l_card, _ = card._grads(card.state.params, batch)
    g_cpu, l_cpu, _ = cpu._grads(cpu.state.params, batch)
    loss_err = abs(float(l_card) - float(l_cpu))
    rel = {}
    names = _leaf_names(g_cpu)
    for name, a, b in zip(names, tree_leaves(g_card), tree_leaves(g_cpu)):
        a = a.float().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"gradient {name} not finite on the card")
        rel[name] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    worst = max(rel, key=rel.get)
    if not loss_err <= TRAIN_LOSS_TOL or rel[worst] > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"train parity: loss err {loss_err} (tol "
                             f"{TRAIN_LOSS_TOL}), worst gradient {worst} "
                             f"{rel[worst]} (tol {TRAIN_GRAD_REL_TOL})")
    return {"n_layer": 2, "batch": 2, "seq": TRAIN_SEQ,
            "loss_card": float(l_card), "loss_cpu": float(l_cpu),
            "loss_abs_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
            "grad_rel_err": rel, "grad_rel_tol": TRAIN_GRAD_REL_TOL}


def _leaf_names(tree, prefix=""):
    """Leaf paths in `tree_leaves` order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


class RouteRecorder:
    """Records each MoE layer's top-1 choice while a `with` block runs, by
    wrapping the port's routing functions from this script
    (`models/moe_gpt.py`'s `top1_gating` and `_nodrop_gates`): every call
    appends its tokens' expert ids (-1 where the capacity dropped the
    token). The wrappers return what the originals return."""

    def __enter__(self):
        import torch
        from deepspeed_tpu_torch.models import moe_gpt
        self.calls = []
        self._saved = (moe_gpt.top1_gating, moe_gpt._nodrop_gates)
        top1, nodrop = self._saved

        def top1_gating(*args, **kwargs):
            out = top1(*args, **kwargs)
            kept = out[1].any(dim=-1)                          # [N, E]
            self.calls.append(torch.where(
                kept.any(dim=-1), kept.int().argmax(dim=-1), -1).cpu())
            return out

        def nodrop_gates(xf, gate_w):
            probs, top = nodrop(xf, gate_w)
            self.calls.append(top.cpu())
            return probs, top

        moe_gpt.top1_gating, moe_gpt._nodrop_gates = top1_gating, nodrop_gates
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.models import moe_gpt
        moe_gpt.top1_gating, moe_gpt._nodrop_gates = self._saved


def _routes_alike(card, cpu):
    """Per routing call, [N] bool: the card's route equals the CPU twin's."""
    if len(card) != len(cpu) or any(a.shape != b.shape
                                    for a, b in zip(card, cpu)):
        raise AssertionError(f"routing calls differ: {len(card)} vs "
                             f"{len(cpu)}")
    return [a.long() == b.long() for a, b in zip(card, cpu)]


def _check_route_share(what, shares):
    if min(shares) < ROUTE_AGREE_MIN:
        raise AssertionError(f"{what}: routes alike {shares} below "
                             f"{ROUTE_AGREE_MIN}")


def _moe_cfg(**over):
    from deepspeed_tpu_torch.models.moe_gpt import MoEGPTConfig
    return MoEGPTConfig(**{**MOE_CFG, **over})


def _bf16_rounded(params):
    import torch
    from deepspeed_tpu_torch.utils.tree import tree_cast
    return tree_cast(tree_cast(params, torch.bfloat16), torch.float32)


def phase_moe(state):
    """MoE-GPT (moe-gpt-125m-e8) at full width and depth, bf16, random
    weights from a numpy seed: (a) training, (b) generate(), (c) the
    serving engine, then (d) the dropless MoE layer. Each path's launches
    are counted from 0 just before it and read just after."""
    counts = {}
    out = {"phase": "moe", "model": MOE_MODEL, "config": MOE_CFG,
           "route_agree_min": ROUTE_AGREE_MIN}
    out["train"] = _moe_train(state, counts)
    out["generate"] = _moe_generate(state, counts)
    out["serve"] = _moe_serve(state, counts)
    out["dropless"] = _moe_dropless(counts)
    emit(out)
    return counts


def _moe_train(state, counts):
    """initialize(make_moe_gpt_model) -> train_batch: one warm-up step, then
    MOE_STEPS timed steps on one batch; then the 2-layer parity run."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.moe_gpt import make_moe_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    cfg = _moe_cfg()
    t0 = time.perf_counter()
    engine, *_ = initialize(model=make_moe_gpt_model(cfg, name=MOE_MODEL,
                                                     seed=0),
                            config=MOE_TRAIN_CONFIG)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MOE_MBS * MOE_GAS, MOE_SEQ + 1))).cuda()}
    def moe_metrics():
        return {k: float(v) for k, v in engine._last_metrics.items()
                if k.startswith("moe/")}
    losses = [float(engine.train_batch(batch))]             # warm-up
    metrics = [moe_metrics()]
    LAUNCHES.clear()
    step_s = []
    for _ in range(MOE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch))  # the read waits for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        metrics.append(moe_metrics())
    counts["moe_train"] = dict(LAUNCHES)
    n = cfg.n_layer * MOE_GAS * MOE_STEPS    # no remat: one forward a layer
    _expect("moe_train", counts["moe_train"],
            {"flash_attention": n, "flash_attention_bwd_dq": n,
             "flash_attention_bwd_dkv": n})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe train losses not finite and falling: "
                             f"{losses}")
    keys = ("moe/aux_loss", "moe/overflow_tokens", "moe/dropped_frac")
    for m in metrics:
        if sorted(m) != sorted(keys) or not all(np.isfinite(list(m.values()))) \
                or not 0 <= m["moe/dropped_frac"] <= 1 \
                or not m["moe/aux_loss"] > 0:
            raise AssertionError(f"moe train metrics {m}")
    n_params = tree_num_params(engine.state.params)
    # top-1 routing activates one expert FFN per token: the active
    # parameters are the dense gpt2-125m's (bench.py's MoE lane counts its
    # dense twin)
    n_active = n_params - tree_num_params(engine.state.params["moe"])
    sec = statistics.median(step_s)
    tokens_per_s = MOE_MBS * MOE_GAS * MOE_SEQ / sec
    state.update(moe_train_engine=engine, moe_train_batch=batch,
                 moe_train_s=sec)
    dense_sec = _dense_twin_step_s(cfg, batch)
    return {"n_layer": cfg.n_layer, "n_params": n_params,
            "n_active_params": n_active, "config": MOE_TRAIN_CONFIG,
            "seq": MOE_SEQ, "setup_s": setup_s, "losses": losses,
            "metrics": metrics, "step_s": step_s, "seconds_per_step": sec,
            "tokens_per_s": tokens_per_s,
            "mfu_active": 6 * n_active * tokens_per_s / BF16_FLOPS,
            "mfu_basis": "6 x active params x tokens/s over 989e12 flop/s",
            "dense_twin_seconds_per_step": dense_sec,
            "step_vs_dense_twin": sec / dense_sec,
            "launches": counts["moe_train"],
            "parity": _moe_train_parity(cfg)}


def _dense_twin_step_s(cfg, batch):
    """Median seconds per step of the dense gpt2-125m (the same GPTConfig,
    no remat, as the MoE forward runs none) under the same engine config
    and batch: bench.py's MoE lane's iso-FLOPs baseline."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import GPTConfig, make_gpt_model
    dense_cfg = GPTConfig(**{**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(GPTConfig)},
                             "remat": False})
    engine, *_ = initialize(model=make_gpt_model(dense_cfg, name="gpt2-125m",
                                                 seed=0),
                            config=MOE_TRAIN_CONFIG)
    float(engine.train_batch(batch))                        # warm-up
    times = []
    for _ in range(MOE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(engine.train_batch(batch))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _moe_train_parity(cfg):
    """The first step's loss and every gradient at 2 layers (layer 1 is
    MoE), B 2, T 512: the engine on the card in bf16 against the engine on
    the CPU in fp32 from the same bf16-rounded weights. A first pass
    records each token's route on both sides; the tokens routed otherwise
    get the label -100, and the loss and gradients of a second pass are
    held to the train phase's tolerances over the rest."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.moe_gpt import (init_moe_gpt_params,
                                                    make_moe_gpt_model)
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    small = dataclasses.replace(cfg, n_layer=2)
    params = _bf16_rounded(init_moe_gpt_params(small, seed=1))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, MOE_SEQ + 1))
    config = {**MOE_TRAIN_CONFIG, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 1}
    name = f"{MOE_MODEL}-2-layers"
    card, *_ = initialize(model=make_moe_gpt_model(small, name=name,
                                                   params=params),
                          config=config)
    cpu, *_ = initialize(
        model=make_moe_gpt_model(dataclasses.replace(small,
                                                     dtype=torch.float32),
                                 name=name, params=params),
        config={**config, "bf16": {"enabled": False}}, device="cpu")
    routes = {}
    for key, eng in (("card", card), ("cpu", cpu)):
        with RouteRecorder() as rec:
            eng._grads(eng.state.params, {"tokens": torch.from_numpy(toks)})
        routes[key] = rec.calls
    same = torch.stack(_routes_alike(routes["card"], routes["cpu"]))
    shares = same.float().mean(dim=1).tolist()
    _check_route_share("moe train parity", shares)
    agree = same.all(dim=0).reshape(2, MOE_SEQ).numpy()
    labels = toks[:, 1:].copy()
    labels[~agree] = -100
    batch = {"input_ids": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(labels)}
    res = {}
    for key, eng in (("card", card), ("cpu", cpu)):
        with RouteRecorder() as rec:
            res[key] = eng._grads(eng.state.params, batch)
        if not all(bool(a.all()) for a in _routes_alike(rec.calls,
                                                        routes[key])):
            raise AssertionError(f"moe train parity: {key} routes changed "
                                 f"between two passes")
    (g_card, l_card, _), (g_cpu, l_cpu, _) = res["card"], res["cpu"]
    loss_err = abs(float(l_card) - float(l_cpu))
    rel = {}
    for leaf, a, b in zip(_leaf_names(g_cpu), tree_leaves(g_card),
                          tree_leaves(g_cpu)):
        a = a.float().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"moe gradient {leaf} not finite on the "
                                 f"card")
        rel[leaf] = 0.0 if b.norm() == 0 and a.norm() == 0 else \
            ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    worst = max(rel, key=rel.get)
    if not loss_err <= TRAIN_LOSS_TOL or rel[worst] > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"moe train parity: loss err {loss_err} (tol "
                             f"{TRAIN_LOSS_TOL}), worst gradient {worst} "
                             f"{rel[worst]} (tol {TRAIN_GRAD_REL_TOL})")
    return {"n_layer": 2, "batch": 2, "seq": MOE_SEQ,
            "routes_alike_per_layer": shares,
            "rows_routed_otherwise": int((~agree).sum()),
            "loss_card": float(l_card), "loss_cpu": float(l_cpu),
            "loss_abs_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
            "grad_rel_err": rel, "grad_rel_tol": TRAIN_GRAD_REL_TOL}


def _moe_generate(state, counts):
    """init_inference(make_moe_gpt_decode_model) -> generate() on the
    generate phase's prompts; then prefill and first-decode logits against
    the CPU twin on the rows whose routes agree in every MoE layer."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.moe_gpt import make_moe_gpt_decode_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    cfg = _moe_cfg()
    L = cfg.n_layer
    t0 = time.perf_counter()
    spec = make_moe_gpt_decode_model(cfg, name=MOE_MODEL, seed=0)
    engine = init_inference(spec, config={
        "dtype": "bfloat16", "kv_cache_dtype": "bfloat16", "greedy": True})
    setup_s = time.perf_counter() - t0
    lens = [100, 250, 431, 600]
    prompts = _ragged_prompts(np.random.default_rng(1), lens, cfg.vocab_size)
    new = 32
    engine.generate(prompts, max_new_tokens=2, stop_on_eos=False)  # warm-up
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new, stop_on_eos=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts["moe_generate"] = dict(LAUNCHES)
    _expect("moe_generate", counts["moe_generate"],
            {"flash_attention": L, "decode_attention": L * (new - 1)})
    if out.shape != (4, new) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"moe generate output {out.shape} out of range")

    cpu_spec = make_moe_gpt_decode_model(
        dataclasses.replace(cfg, dtype=torch.float32), name=MOE_MODEL,
        params=_bf16_rounded(spec.params))
    cpu = init_inference(cpu_spec, config={
        "dtype": "float32", "kv_cache_dtype": "float32"}, device="cpu")
    padded, plens = engine._pad_ragged(prompts)
    last_idx = torch.as_tensor(plens).long() - 1
    with torch.inference_mode():
        with RouteRecorder() as rc:
            logits, cache = engine.forward(padded)
            last = logits[torch.arange(4, device="cuda"), last_idx.cuda()]
            tok = last.argmax(-1).to(torch.int32)
            pos = torch.as_tensor(plens, device="cuda").long()
            dec, _ = spec.decode_fn(engine.params, tok, pos, cache)
        with RouteRecorder() as rp:
            c_logits, c_cache = cpu.forward(padded)
            c_last = c_logits[torch.arange(4), last_idx]
            c_dec, _ = cpu_spec.decode_fn(cpu.params, tok.cpu(), pos.cpu(),
                                          c_cache)
    n_moe = len(cfg.moe_layer_ids())
    T = padded.shape[1]
    same = _routes_alike(rc.calls, rp.calls)
    pre = torch.stack(same[:n_moe]).reshape(n_moe, 4, T)  # prefill tokens
    dcd = torch.stack(same[n_moe:])                       # [n_moe, 4]
    valid = torch.arange(T)[None, :] < torch.as_tensor(plens)[:, None]
    shares = [((pre[l][valid].sum() + dcd[l].sum()).item()
               / (int(valid.sum()) + 4)) for l in range(n_moe)]
    _check_route_share("moe generate", shares)
    rows = {"prefill": pre[:, torch.arange(4), last_idx].all(dim=0),
            "decode": dcd.all(dim=0)}
    errs = {}
    for name, a, b in (("prefill", last, c_last), ("decode", dec, c_dec)):
        a = a.float().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"moe {name} logits not finite")
        keep = rows[name]
        if not keep.any():
            raise AssertionError(f"moe {name}: no row routed alike in every "
                                 f"layer")
        errs[name] = (a[keep] - b[keep]).abs().max().item()
        if errs[name] > LOGIT_TOL:
            raise AssertionError(f"moe {name} logits err {errs[name]} > "
                                 f"{LOGIT_TOL}")
    state.update(moe_engine=engine, moe_prompts=prompts, moe_generate_s=dt)
    return {"batch": 4, "prompt_lens": lens, "max_new_tokens": new,
            "setup_s": setup_s, "seconds": dt, "tokens_per_s": 4 * new / dt,
            "launches": counts["moe_generate"],
            "routes_alike_per_layer": shares,
            "rows_compared": {k: int(v.sum()) for k, v in rows.items()},
            "rows_routed_otherwise": {k: int((~v).sum())
                                      for k, v in rows.items()},
            "logit_max_abs_err": errs, "logit_tol": LOGIT_TOL,
            "logit_ref_std": float(c_last.float().std())}


def _moe_serve(state, counts):
    """ServingEngine on (b)'s engine with the serve phase's trace."""
    import torch
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    engine = state["moe_engine"]
    cfg = _moe_cfg()
    L = cfg.n_layer
    serving = engine.serving(max_slots=8, max_context=1024)
    rng = np.random.default_rng(2)
    lens = rng.integers(100, 601, 16).tolist()
    prompts = _ragged_prompts(rng, lens, cfg.vocab_size)
    new = 32
    serving.run([Request(uid="warm", tokens=prompts[0], max_new_tokens=2,
                         stop_on_eos=False)])
    reqs = [Request(uid=i, tokens=p, max_new_tokens=new, stop_on_eos=False)
            for i, p in enumerate(prompts)]
    steps0 = serving.stats()["decode_steps"]
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serving.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts["moe_serve"] = dict(LAUNCHES)
    if sorted(res) != list(range(16)) or any(
            len(r.tokens) != new or r.finish_reason != "length"
            for r in res.values()):
        raise AssertionError("moe serve: not every request completed")
    steps = (serving.stats()["decode_steps"] - steps0) * serving.window
    if steps <= 0:
        raise AssertionError("moe serve ran no decode step")
    _expect("moe_serve", counts["moe_serve"],
            {"paged_decode_attention": L * steps})
    if serving.allocator.num_free != serving.allocator.capacity:
        raise AssertionError("moe serve: blocks leaked after draining")
    ref = engine.generate(prompts, max_new_tokens=new, stop_on_eos=False)
    agree = float(np.mean([res[i].tokens == ref[i] for i in range(16)]))
    if not agree >= SERVE_AGREE_MIN:
        raise AssertionError(f"moe served tokens agree with generate() on "
                             f"{agree:.3f} < {SERVE_AGREE_MIN}")
    state.update(moe_serve_prompts=prompts, moe_serve_s=dt)
    return {"requests": 16, "slots": 8, "max_context": 1024,
            "prompt_lens": lens, "max_new_tokens": new, "seconds": dt,
            "requests_per_s": 16 / dt, "tokens_per_s": 16 * new / dt,
            "launches": counts["moe_serve"], "decode_model_steps": steps,
            "token_agreement_with_generate": agree,
            "agree_min": SERVE_AGREE_MIN, "stats": serving.stats()}


def _moe_dropless(counts):
    """moe.layer.MoE(hidden_size=768, num_experts=8, drop_tokens=False),
    d_ff 3072, bf16, on x [8, 512, 768]: forward and backward of
    mean(y^2) + 0.01 l_aux, through the token-sort kernel."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.moe.layer import MoE
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.parallel import moe as pmoe
    D, F_, E = 768, 3072, 8
    N = MOE_MBS * MOE_SEQ
    layer = MoE(hidden_size=D, num_experts=E, drop_tokens=False)
    params = {k: v.cuda().requires_grad_(True) for k, v in
              layer.init_params(d_ff=F_, seed=0, dtype=torch.bfloat16).items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (MOE_MBS, MOE_SEQ, D)).astype(np.float32)).to(
            "cuda", torch.bfloat16).requires_grad_(True)

    def step():
        y, l_aux, exp_counts = layer(params, x)
        loss = y.float().square().mean() + 0.01 * l_aux
        return y, exp_counts, torch.autograd.grad(loss, [x, *params.values()])

    step()                                               # warm-up
    sorts, sort = [], pmoe.token_sort

    def recorded_sort(idx, n_experts):
        out = sort(idx, n_experts)
        sorts.append((idx, *out))
        return out

    pmoe.token_sort = recorded_sort
    try:
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, exp_counts, grads = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts["moe_dropless"] = dict(LAUNCHES)
    finally:
        pmoe.token_sort = sort
    _expect("moe_dropless", counts["moe_dropless"], {"token_sort": 1})
    idx, pos, sort_counts = sorts[0]
    if int(sort_counts.sum()) != N or int(exp_counts.sum()) != N:
        raise AssertionError(f"dropless counts {sort_counts.tolist()} do not "
                             f"sum to {N}")
    if torch.unique(idx.long() * N + pos.long()).numel() != N:
        raise AssertionError("dropless (expert, pos) pairs are not unique")
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("dropless gradients not finite")
    # the oracle: each token through its own expert's weights, in fp32 from
    # the same bf16 inputs (tests/test_moe.py:130-155)
    with torch.no_grad():
        flat = x.reshape(N, D)
        gates = torch.softmax(flat.float() @ params["gate_w"].float(), dim=-1)
        e = gates.argmax(dim=-1)
        if not torch.equal(e, idx.long()):
            raise AssertionError("the oracle routes otherwise than the layer")
        ref = torch.empty(N, D, device="cuda")
        for j in range(E):
            rows = e == j
            h = F.gelu(flat[rows].float() @ params["wi"][j].float()
                       + params["wi_b"][j].float(), approximate="tanh")
            ref[rows] = h @ params["wo"][j].float() + params["wo_b"][j].float()
        ref = ref * gates.gather(-1, e[:, None])
        err = (y.reshape(N, D).float() - ref).abs().max().item()
        tol = DROPLESS_REL_TOL * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"dropless layer vs argmax oracle: {err} > {tol}")
    return {"shape": [MOE_MBS, MOE_SEQ, D], "d_ff": F_, "experts": E,
            "launches": counts["moe_dropless"],
            "expert_counts": sort_counts.tolist(), "max_abs_err": err,
            "tol": tol, "fwd_bwd_first_s": dt,
            "fwd_bwd_ms": median_ms(step, reps=5, inner=1)}


def _device_breakdown(prof, wall_s):
    """Kernel time on the card by class, from a torch.profiler run, against
    the unprofiled wall time of the same work."""
    classes = {"attention (ours)": 0.0, "quant (ours)": 0.0,
               "token sort, norms (ours)": 0.0, "matmul": 0.0,
               "optimizer (foreach)": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0 or ev.device_type.name != "CUDA":
            continue
        name = ev.key
        if any(k in name for k in ("decode_attn_kernel", "flash_fwd_kernel",
                                   "flash_bwd_")):
            cls = "attention (ours)"
        elif "quantize_kernel" in name:
            cls = "quant (ours)"
        elif any(k in name for k in ("token_sort_kernel", "norm_kernel")):
            cls = "token sort, norms (ours)"
        elif any(t in name.lower() for t in ("gemm", "xmma", "cutlass",
                                              "nvjet")):
            cls = "matmul"
        elif "multi_tensor_apply" in name:
            cls = "optimizer (foreach)"
        else:
            cls = "other"
        classes[cls] += us / 1e3
        top.append((us / 1e3, ev.count, name[:80]))
    busy = sum(classes.values())
    top.sort(reverse=True)
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall_s * 1e3),
            "by_class_ms": classes,
            "top_kernels": [{"ms": t, "calls": c, "name": n}
                            for t, c, n in top[:8]]}


def phase_profile(state):
    """torch.profiler over one generate() call and one serving run at the
    generate/serve phases' shapes, one quantized serving run at the quant
    phase's, and one train_batch at the train phase's, for the phases
    that ran (opt-in: `python chip_smoke.py
    build,generate,serve,quant,train,profile`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference.scheduler import Request
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"phase": "profile"}
    if "engine" in state:
        engine = state["engine"]
        with profile(activities=acts) as prof:
            engine.generate(state["prompts"], max_new_tokens=32,
                            stop_on_eos=False)
            torch.cuda.synchronize()
        out["generate"] = _device_breakdown(prof, state["generate_s"])
    if "serve_prompts" in state:
        serving = state["engine"].serving(max_slots=8, max_context=1024)
        with profile(activities=acts) as prof:
            serving.run([Request(uid=i, tokens=p, max_new_tokens=32,
                                 stop_on_eos=False)
                         for i, p in enumerate(state["serve_prompts"])])
            torch.cuda.synchronize()
        out["serve"] = _device_breakdown(prof, state["serve_s"])
    if "quant_serving" in state:
        with profile(activities=acts) as prof:
            state["quant_serving"].run(
                [Request(uid=i, tokens=p, max_new_tokens=32,
                         stop_on_eos=False)
                 for i, p in enumerate(state["quant_prompts"])])
            torch.cuda.synchronize()
        out["quant_serve"] = _device_breakdown(prof, state["quant_s"])
    if "train_engine" in state:
        with profile(activities=acts) as prof:
            float(state["train_engine"].train_batch(state["train_batch"]))
        out["train"] = _device_breakdown(prof, state["train_s"])
    if "moe_train_engine" in state:
        with profile(activities=acts) as prof:
            float(state["moe_train_engine"].train_batch(
                state["moe_train_batch"]))
        out["moe_train"] = _device_breakdown(prof, state["moe_train_s"])
    if "moe_serve_prompts" in state:
        serving = state["moe_engine"].serving(max_slots=8, max_context=1024)
        with profile(activities=acts) as prof:
            serving.run([Request(uid=i, tokens=p, max_new_tokens=32,
                                 stop_on_eos=False)
                         for i, p in enumerate(state["moe_serve_prompts"])])
            torch.cuda.synchronize()
        out["moe_serve"] = _device_breakdown(prof, state["moe_serve_s"])
    emit(out)


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    phases = sys.argv[1].split(",") if len(sys.argv) > 1 else \
        ["build", "kernels", "norms", "generate", "serve", "quant", "train",
         "moe"]
    dev = phase_device()
    state, launches, kern = {}, {}, {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kern = phase_kernels()
    for phase, run in (("norms", phase_norms),
                       ("generate", phase_generate), ("serve", phase_serve),
                       ("quant", phase_quant), ("train", phase_train),
                       ("moe", phase_moe)):
        if phase in phases:
            counts = run(state)        # counts of each path's run; the
            # quant and moe phases run four paths each and return
            # {path: counts}
            launches.update(counts if phase in ("quant", "moe")
                            else {phase: counts})
    if "profile" in phases:
        phase_profile(state)
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": [
        {"name": name, "path": path, "route": "cuda",
         "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches.get(path, {}).get(name, 0), **row}
        for (name, path), row in kern.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
