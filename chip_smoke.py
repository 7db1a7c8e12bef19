#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deepspeed_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py            # every phase; exit 0 only if all pass

Phases, one JSON line each:
  device   the card (nvidia-smi name + power limit); fails without CUDA;
  build    nvcc builds every kernel source in ops/csrc/, all in parallel;
  kernels  each kernel against its plain PyTorch version on the card at the
           shapes its paths give it (generate/serve: gpt2-125m, H=12,
           hd=64, bf16; train: gpt2-760m, B 12, T 512, H 12, hd 128,
           causal; north_star: gpt2-1.3b, B 4, T 512, H 16, hd 128,
           causal); the flash forward also at T 16, 48, 200, 333 and 1000
           (shorter than a tile, ragged against the 64-row tiles), GQA 4,
           fp16, causal and full, q/k/v as views of one [B, T, 3, H, D]
           tensor; the backward kernels
           also at hd 64, GQA 4 with ragged T and an lse cotangent,
           non-causal, in fp16, at T 16, 48 and 1000, MQA (16 query heads
           over one kv head), B * H above 65 535, within 2e-2 of max|ref|
           and row by row
           (the block-sparse measure), with two planted faults (a plain
           backward missing one tile) that the row measure must see, and
           the pair timed against SDPA's backward eagerly, in turns and as
           device time alone (torch.profiler), with SDPA's backend; the
           int8 paged decode at the serve
           shape with groups 64 and 32, on a shuffled table with an
           all-trash row and at hd 128 / GQA 4 (one bf16 step of each
           element, and 1e-2); both paged decodes (split into chunks of
           positions) also at PAGED_EDGE_CASES / QUANT_PAGED_EDGE_CASES
           (chunk edges, full capacity and past it, trash-only rows, 16-
           and 48-row blocks, a table naming blocks in two rows, GQA 4, 8
           and 16, hd 128, fp16, fp32, g 8 to 128, a row of 64 chunks)
           and Llama-3-8B's attention
           at position 4095, with two planted faults each (the combine
           skipping a row's last live chunk, one chunk's partial stale
           from the previous call) that the check must reject, timed as
           CUDA-graph device time (inputs rotated past L2) and host time a
           call at the serve and long-context shapes; the contiguous
           decode (the same split kernel with no table) also at
           DECODE_EDGE_CASES (chunk edges, pos 0, M - 1 and past M, M 1000
           and 77, G 1 / 4 / 8 / 16, hd 128, fp16, fp32, a 4095-position
           row) and Llama-3-8B's attention over a 4096-row cache, with the
           same two planted faults, and as device time beside SDPA's and
           at the long shape; the int8 pool write (one launch a layer for
           K and V) bit-exact against the plain sequence (quantize, then
           the index writes) on every block but the trash block at
           KV_WRITE_CASES (g 4 to 128, hd 64 and 128, bf16 / fp16 / fp32
           views of the qkv projection, decode steps with inactive rows
           and prefill chunks of 64 and 80, shuffled tables), with two
           planted faults (a token's K scales taken from V, its last
           payload vector left unwritten) that the check must reject, one
           kernel a call in the profiler, and timed against the plain
           sequence; quantize and dequantize (int8, int4) bit-exact at
           the K/V rows' shape and the largest weights (wte, mlp_up_w;
           wte's quantize_int8 and quantize_int4 also as device time) and
           at groups the vector path of either width takes (4, 8, 24, 768,
           1024) or not (7, 12, an unaligned view), with a planted fault
           (one unit of wte's int4 payload with its nibbles swapped) that
           the check must reject; dequantize also at a
           flat length with a tail, slices of stacked leaves (one not
           aligned to the kernel's unit), g 7, 8, 12 and 25, fp32 and
           fp16 outputs, and several
           leaves in one launch (those cases by dtype, a gpt2-125m layer's
           eight leaves, 40 leaves in two launches), with a planted fault
           (the tail left unwritten) that the check must reject, and timed
           at every dequantize a gpt2-125m model step makes, one layer's
           launch and a whole model step's dequantization (15 launches) as
           CUDA-graph device time in turns with q.to(bf16) on the same
           payloads (copy_ms), inputs rotated past L2; with medians of
           CUDA-event timings of the kernel, its plain version and, where
           one PyTorch call computes the same function, that call
           (library_ms); for the two attention forwards also the factor
           to SDPA, both timed again in turns (ms_turns,
           library_ms_turns) and as device time alone (a CUDA graph of
           the calls: graph_ms, library_graph_ms); token_sort bit-exact
           at the dropless path's shape
           (N 4096, E 8; int32 ids, and int64 as the path holds them), E
           64 and 128, N 65 536 (16 blocks and their look-back), a second
           N 65 536 launched straight after it with other ids (a stale
           look-back word or ticket would show), three tiles and one, an
           odd N, all ids equal, ids out of range and negative, int64 ids
           and int64 ids past 2^32, and a CUDA graph of the sort replayed
           over three id sets, each replay checked; timed as CUDA-graph
           device time at N 4096 (int32, int64) and 65 536; fused_layer_norm /
           fused_rms_norm within one output-dtype step and with at least
           0.999 of the outputs bit-equal to the plain version's at every
           NORM_SWEEP case (model widths 768 to 12288, bf16 and fp16
           with a residual, fp32, a decode step's 16 rows, rows not a
           multiple of 16 bytes) and NORM_EDGE_CASES (residuals of another dtype,
           fp32 or mixed parameters, the widest rows (32768), an unaligned
           start, D 1, the warp kernel's widths), with two planted faults
           (a row's last 16-byte vector left out of the statistics, a
           ring slot read stale) that the check must reject, each sweep
           case timed eagerly, as CUDA-graph device time and host time a
           call, in turns with F.layer_norm / F.rms_norm, inputs rotated
           past L2 (but for the three launch-bound cases);
           the block-sparse forward, dq and dk/dv kernels (and dbias)
           row by row within 1e-2 of each row's norm at the sparse paths'
           shapes (B 1, H 12, T 8192, hd 64), on four layout families, at
           hd 128 in fp16 at T 1008 (also with per-head bias slabs,
           padding and causality), with bias slabs of 1 and H heads
           (learned and frozen), an all-padded row (the mean of its
           visited V), a batched mask and B * H above 65 535; two
           planted faults (a tile dropped from one visit list) that the
           row measure must see;
           the public wrapper's autograd at B 2 against autograd through
           the plain version; the backward pair timed against SDPA's
           backward with the dense mask eagerly, in turns and as device
           time, and at the op path the dq pass also without its dbias;
           the evoformer kernel within one
           output-dtype step at the evoformer phase's shapes, there also
           with at least 0.999 of its output elements bit-equal to the
           plain version's, with two planted faults (a plain forward
           missing one key tile, and one with P narrowed to one bf16
           piece) that those checks must reject, timed eagerly, in turns
           and as device time against SDPA with the summed bias; and in
           fp32 with broadcast biases, fp16 at hd 128, without biases, at
           S 255 / 257 / 640, pair rows TMA cannot read (S 100 fp16, S
           99 fp32), hd 32 / 64 / 128 in bf16 and fp16, fp32 biases
           under bf16 q, fused q/k/v views and B * N * H above 65 535;
  norms    the public norm ops at [4096, 768] bf16 with bf16 scale and
           bias: one launch each, and no other kernel in the profiler;
  generate init_inference -> generate() on gpt2-125m at full width and
           depth (random weights from a numpy seed), bf16: launch counts,
           prefill and first-decode logits held against the port's fp32
           CPU run of the same weights and tokens, tokens/s;
  serve    ServingEngine on the same model: 16 ragged requests through 8
           slots over the paged pool; completion, one paged-decode launch
           per layer per decode step, drained
           pool, the served tokens' agreement with generate() on the same
           prompts, requests/s and tokens/s; telemetry on (registry only,
           cleared after the warm-up request): TTFT, TPOT, queue wait and
           e2e count / p50 / p90 / p99 with exact counts (16 each, TPOT
           16 x 31), and the same trace through a serving engine with
           telemetry off giving the same tokens;
  quant    quantized serving on the same model, four paths, each with
           exact launch counts of its own: (a) the engine.serving build
           with int8 weights (one quantize_int8 per quantized leaf), then
           the int8 KV pool and int8 weights over the serve phase's 16
           requests — completion, drained pool, one int8 paged decode per
           layer per decode step, one quantize_int8 per layer per model
           step for the K/V write, the WOQ dequantize_int8 count derived
           from the quantized tree, the serve phase's latency readings and
           checks; the served tokens' agreement with the
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
  train    bench.py's headline lane: initialize() -> train_batch() on
           gpt2-760m at full width and depth (24 layers, d_model 1536, 12
           heads of 128, random weights from a numpy seed): AdamW, bf16
           without master weights, clipping 1.0, ZeRO 1, micro-batch 12,
           seq 512, gas 32, remat dots_with_no_batch_dims_saveable, a bf16
           gradient accumulator, telemetry on (registry only) and a CSV
           monitor. One warm-up step, then 3 timed steps on one batch:
           finite falling loss, no overflow, exact launch counts (flash
           forward 2 x 24 x gas per step — forward and remat recompute —
           and 24 x gas per backward kernel), seconds per step, tokens/s
           and MFU, the registry's train/step_time_ms p50 within 10 % of
           this script's median and its tokens/s, TFLOP/s, MFU and memory
           watermarks; the aten.mm + aten.addmm of one micro-batch under
           the policy, 3 x 24 fewer than under nothing_saveable; one step
           under nothing_saveable and each policy's peak memory; the CSV
           monitor's Train/loss rows equal to the losses; then the first
           step's loss and every parameter's gradient at 2 layers, bf16 on
           the card against the port's fp32 CPU run of the same weights
           and batch;
  north_star bench.py's north-star lane on one card: gpt2-1.3b at full
           width and depth (24 layers, d_model 2048, 16 heads of 128,
           random weights from a numpy seed), ZeRO 3, micro-batch 4, seq
           512, gas 64, the bf16 accumulator, the headline's remat policy,
           no master weights: 1 warm-up and 2 timed steps, exact flash
           launches, finite losses, seconds per step, tokens/s, MFU and the
           registry's readings;
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
           exact paged-decode launches, agreement with (b)'s generate(),
           the serve phase's latency readings and checks;
           (d) the dropless moe.layer.MoE on x [8, 512, 768]: one
           token_sort launch, handed argmax's int64 ids, and the layer's
           sort one kernel in the profiler (no cast before it), counts and
           unique slots, the per-token argmax oracle, finite gradients. Each MoE layer's top-1 routes
           on the card and the CPU twin are recorded by wrapping the
           port's routing functions from here, and their per-layer share
           alike is held to a floor;
  sparse   gpt2-125m at full width and depth with max_seq_len 8192,
           bf16, through sparse_attn_fn with the Fixed layout of
           tests/test_block_sparse_kernel.py:433-434 at 12 heads: (a)
           initialize() -> train_batch() (the train phase's engine config,
           micro-batch 1, seq 8192, gas 2; 1 warm-up + 3 timed steps):
           finite falling loss, exact launches (forward 2 x 12 x gas,
           each backward kernel 12 x gas per step, no flash), tokens/s,
           MFU; (b) the spec's apply_fn: 12 forward launches, finite
           logits; (c) 2-layer loss and gradients at T 2048, bf16 card vs
           fp32 CPU; (d) SparseSelfAttention with a learned rpe and padded
           keys: one launch of each kernel, the output and the q, k, v and
           rpe gradients against autograd through the plain version;
  evoformer evoformer_attention at AlphaFold 2's MSA-row (N 128, S 256,
           8 heads of 32) and triangle (N 256, S 256, 4 heads of 32)
           shapes, bf16, mask + pair bias: one launch a call, the output
           and the q/k/v/mask/pair gradients against the plain version,
           the forward's and forward + backward's times, the latter also
           with the backward one MSA row at a time (as before it was
           chunked);
  profile  (opt-in, after the phases it reads) torch.profiler over the same
           generate() call, serving runs (bf16, quantized, MoE) and one
           train_batch (gpt2-760m, MoE, sparse): kernel time on the card by
           class and the card's idle share of the unprofiled wall time.
A comma-separated phase list as the one argument runs those phases only
(the device phase always runs), e.g. `build,kernels,train,north_star`
(the training lanes), `build,serve` (TTFT / TPOT), `build,train,profile`,
`build,kernels,quant`, `build,kernels,moe`, `build,kernels,sparse` or
`build,kernels,evoformer`. Then the
card's name and power limit, the `kernels` summary line (one row per
kernel and path that runs it — the flash forward has generate,
quant_generate, train, north_star and moe_train rows; quantize_int8 a
quant_serve row, the K/V
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

# the bench lanes' engine config (bench.py:220-228: AdamW, bf16 without
# master weights, clipping 1.0; the ZeRO stage and the batch are the lane's)
BENCH_ENGINE_CONFIG = {
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                              "weight_decay": 0.1}},
    "bf16": {"enabled": True, "master_weights": False},
    "gradient_clipping": 1.0,
    "steps_per_print": 10**9,
}
# telemetry on the card: the registry only (every file sink off, so no
# file and no directory)
REGISTRY_ONLY = {"enabled": True, "prometheus": False, "jsonl": False,
                 "monitor_bridge": False}
# the training main path: bench.py's headline lane (bench.py:2252-2263,
# :1944) on gpt2-760m at full width and depth: micro-batch 12, seq 512,
# gas 32, ZeRO 1, remat dots_with_no_batch_dims_saveable, a bf16 gradient
# accumulator and a bf16 softmax (the flash kernels keep fp32 statistics
# whatever it says, in both packages), with telemetry on
TRAIN_MODEL, TRAIN_MBS, TRAIN_SEQ, TRAIN_GAS, TRAIN_STEPS = \
    "gpt2-760m", 12, 512, 32, 3
TRAIN_POLICY = "dots_with_no_batch_dims_saveable"
TRAIN_CONFIG = {
    **BENCH_ENGINE_CONFIG,
    "train_micro_batch_size_per_gpu": TRAIN_MBS,
    "gradient_accumulation_steps": TRAIN_GAS,
    "zero_optimization": {"stage": 1},
    "data_types": {"grad_accum_dtype": "bf16"},
    "telemetry": REGISTRY_ONLY,
}
# the registry's train/step_time_ms p50 (CUDA events around the step)
# against this script's own wall clock around train_batch and the loss
# read: the same interval but for the host's launch of the first kernel
# and its read of the loss
STEP_TIME_REL_TOL = 0.1
# the north-star lane (bench.py:1970-1977): gpt2-1.3b (24 layers, d_model
# 2048, 16 heads of 128) at full width and depth on one card, ZeRO 3 (one
# computation at one rank), micro-batch 4, seq 512, gas 64, the bf16
# accumulator, the headline's remat policy, no master weights
NORTH_MODEL, NORTH_MBS, NORTH_SEQ, NORTH_GAS, NORTH_STEPS = \
    "gpt2-1.3b", 4, 512, 64, 2
# the attention of one north-star micro-batch: B 4, T 512, 16 heads of 128
NORTH_ATTN = dict(B=NORTH_MBS, T=NORTH_SEQ, H=16, Hkv=16, D=128, causal=True)
NORTH_CONFIG = {
    **BENCH_ENGINE_CONFIG,
    "train_micro_batch_size_per_gpu": NORTH_MBS,
    "gradient_accumulation_steps": NORTH_GAS,
    "zero_optimization": {"stage": 3},
    "data_types": {"grad_accum_dtype": "bf16"},
    "telemetry": REGISTRY_ONLY,
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

# the sparse phase: gpt2-125m at full width and depth, its max_seq_len
# raised to 8192 (6.3 M more wpe parameters, the one departure from the
# model's config: long context is what sparse attention is for), through
# sparse_attn_fn with the JAX package's timed sparse layout
# (tests/test_block_sparse_kernel.py:433-434) at 12 heads, trained with the
# bench lanes' engine config, ZeRO 1, an fp32 accumulator, remat
# nothing_saveable, at micro-batch 1, gas 2
SPARSE_MODEL, SPARSE_SEQ, SPARSE_MBS, SPARSE_GAS, SPARSE_STEPS = \
    "gpt2-125m", 8192, 1, 2, 3
SPARSE_LAYOUT = dict(num_heads=12, block=16, num_local_blocks=256,
                     num_global_blocks=8, attention="unidirectional")
SPARSE_TRAIN_CONFIG = {**BENCH_ENGINE_CONFIG,
                       "zero_optimization": {"stage": 1},
                       "train_micro_batch_size_per_gpu": SPARSE_MBS,
                       "gradient_accumulation_steps": SPARSE_GAS}
# its parity run: 2 layers at T 2048, a layout of the same family that is
# sparse at that length
SPARSE_PARITY_SEQ = 2048
SPARSE_PARITY_LAYOUT = dict(num_heads=12, block=16, num_local_blocks=64,
                            num_global_blocks=4, attention="unidirectional")
# block-sparse kernels vs their plain versions on the same bf16/fp16
# inputs, row by row: for every row of out, dq, dk, dv (one query's or one
# key's D entries) and dbias (one query's T entries), ||got - ref||_2 over
# ||ref||_2 (`_row_err`). p and ds narrow to 16 bits (relative 2^-9 in
# bf16) before their products and each gradient rounds to bf16 once or
# twice, sums are fp32: a sound kernel's worst row sits a few 2^-9 off. A
# measure over the whole tensor's largest |entry| (the flash kernels' 2e-2
# x max|ref|) does not see a visit list that skips a tile: at T 8192 the
# rows that see few keys set max|ref| at ~3.5, 100x a typical row's
# entries. The row measure must, and the kernels phase proves it on
# planted faults (`_drop_tile`). Set from the kernels phase on an H100
# 80GB HBM3 (700 W): the sound kernels' worst row over every case is
# 0.0054 (dq, op path), the planted faults' rows 0.085-0.85, where the
# old measure read them at 0.0028-0.0128, under its 2e-2.
SPARSE_ROW_TOL = 1e-2
# a row whose ||ref|| is below this share of the RMS row norm is held
# against that floor instead: a padded key's dk and dv rows are exactly 0,
# and a query that sees one key has ds = p (dp - delta) = 0 up to fp32
# rounding, so its dq row is noise
SPARSE_ROW_FLOOR = 0.1
# the port's autograd (q scaling, delta, the need flags, dbias summed over
# heads and batch) vs autograd through the plain forward, as ||err||_2 /
# ||ref||_2 over the whole tensor. The two backward passes round at other
# places (the kernels narrow ds to 16 bits; autograd rounds dp, the
# gradient of the narrowed p), 2^-9 each, and ds sums to 0 along a row, so
# single rows with cancelling terms differ by more than the row measure
# allows; over the tensor they stay a few 2^-9 apart, while a fault in the
# wrapper (a scale, delta, a sum over the wrong axis) is an O(1) error.
# On the H100 above the worst reading is 0.0034 (q's gradient).
SPARSE_AUTOGRAD_TOL = 1e-2
# the evoformer phase: AlphaFold 2's Evoformer attention at the initial-
# training crop of the supplementary information's Table 4 (N_res 256,
# N_clust 128): Algorithm 7 (MSA row attention with pair bias, 8 heads of
# c = 32) and Algorithm 13 (triangle attention around the starting node,
# 4 heads of c = 32), bf16
EVO_CASES = {
    "evoformer_msa_row": dict(B=1, N=128, S=256, H=8, D=32),
    "evoformer_triangle": dict(B=1, N=256, S=256, H=4, D=32),
}
# the Evoformer bound's tensor-core work, fp32-accurate at BF16_FLOPS:
# S = Q K^T once (q and k are exact in 16 bits, so one product is exact),
# P V once per 16-bit piece of the fp32 P (three pieces hold its 24
# significant bits). The kernels line states the fp32 units' bound (both
# products once at FP32_FLOPS) beside it as bound_fp32_units_ms.
EVO_P_PIECES = 3
# evoformer kernel vs its plain version: both compute in fp32 and narrow
# nothing before the output, so only the order of fp32 sums differs; the
# one rounding to the output dtype can put them one step apart (eps x
# max|ref|), and EVO_ATOL covers the fp32 order noise of an fp32 output
EVO_ATOL = 1e-5
# ... and the share of output elements bit-equal to the plain version's at
# the two bf16 path shapes: fp32 order noise (~1e-6 relative) flips the
# bf16 rounding of about one element in 10^4, while P narrowed to one
# bf16 piece (2^-9 relative per p) flips tens of percent
EVO_BIT_EQUAL_MIN = 0.999
# ... and its floor at EVO_EDGE_CASES' 16-bit outputs, by dtype. The noise
# grows with the key tiles (each rescales O) and with a finer output step:
# on the H100 of PERF.md the kernel reads >= 0.99845 in bf16 (S 640) and
# >= 0.99635 in fp16, a bf16 kernel with two pieces of P <= 0.99582, and
# P narrowed to one piece of V's type 0.62-0.72 in both (which stays
# within the one-step tolerance: only this share sees it)
EVO_EDGE_BIT_EQUAL_MIN = {"torch.bfloat16": 0.9975, "torch.float16": 0.99}
# the evoformer kernel's cases beyond its paths' shapes (bf16 unless
# given): the fp32 kernel with biases broadcast over the batch; fp16 at hd
# 128 with a pair only; no biases; S ragged around the paths' 256 (255,
# 257); pair rows TMA cannot read (S 100 fp16: 200-byte rows; S 99 fp32);
# hd 32 / 64 / 128 in bf16 and fp16; an fp32 mask and an fp32 pair shared
# by the heads under bf16 q;
# q / k / v as views of one [B, N, S, 3, H, D] tensor; a slab wider than
# the kernel's window (S 640: two chunks a row); B * N * H above 65 535
EVO_EDGE_CASES = (
    dict(B=2, N=3, S=100, H=2, D=64, dtype="float32",
         mask_shape=(1, 3, 1, 1, 100), pair_shape=(1, 1, 2, 100, 100)),
    dict(B=1, N=4, S=200, H=4, D=128, dtype="float16", mask=False),
    dict(B=1, N=2, S=64, H=2, D=64, mask=False, pair=False),
    dict(B=1, N=9, S=255, H=2, D=32),
    dict(B=1, N=9, S=257, H=2, D=32),
    dict(B=2, N=10, S=100, H=2, D=32, dtype="float16"),
    dict(B=1, N=5, S=99, H=2, D=64, bias_dtype="float32"),
    *(dict(B=1, N=12, S=192, H=2, D=d, dtype=t)
      for d in (32, 64, 128) for t in ("bfloat16", "float16")),
    dict(B=1, N=9, S=128, H=3, D=64, bias_dtype="float32",
         pair_shape=(1, 1, 1, 128, 128)),
    dict(B=1, N=10, S=128, H=4, D=32, fused=True),
    dict(B=1, N=3, S=640, H=2, D=32),
    dict(B=1, N=8200, S=16, H=8, D=32),
)

REPLACES = {
    "block_sparse_attention":
        "deepspeed_tpu/ops/pallas/block_sparse_attention.py:515",
    "block_sparse_attention_bwd_dq":
        "deepspeed_tpu/ops/pallas/block_sparse_attention.py:601",
    "block_sparse_attention_bwd_dkv":
        "deepspeed_tpu/ops/pallas/block_sparse_attention.py:659",
    "evoformer_attention": "deepspeed_tpu/ops/pallas/evoformer_attn.py:98",
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
    "block_sparse_attention": "deepspeed_tpu_torch/ops/csrc/block_sparse.cu",
    "block_sparse_attention_bwd_dq":
        "deepspeed_tpu_torch/ops/csrc/block_sparse.cu",
    "block_sparse_attention_bwd_dkv":
        "deepspeed_tpu_torch/ops/csrc/block_sparse.cu",
    "evoformer_attention": "deepspeed_tpu_torch/ops/csrc/evoformer_attn.cu",
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


def median_ms_turns(fns, reps=31, inner=10, warmup=3):
    """Medians (ms a call) of CUDA-event timings of several calls taken in
    turns: each of `reps` rounds times `inner` calls of each fn in order,
    so that a spell of the host's other load falls on all of them alike.
    The two attention forwards' eager calls (20-50 us of host time each)
    run at the host's pace: `_forward_yardsticks` reads their factor to
    SDPA this way too."""
    import torch
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, t in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end) / inner)
    return [statistics.median(t) for t in times]


def graph_ms_turns(fns, inner=20, reps=10, warmup=3):
    """Median device time of one call of each fn, as `graph_ms`, with the
    graphs (`inner` calls each) replayed in turns: each of `reps` rounds
    replays every graph once, so a change of the card's clock falls on all
    of them alike. Each graph is captured on the stream its warm-up ran on,
    so what a wrapper keeps per stream (a kernel's scratch) is made before
    the capture and not recorded into the graph."""
    import torch
    graphs = []
    for fn in fns:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph, stream=side):
            for _ in range(inner):
                fn()
        graph.replay()
        graphs.append(graph)
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for graph, t in zip(graphs, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end) / inner)
    del graphs
    return [statistics.median(t) for t in times]


def graph_ms(fn, inner=20, reps=10, warmup=3):
    """Median device time of one call of `fn`: CUDA-event timings of a
    CUDA graph holding `inner` calls, so the host's launch time is not in
    it (`median_ms` times eager calls, where a call whose host side is
    slower than its kernel is timed at the host's pace)."""
    return graph_ms_turns([fn], inner, reps, warmup)[0]


def _forward_yardsticks(row, fn, sdpa, inner):
    """The two attention forwards' factor to SDPA three ways: `row`'s `ms`
    over its `library_ms` (both `median_ms`, as every kernel is timed);
    the same eager calls timed in turns (`median_ms_turns`); and device
    time alone (`graph_ms`, CUDA graphs of `inner` calls each)."""
    ms_turns, lib_turns = median_ms_turns([fn, sdpa])
    dev, lib_dev = graph_ms(fn, inner=inner), graph_ms(sdpa, inner=inner)
    row.update(sdpa_factor=row["ms"] / row["library_ms"],
               ms_turns=ms_turns, library_ms_turns=lib_turns,
               sdpa_factor_turns=ms_turns / lib_turns,
               graph_ms=dev, library_graph_ms=lib_dev,
               graph_sdpa_factor=dev / lib_dev)


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


def _flash_case(rng, B, T, H, Hkv, D, causal, dtype="bfloat16",
                fused5d=False):
    import torch
    if fused5d:
        # q/k/v as strided views of one [B, T, 3, H, D] tensor
        qkv = torch.from_numpy(rng.standard_normal(
            (B, T, 3, H, D)).astype(np.float32)).to(
                "cuda", getattr(torch, dtype))
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal
    # q/k/v as [B, T, H, D] views of one fused projection, as the model
    # hands them to the kernel
    qkv = torch.from_numpy(rng.standard_normal(
        (B, T, (H + 2 * Hkv) * D)).astype(np.float32)).to(
            "cuda", getattr(torch, dtype))
    q, k, v = qkv.split([H * D, Hkv * D, Hkv * D], dim=-1)
    return (q.reshape(B, T, H, D), k.reshape(B, T, Hkv, D),
            v.reshape(B, T, Hkv, D), causal)


# the flash forward's edge cases: T short of one tile and ragged against
# the 64-row tiles (16, 48, 200, 333, 1000), GQA 4, fp16, causal and full,
# fused [B, T, 3, H, D] views
FLASH_EDGE_CASES = (
    dict(B=2, T=16, H=4, Hkv=4, D=64, causal=True, fused5d=True),
    dict(B=2, T=48, H=8, Hkv=2, D=128, causal=False),
    dict(B=2, T=48, H=4, Hkv=4, D=128, causal=True, dtype="float16",
         fused5d=True),
    dict(B=2, T=200, H=8, Hkv=8, D=128, causal=True, fused5d=True),
    dict(B=1, T=333, H=4, Hkv=4, D=64, causal=False, dtype="float16",
         fused5d=True),
    dict(B=1, T=1000, H=8, Hkv=2, D=64, causal=True, dtype="float16"),
    dict(B=1, T=1000, H=16, Hkv=4, D=128, causal=True),
    dict(B=1, T=1000, H=8, Hkv=8, D=128, causal=False, fused5d=True),
    dict(B=2, T=333, H=16, Hkv=4, D=128, causal=True),
    dict(B=2, T=200, H=8, Hkv=2, D=128, causal=False))


def _paged_case(rng, B, H, Hkv, hd, bs, nb, pos, dtype="bfloat16",
                tables=None):
    """q, a paged K/V pool, block tables (shuffled, inactive rows on the
    trash block only, unless given) and pos, in `dtype` on the card."""
    import torch
    N = B * nb + 1 if tables is None else int(np.max(tables)) + 1
    if tables is None:
        perm = rng.permutation(np.arange(1, N)).astype(np.int32)
        tables = perm[:B * nb].reshape(B, nb)
        live = [p > 0 for p in pos]
        tables[~np.asarray(live)] = 0      # inactive rows: trash block only

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", getattr(torch, dtype))
    return (randn(B, H, hd), randn(N, Hkv, bs, hd), randn(N, Hkv, bs, hd),
            torch.tensor(np.asarray(tables, np.int32), device="cuda"),
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

    def check_lse(shape, lse, ref_lse):
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= 1e-2:
            raise AssertionError(f"flash lse err {lse_err} at {shape}")

    # --- flash forward: its paths' shapes — generate()'s prefill (4
    # prompts padded to 600, gpt2-125m heads), the train step (gpt2-760m)
    # and the MoE train step — then the edge cases
    cases = [(dict(B=4, T=600, H=12, Hkv=12, D=64, causal=True),
              "generate"),
             (dict(B=12, T=512, H=12, Hkv=12, D=128, causal=True), "train"),
             (NORTH_ATTN, "north_star"),
             (dict(B=8, T=512, H=12, Hkv=12, D=64, causal=True),
              "moe_train")] + [(shape, None) for shape in FLASH_EDGE_CASES]
    for shape, path in cases:
        q, k, v, causal = _flash_case(rng, **shape)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                               layout="BTHD")
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                    layout="BTHD")
        torch.cuda.synchronize()
        err = check("flash_attention", shape, out, ref)
        check_lse(shape, lse, ref_lse)
        if path is None:
            continue
        B, T, H, D = q.shape
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pairs = B * H * T * (T + 1) / 2
        nbytes = 4 * B * T * H * D * 2 + B * H * T * 4
        b_ms, b_by = bound(nbytes, 4 * D * pairs)
        fwd = lambda: fa.flash_attention(q, k, v)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
        row = dict(
            max_abs_err=err, ms=median_ms(fwd),
            plain_ms=median_ms(lambda: fa.flash_attention_reference(
                q, k, v)), bound_ms=b_ms, bound_by=b_by,
            library_ms=median_ms(sdpa))
        _forward_yardsticks(row, fwd, sdpa, 20)
        results["flash_attention", path] = row

    # --- contiguous decode: main path = generate()'s decode over the
    # 1024-row cache (600 + 32 rounded to 512-blocks), mid-generation
    for shape, main in (
            (DECODE_GENERATE, True),
            (dict(B=8, H=32, Hkv=8, hd=128, M=2000,
                  pos=[0, 1, 63, 64, 700, 1999, 1500, 5]), False)):
        kw = _decode_args(rng, shape)
        q, kc, vc, pos = (kw[n] for n in ("q", "k", "v", "pos"))
        out = da.decode_attention(q, kc, vc, pos)
        ref = da.decode_attention_reference(q, kc, vc, pos)
        torch.cuda.synchronize()
        err = check("decode_attention", {k_: v_ for k_, v_ in shape.items()
                                         if k_ != "pos"}, out, ref)
        if not main:
            continue
        b_ms, b_by = _decode_bound(shape)
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
    _paged_split_kernels(rng, checks, results)
    _decode_split_kernels(rng, checks, results)
    results.update(_token_sort_kernel(rng, checks))
    results.update(_norm_kernels(rng, checks))
    results.update(_block_sparse_kernels(rng, checks))
    results.update(_evoformer_kernels(rng, checks))
    emit({"phase": "kernels", "checks": checks,
          "main_path": {f"{name}/{path}": row
                        for (name, path), row in results.items()}})
    return results


# the backward pair's cases beyond its paths' shapes: T short of one tile
# (16, 48) and ragged at hd 128 (1000), MQA (16 query heads over one kv
# head: the longest dk/dv walk), fp16 at hd 64, causal, full attention
# at hd 128 with T a multiple of 64, and B * H above 65 535 (65 600 rows of
# 16 queries: the forward and both passes walk that many items)
BWD_EDGE_CASES = (
    dict(B=4100, T=16, H=16, Hkv=16, D=64, causal=True),
    dict(B=2, T=16, H=4, Hkv=4, D=64, causal=True, fused5d=True),
    dict(B=2, T=48, H=8, Hkv=2, D=128, causal=True),
    dict(B=1, T=1000, H=8, Hkv=2, D=128, causal=True),
    dict(B=2, T=256, H=16, Hkv=1, D=128, causal=True),
    dict(B=2, T=512, H=8, Hkv=8, D=64, causal=True, dtype="float16"),
    dict(B=2, T=384, H=8, Hkv=8, D=128, causal=False))


def _backward_kernels(rng, checks):
    """The dq and dk/dv kernels through the autograd path (q/k/v strided
    views of one fused projection, as the model hands them over) against
    the plain backward on the same inputs and saved (out, lse): at the
    two training paths' shapes (gpt2-760m: H 12, hd 128, B 12, T 512;
    moe-gpt-125m-e8: H 12, hd 64, B 8, T 512; causal), at hd 64 / T 600,
    at GQA 4 with a ragged T and an lse cotangent, non-causal, at GQA 4
    with a ragged T in fp16, and at BWD_EDGE_CASES. Each gradient is held
    at BWD_REL_TOL x max|ref| and row by row (`_row_err`, SPARSE_ROW_TOL);
    the forward of each case against its plain version too. At the train
    shape two planted faults (a plain backward with one 64 x 64 tile
    dropped) must exceed the row measure. Then each kernel alone timed at
    each path's shape, and the pair against SDPA's backward three ways
    (`_backward_yardsticks`)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    results = {}
    for shape, path, with_dlse in (
            (dict(B=12, T=512, H=12, Hkv=12, D=128, causal=True), "train",
             False),
            (NORTH_ATTN, "north_star", False),
            (dict(B=8, T=512, H=12, Hkv=12, D=64, causal=True), "moe_train",
             False),
            (dict(B=4, T=600, H=12, Hkv=12, D=64, causal=True), None, False),
            (dict(B=2, T=333, H=16, Hkv=4, D=128, causal=True), None, True),
            (dict(B=2, T=200, H=8, Hkv=2, D=64, causal=False), None, False),
            (dict(B=2, T=333, H=16, Hkv=4, D=128, causal=True,
                  dtype="float16"), None, False),
            *((shape, None, False) for shape in BWD_EDGE_CASES)):
        q, k, v, do, out, lse, ref, errs, bwd_args = _backward_case(
            rng, checks, shape, with_dlse)
        if path == "train":
            _flash_faults(checks, bwd_args, ref, -(-shape["T"] // 64))
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
        sdpa = lambda: torch.autograd.grad(sout, (sq, sk, sv), sdo,
                                           retain_graph=True)
        library_ms = median_ms(sdpa)
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
        _backward_yardsticks(
            results["flash_attention_bwd_dq", path],
            results["flash_attention_bwd_dkv", path],
            lambda: fa._launch_bwd(qh, kh, vh, doh, lse_d, delta, sm, True,
                                   True, True),
            sdpa, sout.grad_fn.name())
    return results


def _backward_case(rng, checks, shape, with_dlse):
    """One case of the backward pair: q/k/v views of one fused projection
    (`_flash_case`) through the autograd path, against the plain backward
    on the same inputs and saved (out, lse), with an lse cotangent where
    `with_dlse`; each gradient at BWD_REL_TOL x max|ref| and row by row
    (`_row_err`, SPARSE_ROW_TOL), the forward against its plain version.
    Appends one record a kernel to `checks`; returns (q, k, v, do, out,
    lse, ref, {kernel: max abs err}, the plain backward's arguments)."""
    import torch
    from deepspeed_tpu_torch.ops import flash_attention as fa
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
    bwd_args = (qd, kd, vd, out.detach(), lse.detach(), do, dlse, causal)
    ref = fa.flash_attention_bwd_reference(*bwd_args)
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
        row = max(_row_err(grads[i], ref[i]) for i in idx)
        ok = bool(np.isfinite(err) and err <= BWD_REL_TOL * scale
                  and np.isfinite(row) and row <= SPARSE_ROW_TOL)
        checks.append({"kernel": name, "shape": shape,
                       "lse_cotangent": with_dlse,
                       "forward_max_abs_err": fwd_err,
                       "max_abs_err": err,
                       "ref_max_abs": scale,
                       "tol": BWD_REL_TOL * scale, "row_err": row,
                       "row_tol": SPARSE_ROW_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} {shape}: max abs err {err} > "
                                 f"{BWD_REL_TOL} x {scale} or worst row "
                                 f"err {row} > {SPARSE_ROW_TOL}")
        errs[name] = err
    return q, k, v, do, out, lse, ref, errs, bwd_args


def _flash_dropped_bwd(qt, kt, *args):
    """A planted fault for the flash backward's row measure: the plain
    backward (`flash_attention_bwd_reference(*args)`) with the scores of q
    tile `qt` x k tile `kt` (64 x 64) masked, as a kernel that skipped
    that K/V tile for that q tile (dq) or that q tile for that k tile
    (dk/dv) would compute."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    scores = fa._scores

    def dropped(qh, kh, causal, sm_scale):
        s = scores(qh, kh, causal, sm_scale)
        s[..., 64 * qt:64 * (qt + 1), 64 * kt:64 * (kt + 1)] = fa.NEG_INF
        return s
    fa._scores = dropped
    try:
        return fa.flash_attention_bwd_reference(*args)
    finally:
        fa._scores = scores


def _flash_faults(checks, bwd_args, ref, n_t):
    """The row measure against the plain backward with one tile dropped
    (q tile n_t - 2 loses k tile 0, then its diagonal k tile): it must
    exceed SPARSE_ROW_TOL on dq, dk and dv, as `_sparse_faults` shows for
    the block-sparse kernels."""
    for fault, qt, kt in (("dropped_first_tile", n_t - 2, 0),
                          ("dropped_diagonal_tile", n_t - 2, n_t - 2)):
        bad = _flash_dropped_bwd(qt, kt, *bwd_args)
        for name, what, i in (("flash_attention_bwd_dq", "dq", 0),
                              ("flash_attention_bwd_dkv", "dk", 1),
                              ("flash_attention_bwd_dkv", "dv", 2)):
            row = _row_err(bad[i], ref[i])
            checks.append({"kernel": name, "fault": fault, "q_tile": qt,
                           "k_tile": kt, "output": what, "row_err": row,
                           "max_rel_err": _max_rel(bad[i], ref[i]),
                           "seen": row > SPARSE_ROW_TOL})
            if not row > SPARSE_ROW_TOL:
                raise AssertionError(f"{name} {fault} {what}: row err {row} "
                                     f"<= {SPARSE_ROW_TOL}, the check does "
                                     f"not see a skipped tile")


def _device_ms(fn, calls=10, warmup=3):
    """Device time of one call of `fn` alone: the CUDA kernels' time that
    torch.profiler records over `calls` calls, over `calls` (an autograd
    backward whose forward ran outside a CUDA graph cannot be captured in
    one, so `graph_ms` cannot time SDPA's backward); with the kernels'
    names and launches a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, kernels = 0.0, {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t <= 0 or ev.device_type.name != "CUDA":
            continue
        us += t
        kernels[ev.key[:80]] = ev.count / calls
    return us / 1e3 / calls, kernels


def _host_ms(fn, calls=50):
    """Host time of one call: the wall time of `calls` calls enqueued back
    to back (no synchronize between them), over `calls`."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / calls


def _backward_yardsticks(row_dq, row_dkv, pair, sdpa, backend):
    """The backward pair's (dq + dk/dv) factor to SDPA's backward three
    ways: the sum of the two rows' `ms` over `library_ms` (eager
    `median_ms` of each call alone, run 6F's yardstick, which the aims are
    held to); the pair and SDPA's backward timed in turns
    (`median_ms_turns`); and device time alone (`_device_ms`). With the
    pair's host time a call, and SDPA's backend (its autograd node) and
    kernels, to tell a change of backend from noise."""
    ms_turns, lib_turns = median_ms_turns([pair, sdpa])
    dev, _ = _device_ms(pair)
    lib_dev, lib_kernels = _device_ms(sdpa)
    pair_ms = row_dq["ms"] + row_dkv["ms"]
    info = dict(pair_ms=pair_ms,
                pair_sdpa_factor=pair_ms / row_dq["library_ms"],
                pair_ms_turns=ms_turns, library_ms_turns=lib_turns,
                pair_sdpa_factor_turns=ms_turns / lib_turns,
                pair_device_ms=dev, library_device_ms=lib_dev,
                pair_device_sdpa_factor=dev / lib_dev,
                pair_host_ms=_host_ms(pair), sdpa_backend=backend,
                sdpa_kernels=lib_kernels)
    row_dq.update(info)
    row_dkv.update(info)


def _quant_pool_case(rng, B, H, Hkv, hd, bs, nb, g, pos, tables=None,
                     dtype="bfloat16"):
    """An int8 pool (quantized with the plain version from fp32 normals),
    q in `dtype` (bf16), shuffled block tables (inactive rows: trash block
    only) unless given."""
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
        np.float32)).to("cuda", getattr(torch, dtype))
    return (q, pool, torch.tensor(np.asarray(tables, np.int32), device="cuda"),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def _quant_kernels(rng, checks):
    """The int8 paged decode and the four quantize / dequantize kernels
    against their plain versions on the card, then timed: the paged decode
    at the quantized serve path's shape (8 slots, bs 512, hd 64, g 64),
    quantize_int8 at its per-step shape (the K/V pool write, 8 slots x 12
    heads of 64) and at wte [50304, 768], quantize_int4 at wte — each with
    every shape's times under `by_shape`; the dequantize kernels also at
    `_dequant_kernels`' cases, and timed at every dequantize of a model
    step (`_dequant_timing`; the row: wte, the LM head's table)."""
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

    # quantize / dequantize: bit-exact, payload and scales; int8 takes the
    # vector path wherever g divides 8 or is a multiple of 8 up to 1024 and
    # x is 16-byte aligned, else the row body (g 7, 12; an unaligned view)
    timed = {}
    for (rows, D), g, dtype, label in (
            ((96, 64), 64, torch.bfloat16, "kv_rows"),
            ((96, 64), 32, torch.float16, None),
            ((50304, 768), 64, torch.bfloat16, "wte"),
            ((768, 3072), 64, torch.bfloat16, "mlp_up_w"),
            ((40, 14), 7, torch.float32, None),     # a byte spans two groups
            ((96, 64), 8, torch.bfloat16, None),
            ((33, 96), 24, torch.float16, None),    # 3 lanes a group
            ((12, 768), 768, torch.float32, None),  # 3 units a lane
            ((64, 2048), 1024, torch.bfloat16, None),
            ((16, 64), 4, torch.float32, None),     # groups within a unit
            ((9, 96), 12, torch.bfloat16, None),    # the row body
            ((37, 72), 8, "unaligned", None)):      # a view 2 bytes in
        if dtype == "unaligned":
            x = torch.from_numpy(rng.standard_normal(rows * D + 1).astype(
                np.float32)).to("cuda", torch.bfloat16)[1:].view(rows, D)
            dtype = torch.bfloat16
        else:
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
            name = f"quantize_int{bits}"
            timed.setdefault(name, {})[label] = dict(
                shape=[rows, D], group=g, max_abs_err=0.0,
                ms=median_ms(lambda: quant.quantize(x, g, bits)),
                plain_ms=median_ms(
                    lambda: quant.quantize_reference(x, g, bits)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # the quotient's rounding: every element at or beside a tie of the
    # round to nearest even (x / s = k + 1/2), both widths, g 64 (the
    # vector body's team), 4 (groups within a unit) and 12 (the row body)
    for (rows, D), g, dtype in (((256, 768), 64, torch.float32),
                                ((256, 768), 64, torch.bfloat16),
                                ((64, 96), 4, torch.float16),
                                ((33, 96), 12, torch.float32)):
        for bits in (8, 4):
            x = _quant_ties(rng, rows, D, g, bits, dtype)
            qk, sk = quant.quantize(x, g, bits)
            qr, sr = quant.quantize_reference(x, g, bits)
            torch.cuda.synchronize()
            exact = bool(torch.equal(qk, qr) and torch.equal(sk, sr))
            checks.append({"kernel": f"quantize_int{bits}", "case": "ties",
                           "shape": [rows, D], "group": g,
                           "dtype": str(dtype), "bit_exact": exact,
                           "ok": exact})
            if not exact:
                raise AssertionError(f"int{bits} ties [{rows}, {D}] g {g} "
                                     f"{dtype}: kernel != plain version")
    # quantize_int8 runs on two paths: the K/V pool write of every model
    # step (the fused write, one launch a layer), and the int8 weights'
    # quantization when the serving engine is built; quantize_int4 only at
    # the int4 engine's build (wte of both: also device time, in turns)
    write = _kv_write_kernels(rng, checks)
    sets = [dict(x=torch.from_numpy(rng.standard_normal(
        (50304, 768)).astype(np.float32)).to("cuda", torch.bfloat16))
        for _ in range(3)]
    wte_ms = graph_ms_turns([_Rotating(
        lambda x, bits=bits: quant.quantize(x, 64, bits), sets)
        for bits in (8, 4)], inner=6)
    for bits, ms in zip((8, 4), wte_ms):
        wte = timed[f"quantize_int{bits}"]["wte"]
        wte["graph_ms"] = ms
        wte["graph_bound_factor"] = ms / wte["bound_ms"]
    _int4_nibble_fault(checks, sets[0]["x"])
    del sets
    results["quantize_int8", "quant_serve"] = dict(
        write, by_shape=dict(timed["quantize_int8"]))
    for name, path, label in (("quantize_int8", "quant_serve_build", "wte"),
                              ("quantize_int4", "quant_generate_build",
                               "wte")):
        results[name, path] = dict(timed[name][label], by_shape=timed[name])
    # the dequantize kernels beyond those pairs, then timed at every
    # dequantize a model step of their paths makes (the row: wte's)
    _dequant_kernels(rng, checks)
    for bits, path in ((8, "quant_serve"), (4, "quant_generate")):
        by_shape = _dequant_timing(bits)
        results[f"dequantize_int{bits}", path] = dict(by_shape["wte"],
                                                      by_shape=by_shape)
    return results


def _quant_ties(rng, rows, D, g, bits, dtype):
    """x [rows, D] on the card whose groups hold their amax first and
    then values at or within two ulps (of x's dtype) of the quantizer's
    ties, x / s = k + 1/2 for k < qmax - 1, either sign. In fp32 the amax is
    random and s = amax / qmax rounded; in bf16 / fp16, s is a power of
    two (amax = qmax s), so the ties are exact in x's dtype."""
    import torch
    qmax = 127 if bits == 8 else 7
    ng = D // g
    if dtype == torch.float32:
        amax = rng.uniform(0.01, 100.0, (rows, ng)).astype(np.float32)
        s = amax / np.float32(qmax)
    else:
        s = np.ldexp(np.float32(1), rng.integers(-6, 6, (rows, ng))).astype(
            np.float32)
        amax = np.float32(qmax) * s
    # k < qmax - 1: two ulps above (qmax - 3/2) s stay below the amax
    x = (rng.integers(0, qmax - 1, (rows, ng, g)) + np.float32(0.5)) \
        * s[..., None]
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    bits_view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                 torch.float16: torch.int16}[dtype]
    steps = torch.from_numpy(rng.integers(-2, 3, (rows, ng, g))).to(bits_view)
    x = (x.view(bits_view) + steps).view(dtype)     # positive: ulps apart
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], (rows, ng, g))).to(dtype)
    x = x * sign
    x[..., 0] = torch.from_numpy(amax).to(dtype) * sign[..., 0]
    return x.reshape(rows, D).to("cuda")


def _swap_unit_nibbles(q, unit=None):
    """A copy of an int4 payload with one unit's 4 bytes (8 elements) each
    holding its two nibbles the other way round: the first unit the swap
    changes, or `unit`. The likely fault of a packing that puts the even
    element in the high nibble."""
    import torch
    flat = q.reshape(-1).view(torch.uint8)
    units = flat[:flat.numel() // 4 * 4].reshape(-1, 4).to(torch.int32)
    swapped = ((units & 0xF) << 4) | (units >> 4)
    if unit is None:
        unit = int((swapped != units).any(dim=1).int().argmax())
    out = flat.clone()
    out[4 * unit:4 * unit + 4] = swapped[unit].to(torch.uint8)
    return out.view(torch.int8).reshape(q.shape)


def _int4_nibble_fault(checks, x):
    """The int4 quantize's planted fault: wte's payload with one unit's
    nibbles swapped must fail the bit-exact check that the kernel passes."""
    import torch
    from deepspeed_tpu_torch.ops import quant
    qk, _ = quant.quantize_int4(x, 64)
    qr, _ = quant.quantize_reference(x, 64, 4)
    fault = _swap_unit_nibbles(qk)
    torch.cuda.synchronize()
    seen = bool(torch.equal(qk, qr)) and not torch.equal(fault, qr)
    checks.append({"kernel": "quantize_int4", "shape": list(x.shape),
                   "fault": "unit_nibbles_swapped", "seen": seen,
                   "ok": seen})
    if not seen:
        raise AssertionError("quantize_int4: the swapped-nibble fault "
                             "passed the bit-exact check")


# the int8 pool write (row 7 on the quant_serve path: one launch a layer
# for K and V) beyond its path's shape: g 4 (groups within a lane's 8
# elements), 8, 16, 32, 64 and 128 (= hd), hd 64 and 128, bf16 / fp16 /
# fp32 K/V as views of the fused qkv projection (strided rows), decode
# steps (C 1, inactive rows on the trash block) and prefill chunks (C 64
# and 80), 16- and 512-row blocks, shuffled tables; each bit-exact against
# the plain sequence on every block but the trash block, both pools
KV_WRITE_SERVE = dict(B=8, C=1, H=12, Hkv=12, hd=64, g=64, bs=512, nb=2,
                      inactive=2)
KV_WRITE_CASES = (
    KV_WRITE_SERVE,
    dict(B=4, C=1, H=16, Hkv=8, hd=128, g=8, bs=64, nb=3, dtype="float16",
         inactive=1),
    dict(B=1, C=64, H=12, Hkv=12, hd=64, g=16, bs=512, nb=2),
    dict(B=2, C=80, H=8, Hkv=4, hd=128, g=32, bs=16, nb=12,
         dtype="float32"),
    dict(B=6, C=1, H=8, Hkv=2, hd=128, g=128, bs=16, nb=8, inactive=2),
    dict(B=3, C=5, H=4, Hkv=2, hd=64, g=4, bs=16, nb=2, dtype="float32"),
    dict(B=5, C=1, H=12, Hkv=12, hd=64, g=32, bs=512, nb=2, dtype="float16",
         inactive=1),
)


def _kv_write_args(rng, case):
    """(k, v, tables, positions, pool) of one write case on the card: K/V
    views of a fused qkv projection [B, C, (H + 2 Hkv) hd]; shuffled
    tables, the first `inactive` rows all-trash at position 0; distinct
    positions a row (consecutive for C > 1, as a prefill chunk); the pool
    random, so that a cell left unwritten shows."""
    import torch
    B, C, H, Hkv, hd, g, bs, nb = (case[n] for n in (
        "B", "C", "H", "Hkv", "hd", "g", "bs", "nb"))
    dt = getattr(torch, case.get("dtype", "bfloat16"))
    N = B * nb + 1
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(
        B, nb).astype(np.int32)
    cap = nb * bs
    if C == 1:
        pos = rng.integers(0, cap, (B, 1))
    else:
        pos = rng.integers(0, cap - C + 1, (B, 1)) + np.arange(C)[None]
    n_off = case.get("inactive", 0)
    tables[:n_off], pos[:n_off] = 0, 0
    qkv = torch.from_numpy(rng.standard_normal(
        (B, C, (H + 2 * Hkv) * hd)).astype(np.float32)).to("cuda", dt)
    _, k, v = qkv.split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
    pool = {}
    for name in ("k", "v"):
        pool[name] = torch.from_numpy(rng.integers(
            -127, 128, (N, Hkv, bs, hd)).astype(np.int8)).cuda()
        pool[name + "_scale"] = torch.from_numpy(rng.random(
            (N, Hkv, bs, hd // g)).astype(np.float32)).cuda()
    return (k.reshape(B, C, Hkv, hd), v.reshape(B, C, Hkv, hd),
            torch.tensor(tables, device="cuda"),
            torch.tensor(pos, dtype=torch.int64, device="cuda"), pool)


_POOL_NAMES = ("k", "v", "k_scale", "v_scale")


def _kv_write_check(checks, label, got, ref, fault=None):
    """Every pool tensor bit-equal to the plain sequence's outside the
    trash block (block 0, where inactive rows collide); a planted fault
    must fail it."""
    import torch
    equal = {n: bool(torch.equal(got[n][1:], ref[n][1:]))
             for n in _POOL_NAMES}
    ok = all(equal.values())
    row = {"kernel": "quantize_int8", "case": label, "bit_exact": equal}
    if fault:
        row.update(fault=fault, seen=not ok)
        if ok:
            raise AssertionError(f"quantize_kv_write {label}: the planted "
                                 f"fault {fault} passes the check")
    else:
        row["ok"] = ok
        if not ok:
            raise AssertionError(f"quantize_kv_write {label}: kernel != "
                                 f"plain sequence ({equal})")
    checks.append(row)


def _kv_write_fault(args, fault):
    """The plain sequence with a planted fault at the last real token:
    "scale_from_other_tensor", its K scales are V's; "last_vector_unwritten",
    its last kv head's last 8 K payload bytes keep the pool's old ones."""
    from deepspeed_tpu_torch.ops import quant
    k, v, tables, pos, pool = args
    ref = {n: t.clone() for n, t in pool.items()}
    quant.quantize_kv_write_reference(k, v, tables, pos,
                                      *(ref[n] for n in _POOL_NAMES))
    B, C = pos.shape
    bs = pool["k"].shape[2]
    p = int(pos[B - 1, C - 1])
    blk, off = int(tables[B - 1, p // bs]), p % bs
    if fault == "scale_from_other_tensor":
        ref["k_scale"][blk, :, off] = ref["v_scale"][blk, :, off]
    else:
        ref["k"][blk, -1, off, -8:] = pool["k"][blk, -1, off, -8:]
    return ref


def _kv_write_bound(case):
    """The write's bound: K and V read once, payload and scales written
    once, positions and the rows' table entries read once."""
    import torch
    B, C, Hkv, hd, g = (case[n] for n in ("B", "C", "Hkv", "hd", "g"))
    esize = getattr(torch, case.get("dtype", "bfloat16")).itemsize
    n = 2 * B * C * Hkv * hd
    nbytes = n * esize + n + n // g * 4 + B * C * (8 + 4)
    return bound(nbytes, 4 * n, FP32_FLOPS)


def _kv_write_kernels(rng, checks):
    """The fused int8 pool write against the plain sequence (`quantize_kv_
    write_reference`: quantize_reference of K and V, then the index
    writes) at KV_WRITE_CASES, the two planted faults at the serve shape,
    the kernels one call launches (the wrapper's count: one; the profiler:
    its own alone, no gather or scatter), then timed at the serve shape: eager, device time in CUDA
    graphs of the kernel and of the plain sequence in turns, host time."""
    import torch
    from deepspeed_tpu_torch.ops import quant
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    for case in KV_WRITE_CASES:
        k, v, tables, pos, pool = _kv_write_args(rng, case)
        got = {n: t.clone() for n, t in pool.items()}
        ref = {n: t.clone() for n, t in pool.items()}
        quant.quantize_kv_write(k, v, tables, pos,
                                *(got[n] for n in _POOL_NAMES))
        quant.quantize_kv_write_reference(k, v, tables, pos,
                                          *(ref[n] for n in _POOL_NAMES))
        torch.cuda.synchronize()
        _kv_write_check(checks, dict(case), got, ref)
    args = _kv_write_args(rng, KV_WRITE_SERVE)
    k, v, tables, pos, pool = args
    got = {n: t.clone() for n, t in pool.items()}
    quant.quantize_kv_write(k, v, tables, pos, *(got[n] for n in _POOL_NAMES))
    for fault in ("scale_from_other_tensor", "last_vector_unwritten"):
        _kv_write_check(checks, "serve", got, _kv_write_fault(args, fault),
                        fault=fault)
    pools = [dict(pool)] + [{n: t.clone() for n, t in pool.items()}
                            for _ in range(7)]
    sets = [dict(kx=k, vx=v, tables=tables, pos=pos, pool=p) for p in pools]

    def fused(kx, vx, tables, pos, pool):
        quant.quantize_kv_write(kx, vx, tables, pos,
                                *(pool[n] for n in _POOL_NAMES))

    def plain(kx, vx, tables, pos, pool):
        quant.quantize_kv_write_reference(kx, vx, tables, pos,
                                          *(pool[n] for n in _POOL_NAMES))
    kern, ref_fn = _Rotating(fused, sets), _Rotating(plain, sets)
    # the wrapper counts its launches, one a call; the trace shows that
    # nothing else runs, no gather, scatter or copy (a long run's profiler
    # drops some events, so its counts are not exact: see _norms)
    LAUNCHES.clear()
    for _ in range(16):
        kern()
    torch.cuda.synchronize()
    if dict(LAUNCHES) != {"quantize_int8": 16}:
        raise AssertionError(f"quantize_kv_write: {dict(LAUNCHES)} launches "
                             f"in 16 calls, expected 16 of quantize_int8")
    _, kernels = _device_ms(kern, calls=16)
    if len(kernels) != 1 or any("quantize_vec_kernel" not in n
                                for n in kernels):
        raise AssertionError(f"quantize_kv_write: kernels in its calls "
                             f"{kernels}, want the fused write alone")
    # the plain sequence makes a host tensor a call: no CUDA graph of it
    # (the parent's kernel sequence: tools/quant_ab.py)
    g_kern = graph_ms(kern, inner=16)
    b_ms, b_by = _kv_write_bound(KV_WRITE_SERVE)
    return dict(shape={n: v for n, v in KV_WRITE_SERVE.items()},
                max_abs_err=0.0, ms=median_ms(kern), plain_ms=median_ms(ref_fn),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_ms=g_kern, host_ms=_host_ms(kern),
                plain_host_ms=_host_ms(ref_fn), kernels_a_call=kernels,
                graph_bound_factor=g_kern / b_ms)


# rows 5 and 6 (the paged decode over the bf16 and the int8 pool) beyond
# their paths' shapes, bf16 unless given. The kernels split each row's
# prefix into chunks (split_plan: 128 positions at the serve shape):
# positions at a chunk's edges (chunk - 1, chunk, chunk + 1), a row at full
# capacity and one past it (clamped), rows at 0 on the trash block only,
# 16-row blocks with a chunk across 4 pages, 48-row blocks (page
# segments cut by the kernel's tiles), a table that names two physical
# blocks in two rows, GQA 4 and 8, hd 128, fp16 and fp32, one row at 4095
# (64 chunks of 64 to merge) and 16 query heads over one kv head (two
# passes of 8); the int8 pool also at g 8 (two groups a lane's 8
# elements), 16, 32, 64 and 128
PAGED_EDGE_CASES = (
    dict(B=6, H=12, Hkv=12, hd=64, bs=512, nb=2,
         pos=[127, 128, 129, 1023, 0, 2000]),
    dict(B=5, H=16, Hkv=4, hd=128, bs=16, nb=24, pos=[63, 64, 65, 383, 0]),
    dict(B=4, H=32, Hkv=4, hd=64, bs=16, nb=20, pos=[127, 128, 129, 319]),
    dict(B=3, H=12, Hkv=12, hd=64, bs=48, nb=5, pos=[239, 130, 47]),
    dict(B=4, H=16, Hkv=2, hd=128, bs=128, nb=4, pos=[300, 511, 64, 0],
         tables=[[3, 1, 7, 5], [3, 1, 2, 8], [6, 4, 9, 2], [0, 0, 0, 0]]),
    dict(B=4, H=8, Hkv=8, hd=64, bs=64, nb=6, pos=[129, 383, 0, 200],
         dtype="float16"),
    dict(B=4, H=8, Hkv=2, hd=128, bs=32, nb=8, pos=[65, 255, 0, 127],
         dtype="float32"),
    dict(B=1, H=32, Hkv=8, hd=128, bs=512, nb=8, pos=[4095]),
    dict(B=2, H=16, Hkv=1, hd=64, bs=64, nb=4, pos=[200, 255]),
)
QUANT_PAGED_EDGE_CASES = (
    dict(PAGED_EDGE_CASES[0], g=64),
    *(dict(PAGED_EDGE_CASES[1], g=g) for g in (32, 64, 128)),
    dict(PAGED_EDGE_CASES[2], g=8),
    dict(PAGED_EDGE_CASES[3], g=32),
    dict(PAGED_EDGE_CASES[4], g=128),
    dict(PAGED_EDGE_CASES[5], g=16),
    dict(PAGED_EDGE_CASES[6], g=64),
    dict(PAGED_EDGE_CASES[7], g=64),
    dict(PAGED_EDGE_CASES[8], g=32),
)
# the long-context kernel case: Llama-3-8B's attention (32 query heads over
# 8 kv heads of 128, deepspeed_tpu/models/llama.py), 8 rows at position
# 4095 of 512-row blocks, bf16 and the int8 pool at g 64; no model path of
# the port runs it yet
PAGED_LONG = dict(B=8, H=32, Hkv=8, hd=128, bs=512, nb=8, pos=[4095] * 8)
PAGED_SERVE = dict(B=8, H=12, Hkv=12, hd=64, bs=512, nb=2,
                   pos=[150, 0, 400, 640, 1000, 0, 260, 520])


def _paged_args(rng, case):
    """(kwargs of the row's wrapper, kwargs of its plain version) for one
    case: the int8 pool where the case names a group size g."""
    c = dict(case)
    g = c.pop("g", None)
    if g is None:
        q, kp, vp, t, pos = _paged_case(rng, **c)
        kw = dict(q=q, k_pool=kp, v_pool=vp, block_tables=t, pos=pos)
        return kw, kw
    q, pool, t, pos = _quant_pool_case(rng, g=g, **c)
    return (dict(q=q, k_pool=pool["k"], v_pool=pool["v"],
                 k_scale=pool["k_scale"], v_scale=pool["v_scale"],
                 block_tables=t, pos=pos),
            dict(q=q, pool_l=pool, block_tables=t, pos=pos))


def _paged_fns(case):
    """(row name, wrapper, plain version) of a case."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    if "g" in case:
        return ("paged_decode_attention_quant",
                da.paged_decode_attention_quant,
                da.paged_decode_attention_quant_reference)
    return ("paged_decode_attention", da.paged_decode_attention,
            da.paged_decode_attention_reference)


def _paged_bound(case):
    """The byte / operation bound of one call: each row's live K/V (and
    int8 scales) read once, q read and out written once, the tables."""
    import torch
    B, H, Hkv, hd = case["B"], case["H"], case["Hkv"], case["hd"]
    cap = case["bs"] * case["nb"]
    live = sum(min(p, cap - 1) + 1 for p in case["pos"] if p >= 0)
    esize = getattr(torch, case.get("dtype", "bfloat16")).itemsize
    kv = hd * esize if "g" not in case else hd + 4 * (hd // case["g"])
    nbytes = 2 * live * Hkv * kv + 2 * B * H * hd * esize + B * case["nb"] * 4
    return bound(nbytes, 4 * live * H * hd, FP32_FLOPS)


def _paged_check(checks, name, label, out, ref, fault=None):
    """One paged-decode check: max abs error within TOL[name]; for the int8
    pool also every element within one bf16 step (QUANT_DECODE_REL x |ref|
    + QUANT_DECODE_ATOL); appended to `checks`. A planted fault must fail
    it: raises if a fault passes or the kernel fails."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    ok = bool(np.isfinite(err) and err <= TOL[name]
              and out.shape == ref.shape and out.dtype == ref.dtype)
    row = {"kernel": name, "case": label, "max_abs_err": err,
           "tol": TOL[name]}
    if name == "paged_decode_attention_quant":
        steps = (diff / (QUANT_DECODE_REL * ref.float().abs()
                         + QUANT_DECODE_ATOL)).max().item()
        ok = ok and steps <= 1.0
        row["max_err_over_bf16_step"] = steps
    if fault:
        row.update(fault=fault, seen=not ok)
        if ok:
            raise AssertionError(f"{name} {label}: the planted fault {fault} "
                                 f"passes the check ({row})")
    else:
        row["ok"] = ok
        if not ok:
            raise AssertionError(f"{name} {label}: {row}")
    checks.append(row)
    return err


def _paged_fault(kw, fault, seed=0):
    """The plain split algorithm (`paged_partials_reference`, then
    `combine_partials_reference`, at the wrapper's split plan) with a
    planted fault in the chunk partials of the row whose last live chunk
    holds the most positions: "dropped_last_chunk", the combine skips that
    chunk; "stale_partial", that chunk's partial is the previous call's
    (the previous decode step: another q, every pos one less)."""
    import torch
    from deepspeed_tpu_torch.ops import decode_attention as da
    q, k, v, tables, pos = (kw[n] for n in ("q", "k_pool", "v_pool",
                                            "block_tables", "pos"))
    scales = (kw["k_scale"], kw["v_scale"]) if "k_scale" in kw else None
    cap = k.shape[2] * tables.shape[1]
    chunk, _ = da.split_plan(cap, q.shape[0] * k.shape[1])
    m, l, acc = da.paged_partials_reference(q, k, v, tables, pos, chunk,
                                            scales=scales)
    lens = [min(p, cap - 1) + 1 for p in pos.tolist()]
    b = max((i for i, n in enumerate(lens) if n > chunk),
            key=lambda i: (lens[i] - 1) % chunk)
    c = (lens[b] - 1) // chunk
    if fault == "dropped_last_chunk":
        m[b, :, c], l[b, :, c], acc[b, :, c] = float("-inf"), 0.0, 0.0
    else:
        gen = torch.Generator(device=q.device).manual_seed(seed)
        q_prev = torch.randn(q.shape, generator=gen, device=q.device).to(
            q.dtype)
        pm, pl, pa = da.paged_partials_reference(q_prev, k, v, tables,
                                                 pos - 1, chunk,
                                                 scales=scales)
        m[b, :, c], l[b, :, c], acc[b, :, c] = pm[b, :, c], pl[b, :, c], \
            pa[b, :, c]
    return da.combine_partials_reference(m, l, acc, q.dtype)


def _paged_sets(rng, case):
    """Wrapper kwargs of one case, enough sets to move NORM_COLD_BYTES
    between two uses of one (at most 16): the pools are read from device
    memory, as a serving step finds them."""
    import torch
    esize = getattr(torch, case.get("dtype", "bfloat16")).itemsize
    hd = case["hd"]
    kv = hd * esize if "g" not in case else hd + 4 * (hd // case["g"])
    per_set = 2 * (case["B"] * case["nb"] + 1) * case["Hkv"] * case["bs"] \
        * kv
    n = int(min(16, max(1, -(-NORM_COLD_BYTES // per_set))))
    return [_paged_args(rng, case)[0] for _ in range(n)]


def _paged_timed(rng, case, reps=10):
    """One case timed: device time of the wrapper in CUDA graphs with its
    inputs rotated past L2 (`graph_ms`), the wrapper's host time a call, the
    bound; the kernel's check on the first set."""
    _, fn, _ = _paged_fns(case)
    sets = _paged_sets(rng, case)
    rot = _Rotating(fn, sets)
    inner = len(sets) * max(1, round(20 / len(sets)))
    (g,) = graph_ms_turns([rot], inner=inner, reps=reps)
    b_ms, b_by = _paged_bound(case)
    return dict(sets=len(sets), graph_ms=g, host_ms=_host_ms(rot),
                bound_ms=b_ms, bound_by=b_by, graph_bound_factor=g / b_ms)


def _paged_split_kernels(rng, checks, results):
    """Rows 5 and 6, the split kernels: every PAGED_EDGE_CASES /
    QUANT_PAGED_EDGE_CASES case and the long-context shape against the
    plain version; two planted faults at each path's shape that the check
    must reject; the paths' rows gain device time in CUDA graphs (inputs
    rotated past L2), host time a call and the long-context shape's
    readings (`by_shape`); row 4 gains its own device time and SDPA's."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as da
    long_q = dict(PAGED_LONG, g=64)
    for i, case in enumerate(PAGED_EDGE_CASES + QUANT_PAGED_EDGE_CASES
                             + (PAGED_LONG, long_q)):
        name, fn, plain = _paged_fns(case)
        kw, pkw = _paged_args(rng, case)
        out, ref = fn(**kw), plain(**pkw)
        torch.cuda.synchronize()
        label = {k: v for k, v in case.items() if k != "tables"}
        _paged_check(checks, name, label, out, ref)
        del kw, pkw, out, ref
    for case, path in ((PAGED_SERVE, "serve"),
                       (dict(PAGED_SERVE, g=64), "quant_serve")):
        name, fn, plain = _paged_fns(case)
        kw, pkw = _paged_args(rng, case)
        ref = plain(**pkw)
        for fault in ("dropped_last_chunk", "stale_partial"):
            _paged_check(checks, name, path, _paged_fault(kw, fault), ref,
                         fault=fault)
        row = results[name, path]
        row.update(_paged_timed(rng, case))
        row["chunk"], row["n_chunks"] = da.split_plan(
            case["bs"] * case["nb"], case["B"] * case["Hkv"])
        long_case = PAGED_LONG if "g" not in case else long_q
        row["by_shape"] = {"long_context": dict(
            _paged_timed(rng, long_case, reps=5),
            shape={k: v for k, v in long_case.items() if k != "pos"})}
        torch.cuda.empty_cache()


# row 4 (the contiguous decode, the split kernel with no table) beyond its
# path's shape, bf16 unless given. The plan (split_plan(M, B x Hkv)) cuts
# generate()'s 1024-row cache into chunks of 64: positions at a chunk's
# edges (63, 64, 65), 0, M - 1 and past M (clamped to M - 1); M not a
# multiple of 64 (1000, 77); G 1, 4, 8 and 16 (two passes of 8); hd 128;
# fp16 and fp32; one row at 4095 (64 chunks to merge)
DECODE_EDGE_CASES = (
    dict(B=6, H=12, Hkv=12, hd=64, M=1024, pos=[63, 64, 65, 0, 1023, 1500]),
    dict(B=4, H=8, Hkv=8, hd=64, M=1000, pos=[0, 999, 640, 2000],
         dtype="float16"),
    dict(B=3, H=16, Hkv=1, hd=64, M=77, pos=[0, 76, 500], dtype="float32"),
    dict(B=5, H=16, Hkv=4, hd=128, M=512, pos=[63, 64, 65, 511, 0]),
    dict(B=2, H=32, Hkv=4, hd=64, M=640, pos=[128, 639], dtype="float16"),
    dict(B=3, H=8, Hkv=8, hd=128, M=300, pos=[299, 64, 5],
         dtype="float32"),
    dict(B=1, H=32, Hkv=8, hd=128, M=4096, pos=[4095]),
)
# generate()'s decode (gpt2-125m, 4 prompts of 100-600 tokens, 16 tokens
# in) and row 4's long-context shape: Llama-3-8B's attention as
# PAGED_LONG, 8 rows at position 4095 of a contiguous 4096-row cache
DECODE_GENERATE = dict(B=4, H=12, Hkv=12, hd=64, M=1024,
                       pos=[n + 16 for n in (100, 250, 431, 600)])
DECODE_LONG = dict(B=8, H=32, Hkv=8, hd=128, M=4096, pos=[4095] * 8)


def _decode_args(rng, case):
    """Row 4's wrapper kwargs for one case: q, the cache, pos on the
    card in the case's dtype."""
    import torch
    B, H, Hkv, hd, M = (case[n] for n in ("B", "H", "Hkv", "hd", "M"))
    dt = getattr(torch, case.get("dtype", "bfloat16"))

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dt)
    return dict(q=randn(B, H, hd), k=randn(B, Hkv, M, hd),
                v=randn(B, Hkv, M, hd),
                pos=torch.tensor(case["pos"], dtype=torch.int32,
                                 device="cuda"))


def _decode_bound(case):
    """Row 4's bound: each row's live K/V (pos clamped to M - 1) read
    once, q read and out written once."""
    import torch
    B, H, Hkv, hd, M = (case[n] for n in ("B", "H", "Hkv", "hd", "M"))
    esize = getattr(torch, case.get("dtype", "bfloat16")).itemsize
    live = sum(min(p, M - 1) + 1 for p in case["pos"] if p >= 0)
    return bound(2 * live * Hkv * hd * esize + 2 * B * H * hd * esize,
                 4 * live * H * hd, FP32_FLOPS)


def _decode_as_paged(kw):
    """Row 4's kwargs as the paged plain versions take them: the cache as
    a pool of B blocks of M rows, row b's table [b]."""
    import torch
    B = kw["q"].shape[0]
    return dict(q=kw["q"], k_pool=kw["k"], v_pool=kw["v"],
                block_tables=torch.arange(B, dtype=torch.int32,
                                          device=kw["q"].device)[:, None],
                pos=kw["pos"])


def _decode_timed(rng, case, reps=10):
    """Row 4 at one case: device time in CUDA graphs with the inputs
    rotated past L2, host time a call, the bound."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    per_set = 2 * case["B"] * case["Hkv"] * case["M"] * case["hd"] * 2
    sets = [_decode_args(rng, case) for _ in range(
        int(min(8, max(2, -(-NORM_COLD_BYTES // per_set)))))]
    rot = _Rotating(da.decode_attention, sets)
    inner = len(sets) * max(1, round(16 / len(sets)))
    (g,) = graph_ms_turns([rot], inner=inner, reps=reps)
    b_ms, b_by = _decode_bound(case)
    return dict(sets=len(sets), graph_ms=g, host_ms=_host_ms(rot),
                bound_ms=b_ms, bound_by=b_by, graph_bound_factor=g / b_ms)


def _decode_split_kernels(rng, checks, results):
    """Row 4, the split kernel over the contiguous cache: every
    DECODE_EDGE_CASES case and the long-context shape against
    `decode_attention_reference`; the paged planted faults (a dropped last
    chunk, a stale chunk partial) built on the cache as a table-less pool,
    which the check must reject; the path's row gains device time beside
    SDPA's (in turns, inputs rotated past L2), host time a call, its split
    and the long-context shape's readings (`by_shape`)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as da
    name = "decode_attention"
    for case in DECODE_EDGE_CASES + (DECODE_LONG,):
        kw = _decode_args(rng, case)
        out, ref = da.decode_attention(**kw), da.decode_attention_reference(
            **kw)
        torch.cuda.synchronize()
        _paged_check(checks, name, dict(case), out, ref)
        del kw, out, ref
    kw = _decode_args(rng, DECODE_GENERATE)
    ref = da.decode_attention_reference(**kw)
    for fault in ("dropped_last_chunk", "stale_partial"):
        _paged_check(checks, name, "generate",
                     _paged_fault(_decode_as_paged(kw), fault), ref,
                     fault=fault)
    # device time and SDPA's at the path's shape (a masked einsum's worth
    # of work over the whole cache), in turns
    sets = []
    for _ in range(8):
        kw = _decode_args(rng, DECODE_GENERATE)
        kw["mask"] = (torch.arange(DECODE_GENERATE["M"], device="cuda")[
            None, :] <= kw["pos"][:, None].long())[:, None, None, :]
        sets.append(kw)
    kern = _Rotating(lambda q, k, v, pos, mask: da.decode_attention(
        q, k, v, pos), sets)
    g_kern, g_sdpa = graph_ms_turns([kern, _Rotating(
        lambda q, k, v, pos, mask: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask), sets)], inner=16)
    chunk, n_chunks = da.split_plan(DECODE_GENERATE["M"],
                                    DECODE_GENERATE["B"]
                                    * DECODE_GENERATE["Hkv"])
    results[name, "generate"].update(
        graph_ms=g_kern, library_graph_ms=g_sdpa, graph_sets=len(sets),
        graph_sdpa_factor=g_kern / g_sdpa, host_ms=_host_ms(kern),
        chunk=chunk, n_chunks=n_chunks,
        by_shape={"long_context": dict(
            _decode_timed(rng, DECODE_LONG, reps=5),
            shape={k: v for k, v in DECODE_LONG.items() if k != "pos"})})
    del sets, kern
    torch.cuda.empty_cache()


# the dequantize cases beyond the quantize pairs, each bit-exact against
# the plain version at both bit widths: (label, shape, the index of the
# slice taken from a stacked leaf or None, g, output dtype). The kernel
# works in units of one 16-byte output vector (8 elements into bf16 /
# fp16, 4 into fp32): a flat length with a tail after the last whole unit
# (6 elements), with a scale an element (g 25); g 7 into fp32 (an int4
# byte spans two groups) with a tail of 2; g 12 (a scale an element, no
# tail); g 8 into fp16 (one scale a unit); slices of stacked leaves whose
# payload starts on a unit's bytes (one scale a unit; bf16 and fp32) and
# one that does not (294 / 147 bytes in: scalar throughout)
DEQUANT_EDGE_CASES = (
    ("tail", (999, 50), None, 25, "bfloat16"),
    ("g7_fp32_tail", (41, 14), None, 7, "float32"),
    ("g12", (64, 96), None, 12, "bfloat16"),
    ("g8_fp16", (33, 64), None, 8, "float16"),
    ("slice_aligned", (3, 37, 24), 1, 8, "bfloat16"),
    ("slice_aligned_fp32", (3, 3, 100), 1, 4, "float32"),
    ("slice_unaligned_g7", (5, 21, 14), 1, 7, "bfloat16"),
)
# gpt2-125m's stacked block leaves (the quant phase's model), [n_layer, ...]
# each: every one is weight-quantized (quantize_param_tree's rule), so a
# layer's eight leaves dequantize in one launch
DEQUANT_LAYER = {
    "attn_qkv_w": (768, 2304), "attn_qkv_b": (2304,),
    "attn_out_w": (768, 768), "attn_out_b": (768,),
    "mlp_up_w": (768, 3072), "mlp_up_b": (3072,),
    "mlp_down_w": (3072, 768), "mlp_out_b": (768,)}
# rows 9-10's timed shapes: every dequantize a gpt2-125m model step makes
# at g 64 into bf16, as (label, dense shape) — the LM head's table; each
# block leaf of a layer (mlp_out_b is attn_out_b's shape); the embedding
# rows of a decode step over 8 slots (wte and wpe alike); int8 only, the
# prefill's K/V gather of one layer (`dequantize_kv`, 24 a prefill chunk)
# — then one layer's leaves in one launch ("layer") and one model step's
# dequantization ("model_step": 12 layers, the wte rows, the wpe rows and
# the head, as `_layer`, `_embed` and `_head_logits` make it)
DEQUANT_SHAPES = (("wte", (50304, 768)),
                  *((k, v) for k, v in DEQUANT_LAYER.items()
                    if k != "mlp_out_b"),
                  ("embed_rows", (8, 1, 768)),
                  ("kv_gather", (1, 12, 1024, 64)))
DEQUANT_STEP_LAUNCHES = 15       # 12 layers + wte rows + wpe rows + head


def _dequant_check(checks, label, bits, got, ref, fault=None):
    """One dequantize check: the kernel's output bit-equal to the plain
    version's. A planted fault must fail it."""
    import torch
    exact = bool(got.dtype == ref.dtype and got.shape == ref.shape
                 and torch.equal(got, ref))
    row = {"kernel": f"dequantize_int{bits}", "case": label,
           "shape": list(ref.shape), "dtype": str(ref.dtype),
           "bit_exact": exact}
    if fault:
        row.update(fault=fault, seen=not exact)
        if exact:
            raise AssertionError(f"dequantize_int{bits} {label}: the planted "
                                 f"fault {fault} passes the check")
    else:
        row["ok"] = exact
        if not exact:
            raise AssertionError(f"dequantize_int{bits} {label}: kernel != "
                                 f"plain version")
    checks.append(row)


def _dequant_fault_tail(ref):
    """The plain version's output with its last partial 16-byte vector
    (the tail after the kernel's last whole unit) left unwritten: NaN, as
    a fresh allocation may hold."""
    out = ref.clone().reshape(-1)
    tail = out.numel() % (16 // out.element_size())
    out[out.numel() - tail:] = float("nan")
    return out.view(ref.shape)


def _dequant_kernels(rng, checks):
    """dequantize_int8 / int4 beyond the quantize pairs, bit-exact against
    the plain version: at DEQUANT_EDGE_CASES one leaf a call; the same
    leaves of each output dtype in one `dequantize_many` launch (leaves of
    every mode side by side); one gpt2-125m layer's eight leaves (slices of
    [2, ...] stacked leaves, g 64, bf16) in one launch; 40 leaves, which
    take two launches. A planted fault (the tail case's last partial vector
    left unwritten) must fail the check."""
    import torch
    from deepspeed_tpu_torch.ops import quant
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES

    def leaf(shape, index, g, bits):
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
        q, s = quant.quantize_reference(x, g, bits)
        return (q, s) if index is None else (q[index], s[index])

    for bits in (8, 4):
        by_dtype = {}
        for label, shape, index, g, dtype in DEQUANT_EDGE_CASES:
            q, s = leaf(shape, index, g, bits)
            dt = getattr(torch, dtype)
            ref = quant.dequantize_reference(q, s, dt, g, bits)
            _dequant_check(checks, label, bits,
                           quant.dequantize(q, s, dt, g, bits), ref)
            if label == "tail":
                _dequant_check(checks, label, bits,
                               _dequant_fault_tail(ref), ref,
                               fault="tail_unwritten")
            by_dtype.setdefault(dtype, []).append((label, (q, s, dt, g,
                                                           bits), ref))
        layer = []
        for name, shape in DEQUANT_LAYER.items():
            q, s = leaf((2, *shape), 1, 64, bits)
            layer.append((f"layer/{name}", (q, s, torch.bfloat16, 64, bits),
                          quant.dequantize_reference(q, s, torch.bfloat16,
                                                     64, bits)))
        q40, s40 = leaf((40, 3, 64), None, 32, bits)
        many = [(f"many/{i}", (q40[i], s40[i], torch.float32, 32, bits),
                 quant.dequantize_reference(q40[i], s40[i], torch.float32,
                                            32, bits)) for i in range(40)]
        groups = [(v, 1) for v in by_dtype.values()] + [(layer, 1),
                                                        (many, 2)]
        for group, want in groups:
            before = LAUNCHES[f"dequantize_int{bits}"]
            outs = quant.dequantize_many([args for _, args, _ in group])
            launches = LAUNCHES[f"dequantize_int{bits}"] - before
            if launches != want:
                raise AssertionError(f"dequantize_many of {len(group)} "
                                     f"leaves: {launches} launches, not "
                                     f"{want}")
            for (label, _, ref), out in zip(group, outs):
                _dequant_check(checks, f"grouped/{label}", bits, out, ref)


DEQUANT_GROUP = 64


def _dequant_bytes(n, g, bits, out_size=2):
    """Bytes a dequantize of n elements must move: the payload and the
    fp32 scales read once, the output written once."""
    return n * bits // 8 + n // g * 4 + n * out_size


def _dequant_sets(gen, shape, bits):
    """{q, s} sets of one dense shape at g 64 (normals through the plain
    quantizer), enough to move NORM_COLD_BYTES between two uses of one
    set, at most 64 (the biases and the embedding rows stay in L2)."""
    import torch
    from deepspeed_tpu_torch.ops import quant
    per_set = _dequant_bytes(int(np.prod(shape)), DEQUANT_GROUP, bits)
    n_sets = int(min(64, max(1, -(-NORM_COLD_BYTES // per_set))))
    sets = []
    for _ in range(n_sets):
        q, s = quant.quantize_reference(
            torch.randn(shape, generator=gen, device="cuda"), DEQUANT_GROUP,
            bits)
        sets.append(dict(q=q, s=s))
    return sets


def _weight_tree(gen):
    """A gpt2-125m weight tree on the card: the DEQUANT_LAYER blocks of 12
    layers, wte, wpe; bf16 normals of std 0.02. Its 10 leaves are what the
    weight-only engines quantize, one launch each."""
    import torch

    def randn(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(
            torch.bfloat16)
    return {"blocks": {k: randn(12, *v) for k, v in DEQUANT_LAYER.items()},
            "wte": randn(50304, 768), "wpe": randn(1024, 768)}


def _dequant_tree(bits, gen):
    """`_weight_tree` weight-quantized as the engines quantize it
    (`quantize_param_tree`, g 64)."""
    from deepspeed_tpu_torch.inference.quantization import \
        quantize_param_tree
    return quantize_param_tree(_weight_tree(gen), bits=bits,
                               group_size=DEQUANT_GROUP)[0]


def _dequant_step(tree, tokens, positions, layer, dense):
    """One model step's dequantization over a quantized tree, as the model
    functions make it: `layer(tree, i)` for each of the 12 layers
    (`_layer`), the gathered wte and wpe rows (`_embed`) and the head's
    table (`_head_logits`), each through `dense`."""
    def step():
        return [layer(tree, i) for i in range(12)] + [
            dense(tree["wte"][tokens]), dense(tree["wpe"][positions]),
            dense(tree["wte"])]
    return step


def _dequant_row(shape, n, nbytes, n_sets, kern, copy, plain):
    """A dequantize timing: device time alone, `kern` and `copy` (the
    elementwise yardstick) captured in CUDA graphs and replayed in turns;
    eager and host time a call; the plain version; the byte bound."""
    inner = n_sets * max(1, round(20 / n_sets))
    g_kern, g_copy = graph_ms_turns([kern, copy], inner=inner)
    b_ms, b_by = bound(nbytes, n, FP32_FLOPS)
    return dict(shape=shape, group=DEQUANT_GROUP, dtype="torch.bfloat16",
                sets=n_sets, bytes=nbytes, max_abs_err=0.0,
                ms=median_ms(kern, inner=n_sets), graph_ms=g_kern,
                host_ms=_host_ms(kern), copy_ms=g_copy,
                plain_ms=median_ms(plain, reps=5, inner=n_sets),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                graph_bound_factor=g_kern / b_ms)


def _dequant_timing(bits):
    """dequantize_int{bits} timed into bf16 at g 64 at DEQUANT_SHAPES (one
    leaf a call), at "layer" (one launch for a layer's eight leaves, the 12
    layers of `_dequant_tree` in turn) and at "model_step"
    (`_dequant_step`), each by `_dequant_row`: the kernel and `q.to(bf16)`
    on the same payloads (`copy_ms`: no one library call computes the
    function) as device time in turns, inputs rotated past L2. The model
    step launches the kernel DEQUANT_STEP_LAUNCHES times."""
    import torch
    from deepspeed_tpu_torch.inference.quantization import dense
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops import quant
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    gen = torch.Generator(device="cuda").manual_seed(bits)
    bf16, g = torch.bfloat16, DEQUANT_GROUP
    rows = {}
    for label, shape in DEQUANT_SHAPES:
        if label == "kv_gather" and bits == 4:
            continue
        sets = _dequant_sets(gen, shape, bits)
        n = int(np.prod(shape))
        rows[label] = _dequant_row(
            list(shape), n, _dequant_bytes(n, g, bits), len(sets),
            _Rotating(lambda q, s: quant.dequantize(q, s, bf16, g, bits),
                      sets),
            _Rotating(lambda q, s: q.to(bf16), sets),
            _Rotating(lambda q, s: quant.dequantize_reference(
                q, s, bf16, g, bits), sets))
        del sets
    tree = _dequant_tree(bits, gen)
    blocks = tree["blocks"]
    layer_n = [int(np.prod(v)) for v in DEQUANT_LAYER.values()]
    layer_bytes = sum(_dequant_bytes(n, g, bits) for n in layer_n)
    sets = [{"i": i} for i in range(12)]
    rows["layer"] = _dequant_row(
        "8 leaves", sum(layer_n), layer_bytes, len(sets),
        _Rotating(lambda i: gpt._layer(tree, i), sets),
        _Rotating(lambda i: [blocks[k][i].q.to(bf16) for k in blocks], sets),
        _Rotating(lambda i: quant.dequantize_many_reference(
            [(blocks[k][i].q, blocks[k][i].scale, bf16, g, bits)
             for k in blocks]), sets))
    tokens = torch.randint(0, 50304, (8, 1), generator=gen, device="cuda")
    positions = torch.randint(0, 1024, (8, 1), generator=gen, device="cuda")
    step = _dequant_step(tree, tokens, positions, gpt._layer, dense)
    what = f"dequantize_int{bits}"
    before = LAUNCHES[what]
    step()
    if LAUNCHES[what] - before != DEQUANT_STEP_LAUNCHES:
        raise AssertionError(f"one model step launched {what} "
                             f"{LAUNCHES[what] - before} times, not "
                             f"{DEQUANT_STEP_LAUNCHES}")
    wte = tree["wte"]
    step_n = 12 * sum(layer_n) + 2 * 8 * 768 + 50304 * 768
    step_bytes = 12 * layer_bytes + 2 * _dequant_bytes(8 * 768, g, bits) \
        + _dequant_bytes(50304 * 768, g, bits)
    rows["model_step"] = _dequant_row(
        "12 layers, wte and wpe rows, the head", step_n, step_bytes, 1,
        _Rotating(step, [{}]),
        _Rotating(lambda: [t.q.to(bf16) for t in blocks.values()]
                  + [wte.q.to(bf16)], [{}]),
        _Rotating(lambda: [quant.dequantize_many_reference(
            [(blocks[k][i].q, blocks[k][i].scale, bf16, g, bits)
             for k in blocks]) for i in range(12)]
            + [quant.dequantize_reference(wte.q, wte.scale, bf16, g, bits)],
            [{}]))
    rows["model_step"]["launches_a_step"] = DEQUANT_STEP_LAUNCHES
    del tree, blocks, wte
    torch.cuda.empty_cache()
    return rows


def _token_sort_check(checks, label, idx, E, pos, counts):
    """One sort's output against the plain version, bit for bit."""
    import torch
    from deepspeed_tpu_torch.ops import token_sort as ts
    ref_pos, ref_counts = ts.token_sort_reference(idx, E)
    exact = bool(torch.equal(pos, ref_pos)
                 and torch.equal(counts, ref_counts))
    checks.append({"kernel": "token_sort", "case": label,
                   "n": int(idx.numel()), "experts": E,
                   "dtype": str(idx.dtype), "bit_exact": exact, "ok": exact})
    if not exact:
        raise AssertionError(f"token_sort {label}: kernel != plain version")


def _past_int32_ids(rng, n):
    """int64 ids in [0, 8) with some moved past int32: + 2^32, 2^31 + 1,
    -2^32 + 3. Each matches no expert (an int32 cast would wrap most of
    them into range)."""
    ids = rng.integers(0, 8, n).astype(np.int64)
    ids[::5] += 2 ** 32
    ids[1::7] = 2 ** 31 + 1
    ids[2::11] = -(2 ** 32) + 3
    return ids


def _token_sort_graph_replays(rng, checks, tile):
    """A CUDA graph of one sort over three tiles and one (four blocks and
    their look-back), captured once and replayed over three id sets
    copied into its input, each replay's output checked: each replay
    starts from the scratch the previous one left, so a kernel that did
    not reset it would fail here (the scratch is made before the capture,
    by the warm-up on the capture's stream)."""
    import torch
    from deepspeed_tpu_torch.ops import token_sort as ts
    E, n = 8, 3 * tile + 1
    sets = [torch.from_numpy(rng.integers(0, E, n)).to("cuda", torch.int64)
            for _ in range(3)]
    static = sets[0].clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ts.token_sort(static, E)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = ts.token_sort(static, E)
    for i, ids in enumerate(sets[1:] + sets[:1]):
        static.copy_(ids)
        graph.replay()
        torch.cuda.synchronize()
        _token_sort_check(checks, f"graph_replay_{i}", ids, E, *out)
    del graph


def _token_sort_kernel(rng, checks):
    """token_sort against its plain version, bit for bit: at the dropless
    path's shape (N 4096 = 8 x 512 tokens, E 8; int32 ids, and int64 as
    the path holds them), at E 64 and 128, at N 65 536 (sixteen tiles)
    followed straight away by another N 65 536 with other ids (a stale
    look-back word or ticket would show), at three tiles and one, at an odd
    N, with every id equal, with ids out of range and negative, from int64
    ids and from int64 ids past int32; a CUDA graph of the sort replayed
    over three id sets; then timed at the path's shape (int64 ids: the
    row; int32) and at N 65 536 as device time in CUDA graphs, in turns,
    the ids rotated over 64 sets."""
    import torch
    from deepspeed_tpu_torch.ops import token_sort as ts
    results = {}
    tile = ts.tile_tokens("cuda", 8)
    i32, i64 = torch.int32, torch.int64
    cases = (("path", rng.integers(0, 8, 4096), 8, i32),
             ("e64", rng.integers(0, 64, 4096), 64, i32),
             ("e128", rng.integers(0, 128, 4096), 128, i32),
             ("n65536", rng.integers(0, 8, 65536), 8, i32),
             ("odd_n", rng.integers(0, 8, 4097), 8, i32),
             ("all_equal", np.full(4096, 5), 8, i32),
             ("out_of_range", rng.integers(-5, 13, 4096), 8, i32),
             ("int64", rng.integers(0, 8, 3001), 8, i64),
             ("path_int64", rng.integers(0, 8, 4096), 8, i64),
             ("three_tiles_and_one", rng.integers(0, 8, 3 * tile + 1), 8,
              i32),
             ("int64_past_int32", _past_int32_ids(rng, 3 * tile + 1), 8,
              i64),
             ("all_equal_n65536", np.full(65536, 7), 8, i64),
             ("e128_n65536", rng.integers(-1, 129, 65536), 128, i32))
    for label, ids, E, dtype in cases:
        idx = torch.from_numpy(np.asarray(ids)).to("cuda", dtype)
        pos, counts = ts.token_sort(idx, E)
        if label == "n65536":
            other = torch.from_numpy(rng.integers(0, 8, 65536)).to(
                "cuda", dtype)
            back = ts.token_sort(other, E)   # no synchronize between
        torch.cuda.synchronize()
        _token_sort_check(checks, label, idx, E, pos, counts)
        if label == "n65536":
            _token_sort_check(checks, "n65536_back_to_back", other, E, *back)
    _token_sort_graph_replays(rng, checks, tile)

    def sets(n, dtype, k=64):
        return [dict(idx=torch.from_numpy(rng.integers(0, 8, n)).to(
            "cuda", dtype)) for _ in range(k)]

    def row(n, id_bytes):
        # ids in, ranks out, counts out; one compare per token and expert
        return bound(id_bytes * n + 4 * n + 4 * 8, n * 8, FP32_FLOPS)
    timed = (("path_int64", sets(4096, i64), 8), ("path_int32",
             sets(4096, i32), 4), ("n65536", sets(65536, i32), 4))
    g_ms = graph_ms_turns([_Rotating(lambda idx: ts.token_sort(idx, 8), st)
                           for _, st, _ in timed], inner=64)
    by_shape = {}
    for (label, st, id_bytes), g in zip(timed, g_ms):
        n = st[0]["idx"].numel()
        b_ms, b_by = row(n, id_bytes)
        by_shape[label] = dict(n=n, experts=8, ids=str(st[0]["idx"].dtype),
                               bound_ms=b_ms, bound_by=b_by, graph_ms=g,
                               graph_bound_factor=g / b_ms)
    idx = timed[0][1][0]["idx"]
    path = by_shape["path_int64"]
    results["token_sort", "moe_dropless"] = dict(
        shape={"n": 4096, "experts": 8, "ids": "int64"}, max_abs_err=0.0,
        ms=median_ms(lambda: ts.token_sort(idx, 8)),
        plain_ms=median_ms(lambda: ts.token_sort_reference(idx, 8)),
        bound_ms=path["bound_ms"], bound_by=path["bound_by"],
        library_ms=None, graph_ms=path["graph_ms"],
        graph_bound_factor=path["graph_bound_factor"], tile=tile,
        by_shape=by_shape)
    return results


NORM_MAIN = (4096, 768)        # the norms path's shape: [8 x 512, d_model]
# the norms' timing sweep, (case, rows, D, x dtype, residual dtype): rows
# are a step's tokens and widths the repo's model widths; scale and bias
# in x's dtype (one launch a call). gpt2-125m (NORM_MAIN), alone and with
# the residual of its blocks (the phase's own call: the warp-row kernel's
# residual add); gpt2-760m training (micro-batch 12 x seq 512);
# gpt2-6.7b / llama2-7b with a residual; llama2-70b / llama3-70b; fp32
# rows of 8192; 12288; a decode step's 16 rows; widths that are not
# multiples of 16 bytes in the dtype (fp32 1000 is; bf16 100 is not)
NORM_SWEEP = (
    ("gpt2_125m", 4096, 768, "bfloat16", None),
    ("gpt2_125m_res", 4096, 768, "bfloat16", "bfloat16"),
    ("gpt2_760m_train", 6144, 1536, "bfloat16", None),
    ("width_4096_res", 4096, 4096, "float16", "float16"),
    ("width_8192", 2048, 8192, "bfloat16", None),
    ("fp32_8192", 4096, 8192, "float32", None),
    ("width_12288", 1024, 12288, "bfloat16", None),
    ("decode_rows", 16, 4096, "bfloat16", None),
    ("ragged_1000", 37, 1000, "float32", "float32"),
    ("ragged_100", 64, 100, "bfloat16", None),
)
# a replayed CUDA graph reads inputs that fit the 50 MB L2 from L2: the
# sweep's timed calls rotate over buffer sets (`_Rotating`) so that at
# least this many bytes pass between two calls on one set. At most 32
# sets: the three launch-bound cases (decode_rows, ragged_*) move only
# 0.8-14 MB between two uses of a set, and are read from L2
NORM_COLD_BYTES = 200e6


def _norm_sets(rng, rows, D, dtype, res_dtype):
    """Input sets for one sweep case: {x, residual} sets (enough of them
    to move NORM_COLD_BYTES between two uses of one), and one scale and
    bias in x's dtype, shared as a model's are."""
    import torch
    dt = getattr(torch, dtype)
    rt = getattr(torch, res_dtype) if res_dtype else None
    out_dt = torch.promote_types(dt, rt) if rt else dt
    per_set = rows * D * (dt.itemsize + (rt.itemsize if rt else 0)
                          + out_dt.itemsize)
    n = int(min(32, max(1, -(-NORM_COLD_BYTES // per_set))))

    def randn(shape, t):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", t)
    sets = [dict(x=randn((rows, D), dt),
                 residual=randn((rows, D), rt) if rt else None)
            for _ in range(n)]
    scale = (1 + 0.1 * randn((D,), torch.float32)).to(dt)
    bias = (0.1 * randn((D,), torch.float32)).to(dt)
    return sets, scale, bias


class _Rotating:
    """fn(**sets[i]) for i = 0, 1, 2, ... in turn, holding the last
    len(sets) outputs: the inputs of a call were last read len(sets) calls
    ago, and a captured graph's pool hands an output's memory to no call
    within that distance."""

    def __init__(self, fn, sets):
        self.fn, self.sets, self.i = fn, sets, 0
        self.keep = [None] * len(sets)

    def __call__(self):
        k = self.i % len(self.sets)
        self.keep[k] = self.fn(**self.sets[k])
        self.i += 1
        return self.keep[k]


def _norm_bound(rows, D, x, res, scale, rms):
    """The sweep case's bound: x (+ residual) read once, out written once
    in the promoted dtype, scale (and bias) read once; ~8 fp32 operations
    an element at the fp32 units."""
    import torch
    out_size = (torch.promote_types(x.dtype, res.dtype) if res is not None
                else x.dtype).itemsize
    nbytes = rows * D * (x.element_size() + out_size
                         + (res.element_size() if res is not None else 0)) \
        + (1 if rms else 2) * D * scale.element_size()
    return bound(nbytes, 8 * rows * D, FP32_FLOPS)


# norms: the kernel against its plain version: within one output-dtype
# step at max|ref|, and at least this share of output elements bit-equal
# to the plain version's. Both compute the correctly rounded fp32
# statistics and round each element once, so a sound kernel reads 1.0; a
# statistic a few parts in 10^4 off (a row's last 16-byte vector left out
# of its sums at D 4096 and above) stays within the one-step tolerance in
# 16 bits but flips a few percent of the outputs
NORM_BIT_EQUAL_MIN = 0.999
# the norms' cases beyond the sweep (x bf16, no residual, scale and bias
# in x's dtype unless given): residuals of another dtype (bf16 + fp32 and
# fp16 + bf16 -> fp32 out, fp32 + fp16); fp32 parameters under bf16 x; a
# bf16 scale with an fp32 bias; the widest rows, 32768 (fp32 with a
# residual: its slots do not fit twice, direct reads); a start 2 bytes off
# 16 (masked reads); D 1; the warp kernel's widths (528-byte rows: NV 2;
# 2048 bytes, its widest) and 1032, just past it; a 3-D x
NORM_EDGE_CASES = (
    dict(rows=4096, D=768, res="float32"),
    dict(rows=512, D=4096, dtype="float16", res="bfloat16"),
    dict(rows=64, D=1000, dtype="float32", res="float16"),
    dict(rows=4096, D=768, param="float32"),
    dict(rows=256, D=1536, bias="float32"),
    dict(rows=64, D=32768),
    dict(rows=16, D=32768, dtype="float32", res="float32"),
    dict(rows=8, D=32768, dtype="float16", res="float16"),
    dict(rows=300, D=1000, offset=1),
    dict(rows=33, D=1, dtype="float32"),
    dict(rows=100, D=264, dtype="float16"),
    dict(rows=1000, D=1024),
    dict(rows=1000, D=1032, res="bfloat16"),
    dict(rows=96, D=512, lead=(4, 24)),
)
# the planted ring fault's grid: blocks walk rows b, b + NORM_FAULT_GRID, ...
NORM_FAULT_GRID = 132


def _norm_check(name, label, out, ref, checks, fault=None):
    """One norms check: max abs error within one output-dtype step at
    max|ref| (fp32: eps x max|ref|) and a bit-equal share at least
    NORM_BIT_EQUAL_MIN; appended to `checks`. A planted fault must fail
    it: raises if a fault passes or the kernel fails."""
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    tol = torch.finfo(ref.dtype).eps * ref.float().abs().max().item()
    share = (out == ref).float().mean().item()
    ok = bool(np.isfinite(err) and err <= tol and share >= NORM_BIT_EQUAL_MIN
              and out.dtype == ref.dtype and out.shape == ref.shape)
    row = {"kernel": name, "case": label, "shape": list(ref.shape),
           "dtype": str(ref.dtype), "max_abs_err": err, "tol": tol,
           "bit_equal_share": share}
    if fault:
        row.update(fault=fault, seen=not ok)
        if ok:
            raise AssertionError(f"{name} {label}: the planted fault {fault} "
                                 f"passes the check (err {err}, bit-equal "
                                 f"share {share})")
    else:
        row["ok"] = ok
        if not ok:
            raise AssertionError(f"{name} {label}: max abs err {err} (tol "
                                 f"{tol}), bit-equal share {share}, "
                                 f"{out.dtype} {tuple(out.shape)}")
    checks.append(row)
    return row


def _norm_fault_last_vector(x, scale, bias, residual, rms):
    """The plain version with the row's statistics taken without its last
    16-byte vector of the sum (its last partial one where D is not a
    multiple of it)."""
    import torch
    s = x if residual is None else x + residual
    D = s.shape[-1]
    vec = 16 // s.element_size()
    keep = D - (D % vec or vec)
    sf = s.float()
    part = sf[..., :keep].double()
    if rms:
        ms = part.square().mean(-1, keepdim=True).float()
        y = sf * (1.0 / torch.sqrt(ms + 1e-5))
        return (y * scale.float()).to(s.dtype)
    mean = part.mean(-1, keepdim=True).float()
    var = (part.float() - mean).square().double().mean(-1, keepdim=True) \
        .float()
    y = (sf - mean) * (1.0 / torch.sqrt(var + 1e-5))
    return (y * scale.float() + bias.float()).to(s.dtype)


def _norm_fault_stale_slot(plain, x, residual):
    """The plain version as a ring of two slots would give it were the
    second slot read stale: the rows a block takes in its odd turns
    (blocks walk rows b, b + NORM_FAULT_GRID, ...) normalised from the
    row it took before."""
    import torch
    src = np.arange(x.shape[0])
    src[(src // NORM_FAULT_GRID) % 2 == 1] -= NORM_FAULT_GRID
    idx = torch.from_numpy(src).to(x.device)
    return plain(x[idx], None if residual is None else residual[idx])


def _norm_edge_case(rng, rows, D, dtype="bfloat16", res=None, param=None,
                    bias=None, offset=0, lead=None):
    """x (2-D, or `lead` + [D]; `offset` elements into a flat buffer),
    residual, scale and bias for one NORM_EDGE_CASES entry."""
    import torch

    def randn(n, t):
        return torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).to("cuda", getattr(torch, t))
    shape = (*lead, D) if lead else (rows, D)
    x = randn(rows * D + offset, dtype)[offset:].view(shape)
    r = randn(rows * D, res).view(shape) if res else None
    p = param or dtype
    scale = (1 + 0.1 * randn(D, "float32")).to(getattr(torch, p))
    b = (0.1 * randn(D, "float32")).to(getattr(torch, bias or p))
    return x, r, scale, b


def _norm_kernels(rng, checks):
    """fused_layer_norm / fused_rms_norm against their plain versions
    (`_norm_check`: one output-dtype step and the bit-equal share) at
    every NORM_SWEEP case and NORM_EDGE_CASES; two planted faults that the
    check must reject: a row's last 16-byte vector left out of its
    statistics (every sweep case) and a ring's second slot read stale (the
    sweep cases whose rows take the block-row kernel, several a block).
    Then each op timed at every sweep case, its inputs rotated past L2
    where 32 sets reach NORM_COLD_BYTES (`_Rotating`): eager (`median_ms`), device time alone (CUDA graphs, in
    turns with the library call: `graph_ms`, `library_graph_ms`), the
    host's time a call (`host_ms`), the plain version (`plain_ms`) and the
    library call in turns with the kernel (`ms_turns`, `library_ms`):
    F.layer_norm / F.rms_norm, after the residual add (a second launch)
    where there is one. The row at NORM_MAIN is the main path's; each row
    carries the sweep."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import norms
    ops = (("fused_layer_norm", norms.fused_layer_norm,
            norms.layer_norm_reference),
           ("fused_rms_norm", norms.fused_rms_norm, norms.rms_norm_reference))

    def bind(name, fn, scale, bias):
        if name == "fused_rms_norm":
            return lambda x, residual: fn(x, scale, 1e-5, residual)
        return lambda x, residual: fn(x, scale, bias, 1e-5, residual)

    for i, case in enumerate(NORM_EDGE_CASES):
        x, r, scale, bias = _norm_edge_case(rng, **case)
        for name, fn, plain in ops:
            _norm_check(name, f"edge_{i}", bind(name, fn, scale, bias)(x, r),
                        bind(name, plain, scale, bias)(x, r), checks)
    results = {name: {} for name, _, _ in ops}
    for case, rows, D, dtype, res_dtype in NORM_SWEEP:
        sets, scale, bias = _norm_sets(rng, rows, D, dtype, res_dtype)
        x, r = sets[0]["x"], sets[0]["residual"]
        # rows past the warp-row kernel's widest take the block-row ring,
        # where blocks take several rows each
        ring = D * x.element_size() > norms.WARP_MAX_BYTES \
            and rows >= 2 * NORM_FAULT_GRID
        for name, fn, plain in ops:
            rms = name == "fused_rms_norm"
            call, ref_fn = bind(name, fn, scale, bias), \
                bind(name, plain, scale, bias)
            ref = ref_fn(x, r)
            err = _norm_check(name, case, call(x, r), ref, checks)
            _norm_check(name, case, _norm_fault_last_vector(
                x, scale, bias, r, rms), ref, checks, fault="last_vector")
            if ring:
                _norm_check(name, case, _norm_fault_stale_slot(ref_fn, x, r),
                            ref, checks, fault="stale_slot")
            if rms:
                lib = lambda x, residual: F.rms_norm(
                    x if residual is None else x + residual, (D,), scale,
                    1e-5)
            else:
                lib = lambda x, residual: F.layer_norm(
                    x if residual is None else x + residual, (D,), scale,
                    bias, 1e-5)
            ours, theirs = _Rotating(call, sets), _Rotating(lib, sets)
            inner = len(sets) * max(1, round(20 / len(sets)))
            g_ours, g_lib = graph_ms_turns([ours, theirs], inner=inner)
            t_ours, t_lib = median_ms_turns([ours, theirs],
                                            inner=len(sets))
            b_ms, b_by = _norm_bound(rows, D, x, r, scale, rms)
            results[name][case] = dict(
                shape=[rows, D], dtype=dtype, residual=res_dtype,
                max_abs_err=err["max_abs_err"],
                bit_equal_share=err["bit_equal_share"],
                ms=median_ms(ours, inner=len(sets)), graph_ms=g_ours,
                host_ms=_host_ms(ours), ms_turns=t_ours,
                plain_ms=median_ms(_Rotating(ref_fn, sets), reps=5,
                                   inner=len(sets)),
                bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
                library_graph_ms=g_lib, library_host_ms=_host_ms(theirs),
                graph_bound_factor=g_ours / b_ms,
                graph_library_factor=g_ours / g_lib)
            del ours, theirs
        del sets
        torch.cuda.empty_cache()
    main = NORM_SWEEP[0][0]
    return {(name, "norms"): {**rows_[main], "sweep": rows_}
            for name, rows_ in results.items()}


def _sparse_qkv(rng, B, H, T, D, dtype=None):
    """q, k, v as [B, H, T, D] views of one fused [B, T, 3 H D]
    projection, as sparse_attn_fn hands them to the kernels."""
    import torch
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(
        np.float32)).to("cuda", dtype or torch.bfloat16)
    return tuple(x.reshape(B, T, H, D).transpose(1, 2)
                 for x in qkv.split(H * D, dim=-1))


def _row_err(got, ref):
    """Worst row of ||got - ref||_2 / ||ref||_2 over the last dim; a row
    whose ||ref|| is below SPARSE_ROW_FLOOR x the RMS row norm is held
    against that floor."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    den = r.norm(dim=-1)
    floor = SPARSE_ROW_FLOOR * den.square().mean().sqrt()
    return ((g - r).norm(dim=-1) / den.clamp_min(floor)).max().item()


def _l2_err(got, ref):
    """||got - ref||_2 / ||ref||_2 over the whole tensor."""
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _max_rel(got, ref):
    """max|got - ref| / max|ref|: the flash kernels' measure, recorded
    beside the row measure."""
    return (got.float() - ref.float()).abs().max().item() \
        / ref.float().abs().max().item()


# (kernel, output) of the block-sparse kernels' results
SPARSE_OUTPUTS = (("block_sparse_attention", "out"),
                  ("block_sparse_attention_bwd_dq", "dq"),
                  ("block_sparse_attention_bwd_dq", "dbias"),
                  ("block_sparse_attention_bwd_dkv", "dk"),
                  ("block_sparse_attention_bwd_dkv", "dv"))


def _sparse_kernels_run(c, plan, saved=None):
    """({output: tensor}, out, lse) of the three kernels on c's operands
    with `plan`: the forward, then both backward passes from `saved` (out,
    lse), or from the forward's own where None."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    out, lse = bsa._launch_fwd(c["qs"], c["k"], c["v"], plan, c["bias4"],
                               c["kvb"], c["causal"])
    o, l = saved or (out, lse)
    delta = (c["do"].float() * o.float()).sum(-1).contiguous()
    dq, dk, dv, dbias = bsa._launch_bwd(
        c["qs"], c["k"], c["v"], c["do"], l, delta, plan, c["bias4"],
        c["kvb"], c["causal"], c["scale"], c["want_dbias"])
    if dbias is not None and c["bias4"].shape[0] == 1:
        dbias = dbias.sum(0, keepdim=True)
    got = {"out": out, "dq": dq, "dk": dk, "dv": dv, "dbias": dbias}
    return {k: t for k, t in got.items() if t is not None}, out, lse


def _sparse_check(rng, checks, case, q, k, v, layout, block, causal,
                  bias=None, kpm=None, bias_needs_grad=None):
    """The forward, dq and dk/dv kernels (and dbias) against their plain
    versions on the same inputs, row by row (SPARSE_ROW_TOL): the forward's
    out and lse, then both backward passes from the kernel's saved (out,
    lse). Returns the operands and references, for the timing and the
    planted faults that follow."""
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    B, H, T, D = q.shape
    plan = bsa._layout_plan(layout, H, T, block, causal)
    bias4, kvb, scale = bsa._operands(q, plan, None, bias, kpm)
    bsa.check_kernel_operands(q, k, v)
    c = dict(plan=plan, q=q, qs=(q.float() * scale).to(q.dtype), k=k, v=v,
             bias4=bias4, kvb=kvb, scale=scale, causal=causal,
             want_dbias=bias4 is not None and bias_needs_grad is not False,
             do=torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(
                 np.float32)).to("cuda", q.dtype))
    got, c["out"], c["lse"] = _sparse_kernels_run(c, plan)
    c["delta"] = (c["do"].float() * c["out"].float()).sum(-1).contiguous()
    ref_out, ref_lse = bsa._reference_fwd(c["qs"], k, v, plan, bias4, kvb,
                                          causal)
    dq, dk, dv, dbias = bsa._reference_bwd(
        c["qs"], k, v, c["out"], c["lse"], c["do"], plan, bias4, kvb, causal,
        scale, tuple(bias4.shape) if c["want_dbias"] else None)
    c["ref"] = {"out": ref_out, "dq": dq, "dk": dk, "dv": dv, "dbias": dbias}
    torch.cuda.synchronize()
    lse_err = (c["lse"] - ref_lse).abs().max().item()
    if not lse_err <= 1e-2:
        raise AssertionError(f"block_sparse_attention {case}: lse err "
                             f"{lse_err}")
    c["errs"] = {}
    for name, what in SPARSE_OUTPUTS:
        if what not in got:
            continue
        a, b = got[what], c["ref"][what]
        row = _row_err(a, b)
        err = (a.float() - b.float()).abs().max().item()
        ok = bool(np.isfinite(row) and row <= SPARSE_ROW_TOL)
        checks.append({"kernel": name, "case": case, "output": what,
                       "shape": list(q.shape), "dtype": str(q.dtype),
                       "row_err": row, "tol": SPARSE_ROW_TOL,
                       "max_abs_err": err, "max_rel_err": _max_rel(a, b),
                       "ok": ok})
        if not ok:
            raise AssertionError(f"{name} {case} {what}: worst row err {row} "
                                 f"> {SPARSE_ROW_TOL}")
        c["errs"][name] = max(c["errs"].get(name, 0.0), err)
    return c


def _drop_tile(plan, h, i, j):
    """A planted fault: a copy of `plan` whose head-h q tile i skips k tile
    j (and k tile j's transposed list skips q tile i); the fine mask still
    holds the tile's live cells."""
    import copy
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    coarse = bsa._coarse(plan.fine, plan.T, bsa.TILE, bsa.TILE)
    coarse[h, i, j] = False
    bad = copy.copy(plan)
    bad.counts, bad.idx = bsa._visit_lists(coarse)
    bad.countsT, bad.idxT = bsa._visit_lists(coarse.transpose(0, 2, 1))
    bad._device = {}
    return bad


def _sparse_faults(c, faults):
    """The kernels on plans with one tile dropped from head 0's q tile
    nbq - 2 (its first visit, a global tile, then its next-to-last, a local
    one), against c's references: the row measure must exceed
    SPARSE_ROW_TOL on every output the dropped tile feeds."""
    plan = c["plan"]
    i = plan.nbq - 2
    n = int(plan.counts[0, i])
    for fault, j in (("dropped_global_tile", int(plan.idx[0, i, 0])),
                     ("dropped_late_tile", int(plan.idx[0, i, n - 2]))):
        got, _, _ = _sparse_kernels_run(c, _drop_tile(plan, 0, i, j),
                                        saved=(c["out"], c["lse"]))
        for name, what in SPARSE_OUTPUTS:
            if what not in got:
                continue
            row = _row_err(got[what], c["ref"][what])
            rel = _max_rel(got[what], c["ref"][what])
            faults.append({"kernel": name, "fault": fault, "q_tile": i,
                           "k_tile": j, "output": what, "row_err": row,
                           "max_rel_err": rel, "seen": row > SPARSE_ROW_TOL})
            if not row > SPARSE_ROW_TOL:
                raise AssertionError(f"{name} {fault} {what}: row err {row} "
                                     f"<= {SPARSE_ROW_TOL}, the check does "
                                     f"not see a skipped tile")


def _sparse_autograd_check(checks, case, call, leaves, names, layout, block,
                           causal, kpm):
    """call(**leaves) -> out, with its gradients of sum(out^2) for `names`
    through the port's autograd (q scaling, delta, the need flags, dbias
    summed over heads and batch), against autograd through the plain
    block_sparse_attention_reference on copies of the same leaves
    (SPARSE_AUTOGRAD_TOL). Returns (the error of each output, the launch
    counts read just after the port's run)."""
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    res = {}
    for which in ("port", "plain"):
        x = {n: t.detach().clone().requires_grad_(n in names)
             for n, t in leaves.items()}
        if which == "port":
            out = call(**x)
            grads = torch.autograd.grad(out.float().square().sum(),
                                        [x[n] for n in names])
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        else:
            out, _ = bsa.block_sparse_attention_reference(
                x["q"], x["k"], x["v"], layout, block, causal=causal,
                bias=x.get("bias"), key_padding_mask=kpm)
            grads = torch.autograd.grad(out.float().square().sum(),
                                        [x[n] for n in names])
        res[which] = [out.detach()] + list(grads)
        del out, grads, x
    errs = {}
    for what, a, b in zip(["out", *names], res["port"], res["plain"]):
        err = _l2_err(a, b) if a.shape == b.shape else float("nan")
        ok = bool(np.isfinite(err) and err <= SPARSE_AUTOGRAD_TOL)
        checks.append({"kernel": "block_sparse_attention (autograd)",
                       "case": case, "output": what, "shape": list(a.shape),
                       "l2_err": err, "tol": SPARSE_AUTOGRAD_TOL,
                       "max_rel_err": _max_rel(a, b), "ok": ok})
        if not ok:
            raise AssertionError(f"{case} {what}: l2 err {err} > "
                                 f"{SPARSE_AUTOGRAD_TOL} against autograd "
                                 f"through the plain version")
        errs[what] = err
    return errs, launches


# the Fixed layout family of the kernels' cases beyond the paths (H 4, T
# 1024): tests/test_block_sparse_kernel.py:38-55's
SPARSE_FAMILY_FIXED = dict(num_heads=4, block=16, num_local_blocks=4,
                           num_global_blocks=1, attention="unidirectional")


def _sparse_cases(rng):
    """The block-sparse kernels' cases beyond the paths' shapes, as (case,
    q, k, v, layout at block 16, causal, keyword arguments of
    `_sparse_check`), drawn from `rng` as they are checked: the four layout
    families of tests/test_block_sparse_kernel.py:38-55 (H 4, T 1024;
    Variable with a layout per head); hd 128 in fp16 at T 1008 (no
    multiple of 64 or 128), also causal with per-head bias slabs and
    padding (their TMA boxes run past T on the last tiles); a bias of one
    head slab and of H slabs, with dbias and without (frozen); a
    key-padding mask that pads every key of a batch row ("all_padded_row",
    whose output must be the mean of its visited V); a batched [B, T, T]
    keep mask ("batched_mask", one more bias stride for the kernel); B * H
    above 65 535 ("bh_above_65535": B 4100, H 16, T 32, a dense causal
    layout)."""
    import torch
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    fams = [
        ("fixed", sa.FixedSparsityConfig(**SPARSE_FAMILY_FIXED), True),
        ("bigbird", sa.BigBirdSparsityConfig(num_heads=4, block=16,
                                             num_random_blocks=2,
                                             num_sliding_window_blocks=3,
                                             num_global_blocks=1), False),
        ("bslongformer", sa.BSLongformerSparsityConfig(
            num_heads=4, block=16, num_sliding_window_blocks=5,
            global_block_indices=(0, 7)), False),
        ("variable", sa.VariableSparsityConfig(
            num_heads=4, block=16, num_random_blocks=1,
            local_window_blocks=(2, 4, 8), global_block_indices=(0,),
            different_layout_per_head=True), False)]
    for name, cfg, causal in fams:
        yield (name, *_sparse_qkv(rng, 2, 4, 1024, 64), cfg.make_layout(1024),
               causal, {})
    bigbird = sa.BigBirdSparsityConfig(num_heads=4, block=16,
                                       num_random_blocks=2, seed=7,
                                       different_layout_per_head=True)
    yield ("hd128_fp16_T1008",
           *_sparse_qkv(rng, 2, 4, 1008, 128, torch.float16),
           bigbird.make_layout(1008), False, {})
    pad1008 = torch.ones(2, 1008, dtype=torch.bool, device="cuda")
    pad1008[1, -37:] = False
    q, k, v = _sparse_qkv(rng, 2, 4, 1008, 128, torch.float16)
    yield ("hd128_fp16_T1008_bias_padding", q, k, v,
           bigbird.make_layout(1008), True,
           dict(bias=torch.from_numpy((rng.standard_normal(
               (4, 1008, 1008)) * 0.5).astype(np.float32)).cuda(),
                kpm=pad1008))
    lay = sa.FixedSparsityConfig(**SPARSE_FAMILY_FIXED).make_layout(1024)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()
    kpm = torch.ones(2, 1024, dtype=torch.bool, device="cuda")
    kpm[0, -100:] = False
    for case, bias, needs, hd in (("bias_1_slab_dbias", normal(1024, 1024,
                                                                scale=0.5),
                                   None, 64),
                                  ("bias_H_slabs_dbias", normal(4, 1024, 1024,
                                                                scale=0.5),
                                   None, 128),
                                  ("bias_1_slab_frozen", normal(1024, 1024,
                                                                scale=0.5),
                                   False, 64)):
        yield (case, *_sparse_qkv(rng, 2, 4, 1024, hd), lay, True,
               dict(bias=bias, kpm=kpm, bias_needs_grad=needs))
    pad = torch.ones(2, 1024, dtype=torch.bool, device="cuda")
    pad[1] = False
    yield ("all_padded_row", *_sparse_qkv(rng, 2, 4, 1024, 64), lay, True,
           dict(kpm=pad))
    keep = torch.from_numpy(rng.random((2, 1024, 1024)) > 0.1).cuda()
    keep |= torch.eye(1024, dtype=torch.bool, device="cuda")
    q, k, v = _sparse_qkv(rng, 2, 4, 1024, 64)
    yield ("batched_mask", q, k, v, lay, False,
           dict(bias=torch.where(keep, 0.0, bsa.NEG_INF)[:, None],
                bias_needs_grad=False))
    yield ("bh_above_65535", *_sparse_qkv(rng, 4100, 16, 32, 64),
           np.ones((16, 2, 2), bool), True, {})


def _sparse_paths(rng):
    """The block-sparse kernels at their paths' shapes, as `_sparse_cases`
    yields its cases: the sparse phase's train step ("sparse_train": B 1,
    H 12, T 8192, hd 64, its Fixed layout, causal) and SparseSelfAttention
    with a learned rpe [T, T] and 100 padded keys ("sparse_op": the same,
    not causal)."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    layout = sa.FixedSparsityConfig(**SPARSE_LAYOUT).make_layout(SPARSE_SEQ)
    B, H, T, D = SPARSE_MBS, SPARSE_LAYOUT["num_heads"], SPARSE_SEQ, 64
    bias = torch.from_numpy((rng.standard_normal((T, T)) * 0.5).astype(
        np.float32)).cuda()
    kpm = torch.ones(B, T, dtype=torch.bool, device="cuda")
    kpm[:, -100:] = False
    yield ("sparse_train", *_sparse_qkv(rng, B, H, T, D), layout, True, {})
    yield ("sparse_op", *_sparse_qkv(rng, B, H, T, D), layout, False,
           dict(bias=bias, kpm=kpm))


def _bias_read_bytes(plan, bias4):
    """Bytes of the fp32 bias slabs [Bb, Hb, T, T] that the block-sparse
    kernels must read: the 64 x 64 boxes (inside T) of the tiles in the
    visit lists, each head's own where each head has a slab, their union
    over the heads where one slab serves them all; 0 without a bias."""
    if bias4 is None:
        return 0
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    H, nbq = plan.counts.shape
    tiles = np.zeros((H, nbq, plan.nbk), bool)
    hh, ii, vv = np.nonzero(np.arange(plan.idx.shape[-1])
                            < plan.counts[..., None])
    tiles[hh, ii, plan.idx[hh, ii, vv]] = True
    if bias4.shape[1] == 1:
        tiles = tiles.any(0, keepdims=True)
    span = np.minimum(bsa.TILE, plan.T - bsa.TILE * np.arange(nbq))
    cells = int((tiles * (span[:, None] * span[None, :])).sum())
    return bias4.shape[0] * cells * 4


def _block_sparse_kernels(rng, checks):
    """The block-sparse forward, dq and dk/dv kernels against their plain
    versions: at `_sparse_cases` (the all-padded row's output also against
    the mean of its visited V, and SparseSelfAttention on the batched mask
    equal to the kernel's output); through the public wrapper's autograd
    at B 2; at the paths' shapes (`_sparse_paths`). At the train path's shape
    two planted faults (a skipped tile) must fail the row measure. Then
    each kernel alone timed at the two paths' shapes, the backward pair
    against SDPA's backward three ways (`_backward_yardsticks`), and, where
    the path's bias is learned (sparse_op), the dq pass also without its
    dbias, eagerly and as device time."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    results, got = {}, {}
    for case, q, k, v, layout, causal, kw in _sparse_cases(rng):
        got[case] = _sparse_check(rng, checks, case, q, k, v, layout, 16,
                                  causal, **kw)
    del got["bh_above_65535"]
    # every key of batch row 1 padded: its rows see -1e30 on every visited
    # cell, so p = 1 there and the output is the mean of the visited V
    c = got["all_padded_row"]
    _, visited = c["plan"].token_masks(True, "cuda")
    vis = visited.float()
    mean = (vis @ c["v"][1].float()) / vis.sum(-1, keepdim=True)
    row = _row_err(c["out"][1], mean)
    ok = bool(np.isfinite(row) and row <= SPARSE_ROW_TOL)
    checks.append({"kernel": "block_sparse_attention",
                   "case": "all_padded_row_mean_of_visited_v",
                   "row_err": row, "tol": SPARSE_ROW_TOL,
                   "max_rel_err": _max_rel(c["out"][1], mean), "ok": ok})
    if not ok:
        raise AssertionError(f"all-padded row: worst row {row} from the mean "
                             f"of its visited V")
    # the batched [B, T, T] keep mask takes the kernel in SparseSelfAttention
    c = got["batched_mask"]
    fixed = sa.FixedSparsityConfig(**SPARSE_FAMILY_FIXED)
    lay = fixed.make_layout(1024)
    keep = c["bias4"][:, 0] == 0
    out = sa.SparseSelfAttention(fixed)(c["q"], c["k"], c["v"],
                                        attn_mask=keep.float())
    if not torch.equal(out, c["out"]):
        raise AssertionError("SparseSelfAttention's batched mask did not "
                             "take the kernel")

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()
    kpm = torch.ones(2, 1024, dtype=torch.bool, device="cuda")
    kpm[0, -100:] = False
    # the public wrapper and its autograd backward at B 2 with a learned
    # head-shared bias and padded keys: every input's gradient, then k and
    # v alone (no dq launch: the need flags)
    q, k, v = (x.contiguous() for x in _sparse_qkv(rng, 2, 4, 1024, 64))
    leaves = dict(q=q, k=k, v=v, bias=normal(1024, 1024, scale=0.5))
    for case, names, want in (("wrapper_all_grads", ["q", "k", "v", "bias"],
                               (1, 1, 1)),
                              ("wrapper_kv_grads", ["k", "v"], (1, 0, 1))):
        before = dict(LAUNCHES)
        _, after = _sparse_autograd_check(
            checks, case, lambda **x: bsa.block_sparse_attention(
                x["q"], x["k"], x["v"], lay, 16, causal=True, bias=x["bias"],
                key_padding_mask=kpm),
            leaves, names, lay, 16, True, kpm)
        seen = tuple(after.get(n, 0) - before.get(n, 0) for n in (
            "block_sparse_attention", "block_sparse_attention_bwd_dq",
            "block_sparse_attention_bwd_dkv"))
        if seen != want:
            raise AssertionError(f"{case}: launches {seen}, expected {want}")

    # the two paths' shapes, checked and timed
    for path, q, k, v, layout, causal, kw in _sparse_paths(rng):
        B, H, T, D = q.shape
        c = _sparse_check(rng, checks, path, q, k, v, layout, 16, causal,
                          **kw)
        if path == "sparse_train":
            _sparse_faults(c, checks)
        plan, qs, bias4, kvb = c["plan"], c["qs"], c["bias4"], c["kvb"]
        live = plan.live_cells(causal) * B
        tile = B * T * H * D * 2               # one bf16 [B, T, H, D] tensor
        rows = B * H * T * 4                   # one fp32 [B, H, T] vector
        meta = sum(a.nbytes for a in (plan.counts, plan.idx, plan.countsT,
                                      plan.idxT)) + plan.fine.size
        # the bias is read only in the boxes of the visited tiles; dbias,
        # an output, is written whole
        extra = _bias_read_bytes(plan, bias4) \
            + (kvb.numel() * 4 if kvb is not None else 0)
        dbias_bytes = bias4.numel() * 4 if c["want_dbias"] else 0
        args = (qs, k, v, plan, bias4, kvb, causal)
        bwd = (qs, k, v, c["do"], c["lse"], c["delta"], plan, bias4, kvb,
               causal, c["scale"], c["want_dbias"])

        def plain_bwd_fn():
            return bsa._reference_bwd(
                qs, k, v, c["out"], c["lse"], c["do"], plan, bias4, kvb,
                causal, c["scale"],
                tuple(bias4.shape) if c["want_dbias"] else None)
        # the plain versions' device memory above what is live here
        peak = {}
        for what, fn in (("forward", lambda: bsa._reference_fwd(*args)),
                         ("backward", plain_bwd_fn)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak[what] = torch.cuda.max_memory_allocated() - base
        plain_bwd = median_ms(plain_bwd_fn, reps=3, inner=1, warmup=1)
        # the yardstick: SDPA with the dense mask (layout, causal, padding)
        # and the bias, forward and its own backward
        live_mask, _ = plan.token_masks(causal, "cuda")
        lib_mask = torch.where(live_mask[None], 0.0, float("-inf"))
        if bias4 is not None:
            lib_mask = lib_mask + bias4
        if kvb is not None:
            lib_mask = lib_mask + kvb[:, None, None, :]
        lib_mask = lib_mask.to(q.dtype)
        sq, sk, sv = (x.contiguous().requires_grad_(True) for x in (q, k, v))
        sout = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=lib_mask,
                                              scale=c["scale"])
        sdo = c["do"].contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(sout, (sq, sk, sv), sdo,
                                               retain_graph=True)
        lib_bwd = median_ms(sdpa_bwd, reps=5)
        sdpa = lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=lib_mask, scale=c["scale"])
        for name, nbytes, flops, fn, plain, lib in (
                ("block_sparse_attention", 4 * tile + rows + meta + extra,
                 4 * D * live, lambda: bsa._launch_fwd(*args),
                 median_ms(lambda: bsa._reference_fwd(*args), reps=3,
                           inner=1, warmup=1), median_ms(sdpa, reps=5)),
                ("block_sparse_attention_bwd_dq",
                 5 * tile + 2 * rows + meta + extra + dbias_bytes,
                 6 * D * live, lambda: bsa._launch_bwd(*bwd, True, False),
                 plain_bwd, lib_bwd),
                ("block_sparse_attention_bwd_dkv",
                 6 * tile + 2 * rows + meta + extra, 8 * D * live,
                 lambda: bsa._launch_bwd(*bwd[:-1], False, False, True),
                 plain_bwd, lib_bwd)):
            b_ms, b_by = bound(nbytes, flops)
            results[name, path] = dict(
                shape=[B, H, T, D], causal=causal, live_cells=live,
                plain_peak_bytes=peak["forward" if name ==
                                      "block_sparse_attention"
                                      else "backward"],
                max_abs_err=c["errs"][name], ms=median_ms(fn, reps=9),
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib)
            if name == "block_sparse_attention":
                _forward_yardsticks(results[name, path], fn, sdpa, 5)
            else:
                results[name, path]["sdpa_factor"] = \
                    results[name, path]["ms"] / lib
        row_dq = results["block_sparse_attention_bwd_dq", path]
        if c["want_dbias"]:
            # the dq pass's cost of the learned head-shared bias's gradient
            # (its zeroing and the reductions): the same launch without it
            nodb = bwd[:-1] + (False,)
            row_dq.update(
                ms_no_dbias=median_ms(lambda: bsa._launch_bwd(
                    *nodb, True, False), reps=9),
                device_ms=_device_ms(lambda: bsa._launch_bwd(
                    *bwd, True, False))[0],
                device_ms_no_dbias=_device_ms(lambda: bsa._launch_bwd(
                    *nodb, True, False))[0])
        _backward_yardsticks(
            row_dq, results["block_sparse_attention_bwd_dkv", path],
            lambda: bsa._launch_bwd(*bwd), sdpa_bwd, sout.grad_fn.name())
        del sq, sk, sv, sout, lib_mask, live_mask
    # evaluation runs the training path's forward shape
    results["block_sparse_attention", "sparse_eval"] = \
        results["block_sparse_attention", "sparse_train"]
    return results


def _evo_case(rng, B, N, S, H, D, dtype="bfloat16", mask=True, pair=True,
              mask_shape=None, pair_shape=None, bias_dtype=None,
              fused=False):
    """q, k, v [B, N, S, H, D] (`fused`: views of one [B, N, S, 3, H, D]
    tensor) and the bias list (in `bias_dtype`, default q's): a key mask
    of -1e9 on about 10 % of keys, a normal pair bias."""
    import torch
    dtype = getattr(torch, dtype)
    bdt = getattr(torch, bias_dtype) if bias_dtype else dtype

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt)
    if fused:
        qkv = t(rng.standard_normal((B, N, S, 3, H, D)))
        q, k, v = qkv.unbind(3)
    else:
        q, k, v = (t(rng.standard_normal((B, N, S, H, D))) for _ in range(3))
    biases = []
    if mask:
        shape = mask_shape or (B, N, 1, 1, S)
        biases.append(t(np.where(rng.random(shape) < 0.1, -1e9, 0.0), bdt))
    if pair:
        biases.append(t(rng.standard_normal(pair_shape or (B, 1, H, S, S)),
                        bdt))
    return q, k, v, biases


def _evo_tol(ref, dtype):
    import torch
    return torch.finfo(dtype).eps * ref.float().abs().max().item() + EVO_ATOL


def _evo_readings(out, ref):
    """(max abs error, share of elements bit-equal) of an output against
    the plain version's."""
    err = (out.float() - ref.float()).abs().max().item()
    return err, (out == ref).float().mean().item()


def _evo_plain_fault(q, k, v, biases, fault):
    """The plain forward with one planted fault: "dropped_tile" (keys 64 ..
    127, one key tile, get p = 0) or "narrowed_p" (p narrowed to one piece
    of V's 16-bit type before P V, the row sums still in fp32, as a kernel
    without the split would)."""
    import torch
    from deepspeed_tpu_torch.ops import evoformer_attn as evo
    B, N, S, H, D = q.shape
    mask, pair = evo._parse_biases(biases, B, N, S, H)
    s = evo._scores(q, k, mask, pair, 1.0 / D ** 0.5)
    if fault == "dropped_tile":
        s[..., 64:128] = -float("inf")
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    if fault == "narrowed_p":
        p = p.to(v.dtype).float()
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p / l, v.float())
    return out.to(q.dtype)


def _evo_check(path, q, k, v, biases, out, ref):
    """The kernel's output against the plain version's on these inputs:
    finite, in q's dtype, within the one-step tolerance and, for a 16-bit
    output, at or above the bit-equal share's floor (EVO_BIT_EQUAL_MIN at a
    path's shape, EVO_EDGE_BIT_EQUAL_MIN at the others). Planted faults on
    the same inputs must fail those checks: P narrowed to one piece at
    every 16-bit case (only the share sees it), one key tile dropped at
    the paths' shapes (the tolerance sees it). Returns the check's row
    (raises only if a planted fault passes)."""
    err, share = _evo_readings(out, ref)
    tol = _evo_tol(ref, q.dtype)
    floor = EVO_BIT_EQUAL_MIN if path else \
        EVO_EDGE_BIT_EQUAL_MIN.get(str(q.dtype))
    ok = bool(np.isfinite(err) and err <= tol and out.dtype == q.dtype
              and (floor is None or share >= floor))
    faults = {}
    kinds = ("narrowed_p",) if floor else ()
    for fault in kinds + ("dropped_tile",) if path else kinds:
        f_err, f_share = _evo_readings(
            _evo_plain_fault(q, k, v, biases, fault), ref)
        faults[fault] = {"max_abs_err": f_err, "bit_equal_share": f_share}
        if not (f_err > tol if fault == "dropped_tile" else f_share < floor):
            raise AssertionError(f"planted evoformer fault {fault} at "
                                 f"{list(q.shape)} passes the checks: "
                                 f"{faults[fault]}, tol {tol}, floor {floor}")
    return {"kernel": "evoformer_attention", "shape": list(q.shape),
            "dtype": str(q.dtype),
            "biases": [[list(b.shape), str(b.dtype)] for b in biases],
            "max_abs_err": err, "tol": tol, "bit_equal_share": share,
            "bit_equal_min": floor, "faults": faults, "ok": ok}


def _evoformer_kernels(rng, checks):
    """The evoformer kernel against its plain version (`_evo_check`): at
    the evoformer phase's two shapes (bf16, mask + pair) and at
    EVO_EDGE_CASES. Then timed at the two paths' shapes: eagerly, in turns
    and as device time alone (CUDA graphs), against SDPA with the summed
    bias."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import evoformer_attn as evo
    results = {}
    cases = [(path, dict(**shape)) for path, shape in EVO_CASES.items()] \
        + [(None, dict(shape)) for shape in EVO_EDGE_CASES]
    for path, kw in cases:
        q, k, v, biases = _evo_case(rng, **kw)
        out = evo.evoformer_attention(q, k, v, biases)
        ref = evo.evoformer_attention_reference(q, k, v, biases)
        torch.cuda.synchronize()
        check = _evo_check(path, q, k, v, biases, out, ref)
        check["fused"] = bool(kw.get("fused"))
        checks.append(check)
        if not check["ok"]:
            raise AssertionError(f"evoformer_attention {check['shape']}: "
                                 f"max abs err {check['max_abs_err']} (tol "
                                 f"{check['tol']}), bit-equal share "
                                 f"{check['bit_equal_share']} (floor "
                                 f"{check['bit_equal_min']})")
        del ref
        if path is None:
            continue
        B, N, S, H, D = q.shape
        mask, pair = evo._parse_biases(biases, B, N, S, H)
        scale = 1.0 / D ** 0.5
        # q k v in, out out, mask and pair in (their dtype); the tensor
        # cores' fp32-accurate work (S once, P V once per piece of P), and
        # both products once on the fp32 units
        nbytes = 4 * q.numel() * q.element_size() \
            + mask.numel() * mask.element_size() \
            + pair.numel() * pair.element_size()
        flops = 2 * B * N * H * S * S * D
        b_ms, b_by = bound(nbytes, flops * (1 + EVO_P_PIECES))
        sq, sk, sv = (x.permute(0, 1, 3, 2, 4).reshape(B * N, H, S, D)
                      .contiguous() for x in (q, k, v))
        summed = (mask[:, :, None, None, :] + pair[:, None]) \
            .expand(B, N, H, S, S).reshape(B * N, H, S, S).contiguous()
        fn = lambda: evo._launch(q, k, v, mask, pair, scale)
        sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                      attn_mask=summed)
        row = results["evoformer_attention", path] = dict(
            shape=list(q.shape), max_abs_err=check["max_abs_err"],
            bit_equal_share=check["bit_equal_share"],
            faults=check["faults"], ms=median_ms(fn),
            plain_ms=median_ms(lambda: evo.evoformer_attention_reference(
                q, k, v, biases), reps=5),
            bound_ms=b_ms, bound_by=b_by,
            bound_fp32_units_ms=bound(nbytes, 2 * flops, FP32_FLOPS)[0],
            library_ms=median_ms(sdpa))
        _forward_yardsticks(row, fn, sdpa, 10)
        del sq, sk, sv, summed
    return results


def phase_norms(state):
    """The public norm ops as a user calls them, at [4096, 768] bf16 with
    bf16 scale and bias (LayerNorm after a residual add, RMSNorm without):
    one launch each, counted by the wrappers, and no other kernel in the
    profiler's trace of their calls (the parameters are read in their own
    dtype, with no cast); finite outputs of x's shape and dtype within one
    bf16 step of the plain versions."""
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
    kernels = {}
    for name, call in (
            ("fused_layer_norm", lambda: norms.fused_layer_norm(
                x, scale, bias, 1e-5, residual=res)),
            ("fused_rms_norm", lambda: norms.fused_rms_norm(x, scale, 1e-5))):
        # the wrapper counts its launches (one a call, above); the trace
        # shows that nothing else runs, no cast of the parameters (a long
        # run's profiler drops some events, so its counts are not exact)
        _, kernels[name] = _device_ms(call)
        if not kernels[name] or any("dstt::norms" not in k
                                    for k in kernels[name]):
            raise AssertionError(f"{name}: kernels in its calls "
                                 f"{kernels[name]}, want its own alone")
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
          "launches": counts, "kernels_a_call": kernels,
          "max_abs_err": errs})
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
    engine = init_inference(spec, config=SERVE_ENGINE_CONFIG)
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
    """ServingEngine on the generate phase's engine (built here when that
    phase did not run): 16 ragged requests through 8 slots, with telemetry
    on over the timed run; then the same trace through a serving engine
    with telemetry off, token for token."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.models.gpt import (GPT2_CONFIGS,
                                                make_gpt_decode_model)
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    cfg = GPT2_CONFIGS["gpt2-125m"]
    engine = state.get("engine")
    if engine is None:
        engine = init_inference(make_gpt_decode_model(cfg, name="gpt2-125m",
                                                      seed=0),
                                config=SERVE_ENGINE_CONFIG)
    serving = engine.serving(max_slots=8, max_context=1024)
    rng = np.random.default_rng(2)
    lens = rng.integers(100, 601, 16).tolist()
    prompts = _ragged_prompts(rng, lens, 50304)
    new = 32
    serving.run([Request(uid="warm", tokens=prompts[0], max_new_tokens=2,
                         stop_on_eos=False)])
    serving.telemetry.registry.clear()      # the timed run's latency only
    reqs = [Request(uid=i, tokens=p, max_new_tokens=new, stop_on_eos=False)
            for i, p in enumerate(prompts)]
    engine_layers = cfg.n_layer
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
    latency = _latency("serve", serving, reqs)
    off = _tokens_without_telemetry(engine, reqs, res, max_slots=8,
                                    max_context=1024)
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
          "latency": latency, "telemetry_off": off,
          "stats": serving.stats()})
    return counts


# the serving paths' engines: bf16, greedy, telemetry on (registry only)
SERVE_ENGINE_CONFIG = {"dtype": "bfloat16", "kv_cache_dtype": "bfloat16",
                       "greedy": True, "telemetry": REGISTRY_ONLY}
LATENCY_METRICS = ("ttft_ms", "tpot_ms", "queue_wait_ms", "e2e_ms")


def _latency(path, serving, reqs):
    """The timed run's latency histograms (the registry cleared after the
    warm-up request): TTFT, e2e and queue wait once a request, TPOT once a
    token after each request's first (every request runs its whole budget:
    stop_on_eos=False), and 0 < p50 <= p99 each. Returns count, p50, p90,
    p99, mean, min and max of each."""
    lat = serving.latency_snapshot()
    n = len(reqs)
    want = {"ttft_ms": n, "tpot_ms": sum(r.max_new_tokens for r in reqs) - n,
            "queue_wait_ms": n, "e2e_ms": n}
    got = {k: lat.get(k, {}).get("count") for k in LATENCY_METRICS}
    if got != want:
        raise AssertionError(f"{path} latency counts {got} != {want}")
    for k in LATENCY_METRICS:
        if not 0 < lat[k]["p50"] <= lat[k]["p99"]:
            raise AssertionError(f"{path} {k}: p50 {lat[k]['p50']} p99 "
                                 f"{lat[k]['p99']}")
    return {k: {s: lat[k][s] for s in ("count", "p50", "p90", "p99", "mean",
                                       "min", "max")}
            for k in LATENCY_METRICS}


def _tokens_without_telemetry(engine, reqs, res, **kw):
    """The trace once more (untimed) through a serving engine over the same
    engine with its telemetry block off: the tokens must equal the timed
    run's, and that engine must record nothing."""
    cfg = engine.config
    engine.config = dataclasses.replace(cfg, telemetry=None)
    try:
        serving = engine.serving(**kw)
    finally:
        engine.config = cfg
    out = serving.run(reqs)
    if serving.telemetry.enabled or serving.latency_snapshot() or \
            "latency" in serving.stats() or \
            any(r.timing is not None for r in out.values()):
        raise AssertionError("a serving engine with telemetry off recorded")
    differ = [uid for uid in res
              if not np.array_equal(res[uid].tokens, out[uid].tokens)]
    if differ:
        raise AssertionError(f"telemetry changed the tokens of {differ}")
    return {"requests": len(out), "tokens_equal": True}


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
    """dequantize launches of one model step over a quantized tree: one a
    layer for each (bits, dtype) among the quantized block leaves (`_layer`
    dequantizes a layer's leaves together), wte / wpe rows in the
    embedding, the LM-head table (wte when tied, else lm_head) once."""
    leaves = _quantized_leaves(params)
    block = len({(t.bits, t.dtype) for n, t in leaves.items()
                 if n.startswith("blocks/")})
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
    engine = init_inference(spec, config={**base,
                                          "telemetry": REGISTRY_ONLY})
    serving = engine.serving(max_slots=8, max_context=1024,
                             quantization=quantization)
    torch.cuda.synchronize()
    counts["quant_serve_build"] = dict(LAUNCHES)
    peak_build = torch.cuda.max_memory_allocated()
    n_q = serving.weight_quant_stats["quantized"]
    expect("quant_serve_build", {"quantize_int8": n_q})
    serving.run([Request(uid="warm", tokens=prompts[0], max_new_tokens=2,
                         stop_on_eos=False)])
    serving.telemetry.registry.clear()      # the timed run's latency only
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
    latency = _latency("quant serve", serving, reqs)
    # this run's model steps: prefill chunks, and decode calls of `window`
    # model steps each
    st = serving.stats()
    prefills = st["prefill_chunks"] - st0["prefill_chunks"]
    decodes = (st["decode_steps"] - st0["decode_steps"]) * serving.window
    per_step = _dequant_per_step(engine.params, L)
    want = {"paged_decode_attention_quant": L * decodes,
            "quantize_int8": L * (prefills + decodes),
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
        "agree_min": QUANT_SERVE_AGREE_MIN, "latency": latency,
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
    """bench.py's headline lane (TRAIN_CONFIG) through initialize() ->
    train_batch(): 1 warm-up step, then TRAIN_STEPS timed steps with the
    registry cleared after the warm-up, exact flash launches (the forward
    twice a layer and micro-batch: remat replays it; each backward kernel
    once), a finite falling loss, the registry's step time against this
    script's, MFU; the GEMMs of one micro-batch under TRAIN_POLICY and
    under nothing_saveable; one more step under nothing_saveable with each
    policy's peak memory; the CSV monitor's Train/loss rows; the 2-layer
    first-step parity under TRAIN_POLICY."""
    import tempfile
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS, make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    # a private config object: the nothing_saveable step below switches the
    # policy of this engine's loss by setting its field
    cfg = dataclasses.replace(GPT2_CONFIGS[TRAIN_MODEL],
                              remat_policy=TRAIN_POLICY,
                              softmax_dtype=torch.bfloat16)
    csv_dir = tempfile.TemporaryDirectory()
    config = {**TRAIN_CONFIG, "steps_per_print": 1,
              "csv_monitor": {"enabled": True, "output_path": csv_dir.name,
                              "job_name": "train"}}
    t0 = time.perf_counter()
    engine, *_ = initialize(model=make_gpt_model(cfg, name=TRAIN_MODEL,
                                                 seed=0), config=config)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_MBS * TRAIN_GAS, TRAIN_SEQ + 1))).cuda()}
    losses = [float(engine.train_batch(batch))]             # warm-up
    engine.telemetry.registry.clear()

    LAUNCHES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, overflow = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch))  # the read waits for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        overflow.append(bool(engine._last_metrics["overflow"]))
    counts = dict(LAUNCHES)
    peak = {TRAIN_POLICY: torch.cuda.max_memory_allocated()}
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
    snap = engine.telemetry.registry.snapshot()
    registry = _train_registry(snap, TRAIN_STEPS, sec)

    # the GEMMs one micro-batch dispatches (forward, backward and the
    # remat replay) under each policy, and one step under nothing_saveable
    micro = {"tokens": batch["tokens"][:TRAIN_MBS]}
    gemms = {TRAIN_POLICY: _micro_gemms(engine, micro)}
    micro_s = {TRAIN_POLICY: _micro_times(engine, micro)}
    cfg.remat_policy = "nothing_saveable"
    try:
        gemms["nothing_saveable"] = _micro_gemms(engine, micro)
        micro_s["nothing_saveable"] = _micro_times(engine, micro)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        nothing_s = time.perf_counter() - t0
        peak["nothing_saveable"] = torch.cuda.max_memory_allocated()
    finally:
        cfg.remat_policy = TRAIN_POLICY
    # the replay of a block under nothing_saveable runs its qkv, attn_out
    # and mlp_up projections (the down projection's output is needed by no
    # backward formula, and the replay stops once every saved tensor is
    # back); the headline policy keeps all four outputs
    fewer = gemms["nothing_saveable"] - gemms[TRAIN_POLICY]
    if fewer != 3 * L:
        raise AssertionError(f"GEMMs of a micro-batch {gemms}: "
                             f"{TRAIN_POLICY} saves {fewer}, not 3 x {L}")
    rows = _csv_rows(csv_dir.name, "train", "Train/loss")
    csv_dir.cleanup()
    if rows != [(i + 1, v) for i, v in enumerate(losses)]:
        raise AssertionError(f"CSV monitor Train/loss rows {rows} != the "
                             f"losses {losses}")
    parity = _train_parity(cfg)
    emit({"phase": "train", "model": TRAIN_MODEL, "n_layer": L,
          "n_params": n_params, "config": TRAIN_CONFIG, "seq": TRAIN_SEQ,
          "remat": cfg.remat_policy, "softmax_dtype": str(cfg.softmax_dtype),
          "setup_s": setup_s, "losses": losses, "step_s": step_s,
          "seconds_per_step": sec, "tokens_per_s": tokens_per_s,
          "mfu": 6 * n_params * tokens_per_s / BF16_FLOPS,
          "mfu_basis": "6 x params x tokens/s over 989e12 flop/s, the H100 "
                       "SXM dense bf16 peak from NVIDIA's data sheet",
          "registry": registry, "launches": counts,
          "gemms_per_micro_batch": gemms, "gemms_saved": fewer,
          "micro_batch_s": micro_s,
          "nothing_saveable_step_s": nothing_s, "peak_bytes": peak,
          "csv_monitor_rows": len(rows), "parity": parity})
    state.update(train_engine=engine, train_batch=batch, train_s=sec)
    return counts


def _train_registry(snap, steps, sec):
    """The engine registry's train/* readings over `steps` timed steps:
    its step-time p50 within STEP_TIME_REL_TOL of this script's median
    `sec`, tokens/s, TFLOP/s and MFU present and positive, the card's
    allocator watermarks."""
    st = snap.get("train/step_time_ms", {})
    if st.get("count") != steps:
        raise AssertionError(f"train/step_time_ms count {st.get('count')} "
                             f"!= {steps} timed steps")
    rel = abs(st["p50"] / 1e3 - sec) / sec
    if not rel <= STEP_TIME_REL_TOL:
        raise AssertionError(f"train/step_time_ms p50 {st['p50']} ms is "
                             f"{rel:.3f} off this script's {sec} s")
    out = {"step_time_ms": {k: st[k] for k in ("count", "p50", "p90", "p99",
                                               "mean", "min", "max")},
           "step_time_rel_diff": rel, "step_time_rel_tol": STEP_TIME_REL_TOL}
    from deepspeed_tpu_torch.telemetry import device_peak_flops
    keys = ["tokens_per_sec", "tflops_per_chip", "hbm_bytes_in_use",
            "hbm_peak_bytes"]
    if device_peak_flops() is not None:     # else train/mfu is left unset
        keys.append("mfu")
    for key in keys:
        value = snap.get(f"train/{key}", {}).get("value")
        if not (value is not None and value > 0):
            raise AssertionError(f"train/{key} {value} not set or not "
                                 f"positive")
        out[key] = value
    return out


def _micro_gemms(engine, micro):
    """aten.mm + aten.addmm dispatched by one micro-batch's forward and
    backward through the engine's loss (the remat replay included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Gemms(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in ("mm", "addmm"):
                self.n += 1
            return func(*args, **(kwargs or {}))

    mode = Gemms()
    with mode:
        engine._micro_grads(engine.state.params, micro)
    return mode.n


def _micro_times(engine, micro, reps=3):
    """One micro-batch's forward and backward through the engine's loss:
    the host's time to enqueue it (until the call returns), its time to
    the end of its work on the card (a synchronize after), medians of
    `reps` runs after one more, and the card's kernel time in it
    (torch.profiler, `_device_ms`). Host time near the total, and kernel
    time well below it, mean the host holds the card back."""
    import torch
    host, total = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._micro_grads(engine.state.params, micro)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append(t1 - t0)
        total.append(time.perf_counter() - t0)
    device_ms, _ = _device_ms(
        lambda: engine._micro_grads(engine.state.params, micro), calls=2,
        warmup=1)
    sec = statistics.median(total[1:])
    return {"host_s": statistics.median(host[1:]), "s": sec,
            "device_s": device_ms / 1e3, "busy": device_ms / 1e3 / sec}


def _csv_rows(out_dir, job, tag):
    """[(step, value)] of a CSV monitor's file for `tag`."""
    import csv
    import pathlib
    path = pathlib.Path(out_dir) / job / (tag.replace("/", "_") + ".csv")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["step", tag]:
        raise AssertionError(f"CSV monitor header {rows[0]}")
    return [(int(a), float(b)) for a, b in rows[1:]]


def phase_north_star(state):
    """bench.py's north-star lane (NORTH_CONFIG) on one card: gpt2-1.3b at
    full width and depth, random weights from a numpy seed, ZeRO 3, gas 64,
    through initialize() -> train_batch(): 1 warm-up step, NORTH_STEPS
    timed steps, exact flash launches, a finite loss, seconds a step,
    tokens/s and MFU, the registry's readings beside them."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS, make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    cfg = dataclasses.replace(GPT2_CONFIGS[NORTH_MODEL],
                              remat_policy=TRAIN_POLICY)
    t0 = time.perf_counter()
    engine, *_ = initialize(model=make_gpt_model(cfg, name=NORTH_MODEL,
                                                 seed=0),
                            config=NORTH_CONFIG)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (NORTH_MBS * NORTH_GAS, NORTH_SEQ + 1))).cuda()}
    losses = [float(engine.train_batch(batch))]             # warm-up
    engine.telemetry.registry.clear()
    LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(NORTH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - t0)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layer
    want = {"flash_attention": 2 * L * NORTH_GAS * NORTH_STEPS,
            "flash_attention_bwd_dq": L * NORTH_GAS * NORTH_STEPS,
            "flash_attention_bwd_dkv": L * NORTH_GAS * NORTH_STEPS}
    if counts != want:
        raise AssertionError(f"north_star launches {counts} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"north_star losses not finite: {losses}")
    n_params = tree_num_params(engine.state.params)
    sec = statistics.median(step_s)
    tokens_per_s = NORTH_MBS * NORTH_GAS * NORTH_SEQ / sec
    registry = _train_registry(engine.telemetry.registry.snapshot(),
                               NORTH_STEPS, sec)
    micro_s = _micro_times(engine, {"tokens": batch["tokens"][:NORTH_MBS]})
    emit({"phase": "north_star", "model": NORTH_MODEL, "n_layer": L,
          "n_params": n_params, "config": NORTH_CONFIG, "seq": NORTH_SEQ,
          "remat": cfg.remat_policy, "setup_s": setup_s, "losses": losses,
          "step_s": step_s, "seconds_per_step": sec,
          "tokens_per_s": tokens_per_s,
          "mfu": 6 * n_params * tokens_per_s / BF16_FLOPS,
          "mfu_basis": "6 x params x tokens/s over 989e12 flop/s",
          "registry": registry, "micro_batch_s": micro_s,
          "peak_bytes": peak, "launches": counts})
    del engine
    torch.cuda.empty_cache()
    return counts


def _train_parity(cfg, name=TRAIN_MODEL, config=TRAIN_CONFIG, seq=TRAIN_SEQ,
                  batch=2, attn_fn=None):
    """The first step's loss and every parameter's gradient at 2 layers of
    the training model (B `batch`, T `seq`, through `attn_fn` if given): the
    engine on the card in bf16 against the engine on the CPU in fp32, from
    the same (bf16-rounded) weights and batch."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import init_gpt_params, make_gpt_model
    from deepspeed_tpu_torch.utils.tree import tree_cast, tree_leaves
    small = dataclasses.replace(cfg, n_layer=2)
    params = tree_cast(tree_cast(init_gpt_params(small, seed=1),
                                 torch.bfloat16), torch.float32)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (batch, seq + 1))
    config = {**config, "train_micro_batch_size_per_gpu": batch,
              "gradient_accumulation_steps": 1}
    name = f"{name}-2-layers"
    card, *_ = initialize(model=make_gpt_model(small, name=name,
                                               params=params,
                                               attn_fn=attn_fn),
                          config=config)
    # the fp32 reference: fp32 activations and softmax (the CPU's plain
    # attention takes no other)
    cpu, *_ = initialize(
        model=make_gpt_model(dataclasses.replace(
            small, dtype=torch.float32, softmax_dtype=torch.float32),
            name=name, params=params, attn_fn=attn_fn),
        config={**config, "bf16": {"enabled": False}}, device="cpu")
    batch_t = {"tokens": torch.from_numpy(toks)}
    g_card, l_card, _ = card._grads(card.state.params, batch_t)
    g_cpu, l_cpu, _ = cpu._grads(cpu.state.params, batch_t)
    loss_err = abs(float(l_card) - float(l_cpu))
    rel = {}
    names = _leaf_names(g_cpu)
    for leaf, a, b in zip(names, tree_leaves(g_card), tree_leaves(g_cpu)):
        a = a.float().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"gradient {leaf} not finite on the card")
        rel[leaf] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    worst = max(rel, key=rel.get)
    if not loss_err <= TRAIN_LOSS_TOL or rel[worst] > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"{name} parity: loss err {loss_err} (tol "
                             f"{TRAIN_LOSS_TOL}), worst gradient {worst} "
                             f"{rel[worst]} (tol {TRAIN_GRAD_REL_TOL})")
    return {"n_layer": 2, "batch": batch, "seq": seq,
            "loss_card": float(l_card), "loss_cpu": float(l_cpu),
            "loss_abs_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
            "grad_rel_err": rel, "grad_rel_tol": TRAIN_GRAD_REL_TOL}


def phase_sparse(state):
    """GPT-2 with block-sparse attention: gpt2-125m at full width and depth
    (max_seq_len 8192), bf16, random weights from a numpy seed, through
    sparse_attn_fn with the Fixed layout of SPARSE_LAYOUT. (a) initialize
    -> train_batch: one warm-up step, then 3 timed steps, finite falling
    loss, exactly 2 x 12 x gas forward launches (forward and remat
    recompute) and 12 x gas of each backward kernel per step, no flash
    launch; (b) the spec's apply_fn on the same tokens: 12 forward launches,
    no backward launch, finite logits; (c) the first step's loss and
    gradients at 2 layers, T 2048 (SPARSE_PARITY_LAYOUT), bf16 card vs fp32
    CPU; (d) SparseSelfAttention at [1, 12, 8192, 64] with a learned rpe
    and padded keys: one launch of each kernel, the output and the q, k, v
    and rpe gradients against autograd through the plain version."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS, make_gpt_model
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, SparseSelfAttention, sparse_attn_fn)
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    cfg = dataclasses.replace(GPT2_CONFIGS[SPARSE_MODEL],
                              max_seq_len=SPARSE_SEQ)
    sparsity = FixedSparsityConfig(**SPARSE_LAYOUT)
    attn_fn = sparse_attn_fn(sparsity)
    layout = sparsity.make_layout(SPARSE_SEQ)
    plan = bsa._plan(layout, SPARSE_SEQ, sparsity.block, True)
    H, T = SPARSE_LAYOUT["num_heads"], SPARSE_SEQ
    density = {"layout": float(layout.mean()),
               "live_cells_causal": plan.live_cells(True) / (H * T * T),
               "causal": (T + 1) / (2 * T),
               "visited_tiles": float(plan.counts.sum())
               / (H * plan.nbq * plan.nbk)}
    name = f"{SPARSE_MODEL}-seq{SPARSE_SEQ}-sparse"
    t0 = time.perf_counter()
    engine, *_ = initialize(model=make_gpt_model(cfg, name=name, seed=0,
                                                 attn_fn=attn_fn),
                            config=SPARSE_TRAIN_CONFIG)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(8)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SPARSE_MBS * SPARSE_GAS, T + 1))).cuda()}
    losses = [float(engine.train_batch(batch))]             # warm-up
    LAUNCHES.clear()
    step_s = []
    for _ in range(SPARSE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - t0)
    train_counts = dict(LAUNCHES)
    L, n = cfg.n_layer, SPARSE_GAS * SPARSE_STEPS
    _expect("sparse_train", train_counts,
            {"block_sparse_attention": 2 * L * n,
             "block_sparse_attention_bwd_dq": L * n,
             "block_sparse_attention_bwd_dkv": L * n})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"sparse losses not finite and falling: "
                             f"{losses}")
    n_params = tree_num_params(engine.state.params)
    sec = statistics.median(step_s)
    tokens_per_s = SPARSE_MBS * SPARSE_GAS * T / sec

    # (b) evaluation through the spec's apply_fn, the same attn_fn
    tokens = batch["tokens"][:1, :-1]
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = engine.model_spec.apply_fn(engine.state.params, tokens)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = dict(LAUNCHES)
    _expect("sparse_eval", eval_counts, {"block_sparse_attention": L})
    if tuple(logits.shape) != (1, T, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"sparse eval logits {tuple(logits.shape)} not "
                             f"finite or misshapen")
    del logits

    # (c) 2-layer parity, bf16 card vs fp32 CPU
    parity = _train_parity(
        cfg, name=SPARSE_MODEL, config=SPARSE_TRAIN_CONFIG,
        seq=SPARSE_PARITY_SEQ, batch=1,
        attn_fn=sparse_attn_fn(FixedSparsityConfig(**SPARSE_PARITY_LAYOUT)))

    # (d) the public op with a learned rpe and padded keys: its output and
    # every gradient (q, k, v, rpe) against autograd through the plain
    # version on the same inputs
    attn = SparseSelfAttention(sparsity)
    q, k, v = (x.contiguous() for x in _sparse_qkv(rng, 1, H, T, 64))
    rpe = torch.from_numpy((rng.standard_normal((T, T)) * 0.5).astype(
        np.float32)).cuda()
    kpm = torch.ones(1, T, dtype=torch.bool, device="cuda")
    kpm[:, -100:] = False
    op_checks = []
    LAUNCHES.clear()
    _, op_counts = _sparse_autograd_check(
        op_checks, "sparse_op",
        lambda q, k, v, bias: attn(q, k, v, rpe=bias, key_padding_mask=kpm),
        dict(q=q, k=k, v=v, bias=rpe), ["q", "k", "v", "bias"], layout,
        sparsity.block, False, kpm)
    _expect("sparse_op", op_counts, {"block_sparse_attention": 1,
                                     "block_sparse_attention_bwd_dq": 1,
                                     "block_sparse_attention_bwd_dkv": 1})
    emit({"phase": "sparse", "model": SPARSE_MODEL, "n_layer": L,
          "n_params": n_params, "seq": T, "layout": SPARSE_LAYOUT,
          "density": density, "config": SPARSE_TRAIN_CONFIG,
          "remat": cfg.remat_policy if cfg.remat else None,
          "setup_s": setup_s, "losses": losses, "step_s": step_s,
          "seconds_per_step": sec, "tokens_per_s": tokens_per_s,
          "mfu": 6 * n_params * tokens_per_s / BF16_FLOPS,
          "mfu_basis": "6 x params x tokens/s over 989e12 flop/s (no "
                       "attention flops), the H100 SXM dense bf16 peak",
          "launches": train_counts, "eval": {"seconds": eval_s,
                                             "launches": eval_counts},
          "parity": parity,
          "op": {"shape": [1, H, T, 64], "launches": op_counts,
                 "checks": op_checks}})
    state.update(sparse_engine=engine, sparse_batch=batch, sparse_s=sec)
    return {"sparse_train": train_counts, "sparse_eval": eval_counts,
            "sparse_op": op_counts}


def phase_evoformer(state):
    """evoformer_attention at AlphaFold 2's Evoformer shapes (EVO_CASES),
    bf16, with a key mask and a pair bias: one kernel launch a call, the
    output against the plain version, the q, k, v, mask and pair gradients
    through the port's backward finite and against autograd through the
    plain version, and the forward and forward + backward times (the
    backward chunked, `evo.bwd_rows` rows at once)."""
    import torch
    from deepspeed_tpu_torch.ops import evoformer_attn as evo
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    rng = np.random.default_rng(9)
    report, counts = {}, {}
    for path, shape in EVO_CASES.items():
        q, k, v, biases = _evo_case(rng, **shape)
        ins = [x.requires_grad_(True) for x in (q, k, v, *biases)]
        LAUNCHES.clear()
        out = evo.evoformer_attention(*ins[:3], biases=ins[3:])
        g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
            np.float32)).to("cuda", out.dtype)
        grads = torch.autograd.grad(out, ins, g)
        torch.cuda.synchronize()
        counts[path] = dict(LAUNCHES)
        _expect(path, counts[path], {"evoformer_attention": 1})
        ref_ins = [x.detach().clone().requires_grad_(True) for x in ins]
        ref = evo.evoformer_attention_reference(*ref_ins[:3],
                                                biases=ref_ins[3:])
        ref_grads = torch.autograd.grad(ref, ref_ins, g)
        err = (out.detach().float() - ref.detach().float()).abs().max().item()
        tol = _evo_tol(ref, out.dtype)
        grad_err = {}
        for name, a, b in zip(("q", "k", "v", "mask", "pair"), grads,
                              ref_grads):
            e = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            grad_err[name] = {"max_abs_err": e, "ref_max_abs": top}
            if not (torch.isfinite(a).all() and e <= BWD_REL_TOL * top
                    and a.shape == b.shape):
                raise AssertionError(f"{path} d{name}: err {e} > "
                                     f"{BWD_REL_TOL} x {top}")
        if not err <= tol:
            raise AssertionError(f"{path}: out err {err} > {tol}")
        with torch.no_grad():
            fwd_ms = median_ms(lambda: evo.evoformer_attention(
                q, k, v, biases), reps=9)
        fb = lambda: torch.autograd.grad(
            evo.evoformer_attention(*ins[:3], biases=ins[3:]), ins, g)
        fb_ms = median_ms(fb, reps=3, inner=1, warmup=1)
        report[path] = {"shape": shape, "dtype": "bfloat16",
                        "launches": counts[path], "max_abs_err": err,
                        "tol": tol, "grads": grad_err,
                        "forward_ms": fwd_ms,
                        "forward_backward_ms": fb_ms,
                        "backward_rows": evo.bwd_rows(
                            shape["B"], shape["N"], shape["S"], shape["H"])}
    emit({"phase": "evoformer", "cases": report})
    return counts


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
    engine = init_inference(spec, config=SERVE_ENGINE_CONFIG)
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
    serving.telemetry.registry.clear()      # the timed run's latency only
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
    latency = _latency("moe serve", serving, reqs)
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
            "agree_min": SERVE_AGREE_MIN, "latency": latency,
            "stats": serving.stats()}


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
    # the layer hands the sort argmax's int64 ids, and the sort is one
    # kernel: no cast before it (the profiler's kernels of the layer's own
    # call, on its own ids). This late in the script the profiler records
    # few of the events (1 of 16 on an H100; PERF.md §5), so the kernels
    # are gathered over profiled runs of 16 calls until 16 sort launches
    # are seen
    if idx.dtype != torch.int64:
        raise AssertionError(f"dropless: token_sort got {idx.dtype} ids, "
                             f"not argmax's int64")
    sort_kernels, runs = {}, 0
    while runs < 64 and sum(v for k, v in sort_kernels.items()
                            if "token_sort_kernel" in k) < 16:
        _, seen = _device_ms(lambda: sort(idx, E), calls=16)
        for k, per_call in seen.items():
            sort_kernels[k] = sort_kernels.get(k, 0) + round(per_call * 16)
        runs += 1
    if len(sort_kernels) != 1 or any("token_sort_kernel" not in k
                                     for k in sort_kernels):
        raise AssertionError(f"dropless: the sort's kernels {sort_kernels} "
                             f"over {runs} x 16 calls, want "
                             f"token_sort_kernel alone")
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
            "launches": counts["moe_dropless"], "sort_kernels": sort_kernels,
            "sort_profiled_calls": 16 * runs,
            "expert_counts": sort_counts.tolist(), "max_abs_err": err,
            "tol": tol, "fwd_bwd_first_s": dt,
            "fwd_bwd_ms": median_ms(step, reps=5, inner=1)}


def _device_breakdown(prof, wall_s):
    """Kernel time on the card by class, from a torch.profiler run, against
    the unprofiled wall time of the same work; our attention kernels also
    one by one (ms and calls)."""
    classes = {"attention (ours)": 0.0, "quant (ours)": 0.0,
               "token sort, norms (ours)": 0.0, "matmul": 0.0,
               "optimizer (foreach)": 0.0, "other": 0.0}
    top, ours = [], {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0 or ev.device_type.name != "CUDA":
            continue
        name = ev.key
        if any(k in name for k in ("paged_decode_kernel", "flash_fwd_kernel",
                                   "flash_bwd_", "bsa_", "evo_fwd_kernel")):
            cls = "attention (ours)"
            o = ours.setdefault(name[:80], {"ms": 0.0, "calls": 0})
            o["ms"] += us / 1e3
            o["calls"] += ev.count
        elif any(k in name for k in ("quantize_kernel",
                                     "quantize_vec_kernel")):
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
            "by_class_ms": classes, "attention_kernels": ours,
            "top_kernels": [{"ms": t, "calls": c, "name": n}
                            for t, c, n in top[:8]]}


def phase_profile(state):
    """torch.profiler over one generate() call and one serving run at the
    generate/serve phases' shapes, one quantized serving run at the quant
    phase's, and one train_batch at the train, moe and sparse phases', for
    the phases that ran (opt-in: `python chip_smoke.py
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
    if "sparse_engine" in state:
        with profile(activities=acts) as prof:
            float(state["sparse_engine"].train_batch(state["sparse_batch"]))
        out["sparse_train"] = _device_breakdown(prof, state["sparse_s"])
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
         "north_star", "moe", "sparse", "evoformer"]
    dev = phase_device()
    state, launches, kern = {}, {}, {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kern = phase_kernels()
    for phase, run in (("norms", phase_norms),
                       ("generate", phase_generate), ("serve", phase_serve),
                       ("quant", phase_quant), ("train", phase_train),
                       ("north_star", phase_north_star),
                       ("moe", phase_moe), ("sparse", phase_sparse),
                       ("evoformer", phase_evoformer)):
        if phase in phases:
            counts = run(state)        # counts of each path's run; the
            # quant, moe, sparse and evoformer phases run several paths
            # each and return {path: counts}
            launches.update(counts if phase in ("quant", "moe", "sparse",
                                                "evoformer")
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
