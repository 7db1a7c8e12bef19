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
           causal; longctx / longctx16k: gpt2-760m, B 1, T 4096 / 16384,
           H 12, hd 128, causal: the forward and both backward kernels,
           the plain versions on 2 of the 12 heads at T 16384 and timed
           over the 12 two at a time, SDPA's times and device time
           beside them; routing: gpt2-760m's heads at B 12, T 256 — the
           random-LTD layers — and at the curriculum's T 128 and 320,
           forward and both backward kernels); the flash forward also at
           T 16, 48, 200, 333 and 1000
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
           and at the model zoo's paths' shapes (`_zoo_kernels`): the
           flash forward and backward at the bert lane's two shapes
           ([128, 128, 16, 64] and [16, 512, 16, 64], full attention,
           with the two planted dropped-tile faults at 512), the
           block-sparse kernels at the padded bert batch (an all-ones
           layout, the lane's ragged padding row, their two planted
           faults) and key_padded_attention with all-padded rows at T 128
           and 208, the flash forward at llama generate()'s prefill (8
           rows of 4065, 32 heads over 8 of 128, causal; the plain version
           on one row and 8 heads), the contiguous and paged decodes at
           the llama paths' shapes (4608-row cache; 512-row blocks, table
           width 8) with their two planted faults, each timed beside its
           bound, plain version and SDPA;
  norms    the public norm ops at [4096, 768] bf16 with bf16 scale and
           bias: one launch each, and no other kernel in the profiler
           (run right after build, before the kernels phase);
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
           width (d_model 2048, 16 heads of 128; 6 of its 24 layers, for
           time), random weights from a numpy seed, ZeRO 3, micro-batch 4, seq
           512, gas 64, the bf16 accumulator, the headline's remat policy,
           no master weights: 1 warm-up and 2 timed steps, exact flash
           launches, finite losses, seconds per step, tokens/s, MFU and the
           registry's readings;
  longctx  bench.py's seq-4096 lane: gpt2-760m at full width (6 of its 24
           layers, for time) with max_seq_len 4096, micro-batch 1, gas 32, loss_chunks 8,
           ZeRO 1, the headline's policy, engine config and bf16
           accumulator, telemetry on (registry only). First the chunked CE
           at its head ([4096, 1536] x [50304, 1536], 8 chunks, 5 % of the
           labels -1) in fp32 and bf16 against the plain CE in fp32 (nll,
           dx, dw beside their limits), its peak memory against the plain
           CE's (lower), its host and device time. Then 1 warm-up and 2
           timed steps: exact launches, finite falling losses, seconds a
           step, tokens/s, MFU and bench.py's mfu_attn, host against kernel
           time of a micro-batch, peak memory of the step and of a
           micro-batch with loss_chunks 8 and 0 (8 lower); the 2-layer
           first-step parity against the fp32 CPU twin (loss_chunks 0);
  longctx16k the same lane at seq 16384, gas 8: launches, finite losses,
           the readings and the peaks (no CE check, no parity);
  routing  PLD (theta 0.5, gamma 1), random-LTD (256 of 512 positions in
           layers 1-22) and the seqlen curriculum (128 -> 512) on
           gpt2-760m at full width and depth, micro-batch 12, seq 512, gas
           2, 3 steps each: the flash launches follow the kept layers the
           engine drew (PLD), every layer with layers 1-22 at T 256
           (random-LTD, plus the 2-layer parity fed the same directives),
           each step's T the difficulty (curriculum); finite losses;
  bert     bench.py's bert lane: bert-large at full width and depth (24
           layers, d_model 1024, 16 heads of 64, vocab 30528), the MLM
           spec (bf16, remat), AdamW lr 1e-4, ZeRO 0, at seq 128 / micro-
           batch 128 and seq 512 / micro-batch 16, 2 warm-up + 6 timed
           steps each: finite falling losses, exact flash launches (full
           attention: forward 2 x 24, each backward 24 a step), samples/s,
           MFU over the timed window (one sync at its end, as bench.py
           times it; steps synced one by one as a reading), host against
           kernel time of a step, the reference's V100
           samples/s beside them (labelled as the reference's); the seq-128
           engine on an HF-style attention_mask (row lengths 32-128): exact
           block-sparse launches and no flash; the 2-layer first-step
           parity without and with the mask; DeepSpeedTransformerLayer at
           bert-large's width, pre- and post-LN, with an additive [B, 1, 1,
           T] mask against its fp32 CPU twin (output and every gradient);
  llama    Llama-3-8B's width (d_model 4096, 32 heads over 8 kv heads of
           128, d_ff 14336, vocab 128256, rope_theta 5e5, untied head),
           2 of its 32 layers, bf16, from a numpy HF state dict through
           from_hf_llama: generate() on 8 prompts of 100-4065 tokens + 32
           new (exact flash and decode launches, tokens/s), the
           ServingEngine over the paged pool on those and 24 more prompts
           of 100-4065 tokens (32 requests through 8 slots, so they queue;
           a 4096-position context whose last position the longest
           request's last decode reads; exact paged-decode launches, a
           drained pool, requests/s, tokens/s, TTFT / TPOT, the served
           tokens' agreement with generate()'s choices on the same
           prefixes, and the free-running agreement as a reading), and the
           prefill / first-decode logits of a 2-layer cut against its fp32
           CPU twin, relative to the logits' std (`_logits_vs_cpu`);
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
  offload  bench.py's offload lane (bench.py:715-803): InfinityEngine on
           the nvme tier, 8 layers, d_model 256, 4 heads of 64, d_ff 1024,
           vocab 8192, B 4, T 256, in bf16 with the fp32 master on the host
           (the lane runs fp32, which the flash kernels refuse: a cut),
           three arms (lookahead 0 / landing 1, 1 / 1, 2 / 2), 1 warm-up
           each, then 4 timed steps each taken in turns (the lane runs at
           the host's pace, which drifts): bit-identical losses across the
           arms, exact flash launches (2 x 8 forward, 8 each backward a
           step), median step_ms, tokens/s, stall and landing-wait
           fractions, the host's C++ step and upload time, staging hit
           rate, write flushes, vs_baseline (blocking over async), the
           card's busy share (one profiled step) and the swap folder's
           filesystem (/proc/mounts);
  infinity initialize() of a LayeredModelSpec at gpt2-1.3b's width (d_model
           2048, 16 heads of 128, d_ff 8192, vocab 50304; 4 of its 24
           layers, for time) -> InfinityEngine: micro-batch 4, seq 1024,
           gas 2, AdamW on the host, bf16; the cpu tier, then the nvme tier
           with the moments on disk too, 1 warm-up + 2 timed steps each:
           exact launches, finite falling losses, live layers within
           lookahead + 1 and the allocator's bytes between steps equal to
           the resident leaves + lookahead + 1 layers, s/step, tokens/s, MFU,
           the host step's time, the landing wait and the busy share; then
           a 2-layer cut at that width, one step, against the port's fp32
           CPU InfinityEngine (the loss and each layer's gradient flat);
  zero_inference  init_inference() of the same weights as a
           ZeroInferenceEngine (lookahead 1) on the cpu and nvme tiers:
           generate() on 4 prompts of 100-600 tokens + 32 new (one call
           each) and the streamed ServingEngine over 16 requests through 8
           slots, tokens identical to the resident InferenceEngine and
           ServingEngine on the same card and weights, exact launches
           (flash L a prefill, decode L a step, paged decode L a step),
           tokens/s, requests/s, TTFT / TPOT, staging hits and stalls, the
           weight bytes on the card against the model's; then generate()
           at 4 and 8 layers of that width: the allocator's bytes less the
           KV cache equal resident + 2 layers at both depths, the peak
           above them and the reserved bytes flat in depth;
  zero_offload  initialize() of the same weights as the ordinary engine
           with offload_optimizer (ZeRO 3, micro-batch 4, seq 512, gas 2,
           bf16, AdamW): resident (no offload), cpu (the streamed tier),
           cpu with zero_force_ds_cpu_optimizer (the C++ host step) and
           nvme, 1 warm-up + 2 timed steps each: finite losses, exact
           launches, the streamed arm bit-identical to the resident one
           (losses, params, master, moments) and holding at least 0.9 x 12
           bytes a parameter less between steps, s/step, the host step's
           time, and each host-step arm's device peak that much below the
           streamed arm's;
  checkpoint  the train phase's engine (TRAIN_CONFIG: gpt2-760m at full
           width, micro-batch 12, seq 512, ZeRO 1, bf16) cut to 2 of 24
           layers and gas 2, with the fp32 master, fault_tolerance and
           memscope on, saving
           into a tempfile directory (its filesystem printed): the same
           step twice from one state (the spread is every later limit),
           (a) torch-engine save -> 2 steps -> load -> the same 2 steps,
           restored leaves equal to the saved ones on the card, resumed
           losses and state equal, memory_allocated before the save and
           after the load, and the load's allocator peak over the bytes
           it began with, within 64 MiB; (b) the same with the numpy
           engine; (c) a step beside an async save against one without;
           (d) the newest tag corrupted, the load walks back; (e) a
           poisoned batch, the sentinel's rollback, the continued run
           equal to a clean one; the training ledger against the state
           tensors' bytes and the plan, its predicted peak against a
           step's max_memory_allocated; each save's ms and MB/s, each
           load's ms; exact flash launches over every step;
  memscope the serve phase's configuration with telemetry.memscope on: the
           ledger's pool and params bytes equal to the tensors', exact
           paged-decode launches, tokens equal to memscope off,
           max_kv_blocks for the free memory, a refusing pre-flight with
           memory_allocated unchanged, the headroom signal engaging the
           ladder and releasing it, a real torch.OutOfMemoryError in a
           step dumped and re-raised, the int8 pool's ledger;
  router   bench.py's router lane (bench.py:1015-1109): the prefix_cache
           phase's model (8 layers, d_model 1024, 8 heads over 4 kv heads
           of 128, bf16), 16 requests (60 % share a 512-token prefix)
           through one engine, then two InProcessReplicas behind a
           ServingRouter (4 slots each): the same token count, exact
           paged-decode launches, affinity hits, the pool's tokens equal
           to generate()'s choice on the same prefixes on >= 0.9, each
           replica's TTFT, clean audits; then a prefill and a decode
           replica (disaggregated) over the bf16 and the int8 pool: every
           request handed off, each handoff's blocks (and int8 scales)
           equal to the source's after the copy, exact launches (rows 5,
           or 6, 7 and 10), both audits clean;
  robustness bench.py's robustness lane (bench.py:1112-1285): SPEC_CFG's
           model, 16 requests over a hung and a dirty replica on a
           ChaosClock, with the watchdog (completion 1.0, each request
           resolved once, the dirty replica's repairs and clean audits)
           and without it (read), then the degradation ladder under a
           flood (peak >= 2, back to 0);
  fabric   bench.py's fabric lane (bench.py:1288-1560): replica-server
           processes of the tiny engine on the card (bf16, 2 heads of
           64): 3 SIGKILL rounds over a 2-process pool (completion 1.0,
           kill-to-detection times), a SIGSTOP round (the heartbeat's
           detection time), a 1-process pool with restart budget 0 (it
           loses work), the observability plane off then on (overhead,
           pull bytes a step); every child on the card, its own
           paged-decode launches exact;
  autoscale the router lane's model and trace (the router phase's
           weights) as a burst on one in-process replica behind a
           ServingRouter, the Autoscaler ticking once a router step: the
           pool scales to 2 (the joiner warmed with the hot prefix), then
           idle ticks drain and reap it to 1; exactly one scale-up and one
           scale-down, every request completed once, the joiner's affinity
           hits > 0, served tokens equal generate()'s choice on the same
           prefix on >= 0.9, every audit clean, paged-decode launches
           exact; the pool's snapshot through `serving.top_cli` and its
           JSONL through `telemetry.cli` (both exit 0);
  zero     data-parallel ZeRO at the north-star width (gpt2-1.3b, 2 of
           24 layers, micro-batch 4, seq 512, gas 2, bf16, the bf16
           accumulator), stages 0-3, 1 + 2 steps each, over a one-rank
           NCCL process group (a TCPStore on 127.0.0.1) and again with no
           group: losses and final params bit-equal (else within the
           repeated run's spread), flash launches exact, every shard and
           state tensor on the card, the facade's calls a step as planned
           with 0 wire bytes, each stage's seconds a step beside stage
           0's; with more than one card, one rank a card (up to 4) trains
           stage 3 and the ranks' params agree bit for bit;
  profile  (opt-in, after the phases it reads) torch.profiler over the same
           generate() call, serving runs (bf16, quantized, MoE) and one
           train_batch (gpt2-760m, MoE, sparse): kernel time on the card by
           class and the card's idle share of the unprofiled wall time.
A comma-separated phase list as the one argument runs those phases only
(the device phase always runs), e.g. `build,kernels,train,north_star`
(the training lanes), `build,kernels,longctx,longctx16k,routing` (the
long-context lanes and the routing directives), `build,serve` (TTFT / TPOT), `build,train,profile`,
`build,kernels,quant`, `build,kernels,moe`, `build,kernels,sparse`,
`build,kernels,evoformer`, `build,kernels,bert,llama` (the model zoo),
`build,offload,infinity,zero_inference,zero_offload` (the offload tier;
its swap folder is `build/chip_smoke_swap/` in the checkout, removed after
each arm), `build,checkpoint,memscope` (checkpoints, rollback and the
memory ledger), `build,router,robustness,fabric` (the serving fabric; the
fabric's children load the kernel libraries the build phase made) or
`build,autoscale,zero` (the autoscaler and the CLIs; ZeRO over a process
group).
Then each phase's wall seconds, the
card's name and power limit, the `kernels` summary line (one row per
kernel and path that runs it — the flash forward has generate,
quant_generate, train, north_star, longctx, longctx16k, routing,
moe_train, bert, llama_generate, offload, infinity,
zero_inference_generate, zero_offload and checkpoint rows;
paged_decode_attention memscope, router, robustness, fabric and
autoscale rows; the flash kernels a zero row;
quantize_int8 a
quant_serve row, the K/V
writes, and a quant_serve_build row, the weights — with `launches`
counted from 0 just before that path's run and read just after, and
times at that path's shape), and as the last
line `{"ok": true, "device": {...}}`. Any failure exits non-zero
and prints no result line. It imports no JAX and nothing of deepspeed_tpu.
"""

import collections
import dataclasses
import gc
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
# gpt2-125m logits, bf16 on the card vs fp32 on the CPU, set at their std
# LOGIT_REF_STD (the fp32 prefill logits' std, PERF.md). The bf16 error
# scales with the logits (relative 2^-9 roundings of activations and of
# matmul inputs), so `_logits_vs_cpu` holds each error over the reference
# logits' own std to LOGIT_TOL / LOGIT_REF_STD: the same bound at gpt2-125m,
# and at any other head's scale (llama's untied N(0, 0.02) head, std ~1.28)
LOGIT_TOL, LOGIT_REF_STD = 6e-2, 0.554
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
# median_ms's slow calls: above this many ms a call, SLOW_REPS single calls
SLOW_CALL_MS, SLOW_REPS = 20.0, 5
# the north-star lane (bench.py:1970-1977): gpt2-1.3b (d_model 2048, 16
# heads of 128) at full width on one card, ZeRO 3 (one computation at one
# rank), micro-batch 4, seq 512, gas 64, the bf16 accumulator, the
# headline's remat policy, no master weights; 6 of its 24 layers, a cut
# for the script's time limit (at 12 layers the whole script read 1031 and
# 1049 s on slow hosts once the checkpoint and memscope phases joined;
# PERF.md §4)
NORTH_MODEL, NORTH_MBS, NORTH_SEQ, NORTH_GAS, NORTH_STEPS = \
    "gpt2-1.3b", 4, 512, 64, 2
NORTH_LAYERS = 6
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

# bench.py's two long-context lanes (bench.py:1991-2000 and :2013-2020,
# through run_lane :180-228): gpt2-760m with its position table grown to
# the sequence, micro-batch 1, loss_chunks 8, ZeRO 1, the headline's remat
# policy, engine config, bf16 accumulator and bf16 softmax (the lanes keep
# bench.py's BENCH_ACCUM_DTYPE and BENCH_SOFTMAX defaults), explicit labels
# so the model's T is the sequence; gas 32 at seq 4096, gas 8 at seq
# 16384. bench.py runs 3 warm-up and 3 timed steps; here 1 and
# LONGCTX_STEPS. Both lanes run 6 of gpt2-760m's 24 layers, a cut for the
# script's time limit (PERF.md §4).
LONGCTX_MODEL, LONGCTX_LOSS_CHUNKS, LONGCTX_STEPS = "gpt2-760m", 8, 2
LONGCTX_LAYERS = 6
LONGCTX = {"longctx": dict(seq=4096, gas=32),
           "longctx16k": dict(seq=16384, gas=8)}
# the plain flash versions materialize [B, H, T, T] fp32: at T 16384 the
# checks hold the kernels (run at all 12 heads) on 2 of them, and the plain
# version is timed over the 12 heads 2 at a time (heads are independent)
LONGCTX_REF_HEADS = {"longctx": 12, "longctx16k": 2}
# the routing phase: progressive layer drop, random-LTD and the seqlen
# curriculum on gpt2-760m at full width and depth, the headline lane's
# config at micro-batch 12, seq 512, gas 2 (gas cut from 32 to keep the
# phase short), 3 steps per directive. PLD at theta 0.5, gamma 1.0 drops
# layers from the second step on; random-LTD keeps 256 of 512 positions
# in layers 1-22; the curriculum ramps the sequence 128 -> 320 -> 512.
ROUTING_MBS, ROUTING_SEQ, ROUTING_GAS, ROUTING_STEPS = 12, 512, 2, 3
ROUTING_CONFIG = {**TRAIN_CONFIG,
                  "train_micro_batch_size_per_gpu": ROUTING_MBS,
                  "gradient_accumulation_steps": ROUTING_GAS}
ROUTING_DIRECTIVES = {
    "pld": {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                       "gamma": 1.0}},
    "random_ltd": {"data_efficiency": {"enabled": True, "data_routing": {
        "random_ltd": {"enabled": True, "total_layer_num": 24,
                       "random_ltd_layer_id": list(range(1, 23)),
                       "random_ltd_schedule": {
                           "min_value": 0.5, "max_value": 0.5,
                           "schedule_config": {"require_steps": 1,
                                               "seq_per_step": 64}}}}}},
    "curriculum": {"data_efficiency": {"enabled": True, "data_sampling": {
        "curriculum_learning": {
            "enabled": True, "curriculum_type": "fixed_linear",
            "min_difficulty": 128, "max_difficulty": 512,
            "schedule_config": {"total_curriculum_step": 2,
                                "difficulty_step": 8}}}}},
}
ROUTING_LTD_K = 256
# the flash shapes the routing phase adds to the train shape's, held to the
# plain versions in the kernels phase: the random-LTD layers at T 256 (88
# of every 96 forward launches of its run: the kernels line's `routing`
# rows are timed there) and the curriculum's T 128 and 320
ROUTING_ATTN = tuple(
    (dict(B=ROUTING_MBS, T=T, H=12, Hkv=12, D=128, causal=True), path)
    for T, path in ((ROUTING_LTD_K, "routing"), (128, None), (320, None)))
# the cost of the phases added since the long-context lanes, each estimated
# before its first run (seconds of command; printed beside each phase's own
# reading)
PHASE_ESTIMATE_S = {"longctx": 70, "longctx16k": 35, "routing": 60,
                    "bert": 90, "llama": 120}
# the chunked CE on the card at the longctx micro-batch's head: x [4096,
# 1536], the gpt2 table [50304, 1536], 8 chunks, 5 % of the labels -1,
# against the plain CE (gpt_loss's math) in fp32 on the same values. fp32:
# both sum in fp32 in other orders. bf16: the chunked op takes its logits
# in fp32 from the bf16 operands (exact products), so nll differs by sum
# order only; dx and dw pass (p - onehot) · g rounded to bf16 (2^-9) and
# are rounded to bf16 once: within 2 bf16 steps of max|ref|.
CE_N, CE_D, CE_V, CE_CHUNKS = 4096, 1536, 50304, 8
CE_TOL = {"float32": {"nll": 1e-4, "grad_rel": 1e-4},
          "bfloat16": {"nll": 1e-3, "grad_rel": 2.0 ** -7}}

# bench.py's bert lane (`run_bert_lane`, bench.py:1849-1910): bert-large at
# full width and depth (24 layers, d_model 1024, 16 heads of 64, vocab
# 30528), make_bert_model's MLM spec (bf16, remat on), AdamW lr 1e-4, ZeRO
# 0, at the reference's two headline shapes (seq, micro-batch); its batch:
# ids default_rng(0).integers(0, 30000), 15 % of the positions labelled;
# 2 warm-up and 6 timed steps a shape, as bench.py runs them
BERT_MODEL = "bert-large"
BERT_SHAPES = ((128, 128), (512, 16))
BERT_WARMUP, BERT_STEPS = 2, 6
BERT_CONFIG = {"optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
               "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
               "steps_per_print": 10**9}
# (b): the seq-128 engine on an HF-style attention_mask, each row's length
# drawn from default_rng(1) in [BERT_PAD_MIN, 128], pad id 0 and label -100
# past it, BERT_PAD_STEPS steps; the 2-layer parity cuts take its first
# BERT_PARITY_BATCH rows
BERT_PAD_MIN, BERT_PAD_STEPS, BERT_PARITY_BATCH = 32, 2, 4
# the attention of the two lane shapes: full (bidirectional), 16 heads of 64
BERT_ATTN = tuple(dict(B=mbs, T=seq, H=16, Hkv=16, D=64, causal=False)
                  for seq, mbs in BERT_SHAPES)
# (c): DeepSpeedTransformerLayer at bert-large's width, [B, T] of its input
BERT_LAYER_BT = (8, 128)
# the reference's V100 samples/s/GPU at the two shapes (bench.py:1846,
# REF_BERT_SAMPLES: the fastest-BERT post); printed beside the port's
# readings as the reference's V100 figures, never as the port's
REF_BERT_SAMPLES_V100 = {128: 272.0, 512: 52.0}

# the llama phase: Llama-3-8B's width (HF LlamaConfig of Meta-Llama-3-8B:
# d_model 4096, 32 heads over 8 kv heads of 128, d_ff 14336, vocab 128256,
# rope_theta 5e5, RMSNorm eps 1e-5, an untied head), bf16, its 32 layers
# cut to LLAMA_LAYERS (~1.5 B parameters; numpy draws the weights, and the
# whole model's 8 B would take minutes of the run), built from a numpy
# state dict in HF key names (rotate-half rows) through from_hf_llama
LLAMA_HF = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                num_attention_heads=32, num_key_value_heads=8,
                max_position_embeddings=8192, rope_theta=500000.0,
                rms_norm_eps=1e-5, tie_word_embeddings=False)
# 2 layers, for the script's time limit: at 4 the numpy draw and the HF
# adapter took 57 s of the phase's 77 (PERF.md §4)
LLAMA_LAYERS, LLAMA_PARITY_LAYERS = 2, 2
# generate(): 8 prompts of 100 to 4065 tokens, 32 new tokens each, padded
# to 4065. Serving: those 8 and 24 more drawn from default_rng(15) in [100,
# 4065], 32 new tokens each, through 8 slots of a 4096-position context, so
# requests queue and are admitted as slots free (4 waves' worth); the
# 4065-token prompt's last decode step reads position 4095 (PAGED_LONG's,
# on row 5)
LLAMA_LENS = (4065, 100, 3000, 512, 1777, 2600, 900, 3500)
LLAMA_SERVE_LENS = LLAMA_LENS + tuple(
    int(n) for n in np.random.default_rng(15).integers(100, 4066, 24))
LLAMA_NEW, LLAMA_SLOTS, LLAMA_CONTEXT = 32, 8, 4096
# the parity cut's prompts: short, as the CPU twin runs in fp32
LLAMA_PARITY_LENS = (17, 40, 64, 9)
# rows 1, 4 and 5 at the llama paths' shapes: generate()'s prefill (8 rows
# padded to 4065) and decode over its 4608-row cache (4065 + 32 rounded to
# 512-row blocks), the serving pool's decode (512-row blocks, table width
# 8); the decodes mid-generation, 16 tokens in
LLAMA_PREFILL = dict(B=8, T=max(LLAMA_LENS), H=32, Hkv=8, D=128, causal=True)
LLAMA_DECODE = dict(B=8, H=32, Hkv=8, hd=128, M=4608,
                    pos=[n + 16 for n in LLAMA_LENS])
LLAMA_PAGED = dict(B=8, H=32, Hkv=8, hd=128, bs=512, nb=8,
                   pos=[n + 16 for n in LLAMA_LENS])

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
    """Median over `reps` CUDA-event-timed runs of `inner` calls each. A
    call slower than SLOW_CALL_MS over the warm-up (the plain versions at
    the long shapes, 40-160 ms a call) is timed alone, at most SLOW_REPS
    times: the script's time limit, not its precision, sets that."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - t0) * 1e3 > SLOW_CALL_MS * max(1, warmup):
        reps, inner = min(reps, SLOW_REPS), 1
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


def _flash_fwd_row(q, k, v, causal, err, plain=None, plain_reps=None,
                   inner=20):
    """Row 1 timed at one path's shape (q [B, T, H, D], k / v [B, T, Hkv,
    D]): the kernel beside its bound, its plain version (`plain`, else the
    whole call; `plain_reps` (reps, inner, warmup) of `median_ms`) and SDPA
    (over K/V repeated to H heads where Hkv < H: the same products), then
    the factor to SDPA three ways (`_forward_yardsticks`)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kh, vh = fa._repeat_kv(kh, vh, H)
    pairs = B * H * (T * (T + 1) / 2 if causal else T * T)
    # q and out, k and v, lse
    nbytes = 2 * B * T * (H + Hkv) * D * 2 + B * H * T * 4
    b_ms, b_by = bound(nbytes, 4 * D * pairs)
    fwd = lambda: fa.flash_attention(q, k, v, causal=causal)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal)
    plain = plain or (lambda: fa.flash_attention_reference(q, k, v, causal))
    reps, p_inner, warmup = plain_reps or (15, 5, 3)
    row = dict(max_abs_err=err, ms=median_ms(fwd),
               plain_ms=median_ms(plain, reps=reps, inner=p_inner,
                                  warmup=warmup),
               bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(sdpa))
    _forward_yardsticks(row, fwd, sdpa, inner)
    return row


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
    # the offload tier's host libraries (csrc/aio, csrc/cpu_optim), g++
    libs.update({n: op_builder.build_host(n)
                 for n in ("dstpu_aio", "dstpu_cpu_optim")})
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
    # prompts padded to 600, gpt2-125m heads), the train step (gpt2-760m),
    # the north-star and MoE train steps and the routing phase's T 256,
    # 128 and 320 — then the edge cases
    cases = [(dict(B=4, T=600, H=12, Hkv=12, D=64, causal=True),
              "generate"),
             (dict(B=12, T=512, H=12, Hkv=12, D=128, causal=True), "train"),
             (NORTH_ATTN, "north_star"),
             (dict(B=8, T=512, H=12, Hkv=12, D=64, causal=True),
              "moe_train")] + [(shape, path) for shape, path in ROUTING_ATTN] \
        + [(shape, None) for shape in FLASH_EDGE_CASES]
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
        results["flash_attention", path] = _flash_fwd_row(q, k, v, causal,
                                                          err)

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
    results.update(_longctx_flash_kernels(rng, checks))
    results.update(_quant_kernels(rng, checks))
    _paged_split_kernels(rng, checks, results)
    _serving_feature_kernels(rng, checks, results)
    _fabric_rows(rng, checks, results)
    _decode_split_kernels(rng, checks, results)
    results.update(_token_sort_kernel(rng, checks))
    results.update(_norm_kernels(rng, checks))
    results.update(_block_sparse_kernels(rng, checks))
    results.update(_evoformer_kernels(rng, checks))
    results.update(_zoo_kernels(rng, checks))
    _offload_kernels(rng, checks, results)
    # the checkpoint phase runs the train rows' shapes (B 12, T 512, 12
    # heads of 128) and the memscope phase the serve phase's decode
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        results[name, "checkpoint"] = results[name, "train"]
    results["paged_decode_attention", "memscope"] = \
        results["paged_decode_attention", "serve"]
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
    training paths' shapes (gpt2-760m: H 12, hd 128, B 12, T 512;
    moe-gpt-125m-e8: H 12, hd 64, B 8, T 512; the routing phase's
    ROUTING_ATTN: gpt2-760m's heads at B 12, T 256, 128 and 320; causal),
    at hd 64 / T 600,
    at GQA 4 with a ragged T and an lse cotangent, non-causal, at GQA 4
    with a ragged T in fp16, and at BWD_EDGE_CASES. Each gradient is held
    at BWD_REL_TOL x max|ref| and row by row (`_row_err`, SPARSE_ROW_TOL);
    the forward of each case against its plain version too. At the train
    shape two planted faults (a plain backward with one 64 x 64 tile
    dropped) must exceed the row measure. Then each kernel alone timed at
    each path's shape, and the pair against SDPA's backward three ways
    (`_backward_yardsticks`)."""
    results = {}
    for shape, path, with_dlse in (
            (dict(B=12, T=512, H=12, Hkv=12, D=128, causal=True), "train",
             False),
            (NORTH_ATTN, "north_star", False),
            (dict(B=8, T=512, H=12, Hkv=12, D=64, causal=True), "moe_train",
             False),
            *((shape, path, False) for shape, path in ROUTING_ATTN),
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
        if path is not None:
            results.update(_flash_bwd_rows(path, q, k, v, do, out, lse, errs,
                                           shape["causal"]))
    return results


def _flash_bwd_rows(path, q, k, v, do, out, lse, errs, causal):
    """The dq and dk/dv kernels alone timed at one path's shape (MHA; q, k,
    v, do, out [B, T, H, D] from `_backward_case`), each beside its bound,
    the plain backward and SDPA's backward over one SDPA forward, and the
    pair against SDPA's backward three ways (`_backward_yardsticks`):
    {(kernel, path): row}."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    results = {}
    B, T, H, D = q.shape
    qh, kh, vh, doh = (x.detach().transpose(1, 2) for x in (q, k, v, do))
    oh = out.detach().transpose(1, 2)
    lse_d = lse.detach()
    delta = (doh.float() * oh.float()).sum(-1).contiguous()
    sm = 1.0 / D ** 0.5
    pairs = B * H * (T * (T + 1) / 2 if causal else T * T)
    plain_ms = median_ms(lambda: fa.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), out.detach(), lse_d, do,
        None, causal), reps=5, inner=1)
    # the yardstick: SDPA's own backward over one SDPA forward
    sq, sk, sv = (x.contiguous().requires_grad_(True) for x in (qh, kh, vh))
    sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
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
                qh, kh, vh, doh, lse_d, delta, sm, causal, *need)),
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms)
    _backward_yardsticks(
        results["flash_attention_bwd_dq", path],
        results["flash_attention_bwd_dkv", path],
        lambda: fa._launch_bwd(qh, kh, vh, doh, lse_d, delta, sm, causal,
                               True, True),
        sdpa, sout.grad_fn.name())
    return results


def _longctx_flash_kernels(rng, checks):
    """Rows 1-3 at the long-context lanes' shapes ([1, 12, T, 128], causal,
    bf16, T 4096 and 16384): the forward, dq and dk/dv through the autograd
    path against the plain versions on the kernel's saved (out, lse), on
    LONGCTX_REF_HEADS of the 12 heads, with the train shape's tolerances
    (TOL, lse 1e-2, BWD_REL_TOL x max|ref| and row by row SPARSE_ROW_TOL);
    then each timed at all 12 heads beside its bound, the plain version and
    SDPA, and as device time (the forward as a CUDA graph, the backward
    kernels and SDPA's backward in the profiler)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as fa
    results = {}
    for path, lane in LONGCTX.items():
        T, hr = lane["seq"], LONGCTX_REF_HEADS[path]
        shape = dict(B=1, T=T, H=12, Hkv=12, D=128, causal=True)
        q, k, v, _ = _flash_case(rng, **shape)
        for t in (q, k, v):
            t.requires_grad_(True)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        do = torch.randn_like(out)
        grads = torch.autograd.grad(out, (q, k, v), do)
        qd, kd, vd, od = (x.detach() for x in (q, k, v, out))
        heads = lambda x: x[:, :, :hr]                  # BTHD
        ref_out, ref_lse = fa.flash_attention_reference(
            heads(qd), heads(kd), heads(vd), True)
        ref = fa.flash_attention_bwd_reference(
            heads(qd), heads(kd), heads(vd), heads(od), lse[:, :hr].detach(),
            heads(do), None, True)
        torch.cuda.synchronize()
        fwd_err = (heads(od).float() - ref_out.float()).abs().max().item()
        lse_err = (lse[:, :hr].detach() - ref_lse).abs().max().item()
        ok = fwd_err <= TOL["flash_attention"] and lse_err <= 1e-2
        checks.append({"kernel": "flash_attention", "shape": shape,
                       "ref_heads": hr, "max_abs_err": fwd_err,
                       "lse_err": lse_err, "tol": TOL["flash_attention"],
                       "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"flash forward {shape}: out err {fwd_err}"
                                 f", lse err {lse_err}")
        errs = {"flash_attention": fwd_err}
        for name, idx in (("flash_attention_bwd_dq", (0,)),
                          ("flash_attention_bwd_dkv", (1, 2))):
            err = max((heads(grads[i]).float() - ref[i].float()).abs().max()
                      .item() for i in idx)
            scale = max(ref[i].float().abs().max().item() for i in idx)
            row = max(_row_err(heads(grads[i]), ref[i]) for i in idx)
            ok = bool(np.isfinite(err) and err <= BWD_REL_TOL * scale
                      and np.isfinite(row) and row <= SPARSE_ROW_TOL)
            checks.append({"kernel": name, "shape": shape, "ref_heads": hr,
                           "max_abs_err": err, "ref_max_abs": scale,
                           "tol": BWD_REL_TOL * scale, "row_err": row,
                           "row_tol": SPARSE_ROW_TOL, "ok": ok})
            if not ok:
                raise AssertionError(f"{name} {shape}: max abs err {err} > "
                                     f"{BWD_REL_TOL} x {scale} or worst row "
                                     f"err {row} > {SPARSE_ROW_TOL}")
            errs[name] = err
        del ref, ref_out, ref_lse
        torch.cuda.empty_cache()

        B, H, D = 1, 12, 128
        qh, kh, vh, doh = (x.detach().transpose(1, 2) for x in (q, k, v, do))
        lse_d = lse.detach()
        delta = (doh.float() * od.transpose(1, 2).float()).sum(-1) \
            .contiguous()
        sm = 1.0 / D ** 0.5
        pairs = B * H * T * (T + 1) / 2
        tile = B * T * H * D * 2
        rows = B * H * T * 4
        slices = [slice(h, h + hr) for h in range(0, H, hr)]

        def plain_fwd():
            for s_ in slices:
                fa.flash_attention_reference(qd[:, :, s_], kd[:, :, s_],
                                             vd[:, :, s_], True)

        def plain_bwd():
            for s_ in slices:
                fa.flash_attention_bwd_reference(
                    qd[:, :, s_], kd[:, :, s_], vd[:, :, s_], od[:, :, s_],
                    lse_d[:, s_], do[:, :, s_], None, True)
        fwd = lambda: fa.flash_attention(qd, kd, vd)
        sq, sk, sv = (x.contiguous() for x in (qh, kh, vh))
        sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                      is_causal=True)
        b_ms, b_by = bound(4 * tile + rows, 4 * D * pairs)
        results["flash_attention", path] = dict(
            max_abs_err=errs["flash_attention"], ms=median_ms(fwd),
            plain_ms=median_ms(plain_fwd, reps=3, inner=1, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=median_ms(sdpa),
            graph_ms=graph_ms(fwd, inner=5), library_graph_ms=graph_ms(
                sdpa, inner=5), plain_heads_a_call=hr)
        gq, gk, gv = (x.requires_grad_(True) for x in (sq.clone(),
                                                       sk.clone(),
                                                       sv.clone()))
        gout = F.scaled_dot_product_attention(gq, gk, gv, is_causal=True)
        gdo = doh.contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(gout, (gq, gk, gv), gdo,
                                               retain_graph=True)
        library_ms = median_ms(sdpa_bwd)
        library_dev, _ = _device_ms(sdpa_bwd, calls=5)
        plain_ms = median_ms(plain_bwd, reps=3, inner=1, warmup=1)
        for name, need, flops, nbytes in (
                ("flash_attention_bwd_dq", (True, False), 6 * D * pairs,
                 5 * tile + 2 * rows),
                ("flash_attention_bwd_dkv", (False, True), 8 * D * pairs,
                 6 * tile + 2 * rows)):
            b_ms, b_by = bound(nbytes, flops)
            kern = lambda: fa._launch_bwd(qh, kh, vh, doh, lse_d, delta, sm,
                                          True, *need)
            dev, _ = _device_ms(kern, calls=5)
            results[name, path] = dict(
                max_abs_err=errs[name], ms=median_ms(kern),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, device_ms=dev,
                library_device_ms=library_dev, plain_heads_a_call=hr,
                library="SDPA backward (dq, dk, dv together)")
        del q, k, v, out, lse, do, grads, gout
        torch.cuda.empty_cache()
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
    errs = {"flash_attention": fwd_err}
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
    # after many sessions the profiler can record none of a session's
    # device events: such a session is taken again, up to
    # NORM_TRACE_SESSIONS times, as the norms phase's trace check does
    for _ in range(NORM_TRACE_SESSIONS):
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
        if us > 0:
            return us / 1e3 / calls, kernels
    raise RuntimeError(f"_device_ms: {NORM_TRACE_SESSIONS} profiler sessions "
                       f"recorded no device event")


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
        _sparse_path_rows(rng, checks, results, path, q, k, v, layout,
                          causal, kw, faults=path == "sparse_train")
    # evaluation runs the training path's forward shape
    results["block_sparse_attention", "sparse_eval"] = \
        results["block_sparse_attention", "sparse_train"]
    return results


def _sparse_path_rows(rng, checks, results, path, q, k, v, layout, causal,
                      kw, faults=False):
    """One path's shape of the block-sparse kernels: `_sparse_check`, the
    two planted faults where `faults`, then each kernel alone timed beside
    its bound, its plain version and SDPA with the dense mask (the layout,
    causality, padding and bias), the backward pair against SDPA's backward
    three ways (`_backward_yardsticks`), and, where the path's bias is
    learned, the dq pass also without its dbias. Adds the path's three rows
    to `results`."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    B, H, T, D = q.shape
    c = _sparse_check(rng, checks, path, q, k, v, layout, 16, causal,
                      **kw)
    if faults:
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
    return c


def _bert_lens(seq, mbs):
    """The padded bert batch's row lengths: default_rng(1) in
    [BERT_PAD_MIN, seq]."""
    return np.random.default_rng(1).integers(BERT_PAD_MIN, seq + 1, mbs)


def _zoo_kernels(rng, checks):
    """The kernels at the model zoo's paths' shapes: rows 1-3 at the
    two bert lane shapes (BERT_ATTN, full attention; the 512 shape's
    readings under the `bert` rows' `seq512`), with the two planted
    dropped-tile faults at seq 512; rows 15-17 at the padded bert batch
    ([128, 16, 128, 64], an all-ones layout, the lane's ragged padding row)
    with their two planted faults, and `key_padded_attention` with a row
    whose keys are all padded at T 128 and 208 (the mean of V over all T
    keys); rows 1, 4 and 5 at the llama paths' shapes (LLAMA_PREFILL, the
    plain forward on one batch row and 8 of the 32 query heads;
    LLAMA_DECODE; LLAMA_PAGED), rows 4 and 5 with their two planted
    faults. Each timed beside its bound, plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import flash_attention as fa
    results = {}
    for shape in BERT_ATTN:
        q, k, v, do, out, lse, ref, errs, bwd_args = _backward_case(
            rng, checks, shape, False)
        if shape["T"] == 512:
            _flash_faults(checks, bwd_args, ref, shape["T"] // 64)
        rows = _flash_bwd_rows("bert", q, k, v, do, out, lse, errs, False)
        rows["flash_attention", "bert"] = _flash_fwd_row(
            q.detach(), k.detach(), v.detach(), False,
            errs["flash_attention"])
        for key, row in rows.items():
            row["shape"] = [shape[n] for n in ("B", "T", "H", "D")]
            if shape["T"] == 128:
                results[key] = row
            else:
                results[key]["seq512"] = row
        del q, k, v, do, out, lse, ref, bwd_args
        torch.cuda.empty_cache()

    # rows 15-17 at the padded bert batch
    seq, mbs = BERT_SHAPES[0]
    kpm = torch.from_numpy(np.arange(seq)[None]
                           < _bert_lens(seq, mbs)[:, None]).cuda()
    q, k, v = _sparse_qkv(rng, mbs, 16, seq, 64)
    _sparse_path_rows(rng, checks, results, "bert_padded", q, k, v,
                      np.ones((16, seq // 16, seq // 16), bool), False,
                      dict(kpm=kpm), faults=True)
    del q, k, v
    for T in (128, 208):
        q, k, v = _sparse_qkv(rng, 2, 4, T, 64)
        pad = torch.zeros(2, T, device="cuda")
        pad[0, T // 2:] = bsa.NEG_INF
        pad[1] = bsa.NEG_INF
        out = bsa.key_padded_attention(q, k, v, pad)
        ref, _ = bsa.block_sparse_attention_reference(
            q, k, v, np.ones((4, T // 16, T // 16), bool),
            key_padding_mask=pad == 0)
        mean = v[1].float().mean(1, keepdim=True).expand_as(v[1])
        errs = {"plain": _row_err(out, ref),
                "mean_of_v": _row_err(out[1], mean)}
        ok = all(np.isfinite(e) and e <= SPARSE_ROW_TOL
                 for e in errs.values())
        checks.append({"kernel": "block_sparse_attention",
                       "case": f"key_padded_all_padded_row_T{T}",
                       "row_err": errs, "tol": SPARSE_ROW_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"key_padded_attention T {T}: {errs}")

    # row 1 at llama generate()'s prefill: the plain version (fp32 scores
    # of [B, H, T, T]) on batch row 0 and query heads 0-7 (kv heads 0-1)
    q, k, v, _ = _flash_case(rng, **LLAMA_PREFILL)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_reference(
        q[:1, :, :8], k[:1, :, :2], v[:1, :, :2], True)
    torch.cuda.synchronize()
    err = (out[:1, :, :8].float() - ref.float()).abs().max().item()
    lse_err = (lse[:1, :8] - ref_lse).abs().max().item()
    ok = bool(err <= TOL["flash_attention"] and lse_err <= 1e-2)
    checks.append({"kernel": "flash_attention", "shape": LLAMA_PREFILL,
                   "ref_batch_rows": 1, "ref_heads": 8, "max_abs_err": err,
                   "lse_err": lse_err, "tol": TOL["flash_attention"],
                   "ok": ok})
    if not ok:
        raise AssertionError(f"flash forward {LLAMA_PREFILL}: out err {err}"
                             f", lse err {lse_err}")
    del out, lse, ref, ref_lse

    def plain_prefill():
        for b in range(q.shape[0]):
            for h in range(0, 32, 8):
                fa.flash_attention_reference(
                    q[b:b + 1, :, h:h + 8], k[b:b + 1, :, h // 4:h // 4 + 2],
                    v[b:b + 1, :, h // 4:h // 4 + 2], True)
    results["flash_attention", "llama_generate"] = dict(
        _flash_fwd_row(q, k, v, True, err, plain=plain_prefill,
                       plain_reps=(3, 1, 1), inner=5),
        plain_slices="one batch row and 8 query heads a call")
    del q, k, v
    torch.cuda.empty_cache()

    # row 4 at llama generate()'s decode
    kw = _decode_args(rng, LLAMA_DECODE)
    out, ref = da.decode_attention(**kw), da.decode_attention_reference(**kw)
    torch.cuda.synchronize()
    err = _paged_check(checks, "decode_attention", "llama_generate", out,
                       ref)
    for fault in ("dropped_last_chunk", "stale_partial"):
        _paged_check(checks, "decode_attention", "llama_generate",
                     _paged_fault(_decode_as_paged(kw), fault), ref,
                     fault=fault)
    mask = (torch.arange(LLAMA_DECODE["M"], device="cuda")[None, :]
            <= kw["pos"][:, None].long())[:, None, None, :]
    b_ms, b_by = _decode_bound(LLAMA_DECODE)
    results["decode_attention", "llama_generate"] = dict(
        max_abs_err=err, ms=median_ms(lambda: da.decode_attention(**kw)),
        plain_ms=median_ms(lambda: da.decode_attention_reference(**kw)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            kw["q"][:, :, None], kw["k"], kw["v"], attn_mask=mask,
            enable_gqa=True)),
        **{f"timed_{n}": x for n, x in _decode_timed(
            rng, LLAMA_DECODE, reps=5).items()})

    # row 5 at the llama serving pool's decode
    name, fn, plain = _paged_fns(LLAMA_PAGED)
    kw, pkw = _paged_args(rng, LLAMA_PAGED)
    ref = plain(**pkw)
    err = _paged_check(checks, name, "llama_serve", fn(**kw), ref)
    for fault in ("dropped_last_chunk", "stale_partial"):
        _paged_check(checks, name, "llama_serve", _paged_fault(kw, fault),
                     ref, fault=fault)
    b_ms, b_by = _paged_bound(LLAMA_PAGED)
    results[name, "llama_serve"] = dict(
        max_abs_err=err, ms=median_ms(lambda: fn(**kw)),
        plain_ms=median_ms(lambda: plain(**pkw)), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        **{f"timed_{n}": x for n, x in _paged_timed(
            rng, LLAMA_PAGED, reps=5).items()})
    del kw, pkw, ref
    torch.cuda.empty_cache()
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


# ----------------------------------------------------------------------
# the serving features: prefix cache, spec decode, the ladder
# ----------------------------------------------------------------------

# bench.py's prefix-cache lane (bench.py:821-878): a GQA rotary model (8
# layers, d_model 1024, 8 heads over 4 kv heads of 128), 16 requests that
# share a 512-token system prompt with 8-63-token tails and 8-31 new tokens,
# 8 slots, 128-token blocks and prefill chunks, max_context 1024
PREFIX_CFG = dict(n_layer=8, n_head=8, n_kv_head=4, d_model=1024,
                  max_seq_len=1024, vocab_size=50304, use_rotary=True)
PREFIX_REQUESTS, PREFIX_SLOTS, PREFIX_LEN = 16, 8, 512
# bench.py's spec-decode lane (bench.py:880-1013): 4 layers, d_model 512, 8
# heads over 4 kv heads of 64, 8 repetitive prompts (a 4-11-token pattern
# tiled to 48-127 tokens) with 32-63 new tokens, 4 slots, max_context 512,
# draft_k 4
SPEC_CFG = dict(n_layer=4, n_head=8, n_kv_head=4, d_model=512,
                max_seq_len=1024, vocab_size=50304, use_rotary=True)
SPEC_REQUESTS, SPEC_SLOTS, SPEC_DRAFT_K = 8, 4, 4
LANE_ENGINE_CONFIG = {"dtype": "bfloat16", "kv_cache_dtype": "bfloat16",
                      "greedy": True, "kv_block_size": 128,
                      "max_out_tokens": 1024, "telemetry": REGISTRY_ONLY}
# share of positions where the warm wave's tokens equal the cold wave's:
# the warm wave reads the cold wave's own cached K/V (written by the same
# chunks), so only the decode batch's other rows differ between the waves
PREFIX_AGREE_MIN = 0.9
# share of positions where spec decode's tokens equal the drafter-off
# run's in bf16 (bench.py:966-977): the verify's gather + bf16 einsum and
# the decode kernel's fp32 P can flip a near-tied argmax
SPEC_AGREE_MIN = 0.9
# fp32 self-draft against drafter-off: a token may differ only where the
# drafter-off logits' top two lie closer than this (fp32 summation order)
SPEC_NEAR_TIE = 1e-3
# the degradation sub-run (tests/test_selfheal.py:595-653's ladder): the
# trace plus two priority-0 requests, all submitted at once
SPEC_LADDER = {"enabled": True, "eval_interval": 1, "queue_high": 2,
               "queue_low": 1, "free_block_low": 0.0,
               "free_block_high": 0.0, "hold_steps": 2,
               "shed_below_priority": 1}
# the kernels at these paths' shapes: the prefix lane's decode over 8 slots
# of 8 blocks (positions mid-decode past the 512-token prefix), the spec
# lane's over 4 slots of 4 blocks (a position at a block's last row), and
# the verify's int8 pool write (5 tokens a row)
PAGED_PREFIX = dict(B=8, H=8, Hkv=4, hd=128, bs=128, nb=8,
                    pos=[530, 545, 560, 575, 590, 600, 520, 555])
PAGED_SPEC = dict(B=4, H=8, Hkv=4, hd=64, bs=128, nb=4,
                  pos=[60, 127, 150, 185])
VERIFY_WRITE = dict(B=4, C=5, H=8, Hkv=4, hd=64, g=64, bs=128, nb=4)


def _live_cells(tables, pos, n_blocks, bs):
    """[N, bs] bool: the pool cells some row reads (positions 0..pos of
    the row, through its table)."""
    live = np.zeros((n_blocks, bs), bool)
    for row, p in zip(np.asarray(tables), pos):
        for t in range(p + 1):
            live[row[t // bs], t % bs] = True
    return live


def _poisoned(kw, pos):
    """A copy of a paged call's kwargs with every pool cell past each row's
    position (K, V, and the int8 pool's scales) set to a large finite
    value: 1e4, 127 in the int8 payload."""
    import torch
    tables = kw["block_tables"].cpu().numpy()
    n_blocks, _, bs, _ = kw["k_pool"].shape
    dead = torch.from_numpy(~_live_cells(tables, pos, n_blocks, bs)).to(
        kw["k_pool"].device)[:, None, :, None]
    out = dict(kw)
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        if name in kw:
            t = kw[name]
            big = 127 if t.dtype == torch.int8 else 1e4
            out[name] = torch.where(dead, torch.full_like(t, big), t)
    return out


def _stale_kv_kernels(rng, checks):
    """Rows 5 and 6 read nothing past a row's position: the kernel's output
    with every cell past it poisoned is bit-equal to the unpoisoned call's,
    at the serve, prefix-cache and spec-decode shapes (bf16, fp32 and the
    int8 pool; rows at block edges and on the trash block)."""
    import torch
    for case in (PAGED_SERVE, dict(PAGED_SERVE, g=64), PAGED_PREFIX,
                 PAGED_SPEC, dict(PAGED_SPEC, dtype="float32"),
                 dict(PAGED_SPEC, g=64),
                 dict(PAGED_SPEC, bs=16, nb=32, pos=[15, 16, 300, 511])):
        name, fn, _ = _paged_fns(case)
        kw, _ = _paged_args(rng, case)
        out = fn(**kw)
        bad = fn(**_poisoned(kw, case["pos"]))
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, bad))
        checks.append({"kernel": name, "case": "poisoned_past_pos",
                       "shape": {k: v for k, v in case.items()},
                       "bit_equal": equal, "ok": equal})
        if not equal:
            raise AssertionError(f"{name} {case}: cells past pos change the "
                                 f"output (max |diff| "
                                 f"{(out.float() - bad.float()).abs().max()})")


def _verify_write_case(rng, dtype):
    """The verify's pool write: 5 tokens a row at positions 126-130 of
    128-token blocks (across a block edge, offsets 126, 127 then 0-2),
    rows 0-2 with their own written blocks and two read-only blocks (11,
    12) shared in their tables, row 3 inactive (all trash, positions 0-4);
    k / v views of a qkv projection. Returns (k, v, tables, positions, pool,
    written cells [N, bs])."""
    import torch
    c = VERIFY_WRITE
    B, C, H, Hkv, hd, g, bs = (c[n] for n in ("B", "C", "H", "Hkv", "hd",
                                              "g", "bs"))
    tables = np.array([[1, 2, 11, 12], [3, 4, 11, 12], [5, 6, 11, 12],
                       [0, 0, 0, 0]], np.int32)
    pos = np.array([np.arange(126, 131)] * 3 + [np.arange(5)], np.int64)
    n_blocks = 13
    written = np.zeros((n_blocks, bs), bool)
    for row, ps in zip(tables[:3], pos[:3]):
        for p in ps:
            written[row[p // bs], p % bs] = True
    qkv = torch.from_numpy(rng.standard_normal(
        (B, C, (H + 2 * Hkv) * hd)).astype(np.float32)).to(
            "cuda", torch.bfloat16)
    _, k, v = qkv.split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
    if dtype == "int8":
        pool = {}
        for name in ("k", "v"):
            pool[name] = torch.from_numpy(rng.integers(
                -127, 128, (n_blocks, Hkv, bs, hd)).astype(np.int8)).cuda()
            pool[name + "_scale"] = torch.from_numpy(rng.random(
                (n_blocks, Hkv, bs, hd // g)).astype(np.float32)).cuda()
    else:
        pool = {n: torch.from_numpy(rng.standard_normal(
            (n_blocks, Hkv, bs, hd)).astype(np.float32)).to(
                "cuda", torch.bfloat16) for n in ("k", "v")}
    return (k.reshape(B, C, Hkv, hd), v.reshape(B, C, Hkv, hd),
            torch.tensor(tables, device="cuda"),
            torch.tensor(pos, device="cuda"), pool, written)


def _verify_write_kernels(rng, checks):
    """The int8 pool write (row 7, one launch) and the bf16 pool's index
    write, each through the path's `paged_kv_write`, at the verify's shape:
    bit-exact against the plain version (the int8 pool: quantize_reference
    and the index writes; bf16: one token at a time), and no byte changed
    outside the written (block, offset) cells but in the trash block."""
    import torch
    from deepspeed_tpu_torch.models.gpt import paged_kv_write
    from deepspeed_tpu_torch.ops import quant
    for dtype in ("int8", "bfloat16"):
        k, v, tables, pos, pool, written = _verify_write_case(rng, dtype)
        got = {n: t.clone() for n, t in pool.items()}
        ref = {n: t.clone() for n, t in pool.items()}
        paged_kv_write(got, k, v, tables, pos)
        if dtype == "int8":
            quant.quantize_kv_write_reference(
                k, v, tables, pos, *(ref[n] for n in _POOL_NAMES))
        else:
            bs = pool["k"].shape[2]
            for b in range(pos.shape[0]):
                for c in range(pos.shape[1]):
                    p = int(pos[b, c])
                    blk = int(tables[b, p // bs])
                    ref["k"][blk, :, p % bs] = k[b, c]
                    ref["v"][blk, :, p % bs] = v[b, c]
        torch.cuda.synchronize()
        keep = torch.from_numpy(~written).cuda()[1:, None, :, None]
        exact, untouched = {}, {}
        for n in got:
            exact[n] = bool(torch.equal(got[n][1:], ref[n][1:]))
            same = (got[n][1:] == pool[n][1:]) | ~keep
            untouched[n] = bool(same.all())
        ok = all(exact.values()) and all(untouched.values())
        checks.append({"kernel": "quantize_int8" if dtype == "int8"
                       else "bf16_pool_write", "case": "verify_write",
                       "shape": dict(VERIFY_WRITE, dtype=dtype),
                       "positions": [126, 130], "shared_blocks": [11, 12],
                       "bit_exact": exact, "untouched_outside": untouched,
                       "ok": ok})
        if not ok:
            raise AssertionError(f"verify pool write ({dtype}): bit-exact "
                                 f"{exact}, untouched {untouched}")


def _paged_row(rng, checks, case, label):
    """Row 5 or 6 at one path's shape: checked, eager and plain times,
    device time with inputs rotated past L2."""
    import torch
    name, fn, plain = _paged_fns(case)
    kw, pkw = _paged_args(rng, case)
    out, ref = fn(**kw), plain(**pkw)
    torch.cuda.synchronize()
    err = _paged_check(checks, name, label, out, ref)
    b_ms, b_by = _paged_bound(case)
    row = dict(shape={k: v for k, v in case.items() if k != "pos"},
               max_abs_err=err, ms=median_ms(lambda: fn(**kw)),
               plain_ms=median_ms(lambda: plain(**pkw)),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    row.update(_paged_timed(rng, case, reps=5))
    return name, row


def _write_row(rng, checks, case):
    """Row 7's int8 pool write at one path's shape, bit-exact against the
    plain sequence, eager and plain times."""
    import torch
    from deepspeed_tpu_torch.ops import quant
    k, v, tables, pos, pool = _kv_write_args(rng, case)
    got = {n: t.clone() for n, t in pool.items()}
    ref = {n: t.clone() for n, t in pool.items()}
    quant.quantize_kv_write(k, v, tables, pos, *(got[n] for n in _POOL_NAMES))
    quant.quantize_kv_write_reference(k, v, tables, pos,
                                      *(ref[n] for n in _POOL_NAMES))
    torch.cuda.synchronize()
    _kv_write_check(checks, dict(case), got, ref)
    b_ms, b_by = _kv_write_bound(case)
    return dict(
        shape=dict(case), max_abs_err=0.0,
        ms=median_ms(lambda: quant.quantize_kv_write(
            k, v, tables, pos, *(got[n] for n in _POOL_NAMES))),
        plain_ms=median_ms(lambda: quant.quantize_kv_write_reference(
            k, v, tables, pos, *(ref[n] for n in _POOL_NAMES))),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _gather_row(rng, checks, label, B, Hkv, S, hd, g):
    """Row 10 at a dequantizing gather's shape: a [B, Hkv, S, hd] int8 K
    (or V) with one scale a g-group, into bf16, bit-exact, eager and plain
    times."""
    import torch
    from deepspeed_tpu_torch.ops import quant
    q8 = torch.from_numpy(rng.integers(-127, 128, (B, Hkv, S, hd)).astype(
        np.int8)).cuda()
    sc = torch.from_numpy(rng.random((B, Hkv, S, hd // g)).astype(
        np.float32)).cuda()
    dk = quant.dequantize_int8(q8, sc, torch.bfloat16, g)
    dr = quant.dequantize_reference(q8, sc, torch.bfloat16, g, 8)
    torch.cuda.synchronize()
    exact = bool(torch.equal(dk, dr))
    checks.append({"kernel": "dequantize_int8", "case": label,
                   "shape": [B, Hkv, S, hd], "group": g, "bit_exact": exact,
                   "ok": exact})
    if not exact:
        raise AssertionError(f"dequantize_int8 at {label}: kernel != plain "
                             f"version")
    n = B * Hkv * S * hd
    b_ms, b_by = bound(n + n // g * 4 + 2 * n, n, FP32_FLOPS)
    return dict(
        shape=[B, Hkv, S, hd], group=g, max_abs_err=0.0,
        ms=median_ms(lambda: quant.dequantize_int8(q8, sc, torch.bfloat16,
                                                   g)),
        plain_ms=median_ms(lambda: quant.dequantize_reference(
            q8, sc, torch.bfloat16, g, 8)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def _feature_rows(rng, checks, results):
    """The kernels line's rows of the prefix-cache and spec-decode paths,
    each at its path's shape: rows 5 and 6 (checked, eager and plain times,
    device time with inputs rotated past L2), row 7 (the verify's int8
    write) and row 10 (the verify's dequantizing gather)."""
    rows = {}
    for case, paths in (
            (PAGED_PREFIX, ("prefix_cache",)),
            (PAGED_SPEC, ("spec_off", "spec_ladder")),
            (dict(PAGED_SPEC, dtype="float32"),
             ("spec_off_fp32", "spec_model_fp32")),
            (dict(PAGED_SPEC, g=64), ("spec_off_int8", "spec_model_int8"))):
        name, row = _paged_row(rng, checks, case, paths[0])
        for path in paths:
            rows[name, path] = row
    # row 7 at the verify's write (5 tokens a row); row 10 at the verify's
    # dequantizing gather: a [4, 4, 512, 64] int8 K (or V), 64-groups
    write = _write_row(rng, checks, VERIFY_WRITE)
    gather = _gather_row(rng, checks, "verify_gather", 4, 4, 4 * 128, 64, 64)
    for path in ("spec_off_int8", "spec_model_int8"):
        rows["quantize_int8", path] = write
        rows["dequantize_int8", path] = gather
    results.update(rows)


def _serving_feature_kernels(rng, checks, results):
    import torch
    _stale_kv_kernels(rng, checks)
    _verify_write_kernels(rng, checks)
    _feature_rows(rng, checks, results)
    torch.cuda.empty_cache()


def _lane_engine(cfg_kw, name, dtype=None):
    """init_inference over a GPTConfig of `cfg_kw` with random weights from
    numpy seed 0 (bf16 unless `dtype`): (cfg, spec, engine)."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.gpt import GPTConfig, \
        make_gpt_decode_model
    cfg = GPTConfig(**cfg_kw, dtype=dtype or torch.bfloat16)
    spec = make_gpt_decode_model(cfg, name=name, seed=0)
    config = dict(LANE_ENGINE_CONFIG)
    if dtype is not None:
        config.update(dtype="float32", kv_cache_dtype="float32")
    return cfg, spec, init_inference(spec, config=config)


def _timed_run(serving, reqs):
    """Run a trace, timed: (results, seconds, launches)."""
    import torch
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serving.run(reqs)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(LAUNCHES)


def _completed(path, res, reqs):
    if sorted(res, key=str) != sorted((r.uid for r in reqs), key=str) or any(
            len(res[r.uid].tokens) != r.max_new_tokens
            or res[r.uid].finish_reason != "length" for r in reqs):
        raise AssertionError(f"{path}: not every request completed with "
                             f"its budget")


def _agreement(a, b, uids):
    """Share of positions whose tokens are equal (bench.py:966-977)."""
    matched = total = 0
    for uid in uids:
        x, y = a[uid].tokens, b[uid].tokens
        total += len(x)
        matched += int((x[:len(y)] == y[:len(x)]).sum())
    return matched / max(1, total)


def _clean_close(path, serving):
    """close()'s final audit must be clean, and so every scheduled one."""
    report = serving.close()
    audit = serving.stats().get("audit", {})
    if not report.ok or audit.get("violations"):
        raise AssertionError(f"{path}: pool audit {report.summary()} "
                             f"({audit})")
    return report.summary()


def phase_prefix_cache(state):
    """bench.py's prefix-cache lane through the port's ServingEngine: a cold
    wave then a warm wave of the same 16 requests on one cache-enabled
    engine (after a warm-up request on a separate engine)."""
    from deepspeed_tpu_torch.inference.scheduler import Request
    t0 = time.perf_counter()
    cfg, spec, engine = _lane_engine(PREFIX_CFG, "prefix-cache-lane")
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, (PREFIX_LEN,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32)
             for t in rng.integers(8, 64, PREFIX_REQUESTS)]
    news = [int(n) for n in rng.integers(8, 32, PREFIX_REQUESTS)]
    kw = dict(max_slots=PREFIX_SLOTS, max_context=1024, prefill_chunk=128,
              enable_prefix_caching=True)
    warm_up = np.random.default_rng(1).integers(0, cfg.vocab_size, (300,))
    engine.serving(**kw).run([Request(uid="warm-up", tokens=warm_up,
                                      max_new_tokens=4, stop_on_eos=False)])
    serving = engine.serving(**kw)
    L = cfg.n_layer
    waves, outs, counts = {}, {}, {}
    for wave, base in (("cold", 0), ("warm", 10_000)):
        reqs = [Request(uid=base + i, tokens=np.concatenate([prefix, t]),
                        max_new_tokens=n, stop_on_eos=False)
                for i, (t, n) in enumerate(zip(tails, news))]
        serving.telemetry.registry.clear()
        st0 = serving.stats()
        res, dt, launches = _timed_run(serving, reqs)
        st1 = serving.stats()
        _completed(f"prefix_cache {wave}", res, reqs)
        steps = st1["decode_steps"] - st0["decode_steps"]
        _expect(f"prefix_cache {wave}", launches,
                {"paged_decode_attention": L * steps})
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n
        pc0, pc1 = st0["prefix_cache"], st1["prefix_cache"]
        toks = sum(len(r.tokens) for r in res.values())
        waves[wave] = dict(
            seconds=dt, tokens_per_s=toks / dt,
            prefill_chunks=st1["prefill_chunks"] - st0["prefill_chunks"],
            decode_steps=steps,
            hit_tokens=pc1["hit_tokens"] - pc0["hit_tokens"],
            prefill_chunks_skipped=pc1["prefill_chunks_skipped"]
            - pc0["prefill_chunks_skipped"],
            evictions=pc1["evictions"] - pc0["evictions"],
            latency=_latency(f"prefix_cache {wave}", serving, reqs))
        outs[wave] = {uid - base: r for uid, r in res.items()}
    cold, warm = waves["cold"], waves["warm"]
    if not warm["prefill_chunks"] < cold["prefill_chunks"]:
        raise AssertionError(f"prefix_cache: warm wave ran "
                             f"{warm['prefill_chunks']} prefill chunks, cold "
                             f"{cold['prefill_chunks']}")
    agree = _agreement(outs["cold"], outs["warm"], range(PREFIX_REQUESTS))
    if not agree >= PREFIX_AGREE_MIN:
        raise AssertionError(f"prefix_cache: warm tokens equal cold on "
                             f"{agree:.3f} < {PREFIX_AGREE_MIN}")
    if serving.allocator.available != serving.allocator.capacity:
        raise AssertionError("prefix_cache: blocks leaked after draining")
    audit = _clean_close("prefix_cache", serving)
    emit({"phase": "prefix_cache", "model": PREFIX_CFG, "dtype": "bfloat16",
          "source": "bench.py:821-878", "requests_a_wave": PREFIX_REQUESTS,
          "slots": PREFIX_SLOTS, "shared_prefix_tokens": PREFIX_LEN,
          "tail_lens": [len(t) for t in tails], "max_new_tokens": news,
          "setup_s": setup_s, "cold": cold, "warm": warm,
          "warm_over_cold_tokens_per_s": warm["tokens_per_s"]
          / cold["tokens_per_s"],
          "warm_tokens_equal_cold": agree, "launches": counts,
          "audit": audit, "stats": serving.stats()})
    return counts


def _top2_gap(serving, prompt):
    """The fp32 engine's logits after `prompt` (prefill through a fresh
    pool, as the scheduler chunks it): the gap between its two largest."""
    logits, _, _ = _paged_logits(serving, prompt)
    top = logits.topk(2).values
    return float(top[0] - top[1]), int(logits.argmax())


def _spec_mode(engine, path, reqs, **over):
    """One timed run of the spec lane's trace through a fresh serving
    engine: (serving, results, seconds, launches, stats, latency, audit)."""
    serving = engine.serving(max_slots=SPEC_SLOTS, max_context=512,
                             prefill_chunk=128, **over)
    res, dt, launches = _timed_run(serving, reqs)
    _completed(path, res, reqs)
    latency = _latency(path, serving, reqs)
    audit = _clean_close(path, serving)
    st = serving.stats()
    toks = sum(len(r.tokens) for r in res.values())
    summary = dict(seconds=dt, tokens_per_s=toks / dt,
                   decode_steps=st["decode_steps"],
                   prefill_chunks=st["prefill_chunks"], latency=latency,
                   audit=audit, launches=launches)
    if "spec_decode" in st:
        summary["spec_decode"] = st["spec_decode"]
    return serving, res, launches, st, summary


def phase_spec_decode(state):
    """bench.py's spec-decode lane through the port's ServingEngine: (a)
    drafter off against ngram; (b) the target drafting for itself in fp32,
    token for token; (c) (b) over the int8 pool in bf16; (d) ngram with the
    degradation ladder under queue pressure."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.models.gpt import make_gpt_decode_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    t0 = time.perf_counter()
    cfg, spec, engine = _lane_engine(SPEC_CFG, "spec-decode-lane")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    spec32 = make_gpt_decode_model(cfg32, name="spec-decode-lane",
                                   params=spec.params)
    engine32 = init_inference(spec32, config=dict(
        LANE_ENGINE_CONFIG, dtype="float32", kv_cache_dtype="float32"))
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts, news = [], []
    for _ in range(SPEC_REQUESTS):
        pat = rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 12)),))
        reps = -(-int(rng.integers(48, 128)) // len(pat))
        prompts.append(np.tile(pat, reps).astype(np.int32))
        news.append(int(rng.integers(32, 64)))
    mk = lambda priority=0: [Request(uid=i, tokens=p, max_new_tokens=n,
                                     stop_on_eos=False, priority=priority)
                             for i, (p, n) in enumerate(zip(prompts, news))]
    ngram = {"drafter": "ngram", "draft_k": SPEC_DRAFT_K}
    model = {"drafter": "model", "draft_k": SPEC_DRAFT_K}
    int8 = {"kv_cache_dtype": "int8"}
    L, k, uids = cfg.n_layer, SPEC_DRAFT_K, range(SPEC_REQUESTS)
    warm = [Request(uid="warm-up", tokens=prompts[0], max_new_tokens=8,
                    stop_on_eos=False)]
    for e in (engine, engine32):
        e.serving(max_slots=SPEC_SLOTS, max_context=512, prefill_chunk=128,
                  spec_decode=ngram).run(warm)
    runs, counts = {}, {}

    # (a) drafter off against prompt lookup
    _, off, c, st, runs["spec_off"] = _spec_mode(engine, "spec_off", mk())
    _expect("spec_off", c, {"paged_decode_attention":
                            L * st["decode_steps"]})
    counts["spec_off"] = c
    _, ng, c, st, runs["spec_ngram"] = _spec_mode(engine, "spec_ngram", mk(),
                                                  spec_decode=ngram)
    _expect("spec_ngram", c, {})       # prefill and verify: the gather
    counts["spec_ngram"] = c
    parity_a = _agreement(off, ng, uids)
    if not parity_a > SPEC_AGREE_MIN:
        raise AssertionError(f"spec_ngram: greedy parity {parity_a:.3f} <= "
                             f"{SPEC_AGREE_MIN}")

    # (b) fp32, the target as its own draft model: token for token
    s32, off32, c, st, runs["spec_off_fp32"] = _spec_mode(
        engine32, "spec_off_fp32", mk())
    _expect("spec_off_fp32", c, {"paged_decode_attention":
                                 L * st["decode_steps"]})
    counts["spec_off_fp32"] = c
    _, self32, c, st, runs["spec_model_fp32"] = _spec_mode(
        engine32, "spec_model_fp32", mk(), spec_decode=model,
        draft_spec=spec32)
    verify = st["spec_decode"]["verify_steps"]
    _expect("spec_model_fp32", c, {"paged_decode_attention": k * L * verify})
    counts["spec_model_fp32"] = c
    mismatches = []
    for i in uids:
        a, b = off32[i].tokens, self32[i].tokens
        diff = np.nonzero(a != b)[0]
        if diff.size:
            j = int(diff[0])
            gap, top = _top2_gap(engine32.serving(
                max_slots=1, max_context=512, prefill_chunk=128),
                np.concatenate([prompts[i], a[:j]]).astype(np.int64))
            mismatches.append({"request": i, "position": j,
                               "off": int(a[j]), "self_draft": int(b[j]),
                               "top2_gap": gap, "argmax": top})
    print(json.dumps({"spec_model_fp32_mismatches": mismatches}), flush=True)
    far = [m for m in mismatches if not m["top2_gap"] < SPEC_NEAR_TIE]
    if far:
        raise AssertionError(f"spec_model_fp32: tokens differ from drafter-"
                             f"off past the near-tie rule: {far}")

    # (c) (b) over the int8 pool, bf16
    _, offq, c, st, runs["spec_off_int8"] = _spec_mode(
        engine, "spec_off_int8", mk(), quantization=int8)
    P, D = st["prefill_chunks"], st["decode_steps"]
    _expect("spec_off_int8", c, {"paged_decode_attention_quant": L * D,
                                 "quantize_int8": L * (P + D),
                                 "dequantize_int8": 2 * L * P})
    counts["spec_off_int8"] = c
    _, selfq, c, st, runs["spec_model_int8"] = _spec_mode(
        engine, "spec_model_int8", mk(), spec_decode=model, draft_spec=spec,
        quantization=int8)
    P, V = st["prefill_chunks"], st["spec_decode"]["verify_steps"]
    # target and draft mirror: a write and a dequantizing gather (K and V)
    # a layer of every prefill chunk; the verify a write and a gather; each
    # of the k draft steps a write and the int8 paged decode
    _expect("spec_model_int8", c, {
        "paged_decode_attention_quant": k * L * V,
        "quantize_int8": L * (2 * P + V + k * V),
        "dequantize_int8": 2 * L * (2 * P + V)})
    counts["spec_model_int8"] = c
    parity_c = _agreement(offq, selfq, uids)
    if not parity_c > SPEC_AGREE_MIN:
        raise AssertionError(f"spec_model_int8: parity {parity_c:.3f} <= "
                             f"{SPEC_AGREE_MIN}")

    # (d) ngram with the degradation ladder under queue pressure
    serving = engine.serving(max_slots=SPEC_SLOTS, max_context=512,
                             prefill_chunk=128, spec_decode=ngram,
                             degradation=SPEC_LADDER)
    reqs = mk(priority=1) + [Request(uid=f"low{j}", tokens=prompts[j],
                                     max_new_tokens=news[j],
                                     stop_on_eos=False, priority=0)
                             for j in range(2)]
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        serving.submit(r)
    done, levels = {}, []
    while serving.num_active or serving.queue_depth:
        for d in serving.step():
            done[d.uid] = d
        levels.append(serving.pressure.level)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = dict(LAUNCHES)
    st = serving.stats()
    fallback = st["decode_steps"] - st["spec_decode"]["verify_steps"]
    _expect("spec_ladder", c, {"paged_decode_attention": L * fallback})
    counts["spec_ladder"] = c
    peak = levels.index(max(levels))
    shed = sorted(u for u, d in done.items()
                  if d.finish_reason == "cancelled")
    if not (max(levels) >= 2 and fallback > 0 and levels[-1] == 0
            and all(a >= b for a, b in zip(levels[peak:],
                                           levels[peak + 1:]))):
        raise AssertionError(f"spec_ladder: levels {levels}")
    if shed != ["low0", "low1"]:
        raise AssertionError(f"spec_ladder: shed {shed}, want the two "
                             f"priority-0 requests")
    _completed("spec_ladder", {u: done[u] for u in uids}, mk())
    parity_d = _agreement(off, done, uids)
    if not parity_d > SPEC_AGREE_MIN:
        raise AssertionError(f"spec_ladder: parity {parity_d:.3f} <= "
                             f"{SPEC_AGREE_MIN}")
    runs["spec_ladder"] = dict(
        seconds=dt, levels=levels, peak_level=max(levels),
        fallback_decode_steps=fallback, shed=shed,
        degradation=st["degradation"], spec_decode=st["spec_decode"],
        latency=serving.latency_snapshot(),
        audit=_clean_close("spec_ladder", serving), launches=c)
    emit({"phase": "spec_decode", "model": SPEC_CFG,
          "source": "bench.py:880-1013", "requests": SPEC_REQUESTS,
          "slots": SPEC_SLOTS, "draft_k": k,
          "prompt_lens": [len(p) for p in prompts], "max_new_tokens": news,
          "setup_s": setup_s, "runs": runs,
          "ngram_over_off_tokens_per_s": runs["spec_ngram"]["tokens_per_s"]
          / runs["spec_off"]["tokens_per_s"],
          "parity": {"ngram_vs_off": parity_a,
                     "model_int8_vs_off_int8": parity_c,
                     "ladder_vs_off": parity_d},
          "fp32_self_draft_mismatches": mismatches})
    return counts


# ----------------------------------------------------------------------
# the serving fabric: router, robustness and fabric (bench.py's lanes)
# ----------------------------------------------------------------------

# bench.py's router lane (bench.py:1015-1109): PREFIX_CFG's model (8
# layers, d_model 1024, 8 heads over 4 kv heads of 128, rotary, vocab
# 50304, bf16), 16 requests of which 60 % share a 512-token prefix with an
# 8-63-token tail and the rest are unique prompts of 64-383 tokens, 8-47
# new tokens, seed 0; 4 slots a replica, kv_block_size 128, prefill_chunk
# 128, prefix caching on
ROUTER_REQUESTS, ROUTER_SLOTS, ROUTER_PREFIX = 16, 4, 512
# share of the pool's served tokens equal to generate()'s choice on the
# same prefix (`_forced_agreement`): a 2-replica pool decodes another mix
# of rows each step than one engine, so cuBLAS may pick another algorithm
# and a near-tied bf16 argmax flip, as in the serve phase (floor 0.9)
ROUTER_AGREE_MIN = 0.9
# bench.py's robustness lane (bench.py:1112-1285): SPEC_CFG's model (4
# layers, d_model 512, 8 heads over 4 kv heads of 64), 16 requests of
# 32-255 tokens and 8-31 new ones, 4 slots a replica, audit_interval 1
ROBUST_REQUESTS, ROBUST_SLOTS = 16, 4
# bench.py's fabric lane (bench.py:1288-1560) over the port's tiny engine
# (`testing/fabric.py`) at the widths the card's kernels take: bf16, 2
# heads of 64 (the reference's tiny model is fp32 at head width 16, which
# the attention dispatch refuses on CUDA)
FABRIC_FACTORY = "deepspeed_tpu_torch.testing.fabric:tiny_serving_engine"
FABRIC_MODEL = {"dtype": "bfloat16", "n_head": 2, "d_model": 128}
FABRIC_DEVICE_TYPE = "cuda"      # where every child must run
FABRIC_REQUESTS, FABRIC_KILLS, FABRIC_HEARTBEAT_S = 8, 3, 0.2
FABRIC_OBS_ROUNDS = 2
# the kernels at these paths' shapes: the router lane's decode over 4 slots
# of 8 blocks (positions past the 512-token prefix and short unique
# prompts), over the int8 pool (one scale a head vector), its int8 write at
# a decode step (one slot idle) and the prefill chunk's dequantizing gather
# ([1, 4, 1024, 128]); the robustness lane's decode over 4 slots of 8
# blocks at hd 64; the fabric's tiny engine, 2 slots of 6 16-row blocks
PAGED_ROUTER = dict(B=4, H=8, Hkv=4, hd=128, bs=128, nb=8,
                    pos=[530, 120, 560, 300])
PAGED_ROBUST = dict(B=4, H=8, Hkv=4, hd=64, bs=128, nb=8,
                    pos=[40, 200, 127, 260])
PAGED_FABRIC = dict(B=2, H=2, Hkv=2, hd=64, bs=16, nb=6, pos=[20, 29])
ROUTER_WRITE = dict(B=4, C=1, H=8, Hkv=4, hd=128, g=128, bs=128, nb=8,
                    inactive=1)


def _fabric_rows(rng, checks, results):
    """The kernels line's rows of the router, robustness and fabric paths,
    each at its path's shape (the kernels' edge cases and faults stay in
    the rows above)."""
    rows = {}
    for case, paths in ((PAGED_ROUTER, ("router", "router_disagg",
                                        "autoscale")),
                        (dict(PAGED_ROUTER, g=128), ("router_disagg_int8",)),
                        (PAGED_ROBUST, ("robustness",)),
                        (PAGED_FABRIC, ("fabric",))):
        name, row = _paged_row(rng, checks, case, paths[0])
        for path in paths:
            rows[name, path] = row
    rows["quantize_int8", "router_disagg_int8"] = _write_row(
        rng, checks, ROUTER_WRITE)
    rows["dequantize_int8", "router_disagg_int8"] = _gather_row(
        rng, checks, "router_prefill_gather", 1, 4, 8 * 128, 128, 128)
    results.update(rows)


def _router_trace(vocab):
    """bench.py:1063-1074's trace: (prompts, new tokens)."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, (ROUTER_PREFIX,)).astype(np.int32)
    prompts, news = [], []
    for _ in range(ROUTER_REQUESTS):
        tail = rng.integers(0, vocab, (int(rng.integers(8, 64)),)).astype(
            np.int32)
        if rng.random() < 0.6:
            prompts.append(np.concatenate([prefix, tail]))
        else:
            prompts.append(rng.integers(0, vocab, (int(rng.integers(
                64, 384)),)).astype(np.int32))
        news.append(int(rng.integers(8, 48)))
    return prompts, news


def _router_forced(engine, prompts, res):
    """`_forced_agreement` request by request (the trace's new-token counts
    differ)."""
    share, n, gaps = 0.0, 0, []
    for i, p in enumerate(prompts):
        f = _forced_agreement(engine, [p], [res[i].tokens], 1)
        share += f["share"] * f["positions"]
        n += f["positions"]
        gaps += f["differing_top2_gaps"]
    return {"share": share / max(1, n), "positions": n,
            "differing_top2_gaps": gaps}


def _disagg_arm(engine, path, reqs, L, **quant):
    """One prefill replica and one decode replica on the router trace: every
    handoff's transplanted blocks (payload and, on the int8 pool, scales)
    equal to the source's right after the copy, exact launches, both
    pools' audits clean at close."""
    import torch
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.serving import InProcessReplica, ServingRouter
    kw = dict(max_slots=ROUTER_SLOTS, max_context=1024, prefill_chunk=128)
    pre = engine.serving(enable_prefix_caching=True, **kw, **quant)
    dec = engine.serving(enable_prefix_caching=False, **kw, **quant)
    moved = {"handoffs": 0, "blocks": 0, "leaves_equal": True}
    adopt = dec.adopt_handoff

    def checked_adopt(state, src_pool):
        ok = adopt(state, src_pool)
        if ok:
            slot = next(s for s in dec.slots if s.uid == state["uid"])
            n = len(state["blocks"])
            src = torch.as_tensor(state["blocks"], device=engine.device)
            dst = torch.as_tensor(slot.blocks[:n], device=engine.device)
            for name in sorted(src_pool):
                moved["leaves_equal"] &= bool(torch.equal(
                    src_pool[name].index_select(1, src),
                    dec.pool[name].index_select(1, dst)))
            moved["handoffs"] += 1
            moved["blocks"] += n
        return ok

    dec.adopt_handoff = checked_adopt
    router = ServingRouter()
    router.add_replica(InProcessReplica(pre, replica_id="prefill"),
                       role="prefill")
    router.add_replica(InProcessReplica(dec, replica_id="decode"),
                       role="decode")
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = router.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    _completed(path, res, reqs)
    if not moved["leaves_equal"] or moved["handoffs"] != len(reqs) or \
            router.counters["handoffs"] != len(reqs):
        raise AssertionError(f"{path}: handoffs {moved} / "
                             f"{router.counters['handoffs']} of {len(reqs)}")
    sp, sd = pre.stats(), dec.stats()
    if sp["decode_steps"] or sd["prefill_chunks"]:
        raise AssertionError(f"{path}: the prefill replica decoded or the "
                             f"decode replica prefilled ({sp['decode_steps']}"
                             f", {sd['prefill_chunks']})")
    steps, chunks = sd["decode_steps"], sp["prefill_chunks"]
    want = ({"paged_decode_attention_quant": L * steps,
             "quantize_int8": L * (steps + chunks),
             "dequantize_int8": 2 * L * chunks} if quant else
            {"paged_decode_attention": L * steps})
    _expect(path, launches, want)
    audits = {"prefill": _clean_close(f"{path} prefill", pre),
              "decode": _clean_close(f"{path} decode", dec)}
    return res, launches, dict(
        seconds=dt, tokens_per_s=sum(len(r.tokens) for r in res.values())
        / dt, handoffs=moved["handoffs"], transplanted_blocks=moved["blocks"],
        transplanted_leaves_equal=moved["leaves_equal"],
        prefill_chunks=chunks, decode_steps=steps, audit=audits,
        launches=launches)


def phase_router(state):
    """bench.py's router lane through the port: one engine, then two
    InProcessReplicas behind a ServingRouter on the same trace; then the
    disaggregated arms (a prefill and a decode replica) over the bf16 and
    the int8 pool."""
    import torch
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.serving import ServingRouter
    t_phase = time.perf_counter()
    cfg, spec, engine = _lane_engine(PREFIX_CFG, "router-lane")
    state["router_engine"] = (cfg, engine)    # the autoscale phase's
    setup_s = time.perf_counter() - t_phase
    L = cfg.n_layer
    prompts, news = _router_trace(cfg.vocab_size)

    def reqs():
        return [Request(uid=i, tokens=p, max_new_tokens=n, stop_on_eos=False)
                for i, (p, n) in enumerate(zip(prompts, news))]

    def replica():
        return engine.serving(max_slots=ROUTER_SLOTS, max_context=1024,
                              prefill_chunk=128, enable_prefix_caching=True)

    replica().run([Request(uid="warm-up", tokens=prompts[0],
                           max_new_tokens=4, stop_on_eos=False)])
    single = replica()
    res1, dt1, l1 = _timed_run(single, reqs())
    _completed("router single", res1, reqs())
    _expect("router single", l1, {"paged_decode_attention":
                                  L * single.stats()["decode_steps"]})
    toks = sum(len(r.tokens) for r in res1.values())

    router = ServingRouter(replicas=[replica(), replica()])
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = router.run(reqs())
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    _completed("router", res2, reqs())
    toks2 = sum(len(r.tokens) for r in res2.values())
    if toks2 != toks:
        raise AssertionError(f"router: the pool served {toks2} tokens, the "
                             f"single engine {toks}")
    _expect("router", counts, {"paged_decode_attention": L * sum(
        r.stats()["decode_steps"] for r in router.replicas.values())})
    c = router.counters
    if not c["affinity_hits"] > 0:
        raise AssertionError(f"router: no affinity hit ({c})")
    forced = _router_forced(engine, prompts, res2)
    if not forced["share"] >= ROUTER_AGREE_MIN:
        raise AssertionError(f"router: pool tokens equal generate()'s "
                             f"choice on {forced['share']:.3f} < "
                             f"{ROUTER_AGREE_MIN}")
    ttft = {rid: router.replica_ttft(rid) for rid in router.replicas}
    audits = {rid: _clean_close(f"router {rid}", rep.engine)
              for rid, rep in router.replicas.items()}
    _clean_close("router single", single)

    out = {}
    res_d, l_d, out["disaggregated"] = _disagg_arm(
        engine, "router_disagg", reqs(), L)
    res_q, l_q, out["disaggregated_int8"] = _disagg_arm(
        engine, "router_disagg_int8", reqs(), L,
        quantization={"kv_cache_dtype": "int8"})
    for key, res, floor in (("disaggregated", res_d, ROUTER_AGREE_MIN),
                            ("disaggregated_int8", res_q,
                             QUANT_SERVE_AGREE_MIN)):
        f = _router_forced(engine, prompts, res)
        out[key]["forced_agreement"] = f["share"]
        if not f["share"] >= floor:
            raise AssertionError(f"router {key}: tokens equal generate()'s "
                                 f"choice on {f['share']:.3f} < {floor}")
    emit({"phase": "router", "model": PREFIX_CFG, "dtype": "bfloat16",
          "source": "bench.py:1015-1109", "requests": ROUTER_REQUESTS,
          "slots_per_replica": ROUTER_SLOTS,
          "shared_prefix_tokens": ROUTER_PREFIX,
          "prompt_lens": [len(p) for p in prompts], "max_new_tokens": news,
          "setup_s": setup_s,
          "tokens_per_s": toks2 / dt2,
          "single_engine_tokens_per_s": toks / dt1,
          "vs_baseline": (toks2 / dt2) / (toks / dt1),
          "router_wall_s": dt2, "single_wall_s": dt1,
          "affinity_hit_rate": c["affinity_hits"] / max(1, c["submitted"]),
          "load_spills": c["load_spills"],
          "router_prefill_chunks": router.total_prefill_chunks(),
          "single_prefill_chunks": single.prefill_chunks,
          "replica_ttft_ms": ttft,
          "forced_agreement": forced["share"],
          "differing_top2_gaps": forced["differing_top2_gaps"],
          "tokens_equal_single_free_running": _agreement(
              res1, res2, range(ROUTER_REQUESTS)),
          "counters": {k: v for k, v in c.items() if v},
          "compiles": {rid: rep.compile_stats()
                       for rid, rep in router.replicas.items()},
          "audit": audits, "launches": counts, **out,
          "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": state["nvidia_smi"]})
    return {"router": counts, "router_disagg": l_d,
            "router_disagg_int8": l_q}


def phase_robustness(state):
    """bench.py's robustness lane through the port: a 2-replica pool on a
    ChaosClock (0.5 ms a read) where "hung" hangs for good at its step 3
    and "dirty" takes seeded safe pool corruptions, with the hung-replica
    watchdog and without it; then the degradation ladder under a flood on
    one engine."""
    import torch
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.serving import InProcessReplica, ServingRouter
    from deepspeed_tpu_torch.testing.chaos import (SAFE_CORRUPTIONS,
                                                   ChaosClock, ChaosEvent,
                                                   ChaosReplica,
                                                   ChaosSchedule)
    t_phase = time.perf_counter()
    cfg, spec, engine = _lane_engine(SPEC_CFG, "robustness-lane")
    L = cfg.n_layer
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (int(rng.integers(
        32, 256)),)).astype(np.int32) for _ in range(ROBUST_REQUESTS)]
    news = [int(rng.integers(8, 32)) for _ in range(ROBUST_REQUESTS)]

    def reqs():
        return [Request(uid=i, tokens=p, max_new_tokens=n, stop_on_eos=False,
                        deadline_ms=1200.0 if i % 4 == 0 else None)
                for i, (p, n) in enumerate(zip(prompts, news))]

    def run_pool(watchdog):
        built = []

        def serving():
            s = engine.serving(max_slots=ROBUST_SLOTS, max_context=1024,
                               prefill_chunk=128, enable_prefix_caching=True,
                               audit_interval=1)
            built.append(s)
            return s

        clock = ChaosClock(tick=0.0005)
        hung = ChaosReplica(
            InProcessReplica(factory=serving, replica_id="hung"),
            ChaosSchedule([ChaosEvent(3, "hang", 0.4)]), clock=clock)
        dirty = ChaosReplica(
            InProcessReplica(factory=serving, replica_id="dirty"),
            ChaosSchedule.seeded(7, 64, corrupt_rate=0.3,
                                 corruptions=SAFE_CORRUPTIONS),
            clock=clock, seed=70)
        router = ServingRouter(
            replicas=[hung, dirty], clock=clock,
            step_deadline_ms=150.0 if watchdog else None,
            step_strike_budget=2, hedge_after_ms=2000.0,
            restart_backoff_s=0.0, max_replica_restarts=1)
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, counts, stalls = {}, {}, 0
        for r in reqs():
            router.submit(r)
        while router.in_flight and stalls < 3:
            before = router._progress_mark()
            for d in router.step():
                res[d.uid] = d
                counts[d.uid] = counts.get(d.uid, 0) + 1
            stalls = stalls + 1 if router._progress_mark() == before else 0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        path = "robustness" if watchdog else "robustness_no_watchdog"
        _expect(path, launches, {"paged_decode_attention": L * sum(
            s.decode_steps for s in built)})
        ttft = sorted((r.timing or {}).get("first_token", 0.0) * 1e3
                      for r in res.values()
                      if (r.timing or {}).get("first_token"))
        audits = {"runs": 0, "violations": 0, "repairs": 0}
        for s in built:
            for k, v in s.stats().get("audit", {}).items():
                if k in audits:
                    audits[k] += v
        dirty_audit = dirty.engine.stats().get("audit", {})
        final = router.audit_pool(repair=True)
        clean = {rid: r.ok for rid, r in router.audit_pool().items()}
        out = {
            "completion_rate": len(res) / ROBUST_REQUESTS,
            "stuck": sorted(set(range(ROBUST_REQUESTS)) - set(res)),
            "resolved_once": sorted(set(counts.values())) == [1],
            "completed_ok": sum(r.finish_reason == "length"
                                for r in res.values()),
            "deadline_cancelled": sum(r.finish_reason == "deadline"
                                      for r in res.values()),
            "ttft_p99_sim_ms": ttft[min(len(ttft) - 1, int(0.99 * len(
                ttft)))] if ttft else None,
            "counters": {k: v for k, v in router.counters.items() if v},
            "audit": audits, "dirty_audit": dirty_audit,
            "final_audit_clean": clean,
            "injected": {r.replica_id: [list(map(str, ev))
                                        for ev in r.injected]
                         for r in (hung, dirty)},
            "wall_s": wall, "launches": launches}
        return out, dirty_audit, final, clean, launches

    with_wd, dirty_audit, final, clean, counts = run_pool(True)
    if with_wd["completion_rate"] != 1.0 or not with_wd["resolved_once"]:
        raise AssertionError(f"robustness: the watchdog pool lost or "
                             f"duplicated work ({with_wd})")
    if not dirty_audit.get("repairs", 0) >= 1 or not clean.get("dirty") \
            or not all(clean.values()):
        raise AssertionError(f"robustness: the dirty replica's audits "
                             f"{dirty_audit}, final {clean}")
    without_wd, _, _, _, counts_off = run_pool(False)

    degr = engine.serving(
        max_slots=2, max_context=1024, prefill_chunk=128,
        enable_prefix_caching=True,
        degradation={"enabled": True, "eval_interval": 1, "queue_high": 4,
                     "queue_low": 1, "free_block_low": 0.0,
                     "free_block_high": 0.0, "hold_steps": 2,
                     "shed_below_priority": 1})
    flood = [Request(uid=i, tokens=prompts[i % ROBUST_REQUESTS],
                     max_new_tokens=8, stop_on_eos=False, priority=1)
             for i in range(12)]
    flood += [Request(uid=f"low{i}", tokens=prompts[i], max_new_tokens=8,
                      stop_on_eos=False, priority=0) for i in range(2)]
    dres = degr.run(flood)
    dstats = degr.stats()["degradation"]
    occ = dstats["level_occupancy"]
    levels = list(occ)
    peak = max((i for i, n in enumerate(occ.values()) if n), default=0)
    if not (peak >= 2 and dstats["level"] == 0 and len(dres) == len(flood)):
        raise AssertionError(f"robustness: the ladder peaked at {peak} "
                             f"({levels[peak]}) and ended at "
                             f"{dstats['level']} ({dstats})")
    _clean_close("robustness ladder", degr)
    t_without = without_wd["ttft_p99_sim_ms"]
    t_with = with_wd["ttft_p99_sim_ms"]
    emit({"phase": "robustness", "model": SPEC_CFG, "dtype": "bfloat16",
          "source": "bench.py:1112-1285", "requests": ROBUST_REQUESTS,
          "slots_per_replica": ROBUST_SLOTS,
          "completion_rate": with_wd["completion_rate"],
          "vs_baseline": t_without / max(1e-9, t_with)
          if t_with and t_without else None,
          "with_watchdog": with_wd, "without_watchdog": without_wd,
          "degradation": {"completed": len(dres), "sheds": dstats["sheds"],
                          "escalations": dstats["escalations"],
                          "deescalations": dstats["deescalations"],
                          "peak_level": peak, "final_level": dstats["level"],
                          "level_occupancy": occ},
          "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": state["nvidia_smi"]})
    return {"robustness": counts, "robustness_no_watchdog": counts_off}


def phase_fabric(state):
    """bench.py's fabric lane through the port: replica-server processes of
    the tiny engine on the card behind the router — SIGKILL rounds, a
    SIGSTOP round, a 1-process pool with no restart budget, and the
    observability plane off then on. Every child reports a CUDA device and
    its own kernel launches."""
    import shutil
    import signal as _signal
    import tempfile
    from deepspeed_tpu_torch.config.core import TelemetryConfig
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.serving import (RemoteConfig, RemoteReplica,
                                             ReplicaProcess, ServingRouter)
    from deepspeed_tpu_torch.testing.chaos import kill_replica_process
    t_phase = time.perf_counter()
    n_req, rounds, hb = FABRIC_REQUESTS, FABRIC_KILLS, FABRIC_HEARTBEAT_S
    cfg = RemoteConfig(heartbeat_interval_s=hb, heartbeat_miss_budget=4,
                       step_timeout_s=300.0)
    rng = np.random.default_rng(0)
    spawn_s, respawn_s = {}, []    # spawn to ready a pool; the respawns
    procs = []                     # every process this phase starts
    devices = []
    out_dir = tempfile.mkdtemp(prefix="fabric_obs_")
    obs_on = {"enabled": True, "tracing": True, "flight_recorder": True,
              "prometheus": False, "jsonl": False,
              "output_path": f"{out_dir}/rep"}

    def batch(tag):
        return [Request(uid=f"{tag}-{i}",
                        tokens=rng.integers(0, 200, (int(rng.integers(
                            4, 24)),)).astype(np.int32),
                        max_new_tokens=6, stop_on_eos=False)
                for i in range(n_req)]

    def spawn(n, telemetry=None):
        kw = dict(FABRIC_MODEL)
        if telemetry is not None:
            kw["telemetry"] = telemetry
        ps = [ReplicaProcess(factory=FABRIC_FACTORY, factory_kwargs=kw,
                             heartbeat_interval_s=hb,
                             replica_id=f"r{i}").spawn() for i in range(n)]
        procs.extend(ps)
        return ps

    def pool(name, ps):
        handles = []
        for i, p in enumerate(ps):
            p.wait_ready(180.0)
            h = RemoteReplica(process=p, replica_id=f"r{i}", config=cfg)
            devices.append(h.stats()["device"])
            h.restart = _timed_restart(h)
            handles.append(h)
        spawn_s[name] = time.perf_counter() - t_spawn
        return handles

    def _timed_restart(h):
        restart = h.restart

        def timed():
            t0 = time.perf_counter()
            restart()
            respawn_s.append(time.perf_counter() - t0)
            devices.append(h.stats()["device"])
        return timed

    def drive(router, done, on_step=None, max_stalls=None):
        stalls = 0
        while router.in_flight or router._finished_buf:
            before = router._progress_mark()
            try:
                for d in router.step():
                    done[d.uid] = d
            except RuntimeError:
                break
            if on_step is not None:
                on_step()
            if max_stalls is not None:
                stalls = stalls + 1 \
                    if router._progress_mark() == before else 0
                if stalls >= max_stalls:
                    break

    try:
        # every pool's processes start together (their boots overlap); an
        # arm waits for its own
        t_spawn = time.perf_counter()
        pending = {"failover": spawn(2), "degraded": spawn(1),
                   "obs_off": spawn(2), "obs_on": spawn(2, obs_on)}
        # ---- failover arm: SIGKILL r0 while it owns work, each round ----
        handles = pool("failover", pending["failover"])
        router = ServingRouter(replicas=handles,
                               max_replica_restarts=rounds + 1,
                               restart_backoff_s=0.0)
        submitted = completed = 0
        detect, st = [], {}

        def kill_and_time():
            if not st["killed"] and any(
                    rec.replica == "r0" for rec in router._pending.values()):
                kill_replica_process(handles[0], _signal.SIGKILL)
                st.update(killed=True, t_kill=time.perf_counter())
            if st["killed"] and st["t_kill"] is not None and \
                    router.counters["replica_failures"] > st["fail0"]:
                detect.append(time.perf_counter() - st["t_kill"])
                st["t_kill"] = None

        t_arm = time.perf_counter()
        for rnd in range(rounds):
            done = {}
            st.update(killed=False, t_kill=None,
                      fail0=router.counters["replica_failures"])
            for r in batch(f"k{rnd}"):
                router.submit(r)
            submitted += n_req
            drive(router, done, on_step=kill_and_time)
            completed += len(done)
            if not st["killed"]:
                raise AssertionError(f"fabric: round {rnd} never killed r0")
        failover_wall = time.perf_counter() - t_arm
        failover_rate = completed / submitted
        arm_s = {"failover": failover_wall}
        t_arm = time.perf_counter()

        # ---- the hung round: SIGSTOP, found by the heartbeat budget ----
        done = {}
        for r in batch("stop"):
            router.submit(r)
        submitted += n_req
        while not any(rec.replica == "r0"
                      for rec in router._pending.values()):
            for d in router.step():
                done[d.uid] = d
        kill_replica_process(handles[0], _signal.SIGSTOP)
        t_stop = time.perf_counter()
        while handles[0].heartbeat_alive() and \
                time.perf_counter() - t_stop < 30.0:
            time.sleep(0.02)
        hang_detect_s = time.perf_counter() - t_stop
        drive(router, done)
        completed += len(done)
        rate = completed / submitted
        pool_after = len(router._healthy())
        ctr = dict(router.counters)
        for h in handles:
            h.close()
        arm_s["hung"] = time.perf_counter() - t_arm
        t_arm = time.perf_counter()

        # ---- degraded arm: one process, no restart budget ---------------
        handles1 = pool("degraded", pending["degraded"])
        router1 = ServingRouter(replicas=handles1, max_replica_restarts=0)
        deg_done = {}
        for r in batch("deg"):
            router1.submit(r)
        for d in router1.step():
            deg_done[d.uid] = d
        kill_replica_process(handles1[0], _signal.SIGKILL)
        drive(router1, deg_done, max_stalls=3)
        deg_rate = len(deg_done) / n_req
        for h in handles1:
            h.close()
        arm_s["degraded"] = time.perf_counter() - t_arm

        # ---- observability arm: the plane off, then on -----------------
        def obs_arm(tag, router_tel):
            t0_arm = time.perf_counter()
            hs = pool(f"obs_{tag}", pending[f"obs_{tag}"])
            r = ServingRouter(replicas=hs, telemetry_config=router_tel)
            rng2 = np.random.default_rng(7)
            rq = [Request(uid=f"{tag}-{i}", tokens=rng2.integers(
                0, 200, (int(rng2.integers(4, 24)),)).astype(np.int32),
                max_new_tokens=6, stop_on_eos=False)
                for i in range(n_req * FABRIC_OBS_ROUNDS)]
            r.run(rq[:1])
            t0 = time.perf_counter()
            res = r.run(rq[1:])
            wall = time.perf_counter() - t0
            toks = sum(len(d.tokens) for d in res.values())
            if r.telemetry.enabled:
                r.observability_snapshot(refresh=True)
            snap = r.telemetry.registry.snapshot() \
                if r.telemetry.enabled else {}
            steps = max(1, r.steps)
            child = [h.stats() for h in hs]
            r.telemetry.close()
            for h in hs:
                h.close()
            arm_s[f"obs_{tag}"] = time.perf_counter() - t0_arm
            return toks / max(wall, 1e-9), snap, steps, child, len(res)

        tps_off, _, _, child_off, n_off = obs_arm("off", None)
        tps_on, snap, steps, child_on, n_on = obs_arm(
            "on", TelemetryConfig(enabled=True, prometheus=False,
                                  jsonl=False, tracing=True,
                                  flight_recorder=True,
                                  output_path=f"{out_dir}/router"))
    finally:
        for p in procs:             # SIGSTOPped ones too: SIGKILL ends them
            p.kill()
            p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    if n_off != n_req * FABRIC_OBS_ROUNDS - 1 or n_on != n_off:
        raise AssertionError(f"fabric observability arm completed "
                             f"{n_off} / {n_on}")
    # the children's own launches: row 5 on every decode step of each
    # engine (the obs-off arm's two children, alive from spawn to the end)
    from deepspeed_tpu_torch.testing.fabric import TINY_DEFAULTS
    launches = {}
    for s in child_off:
        _expect("fabric child", s["launches"], {
            "paged_decode_attention": TINY_DEFAULTS["n_layer"]
            * s["decode_steps"]})
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if not all(d["type"] == FABRIC_DEVICE_TYPE for d in devices):
        raise AssertionError(f"fabric: a child is not on the card: "
                             f"{devices}")
    if failover_rate != 1.0 or rate != 1.0:
        raise AssertionError(f"fabric: completion {failover_rate} over the "
                             f"kill rounds, {rate} with the hung round")
    if not hang_detect_s < 30.0:
        raise AssertionError(f"fabric: the SIGSTOPped replica was not "
                             f"declared dead in {hang_detect_s:.1f} s")
    if not deg_rate < 1.0:
        raise AssertionError(f"fabric: the degraded arm lost no work "
                             f"({deg_rate})")

    def _ctr(name):
        return float(snap.get(name, {}).get("value", 0.0))

    ds = sorted(detect)
    emit({"phase": "fabric", "model": FABRIC_MODEL,
          "source": "bench.py:1288-1560", "requests_per_round": n_req,
          "kill_rounds": rounds, "heartbeat_interval_s": hb,
          "heartbeat_miss_budget": cfg.heartbeat_miss_budget,
          "step_timeout_s": cfg.step_timeout_s,
          "completion_rate": rate, "failover_completion_rate": failover_rate,
          "vs_baseline": rate / max(deg_rate, 1.0 / n_req),
          "kill_detect_s": ds,
          "kill_detect_p50_s": ds[len(ds) // 2] if ds else None,
          "kill_detect_p99_s": ds[min(len(ds) - 1, int(0.99 * len(ds)))]
          if ds else None,
          "hang_detect_s": hang_detect_s,
          "replica_failures": ctr["replica_failures"],
          "replica_restarts": ctr["replica_restarts"],
          "reroutes": ctr["reroutes"], "pool_size_after": pool_after,
          "failover_wall_s": failover_wall, "arm_s": arm_s,
          "degraded": {"completion_rate": deg_rate},
          "observability": {
              "tokens_s_plane_off": tps_off, "tokens_s_plane_on": tps_on,
              "overhead_frac": 1.0 - tps_on / max(tps_off, 1e-9),
              "pulls": int(_ctr("obs/pulls")),
              "pulled_spans": int(_ctr("obs/pull_spans")),
              "pull_bytes_per_step": _ctr("obs/pull_bytes") / steps},
          "spawn_to_ready_s": spawn_s, "respawn_s": respawn_s,
          "processes": len(procs),
          "children_devices": devices, "child_launches": launches,
          "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": state["nvidia_smi"]})
    return {"fabric": launches}


# profiler sessions a norm op's trace check may take when one records
# no device event at all
NORM_TRACE_SESSIONS = 3


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
    # a profiler session after the kernels phase's many can lose some or
    # all of its device events (fused_layer_norm's kernel in 0.4 down to 0
    # of its 10 calls as that phase grew, PERF.md; fused_rms_norm's in all
    # of a later session once): main runs this phase before the kernels
    # phase, and one session first, its trace printed
    _, dropped = _device_ms(lambda: norms.fused_rms_norm(x, scale, 1e-5))
    kernels, sessions = {}, {}
    for name, call in (
            ("fused_layer_norm", lambda: norms.fused_layer_norm(
                x, scale, bias, 1e-5, residual=res)),
            ("fused_rms_norm", lambda: norms.fused_rms_norm(x, scale, 1e-5))):
        # the wrapper counts its launches (one a call, above); the trace
        # shows that nothing else runs, no cast of the parameters (a long
        # run's profiler drops some events, so its counts are not exact).
        # A session that recorded no device event at all (seen once, in
        # the first phase after the build) is taken again, at most
        # NORM_TRACE_SESSIONS times; the check is on what a session saw
        for sessions[name] in range(1, NORM_TRACE_SESSIONS + 1):
            _, kernels[name] = _device_ms(call)
            if kernels[name]:
                break
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
          "trace_sessions": sessions,
          "first_session_kernels_a_call": dropped,
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
    # tokens
    cpu_spec = make_gpt_decode_model(
        dataclasses.replace(cfg, dtype=torch.float32), name="gpt2-125m",
        params=spec.params)
    cpu = init_inference(cpu_spec, config={
        "dtype": "float32", "kv_cache_dtype": "float32"}, device="cpu")
    errs, ref_std = _logits_vs_cpu(engine, cpu, prompts)
    emit({"phase": "generate", "model": "gpt2-125m", "dtype": "bfloat16",
          "batch": 4, "prompt_lens": lens, "max_new_tokens": new,
          "setup_s": setup_s, "seconds": dt, "tokens_per_s": 4 * new / dt,
          "launches": counts, "logit_max_abs_err": errs,
          "logit_rel_err": {k: e / ref_std for k, e in errs.items()},
          "logit_rel_tol": LOGIT_TOL / LOGIT_REF_STD,
          "logit_ref_std": ref_std})
    state.update(spec=spec, engine=engine, prompts=prompts, generate_s=dt,
                 n_layer=L)
    return counts


def _logits_vs_cpu(engine, cpu, prompts):
    """The card engine's prefill logits at each prompt's last token and its
    first decode step's logits against the CPU engine's on the same padded
    prompts (the CPU side decodes the token the card chose): ({"prefill",
    "decode"}: max abs error, the CPU prefill logits' std). Each error over
    that std must stay within LOGIT_TOL / LOGIT_REF_STD."""
    import torch
    padded, plens = engine._pad_ragged(prompts)
    B, dev = len(prompts), engine.device
    errs = {}
    with torch.inference_mode():
        logits, cache = engine.forward(padded)
        rows = torch.arange(B, device=dev)
        last = logits[rows, torch.as_tensor(plens, device=dev).long() - 1]
        tok = last.argmax(-1).to(torch.int32)
        pos = torch.as_tensor(plens, device=dev).long()
        dec, _ = engine.model_spec.decode_fn(engine.params, tok, pos, cache)
        c_logits, c_cache = cpu.forward(padded)
        c_last = c_logits[torch.arange(B), torch.as_tensor(plens).long() - 1]
        c_dec, _ = cpu.model_spec.decode_fn(cpu.params, tok.cpu(),
                                            pos.cpu(), c_cache)
    ref_std = float(c_last.float().std())
    for name, a, b in (("prefill", last, c_last), ("decode", dec, c_dec)):
        a = a.float().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} logits not finite")
        errs[name] = (a - b).abs().max().item()
        if errs[name] / ref_std > LOGIT_TOL / LOGIT_REF_STD:
            raise AssertionError(
                f"{name} logits err {errs[name]} at std {ref_std}: "
                f"{errs[name] / ref_std} of it > "
                f"{LOGIT_TOL / LOGIT_REF_STD}")
    return errs, ref_std


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
    full width, NORTH_LAYERS deep, random weights from a numpy seed, ZeRO
    3, gas 64,
    through initialize() -> train_batch(): 1 warm-up step, NORTH_STEPS
    timed steps, exact flash launches, a finite loss, seconds a step,
    tokens/s and MFU, the registry's readings beside them."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS, make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    cfg = dataclasses.replace(GPT2_CONFIGS[NORTH_MODEL], n_layer=NORTH_LAYERS,
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
                  batch=2, attn_fn=None, cpu_over=None, extra=None):
    """The first step's loss and every parameter's gradient at 2 layers of
    the training model (B `batch`, T `seq`, through `attn_fn` if given): the
    engine on the card in bf16 against the engine on the CPU in fp32, from
    the same (bf16-rounded) weights and batch. `cpu_over` changes fields of
    the CPU twin's config (the long-context lane's twin takes the
    unchunked loss); `extra` adds batch leaves (routing directives) to
    both."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import init_gpt_params, make_gpt_model
    from deepspeed_tpu_torch.utils.tree import tree_cast
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
            small, dtype=torch.float32, softmax_dtype=torch.float32,
            **(cpu_over or {})), name=name, params=params, attn_fn=attn_fn),
        config={**config, "bf16": {"enabled": False}}, device="cpu")
    batch_t = {"tokens": torch.from_numpy(toks),
               **{k: torch.from_numpy(v) for k, v in (extra or {}).items()}}
    return {"n_layer": 2, "batch": batch, "seq": seq,
            "cpu_over": cpu_over, "extra": sorted(extra or ()),
            **_engine_parity(name, card, cpu, batch_t)}


def _engine_parity(name, card, cpu, batch):
    """The first step's loss and every parameter's gradient of the card
    engine against the CPU engine on `batch`: the loss within
    TRAIN_LOSS_TOL, each leaf's ||card - cpu|| / ||cpu|| within
    TRAIN_GRAD_REL_TOL."""
    import torch
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    g_card, l_card, _ = card._grads(card.state.params, batch)
    g_cpu, l_cpu, _ = cpu._grads(cpu.state.params, batch)
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
    return {"loss_card": float(l_card), "loss_cpu": float(l_cpu),
            "loss_abs_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
            "grad_rel_err": rel, "grad_rel_tol": TRAIN_GRAD_REL_TOL}


def _plain_ce(x, w, labels):
    """gpt_loss's plain cross entropy over x [N, D] and the table w [V, D]:
    logits in x's dtype, the max taken there, the log-sum-exp in fp32; the
    masked mean over the labels >= 0."""
    import torch
    logits = x @ w.t()
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = m[:, 0].float() + torch.log(
        torch.exp((logits - m).float()).sum(dim=-1))
    gold = logits.gather(-1, labels.clamp_min(0).long()[:, None])[:, 0]
    return logz - gold.float()


def _ce_fwd_bwd(fn, x, w, labels):
    """(nll, dx, dw) of the masked mean of `fn(x, w, labels)`'s nll."""
    import torch
    xg, wg = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    nll = fn(xg, wg, labels)
    mask = (labels >= 0).float()
    dx, dw = torch.autograd.grad((nll * mask).sum() / mask.sum(), (xg, wg))
    return nll.detach(), dx, dw


def _chunked_ce_card():
    """The chunked-vocab CE at the longctx micro-batch's head, bf16 and
    fp32, against the plain CE in fp32 on the same values: nll, dx and dw
    each beside its limit (CE_TOL); the peak memory above the inputs of the
    chunked op and of gpt_loss's plain CE in bf16, forward + backward (the
    chunked must be lower); the chunked op's host time a call (enqueue) and
    device time (profiler), beside the plain CE's."""
    import torch
    from deepspeed_tpu_torch.ops.chunked_ce import chunked_softmax_xent
    gen = np.random.default_rng(17)
    x32 = torch.from_numpy(gen.standard_normal((CE_N, CE_D)).astype(
        np.float32)).cuda()
    w32 = torch.from_numpy((0.02 * gen.standard_normal((CE_V, CE_D))).astype(
        np.float32)).cuda()
    labels = gen.integers(0, CE_V, CE_N)
    labels[gen.random(CE_N) < 0.05] = -1
    labels = torch.from_numpy(labels).cuda()
    chunked = lambda x, w, lab: chunked_softmax_xent(x, w, lab, CE_CHUNKS)
    out = {"shape": {"N": CE_N, "D": CE_D, "V": CE_V, "chunks": CE_CHUNKS},
           "masked_labels": int((labels < 0).sum())}
    for dtype in ("float32", "bfloat16"):
        x, w = (t.to(getattr(torch, dtype)) for t in (x32, w32))
        nll, dx, dw = _ce_fwd_bwd(chunked, x, w, labels)
        rn, rdx, rdw = _ce_fwd_bwd(_plain_ce, x.float(), w.float(), labels)
        tol = CE_TOL[dtype]
        err = {"nll": (nll - rn).abs().max().item(), "nll_tol": tol["nll"]}
        for name, a, b in (("dx", dx, rdx), ("dw", dw, rdw)):
            scale = b.abs().max().item()
            err[name] = (a.float() - b).abs().max().item()
            err[name + "_tol"] = tol["grad_rel"] * scale
        out[dtype] = err
        if not (err["nll"] <= err["nll_tol"] and err["dx"] <= err["dx_tol"]
                and err["dw"] <= err["dw_tol"]):
            raise AssertionError(f"chunked CE {dtype}: {err}")
        del nll, dx, dw, rn, rdx, rdw
    x, w = x32.bfloat16(), w32.bfloat16()
    del x32, w32
    peak = {}
    for name, fn in (("chunked", chunked), ("plain", _plain_ce)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _ce_fwd_bwd(fn, x, w, labels)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
    if not peak["chunked"] < peak["plain"]:
        raise AssertionError(f"chunked CE peak {peak} not below the plain's")
    out["peak_bytes_bf16"] = peak
    for name, fn in (("chunked", chunked), ("plain", _plain_ce)):
        call = lambda: _ce_fwd_bwd(fn, x, w, labels)
        out[name + "_device_ms"], _ = _device_ms(call, calls=5)
        out[name + "_host_ms"] = _host_ms(call, calls=10)
        out[name + "_ms"] = median_ms(call, reps=5, inner=1)
    return out


def _longctx_cfg(seq):
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS
    return dataclasses.replace(
        GPT2_CONFIGS[LONGCTX_MODEL], n_layer=LONGCTX_LAYERS, max_seq_len=seq,
        remat_policy=TRAIN_POLICY, softmax_dtype=torch.bfloat16,
        loss_chunks=LONGCTX_LOSS_CHUNKS)


def _longctx_config(gas):
    return {**BENCH_ENGINE_CONFIG, "train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": gas,
            "zero_optimization": {"stage": 1},
            "data_types": {"grad_accum_dtype": "bf16"},
            "telemetry": REGISTRY_ONLY}


def _micro_peak(engine, micro):
    """Peak device memory of one micro-batch's forward and backward through
    the engine's loss (the engine's state included)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine._micro_grads(engine.state.params, micro)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _phase_longctx(state, path):
    """bench.py's `path` lane (LONGCTX) through initialize() ->
    train_batch(): 1 warm-up and LONGCTX_STEPS timed steps; exact flash
    launches (2 x 24 x gas forward, 24 x gas each backward kernel a step),
    finite losses (longctx: falling too); seconds a step, tokens/s, MFU
    (6N) and bench.py's attention-inclusive mfu_attn (bench.py:300-306:
    + 12 x tokens x seq x d_model x n_layer a step), the registry's
    readings, host against kernel time of one micro-batch, the step's and
    one micro-batch's peak memory (each above what was allocated before
    initialize(), so what earlier phases left on the card is not in it:
    the lane's engine, state and activations). longctx also: the chunked CE on the card
    (`_chunked_ce_card`), one micro-batch's peak with loss_chunks 0 (it
    must be higher), and the 2-layer first-step parity against the fp32
    CPU twin with loss_chunks 0 at seq 4096."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    t_phase = time.perf_counter()
    seq, gas = LONGCTX[path]["seq"], LONGCTX[path]["gas"]
    out = {"phase": path, "estimate_s": PHASE_ESTIMATE_S[path]}
    if path == "longctx":
        out["chunked_ce"] = _chunked_ce_card()
    cfg = _longctx_cfg(seq)
    config = _longctx_config(gas)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine, *_ = initialize(model=make_gpt_model(cfg, name=LONGCTX_MODEL,
                                                 seed=0), config=config)
    setup_s = time.perf_counter() - t0
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (gas, seq + 1))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = [float(engine.train_batch(batch))]             # warm-up
    engine.telemetry.registry.clear()
    LAUNCHES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(LONGCTX_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - t0)
    counts = dict(LAUNCHES)
    peak_step = torch.cuda.max_memory_allocated() - base
    L, d = cfg.n_layer, cfg.d_model
    _expect(path, counts, {
        "flash_attention": 2 * L * gas * LONGCTX_STEPS,
        "flash_attention_bwd_dq": L * gas * LONGCTX_STEPS,
        "flash_attention_bwd_dkv": L * gas * LONGCTX_STEPS})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{path} losses not finite: {losses}")
    if path == "longctx" and not losses[-1] < losses[0]:
        raise AssertionError(f"{path} losses not falling: {losses}")
    n_params = tree_num_params(engine.state.params)
    sec = statistics.median(step_s)
    tokens = gas * seq
    micro = {k: v[:1] for k, v in batch.items()}
    peak_micro = {"loss_chunks_8": _micro_peak(engine, micro) - base}
    out.update(
        model=LONGCTX_MODEL, n_layer=L, n_params=n_params, seq=seq,
        config=config, loss_chunks=cfg.loss_chunks, remat=cfg.remat_policy,
        setup_s=setup_s, losses=losses, step_s=step_s,
        seconds_per_step=sec, tokens_per_s=tokens / sec,
        mfu=6 * n_params * tokens / sec / BF16_FLOPS,
        mfu_attn=(6 * n_params * tokens + 12 * tokens * seq * d * L)
        / sec / BF16_FLOPS,
        mfu_basis="6 x params x tokens (mfu_attn: + 12 x tokens x seq x "
                  "d_model x n_layer, bench.py:300-306) a step over "
                  "989e12 flop/s",
        registry=_train_registry(engine.telemetry.registry.snapshot(),
                                 LONGCTX_STEPS, sec),
        micro_batch_s=_micro_times(engine, micro), launches=counts,
        baseline_bytes=base, peak_bytes_step=peak_step)
    if path == "longctx":
        cfg.loss_chunks = 0     # the engine's loss holds this cfg
        try:
            peak_micro["loss_chunks_0"] = _micro_peak(engine, micro) - base
        finally:
            cfg.loss_chunks = LONGCTX_LOSS_CHUNKS
        if not peak_micro["loss_chunks_8"] < peak_micro["loss_chunks_0"]:
            raise AssertionError(f"{path} micro-batch peak {peak_micro}: "
                                 f"the chunked loss is not lower")
    out["peak_bytes_micro_batch"] = peak_micro
    del engine, batch, micro, toks
    torch.cuda.empty_cache()
    if path == "longctx":
        out["parity"] = _train_parity(
            cfg, name=LONGCTX_MODEL, config=config, seq=seq, batch=1,
            cpu_over={"loss_chunks": 0})
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return counts


def phase_longctx(state):
    return _phase_longctx(state, "longctx")


def phase_longctx16k(state):
    return _phase_longctx(state, "longctx16k")


class _FlashSeqs:
    """Records the T and the causal flag of every flash forward call a
    model module (`models.gpt`, `models.bert`) makes while a `with` block
    runs, by wrapping its `flash_attention` from here (the remat replay
    calls it again)."""

    def __init__(self, module="gpt"):
        import importlib
        self.module = importlib.import_module(
            f"deepspeed_tpu_torch.models.{module}")

    def __enter__(self):
        self.seen, self.causal = [], []
        self._orig = self.module.flash_attention

        def spy(q, k, v, **kw):
            self.seen.append(int(q.shape[1]))
            self.causal.append(bool(kw.get("causal", True)))
            return self._orig(q, k, v, **kw)
        self.module.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self._orig


def _routing_run(name, cfg, params, toks):
    """One directive's run: the engine with ROUTING_CONFIG plus the
    directive's block, ROUTING_STEPS steps on one batch with the launch
    counts from 0, the directives the engine drew each step (recorded by
    wrapping its `_inject_routing_directives` from here) and the T of every
    flash forward. Returns (counts, record)."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    engine, *_ = initialize(
        model=make_gpt_model(cfg, name=f"{TRAIN_MODEL}-{name}",
                             params=params),
        config={**ROUTING_CONFIG, **ROUTING_DIRECTIVES[name]})
    drawn = []
    inject = engine._inject_routing_directives

    def record(batch):
        leaves = inject(batch)
        drawn.append({k: np.asarray(v) for k, v in leaves.items()
                      if k.startswith(("pld_", "ltd_"))})
        return leaves
    engine._inject_routing_directives = record
    if name == "curriculum":    # explicit labels: the model's T is the cut
        batch = {"input_ids": toks[:, :-1], "labels": toks[:, 1:]}
    else:
        batch = {"tokens": toks}
    losses, step_s, seqs, difficulty = [], [], [], []
    LAUNCHES.clear()
    for _ in range(ROUTING_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _FlashSeqs() as fs:
            losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - t0)
        seqs.append(fs.seen)
        if engine.curriculum_scheduler is not None:
            difficulty.append(engine.curriculum_scheduler.current_difficulty)
    counts = dict(LAUNCHES)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"routing {name} losses not finite: {losses}")
    del engine
    torch.cuda.empty_cache()
    return counts, dict(losses=losses, step_s=step_s, drawn=drawn,
                        seqs=seqs, difficulty=difficulty)


def phase_routing(state):
    """The routing directives through initialize() -> train_batch() on
    gpt2-760m at full width and depth (ROUTING_CONFIG, ROUTING_DIRECTIVES),
    each run's launches from 0: PLD — flash forward 2 x gas x the kept
    layers the engine drew, summed over the steps, each backward kernel
    gas x kept; random-LTD — every layer launches (2 x 24 x gas forward a
    step), layers 1-22 at T 256, layers 0 and 23 at 512, and the 2-layer
    first-step parity (start 1, one routed layer, K 256) against the fp32
    CPU twin fed the same directives; the curriculum — each step's T equal
    to the scheduler's difficulty, 128, 320, 512. Losses finite
    throughout. Returns the three runs' launches summed (the `routing`
    path)."""
    import collections
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS, init_gpt_params
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GPT2_CONFIGS[TRAIN_MODEL],
                              remat_policy=TRAIN_POLICY,
                              softmax_dtype=torch.bfloat16)
    params = init_gpt_params(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (ROUTING_MBS * ROUTING_GAS,
                            ROUTING_SEQ + 1))).cuda()
    L, gas = cfg.n_layer, ROUTING_GAS
    total = collections.Counter()
    out = {"phase": "routing", "estimate_s": PHASE_ESTIMATE_S["routing"],
           "model": TRAIN_MODEL, "config": ROUTING_CONFIG,
           "directives": ROUTING_DIRECTIVES}
    for name in ROUTING_DIRECTIVES:
        counts, rec = _routing_run(name, cfg, params, toks)
        total.update(counts)
        if name == "pld":
            kept = [int(d["pld_keep_idx"].shape[1]) for d in rec["drawn"]]
            rec["kept_layers"] = kept
            rec["theta"] = [float(d["pld_theta"][0]) for d in rec["drawn"]]
            if not min(kept) < L:
                raise AssertionError(f"routing pld dropped no layer: {kept}")
            _expect("routing pld", counts, {
                "flash_attention": 2 * gas * sum(kept),
                "flash_attention_bwd_dq": gas * sum(kept),
                "flash_attention_bwd_dkv": gas * sum(kept)})
        elif name == "random_ltd":
            shapes = {tuple(d["ltd_keep_idx"].shape) for d in rec["drawn"]}
            want_t = sorted([ROUTING_SEQ] * 2 * 2 * gas
                            + [ROUTING_LTD_K] * 2 * (L - 2) * gas)
            if shapes != {(ROUTING_MBS * gas, L - 2, ROUTING_LTD_K)} or \
                    any(sorted(t) != want_t for t in rec["seqs"]):
                raise AssertionError(f"routing random_ltd: keep shapes "
                                     f"{shapes}, flash T "
                                     f"{[collections.Counter(t) for t in rec['seqs']]}")
            _expect("routing random_ltd", counts, {
                "flash_attention": 2 * L * gas * ROUTING_STEPS,
                "flash_attention_bwd_dq": L * gas * ROUTING_STEPS,
                "flash_attention_bwd_dkv": L * gas * ROUTING_STEPS})
            gen = np.random.default_rng(13)
            keep = np.sort(np.argpartition(gen.random((2, 1, ROUTING_SEQ)),
                                           ROUTING_LTD_K - 1, axis=-1)
                           [..., :ROUTING_LTD_K], axis=-1).astype(np.int32)
            rec["parity"] = _train_parity(
                cfg, name=TRAIN_MODEL, config=TRAIN_CONFIG, seq=ROUTING_SEQ,
                batch=2, extra={"ltd_keep_idx": keep,
                                "ltd_start": np.zeros((2, 1), np.int8)})
        else:
            if rec["difficulty"] != [128, 320, 512] or any(
                    set(t) != {d} for t, d in zip(rec["seqs"],
                                                  rec["difficulty"])):
                raise AssertionError(
                    f"routing curriculum: difficulty {rec['difficulty']}, "
                    f"flash T {[sorted(set(t)) for t in rec['seqs']]}")
            _expect("routing curriculum", counts, {
                "flash_attention": 2 * L * gas * ROUTING_STEPS,
                "flash_attention_bwd_dq": L * gas * ROUTING_STEPS,
                "flash_attention_bwd_dkv": L * gas * ROUTING_STEPS})
        rec["launches"] = counts
        rec["flash_seqs"] = [dict(collections.Counter(t))
                             for t in rec.pop("seqs")]
        rec.pop("drawn")
        out[name] = rec
    out["launches"] = dict(total)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return dict(total)


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


def _bert_batch(seq, mbs, masked=False):
    """bench.py's bert lane batch (bench.py:1885-1888) on the card: ids
    default_rng(0).integers(0, 30000), 15 % of the positions labelled, -100
    elsewhere; `masked` adds the HF-style attention_mask of `_bert_lens`,
    with pad id 0 and label -100 past each row's length."""
    import torch
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 30000, (mbs, seq)).astype(np.int32)
    labels = np.where(rng.random((mbs, seq)) < 0.15, ids, -100) \
        .astype(np.int32)
    batch = {"input_ids": ids, "labels": labels}
    if masked:
        keep = np.arange(seq)[None] < _bert_lens(seq, mbs)[:, None]
        batch = {"input_ids": np.where(keep, ids, 0).astype(np.int32),
                 "labels": np.where(keep, labels, -100).astype(np.int32),
                 "attention_mask": keep.astype(np.int32)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _bert_parity(masked):
    """The first step's loss and every gradient at 2 layers of bert-large
    (B BERT_PARITY_BATCH, seq 128, the lane's batch rows, with the padded
    batch's mask where `masked`): the engine on the card in bf16 against
    the engine on the CPU in fp32 (the dense encoder arithmetic), from the
    same bf16-rounded weights."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.bert import (BERT_CONFIGS,
                                                 init_bert_params,
                                                 make_bert_model)
    from deepspeed_tpu_torch.utils.tree import tree_cast
    small = dataclasses.replace(BERT_CONFIGS[BERT_MODEL], n_layer=2)
    params = tree_cast(tree_cast(init_bert_params(small, seed=1),
                                 torch.bfloat16), torch.float32)
    seq, mbs = BERT_SHAPES[0]
    batch = {k: v[:BERT_PARITY_BATCH].cpu()
             for k, v in _bert_batch(seq, mbs, masked).items()}
    config = {**BERT_CONFIG,
              "train_micro_batch_size_per_gpu": BERT_PARITY_BATCH}
    name = f"{BERT_MODEL}-2-layers"
    card, *_ = initialize(model=make_bert_model(small, name=name,
                                                params=params),
                          config=config)
    cpu, *_ = initialize(
        model=make_bert_model(dataclasses.replace(small, dtype=torch.float32),
                              name=name, params=params),
        config={**config, "bf16": {"enabled": False}}, device="cpu")
    return {"n_layer": 2, "batch": BERT_PARITY_BATCH, "seq": seq,
            "masked": masked, **_engine_parity(name, card, cpu, batch)}


def _transformer_layer_parity(pre_layer_norm):
    """(c): DeepSpeedTransformerLayer at bert-large's width (hidden 1024,
    16 heads, intermediate 4096) on the card in bf16 with an additive [B,
    1, 1, T] key-padding bias (the block-sparse kernels, one launch each),
    against its fp32 CPU twin holding the card's weights: the output and
    the gradients of sum(out * g) for every parameter and the input, each
    ||card - cpu|| / ||cpu|| within TRAIN_GRAD_REL_TOL."""
    import torch
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    kw = dict(hidden_size=1024, heads=16, intermediate_size=4096,
              num_hidden_layers=24, pre_layer_norm=pre_layer_norm, seed=5)
    card = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(**kw),
                                     layer_id=0).cuda()
    cpu = DeepSpeedTransformerLayer(DeepSpeedTransformerConfig(
        **kw, bf16=False), layer_id=0)
    names = list(card.params)
    cpu_params = {n: p.detach().float().cpu().requires_grad_(True)
                  for n, p in card.params.items()}
    B, T = BERT_LAYER_BT
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((B, T, 1024)).astype(
        np.float32)).cuda().bfloat16().requires_grad_(True)
    lens = rng.integers(BERT_PAD_MIN, T + 1, B)
    bias = torch.from_numpy(np.where(np.arange(T)[None] < lens[:, None], 0.0,
                                     -1e30).astype(np.float32)[:, None, None])
    g = torch.from_numpy(rng.standard_normal((B, T, 1024)).astype(np.float32))
    LAUNCHES.clear()
    out = card(x, bias.cuda())
    grads = torch.autograd.grad((out.float() * g.cuda()).sum(),
                                [card.params[n] for n in names] + [x])
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    _expect("transformer_layer", counts,
            {"block_sparse_attention": 1, "block_sparse_attention_bwd_dq": 1,
             "block_sparse_attention_bwd_dkv": 1})
    xc = x.detach().float().cpu().requires_grad_(True)
    out_c = cpu(xc, bias, params=cpu_params)
    grads_c = torch.autograd.grad((out_c * g).sum(),
                                  [cpu_params[n] for n in names] + [xc])
    rel = {}
    for what, a, b in zip(["out", *names, "input"], [out, *grads],
                          [out_c, *grads_c]):
        a, b = a.detach().float().cpu(), b.detach()
        if not torch.isfinite(a).all():
            raise AssertionError(f"transformer layer {what} not finite")
        rel[what] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    worst = max(rel, key=rel.get)
    if rel[worst] > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"transformer layer (pre_layer_norm "
                             f"{pre_layer_norm}): {worst} {rel[worst]} > "
                             f"{TRAIN_GRAD_REL_TOL}")
    return {"pre_layer_norm": pre_layer_norm, "shape": [B, T, 1024],
            "launches": counts, "rel_err": rel,
            "rel_tol": TRAIN_GRAD_REL_TOL}


def phase_bert(state):
    """bench.py's bert lane (`run_bert_lane`): (a) initialize() ->
    train_batch() on bert-large at full width and depth, at each of
    BERT_SHAPES: BERT_WARMUP + BERT_STEPS steps, exact flash launches
    (forward 2 x 24, each backward 24 a step, all causal=False: the
    encoder site), finite falling losses, samples/s and MFU over the
    window of timed steps as bench.py times it (one sync at its end; then
    BERT_STEPS steps synced one by one as a reading), host against kernel
    time of a step; the 2-layer parity; (b) the seq-128 engine on
    the padded batch: exact block-sparse launches and no flash launch, the
    2-layer parity with the mask; (c) the DeepSpeedTransformerLayer
    frontend, pre- and post-LN, against its fp32 CPU twin. Returns the
    launches of the lane's timed steps (`bert`) and of (b)
    (`bert_padded`)."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.bert import (BERT_CONFIGS,
                                                 init_bert_params,
                                                 make_bert_model)
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    t_phase = time.perf_counter()
    cfg = BERT_CONFIGS[BERT_MODEL]
    L = cfg.n_layer
    params = init_bert_params(cfg, seed=0)
    out = {"phase": "bert", "estimate_s": PHASE_ESTIMATE_S["bert"],
           "model": BERT_MODEL, "n_layer": L, "config": BERT_CONFIG,
           "remat": cfg.remat, "warmup_steps": BERT_WARMUP,
           "timed_steps": BERT_STEPS,
           "reference_v100_samples_per_s": {
               "values": REF_BERT_SAMPLES_V100,
               "source": "bench.py:1846 REF_BERT_SAMPLES, the reference's "
                         "V100 figures (fastest-BERT post), not this card's"},
           "mfu_basis": "6 x params x tokens/s over 989e12 flop/s"}
    lane_counts = {}
    for seq, mbs in BERT_SHAPES:
        engine, *_ = initialize(
            model=make_bert_model(cfg, name=BERT_MODEL, params=params),
            config={**BERT_CONFIG, "train_micro_batch_size_per_gpu": mbs})
        batch = _bert_batch(seq, mbs)
        losses = [float(engine.train_batch(batch))
                  for _ in range(BERT_WARMUP)]
        LAUNCHES.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # timed as bench.py times the lane (bench.py:1889-1892): the window
        # of BERT_STEPS steps, one sync and one loss read at its end
        with _FlashSeqs("bert") as calls:
            t0 = time.perf_counter()
            window = [engine.train_batch(batch) for _ in range(BERT_STEPS)]
            float(window[-1])
            sec = (time.perf_counter() - t0) / BERT_STEPS
        losses += [float(x) for x in window]
        counts = dict(LAUNCHES)
        _expect(f"bert seq {seq}", counts, {
            "flash_attention": 2 * L * BERT_STEPS,
            "flash_attention_bwd_dq": L * BERT_STEPS,
            "flash_attention_bwd_dkv": L * BERT_STEPS})
        if calls.causal != [False] * (2 * L * BERT_STEPS):
            raise AssertionError(f"bert seq {seq}: a flash call was causal "
                                 f"({calls.causal.count(True)} of "
                                 f"{len(calls.causal)})")
        for name, n in counts.items():
            lane_counts[name] = lane_counts.get(name, 0) + n
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"bert seq {seq} losses not finite and "
                                 f"falling: {losses}")
        n_params = tree_num_params(engine.state.params)
        peak = torch.cuda.max_memory_allocated()
        # a reading beside the window: each step alone, a sync and a loss
        # read after each (what a sync every step costs the host's overlap)
        step_s = []
        for _ in range(BERT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(engine.train_batch(batch))
            step_s.append(time.perf_counter() - t0)
        lane = dict(seq=seq, micro_batch=mbs, n_params=n_params,
                    losses=losses, seconds_per_step=sec,
                    samples_per_s=mbs / sec, tokens_per_s=mbs * seq / sec,
                    mfu=6 * n_params * mbs * seq / sec / BF16_FLOPS,
                    synced_step_s=step_s,
                    synced_median_s=statistics.median(step_s),
                    peak_bytes=peak, launches=counts,
                    micro_batch_s=_micro_times(engine, batch))
        if seq == BERT_SHAPES[0][0]:
            pbatch = _bert_batch(seq, mbs, masked=True)
            LAUNCHES.clear()
            plosses, pstep_s = [], []
            for _ in range(BERT_PAD_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plosses.append(float(engine.train_batch(pbatch)))
                pstep_s.append(time.perf_counter() - t0)
            pad_counts = dict(LAUNCHES)
            _expect("bert_padded", pad_counts, {
                "block_sparse_attention": 2 * L * BERT_PAD_STEPS,
                "block_sparse_attention_bwd_dq": L * BERT_PAD_STEPS,
                "block_sparse_attention_bwd_dkv": L * BERT_PAD_STEPS})
            if not all(np.isfinite(plosses)):
                raise AssertionError(f"bert padded losses not finite: "
                                     f"{plosses}")
            out["padded"] = dict(
                seq=seq, micro_batch=mbs, steps=BERT_PAD_STEPS,
                lens_min=int(_bert_lens(seq, mbs).min()),
                lens_mean=float(_bert_lens(seq, mbs).mean()),
                losses=plosses, step_s=pstep_s, launches=pad_counts)
        out[f"seq{seq}"] = lane
        del engine, batch
        torch.cuda.empty_cache()
    out["parity"] = _bert_parity(False)
    out["padded"]["parity"] = _bert_parity(True)
    out["transformer_layer"] = [_transformer_layer_parity(pre)
                                for pre in (True, False)]
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return {"bert": lane_counts, "bert_padded": out["padded"]["launches"]}


def _llama_namespace(n_layer):
    """The HF config of LLAMA_HF at `n_layer` layers, as a plain object
    (the card's machine has no transformers)."""
    import types
    return types.SimpleNamespace(model_type="llama",
                                 num_hidden_layers=n_layer, **LLAMA_HF)


def _llama_state_dict(n_layer, seed=0):
    """An HF LlamaForCausalLM state dict of LLAMA_HF at `n_layer` layers in
    numpy fp32: HF's N(0, 0.02) weights (the untied head too), unit norm
    scales, HF key names (random rows: HF's rotate-half order is as
    good as any)."""
    rng = np.random.default_rng(seed)
    c = LLAMA_HF
    D, V, F_ = c["hidden_size"], c["vocab_size"], c["intermediate_size"]
    hd = D // c["num_attention_heads"]
    kv = c["num_key_value_heads"] * hd

    def w(*shape, std=0.02):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= std
        return a
    sd = {"model.embed_tokens.weight": w(V, D),
          "model.norm.weight": np.ones(D, np.float32)}
    for i in range(n_layer):
        b = f"model.layers.{i}."
        sd.update({
            b + "self_attn.q_proj.weight": w(D, D),
            b + "self_attn.k_proj.weight": w(kv, D),
            b + "self_attn.v_proj.weight": w(kv, D),
            b + "self_attn.o_proj.weight": w(D, D),
            b + "mlp.gate_proj.weight": w(F_, D),
            b + "mlp.up_proj.weight": w(F_, D),
            b + "mlp.down_proj.weight": w(D, F_),
            b + "input_layernorm.weight": np.ones(D, np.float32),
            b + "post_attention_layernorm.weight": np.ones(D, np.float32)})
    sd["lm_head.weight"] = w(V, D)
    return sd


def _llama_parity(sd):
    """Prefill and first-decode logits of the state dict's first
    LLAMA_PARITY_LAYERS layers (from_hf_llama) on short prompts: bf16 on the
    card against the fp32 CPU twin from the same bf16-rounded weights."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.adapters import from_hf_llama
    from deepspeed_tpu_torch.models.llama import make_llama_decode_model
    from deepspeed_tpu_torch.utils.tree import tree_cast
    n = LLAMA_PARITY_LAYERS
    cut = {k: v for k, v in sd.items() if not k.startswith("model.layers.")
           or int(k.split(".")[2]) < n}
    cfg, params = from_hf_llama(cut, _llama_namespace(n),
                                dtype=torch.float32)
    params = tree_cast(tree_cast(params, torch.bfloat16), torch.float32)
    card = init_inference(make_llama_decode_model(
        dataclasses.replace(cfg, dtype=torch.bfloat16), name="llama-cut",
        params=params), config=SERVE_ENGINE_CONFIG)
    cpu = init_inference(make_llama_decode_model(
        cfg, name="llama-cut", params=params),
        config={"dtype": "float32", "kv_cache_dtype": "float32"},
        device="cpu")
    prompts = _ragged_prompts(np.random.default_rng(14), LLAMA_PARITY_LENS,
                              cfg.vocab_size)
    errs, ref_std = _logits_vs_cpu(card, cpu, prompts)
    return {"n_layer": n, "prompt_lens": list(LLAMA_PARITY_LENS),
            "logit_max_abs_err": errs,
            "logit_rel_err": {k: e / ref_std for k, e in errs.items()},
            "logit_rel_tol": LOGIT_TOL / LOGIT_REF_STD,
            "logit_ref_std": ref_std}


def _forced_agreement(engine, prompts, served, group):
    """The served tokens against generate()'s own choices on the same
    prefixes: the contiguous path (generate's prefill, then its decode
    steps) fed each request's served tokens, its argmax after the prompt
    and after each served token held to the next served token, `group`
    requests at a time. With an untied random head the top-2 logit gap is
    often a few bf16 steps of the logits, so a free-running comparison
    diverges for good at the first near tie; this one counts each position
    once. Returns the share equal and, at the positions that differ,
    generate()'s top-2 gap."""
    import torch
    dev = engine.device
    same, differing = [], []
    for g in range(0, len(prompts), group):
        padded, plens = engine._pad_ragged(prompts[g:g + group])
        toks = torch.as_tensor(np.stack(served[g:g + group]), device=dev)
        B, new = toks.shape
        rows = torch.arange(B, device=dev)
        preds, gaps = [], []
        with torch.inference_mode():
            logits, cache = engine.forward(padded)
            step = logits[rows, torch.as_tensor(plens, device=dev).long() - 1]
            del logits
            pos = torch.as_tensor(plens, device=dev).long()
            for j in range(new):
                top = step.float().topk(2, dim=-1).values
                preds.append(step.argmax(-1))
                gaps.append(top[:, 0] - top[:, 1])
                if j < new - 1:
                    step, cache = engine.model_spec.decode_fn(
                        engine.params, toks[:, j].to(torch.int32), pos, cache)
                    pos = pos + 1
        eq = (torch.stack(preds, 1) == toks).cpu()
        same.append(eq)
        differing += [round(float(x), 5)
                      for x in torch.stack(gaps, 1).cpu()[~eq]]
        del cache
    return {"share": float(torch.cat(same).float().mean()),
            "positions": int(sum(e.numel() for e in same)),
            "differing_top2_gaps": differing}


def phase_llama(state):
    """Llama-3-8B's width (LLAMA_HF, LLAMA_LAYERS layers, bf16) built from a
    numpy HF state dict through from_hf_llama: generate() on LLAMA_LENS
    (flash prefill and the contiguous decode at GQA 4:1, exact launches,
    tokens/s), then the ServingEngine over the paged pool on
    LLAMA_SERVE_LENS (LLAMA_LENS first) through LLAMA_SLOTS slots of
    LLAMA_CONTEXT positions, 4 requests a slot (exact paged-decode
    launches, the last at position 4095, completion, a drained pool, the
    latency readings, the served tokens' agreement with generate()'s), and
    the 2-layer logits parity (`_llama_parity`).
    Returns the launches of both runs (`llama_generate`, `llama_serve`)."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.adapters import from_hf_llama
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.models.llama import make_llama_decode_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sd = _llama_state_dict(LLAMA_LAYERS)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, params = from_hf_llama(sd, _llama_namespace(LLAMA_LAYERS),
                                dtype=torch.bfloat16)
    adapt_s = time.perf_counter() - t0
    spec = make_llama_decode_model(cfg, name="llama3-8b-wide", params=params)
    engine = init_inference(spec, config=SERVE_ENGINE_CONFIG)
    del params
    L = cfg.n_layer
    prompts = _ragged_prompts(np.random.default_rng(13), LLAMA_SERVE_LENS,
                              cfg.vocab_size)
    gen_prompts = prompts[:len(LLAMA_LENS)]
    new = LLAMA_NEW
    if max(LLAMA_SERVE_LENS) + new - 2 != LLAMA_CONTEXT - 1:
        raise AssertionError("the longest request's last decode step must "
                             "read the context's last position")
    engine.generate(prompts[:1], max_new_tokens=2, stop_on_eos=False)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = engine.generate(gen_prompts, max_new_tokens=new,
                          stop_on_eos=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = dict(LAUNCHES)
    _expect("llama_generate", gen_counts, {
        "flash_attention": L, "decode_attention": L * (new - 1)})

    serving = engine.serving(max_slots=LLAMA_SLOTS,
                             max_context=LLAMA_CONTEXT)
    serving.run([Request(uid="warm", tokens=prompts[1], max_new_tokens=2,
                         stop_on_eos=False)])
    serving.telemetry.registry.clear()
    reqs = [Request(uid=i, tokens=p, max_new_tokens=new, stop_on_eos=False)
            for i, p in enumerate(prompts)]
    steps0 = serving.stats()["decode_steps"]
    res, serve_s, serve_counts = _timed_run(serving, reqs)
    _completed("llama_serve", res, reqs)
    steps = (serving.stats()["decode_steps"] - steps0) * serving.window
    _expect("llama_serve", serve_counts,
            {"paged_decode_attention": L * steps})
    if serving.allocator.num_free != serving.allocator.capacity:
        raise AssertionError("llama_serve: blocks leaked after draining")
    latency = _latency("llama_serve", serving, reqs)
    served = [np.asarray(res[i].tokens) for i in range(len(prompts))]
    free = float(np.mean([np.mean(served[i] == gen[i])
                          for i in range(len(gen_prompts))]))
    agree = _forced_agreement(engine, prompts, served, LLAMA_SLOTS)
    if not agree["share"] >= SERVE_AGREE_MIN:
        raise AssertionError(f"llama served tokens agree with generate()'s "
                             f"choices on {agree} < {SERVE_AGREE_MIN}")
    out = {"phase": "llama", "estimate_s": PHASE_ESTIMATE_S["llama"],
           "model": "llama3-8b-wide", "n_layer": L,
           "n_layer_published": 32, "n_params": tree_num_params(
               engine.params),
           "hf_config": LLAMA_HF, "dtype": "bfloat16",
           "init_s": init_s, "adapt_s": adapt_s,
           "prompt_lens": list(LLAMA_LENS), "max_new_tokens": new,
           "last_decode_position": max(LLAMA_SERVE_LENS) + new - 2,
           "generate": dict(seconds=gen_s, tokens_per_s=len(gen_prompts)
                            * new / gen_s, launches=gen_counts),
           "serve": dict(slots=LLAMA_SLOTS, max_context=LLAMA_CONTEXT,
                         requests=len(reqs),
                         prompt_lens=list(LLAMA_SERVE_LENS),
                         prompt_tokens=sum(LLAMA_SERVE_LENS),
                         seconds=serve_s,
                         requests_per_s=len(reqs) / serve_s,
                         tokens_per_s=len(reqs) * new / serve_s,
                         launches=serve_counts, decode_steps=steps,
                         latency=latency,
                         token_agreement_with_generate_forced=agree,
                         agree_min=SERVE_AGREE_MIN,
                         token_agreement_with_generate_free_running=free,
                         stats={k: v for k, v in serving.stats().items()
                                if k != "latency"})}
    del engine, serving, spec
    torch.cuda.empty_cache()
    out["parity"] = _llama_parity(sd)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return {"llama_generate": gen_counts, "llama_serve": serve_counts}


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


# ----------------------------------------------------------------------
# the offload tier (ROADMAP queue 1 item 9): bench.py's offload lane and
# the three spill engines at gpt2-1.3b's width
# ----------------------------------------------------------------------

# bench.py's offload lane (bench.py:715-803): 8 layers, d_model 256, 4
# heads of 64, d_ff 1024, vocab 8192, B 4, T 256, the nvme tier. The lane
# runs fp32; the port's flash kernels take bf16 / fp16 only, so the cell
# runs the lane's shapes in bf16 with the fp32 master on the host (cut)
OFFLOAD_CFG = dict(n_layer=8, n_head=4, d_model=256, d_ff=1024,
                   vocab_size=8192, max_seq_len=256)
OFFLOAD_B, OFFLOAD_T, OFFLOAD_STEPS = 4, 256, 4
OFFLOAD_ATTN = dict(B=4, T=256, H=4, Hkv=4, D=64, causal=True)
# (name, lookahead, landing_depth): bench.py's blocking and async arms and
# the lookahead-1 arm between them; the losses must be bit-identical
OFFLOAD_ARMS = (("blocking", 0, 1), ("lookahead1", 1, 1), ("async", 2, 2))
# the three spill engines share one numpy draw of gpt2-1.3b's width
# (models/gpt.py GPT2_CONFIGS: d_model 2048, 16 heads of 128, d_ff 8192,
# vocab 50304) cut to 4 of its 24 layers for time
SPILL_MODEL, SPILL_LAYERS = "gpt2-1.3b", 4
INFINITY_MBS, INFINITY_SEQ, INFINITY_GAS, INFINITY_STEPS = 4, 1024, 2, 2
INFINITY_ATTN = dict(B=4, T=1024, H=16, Hkv=16, D=128, causal=True)
INFINITY_PARITY_B = 2
ZI_LENS, ZI_NEW, ZI_SERVE_N = (100, 250, 431, 600), 32, 16
ZI_CONFIG = {"dtype": "bfloat16", "kv_cache_dtype": "bfloat16",
             "greedy": True, "max_out_tokens": 1024,
             "telemetry": REGISTRY_ONLY}
# row 1 at the longest prompt's prefill (each prompt is its own generate()
# call), row 4 mid-generation over its 1024-row cache, row 5 over 8 slots
ZI_PREFILL = dict(B=1, T=600, H=16, Hkv=16, D=128, causal=True)
ZI_DECODE = dict(B=1, H=16, Hkv=16, hd=128, M=1024, pos=[616])
ZI_PAGED = dict(B=8, H=16, Hkv=16, hd=128, bs=512, nb=2,
                pos=[150, 0, 400, 640, 1000, 0, 260, 520])
ZO_MBS, ZO_SEQ, ZO_GAS, ZO_STEPS = 4, 512, 2, 2
# the weight bound on the card, measured at two depths of the same width:
# the zero_inference model at 8 layers and the same blocks twice over (16)
ZI_DEPTHS, ZI_DEPTH_NEW = (SPILL_LAYERS, 2 * SPILL_LAYERS), 8
# the allocator's rounding of the ring's and the resident leaves' blocks
# (each to 512 B, or to 2 MiB segments for reserved memory) and the
# sampler's scratch: what a measured byte count may exceed its bound by
MEM_SLACK = 64 << 20
# the swap folder: inside the checkout (listed in .gitignore under build/)
SWAP_ROOT = "build/chip_smoke_swap"


def _swap_dir(name):
    import os
    import shutil
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SWAP_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _filesystem(path):
    """The swap folder's mount and filesystem type from /proc/mounts (the
    longest mount prefix), and its free bytes: an NVMe-tier number read
    from tmpfs or overlay is a page-cache number, not a disk's."""
    import os
    import shutil
    path = os.path.realpath(path)
    best = ("", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            mnt = mnt.replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    return {"path": path, "mount": best[0], "fstype": best[1],
            "free_bytes": shutil.disk_usage(path).free}


def _spill_cfg(n_layer=SPILL_LAYERS):
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS
    return dataclasses.replace(GPT2_CONFIGS[SPILL_MODEL], n_layer=n_layer)


def _spill_params(state):
    """The one numpy draw the infinity, zero_inference and zero_offload
    phases share (fp32 on the host)."""
    if "spill_params" not in state:
        from deepspeed_tpu_torch.models.gpt import init_gpt_params
        t0 = time.perf_counter()
        state["spill_params"] = init_gpt_params(_spill_cfg(), seed=0)
        state["spill_init_s"] = time.perf_counter() - t0
    return state["spill_params"]


def _host_timer(obj, name, acc):
    """Wrap obj.name so that its host seconds add into acc[0]."""
    fn = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[0] += time.perf_counter() - t0
    setattr(obj, name, timed)


def _busy_share(fn, wall_s):
    """One run of fn under torch.profiler: the card's busy time against
    the unprofiled wall time of the same work (`_device_breakdown`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    br = _device_breakdown(prof, wall_s)
    return {"busy_share": 1.0 - br["idle_share"],
            "device_busy_ms": br["device_busy_ms"], "wall_ms": br["wall_ms"],
            "by_class_ms": br["by_class_ms"]}


def _train_launches(path, counts, L, per_step_micro):
    """Flash launches of a training path: the forward twice a layer and
    micro-batch (the backward's recompute), each backward kernel once."""
    _expect(path, counts, {
        "flash_attention": 2 * L * per_step_micro,
        "flash_attention_bwd_dq": L * per_step_micro,
        "flash_attention_bwd_dkv": L * per_step_micro})


def phase_offload(state):
    """bench.py's offload lane through InfinityEngine on the nvme tier,
    three arms (blocking: lookahead 0, landing 1; lookahead 1, landing 1;
    async: lookahead 2, landing 2), built side by side, each 1 warm-up
    step, then OFFLOAD_STEPS timed steps on the same batches taken in
    turns (one step of each arm a round, the order reversed every other
    round), so that the host's other load falls on every arm alike: the
    lane runs at the host's pace, whose time for the same work varies
    several-fold over seconds. Bit-identical losses across the arms, exact
    flash launches, bench.py's columns from each arm's median step, and
    the host's time a step in the C++ step and in making layers live
    (`tools/offload_ab.py` breaks a step down further)."""
    import shutil
    import torch
    from deepspeed_tpu_torch.models.gpt import (GPTConfig, init_gpt_params,
                                                make_gpt_layered_model)
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES, omp_threads
    from deepspeed_tpu_torch.runtime.infinity import InfinityEngine
    cfg = GPTConfig(**OFFLOAD_CFG, remat=False, dtype="bfloat16")
    params = init_gpt_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size,
                                       (OFFLOAD_B, OFFLOAD_T + 1))}
               for _ in range(OFFLOAD_STEPS + 1)]
    engines, losses, launches, timers, fs = {}, {}, {}, {}, None
    for name, lookahead, landing in OFFLOAD_ARMS:
        folder = _swap_dir(f"offload_{name}")
        fs = _filesystem(folder)
        eng = InfinityEngine(make_gpt_layered_model(cfg, params=params),
                             lr=1e-3, dtype=torch.bfloat16,
                             offload_device="nvme", nvme_path=folder,
                             lookahead=lookahead, landing_depth=landing)
        losses[name] = [eng.train_batch(batches[0])]          # warm-up
        engines[name] = (eng, eng.offload_stats(), folder)
        timers[name] = {"host_step": [0.0], "upload": [0.0], "step": []}
        for opt in eng.layer_opts:
            _host_timer(opt, "step", timers[name]["host_step"])
        _host_timer(eng.streamer, "_upload", timers[name]["upload"])
        launches[name] = collections.Counter()
    order = [name for name, _, _ in OFFLOAD_ARMS]
    for r, batch in enumerate(batches[1:]):
        for name in (order if r % 2 == 0 else order[::-1]):
            eng = engines[name][0]
            LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[name].append(eng.train_batch(batch))
            torch.cuda.synchronize()
            timers[name]["step"].append(time.perf_counter() - t0)
            launches[name].update(LAUNCHES)
    arms = {}
    for name, lookahead, landing in OFFLOAD_ARMS:
        eng, base, folder = engines[name]
        launches[name] = dict(launches[name])
        _train_launches(f"offload/{name}", launches[name], cfg.n_layer,
                        OFFLOAD_STEPS)
        t = timers[name]
        dt = sum(t["step"])
        off = eng.offload_stats()
        st, st0 = off["staging"], base["staging"]
        stall = st["stall_ms_total"] - st0["stall_ms_total"]
        landing_ms = off["hostward_wait_ms_total"] \
            - base["hostward_wait_ms_total"]
        step_s = statistics.median(t["step"])
        busy = _busy_share(lambda: eng.train_batch(batches[1]), step_s)
        arms[name] = {
            "lookahead": lookahead, "landing_depth": landing,
            "step_ms": step_s * 1e3,
            "step_ms_each": [v * 1e3 for v in t["step"]],
            "tokens_per_s": OFFLOAD_B * OFFLOAD_T / step_s,
            "stall_fraction": stall / (dt * 1e3),
            "landing_wait_fraction": landing_ms / (dt * 1e3),
            "host_optimizer_ms_per_step": t["host_step"][0] * 1e3
            / OFFLOAD_STEPS,
            "upload_ms_per_step": t["upload"][0] * 1e3 / OFFLOAD_STEPS,
            "staging_hit_rate": (st["hits"] - st0["hits"])
            / max(1, st["acquires"] - st0["acquires"]),
            "write_flushes": eng.store.write_flushes,
            "peak_live_layers": st["peak_live_layers"],
            "final_loss": losses[name][-1], **busy}
        eng.release()
        shutil.rmtree(folder, ignore_errors=True)
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"offload losses not finite: {losses}")
    if len({tuple(v) for v in losses.values()}) != 1:
        raise AssertionError(f"offload arms' losses differ: {losses}")
    emit({"phase": "offload", "source": "bench.py:715-803",
          "cut": "bf16 compute (the lane runs fp32; the flash kernels take "
                 "bf16 / fp16), the fp32 master on the host",
          "config": OFFLOAD_CFG, "batch": OFFLOAD_B, "seq": OFFLOAD_T,
          "steps": OFFLOAD_STEPS, "timing": "in turns, median step",
          "swap_filesystem": fs, "omp_threads": omp_threads(),
          "arms": arms, "losses": losses,
          "vs_baseline": arms["blocking"]["step_ms"]
          / arms["async"]["step_ms"], "launches": launches})
    return {"offload": launches["async"]}


def _infinity_config(tier, folder, lookahead=1):
    off = {"device": tier, "lookahead": lookahead}
    zero = {"stage": 3, "offload_param": off}
    if tier == "nvme":
        off["nvme_path"] = f"{folder}/weights"
        zero["offload_optimizer"] = {"device": "nvme",
                                     "nvme_path": f"{folder}/moments"}
    return {"train_micro_batch_size_per_gpu": INFINITY_MBS,
            "gradient_accumulation_steps": INFINITY_GAS,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "bf16": {"enabled": True}, "zero_optimization": zero}


def _infinity_parity():
    """A 2-layer cut at the spill width, one step: the card's bf16
    InfinityEngine against the port's fp32 CPU InfinityEngine from the
    same bf16-rounded weights and batch: the loss within TRAIN_LOSS_TOL
    and each layer's landed gradient flat within TRAIN_GRAD_REL_TOL."""
    import torch
    from deepspeed_tpu_torch.models.gpt import (init_gpt_params,
                                                make_gpt_layered_model)
    from deepspeed_tpu_torch.runtime.infinity import InfinityEngine
    from deepspeed_tpu_torch.utils.tree import tree_cast
    small = _spill_cfg(2)
    params = tree_cast(tree_cast(init_gpt_params(small, seed=1),
                                 torch.bfloat16), torch.float32)
    toks = np.random.default_rng(7).integers(
        0, small.vocab_size, (INFINITY_PARITY_B, INFINITY_SEQ + 1))
    out = {}
    for side, dtype, device in (("card", torch.bfloat16, None),
                                ("cpu", torch.float32, "cpu")):
        cfg = small if side == "card" else dataclasses.replace(
            small, dtype=torch.float32)
        eng = InfinityEngine(make_gpt_layered_model(cfg, params=params),
                             lr=1e-3, dtype=dtype, device=device)
        flats = {}
        step = eng._layer_step_host

        def record(i, flat, step=step, flats=flats):
            flats[i] = flat.clone()
            return step(i, flat)
        eng._layer_step_host = record
        out[side] = (eng.train_batch({"tokens": toks}), flats)
        eng.release()
    (l_card, f_card), (l_cpu, f_cpu) = out["card"], out["cpu"]
    rel = {i: float((f_card[i] - f_cpu[i]).norm()
                    / f_cpu[i].norm().clamp_min(1e-30)) for i in f_cpu}
    err = abs(l_card - l_cpu)
    if not err <= TRAIN_LOSS_TOL or max(rel.values()) > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"infinity 2-layer parity: loss err {err}, "
                             f"layer flats {rel}")
    return {"n_layer": 2, "batch": INFINITY_PARITY_B, "seq": INFINITY_SEQ,
            "loss_card": l_card, "loss_cpu": l_cpu, "loss_abs_err": err,
            "loss_tol": TRAIN_LOSS_TOL, "layer_flat_rel_err": rel,
            "grad_rel_tol": TRAIN_GRAD_REL_TOL}


def phase_infinity(state):
    """initialize() of a LayeredModelSpec at gpt2-1.3b's width
    (SPILL_LAYERS of 24 layers) -> InfinityEngine, micro-batch 4, seq 1024, gas 2, AdamW on the
    host, bf16: the cpu tier, then the nvme tier with the moments on disk
    too, each 1 warm-up and INFINITY_STEPS timed steps on one batch: exact
    launches, finite falling losses, the live-layer bound and the bytes
    the card holds between steps (the resident leaves and the streamer's
    ring, from the allocator), s/step, tokens/s, MFU, host step, landing wait and busy share; then the
    2-layer parity."""
    import shutil
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import make_gpt_layered_model
    from deepspeed_tpu_torch.inference.zero_inference import tree_bytes
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES, omp_threads
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    cfg = _spill_cfg()
    params = _spill_params(state)
    n_params = tree_num_params(params)
    L = cfg.n_layer
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (INFINITY_MBS * INFINITY_GAS, INFINITY_SEQ + 1))
    tokens = INFINITY_MBS * INFINITY_GAS * INFINITY_SEQ
    arms, launches = {}, {}
    for tier in ("cpu", "nvme"):
        folder = _swap_dir(f"infinity_{tier}")
        gc.collect()                   # the previous tier's engine
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng, *_ = initialize(model=make_gpt_layered_model(
            cfg, name=SPILL_MODEL, params=params),
            config=_infinity_config(tier, folder))
        setup_s = time.perf_counter() - t0
        host_s = [0.0]
        _host_timer(eng, "_layer_step_host", host_s)
        _host_timer(eng.resident_opt, "step", host_s)
        losses = [eng.train_batch({"tokens": toks})]          # warm-up
        base = eng.offload_stats()
        host_s[0] = 0.0
        LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for _ in range(INFINITY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(eng.train_batch({"tokens": toks}))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches[tier] = dict(LAUNCHES)
        _train_launches(f"infinity/{tier}", launches[tier], L,
                        INFINITY_GAS * INFINITY_STEPS)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"infinity/{tier} losses not finite and "
                                 f"falling: {losses}")
        la = eng.streamer.lookahead
        if eng.streamer.peak_live_layers > la + 1:
            raise AssertionError(
                f"infinity/{tier}: {eng.streamer.peak_live_layers} live "
                f"layers > {la + 1}")
        # between steps the card holds the resident leaves and the
        # streamer's ring, read from the allocator
        resident = tree_bytes(eng.resident)
        bound = resident + (la + 1) * eng.store.layer_bytes
        held = torch.cuda.memory_allocated() - base_bytes
        if not bound <= held <= bound + MEM_SLACK:
            raise AssertionError(f"infinity/{tier}: {held} B held on the "
                                 f"card between steps, bound {bound}")
        off = eng.offload_stats()
        sec = statistics.median(step_s)
        busy = _busy_share(lambda: eng.train_batch({"tokens": toks}), sec)
        arms[tier] = {
            "setup_s": setup_s, "losses": losses, "step_s": step_s,
            "seconds_per_step": sec, "tokens_per_s": tokens / sec,
            "mfu": 6 * n_params * tokens / sec / BF16_FLOPS,
            "host_step_s_per_step": host_s[0] / INFINITY_STEPS,
            "landing_wait_ms_per_step": (off["hostward_wait_ms_total"]
                                         - base["hostward_wait_ms_total"])
            / INFINITY_STEPS,
            "stall_ms_per_step": (off["staging"]["stall_ms_total"]
                                  - base["staging"]["stall_ms_total"])
            / INFINITY_STEPS,
            "staging": off["staging"], "write_flushes": off["write_flushes"],
            "lookahead": la, "peak_live_layers": eng.streamer.peak_live_layers,
            "held_between_steps": held, "resident_bytes": resident,
            "weight_bound_bytes": bound, "slack_bytes": MEM_SLACK,
            "layer_bytes": eng.store.layer_bytes,
            "all_layers_bit16_bytes": eng.store.host_bytes,
            "max_allocated_above_baseline": torch.cuda.max_memory_allocated()
            - base_bytes, **busy}
        if tier == "nvme":
            arms[tier]["swap_filesystem"] = _filesystem(folder)
        eng.release()
        del eng
        shutil.rmtree(folder, ignore_errors=True)
    parity = _infinity_parity()
    emit({"phase": "infinity", "model": SPILL_MODEL,
          "cut": f"{SPILL_LAYERS} of 24 layers, for time",
          "n_layer": L, "n_params": n_params,
          "numpy_init_s": state.get("spill_init_s"),
          "micro_batch": INFINITY_MBS, "seq": INFINITY_SEQ,
          "gas": INFINITY_GAS, "omp_threads": omp_threads(),
          "mfu_basis": "6 x params x tokens/s over 989e12 flop/s",
          "arms": arms, "launches": launches, "parity": parity})
    return {"infinity": launches["cpu"]}


def _first_mismatch(engine, prompt, got, ref):
    """First position where the served tokens differ from the resident
    engine's, and the resident engine's top-2 gap there."""
    pos = int(np.flatnonzero(np.asarray(got) != np.asarray(ref))[0])
    prefix = np.concatenate([prompt, np.asarray(ref[:pos], np.int32)])
    logits, _ = engine.forward(prefix[None])
    top = logits[0, -1].float().topk(2).values
    return {"position": pos, "top2_gap": float(top[0] - top[1])}


def _depth_memory(cfg, params, prompt):
    """The streamed weights on the card, read from the allocator: the cpu
    tier at lookahead 1, generate() on one prompt at each depth of
    ZI_DEPTHS (the deeper model repeats the cut's blocks). Between
    calls the card holds the resident leaves, the streamer's ring and the
    KV cache, nothing else: `held` (allocated, less the cache) must equal
    resident + (lookahead + 1) layers to MEM_SLACK, and be the same at
    both depths; the peak above it (activations) and the reserved peak
    less the cache must not grow with the depth beyond MEM_SLACK."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.zero_inference import tree_bytes
    from deepspeed_tpu_torch.models.gpt import make_gpt_layered_model
    rows = {}
    for L in ZI_DEPTHS:
        reps = L // cfg.n_layer
        p = {**params, "blocks": {k: torch.cat([v] * reps)
                                  for k, v in params["blocks"].items()}}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        base_res = torch.cuda.memory_reserved()
        eng = init_inference(make_gpt_layered_model(
            dataclasses.replace(cfg, n_layer=L), name=SPILL_MODEL, params=p),
            config={**ZI_CONFIG, "zero": {"offload_param": {
                "device": "cpu", "lookahead": 1}}})
        del p
        eng.generate(prompt[None], max_new_tokens=2)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.generate(prompt[None], max_new_tokens=ZI_DEPTH_NEW)
        torch.cuda.synchronize()
        kv = tree_bytes(eng._cache_entry[1])
        held = torch.cuda.memory_allocated() - base - kv
        la = eng.streamer.lookahead
        rows[L] = {
            "resident_bytes": tree_bytes(eng.params),
            "ring_bytes": eng.streamer.device_bytes,
            "bound_bytes": tree_bytes(eng.params)
            + (la + 1) * eng.store.layer_bytes,
            "kv_cache_bytes": kv, "held_bytes": held,
            "peak_above_held": torch.cuda.max_memory_allocated() - base
            - kv - held,
            "reserved_peak_less_kv": torch.cuda.max_memory_reserved()
            - base_res - kv,
            "model_bit16_bytes": eng.store.host_bytes + tree_bytes(eng.params)}
        eng.release()
        del eng
    a, b = (rows[L] for L in ZI_DEPTHS)
    for L, r in rows.items():
        if not r["bound_bytes"] <= r["held_bytes"] \
                <= r["bound_bytes"] + MEM_SLACK:
            raise AssertionError(f"zero_inference at {L} layers holds "
                                 f"{r['held_bytes']} B on the card, bound "
                                 f"{r['bound_bytes']}: {rows}")
    for key in ("held_bytes", "peak_above_held", "reserved_peak_less_kv"):
        if b[key] > a[key] + MEM_SLACK:
            raise AssertionError(f"zero_inference: {key} grows with depth: "
                                 f"{rows}")
    torch.cuda.empty_cache()
    return {"depths": rows, "slack_bytes": MEM_SLACK,
            "prompt_len": int(len(prompt)), "new_tokens": ZI_DEPTH_NEW}


def phase_zero_inference(state):
    """init_inference() of a LayeredModelSpec at the spill width (the
    infinity phase's weights) -> ZeroInferenceEngine, lookahead 1, on the
    cpu and nvme tiers: generate() on 4 prompts (one call each) and the
    streamed ServingEngine over 16 requests through 8 slots, tokens
    identical to the resident InferenceEngine / ServingEngine on the same
    card and weights, exact launches, the weight bytes on the device."""
    import shutil
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.inference.zero_inference import tree_bytes
    from deepspeed_tpu_torch.models.gpt import (make_gpt_decode_model,
                                                make_gpt_layered_model)
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    cfg = _spill_cfg()
    params = _spill_params(state)
    L = cfg.n_layer
    rng = np.random.default_rng(9)
    prompts = _ragged_prompts(rng, ZI_LENS, cfg.vocab_size)
    serve_lens = rng.integers(100, 601, ZI_SERVE_N).tolist()
    serve_prompts = _ragged_prompts(rng, serve_lens, cfg.vocab_size)
    resident = init_inference(make_gpt_decode_model(cfg, name=SPILL_MODEL,
                                                    params=params),
                              config=ZI_CONFIG)
    ref_gen = [resident.generate([p], max_new_tokens=ZI_NEW,
                                 stop_on_eos=False)[0] for p in prompts]
    reqs = [Request(uid=i, tokens=p, max_new_tokens=ZI_NEW,
                    stop_on_eos=False) for i, p in enumerate(serve_prompts)]
    ref_serve = resident.serving(max_slots=8, max_context=1024).run(reqs)
    arms, launches = {}, {}
    for tier in ("cpu", "nvme"):
        folder = _swap_dir(f"zero_inference_{tier}")
        off = {"device": tier, "lookahead": 1}
        if tier == "nvme":
            off["nvme_path"] = folder
        t0 = time.perf_counter()
        eng = init_inference(make_gpt_layered_model(cfg, name=SPILL_MODEL,
                                                    params=params),
                             config={**ZI_CONFIG,
                                     "zero": {"offload_param": off}})
        setup_s = time.perf_counter() - t0
        eng.generate(prompts[0][None], max_new_tokens=2)     # warm-up
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [eng.generate(p[None], max_new_tokens=ZI_NEW)[0]
                for p in prompts]
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_counts = dict(LAUNCHES)
        _expect(f"zero_inference_generate/{tier}", gen_counts, {
            "flash_attention": L * len(prompts),
            "decode_attention": L * (ZI_NEW - 1) * len(prompts)})
        for i, (a, b) in enumerate(zip(outs, ref_gen)):
            if not np.array_equal(a, b):
                raise AssertionError(
                    f"zero_inference/{tier} generate prompt {i} differs "
                    f"from the resident engine: "
                    f"{_first_mismatch(resident, prompts[i], a, b)}")
        serving = eng.serving(max_slots=8, max_context=1024)
        serving.run([Request(uid="warm", tokens=serve_prompts[0],
                             max_new_tokens=2, stop_on_eos=False)])
        serving.telemetry.registry.clear()
        steps0 = serving.stats()["decode_steps"]
        stage0 = eng.streamer.stats()
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = serving.run(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        serve_counts = dict(LAUNCHES)
        steps = serving.stats()["decode_steps"] - steps0
        _expect(f"zero_inference_serve/{tier}", serve_counts,
                {"paged_decode_attention": L * steps})
        for u in range(ZI_SERVE_N):
            if not np.array_equal(res[u].tokens, ref_serve[u].tokens):
                where = _first_mismatch(resident, serve_prompts[u],
                                        res[u].tokens, ref_serve[u].tokens)
                raise AssertionError(
                    f"zero_inference/{tier} served request {u} differs "
                    f"from the resident ServingEngine: {where}")
        if serving.allocator.num_free != serving.allocator.capacity:
            raise AssertionError("zero_inference: blocks leaked")
        latency = _latency(f"zero_inference/{tier}", serving, reqs)
        stage = eng.streamer.stats()
        arms[tier] = {
            "setup_s": setup_s, "generate_s": gen_s,
            "generate_tokens_per_s": len(prompts) * ZI_NEW / gen_s,
            "serve_s": serve_s, "requests_per_s": ZI_SERVE_N / serve_s,
            "serve_tokens_per_s": ZI_SERVE_N * ZI_NEW / serve_s,
            "ttft_p50_ms": latency["ttft_ms"]["p50"],
            "tpot_p50_ms": latency["tpot_ms"]["p50"], "latency": latency,
            "decode_steps": steps,
            "serve_staging_hits": stage["hits"] - stage0["hits"],
            "serve_staging_acquires": stage["acquires"] - stage0["acquires"],
            "serve_stall_ms": stage["stall_ms_total"]
            - stage0["stall_ms_total"],
            "staging": stage,
            "device_weight_bytes": eng.streamer.device_bytes
            + tree_bytes(eng.params),
            "model_weight_bytes": eng.store.host_bytes
            + tree_bytes(eng.params),
            "launches": {"generate": gen_counts, "serve": serve_counts}}
        if tier == "nvme":
            arms[tier]["swap_filesystem"] = _filesystem(folder)
        launches[tier] = (gen_counts, serve_counts)
        eng.release()
        del eng, serving
        shutil.rmtree(folder, ignore_errors=True)
    del resident
    depth = _depth_memory(cfg, params, prompts[-1])
    emit({"phase": "zero_inference", "model": SPILL_MODEL,
          "cut": f"{SPILL_LAYERS} of 24 layers", "prompt_lens": ZI_LENS,
          "max_new_tokens": ZI_NEW, "serve_prompt_lens": serve_lens,
          "slots": 8, "arms": arms, "depth_memory": depth})
    return {"zero_inference_generate": launches["cpu"][0],
            "zero_inference_serve": launches["cpu"][1]}


def _state_equal(a, b):
    """Leaves of two state trees bit-equal, each compared on the card
    (one tree may live in pinned host memory)."""
    import torch
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.to("cuda"), y.to("cuda")) for x, y in zip(la, lb))


def phase_zero_offload(state):
    """The ordinary engine with offload_optimizer on the spill phases'
    weights: ZeRO 3 at one rank, micro-batch 4, seq 512, gas 2, bf16,
    AdamW; arms `resident` (no offload: the state on the card), `cpu`
    streamed (the state in pinned host memory, moved through the card on
    a side stream each update), `cpu` with zero_force_ds_cpu_optimizer
    (the C++ host step) and `nvme`, each 1 warm-up and ZO_STEPS timed
    steps on the same batches: finite losses, exact launches; the streamed
    arm's losses, params, master and moments bit-identical to the resident
    arm's (the same update on the same card, only the state's home
    differs: a missed wait on the side stream reads stale state); between
    steps (the allocator's pending frees polled) the streamed arm holds at
    least 0.9 x 12 bytes a parameter (the fp32 master and moments) less
    than the resident arm, and each host-step arm's device peak is that
    much below the streamed arm's."""
    import shutil
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES, omp_threads
    from deepspeed_tpu_torch.utils.tree import tree_num_params
    cfg = _spill_cfg()
    params = _spill_params(state)
    n_params = tree_num_params(params)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (ZO_MBS * ZO_GAS, ZO_SEQ + 1))).cuda()
    arms, launches, resident = {}, {}, None
    for arm in ("resident", "streamed", "forced", "nvme"):
        folder = _swap_dir(f"zero_offload_{arm}")
        zero = {"stage": 3}
        if arm != "resident":
            zero["offload_optimizer"] = {
                "device": "nvme" if arm == "nvme" else "cpu"}
            if arm == "nvme":
                zero["offload_optimizer"]["nvme_path"] = folder
        config = {"train_micro_batch_size_per_gpu": ZO_MBS,
                  "gradient_accumulation_steps": ZO_GAS,
                  "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
                  "bf16": {"enabled": True}, "zero_optimization": zero,
                  "zero_force_ds_cpu_optimizer": arm == "forced"}
        gc.collect()                   # the previous arm's engine
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng, *_ = initialize(model=make_gpt_model(cfg, name=SPILL_MODEL,
                                                  params=params),
                             config=config)
        setup_s = time.perf_counter() - t0
        if eng.host_step != (arm in ("forced", "nvme")) or \
                (eng._state_copy_stream is not None) != (arm == "streamed"):
            raise AssertionError(f"zero_offload/{arm}: host_step "
                                 f"{eng.host_step}, streamed "
                                 f"{eng._state_copy_stream is not None}")
        host_s = [0.0]
        if eng.host_step:
            _host_timer(eng.host_optimizer, "step", host_s)
        losses = [float(eng.train_batch({"tokens": toks}))]   # warm-up
        host_s[0] = 0.0
        LAUNCHES.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for _ in range(ZO_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch({"tokens": toks})))
            step_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base_bytes
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() - base_bytes
        launches[arm] = dict(LAUNCHES)
        per = ZO_GAS * ZO_STEPS
        _expect(f"zero_offload/{arm}", launches[arm], {
            "flash_attention": (2 if cfg.remat else 1) * cfg.n_layer * per,
            "flash_attention_bwd_dq": cfg.n_layer * per,
            "flash_attention_bwd_dkv": cfg.n_layer * per})
        if not all(np.isfinite(losses)):
            raise AssertionError(f"zero_offload/{arm} losses: {losses}")
        arms[arm] = {"setup_s": setup_s, "losses": losses, "step_s": step_s,
                     "seconds_per_step": statistics.median(step_s),
                     "host_step_s_per_step": host_s[0] / ZO_STEPS,
                     "peak_above_baseline": peak,
                     "held_between_steps": held}
        if arm == "nvme":
            arms[arm]["swap_filesystem"] = _filesystem(folder)
        if arm == "resident":
            resident = eng
            shutil.rmtree(folder, ignore_errors=True)
            continue
        if arm == "streamed":
            st, ref = eng.state, resident.state
            same = {"losses": losses == arms["resident"]["losses"],
                    "params": _state_equal(st.params, ref.params),
                    "master": _state_equal(st.master, ref.master),
                    "opt_state": _state_equal(st.opt_state, ref.opt_state)}
            arms[arm]["bit_identical_to_resident"] = same
            if not all(same.values()):
                raise AssertionError(
                    f"zero_offload/streamed differs from the resident arm: "
                    f"{same}; losses {losses} vs "
                    f"{arms['resident']['losses']}")
            del resident, st, ref
        del eng
        shutil.rmtree(folder, ignore_errors=True)
    need = 0.9 * 12 * n_params
    saved = arms["resident"]["held_between_steps"] \
        - arms["streamed"]["held_between_steps"]
    arms["streamed"]["held_below_resident"] = saved
    if saved < need:
        raise AssertionError(f"zero_offload/streamed: holds only {saved} B "
                             f"less than the resident arm between steps "
                             f"(need {need})")
    for arm in ("forced", "nvme"):
        saved = arms["streamed"]["peak_above_baseline"] \
            - arms[arm]["peak_above_baseline"]
        arms[arm]["peak_below_streamed"] = saved
        if saved < need:
            raise AssertionError(f"zero_offload/{arm}: device peak only "
                                 f"{saved} below the streamed arm's "
                                 f"(need {need})")
    torch.cuda.empty_cache()
    emit({"phase": "zero_offload", "model": SPILL_MODEL,
          "cut": f"{SPILL_LAYERS} of 24 layers", "n_params": n_params,
          "micro_batch": ZO_MBS, "seq": ZO_SEQ, "gas": ZO_GAS,
          "omp_threads": omp_threads(), "peak_gap_needed": need,
          "arms": arms, "launches": launches})
    return {"zero_offload": launches["streamed"]}


# the checkpoint phase: the headline lane's engine (TRAIN_CONFIG:
# gpt2-760m's full width, micro-batch 12, seq 512, ZeRO 1, bf16,
# TRAIN_POLICY) cut to CKPT_LAYERS of its 24 layers and gas CKPT_GAS, with
# the fp32 master on (the lane runs without one; then the moments are bf16,
# which the planner, as JAX's, prices at 4 bytes), fault_tolerance (a
# budget of one non-finite loss) and the memscope ledger on; its saves go
# to a tempfile directory. 2 layers, not 4: where the script has run,
# that directory was a 9p share (~350 MB/s), and 4 layers' 2.69 GB a save
# took the phase to 98 s (PERF.md §4)
CKPT_LAYERS, CKPT_GAS = 2, 2
# memory_allocated before a save against after its load, and the
# allocator's peak during a load above the bytes allocated when it began
# (the loaded state stays in host memory; each leaf is copied into the
# engine's own tensor: the slack is the allocator's rounding and scalars)
CKPT_MEM_SLACK = 64 << 20
# the training ledger's plan (model states) against the ledger itself:
# the planner prices the moments, not the optimizer's count scalar
CKPT_PLAN_SLACK = 1 << 20


def _ckpt_loss(base):
    """The GPT loss times (1 + the sum of a float `probe` leaf of zeros):
    the same loss and gradients bit for bit, and a leaf
    `testing.faults.poison_batch` can plant a NaN in (a token batch has
    none), which NaNs the loss and every gradient."""
    def loss_fn(params, batch, rng=None):
        rest = {k: v for k, v in batch.items() if k != "probe"}
        return base(params, rest, rng) * (1.0 + batch["probe"].sum())
    return loss_fn


def _snapshot(engine):
    """A copy of every checkpoint leaf where it lives (the card), by
    name: the engine steps its own tensors in place."""
    return {n: t.detach().clone() for n, t in engine.checkpoint_leaves()}


def _nbytes(snapshot):
    return sum(t.nbytes for t in snapshot.values())


def _leaf_spread(a, b):
    """Largest |a - b| over the named leaves: 0.0 where every leaf is
    bit-equal, NaN where a difference is."""
    import torch
    worst = 0.0
    for name, x in a.items():
        if torch.equal(x, b[name]):
            continue
        d = (x.double() - b[name].double()).abs().max().item()
        if not d <= worst:
            worst = d
    return worst


def phase_checkpoint(state):
    """Crash-safe checkpoints on the headline lane's engine (CKPT_LAYERS of
    gpt2-760m's 24 layers at full width, gas CKPT_GAS): the same step twice
    from one state (bit-reproducible, or the spread that sets the limit
    below), (a) torch-engine save -> 2 reference steps -> load -> the same 2
    steps: every restored leaf equal to the saved one and on the card, the
    resumed losses and state equal to the reference's, memory_allocated
    before the save and after the load within CKPT_MEM_SLACK, and so the
    load's allocator peak above the bytes it began with; (b) the same
    with the numpy engine; (c) a step while an async save is in flight
    against one without; (d) the newest tag corrupted: the load walks back
    to the previous tag; (e) a poisoned batch: the sentinel rolls back to
    the last save and the continued losses and state equal a clean run's;
    then the TrainMemScope ledger: model-state bytes equal to the state
    tensors' bytes, the plan's total less grads within CKPT_PLAN_SLACK of
    it, its predicted peak against max_memory_allocated of a step. Each
    save's ms and MB/s and each load's ms; exact flash launches over every
    step of the phase."""
    import tempfile
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint import manifest as manifest_mod
    from deepspeed_tpu_torch.checkpoint.saver import wait_pending_save
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS, make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.telemetry.memscope import tree_bytes
    from deepspeed_tpu_torch.testing import faults
    cfg = dataclasses.replace(GPT2_CONFIGS[TRAIN_MODEL], n_layer=CKPT_LAYERS,
                              remat_policy=TRAIN_POLICY,
                              softmax_dtype=torch.bfloat16)
    spec = make_gpt_model(cfg, name=TRAIN_MODEL, seed=0)
    spec = dataclasses.replace(spec, loss_fn=_ckpt_loss(spec.loss_fn))
    config = {**TRAIN_CONFIG, "gradient_accumulation_steps": CKPT_GAS,
              "bf16": {"enabled": True, "master_weights": True},
              "telemetry": {**REGISTRY_ONLY, "memscope": True},
              "checkpoint": {"engine": "torch"},
              "fault_tolerance": {"enabled": True, "nonfinite_budget": 1}}
    t0 = time.perf_counter()
    engine, *_ = initialize(model=spec, config=config)
    setup_s = time.perf_counter() - t0
    rows = TRAIN_MBS * CKPT_GAS
    rng = np.random.default_rng(7)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (rows, TRAIN_SEQ + 1))).cuda(),
        "probe": torch.zeros(rows, device="cuda")} for _ in range(6)]
    n_steps = [0]

    def step(batch):
        n_steps[0] += 1
        return float(engine.train_batch(batch))

    root = tempfile.TemporaryDirectory()
    fs = _filesystem(root.name)
    out = {"phase": "checkpoint", "model": TRAIN_MODEL,
           "n_layer": CKPT_LAYERS, "gas": CKPT_GAS, "micro_batch": TRAIN_MBS,
           "seq": TRAIN_SEQ, "setup_s": setup_s, "save_filesystem": fs}
    LAUNCHES.clear()
    step(batches[0])                                   # warm-up

    # the same step twice from one state: the limit of every comparison
    snap = _snapshot(engine)
    steps0 = engine.global_steps
    loss_a = step(batches[1])
    state_a = _snapshot(engine)
    engine.restore_checkpoint_leaves(snap)     # in memory, by name
    engine.global_steps = steps0
    loss_b = step(batches[1])
    del snap
    loss_tol = abs(loss_a - loss_b)
    leaf_tol = _leaf_spread(state_a, _snapshot(engine))
    out["reproducible"] = {"bit_equal": loss_tol == 0 and leaf_tol == 0,
                           "loss_spread": loss_tol, "leaf_spread": leaf_tol}
    del state_a
    if not (np.isfinite(loss_tol) and np.isfinite(leaf_tol)):
        raise AssertionError(f"checkpoint: the repeated step is not finite "
                             f"({loss_a}, {loss_b})")

    def round_trip(kind, d, tag):
        """save -> 2 reference steps -> load -> the same 2 steps."""
        engine.config.checkpoint.engine = kind
        engine._ckpt_engine = None
        saved = _snapshot(engine)
        gc.collect()
        torch.cuda.synchronize()
        # the engine's bytes: the snapshots held here are not its
        mem0 = torch.cuda.memory_allocated() - _nbytes(saved)
        t0 = time.perf_counter()
        engine.save_checkpoint(d, tag=tag)
        save_s = time.perf_counter() - t0
        nbytes = manifest_mod.read_manifest(f"{d}/{tag}")["total_bytes"]
        ref = [step(b) for b in batches[2:4]]
        ref_state = _snapshot(engine)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        load_base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        path, client = engine.load_checkpoint(d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated() - load_base
        gc.collect()
        mem1 = torch.cuda.memory_allocated() - _nbytes(saved) \
            - _nbytes(ref_state)
        if path is None or not path.endswith(tag):
            raise AssertionError(f"checkpoint/{kind}: loaded {path}")
        leaves = dict(engine.checkpoint_leaves())
        off = [n for n, t in leaves.items()
               if t.device.type != engine.device.type]
        if off:
            raise AssertionError(f"checkpoint/{kind}: leaves off the card "
                                 f"after the load: {off[:4]}")
        bad = [n for n, t in leaves.items() if not torch.equal(t, saved[n])]
        if bad:
            raise AssertionError(f"checkpoint/{kind}: restored leaves differ "
                                 f"from the saved ones: {bad[:4]}")
        got = [step(b) for b in batches[2:4]]
        loss_d = max(abs(x - y) for x, y in zip(got, ref))
        state_d = _leaf_spread(_snapshot(engine), ref_state)
        del ref_state
        if not (loss_d <= loss_tol and state_d <= leaf_tol):
            raise AssertionError(
                f"checkpoint/{kind}: resumed {got} vs reference {ref} "
                f"(loss spread {loss_d}, state {state_d}; the repeated "
                f"step's {loss_tol}, {leaf_tol})")
        if abs(mem1 - mem0) > CKPT_MEM_SLACK:
            raise AssertionError(f"checkpoint/{kind}: memory_allocated "
                                 f"{mem0} before the save, {mem1} after the "
                                 f"load")
        if load_peak > CKPT_MEM_SLACK:
            raise AssertionError(f"checkpoint/{kind}: the load's allocator "
                                 f"peak {load_peak} B above the engine's "
                                 f"resident bytes")
        return {"bytes": nbytes, "save_ms": save_s * 1e3,
                "save_MB_per_s": nbytes / save_s / 1e6,
                "load_ms": load_s * 1e3, "load_peak_above_resident": load_peak,
                "allocated_before_save": mem0,
                "allocated_after_load": mem1, "resumed_losses": got,
                "reference_losses": ref, "loss_spread": loss_d,
                "state_spread": state_d, "global_steps": client[
                    "global_steps"]}, saved

    d_a = f"{root.name}/a"
    out["torch"], saved_a = round_trip("torch", d_a, "a")
    steps_a = engine.global_steps - 2
    out["numpy"], _ = round_trip("numpy", f"{root.name}/b", "b")

    # (c) a step with no save in flight, then one beside an async save
    engine.config.checkpoint.engine = "torch"
    engine.config.checkpoint.async_save = True
    engine._ckpt_engine = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batches[4])
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.save_checkpoint(d_a, tag="c")
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(batches[5])
    during_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wait_pending_save(engine)
    drain_s = time.perf_counter() - t0
    if not manifest_mod.verify_manifest(f"{d_a}/c")[0] or \
            manifest_mod.resolve_latest_tag(d_a) != "c":
        raise AssertionError("checkpoint: the async save did not commit")
    out["async"] = {"step_ms_no_save": plain_s * 1e3,
                    "step_ms_save_in_flight": during_s * 1e3,
                    "host_snapshot_ms": snapshot_s * 1e3,
                    "remaining_write_ms": drain_s * 1e3}
    engine.config.checkpoint.async_save = False
    engine._ckpt_engine = None

    # (d) the newest tag corrupted: the load walks back to "a"
    victim = faults.corrupt_checkpoint(d_a, target="state")
    path, _ = engine.load_checkpoint(d_a)
    leaves = _snapshot(engine)
    if not path.endswith("/a") or engine.global_steps != steps_a or any(
            not torch.equal(leaves[n], saved_a[n]) for n in saved_a):
        raise AssertionError(f"checkpoint: corrupted {victim}, loaded "
                             f"{path} at step {engine.global_steps}")
    out["walk_back"] = {"corrupted": victim.rsplit("/", 3)[-3:],
                        "loaded": path.rsplit("/", 1)[-1],
                        "global_steps": engine.global_steps}
    del saved_a, leaves

    # (e) fault_tolerance: a poisoned batch rolls back to the last save
    d_e = f"{root.name}/e"
    engine.save_checkpoint(d_e, tag="e")
    steps_e = engine.global_steps
    clean = [step(b) for b in batches[2:4]]
    clean_state = _snapshot(engine)
    engine.load_checkpoint(d_e)
    rollbacks0 = engine.rollbacks
    poisoned = step(faults.poison_batch(batches[2]))
    if engine.rollbacks != rollbacks0 + 1 or \
            engine.global_steps != steps_e or np.isfinite(poisoned):
        raise AssertionError(f"checkpoint: the poisoned step (loss "
                             f"{poisoned}) did not roll back to step "
                             f"{steps_e} (at {engine.global_steps}, "
                             f"rollbacks {engine.rollbacks})")
    cont = [step(b) for b in batches[2:4]]
    loss_d = max(abs(x - y) for x, y in zip(cont, clean))
    state_d = _leaf_spread(_snapshot(engine), clean_state)
    if not (loss_d <= loss_tol and state_d <= leaf_tol):
        raise AssertionError(f"checkpoint: after the rollback {cont} vs the "
                             f"clean run {clean}")
    out["rollback"] = {"poisoned_loss": str(poisoned),
                       "rolled_back_to_step":
                       steps_e, "rollbacks": engine.rollbacks,
                       "continued_losses": cont, "clean_losses": clean,
                       "loss_spread": loss_d, "state_spread": state_d}
    del clean_state
    counts = dict(LAUNCHES)
    n = n_steps[0]
    want = {"flash_attention": 2 * CKPT_LAYERS * CKPT_GAS * n,
            "flash_attention_bwd_dq": CKPT_LAYERS * CKPT_GAS * n,
            "flash_attention_bwd_dkv": CKPT_LAYERS * CKPT_GAS * n}
    _expect("checkpoint", counts, want)

    # the training ledger on the same engine
    ms = engine.memscope
    st = engine.state
    nbytes = {"params_bytes": sum(t.nbytes for t in _leaves(st.params)),
              "master_bytes": sum(t.nbytes for t in _leaves(st.master)),
              "opt_state_bytes": sum(t.nbytes for t in _leaves(
                  st.opt_state))}
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    loss = step(batches[0])
    peak = torch.cuda.max_memory_allocated()
    snap = ms.snapshot()
    plan = ms.plan()
    states = plan.total_device_bytes - plan.device_bytes["grads"]
    if {k: snap[k] for k in nbytes} != nbytes or \
            tree_bytes(st.params) != nbytes["params_bytes"]:
        raise AssertionError(f"checkpoint: ledger {snap} != the state "
                             f"tensors' bytes {nbytes}")
    if abs(states - sum(nbytes.values())) > CKPT_PLAN_SLACK:
        raise AssertionError(f"checkpoint: plan less grads {states} vs the "
                             f"ledger {sum(nbytes.values())}")
    if not np.isfinite(loss):
        raise AssertionError(f"checkpoint: the ledger step's loss {loss}")
    # the card also holds earlier phases' tensors: the step's own peak is
    # its peak less what was allocated beside this engine's states
    others = base - sum(nbytes.values())
    out["memscope"] = {"ledger": snap, "plan": plan.to_dict(),
                       "plan_states_bytes": states,
                       "predicted_peak_bytes": plan.predicted_peak_bytes,
                       "max_memory_allocated_step": peak,
                       "allocated_before_step": base,
                       "allocated_beside_the_engine": others,
                       "step_peak_less_beside": peak - others}
    out["steps"] = n_steps[0] + 1
    out["launches"] = counts
    emit(out)
    root.cleanup()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _leaves(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


# the memscope phase: the serve phase's engine (gpt2-125m, bf16) with
# telemetry.memscope on; its headroom arm sets a capacity 5 % above the
# card's allocated bytes, under the ladder's headroom_low
MEMSCOPE_HEADROOM_LOW, MEMSCOPE_HEADROOM_HIGH = 0.2, 0.3


def phase_memscope(state):
    """The serving ledger on the serve phase's configuration (gpt2-125m,
    16 ragged requests through 8 slots) with telemetry.memscope on: the
    ledger's pool and params bytes equal to the tensors' bytes, exact
    paged-decode launches, tokens equal to a memscope-off engine's;
    max_kv_blocks for the card's free memory; a refusing pre-flight below
    the plan raises PredictedOOMError with memory_allocated unchanged; a
    capacity under headroom_low engages the ladder (level >= 1) and a
    calm one returns it to 0; a real torch.OutOfMemoryError inside a step
    is matched, dumped (ledger + flight events) and re-raised; the int8
    pool's ledger (payload and scales) against the planner."""
    import os
    import tempfile
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.models.gpt import (GPT2_CONFIGS,
                                                make_gpt_decode_model)
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.telemetry import memscope as ms_mod
    cfg = GPT2_CONFIGS["gpt2-125m"]
    out_dir = tempfile.TemporaryDirectory()
    tel = {**REGISTRY_ONLY, "memscope": True, "flight_recorder": True,
           "output_path": out_dir.name}
    spec = make_gpt_decode_model(cfg, name="gpt2-125m", seed=0)
    engine = init_inference(spec, config={**SERVE_ENGINE_CONFIG,
                                          "telemetry": tel})
    # the other engines share the card's params tensors (no copy)
    shared = make_gpt_decode_model(cfg, name="gpt2-125m",
                                   params=engine.params)

    def sibling(**telemetry):
        return init_inference(shared, config={
            **SERVE_ENGINE_CONFIG, "telemetry": {**tel, **telemetry}})

    serving = engine.serving(max_slots=8, max_context=1024)
    scope = serving.memscope
    pool_bytes = sum(t.nbytes for t in serving.pool.values())
    params_bytes = sum(t.nbytes for t in _leaves(engine.params))
    if scope is None or scope.pool_bytes != pool_bytes or \
            scope.params_bytes != params_bytes:
        raise AssertionError(f"memscope: ledger pool / params "
                             f"{getattr(scope, 'pool_bytes', None)} / "
                             f"{getattr(scope, 'params_bytes', None)} != "
                             f"{pool_bytes} / {params_bytes}")
    rng = np.random.default_rng(2)
    lens = rng.integers(100, 601, 16).tolist()
    prompts = _ragged_prompts(rng, lens, 50304)
    new = 32
    reqs = [Request(uid=i, tokens=p, max_new_tokens=new, stop_on_eos=False)
            for i, p in enumerate(prompts)]
    serving.run([Request(uid="warm", tokens=prompts[0], max_new_tokens=2,
                         stop_on_eos=False)])
    steps0 = serving.stats()["decode_steps"]
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serving.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    steps = (serving.stats()["decode_steps"] - steps0) * serving.window
    _expect("memscope", counts,
            {"paged_decode_attention": cfg.n_layer * steps})
    engine_off = init_inference(shared, config=SERVE_ENGINE_CONFIG)
    off = engine_off.serving(max_slots=8, max_context=1024)
    if off.memscope is not None:
        raise AssertionError("memscope: the memscope-off engine has a ledger")
    res_off = off.run([Request(uid=i, tokens=p, max_new_tokens=new,
                               stop_on_eos=False)
                       for i, p in enumerate(prompts)])
    if any(not np.array_equal(res[i].tokens, res_off[i].tokens)
           for i in range(16)):
        raise AssertionError("memscope: served tokens differ from the "
                             "memscope-off engine's")
    snap = serving.stats()["memory"]
    del off, engine_off
    gc.collect()
    free, total = torch.cuda.mem_get_info()
    blocks = ms_mod.max_kv_blocks(
        free, n_layer=cfg.n_layer, n_kv_head=cfg.n_kv_head,
        head_dim=cfg.head_dim, kv_block_size=serving.block_size)
    out = {"phase": "memscope", "model": "gpt2-125m", "requests": 16,
           "slots": 8, "seconds": dt, "tokens_per_s": 16 * new / dt,
           "launches": counts, "ledger": snap,
           "max_kv_blocks_free_memory": {"free_bytes": free,
                                         "total_bytes": total,
                                         "block_size": serving.block_size,
                                         "blocks": blocks}}

    # a refusing pre-flight below the plan: nothing is allocated
    refusing = sibling(memscope_preflight="refuse",
                       memscope_capacity_bytes=pool_bytes // 2)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        refusing.serving(max_slots=8, max_context=1024)
        raise AssertionError("memscope: the refusing pre-flight built")
    except ms_mod.PredictedOOMError as e:
        refused = str(e).splitlines()[0]
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"memscope: memory_allocated {before} -> "
                             f"{after} across the refused pre-flight")
    out["preflight_refusal"] = {"message": refused,
                                "allocated_before": before,
                                "allocated_after": after}

    # the headroom signal: a capacity 5 % above what the card holds
    cap = int(torch.cuda.memory_allocated() * 1.05)
    tight = sibling(memscope_capacity_bytes=cap).serving(
        max_slots=8, max_context=1024,
        degradation={"enabled": True, "eval_interval": 1,
                     "free_block_low": -1.0, "free_block_high": -1.0,
                     "queue_high": 10**6, "queue_low": 10**6,
                     "hold_steps": 1,
                     "headroom_low": MEMSCOPE_HEADROOM_LOW,
                     "headroom_high": MEMSCOPE_HEADROOM_HIGH})
    levels = []
    for i in range(4):
        tight.run([Request(uid=f"h{i}", tokens=prompts[i], max_new_tokens=4,
                           stop_on_eos=False)])
        levels.append(tight.pressure.level)
    pressured = tight.memscope.headroom_frac()
    tight.memscope.capacity_override = total      # the whole card: calm
    for _ in range(8):
        tight.pressure.update([])
        levels.append(tight.pressure.level)
    if not max(levels) >= 1 or levels[-1] != 0:
        raise AssertionError(f"memscope: ladder levels {levels} under "
                             f"headroom {pressured}")
    out["headroom_ladder"] = {"capacity_bytes": cap,
                              "headroom_frac": pressured,
                              "calm_headroom_frac":
                                  tight.memscope.headroom_frac(),
                              "levels": levels}
    del tight

    # a real allocator failure inside a step
    victim = sibling().serving(max_slots=8, max_context=1024)
    victim.run([Request(uid="v", tokens=prompts[1], max_new_tokens=2,
                        stop_on_eos=False)])

    def too_big(*a, **k):
        free_now, _ = torch.cuda.mem_get_info()
        return torch.empty(free_now + (8 << 30), dtype=torch.uint8,
                           device="cuda")

    victim._decode_step = too_big
    victim.submit(Request(uid="oom", tokens=prompts[2], max_new_tokens=4,
                          stop_on_eos=False))
    caught = None
    try:
        for _ in range(8):
            victim.step()
    except torch.OutOfMemoryError as e:
        caught = e
    dumps = sorted(f for f in os.listdir(out_dir.name)
                   if f.startswith("serving.memscope.oom."))
    if caught is None or not ms_mod.is_resource_exhausted(caught) or \
            not dumps:
        raise AssertionError(f"memscope: OOM {caught!r}, dumps {dumps}")
    with open(os.path.join(out_dir.name, dumps[-1])) as f:
        dump = json.load(f)
    if not dump["ledger"]["kv_pool_bytes"] or not dump["flight_events"]:
        raise AssertionError("memscope: the OOM dump lacks the ledger or "
                             "the flight events")
    out["oom"] = {"error": type(caught).__name__, "dump": dumps[-1],
                  "flight_events": len(dump["flight_events"]),
                  "plan_delta": dump["plan_delta"]}
    del victim, caught
    gc.collect()
    torch.cuda.empty_cache()

    # the int8 pool's ledger: payload + f32 scales, as the planner prices it
    q = sibling().serving(max_slots=8, max_context=1024,
                          quantization={"kv_cache_dtype": "int8"})
    q_bytes = sum(t.nbytes for t in q.pool.values())
    L, N, Hkv, B, hd = q.pool["k"].shape
    planned = ms_mod.serving_pool_bytes(
        n_layer=L, n_kv_head=Hkv, head_dim=hd, kv_block_size=B,
        num_kv_blocks=N, kv_cache_dtype="int8")
    if not q.memscope.pool_bytes == q_bytes == planned:
        raise AssertionError(f"memscope: int8 ledger {q.memscope.pool_bytes}"
                             f", tensors {q_bytes}, plan {planned}")
    out["int8_pool"] = {"pool_bytes": q_bytes,
                        "bf16_pool_bytes": pool_bytes,
                        "ratio": pool_bytes / q_bytes}
    emit(out)
    del q, serving, engine
    gc.collect()
    torch.cuda.empty_cache()
    out_dir.cleanup()
    return counts


def _offload_kernels(rng, checks, results):
    """Rows 1-5 at the offload paths' shapes: the flash forward and both
    backward kernels at the offload lane's [4, 256, 4, 64] and the
    infinity phase's [4, 1024, 16, 128]; the flash forward at
    zero_inference's longest prefill, the contiguous decode over its
    1024-row cache and the paged decode over 8 slots at 16 heads of 128;
    zero_offload runs the north-star shape (its rows reused)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import flash_attention as fa
    for shape, path, bwd in ((OFFLOAD_ATTN, "offload", True),
                             (INFINITY_ATTN, "infinity", True),
                             (ZI_PREFILL, "zero_inference_generate", False)):
        q, k, v, causal = _flash_case(rng, **shape)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                               layout="BTHD")
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal,
                                                    layout="BTHD")
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = err <= TOL["flash_attention"] and lse_err <= 1e-2
        checks.append({"kernel": "flash_attention", "shape": shape,
                       "max_abs_err": err, "tol": TOL["flash_attention"],
                       "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention {shape}: err {err}, lse "
                                 f"err {lse_err}")
        results["flash_attention", path] = _flash_fwd_row(
            q, k, v, causal, err, plain_reps=(3, 1, 1))
        if bwd:
            q, k, v, do, out, lse, _, errs, _ = _backward_case(
                rng, checks, shape, False)
            results.update(_flash_bwd_rows(path, q, k, v, do, out, lse,
                                           errs, shape["causal"]))
    kw = _decode_args(rng, ZI_DECODE)
    q, kc, vc, pos = (kw[n] for n in ("q", "k", "v", "pos"))
    err = (da.decode_attention(q, kc, vc, pos).float()
           - da.decode_attention_reference(q, kc, vc, pos).float()
           ).abs().max().item()
    checks.append({"kernel": "decode_attention", "shape": ZI_DECODE,
                   "max_abs_err": err, "tol": TOL["decode_attention"],
                   "ok": err <= TOL["decode_attention"]})
    if not err <= TOL["decode_attention"]:
        raise AssertionError(f"decode_attention {ZI_DECODE}: err {err}")
    b_ms, b_by = _decode_bound(ZI_DECODE)
    mask = (torch.arange(kc.shape[2], device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]
    results["decode_attention", "zero_inference_generate"] = dict(
        max_abs_err=err, ms=median_ms(lambda: da.decode_attention(
            q, kc, vc, pos)),
        plain_ms=median_ms(lambda: da.decode_attention_reference(
            q, kc, vc, pos)), bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask)))
    q, kp, vp, tables, pos = _paged_case(rng, **ZI_PAGED)
    out = da.paged_decode_attention(q, kp, vp, tables, pos)
    ref = da.paged_decode_attention_reference(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    checks.append({"kernel": "paged_decode_attention", "shape": ZI_PAGED,
                   "max_abs_err": err, "tol": TOL["decode_attention"],
                   "ok": err <= TOL["decode_attention"]})
    if not err <= TOL["decode_attention"]:
        raise AssertionError(f"paged_decode_attention {ZI_PAGED}: {err}")
    B, H, hd = q.shape
    Hkv = kp.shape[1]
    live = sum(p + 1 for p in ZI_PAGED["pos"])
    b_ms, b_by = bound(2 * live * Hkv * hd * 2 + 2 * B * H * hd * 2
                       + tables.numel() * 4, 4 * live * H * hd, FP32_FLOPS)
    results["paged_decode_attention", "zero_inference_serve"] = dict(
        max_abs_err=err, ms=median_ms(lambda: da.paged_decode_attention(
            q, kp, vp, tables, pos)),
        plain_ms=median_ms(lambda: da.paged_decode_attention_reference(
            q, kp, vp, tables, pos)), bound_ms=b_ms, bound_by=b_by,
        library_ms=None)
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        results[name, "zero_offload"] = results[name, "north_star"]
        results[name, "zero"] = results[name, "north_star"]


# ----------------------------------------------------------------------
# the autoscaler and data-parallel ZeRO over a process group
# ----------------------------------------------------------------------

# the autoscale cell: the router lane's model and trace (bench.py:1015-1109,
# the router phase's weights when it ran), one replica to start, at most 2;
# a burst of the 16 requests is the pressure (4 a live replica), the hot
# 512-token prefix the join warmup; idle ticks drain and reap the pool
AUTOSCALE = dict(min_replicas=1, max_replicas=2,
                 scale_up_queue_per_replica=4.0, sustain_up=2,
                 sustain_down=4, cooldown_ticks=2, warmup_prompts=1)
AUTOSCALE_IDLE_TICKS = 40
# the zero cell: the north-star lane's width (gpt2-1.3b, bench.py:1970) at
# ZERO_LAYERS of 24 layers, micro-batch 4, seq 512, gas 2, bf16 with the
# bf16 accumulator and the lane's remat policy, 1 warm-up + 2 steps at each
# of ZeRO stages 0-3, over a one-rank NCCL process group and again without
# a group
ZERO_LAYERS, ZERO_GAS, ZERO_STEPS = 2, 2, 3
ZERO_CONFIG = {**NORTH_CONFIG, "gradient_accumulation_steps": ZERO_GAS,
               "telemetry": {"enabled": False}}
ZERO_MAX_RANKS = 4
ZERO_BACKEND, ZERO_DEVICE = "nccl", "cuda:0"


def phase_autoscale(state):
    """The router lane's trace as a burst on one in-process replica behind
    a ServingRouter with the Autoscaler ticking once a router step: the
    pool scales to 2 (the joiner warmed with the hot prefix), serves every
    request once, then idle ticks drain and reap it back to 1. Exactly one
    scale-up and one scale-down, the joiner's affinity hits > 0, served
    tokens equal to generate()'s choice on the same prefix on >= 0.9,
    every audit clean, paged-decode launches exact; then the pool's
    snapshot through `serving.top_cli` and its JSONL through
    `telemetry.cli`, both exit 0."""
    import contextlib
    import io
    import tempfile
    import torch
    from deepspeed_tpu_torch.config.core import TelemetryConfig
    from deepspeed_tpu_torch.inference.scheduler import Request
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.serving import (Autoscaler, InProcessReplica,
                                             ServingRouter, top_cli)
    from deepspeed_tpu_torch.telemetry import cli as metrics_cli
    t_phase = time.perf_counter()
    if "router_engine" in state:
        cfg, engine = state["router_engine"]
    else:
        cfg, _, engine = _lane_engine(PREFIX_CFG, "router-lane")
    L = cfg.n_layer
    prompts, news = _router_trace(cfg.vocab_size)
    hot = prompts[0][:ROUTER_PREFIX]     # the shared prefix (bench.py:1063)
    handles = []

    def replica(rid):
        handles.append(InProcessReplica(engine=engine.serving(
            max_slots=ROUTER_SLOTS, max_context=1024, prefill_chunk=128,
            enable_prefix_caching=True), replica_id=rid))
        return handles[-1]

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_autoscale_")
    router = ServingRouter(replicas=[replica("r0")],
                           telemetry_config=TelemetryConfig(
                               enabled=True, prometheus=False, jsonl=True,
                               monitor_bridge=False, flight_recorder=True,
                               output_path=out_dir))
    scaler = Autoscaler(router, spawn=lambda i: replica(f"auto{i}"),
                        **AUTOSCALE)
    scaler.note_prompt(hot)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (p, n) in enumerate(zip(prompts, news)):
        router.submit(Request(uid=i, tokens=p, max_new_tokens=n,
                              stop_on_eos=False))
    done, actions, joined = {}, [], {}
    hits_at_join = 0
    while router.in_flight or router._finished_buf:
        for d in router.step():
            if d.uid in done:
                raise AssertionError(f"autoscale: uid {d.uid} completed "
                                     f"twice")
            done[d.uid] = d
        act = scaler.tick()
        actions.append(act)
        if act == "scale_up":
            rep = handles[-1]
            joined = {"replica": rep.replica_id,
                      "warm_affinity_blocks": rep.affinity(
                          rep.hash_chain(hot))}
            hits_at_join = router.counters["affinity_hits"]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    for _ in range(AUTOSCALE_IDLE_TICKS):
        router.step()
        act = scaler.tick()
        actions.append(act)
        if act == "reap":
            break
    counts = dict(LAUNCHES)
    reqs = [Request(uid=i, tokens=p, max_new_tokens=n, stop_on_eos=False)
            for i, (p, n) in enumerate(zip(prompts, news))]
    _completed("autoscale", done, reqs)
    ups, downs = actions.count("scale_up"), actions.count("scale_down")
    if (ups, downs, actions.count("reap")) != (1, 1, 1) or \
            len(router.replicas) != 1:
        raise AssertionError(f"autoscale: {ups} scale-ups, {downs} "
                             f"scale-downs, pool {sorted(router.replicas)} "
                             f"({scaler.stats()})")
    joiner_hits = router.counters["affinity_hits"] - hits_at_join
    if not (joined.get("warm_affinity_blocks", 0) > 0 and joiner_hits > 0):
        raise AssertionError(f"autoscale: the joiner's affinity {joined}, "
                             f"hits after the join {joiner_hits}")
    _expect("autoscale", counts, {"paged_decode_attention": L * sum(
        h.stats()["decode_steps"] for h in handles)})
    forced = _router_forced(engine, prompts, done)
    if not forced["share"] >= ROUTER_AGREE_MIN:
        raise AssertionError(f"autoscale: tokens equal generate()'s choice "
                             f"on {forced['share']:.3f} < "
                             f"{ROUTER_AGREE_MIN}")
    audits = {}
    for h in handles:
        if h.replica_id in router.replicas:
            audits[h.replica_id] = _clean_close(f"autoscale {h.replica_id}",
                                                h.engine)
        else:                    # reaped: closed by the router already
            audit = h.engine.stats().get("audit", {})
            if audit.get("violations"):
                raise AssertionError(f"autoscale {h.replica_id}: audit "
                                     f"{audit}")
            audits[h.replica_id] = "reaped"
    kinds = [e["kind"] for e in router.flightrec.events()]
    for kind in ("scale_up", "scale_down", "reap"):
        if kind not in kinds:
            raise AssertionError(f"autoscale: no {kind!r} flight event "
                                 f"({kinds})")
    snap = router.observability_snapshot(refresh=True)
    snap_path = f"{out_dir}/pool_snapshot.json"
    with open(snap_path, "w") as f:
        json.dump(snap, f, default=str)
    router.telemetry.export(router.steps)
    with contextlib.redirect_stdout(io.StringIO()) as cli_out:
        rc_top = top_cli.main([snap_path])
        rc_metrics = metrics_cli.main([out_dir])
    if (rc_top, rc_metrics) != (0, 0):
        raise AssertionError(f"autoscale: dstpu_top rc {rc_top}, "
                             f"dstpu_metrics rc {rc_metrics}")
    fabric = {k: v for k, v in snap.get("counters", {}).items() if v}
    router.telemetry.close()
    emit({"phase": "autoscale", "model": PREFIX_CFG, "dtype": "bfloat16",
          "source": "bench.py:1015-1109 (the router lane's model and trace)",
          "requests": ROUTER_REQUESTS, "slots_per_replica": ROUTER_SLOTS,
          "autoscaler": AUTOSCALE, "actions": [a for a in actions if a],
          "ticks": scaler.ticks, "stats": scaler.stats(),
          "joined": joined, "joiner_affinity_hits": joiner_hits,
          "served_tokens": sum(len(d.tokens) for d in done.values()),
          "serve_wall_s": serve_s,
          "tokens_per_s": sum(len(d.tokens) for d in done.values())
          / serve_s,
          "forced_agreement": forced["share"],
          "differing_top2_gaps": forced["differing_top2_gaps"],
          "router_counters": fabric, "audit": audits,
          "flight_events": dict(collections.Counter(kinds)),
          "cli_chars": len(cli_out.getvalue()),
          "launches": counts, "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": state["nvidia_smi"]})
    return counts


def _zero_free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _zero_cfg():
    from deepspeed_tpu_torch.models.gpt import GPT2_CONFIGS
    return dataclasses.replace(GPT2_CONFIGS[NORTH_MODEL], n_layer=ZERO_LAYERS,
                               remat_policy=TRAIN_POLICY)


def _zero_batch(cfg):
    import torch
    rng = np.random.default_rng(8)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (NORTH_MBS * ZERO_GAS, NORTH_SEQ + 1))).to(
            ZERO_DEVICE)}


def _zero_run(stage, params, batch, save_dir=None):
    """One engine at `stage` (over the process group when one is up):
    losses, seconds a step, the final params (host copies), the flash
    launches, the facade's calls a step and its stats, and where every
    state tensor lives. With `save_dir`, then a checkpoint save: its
    seconds and the allocator's peak above the bytes held when it
    began."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.comm import collectives as coll
    from deepspeed_tpu_torch.models.gpt import make_gpt_model
    from deepspeed_tpu_torch.ops.op_builder import LAUNCHES
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    cfg = _zero_cfg()
    config = dict(ZERO_CONFIG, zero_optimization={"stage": stage})
    engine, *_ = initialize(model=make_gpt_model(cfg, name=NORTH_MODEL,
                                                 params=params),
                            config=config)
    LAUNCHES.clear()
    coll.LAUNCHES.clear()
    coll.stats.reset()
    losses, step_s = [], []
    for _ in range(ZERO_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - t0)
    devices = {str(t.device) for t in tree_leaves(
        (engine.state.params, engine.state.master, engine.state.opt_state,
         engine.state.scaler, engine.state.step))}
    out = {"losses": losses, "step_s": step_s,
           "seconds_per_step": statistics.median(step_s[1:]),
           "params": [t.detach().cpu() for t in tree_leaves(
               engine.state.params)],
           "launches": dict(LAUNCHES),
           "comm_launches": {k: v / ZERO_STEPS for k, v in
                             coll.LAUNCHES.items()},
           "comm_stats": coll.stats.snapshot(), "devices": devices,
           "sharded": engine.sharded,
           "dims": [engine._pdims, engine._sdims, engine._gdims]}
    if save_dir is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine.save_checkpoint(save_dir, tag="zero")
        out["save"] = {"seconds": time.perf_counter() - t0, "held": held,
                       "peak_above_held":
                       torch.cuda.max_memory_allocated() - held}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _zero_facade(x):
    """The facade's primitives on the card over the one-rank NCCL group: each
    returns its input (the untiled gather stacked), issues one operation to
    NCCL and records no wire bytes."""
    import torch
    from deepspeed_tpu_torch.comm import collectives as coll
    from deepspeed_tpu_torch.comm import comm
    coll.LAUNCHES.clear()
    coll.stats.reset()
    outs = {"all_reduce": coll.psum(x, "data"),
            "all_gather": coll.all_gather(x, "data")[0],
            "reduce_scatter": coll.reduce_scatter(x, "data"),
            "broadcast": comm.broadcast(x, src=0)}
    torch.cuda.synchronize()
    bad = [k for k, v in outs.items() if not torch.equal(v, x)]
    if bad:
        raise AssertionError(f"zero facade: {bad} changed the tensor at one "
                             f"rank")
    if dict(coll.LAUNCHES) != {k: 1 for k in outs}:
        raise AssertionError(f"zero facade: launches {dict(coll.LAUNCHES)}")
    if coll.stats.snapshot():
        raise AssertionError(f"zero facade: wire bytes at one rank "
                             f"{coll.stats.snapshot()}")
    return dict(coll.LAUNCHES)


def phase_zero(state):
    """Data-parallel ZeRO on the card: the north-star width at ZERO_LAYERS
    layers, stages 0-3, first over a real NCCL process group of one rank
    (a TCPStore on 127.0.0.1, destroyed at the phase's end), then with no
    group; the losses and final params bit-equal between the two (else
    within the repeated run's spread), the flash launches exact, every
    state tensor on the card, no facade call in the step (at one rank
    nothing is sharded, JAX's rule) and 0 wire bytes, each stage's seconds
    a step beside stage 0's. On the group, the facade's primitives once
    each on the wte's bytes (each its input back, one NCCL operation), and
    a stage-3 save whose allocator peak stays within CKPT_MEM_SLACK of the
    bytes held. With more than one card visible, one rank a card (up to
    ZERO_MAX_RANKS) trains stage 3 and the ranks' params must agree bit
    for bit."""
    import tempfile
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.gpt import init_gpt_params
    t_phase = time.perf_counter()
    cfg = _zero_cfg()
    params = init_gpt_params(cfg, seed=0)
    batch = _zero_batch(cfg)
    store = dist.TCPStore("127.0.0.1", _zero_free_port(), 1, True)
    dist.init_process_group(ZERO_BACKEND, store=store, rank=0, world_size=1)
    root = tempfile.TemporaryDirectory()
    try:
        comm.init_distributed(device=ZERO_DEVICE)
        facade = _zero_facade(params["wte"].to(ZERO_DEVICE).reshape(-1))
        grouped = {s: _zero_run(s, params, batch,
                                f"{root.name}/s3" if s == 3 else None)
                   for s in (0, 1, 2, 3)}
    finally:
        comm.destroy_process_group()
        del store
        root.cleanup()
    save = grouped[3]["save"]
    if save["peak_above_held"] > CKPT_MEM_SLACK:
        raise AssertionError(f"zero stage 3: the save's allocator peak "
                             f"{save['peak_above_held']} B above the "
                             f"{save['held']} B held")
    alone = {s: _zero_run(s, params, batch) for s in (0, 1, 2, 3)}
    L = cfg.n_layer
    want = {"flash_attention": 2 * L * ZERO_GAS * ZERO_STEPS,
            "flash_attention_bwd_dq": L * ZERO_GAS * ZERO_STEPS,
            "flash_attention_bwd_dkv": L * ZERO_GAS * ZERO_STEPS}
    stages = {}
    for s in (0, 1, 2, 3):
        g, a = grouped[s], alone[s]
        for path, run in (("grouped", g), ("alone", a)):
            _expect(f"zero stage {s} {path}", run["launches"], want)
            if run["devices"] != {ZERO_DEVICE}:
                raise AssertionError(f"zero stage {s} {path}: state on "
                                     f"{run['devices']}")
            if not all(np.isfinite(run["losses"])):
                raise AssertionError(f"zero stage {s} {path}: losses "
                                     f"{run['losses']}")
        if not g["sharded"] or a["sharded"]:
            raise AssertionError(f"zero stage {s}: the grouped engine must "
                                 f"be sharded, the other not")
        if any(d is not None for dims in g["dims"] for d in dims) or \
                g["comm_launches"]:
            raise AssertionError(f"zero stage {s}: at one rank nothing is "
                                 f"sharded and the step issues no "
                                 f"collective; dims {g['dims']}, facade "
                                 f"calls a step {g['comm_launches']}")
        if g["comm_stats"]:
            raise AssertionError(f"zero stage {s}: wire bytes at one rank "
                                 f"{g['comm_stats']}")
        bit_equal = g["losses"] == a["losses"] and all(
            torch.equal(x, y) for x, y in zip(g["params"], a["params"]))
        spread = None
        if not bit_equal:
            again = _zero_run(s, params, batch)
            spread = max(float((x.float() - y.float()).abs().max())
                         for x, y in zip(again["params"], a["params"]))
            diff = max(float((x.float() - y.float()).abs().max())
                       for x, y in zip(g["params"], a["params"]))
            lspread = max(abs(x - y) for x, y in zip(again["losses"],
                                                     a["losses"]))
            ldiff = max(abs(x - y) for x, y in zip(g["losses"],
                                                   a["losses"]))
            if not (diff <= spread and ldiff <= lspread):
                raise AssertionError(
                    f"zero stage {s}: grouped vs alone params {diff}, "
                    f"losses {ldiff}; the repeated run's spread {spread}, "
                    f"{lspread}")
        stages[s] = {"losses": g["losses"], "bit_equal": bit_equal,
                     "spread": spread,
                     "seconds_per_step": g["seconds_per_step"],
                     "seconds_per_step_alone": a["seconds_per_step"],
                     "vs_stage0": g["seconds_per_step"]
                     / grouped[0]["seconds_per_step"],
                     "facade_calls_per_step": g["comm_launches"],
                     "step_s": g["step_s"]}
    ranks = None
    n_cards = min(torch.cuda.device_count(), ZERO_MAX_RANKS)
    if n_cards > 1:
        ranks = _zero_ranks(n_cards)
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    emit({"phase": "zero", "model": NORTH_MODEL, "n_layer": L,
          "n_params": n_params, "source": "bench.py:1970-1977 (north-star "
          "width, ZERO_LAYERS of 24 layers, gas 2)",
          "config": ZERO_CONFIG, "seq": NORTH_SEQ, "remat": cfg.remat_policy,
          "world_size": 1, "backend": ZERO_BACKEND, "stages": stages,
          "facade_launches": facade, "save_stage3": save, "ranks": ranks, "launches": grouped[3]["launches"],
          "phase_s": time.perf_counter() - t_phase,
          "nvidia_smi": state["nvidia_smi"]})
    return grouped[3]["launches"]


def _zero_rank(rank, world, store_dir, results):
    """One rank of the multi-card check: stage 3 over NCCL, the same global
    batch on every rank; its params' bytes digest."""
    import hashlib
    import torch
    import torch.distributed as dist
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt import make_gpt_model
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(
        f"{store_dir}/store", world), rank=rank, world_size=world)
    try:
        cfg = _zero_cfg()
        config = dict(ZERO_CONFIG, zero_optimization={"stage": 3},
                      mesh={"data": world})
        engine, *_ = initialize(model=make_gpt_model(
            cfg, name=NORTH_MODEL, seed=0), config=config)
        batch = {"tokens": torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (NORTH_MBS * ZERO_GAS * world,
                                NORTH_SEQ + 1))).cuda()}
        losses = [float(engine.train_batch(batch)) for _ in range(2)]
        full = engine._full_state().params
        digest = hashlib.sha256()
        for t in tree_leaves(full):
            digest.update(t.detach().cpu().view(torch.uint8).numpy()
                          .tobytes())
        results.put((rank, losses, digest.hexdigest()))
    finally:
        dist.destroy_process_group()


def _zero_ranks(world):
    """Stage 3 on `world` cards, one spawned rank a card: every rank's
    losses and params must agree bit for bit."""
    import tempfile
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    procs = [ctx.Process(target=_zero_rank,
                         args=(r, world, store_dir, results))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = sorted(results.get(timeout=600) for _ in range(world))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    if len({(tuple(losses), digest) for _, losses, digest in got}) != 1:
        raise AssertionError(f"zero across {world} cards: ranks disagree "
                             f"{got}")
    return {"world_size": world, "losses": got[0][1], "digest": got[0][2]}


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
        ["build", "kernels", "norms", "generate", "serve", "quant",
         "prefix_cache", "spec_decode", "train", "north_star", "longctx",
         "longctx16k", "routing", "bert", "llama", "moe", "sparse",
         "evoformer", "offload", "infinity", "zero_inference",
         "zero_offload", "checkpoint", "memscope", "router", "robustness",
         "fabric", "autoscale", "zero"]
    dev = phase_device()
    state, launches, kern, wall = {"nvidia_smi": dev["nvidia_smi"]}, {}, \
        {}, {}
    t0 = time.perf_counter()
    if "build" in phases:
        phase_build()
        wall["build"] = time.perf_counter() - t0
    # the norms phase's trace check goes first: after the kernels phase's
    # many profiler sessions a session can record none of a call's kernels
    if "norms" in phases:
        t0 = time.perf_counter()
        launches["norms"] = phase_norms(state)
        wall["norms"] = time.perf_counter() - t0
    if "kernels" in phases:
        t0 = time.perf_counter()
        kern = phase_kernels()
        wall["kernels"] = time.perf_counter() - t0
    for phase, run in (("generate", phase_generate), ("serve", phase_serve),
                       ("quant", phase_quant),
                       ("prefix_cache", phase_prefix_cache),
                       ("spec_decode", phase_spec_decode),
                       ("train", phase_train),
                       ("north_star", phase_north_star),
                       ("longctx", phase_longctx),
                       ("longctx16k", phase_longctx16k),
                       ("routing", phase_routing),
                       ("bert", phase_bert), ("llama", phase_llama),
                       ("moe", phase_moe), ("sparse", phase_sparse),
                       ("evoformer", phase_evoformer),
                       ("offload", phase_offload),
                       ("infinity", phase_infinity),
                       ("zero_inference", phase_zero_inference),
                       ("zero_offload", phase_zero_offload),
                       ("checkpoint", phase_checkpoint),
                       ("memscope", phase_memscope),
                       ("router", phase_router),
                       ("robustness", phase_robustness),
                       ("fabric", phase_fabric),
                       ("autoscale", phase_autoscale),
                       ("zero", phase_zero)):
        if phase in phases:
            t0 = time.perf_counter()
            counts = run(state)        # counts of each path's run; the
            # quant, moe, sparse, evoformer, bert and llama phases run
            # several paths each and return {path: counts}
            launches.update(counts if phase in (
                "quant", "spec_decode", "moe", "sparse", "evoformer", "bert",
                "llama", "offload", "infinity", "zero_inference",
                "zero_offload", "router", "robustness", "fabric")
                else {phase: counts})
            wall[phase] = time.perf_counter() - t0
    if "profile" in phases:
        phase_profile(state)
    emit({"phase": "wall_seconds", "seconds": wall})
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
