"""Where the offload lane's step goes, arm by arm: bench.py's offload lane
(chip_smoke.OFFLOAD_CFG: 8 layers, d_model 256, vocab 8192, B 4, T 256,
bf16) through InfinityEngine on one CUDA card, at several
(lookahead, landing_depth) pairs, on the nvme tier (the swap folder under
chip_smoke.SWAP_ROOT) and the cpu tier.

    python tools/offload_ab.py [--steps N] [--arms 0:1,2:2,...]
        [--tiers nvme,cpu] [--trace DIR]

For each tier and arm: one warm-up step, then N timed steps on the same
batches as chip_smoke's offload phase, and
  * the host's time in each part of the streamer and the host step,
    summed over the timed steps (`host_ms`): `upload` (LayerStreamer.
    _upload: the store's get plus the copy's enqueue), `read_wait`
    (LayerParamStore._settle: waiting for an AIO read), `prefetch`
    (issuing a read, its slot's waits included), `copy_wait` (a staging
    slot waiting for the copy that reads its buffers), `host_step`
    (InfinityEngine._layer_step_host: the C++ step and the write-back),
    `adam` (the C++ step alone), `put`, `flush_writes`, and the
    landing wait and the streamer's stall as the engine counts them;
  * one more step under torch.profiler: the card's busy time, the
    host-to-device copies' time, and the host's time in the CUDA calls
    that can block it (`cudaEventSynchronize`, `cudaStreamSynchronize`,
    `cudaMalloc`, `cudaHostAlloc`, `cudaMemcpyAsync`, ...), each with its
    count; with --trace, that step's chrome trace is written to DIR, gzipped.
Every arm's losses must be bit-identical to the first arm's of its tier.
Prints one JSON line per (tier, arm), then the card's name and power
limit and OpenMP's thread count. Run from the repo's root; it needs the
CUDA toolkit, g++ and a card.
"""

import argparse
import gzip
import json
import pathlib
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.models.gpt import (GPTConfig,  # noqa: E402
                                            init_gpt_params,
                                            make_gpt_layered_model)
from deepspeed_tpu_torch.ops.op_builder import omp_threads  # noqa: E402
from deepspeed_tpu_torch.runtime.infinity import InfinityEngine  # noqa: E402

# the CUDA runtime calls a host thread can block in
_BLOCKING = ("cudaEventSynchronize", "cudaStreamSynchronize",
             "cudaDeviceSynchronize", "cudaMalloc", "cudaFree",
             "cudaHostAlloc", "cudaFreeHost", "cudaMemcpyAsync",
             "cudaStreamWaitEvent", "cudaEventQuery", "cudaLaunchKernel")


def _timed(obj, name, acc, key):
    """Wrap obj.name so that its host ms add into acc[key]."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[key] = acc.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
    setattr(obj, name, wrapper)


class _TimedEvent:
    """A CUDA event whose synchronize() adds its host ms into acc."""

    def __init__(self, event, acc):
        self.event, self.acc = event, acc

    def synchronize(self):
        t0 = time.perf_counter()
        self.event.synchronize()
        self.acc["copy_wait"] = self.acc.get("copy_wait", 0.0) \
            + (time.perf_counter() - t0) * 1e3

    def __getattr__(self, name):
        return getattr(self.event, name)


def _instrument(eng, acc):
    store, streamer = eng.store, eng.streamer
    _timed(streamer, "_upload", acc, "upload")
    _timed(store, "_settle", acc, "read_wait")
    _timed(store, "prefetch", acc, "prefetch")
    _timed(store, "put", acc, "put")
    _timed(store, "flush_writes", acc, "flush_writes")
    _timed(eng, "_layer_step_host", acc, "host_step")
    for opt in eng.layer_opts:
        _timed(opt, "step", acc, "adam")
    mark = store.mark_read

    def mark_read(i, event):
        return mark(i, _TimedEvent(event, acc))
    store.mark_read = mark_read


def _profile(eng, batch, trace):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.train_batch(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if trace is not None:
        prof.export_chrome_trace(str(trace))
        with open(trace, "rb") as f, gzip.open(f"{trace}.gz", "wb") as g:
            shutil.copyfileobj(f, g)
        trace.unlink()
    busy = copies = 0.0
    calls = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        if ev.device_type.name == "CUDA" and dev > 0:
            if "Memcpy HtoD" in ev.key:
                copies += dev / 1e3
            else:
                busy += dev / 1e3
        elif ev.key in _BLOCKING:
            calls[ev.key] = {"count": ev.count,
                             "host_ms": ev.self_cpu_time_total / 1e3}
    return {"profiled_wall_ms": wall_ms, "kernels_ms": busy,
            "htod_copies_ms": copies, "cuda_calls": calls}


def _arm(cfg, params, batches, tier, lookahead, landing, trace_dir):
    folder = cs._swap_dir(f"offload_ab_{tier}_{lookahead}_{landing}")
    eng = InfinityEngine(make_gpt_layered_model(cfg, params=params),
                         lr=1e-3, dtype=torch.bfloat16, offload_device=tier,
                         nvme_path=folder if tier == "nvme" else None,
                         lookahead=lookahead, landing_depth=landing)
    losses = [eng.train_batch(batches[0])]                  # warm-up
    acc = {}
    _instrument(eng, acc)
    base = eng.offload_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [eng.train_batch(b) for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = len(batches) - 1
    off = eng.offload_stats()
    acc["stall"] = off["staging"]["stall_ms_total"] \
        - base["staging"]["stall_ms_total"]
    acc["landing_wait"] = off["hostward_wait_ms_total"] \
        - base["hostward_wait_ms_total"]
    trace = None if trace_dir is None else \
        pathlib.Path(trace_dir) / f"{tier}_la{lookahead}_land{landing}.json"
    prof = _profile(eng, batches[1], trace)
    eng.release()
    shutil.rmtree(folder, ignore_errors=True)
    return losses, {
        "tier": tier, "lookahead": lookahead, "landing_depth": landing,
        "step_ms": dt / steps * 1e3,
        "host_ms_per_step": {k: v / steps for k, v in sorted(acc.items())},
        "uploads": off["staging"]["uploads"],
        "hit_rate": off["staging"]["hit_rate"],
        "write_flushes": off["write_flushes"], **prof}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=cs.OFFLOAD_STEPS)
    ap.add_argument("--arms", default="0:1,1:1,2:2,2:1,0:2")
    ap.add_argument("--tiers", default="nvme,cpu")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if args.trace:
        pathlib.Path(args.trace).mkdir(parents=True, exist_ok=True)
    cfg = GPTConfig(**cs.OFFLOAD_CFG, remat=False, dtype="bfloat16")
    params = init_gpt_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size,
                                       (cs.OFFLOAD_B, cs.OFFLOAD_T + 1))}
               for _ in range(args.steps + 1)]
    arms = [tuple(int(v) for v in a.split(":")) for a in args.arms.split(",")]
    for tier in args.tiers.split(","):
        first = None
        for lookahead, landing in arms:
            losses, row = _arm(cfg, params, batches, tier, lookahead,
                               landing, args.trace)
            first = losses if first is None else first
            row["losses_equal_first_arm"] = losses == first
            row["losses"] = losses
            print(json.dumps(row), flush=True)
            if losses != first:
                raise AssertionError(f"{tier} arm {lookahead}:{landing} "
                                     f"losses {losses} != {first}")
    smi = cs.phase_device()["nvidia_smi"]
    print(json.dumps({"nvidia_smi": smi, "omp_threads": omp_threads()}))


if __name__ == "__main__":
    main()
