"""A pool of gloo ranks on the CPU for multi-rank tests (the counterpart of
the JAX package's virtual multi-device mesh).

`RankPool(world)` spawns `world` processes with the `spawn` start method
(the test process may have JAX loaded: a forked child would inherit it),
joins them in a gloo process group through a `FileStore` in a directory of
the caller's (no fixed port: parallel test runs cannot collide), and then
runs tasks: `pool.run("module:function", *args)` calls the function on
every rank with the same arguments and returns the ranks' results in rank
order; `pool.submit(...)` starts it and returns a function that waits for
them, so the caller can work meanwhile. A task that raises on any rank raises here with that rank's
traceback; a rank that hangs in a collective is bounded by the group's
timeout. The worker side imports torch and this package only.

The task bodies of the port's comm and ZeRO tests live here too: each takes
numpy inputs and returns numpy results, so the test process holds both
packages' outcomes side by side.
"""

import datetime
import functools
import importlib
import os
import queue
import traceback

import numpy as np
import torch

TIMEOUT_S = 120


def _resolve(target):
    mod, _, fn = target.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _worker(rank, world, store_path, tasks, results, threads):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            task, target, args, kwargs = item
            try:
                results.put((task, rank, True,
                             _resolve(target)(*args, **kwargs)))
            except Exception:
                results.put((task, rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` gloo ranks running tasks in lockstep (see the module
    docstring). Close it (or use it as a context manager) to stop them."""

    def __init__(self, world, workdir, threads=1):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world = world
        store = os.path.join(str(workdir), "rank_pool_store")
        if os.path.exists(store):
            os.remove(store)
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._next, self._done = 0, {}
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, world, store, self._tasks[r],
                                         self._results, threads))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def submit(self, target, *args, **kwargs):
        """Start a task on every rank and return at once: `result()` of the
        returned function waits for the ranks' results. The ranks run the
        tasks in the order they were submitted."""
        self._next += 1
        task = self._next
        for q in self._tasks:
            q.put((task, target, args, kwargs))
        return functools.partial(self._result, task, target)

    def run(self, target, *args, timeout=TIMEOUT_S + 60, **kwargs):
        return self.submit(target, *args, **kwargs)(timeout=timeout)

    def _result(self, task, target, timeout=TIMEOUT_S + 60):
        while len(self._done.get(task, ())) < self.world:
            try:
                t, rank, ok, value = self._results.get(timeout=timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"{target}: no result within {timeout} s "
                                   f"(a rank hung; the pool was stopped)")
            self._done.setdefault(t, {})[rank] = (ok, value)
        got = self._done.pop(task)
        errors = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items())
                  if not ok]
        if errors:
            raise RuntimeError(f"{target} failed:\n" + "\n".join(errors))
        return [got[r][1] for r in range(self.world)]

    def close(self):
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                try:
                    q.put(None)
                except Exception:
                    pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _rank():
    import torch.distributed as dist
    return dist.get_rank()


# ----------------------------------------------------------------------
# comm tasks
# ----------------------------------------------------------------------


def comm_facade_ops(per_rank):
    """Every facade op on this rank's numpy inputs (`per_rank[rank]`, a dict
    of arrays): {op: result}, the stats after each op and the launches."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import collectives as coll
    comm.init_distributed(device="cpu")
    x = {k: torch.from_numpy(np.array(v)) for k, v in per_rank[_rank()].items()}
    coll.stats.reset()
    coll.LAUNCHES.clear()
    out, snaps = {}, {}

    def step(name, fn):
        coll.stats.reset()
        out[name] = fn()
        snaps[name] = coll.stats.snapshot()

    R = comm.ReduceOp
    step("all_reduce_sum", lambda: comm.all_reduce(x["a"]))
    step("all_reduce_avg", lambda: comm.all_reduce(x["a"], op=R.AVG))
    step("all_reduce_max", lambda: comm.all_reduce(x["a"], op=R.MAX))
    step("all_reduce_min", lambda: comm.all_reduce(x["a"], op=R.MIN))
    step("all_gather_tiled", lambda: comm.all_gather(x["a"]))
    step("all_gather_stacked", lambda: comm.all_gather(x["a"], tiled=False))
    step("reduce_scatter", lambda: comm.reduce_scatter(x["a"]))
    step("reduce_scatter_avg", lambda: comm.reduce_scatter(x["a"],
                                                           op=R.AVG))
    step("all_to_all", lambda: comm.all_to_all(x["a"]))
    step("broadcast", lambda: comm.broadcast(x["a"], src=0))
    step("scatter", lambda: comm.scatter(x["a"], src=0))
    step("all_reduce_coalesced",
         lambda: comm.all_reduce_coalesced([x["a"], x["b"]]))
    step("all_gather_coalesced",
         lambda: comm.all_gather_coalesced([x["a"], x["b"]]))
    step("all_to_all_single_uneven",
         lambda: comm.all_to_all_single(input=x["u"],
                                        input_split_sizes=[1, 3]))
    step("run_all_reduce", lambda: coll.run("all_reduce", x["a"]))
    step("p2p_shift", lambda: comm.p2p_shift(x["a"], "data"))
    # the primitives (jax.lax's signatures)
    step("psum", lambda: coll.psum(x["a"], "data", repeats=3))
    step("pmean", lambda: coll.pmean(x["a"], "data"))
    step("lax_all_gather", lambda: coll.all_gather(x["a"], "data", axis=1,
                                                   tiled=True))
    step("lax_reduce_scatter", lambda: coll.reduce_scatter(
        x["a"], "data", scatter_dimension=1))
    step("lax_all_to_all", lambda: coll.all_to_all(
        x["a"], "data", split_axis=1, concat_axis=0, tiled=True))
    step("lax_all_to_all_stacked", lambda: coll.all_to_all(
        x["s"], "data", split_axis=0, concat_axis=1))
    step("ppermute", lambda: coll.ppermute(x["a"], "data", [(0, 1)]))
    # the wires
    flat = x["w"].reshape(-1)
    step("rs_none", lambda: coll.transform_reduce_scatter(flat, "data",
                                                          "none"))
    step("rs_int8", lambda: coll.transform_reduce_scatter(flat, "data",
                                                          "int8"))
    step("ag_int8", lambda: coll.transform_all_gather(x["w"][0], "data",
                                                      "int8"))
    step("car_none", lambda: coll.compressed_all_reduce(x["o"], "data",
                                                        "none"))
    step("car_int8", lambda: coll.compressed_all_reduce(x["o"], "data",
                                                        "int8"))
    step("car_onebit", lambda: coll.compressed_all_reduce(
        x["o"], "data", "onebit", err=torch.zeros_like(x["o"])))
    step("a2a_int8", lambda: coll.transform_all_to_all(
        x["w"], "data", split_axis=0, concat_axis=0, transform="int8"))
    launches = dict(coll.LAUNCHES)
    refusals = {}
    for name in ("send", "recv", "isend", "irecv"):
        try:
            getattr(comm, name)(x["a"], 0)
        except NotImplementedError as e:
            refusals[name] = str(e)
    try:
        comm.init_distributed(device="cuda")
    except ValueError as e:
        refusals["backend"] = str(e)
    from deepspeed_tpu_torch.utils import groups
    info = {"world": comm.get_world_size(), "rank": comm.get_rank(),
            "dp_world": groups._get_data_parallel_world_size(),
            "dp_rank": groups._get_data_parallel_rank(),
            "tp_world": groups._get_model_parallel_world_size(),
            "global_rank_data_1": comm.get_global_rank(("data",), 1),
            "spec": comm.get_spec().axis_sizes()}
    return {"out": _np(out), "stats": snaps, "launches": launches,
            "refusals": refusals, "info": info}


# ----------------------------------------------------------------------
# ZeRO tasks
# ----------------------------------------------------------------------


def _gpt_engine(config, params_np, cfg_kwargs):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import gpt as tgpt
    cfg = tgpt.GPTConfig(**cfg_kwargs)
    engine, *_ = initialize(
        model=tgpt.make_gpt_model(cfg, name="tiny",
                                  params=tgpt.params_from_jax(params_np)),
        config=config, device="cpu")
    return engine


def _leaf_plan(engine):
    """Each param leaf's shape, itemsize and shard dims (param, state,
    grad), in leaf order."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    full = engine._full_state().params
    return [{"shape": tuple(t.shape), "itemsize": t.element_size(),
             "pdim": pd, "sdim": sd, "gdim": gd}
            for t, pd, sd, gd in zip(tree_leaves(full), engine._pdims,
                                     engine._sdims, engine._gdims)]


def zero_train(config, params_np, cfg_kwargs, batches, save_dir=None,
               save_after=None, load_dir=None):
    """Train the port's GPT on this rank's rows of each global batch:
    losses, each step's CommStats, the whole (gathered) state at the end,
    the step metrics, the leaf plan and the memscope plan. `save_dir` /
    `save_after`: save a checkpoint after that many steps; `load_dir`:
    resume from it first."""
    from deepspeed_tpu_torch.comm import collectives as coll
    from deepspeed_tpu_torch.telemetry.memscope import \
        plan_training_from_engine
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    engine = _gpt_engine(config, params_np, cfg_kwargs)
    if load_dir is not None:
        engine.load_checkpoint(load_dir)
    losses, stats, metrics = [], [], []
    coll.LAUNCHES.clear()
    for i, b in enumerate(batches):
        coll.stats.reset()
        losses.append(float(engine.train_batch(b)))
        stats.append(coll.stats.snapshot())
        m = engine._last_metrics
        metrics.append({k: float(m[k]) for k in ("grad_norm", "loss_scale")}
                       | {"overflow": bool(m["overflow"])})
        if save_dir is not None and i + 1 == save_after:
            engine.save_checkpoint(save_dir, tag="mid")
    launches = dict(coll.LAUNCHES)
    plan = plan_training_from_engine(engine)
    return {"losses": losses, "stats": stats, "metrics": metrics,
            "launches": launches, "state": engine.state_to_numpy(),
            "plan": {"device": dict(plan.device_bytes),
                     "host": dict(plan.host_bytes)},
            "leaves": _leaf_plan(engine),
            "shard_shapes": [tuple(t.shape) for t in
                             tree_leaves(engine.state.params)],
            "master_shapes": [tuple(t.shape) for t in
                              tree_leaves(engine.state.master)]
            if engine.state.master is not None else None,
            "dp": (engine.dp_world_size, engine.dp_rank)}


def zero_save_fault(config, params_np, cfg_kwargs, batch, save_dir):
    """One step, then two saves under one tag: the first with rank 0's
    commit failing (a fault injected before its rename), the second
    clean. For each save: the error this rank raised (None), the rollback
    target it holds after, and the element count of every all-gather the
    save issued."""
    from deepspeed_tpu_torch.checkpoint import saver
    from deepspeed_tpu_torch.comm import collectives as coll
    engine = _gpt_engine(config, params_np, cfg_kwargs)
    engine.train_batch(batch)
    gathers, all_gather = [], coll.all_gather

    def counted(x, *args, **kwargs):
        gathers.append(x.numel())
        return all_gather(x, *args, **kwargs)

    def disk_full(**_):
        raise OSError("no space left on device (injected)")

    out = []
    coll.all_gather = counted
    try:
        for fault in (True, False):
            if fault and _rank() == 0:
                saver._FAULT_HOOKS["before_commit"] = disk_full
            gathers.clear()
            error = None
            try:
                engine.save_checkpoint(save_dir, tag="t")
            except Exception as e:
                error = f"{type(e).__name__}: {e}"
            finally:
                saver._FAULT_HOOKS.pop("before_commit", None)
            out.append({"error": error,
                        "last_ckpt_dir": engine._last_ckpt_dir,
                        "gathers": list(gathers)})
    finally:
        coll.all_gather = all_gather
    return out


def zero_branches(config, per_rank_scale, steps, nan_rank=None):
    """A linear model whose loss reads a float batch leaf: rank r's rows
    are scaled by `per_rank_scale[r]` (a large or an infinite gradient on
    one rank only; `nan_rank`'s rows NaN). Returns each step's metrics and
    params, or the step and the error where the engine raised."""
    from deepspeed_tpu_torch.runtime.engine import ModelSpec, initialize
    from deepspeed_tpu_torch.utils.tree import tree_leaves
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(0, 0.5, (8, 4))
                                    .astype(np.float32)),
              "b": torch.zeros(4)}

    def loss_fn(p, batch):
        x = batch["x"].to(p["w"].dtype)
        return ((x @ p["w"] + p["b"]).float() ** 2).mean()

    engine, *_ = initialize(model=ModelSpec(loss_fn=loss_fn, params=params),
                            config=config, device="cpu")
    mb, gas = engine.micro_batch_size, engine.gradient_accumulation_steps()
    n = engine.dp_world_size
    out = []
    for step in range(steps):
        x = rng.normal(0, 1, (gas, mb * n, 8)).astype(np.float32)
        for r in range(n):
            x[:, r * mb:(r + 1) * mb] *= per_rank_scale[r]
            if r == nan_rank:
                x[:, r * mb:(r + 1) * mb] = np.nan
        try:
            loss = float(engine.train_batch({"x": x.reshape(-1, 8)}))
        except Exception as e:
            out.append({"step": step, "error": type(e).__name__,
                        "message": str(e)[:300]})
            break
        m = engine._last_metrics
        st = engine.state_to_numpy()
        out.append({"step": step, "loss": loss,
                    "grad_norm": float(m["grad_norm"]),
                    "overflow": bool(m["overflow"]),
                    "loss_scale": float(m["loss_scale"]),
                    "params": [np.asarray(t) for t in
                               tree_leaves(st["params"])],
                    "global_steps": engine.global_steps,
                    "skipped": engine.skipped_steps})
    return out
