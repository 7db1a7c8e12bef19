"""Checkpoint save/load with the reference's directory semantics, made
crash-safe (counterpart of `deepspeed_tpu/checkpoint/saver.py`).

Layout (the JAX package's, file for file):
    <save_dir>/<tag>/state/         — state.pt (torch engine) or
                                      state.npz (numpy engine) + keys.json
    <save_dir>/<tag>/client.json    — client_state (step counts, scheduler)
    <save_dir>/<tag>/manifest.json  — integrity manifest (commit marker)
    <save_dir>/latest               — text file with the most recent tag
    <save_dir>/zero_to_fp32.py      — the standalone consolidation script

Commit protocol (checkpoint/manifest.py holds the primitives), the JAX
package's order: state into a `<tag>.tmp` staging dir -> `client.json` ->
`manifest.json` (per-leaf shapes/dtypes, per-file crc32, step, world) ->
rename-commit to `<tag>` -> `latest` (tempfile + rename) -> retention.
A kill at any point leaves either a committed tag or an orphaned `.tmp`
dir (GC'd by the next save / the doctor); `load_checkpoint` verifies the
manifest and walks back through the retained tags to the newest good one.

Engines (`checkpoint.engine`):

  * "torch" (the default): `torch.save` of one flat `{key: tensor}` dict,
    16-bit leaves in their own dtype; loaded with `weights_only=True`,
    mapped into host memory, and copied leaf by leaf into the engine's
    own tensors (so a load adds no second copy of the state on the card).
  * "numpy": the JAX package's numpy layout — `state.npz` with positional
    `arr_i` leaves, bf16 widened to fp32 (exact) and narrowed back to the
    template's dtype on load. It reads by the names in `keys.json`.
  * `async_save: true` wraps either in `AsyncCheckpointEngine`: the host
    snapshot is taken at once, the write and the commit run on a thread,
    and an error surfaces on the next `wait` or save.
  * "orbax" raises: the port writes no Orbax format.

Leaf names on disk follow the JAX package's layout: `params/...`,
`master/...`, optax's `opt_state/<chain index>/<field>/...` (see
`optax_opt_leaves`), `scaler/...`, `step`. A JAX checkpoint's `rng` leaf
has no counterpart in the port (dropout is never applied; the port draws
from `torch.Generator`s) and is dropped on load.

The training engines provide `checkpoint_leaves()` (the [(name, leaf)]
to save), `restore_checkpoint_leaves(named, prefixes)` and
`checkpoint_device`; the saver owns everything else.
"""

import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint import manifest as manifest_mod
from deepspeed_tpu_torch.checkpoint.manifest import (CheckpointCorruptionError,
                                                     LATEST_FILE, TMP_SUFFIX)
from deepspeed_tpu_torch.utils.logging import log_dist, logger

# Fault-injection points (deepspeed_tpu_torch/testing/faults.py installs
# hooks here to simulate kills at precise moments of the commit protocol):
#   after_state_save — state durable in the staging dir, metadata not yet
#   before_commit    — manifest written, rename-commit not yet executed
#   after_commit     — tag committed, `latest` not yet advanced
_FAULT_HOOKS = {}

ENGINES = ("torch", "numpy")


def _fire_fault_hook(point, **ctx):
    hook = _FAULT_HOOKS.get(point)
    if hook is not None:
        hook(point=point, **ctx)


# ----------------------------------------------------------------------
# named leaves
# ----------------------------------------------------------------------


def named_leaves(tree, prefix=()):
    """[(key path, leaf)] in the JAX pytree order (dict keys sorted,
    sequences by index, NamedTuple fields by name, None skipped); the key
    path is "params/blocks/attn_qkv_w"-style, as the JAX saver names it."""
    out = []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            out += named_leaves(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out += named_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += named_leaves(v, prefix + (str(i),))
    elif tree is not None:
        out.append(("/".join(prefix), tree))
    return out


def unflatten_named(template, named, prefix=()):
    """`template`'s structure with each leaf taken from `named` by its key
    path (the inverse of `named_leaves`)."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(unflatten_named(getattr(template, n), named,
                                                prefix + (n,))
                                for n in template._fields))
    if isinstance(template, dict):
        return {k: unflatten_named(v, named, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_named(v, named, prefix + (str(i),))
                              for i, v in enumerate(template))
    if template is None:
        return None
    key = "/".join(prefix)
    if key not in named:
        raise KeyError(f"checkpoint has no leaf '{key}'")
    return named[key]


def _dtype_name(leaf):
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return type(leaf).__name__
    return str(dt).replace("torch.", "")


def tree_entries(leaves):
    """Per-leaf {key, shape, dtype} manifest entries (metadata only)."""
    return [{"key": name,
             "shape": [int(d) for d in getattr(leaf, "shape", ()) or ()],
             "dtype": _dtype_name(leaf)} for name, leaf in leaves]


# optax's chain for each optimizer of the JAX package (its ops/optim.py):
# whether the first transform keeps a step count, and the chain index of
# the learning-rate transform, which keeps a count of its own under a
# schedule. The port keeps one `count` for both (they always agree).
_OPTAX_CHAIN = {"adam": (True, 1), "adamw": (True, 2), "lion": (True, 2),
                "lamb": (True, 3), "sgd": (False, 1), "adagrad": (False, 1)}


def optax_opt_leaves(opt_leaves, optimizer, has_schedule):
    """The port's optimizer state [(name under opt_state/, leaf)] named as
    the JAX package's optax tree: `count` -> `opt_state/0/count` (where
    optax's first transform counts) and `opt_state/<lr index>/count` (under
    a schedule); `mu/...` -> `opt_state/0/mu/...`."""
    inner_count, lr_index = _OPTAX_CHAIN[optimizer]
    out, count = [], None
    for name, leaf in opt_leaves:
        if name == "count":
            count = leaf
            if inner_count:
                out.append(("opt_state/0/count", leaf))
        else:
            out.append((f"opt_state/0/{name}", leaf))
    if has_schedule and count is not None:
        out.append((f"opt_state/{lr_index}/count", count))
    return out


def optax_count(named):
    """The optimizer's step count in a checkpoint of optax names: any
    `opt_state/<i>/count`, else None (optax's constant-rate SGD and
    Adagrad keep no count: the caller falls back to the step)."""
    for key in sorted(named):
        parts = key.split("/")
        if len(parts) == 3 and parts[0] == "opt_state" and \
                parts[2] == "count":
            return named[key]
    return None


# ----------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------


class CheckpointEngine:
    """Pluggable engine ABC (reference `checkpoint_engine.py:9`): `save`
    writes [(name, leaf)] into a state dir, `load` returns {name: leaf}."""

    def save(self, leaves, path):
        raise NotImplementedError

    def load(self, path, template):
        raise NotImplementedError

    def commit(self, tag):
        return True


def _write_keys(leaves, path):
    with open(os.path.join(path, "keys.json"), "w") as f:
        json.dump([name for name, _ in leaves], f, indent=1)


def _read_keys(path):
    keys_file = os.path.join(path, "keys.json")
    if not os.path.exists(keys_file):
        return None
    with open(keys_file) as f:
        return json.load(f)


class NumpyCheckpointEngine(CheckpointEngine):
    """The JAX package's numpy layout: positional `arr_i` leaves in
    `state.npz` plus `keys.json`. bf16 leaves are written as fp32 (numpy
    has no bf16); the restore casts back to the template's dtype. Loads
    read by name (positionally only for a npz without keys.json)."""

    def save(self, leaves, path):
        arrays = {}
        for i, (_, x) in enumerate(leaves):
            if isinstance(x, torch.Tensor):
                t = x.detach().cpu()
                x = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
            arrays[f"arr_{i}"] = np.asarray(x)
        pathlib.Path(path).mkdir(parents=True, exist_ok=True)
        np.savez(os.path.join(path, "state.npz"), **arrays)
        _write_keys(leaves, path)

    def load(self, path, template):
        names = _read_keys(path)
        with np.load(os.path.join(path, "state.npz")) as data:
            if names is None:
                names = [name for name, _ in template]
            return {name: data[f"arr_{i}"] for i, name in enumerate(names)}


def _owned(t):
    """The tensor itself where it owns its whole storage, else a compact
    copy: `torch.save` writes a view's entire storage."""
    t = t.detach()
    if t.is_contiguous() and t.storage_offset() == 0 and \
            t.untyped_storage().nbytes() == t.nbytes:
        return t
    return t.clone()


class TorchCheckpointEngine(CheckpointEngine):
    """The port's native engine: `torch.save` of a flat {key: tensor} dict
    in the leaves' own dtypes (bf16 stays bf16) plus the same `keys.json`;
    loads with `weights_only=True` into host memory."""

    def save(self, leaves, path):
        pathlib.Path(path).mkdir(parents=True, exist_ok=True)
        flat = {name: _owned(x) if isinstance(x, torch.Tensor) else x
                for name, x in leaves}
        torch.save(flat, os.path.join(path, "state.pt"))
        _write_keys(leaves, path)

    def load(self, path, template):
        # mapped from the file into host memory: the engine copies each
        # leaf into its own tensor, so a load never holds a second copy of
        # the state on the card (nor the host tiers' state there at all)
        return torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                          mmap=True, weights_only=True)


def host_snapshot(leaves):
    """[(name, leaf)] with every tensor copied to host memory: the engine
    steps its tensors in place, so a write that runs later must not read
    them."""
    return [(name, x.detach().to("cpu", copy=True)
             if isinstance(x, torch.Tensor) else x) for name, x in leaves]


class AsyncCheckpointEngine(CheckpointEngine):
    """Async tiered save (reference `NebulaCheckpointEngine`): the host
    snapshot is taken synchronously (so training can step its tensors in
    place at once); serialization and the completions (manifest, commit,
    `latest`) run on a worker thread. An error surfaces on the next
    `wait()`, `commit()` or save."""

    def __init__(self, inner: CheckpointEngine):
        self.inner = inner
        self._thread = None
        self._error = None
        self._completions = []

    def add_completion(self, fn):
        """Run `fn()` in the worker after the pending save persists."""
        self._completions.append(fn)

    def save(self, leaves, path):
        snapshot = host_snapshot(leaves)
        self.wait()
        completions, self._completions = self._completions, []

        def worker():
            try:
                self.inner.save(snapshot, path)
                for fn in completions:
                    fn()
            except Exception as e:   # surfaced on commit/wait
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def load(self, path, template):
        self.wait()
        return self.inner.load(path, template)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def commit(self, tag):
        self.wait()
        return True


def _make_engine(config):
    ckpt = getattr(config, "checkpoint", None)
    name = str(getattr(ckpt, "engine", "torch"))
    async_save = bool(getattr(ckpt, "async_save", False))
    if name == "numpy":
        eng = NumpyCheckpointEngine()
    elif name == "torch":
        eng = TorchCheckpointEngine()
    elif name == "orbax":
        raise NotImplementedError(
            "checkpoint.engine 'orbax' is not available in "
            "deepspeed_tpu_torch: it writes no Orbax format — use 'torch' "
            "(the default) or 'numpy' (the JAX package's numpy layout)")
    else:
        raise ValueError(f"unknown checkpoint.engine {name!r} (expected "
                         f"one of {ENGINES})")
    if async_save:
        eng = AsyncCheckpointEngine(eng)
    return eng


def _engine_for(engine):
    """One checkpoint engine per training engine, so async saves overlap
    training and cross-call wait() semantics hold."""
    ck = getattr(engine, "_ckpt_engine", None)
    if ck is None:
        ck = _make_engine(engine.config)
        engine._ckpt_engine = ck
    return ck


def _register_exit_drain(engine):
    """A clean interpreter exit must not abandon an in-flight async save:
    drain it at atexit. A failed final save only logs — `latest` still
    names the previous committed tag by construction."""
    if getattr(engine, "_ckpt_exit_drain", None) is not None:
        return
    import atexit
    import weakref
    ref = weakref.ref(engine)

    def _drain():
        e = ref()
        if e is None:
            return
        try:
            wait_pending_save(e)
        except Exception as ex:
            logger.warning(f"final async checkpoint save failed at exit "
                           f"({ex!r}); `latest` still names the previous "
                           "committed tag")

    atexit.register(_drain)
    engine._ckpt_exit_drain = _drain


def get_latest_tag(load_dir):
    """The newest resumable tag: `latest` when it names a committed tag,
    else a scan of tag dirs (newest committed manifest wins)."""
    return manifest_mod.resolve_latest_tag(load_dir)


def wait_pending_save(engine):
    """Block until any in-flight async save is durable AND finalized
    (manifest written, tag committed, `latest` advanced). Re-raises a
    failed save's error."""
    ck = getattr(engine, "_ckpt_engine", None)
    if isinstance(ck, AsyncCheckpointEngine):
        ck.wait()


def _world_info(engine):
    return {"process_count": 1, "device_count": 1,
            "device": str(getattr(engine, "checkpoint_device", "cpu"))}


def _emit_ckpt_events(engine, events):
    # the telemetry registry first (save latency becomes a
    # `Checkpoint/save_ms` histogram), then the monitors
    telem = getattr(engine, "telemetry", None)
    if telem is not None:
        try:
            telem.record_events(events)
        except Exception as e:
            logger.warning(f"checkpoint telemetry events not recorded: {e}")
    mon = getattr(engine, "monitor", None)
    try:
        from deepspeed_tpu_torch.monitor.monitor import write_recovery_events
        write_recovery_events(mon, events)
    except Exception as e:
        logger.warning(f"checkpoint monitor events not written: {e}")


def _framework_version():
    return f"deepspeed_tpu_torch (torch {torch.__version__})"


def save_checkpoint(engine, save_dir, tag=None, client_state=None,
                    save_latest=True):
    tag = tag if tag is not None else f"global_step{engine.global_steps}"
    tag = str(tag)
    save_dir = pathlib.Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    wait_pending_save(engine)

    removed = manifest_mod.gc_orphaned_tmp(save_dir, keep=None)
    if removed:
        logger.warning(f"checkpoint GC: removed orphaned staging dirs "
                       f"{removed} (crashed saves)")
    stage_dir = save_dir / (tag + TMP_SUFFIX)
    final_dir = save_dir / tag
    stage_dir.mkdir(parents=True, exist_ok=True)

    ck_engine = _engine_for(engine)
    state_path = stage_dir / "state"
    leaves = engine.checkpoint_leaves()
    entries = tree_entries(leaves)
    world = _world_info(engine)
    step = int(engine.global_steps)
    engine_name = type(getattr(ck_engine, "inner", ck_engine)).__name__
    client = dict(client_state or {})
    t0 = time.monotonic()
    ckpt_cfg = getattr(engine.config, "checkpoint", None)
    keep_last_n = int(getattr(ckpt_cfg, "keep_last_n", 0) or 0)

    def finalize():
        """Runs once the state is durable in the staging dir. Order
        matters: metadata -> manifest -> rename-commit -> latest ->
        retention."""
        _fire_fault_hook("after_state_save", tag=tag,
                         stage_dir=str(stage_dir))
        with open(stage_dir / "client.json", "w") as f:
            json.dump(client, f, indent=2, default=str)
        m = manifest_mod.write_manifest(
            stage_dir, tag=tag, step=step, tree=entries, world=world,
            engine=engine_name,
            extra={"framework_version": _framework_version()})
        total_bytes = m["total_bytes"]
        _fire_fault_hook("before_commit", tag=tag, stage_dir=str(stage_dir))
        aside = None
        if final_dir.exists():
            # re-save under an existing tag: rename the committed copy
            # aside (atomic) — a kill between the two renames leaves the
            # old copy recoverable as a .tmp orphan
            aside = save_dir / (tag + ".old" + TMP_SUFFIX)
            if aside.exists():
                shutil.rmtree(aside)
            os.replace(final_dir, aside)
        os.replace(stage_dir, final_dir)       # COMMIT point
        manifest_mod.fsync_dir(save_dir)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        _fire_fault_hook("after_commit", tag=tag, ckpt_dir=str(final_dir))
        # ship the consolidation script next to `latest` (reference
        # engine.py:3366) so `python zero_to_fp32.py . out` works in place
        try:
            from deepspeed_tpu_torch.checkpoint import zero_to_fp32 as _z2f
            shutil.copyfile(_z2f.__file__, save_dir / "zero_to_fp32.py")
        except Exception as e:
            logger.warning(f"could not ship zero_to_fp32.py: {e}")
        if save_latest:
            # ordering contract: `latest` only advances after the commit
            manifest_mod.atomic_write_text(save_dir / LATEST_FILE, tag)
        if keep_last_n > 0:
            latest_tag = tag if save_latest else get_latest_tag(save_dir)
            dropped = manifest_mod.retention_gc(
                save_dir, keep_last_n, protect=(tag, latest_tag))
            if dropped:
                log_dist(f"checkpoint retention (keep_last_n="
                         f"{keep_last_n}): removed {dropped}", ranks=[0])
        engine._last_ckpt_dir = str(save_dir)
        save_ms = (time.monotonic() - t0) * 1000.0
        _emit_ckpt_events(engine, [
            ("Checkpoint/save_ms", save_ms, step),
            ("Checkpoint/bytes", float(total_bytes), step),
            ("Checkpoint/last_good_step", float(step), step),
        ])
        log_dist(f"saved checkpoint {tag} to {final_dir} "
                 f"({total_bytes / 2**20:.1f} MiB, {save_ms:.0f} ms)",
                 ranks=[0])

    if isinstance(ck_engine, AsyncCheckpointEngine):
        # finalization (incl. commit + `latest`) runs on the worker after
        # persist; save() returns once the host snapshot is taken
        _register_exit_drain(engine)
        ck_engine.add_completion(finalize)
        ck_engine.save(leaves, str(state_path))
    else:
        ck_engine.save(leaves, str(state_path))
        ck_engine.commit(tag)
        finalize()
    return str(final_dir)


def _load_prefixes(template, load_optimizer_states, load_module_only):
    """Which manifest-tree key prefixes must match the restore template: a
    partial load consumes a subset of the state. A full load compares
    every top-level entry of the template, so a saved leaf the port has
    no counterpart for (the JAX package's `rng`) does not fail it."""
    if load_module_only:
        return ("params", "master")
    if not load_optimizer_states:
        return ("params", "master", "step", "scaler")
    return tuple(sorted({e["key"].split("/")[0] for e in template}))


def _candidate_tags(load_dir, tag):
    """Requested (or latest) tag first, then every other committed tag
    newest first — the rollback-on-corruption walk order."""
    cands = []
    if tag is not None:
        cands.append(str(tag))
    else:
        lt = get_latest_tag(load_dir)
        if lt is not None:
            cands.append(lt)
    for t, _step in manifest_mod.committed_tags(load_dir):
        if t not in cands:
            cands.append(t)
    return cands


def load_checkpoint(engine, load_dir, tag=None, load_optimizer_states=True,
                    load_module_only=False):
    wait_pending_save(engine)
    load_dir = pathlib.Path(load_dir)
    candidates = _candidate_tags(load_dir, tag)
    if not candidates:
        logger.warning(f"no checkpoint found in {load_dir} (no "
                       f"'{LATEST_FILE}' file and no committed tag dirs)")
        return None, None

    ck_engine = _engine_for(engine)
    ckpt_cfg = getattr(engine.config, "checkpoint", None)
    deep = bool(getattr(ckpt_cfg, "verify_checksums", True))
    template = engine.checkpoint_leaves()
    template_tree = tree_entries(template)
    prefixes = _load_prefixes(template_tree, load_optimizer_states,
                              load_module_only)
    discarded = []

    for cand in candidates:
        ckpt_dir = load_dir / cand
        if not ckpt_dir.exists():
            if tag is not None and cand == str(tag):
                # an explicitly requested tag that is not there is a
                # caller error, not corruption: never substitute another
                logger.warning(f"checkpoint dir {ckpt_dir} does not exist")
                return None, None
            discarded.append((cand, ["directory does not exist"]))
            continue
        m = manifest_mod.read_manifest(ckpt_dir)
        if m is None:
            # legacy pre-manifest checkpoint: accept, but only as the
            # primary candidate (never walk back INTO an unverifiable dir)
            if cand is not candidates[0]:
                discarded.append((cand, ["no manifest (legacy layout)"]))
                continue
            logger.warning(f"checkpoint {ckpt_dir} has no manifest (legacy "
                           "layout): loading without integrity verification")
        else:
            ok, errors = manifest_mod.verify_manifest(
                ckpt_dir, template_tree=template_tree, deep=deep,
                template_prefixes=prefixes)
            if not ok:
                discarded.append((cand, errors))
                logger.warning(
                    f"checkpoint {ckpt_dir} failed integrity verification "
                    f"({len(errors)} error(s): {errors[:3]}...); walking "
                    "back to an older tag")
                continue
        try:
            named = ck_engine.load(str(ckpt_dir / "state"), template)
            engine.restore_checkpoint_leaves(named, prefixes)
        except Exception as e:
            discarded.append((cand, [f"restore failed: {e!r}"]))
            logger.warning(f"checkpoint {ckpt_dir} failed to restore "
                           f"({e!r}); walking back to an older tag")
            continue

        client_state = {}
        client_file = ckpt_dir / "client.json"
        if client_file.exists():
            with open(client_file) as f:
                client_state = json.load(f)
        if m is not None and client_state.get("global_steps") is not None \
                and int(client_state["global_steps"]) != \
                int(m.get("step", -1)):
            logger.warning(
                f"checkpoint {cand}: manifest step {m.get('step')} != "
                f"client_state global_steps {client_state['global_steps']}")
        if discarded:
            names = [c for c, _ in discarded]
            logger.warning(f"recovered from {cand} after discarding "
                           f"corrupted/unusable tag(s) {names}")
            _emit_ckpt_events(engine, [
                ("Recovery/discarded_tags", float(len(discarded)),
                 int(engine.global_steps)),
            ])
        engine._last_ckpt_dir = str(load_dir)
        log_dist(f"loaded checkpoint {cand} from {ckpt_dir}", ranks=[0])
        return str(ckpt_dir), client_state

    detail = "; ".join(f"{c}: {errs[0]}" for c, errs in discarded[:5])
    raise CheckpointCorruptionError(
        f"no loadable checkpoint in {load_dir}: every retained tag failed "
        f"validation ({detail})")
