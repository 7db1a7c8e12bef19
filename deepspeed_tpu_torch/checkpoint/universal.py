"""Universal checkpoints — topology-independent fp32 state (counterpart of
`deepspeed_tpu/checkpoint/universal.py`).

Reference: `deepspeed/checkpoint/ds_to_universal.py:254` (offline
converter: ZeRO shards -> per-param fp32 slices) + `universal_checkpoint.py:12`
(loader). The artifact is the JAX package's, name for name: one
`universal_fp32.npz` of flat `path -> fp32 array` entries (the fp32
weights, and the optimizer state under `__opt__/<optax path>`) plus
`universal_meta.json` (format_version 2, has_optimizer_state,
global_steps, step, scaler, ...). A universal checkpoint of either
package loads into the other's engine; the offline converter reads the
numpy and torch engines' tag dirs. Run it as

    python -m deepspeed_tpu_torch.checkpoint.universal \
        --input_folder <root> --output_folder <out>
"""

import json
import pathlib

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger

UNIVERSAL_FILE = "universal_fp32.npz"
META_FILE = "universal_meta.json"
OPT_PREFIX = "__opt__"
# the one-rank layout the port trains on, in the JAX package's spelling
ONE_RANK_MESH = ("MeshSpec(pipe=1, data=1, zero=1, expert=1, sequence=1, "
                 "tensor=1)")


def _flatten(tree, prefix=()):
    """Nested dicts / lists / NamedTuples -> {"a/b/c": leaf} (the JAX
    package's `_flatten`)."""
    out = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, path + (str(k),))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                rec(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + (str(i),))
        elif node is not None:
            out["/".join(path)] = node

    rec(tree, prefix)
    return out


def _fp32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _write_universal(flat, out_dir, extra_meta=None):
    """Single writer of the on-disk universal format (npz + meta json)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / UNIVERSAL_FILE, **flat)
    meta = {"format_version": 1,
            "param_shapes": {k: list(v.shape) for k, v in flat.items()}}
    meta.update(extra_meta or {})
    with open(out_dir / META_FILE, "w") as f:
        json.dump(meta, f, indent=2)
    log_dist(f"universal checkpoint -> {out_dir} ({len(flat)} tensors)",
             ranks=[0])
    return str(out_dir)


def _opt_leaves(engine):
    """The engine's optimizer state [(optax path, leaf)], the path under
    `opt_state/` of its checkpoint names."""
    pre = "opt_state/"
    return [(n[len(pre):], v) for n, v in engine.checkpoint_leaves()
            if n.startswith(pre)]


def save_universal_checkpoint(engine, save_dir, tag="universal",
                              save_optimizer_states=True):
    """The engine's fp32 weights AND optimizer state as the flat npz
    artifact (v2: the moments ride along, so a resume continues the same
    optimization trajectory)."""
    flat = {k: _fp32(v)
            for k, v in _flatten(engine.get_fp32_state_dict()).items()}
    has_opt = False
    if save_optimizer_states:
        opt = _opt_leaves(engine)
        if opt:
            flat.update({f"{OPT_PREFIX}/{k}": _fp32(v) for k, v in opt})
            has_opt = True
    sc = engine.state.scaler
    return _write_universal(flat, pathlib.Path(save_dir) / tag, {
        "format_version": 2,
        "has_optimizer_state": has_opt,
        "global_steps": engine.global_steps,
        "step": int(engine.state.step),
        "scaler": {"scale": float(sc.scale),
                   "good_steps": int(sc.good_steps),
                   "overflows": int(sc.overflows),
                   "hysteresis_left": int(sc.hysteresis_left)},
        "zero_stage": engine.zero_stage,
        "mesh": ONE_RANK_MESH,
    })


def load_universal_checkpoint(engine, load_dir, tag="universal", strict=True,
                              load_optimizer_states=True):
    """Load a universal artifact into the engine: each array is cast to its
    leaf's dtype and copied into the engine's tensor (params, the fp32
    master, and — v2 — the optimizer state). A v1 artifact without
    optimizer slices leaves the optimizer state as it is."""
    in_dir = pathlib.Path(load_dir) / tag
    with np.load(in_dir / UNIVERSAL_FILE) as data:
        flat = {k: data[k] for k in data.files}
    opt_flat = {k[len(OPT_PREFIX) + 1:]: v for k, v in flat.items()
                if k.startswith(OPT_PREFIX + "/")}
    param_flat = {k: v for k, v in flat.items()
                  if not k.startswith(OPT_PREFIX + "/")}
    named, prefixes = {}, ["params", "master"]
    for name, _ in engine.checkpoint_leaves():
        if name.startswith(("params/", "master/")):
            key = name.split("/", 1)[1]
            if key not in param_flat:
                raise KeyError(f"universal checkpoint missing param '{key}'")
            named[name] = param_flat[key]
    if load_optimizer_states and opt_flat:
        mine = {k for k, _ in _opt_leaves(engine)}
        if mine != set(opt_flat):
            missing = sorted(mine - set(opt_flat))[:5]
            extra = sorted(set(opt_flat) - mine)[:5]
            msg = ("universal optimizer state does not match this engine's "
                   f"optimizer structure (missing {missing}, unexpected "
                   f"{extra})")
            if strict:
                raise KeyError(msg + "; pass strict=False to keep the "
                               "engine's moments instead, or "
                               "load_optimizer_states=False")
            logger.warning(msg + " — optimizer state kept (strict=False)")
            opt_flat = {}
        if opt_flat:
            named.update({f"opt_state/{k}": v for k, v in opt_flat.items()})
            prefixes.append("opt_state")
    elif load_optimizer_states and not opt_flat:
        log_dist("universal checkpoint has no optimizer slices (v1 "
                 "artifact): optimizer state kept", ranks=[0])
    meta = {}
    meta_file = in_dir / META_FILE
    if meta_file.exists():
        with open(meta_file) as f:
            meta = json.load(f)
    if meta.get("step") is not None and load_optimizer_states:
        # counters ride with the optimizer state: a weights-only warm
        # start keeps the engine's step and loss scale
        named["step"] = np.asarray(meta["step"])
        prefixes.append("step")
    if meta.get("scaler") and load_optimizer_states:
        named.update({f"scaler/{k}": np.asarray(v)
                      for k, v in meta["scaler"].items()})
        prefixes.append("scaler")
    engine.restore_checkpoint_leaves(named, tuple(prefixes))
    if meta.get("global_steps") is not None and load_optimizer_states:
        engine.global_steps = int(meta["global_steps"])
    log_dist(f"loaded universal checkpoint from {in_dir} (optimizer state "
             f"{'restored' if 'opt_state' in prefixes else 'kept'})",
             ranks=[0])
    return meta


def convert_to_universal(ckpt_dir, out_dir, engine):
    """Load a tagged checkpoint into `engine`, then emit the universal
    artifact."""
    path, _ = engine.load_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    return save_universal_checkpoint(engine, out_dir)


def get_fp32_state_dict_from_universal(load_dir, tag="universal"):
    """zero_to_fp32-style accessor: plain dict of fp32 numpy arrays."""
    in_dir = pathlib.Path(load_dir) / tag
    with np.load(in_dir / UNIVERSAL_FILE) as data:
        return {k: data[k] for k in data.files}


def convert_checkpoint_to_universal(ckpt_dir, out_dir, tag=None,
                                    out_tag="universal"):
    """Fully offline converter (no engine): reads a numpy- or torch-engine
    tag dir by its `keys.json` names and writes the universal artifact,
    the JAX converter's names and meta fields."""
    import os
    from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import (
        _read_latest, _restore_state_tree)
    tag = tag or _read_latest(ckpt_dir)
    if tag is None:
        raise FileNotFoundError(f"no 'latest' file in {ckpt_dir}; pass --tag")
    restored, fmt = _restore_state_tree(os.path.join(ckpt_dir, str(tag),
                                                     "state"))
    if fmt not in ("npz-named", "torch-named"):
        raise ValueError(
            "offline universal conversion needs a named checkpoint "
            "(keys.json): a positional npz cannot be mapped back to "
            "parameter names offline — use convert_to_universal(ckpt_dir, "
            "out_dir, engine)")
    master, params = restored.get("master"), restored.get("params")
    source = master if master is not None else params
    if source is None:
        raise ValueError("checkpoint has neither 'master' nor 'params' trees")
    flat = {k: np.asarray(v, np.float32) for k, v in _flatten(source).items()}
    opt_state = restored.get("opt_state")
    has_opt = opt_state is not None and bool(_flatten(opt_state))
    if has_opt:
        flat.update({k: np.asarray(v, np.float32)
                     for k, v in _flatten(opt_state, (OPT_PREFIX,)).items()})
    extra = {"format_version": 2, "has_optimizer_state": bool(has_opt),
             "source_checkpoint": str(ckpt_dir), "tag": str(tag)}
    step = restored.get("step")
    if step is not None and np.ndim(step) == 0:
        extra["step"] = int(step)
    scaler = restored.get("scaler")
    names = ("scale", "good_steps", "overflows", "hysteresis_left")
    if isinstance(scaler, dict) and all(n in scaler for n in names):
        extra["scaler"] = {"scale": float(np.asarray(scaler["scale"])),
                           **{n: int(np.asarray(scaler[n]))
                              for n in names[1:]}}
    return _write_universal(flat, pathlib.Path(out_dir) / out_tag, extra)


def main(argv=None):
    """The `ds_to_universal` CLI."""
    import argparse
    parser = argparse.ArgumentParser(
        description="convert a deepspeed_tpu_torch checkpoint to a "
                    "universal (topology-independent) checkpoint")
    parser.add_argument("--input_folder", required=True,
                        help="checkpoint root (contains `latest` / tag dirs)")
    parser.add_argument("--output_folder", required=True,
                        help="where to write the universal artifact")
    parser.add_argument("--tag", default=None,
                        help="checkpoint tag (default: latest)")
    parser.add_argument("--out_tag", default="universal")
    args = parser.parse_args(argv)
    out = convert_checkpoint_to_universal(args.input_folder,
                                          args.output_folder, tag=args.tag,
                                          out_tag=args.out_tag)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
