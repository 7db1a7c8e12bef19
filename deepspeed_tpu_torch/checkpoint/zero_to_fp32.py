"""Offline fp32 consolidation (counterpart of
`deepspeed_tpu/checkpoint/zero_to_fp32.py`).

Reference: `deepspeed/utils/zero_to_fp32.py` — a standalone script that
DeepSpeed copies into every checkpoint directory so a user can reassemble
the full fp32 state dict without an engine or a distributed launch. The
saver (`checkpoint/saver.py`) copies this file next to `latest`, so it
imports numpy and torch only, never this package:

    python zero_to_fp32.py <checkpoint_dir> <output.npz> [--tag TAG]
    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <dir> <out.npz>

It reads the tag dirs of both engines of the port: the numpy engine's
`state/state.npz` + `keys.json` (also what the JAX package's numpy engine
writes) and the torch engine's `state/state.pt` (a flat `{key: tensor}`
dict, loaded with `weights_only=True` onto the CPU). Consolidation picks
the fp32 master tree (the params where training kept no master), casts
to fp32 and emits one flat ``{dot.path: np.ndarray}`` dict. An Orbax
state dir (the JAX package's default engine) raises, naming the engine.
"""

import argparse
import json
import os
import pathlib

import numpy as np

LATEST_FILE = "latest"
MANIFEST_FILE = "manifest.json"


def _read_latest(ckpt_root):
    latest = pathlib.Path(ckpt_root) / LATEST_FILE
    if latest.exists():
        return latest.read_text().strip()
    return None


def _flatten(tree, prefix=()):
    """Nested dict -> {dot.path: leaf} with stable, human-readable keys."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
    elif tree is None:
        pass
    else:
        out[".".join(prefix)] = tree
    return out


def _nest(names, values):
    """Rebuild the nested state from slash-separated key paths."""
    nested = {}
    for name, value in zip(names, values):
        parts = name.split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = value
    return nested


def _to_numpy(value):
    """A loaded leaf as numpy; 16-bit floats numpy cannot hold (bfloat16)
    widen to fp32 exactly."""
    import torch
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(value)


def _restore_state_tree(state_path):
    """Load a saved state directory as host numpy trees. Returns (tree,
    format): "npz-named" / "torch-named" (nested by key path) or "npz"
    (a positional npz without keys.json: flat arr_i)."""
    npz = os.path.join(state_path, "state.npz")
    keys_file = os.path.join(state_path, "keys.json")
    names = None
    if os.path.exists(keys_file):
        with open(keys_file) as f:
            names = json.load(f)
    if os.path.exists(npz):
        with np.load(npz) as data:
            if names is None:
                return {k: data[k] for k in data.files}, "npz"
            return _nest(names, [data[f"arr_{i}"]
                                 for i in range(len(names))]), "npz-named"
    pt = os.path.join(state_path, "state.pt")
    if os.path.exists(pt):
        import torch
        flat = torch.load(pt, map_location="cpu", weights_only=True)
        names = names if names is not None else list(flat)
        return _nest(names, [_to_numpy(flat[n]) for n in names]), \
            "torch-named"
    engine = None
    try:
        with open(os.path.join(os.path.dirname(os.path.normpath(state_path)),
                               MANIFEST_FILE)) as f:
            engine = json.load(f).get("engine")
    except (OSError, ValueError):
        pass
    raise ValueError(
        f"{state_path} holds neither state.npz nor state.pt (checkpoint "
        f"engine: {engine or 'unknown, e.g. orbax'}): only the numpy and "
        f"torch checkpoint engines' layouts can be consolidated here")


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """Full fp32 params as {dot.path: np.ndarray} (reference
    `get_fp32_state_dict_from_zero_checkpoint`)."""
    tag = tag or _read_latest(checkpoint_dir)
    if tag is None:
        raise FileNotFoundError(f"no '{LATEST_FILE}' file in "
                                f"{checkpoint_dir}; pass --tag")
    state_path = os.path.join(checkpoint_dir, str(tag), "state")
    if not os.path.isdir(state_path):
        raise FileNotFoundError(f"no state dir at {state_path}")
    restored, fmt = _restore_state_tree(state_path)
    if fmt == "npz":
        # positional npz: the param/master split is not recoverable
        # without the engine's tree — return the raw leaves
        return {k: np.asarray(v, np.float32) for k, v in restored.items()}
    source = restored.get("master")
    if source is None:
        source = restored.get("params")
    if source is None:
        raise ValueError("checkpoint has neither 'master' nor 'params' trees")
    return {k: np.asarray(v, np.float32)
            for k, v in _flatten(source).items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file,
                                               tag=None):
    """Write the consolidated fp32 dict to one .npz."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=tag)
    out = pathlib.Path(output_file)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **sd)
    meta = {"num_params": len(sd),
            "total_elems": int(sum(int(np.prod(v.shape))
                                   for v in sd.values()))}
    print(json.dumps(meta))
    return output_file


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch checkpoint into one "
                    "fp32 npz")
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_file")
    parser.add_argument("--tag", default=None)
    args = parser.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir,
                                               args.output_file, tag=args.tag)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
