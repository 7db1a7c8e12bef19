"""The legacy sequence-length curriculum (counterpart of
`deepspeed_tpu/runtime/data_pipeline/curriculum.py`).

Difficulty (the sequence length) ramps from `min_difficulty` to
`max_difficulty` by a schedule of the global step. `apply_seqlen_curriculum`
is the JAX package's: with no `bucketize` it keeps the batch's shape and
masks the labels past the difficulty (one compiled program under XLA);
with `bucketize` it cuts every sequence to the smallest bucket that holds
the difficulty. The engine, alone, cuts to the difficulty
(`bucketize=(difficulty,)`, the reference DeepSpeed's truncation): causal
attention gives the kept positions the same logits either way, so the loss
and its gradients are the masked batch's, and the cut tail costs nothing.
With random-LTD on it masks, as the JAX engine does, so that the keep
count and the kept positions are drawn over the same T.
"""

import numpy as np
import torch

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"


class CurriculumScheduler:
    """difficulty(step) by the fixed_linear / fixed_root / fixed_discrete
    schedules (the reference's `curriculum_scheduler.py`)."""

    def __init__(self, config):
        self.schedule_type = config.get("curriculum_type",
                                        config.get("schedule_type",
                                                   FIXED_LINEAR))
        self.min_difficulty = config.get("min_difficulty", 8)
        self.max_difficulty = config.get("max_difficulty", 1024)
        cfg = config.get("schedule_config", config)
        self.total_step = cfg.get("total_curriculum_step",
                                  cfg.get("total_step", 10000))
        self.difficulty_step = cfg.get("difficulty_step", 8)
        self.root_degree = cfg.get("root_degree", 2)
        self.difficulties = cfg.get("difficulty", [])
        self.max_steps = cfg.get("max_step", [])
        self.current_difficulty = self.min_difficulty

    def update_difficulty(self, global_steps):
        t = self.schedule_type
        if t == FIXED_LINEAR:
            frac = min(global_steps / max(self.total_step, 1), 1.0)
        elif t == FIXED_ROOT:
            frac = min((global_steps / max(self.total_step, 1))
                       ** (1.0 / self.root_degree), 1.0)
        elif t == FIXED_DISCRETE:
            d = self.min_difficulty
            for diff, until in zip(self.difficulties, self.max_steps):
                if global_steps >= until:
                    d = diff
            self.current_difficulty = d
            return d
        else:
            frac = 1.0
        raw = self.min_difficulty \
            + (self.max_difficulty - self.min_difficulty) * frac
        stepped = int(raw // self.difficulty_step * self.difficulty_step)
        self.current_difficulty = max(stepped, self.min_difficulty)
        return self.current_difficulty

    def get_difficulty(self, global_steps=None):
        if global_steps is not None:
            self.update_difficulty(global_steps)
        return self.current_difficulty


def apply_seqlen_curriculum(batch, difficulty, ignore_index=-1,
                            bucketize=None):
    """Mask labels past `difficulty` tokens (static shape), or with
    `bucketize` cut every sequence to the smallest bucket >= difficulty.
    Numpy out, but a cut tensor stays a tensor (on its device)."""
    out = dict(batch)
    tokens = out.get("tokens", out.get("input_ids"))
    if tokens is None:
        return out
    T = tokens.shape[1]
    if bucketize:
        difficulty = min((b for b in bucketize if b >= difficulty),
                         default=T)
        for k in ("tokens", "input_ids", "labels", "attention_mask"):
            if k in out:
                v = out[k]
                out[k] = (v if isinstance(v, torch.Tensor)
                          else np.asarray(v))[:, :difficulty]
        return out
    labels = out.get("labels")
    if labels is None:
        # causal LM: always derive shifted labels, so the batch's keys and
        # shapes stay the same over the whole ramp
        tokens_np = np.asarray(tokens)
        inputs = tokens_np[:, :-1]
        labels = tokens_np[:, 1:].astype(np.int32).copy()
        if difficulty < T:
            labels[:, max(difficulty - 1, 0):] = ignore_index
        out["tokens"] = inputs
        if "input_ids" in out:
            out["input_ids"] = inputs
        out["labels"] = labels
    elif difficulty < T:
        labels = np.asarray(labels).astype(np.int32).copy()
        labels[:, difficulty:] = ignore_index
        out["labels"] = labels
    return out
