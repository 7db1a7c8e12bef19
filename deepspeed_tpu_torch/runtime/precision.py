"""Mixed precision: dynamic loss scaling and the masked skip-step
(counterpart of `deepspeed_tpu/runtime/precision.py`).

The scaler state is a tuple of 0-d tensors on the engine's device, updated
with `torch.where`, so an overflow step is skipped by a masked update and
not by a host branch: the training step reads nothing back from the card
to decide it.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.utils.tree import (tree_all_finite, tree_leaves,
                                            tree_unflatten)


class LossScaleState(NamedTuple):
    scale: torch.Tensor            # f32 scalar
    good_steps: torch.Tensor       # i32 — consecutive overflow-free steps
    overflows: torch.Tensor        # i32 — total skipped steps
    hysteresis_left: torch.Tensor  # i32 — overflows tolerated before a cut


class LossScaler:
    """Static or dynamic loss scaling as pure functions over
    LossScaleState."""

    def __init__(self, static_scale=None, initial_scale_power=16,
                 loss_scale_window=1000, hysteresis=2,
                 consecutive_hysteresis=False, min_loss_scale=1.0,
                 scale_factor=2.0, enabled=True):
        self.enabled = enabled
        self.dynamic = static_scale in (None, 0, 0.0)
        self.static_scale = float(static_scale or 2.0**initial_scale_power)
        self.initial_scale = float(2.0**initial_scale_power) \
            if self.dynamic else self.static_scale
        self.loss_scale_window = loss_scale_window
        self.hysteresis = hysteresis
        self.consecutive_hysteresis = consecutive_hysteresis
        self.min_loss_scale = float(min_loss_scale)
        self.scale_factor = float(scale_factor)

    def init(self, device="cpu") -> LossScaleState:
        i32 = dict(dtype=torch.int32, device=device)
        return LossScaleState(
            scale=torch.tensor(self.initial_scale if self.enabled else 1.0,
                               dtype=torch.float32, device=device),
            good_steps=torch.tensor(0, **i32),
            overflows=torch.tensor(0, **i32),
            hysteresis_left=torch.tensor(self.hysteresis, **i32))

    def scale_loss(self, loss, state: LossScaleState):
        if not self.enabled:
            return loss
        return loss * state.scale.to(loss.dtype)

    def unscale_grads(self, grads, state: LossScaleState):
        """Unscale in fp32: dividing in fp16 underflows small grads to zero
        once the scale grows."""
        if not self.enabled:
            return grads
        inv = (1.0 / state.scale).float()
        return tree_unflatten(grads, [g.float() * inv
                                      for g in tree_leaves(grads)])

    def check_overflow(self, grads):
        """0-d bool tensor, True == all finite (no overflow)."""
        if not self.enabled:
            leaves = tree_leaves(grads)
            return torch.ones((), dtype=torch.bool,
                              device=leaves[0].device if leaves else "cpu")
        return tree_all_finite(grads)

    def update(self, state: LossScaleState, grads_finite) -> LossScaleState:
        """Dynamic scale update: on overflow, spend one unit of hysteresis
        and cut the scale only once it is exhausted; double after
        `loss_scale_window` consecutive clean steps (a clean step also
        refills the hysteresis unless `consecutive_hysteresis`)."""
        bad = (~grads_finite).to(torch.int32)
        if not self.enabled or not self.dynamic:
            return state._replace(good_steps=state.good_steps + 1,
                                  overflows=state.overflows + bad)
        new_good = torch.where(grads_finite, state.good_steps + 1,
                               torch.zeros_like(state.good_steps))
        grow = new_good >= self.loss_scale_window
        scale_up = torch.where(grow, state.scale * self.scale_factor,
                               state.scale)
        hyst_exhausted = state.hysteresis_left <= 1
        cut_scale = (state.scale / self.scale_factor).clamp_min(
            self.min_loss_scale)
        new_scale = torch.where(grads_finite, scale_up,
                                torch.where(hyst_exhausted, cut_scale,
                                            state.scale))
        refill = state.hysteresis_left if self.consecutive_hysteresis \
            else torch.full_like(state.hysteresis_left, self.hysteresis)
        new_hyst = torch.where(grads_finite, refill,
                               (state.hysteresis_left - 1).clamp_min(1))
        return LossScaleState(
            scale=new_scale,
            good_steps=torch.where(grow, torch.zeros_like(new_good),
                                   new_good).to(torch.int32),
            overflows=(state.overflows + bad).to(torch.int32),
            hysteresis_left=new_hyst.to(torch.int32))


def masked_update(stored, new, apply_mask=None):
    """In place, leaf by leaf over two lists: stored = apply_mask ? new :
    stored, with new rounded to stored's dtype — the skip-step as one
    `torch.where` per leaf. `apply_mask` None applies every leaf (a leaf
    that is already `new` stays as it is)."""
    for s, n in zip(stored, new):
        if apply_mask is not None:
            s.copy_(torch.where(apply_mask, n, s))
        elif n is not s:
            s.copy_(n)
