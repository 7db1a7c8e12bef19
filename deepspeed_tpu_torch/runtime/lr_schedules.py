"""LR schedules (counterpart of `deepspeed_tpu/runtime/lr_schedules.py`):
WarmupLR, WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest.

Each is a function `step -> lr` over 0-d fp32 tensors, as the JAX ones
are traced in fp32: a step that lives on the device (the optimizer's
count) gives an lr on the device without a host read. `LRScheduler` keeps
the torch-scheduler-like `step()` / `get_lr()` API the engine exposes.
"""

import math

import torch

WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
ONE_CYCLE = "OneCycle"
LR_RANGE_TEST = "LRRangeTest"


def _step(step):
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_lr(warmup_min_lr=0.0, warmup_max_lr=0.001, warmup_num_steps=1000,
              warmup_type="log", **_):
    """Warm from min to max over warmup_num_steps, then hold."""
    wn = max(warmup_num_steps, 1)

    def schedule(step):
        step = _step(step)
        if warmup_type == "log":
            frac = torch.log(step + 1.0) / math.log(wn + 1.0)
        else:
            frac = step / wn
        frac = frac.clamp(0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return schedule


def warmup_decay_lr(total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001,
                    warmup_num_steps=1000, warmup_type="log", **_):
    """Warmup, then linear decay to 0 at total_num_steps."""
    wl = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
    wn = max(warmup_num_steps, 1)

    def schedule(step):
        step = _step(step)
        decay = ((total_num_steps - step) / max(total_num_steps - wn, 1)
                 ).clamp(0.0, 1.0)
        return torch.where(step < wn, wl(step), warmup_max_lr * decay)

    return schedule


def warmup_cosine_lr(total_num_steps, warmup_min_ratio=0.0,
                     warmup_num_steps=1000, cos_min_ratio=0.0001,
                     warmup_max_lr=0.001, **_):
    wn = max(warmup_num_steps, 1)

    def schedule(step):
        step = _step(step)
        warm = warmup_max_lr * (warmup_min_ratio + (1 - warmup_min_ratio)
                                * (step / wn).clamp(0.0, 1.0))
        progress = ((step - wn) / max(total_num_steps - wn, 1)).clamp(0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * progress))
        decay = warmup_max_lr * (cos_min_ratio + (1 - cos_min_ratio) * cos)
        return torch.where(step < wn, warm, decay)

    return schedule


def one_cycle(cycle_min_lr, cycle_max_lr, decay_lr_rate=0.0,
              cycle_first_step_size=2000, cycle_second_step_size=None,
              decay_step_size=0, **_):
    """min -> max over the first phase, max -> min over the second, then
    decay."""
    first = max(cycle_first_step_size, 1)
    second = max(cycle_second_step_size if cycle_second_step_size is not None
                 else first, 1)

    def schedule(step):
        step = _step(step)
        up = cycle_min_lr + (cycle_max_lr - cycle_min_lr) \
            * (step / first).clamp(0.0, 1.0)
        down = cycle_max_lr - (cycle_max_lr - cycle_min_lr) \
            * ((step - first) / second).clamp(0.0, 1.0)
        post = (step - first - second).clamp_min(0.0)
        if decay_step_size > 0:
            decayed = cycle_min_lr * (1.0 - decay_lr_rate) ** torch.floor(
                post / decay_step_size)
        else:
            decayed = torch.full_like(step, cycle_min_lr)
        return torch.where(step <= first, up,
                           torch.where(step <= first + second, down, decayed))

    return schedule


def lr_range_test(lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                  lr_range_test_step_rate=1.0, lr_range_test_staircase=False,
                  **_):
    size = max(lr_range_test_step_size, 1)

    def schedule(step):
        interval = _step(step) / size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1 + interval * lr_range_test_step_rate)

    return schedule


SCHEDULE_REGISTRY = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
    ONE_CYCLE: one_cycle,
    LR_RANGE_TEST: lr_range_test,
}


def build_schedule(scheduler_config):
    if scheduler_config is None or scheduler_config.type is None:
        return None
    name = scheduler_config.type
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown scheduler '{name}'. Known: "
                         f"{sorted(SCHEDULE_REGISTRY)}")
    return SCHEDULE_REGISTRY[name](**scheduler_config.params)


class LRScheduler:
    """Stateful wrapper with the torch-like API the engine exposes
    (`engine.lr_scheduler.step()`, `.get_lr()`)."""

    def __init__(self, schedule_fn, last_step=0):
        self.schedule_fn = schedule_fn
        self.last_step = last_step

    def step(self, increment=1):
        self.last_step += increment

    def get_lr(self):
        return [float(self.schedule_fn(self.last_step))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]
