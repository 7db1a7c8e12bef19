"""Wall-clock and throughput timers (counterpart of
`deepspeed_tpu/utils/timer.py`).

"Synchronized" means the timer waits for the device's queued work before
it reads the clock: for a CUDA device a timed region is bracketed by CUDA
events and read after `Event.synchronize()`, so the time covers the
kernels the region enqueued, not only their launches. For the CPU the host
clock is read directly.
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import logger

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


class Timer:
    def __init__(self, name, device=None):
        self.name = name
        self.on_cuda = device is not None and torch.device(device).type \
            == "cuda"
        self.started = False
        self.start_time = 0.0
        self.elapsed_total = 0.0
        self.last = 0.0          # seconds of the last start/stop interval
        self.count = 0
        self._event = None

    def start(self):
        if self.started:
            return
        if self.on_cuda:
            self._event = torch.cuda.Event(enable_timing=True)
            self._event.record()
        else:
            self.start_time = time.perf_counter()
        self.started = True

    def stop(self, reset=False):
        if not self.started:
            return
        if self.on_cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.last = self._event.elapsed_time(end) / 1e3
        else:
            self.last = time.perf_counter() - self.start_time
        self.elapsed_total += self.last
        self.count += 1
        self.started = False

    def elapsed(self, reset=True):
        value = self.elapsed_total
        if reset:
            self.reset()
        return value

    def mean(self):
        return self.elapsed_total / max(self.count, 1)

    def reset(self):
        self.elapsed_total = 0.0
        self.count = 0
        self.started = False


class SynchronizedWallClockTimer:
    """Named-timer registry; `log()` prints ms per timer like the reference."""

    def __init__(self, device=None):
        self.device = device
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = Timer(name, self.device)
        return self.timers[name]

    def has_timer(self, name):
        return name in self.timers

    def log(self, names=None, normalizer=1.0, reset=True):
        if normalizer <= 0.0:
            raise ValueError(f"normalizer must be positive, got {normalizer}")
        names = names if names is not None else list(self.timers.keys())
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 \
                    / normalizer
                string += f" | {name}: {elapsed:.2f}"
        logger.info(string)
        return string

    def get_mean(self, names, normalizer=1.0, reset=True):
        if normalizer <= 0.0:
            raise ValueError(f"normalizer must be positive, got {normalizer}")
        means = {}
        for name in names:
            if name in self.timers:
                means[name] = self.timers[name].mean() * 1000.0 / normalizer
                if reset:
                    self.timers[name].reset()
        return means


class ThroughputTimer:
    """Samples/s across optimizer steps, skipping the first `start_step`
    (warm-up) steps; each timed step is a synchronized `Timer` interval."""

    def __init__(self, batch_size, start_step=2, steps_per_output=50,
                 logging_fn=None, device=None):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or logger.info
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.started = False
        self._timer = Timer("throughput", device)

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.started = True
        if self.global_step_count >= self.start_step:
            self._timer.start()

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if not self._timer.started:
            return
        self._timer.stop()
        duration = self._timer.elapsed(reset=True)
        self.total_elapsed_time += duration
        self.step_elapsed_time += duration
        if global_step:
            if report_speed and \
                    self.global_step_count % self.steps_per_output == 0:
                self.logging(
                    f"epoch={self.epoch_count}/micro_step="
                    f"{self.micro_step_count}/global_step="
                    f"{self.global_step_count}, RunningAvgSamplesPerSec="
                    f"{self.avg_samples_per_sec():.6g}, CurrSamplesPerSec="
                    f"{self.batch_size / self.step_elapsed_time:.6g}")
            self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self):
        if self.total_elapsed_time > 0:
            samples = self.batch_size * max(
                self.global_step_count - self.start_step, 1)
            return samples / self.total_elapsed_time
        return float("-inf")
