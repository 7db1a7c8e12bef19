"""Random layerwise token dropping, the schedule (counterpart of
`deepspeed_tpu/runtime/data_pipeline/random_ltd.py`).

Middle layers run on a random subset of each sample's tokens; the kept
count ramps by schedule and is bucketed. The engine draws the kept
positions on the host (`runtime/engine.py`) and the model gathers, runs
and scatters them (`models/gpt.gpt_hidden(ltd=...)`). The JAX package's
`random_ltd_layer` helper is called by nothing in the port and has no
counterpart here.
"""


class RandomLTDScheduler:
    """Kept-token count ramp (the reference's `data_routing/scheduler.py`)."""

    def __init__(self, total_layers, start_ratio=0.5, end_ratio=1.0,
                 total_steps=10000, ltd_start_layer=1, ltd_end_layer=None,
                 bucket=64):
        self.start_ratio = start_ratio
        self.end_ratio = end_ratio
        self.total_steps = max(total_steps, 1)
        self.start_layer = ltd_start_layer
        self.end_layer = ltd_end_layer if ltd_end_layer is not None \
            else total_layers - 1
        self.bucket = bucket

    def keep_ratio(self, step):
        frac = min(step / self.total_steps, 1.0)
        return self.start_ratio + (self.end_ratio - self.start_ratio) * frac

    def keep_count(self, step, seq_len):
        """Kept tokens a row at `step`: the schedule's value (a count above
        1, else a ratio of `seq_len`), rounded down to the bucket, at least
        one bucket, at most `seq_len`."""
        raw = self.keep_ratio(step)
        raw = int(raw if raw > 1 else raw * seq_len)
        bucketed = max((raw // self.bucket) * self.bucket, self.bucket)
        return min(bucketed, seq_len)
