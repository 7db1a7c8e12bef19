"""Data loading (counterpart of `deepspeed_tpu/runtime/dataloader.py`).

The engine takes batches as trees of numpy arrays or tensors.
`TpuDataLoader` slices an indexable dataset into global batches;
`RepeatingLoader` restarts an exhausted loader. The metric-driven
curriculum loader (`CurriculumDataLoader`, over the data sampler) is not
ported: it raises. The legacy seqlen curriculum is the engine's
(`runtime/data_pipeline/curriculum.py`).
"""

import numpy as np

from deepspeed_tpu_torch.config.core import not_ported


class RepeatingLoader:
    """Wraps an iterable to restart it on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack(samples)


class CurriculumDataLoader:
    def __init__(self, *args, **kwargs):
        not_ported("CurriculumDataLoader (the curriculum_metrics "
                   "curriculum over the data sampler)")


class TpuDataLoader:
    """Batches an indexable dataset; drops the ragged tail (drop_last)."""

    def __init__(self, dataset, batch_size, collate_fn=None, shuffle=False,
                 seed=0, drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        stop = n - (self.batch_size - 1 if self.drop_last else 0)
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
