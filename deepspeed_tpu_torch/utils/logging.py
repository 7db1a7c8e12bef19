"""Rank-filtered logging (counterpart of `deepspeed_tpu/utils/logging.py`).

Process identity comes from `torch.distributed` when a process group is
initialized, else rank 0.
"""

import functools
import logging
import os
import sys

LOG_LEVEL = os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper()


@functools.lru_cache(None)
def _create_logger(name="deepspeed_tpu_torch"):
    lg = logging.getLogger(name)
    lg.setLevel(getattr(logging, LOG_LEVEL, logging.INFO))
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S"))
        lg.addHandler(handler)
    return lg


logger = _create_logger()


def _process_index():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log `message` only if this process's rank is in `ranks` (or ranks is
    None / contains -1)."""
    rank = _process_index()
    if ranks is None or -1 in ranks or rank in ranks:
        logger.log(level, f"[Rank {rank}] {message}")
