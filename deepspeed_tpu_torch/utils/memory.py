"""Memory reporting (counterpart of `deepspeed_tpu/utils/memory.py`).

The reference's `see_memory_usage`: the card's allocator reading
(`torch.cuda.memory_stats` / `torch.cuda.mem_get_info`) plus the host's
resident set from /proc. Handed a `Telemetry` object, the reading also
lands in the registry (`mem/bytes_in_use` / `mem/peak_bytes`); the full
byte-attribution ledger lives in `telemetry/memscope.py`.
"""

import os

import torch

from deepspeed_tpu_torch.utils.logging import logger


def _host_rss_gb():
    """Host resident-set size in GiB, from procfs; 0.0 without /proc."""
    path = f"/proc/{os.getpid()}/status"
    if not os.path.exists(path):
        return 0.0
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / (1024**2)
    except Exception:
        pass
    return 0.0


def device_memory_stats(device=None):
    """{bytes_in_use, peak_bytes_in_use, bytes_limit, bytes_free} of a CUDA
    device (the current one by default): the caching allocator's live and
    peak allocated bytes, and `mem_get_info`'s total and free. {} for a
    device that is not CUDA, or on a box without a GPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    try:
        raw = torch.cuda.memory_stats(device)
        free, total = torch.cuda.mem_get_info(device)
    except Exception:
        return {}
    return {"bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total), "bytes_free": int(free)}


def see_memory_usage(message, force=False, device=None, telemetry=None):
    """Log the card's allocator reading and the host RSS. `force` gates it,
    as the reference's signature does. With an enabled `telemetry` the
    same reading sets the `mem/bytes_in_use` / `mem/peak_bytes` gauges."""
    if not force:
        return
    stats = device_memory_stats(device)
    if telemetry is not None and getattr(telemetry, "enabled", False):
        telemetry.set_gauge("mem/bytes_in_use", stats.get("bytes_in_use", 0))
        telemetry.set_gauge("mem/peak_bytes",
                            stats.get("peak_bytes_in_use", 0))
    gb = 1024**3
    logger.info(
        f"{message} | device in use: "
        f"{stats.get('bytes_in_use', 0) / gb:.2f} GB | device peak: "
        f"{stats.get('peak_bytes_in_use', 0) / gb:.2f} GB | device limit: "
        f"{stats.get('bytes_limit', 0) / gb:.2f} GB | host RSS: "
        f"{_host_rss_gb():.2f} GB")
