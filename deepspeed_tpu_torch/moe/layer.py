"""Reference import path `deepspeed.moe.layer` (`deepspeed/moe/layer.py:16`)."""

from deepspeed_tpu_torch.parallel.moe import MoE, MoELayer

__all__ = ["MoE", "MoELayer"]
