"""Parallelism (counterpart of `deepspeed_tpu.parallel`): the one-rank
Mixture-of-Experts layer so far."""

from deepspeed_tpu_torch.parallel.moe import (MoE, MoELayer, top1_gating,
                                              top2_gating)

__all__ = ["MoE", "MoELayer", "top1_gating", "top2_gating"]
