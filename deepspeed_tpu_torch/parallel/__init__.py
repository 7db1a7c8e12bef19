"""Parallelism (counterpart of `deepspeed_tpu.parallel`): DeepSpeed-Ulysses,
ring attention and their composition over the `sequence` mesh axis, and the
one-rank Mixture-of-Experts layer. Tensor parallelism (`plan_tp_specs`,
`TiledLinear`) waits on ROADMAP queue 1 item 8."""

from deepspeed_tpu_torch.parallel.ulysses import (DistributedAttention,
                                                  ulysses_attention)
from deepspeed_tpu_torch.parallel.ring import (factored_sequence_mesh,
                                               ring_attention,
                                               ring_attention_blockwise,
                                               ring_flash_attention,
                                               ring_ulysses_attention)
from deepspeed_tpu_torch.parallel.moe import (MoE, MoELayer, top1_gating,
                                              top2_gating)

__all__ = ["DistributedAttention", "ulysses_attention", "ring_attention",
           "ring_flash_attention", "ring_attention_blockwise",
           "factored_sequence_mesh", "ring_ulysses_attention", "MoE",
           "MoELayer", "top1_gating", "top2_gating"]
