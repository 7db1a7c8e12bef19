from deepspeed_tpu_torch.ops.adam import FusedAdam, DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.lamb import FusedLamb
from deepspeed_tpu_torch.ops.lion import FusedLion, DeepSpeedCPULion
from deepspeed_tpu_torch.ops.adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.optim import build_optimizer, OPTIMIZER_REGISTRY
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)
