from deepspeed_tpu_torch.runtime.data_pipeline.curriculum import (
    CurriculumScheduler, apply_seqlen_curriculum)
from deepspeed_tpu_torch.runtime.data_pipeline.random_ltd import \
    RandomLTDScheduler
