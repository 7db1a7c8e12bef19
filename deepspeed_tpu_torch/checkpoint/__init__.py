from deepspeed_tpu_torch.checkpoint.saver import (get_latest_tag,
                                                  load_checkpoint,
                                                  save_checkpoint,
                                                  wait_pending_save)
from deepspeed_tpu_torch.checkpoint.manifest import (CheckpointCorruptionError,
                                                     read_manifest,
                                                     verify_manifest)
