from deepspeed_tpu_torch.monitor.monitor import (CsvMonitor, MonitorMaster,
                                              TensorBoardMonitor,
                                              WandbMonitor)

__all__ = ["CsvMonitor", "MonitorMaster", "TensorBoardMonitor", "WandbMonitor"]
