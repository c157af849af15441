"""AdamW over the SRAM tree, its schedules, and the error-feedback int8
gradient all-reduce over a mesh (port of ``repro.optim``)."""

from repro_torch.optim.adamw import AdamWConfig, init, update, global_norm
from repro_torch.optim import compress, schedule

__all__ = ["AdamWConfig", "init", "update", "global_norm", "schedule",
           "compress"]
