"""AdamW over the SRAM tree and its schedules (port of ``repro.optim``;
``compress``, the multi-device gradient all-reduce, waits for ROADMAP
Queue 1 item 5)."""

from repro_torch.optim.adamw import AdamWConfig, init, update, global_norm
from repro_torch.optim import schedule

__all__ = ["AdamWConfig", "init", "update", "global_norm", "schedule"]
