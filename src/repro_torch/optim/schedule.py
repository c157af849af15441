"""Learning-rate schedules, pure functions of the step counter (port of
``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup_steps: int,
                       total_steps: int, min_frac: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``min_frac * peak_lr`` at ``total_steps``; a 0-d f32 tensor on the
    step's device."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(1, warmup_steps)
    t = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    # the f64 cosine rounded to f32, as XLA's: PyTorch's f32 cosine on the
    # CPU is off by an ulp where XLA's is correctly rounded
    c = torch.cos((math.pi * t).double()).float()
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + c))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, lr: float):
    del step
    return lr
