"""LR schedules (pure functions of the step), PyTorch port of
``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``floor *
    peak_lr`` at ``total``.  ``step`` is an int or an integer tensor; the
    result is a float32 tensor on its device (the CPU for an int),
    computed in float32 as the reference computes it."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)
