"""LR schedules (the port of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 200, total: int = 10_000,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` of peak (returns the
    float32 scale, on ``step``'s device when it is a tensor)."""
    step = step.float() if isinstance(step, torch.Tensor) else torch.tensor(float(step))
    # (step+1): the very first step must not have a zero learning rate
    warm = torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * progress))
    return warm * cos
