"""Learning-rate schedules (pure functions of the step), in fp32."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to ``final_frac`` of
    it at ``total_steps``; a 0-d fp32 tensor on the CPU (or on ``step``'s
    device when ``step`` is a tensor)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(1.0, warmup_steps)
    t = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, lr: float) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step, dtype=torch.float32), lr)
