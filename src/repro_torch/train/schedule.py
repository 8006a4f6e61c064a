"""LR schedules (the reference's `train/schedule.py`): pure functions of
the step, computed in fp32 on the step's device."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, warmup: int, total: int,
                       min_ratio: float = 0.1):
    """Linear warmup to 1 over `warmup` steps, then a cosine down to
    `min_ratio` at `total`. -> fp32 scalar tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
