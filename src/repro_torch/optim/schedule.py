"""LR schedules (PyTorch counterpart of ``repro.optim.schedule``)."""
from __future__ import annotations

import math
from typing import Union

import torch


def warmup_cosine(step: Union[int, torch.Tensor], *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor * peak_lr``
    at ``total``: a 0-d float32 tensor on ``step``'s device (the CPU for a
    Python int), computed in float32 in the JAX package's order."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
