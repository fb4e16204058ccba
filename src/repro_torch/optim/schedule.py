"""Learning-rate schedules: linear warmup, then cosine / linear / constant
decay (counterpart of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def make_schedule(cfg: TrainConfig):
    """``schedule(step) -> lr`` as an fp32 scalar tensor on ``step``'s
    device (``step`` is the optimizer's count BEFORE the update)."""
    peak, warm, total = cfg.learning_rate, cfg.warmup_steps, cfg.total_steps

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm_frac = torch.clamp(step / max(warm, 1), max=1.0)
        t = torch.clamp((step - warm) / max(total - warm, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(math.pi * t))
        elif cfg.schedule == "linear":
            decay = 1.0 - t
        else:
            decay = torch.ones_like(t)
        return peak * warm_frac * decay

    return schedule
