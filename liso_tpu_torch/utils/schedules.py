"""Learning-rate schedules (port of liso_tpu/utils/schedules.py). Each
maps a step to a 0-dim fp32 tensor, computed in fp32 as the JAX schedules
are."""
from __future__ import annotations

import math
from typing import Callable

import torch


def polynomial_decay_with_warmup(
    initial_lr: float, num_warmup_steps: int, num_training_steps: int,
    lr_end_factor: float = 0.05, power: float = 1.0,
) -> Callable[[int], torch.Tensor]:
    """Linear warmup 0 -> initial, then polynomial decay to
    initial * lr_end_factor. The returned schedule maps a step to a 0-dim
    fp32 tensor, computed in fp32 as the JAX schedule is."""
    lr_end = initial_lr * lr_end_factor

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = step / max(1, num_warmup_steps) * initial_lr
        decay_steps = max(1, num_training_steps - num_warmup_steps)
        pct_remaining = (1.0 - (step - num_warmup_steps) / decay_steps).clamp(
            0.0, 1.0
        )
        decayed = (initial_lr - lr_end) * pct_remaining**power + lr_end
        return torch.where(step < num_warmup_steps, warm, decayed)

    return schedule


def onecycle(
    max_lr: float, total_steps: int, pct_start: float = 0.4,
    div_factor: float = 10.0, final_div_factor: float = 10.0,
) -> Callable[[int], torch.Tensor]:
    """torch OneCycleLR with cosine annealing and the reference's mined-mode
    hyperparameters (pct_start 0.4, div_factor 10, final_div_factor 10):
    cosine from max_lr / div up to max_lr over the first phase, then down to
    max_lr / (div * final_div). Beyond `total_steps` the rate stays clamped
    at that minimum, where torch's scheduler raises."""
    total = max(int(total_steps), 10)
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    # torch's phase boundary: float(pct_start * total_steps) - 1
    up_steps = max(float(pct_start * total) - 1.0, 1.0)
    down_steps = max(total - 1.0 - up_steps, 1.0)

    def schedule(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=torch.float32)
        pct_up = (s / up_steps).clamp(0.0, 1.0)
        lr_up = max_lr + (initial_lr - max_lr) * 0.5 * (
            1.0 + torch.cos(math.pi * pct_up))
        pct_dn = ((s - up_steps) / down_steps).clamp(0.0, 1.0)
        lr_dn = min_lr + (max_lr - min_lr) * 0.5 * (
            1.0 + torch.cos(math.pi * pct_dn))
        return torch.where(s <= up_steps, lr_up, lr_dn)

    return schedule
