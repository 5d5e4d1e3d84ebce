"""Learning-rate schedules (port of the parts of liso_tpu/utils/schedules.py
that SLIM training uses)."""
from __future__ import annotations

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
