"""Learning-rate schedules (reference ``perceiver/scripts/lrs.py``), as plain
functions of the optimizer step. Counterpart of
``perceiver_io_tpu/training/lrs.py``.

:func:`lambda_lr` wraps a schedule for ``torch.optim.lr_scheduler.LambdaLR``
so that update ``n`` (counted from 0) uses ``schedule(n)``: the first update
uses the value at step 0, as optax's count does.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def cosine_with_warmup(base_lr: float, *, warmup_steps: int, training_steps: int,
                       min_fraction: float = 1e-1) -> Schedule:
    """Linear warmup, then cosine decay to ``min_fraction * base_lr``
    (reference ``CosineWithWarmupLR``)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, training_steps - warmup_steps)
        progress = min(max(progress, 0.0), 1.0)
        return base_lr * (min_fraction + (1.0 - min_fraction) * 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


def constant_with_warmup(base_lr: float, *, warmup_steps: int) -> Schedule:
    """Linear warmup, then constant (reference ``ConstantWithWarmupLR``)."""

    def schedule(step: int) -> float:
        return base_lr * min(1.0, step / max(1.0, warmup_steps))

    return schedule


def lambda_lr(optimizer: torch.optim.Optimizer, schedule: Schedule) -> torch.optim.lr_scheduler.LambdaLR:
    """A ``LambdaLR`` that sets each group's learning rate to
    ``schedule(step)`` exactly: the groups' base rate is set to 1 first, so
    the multiplier is the rate itself. Step it once after each update."""
    for group in optimizer.param_groups:
        group["lr"] = 1.0
        group.pop("initial_lr", None)
    return torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
