"""Optimizer construction with optional parameter freezing. Counterpart of
``perceiver_io_tpu/training/optim.py``.

:func:`make_optimizer` returns what an optax transformation is to the JAX
package: a recipe, applied to a model by ``TrainState.create``, that gives
the ``torch.optim`` optimizer and, for a scheduled learning rate, its
``LambdaLR``. ``adamw``, ``adam`` and ``sgd`` map onto ``torch.optim.AdamW``,
``Adam`` and ``SGD`` with optax's defaults (eps 1e-8; AdamW decays every
trainable parameter, as ``optax.adamw`` with no mask). Frozen parameters
(``frozen_prefixes``, flax path prefixes mapped onto ``state_dict`` names by
the weight bridge) are left out of the optimizer: they get no update and no
moments, as under ``optax.set_to_zero``. Their gradients are still computed,
so they count in the clipping norm as in JAX.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from perceiver_io_tpu_torch.convert.from_jax import torch_name
from perceiver_io_tpu_torch.training.lrs import Schedule, lambda_lr

OptimizerFactory = Callable[
    [nn.Module], Tuple[torch.optim.Optimizer, Optional[torch.optim.lr_scheduler.LambdaLR]]
]


def _trainable(model: nn.Module, frozen_prefixes: Sequence[str] = ()):
    """The parameters outside the frozen flax path prefixes."""
    prefixes = [torch_name(p) for p in frozen_prefixes]
    return [p for name, p in model.named_parameters()
            if not any(name == f or name.startswith(f + ".") for f in prefixes)]


def make_optimizer(
    learning_rate: Union[float, Schedule],
    *,
    optimizer: str = "adamw",
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    frozen_prefixes: Sequence[str] = (),
) -> OptimizerFactory:
    """The training optimizer's factory: ``factory(model) -> (optimizer,
    scheduler or None)``.

    :param learning_rate: a rate, or a schedule of the step (see
        :mod:`~perceiver_io_tpu_torch.training.lrs`).
    :param frozen_prefixes: flax parameter-path prefixes (e.g.
        ``("perceiver_ar/cross_attention",)``) excluded from updates.
    """
    if optimizer == "lamb":
        raise NotImplementedError("the lamb optimizer is not ported yet (ROADMAP.md A)")
    if optimizer not in ("adamw", "adam", "sgd"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    scheduled = callable(learning_rate)
    lr = 1.0 if scheduled else learning_rate

    def factory(model: nn.Module):
        params = _trainable(model, frozen_prefixes)
        if optimizer == "adamw":
            opt = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=weight_decay)
        elif optimizer == "adam":
            opt = torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)
        else:
            opt = torch.optim.SGD(params, lr=lr)
        return opt, (lambda_lr(opt, learning_rate) if scheduled else None)

    return factory
