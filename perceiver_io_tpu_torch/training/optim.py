"""Optimizer construction with optional parameter freezing. Counterpart of
``perceiver_io_tpu/training/optim.py``.

:func:`make_optimizer` returns what an optax transformation is to the JAX
package: a recipe, applied to a model by ``TrainState.create``, that gives
the ``torch.optim`` optimizer and, for a scheduled learning rate, its
``LambdaLR``. ``adamw``, ``adam`` and ``sgd`` map onto ``torch.optim.AdamW``,
``Adam`` and ``SGD`` with optax's defaults (eps 1e-8; AdamW decays every
trainable parameter, as ``optax.adamw`` with no mask); ``lamb`` is
:class:`Lamb`, written here to equal ``optax.lamb``. Frozen parameters
(``frozen_prefixes``, flax path prefixes mapped onto ``state_dict`` names by
the weight bridge) are left out of the optimizer: they get no update and no
moments, as under ``optax.set_to_zero``. Their gradients are still computed,
so they count in the clipping norm as in JAX.

Under a mesh a parameter may be a shard, and LAMB's trust ratio wants the
whole tensor's norm: :func:`~perceiver_io_tpu_torch.parallel.train_step.create_train_state`
gives :class:`Lamb` a norm reducer, which sums the shards' squared norms over
the axes each parameter is sharded on (GSPMD's whole norms in JAX).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from perceiver_io_tpu_torch.convert.from_jax import torch_name
from perceiver_io_tpu_torch.training.lrs import Schedule, lambda_lr

def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in fp32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


#: ``reducer(params, sq) -> sq``: ``sq`` is the ``(n, 2)`` fp32 squared norms
#: of each parameter (as held on this rank) and of its update; the reducer
#: returns the whole tensors' squared norms
NormReducer = Callable[[List[torch.Tensor], torch.Tensor], torch.Tensor]


class Lamb(torch.optim.Optimizer):
    """LAMB as ``optax.lamb(lr, b1, b2, eps=1e-6, weight_decay=wd)``: per
    parameter tensor, the bias-corrected Adam direction ``m_hat / (sqrt(v_hat)
    + eps)`` plus ``wd * p``, scaled by the trust ratio ``|p| / |u|`` (1 where
    either norm is 0), times the group's learning rate. Plain tensor code
    over all of a group's parameters at once (``torch._foreach_*``).

    ``norm_reducer`` (set under a mesh whose specs shard a parameter) turns
    each norm of a shard into the whole tensor's: the squared norms go
    through it before the square root. Without it the norms are the local
    tensors'."""

    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0, norm_reducer: Optional[NormReducer] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.norm_reducer = norm_reducer

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["step"] += 1
            grads = [p.grad for p in params]
            mu = [self.state[p]["exp_avg"] for p in params]
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            steps = [self.state[p]["step"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p
            denom = torch._foreach_div(nu, [_bias_correction(b2, t) for t in steps])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mu, [_bias_correction(b1, t) for t in steps])
            torch._foreach_div_(update, denom)
            if group["weight_decay"]:
                torch._foreach_add_(update, params, alpha=group["weight_decay"])
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(update))
            if self.norm_reducer is not None:
                # sqrt(x * x) == x in IEEE arithmetic: a row the reducer
                # leaves alone keeps its local norm to the bit
                sq = self.norm_reducer(params, torch.stack([p_norm, u_norm], dim=1).float().square())
                p_norm, u_norm = (n.to(p_norm.dtype) for n in sq.sqrt().unbind(1))
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
            torch._foreach_mul_(update, list((ratio * -group["lr"]).unbind()))
            torch._foreach_add_(params, update)
        return loss


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
    if optimizer not in ("adamw", "adam", "sgd", "lamb"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    scheduled = callable(learning_rate)
    lr = 1.0 if scheduled else learning_rate

    def factory(model: nn.Module):
        params = _trainable(model, frozen_prefixes)
        if optimizer == "adamw":
            opt = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=weight_decay)
        elif optimizer == "adam":
            opt = torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)
        elif optimizer == "lamb":
            opt = Lamb(params, lr=lr, betas=(b1, b2), eps=1e-6, weight_decay=weight_decay)
        else:
            opt = torch.optim.SGD(params, lr=lr)
        return opt, (lambda_lr(opt, learning_rate) if scheduled else None)

    return factory
