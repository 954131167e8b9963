"""The training step on one device. Counterpart of
``perceiver_io_tpu/parallel/train_step.py`` without a mesh: a
:class:`TrainState` (step, model, optimizer, scheduler) and
:func:`make_train_step` / :func:`make_eval_step`.

PyTorch runs eagerly, so the step is a plain function that updates the
state in place (the model's parameters and the optimizer's moments) and
returns it. Metrics are device tensors; nothing in the step waits for the
device. Meshes (DDP/FSDP) and several optimizer steps per call
(``multi_steps``) are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device

if TYPE_CHECKING:  # the training package imports this module
    from perceiver_io_tpu_torch.training.optim import OptimizerFactory
    from perceiver_io_tpu_torch.training.tasks import LossFn


@dataclass
class TrainState:
    """Step counter, model (the parameters), optimizer and optional
    learning-rate scheduler."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerFactory) -> "TrainState":
        optimizer, scheduler = tx(model)
        return cls(step=0, model=model, optimizer=optimizer, scheduler=scheduler)

    def apply_gradients(self) -> "TrainState":
        """One update from the gradients in the parameters' ``.grad``."""
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
        return self


def to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


def make_train_step(
    loss_fn: LossFn,
    *,
    grad_clip_norm: Optional[float] = None,
    grad_accum_steps: int = 1,
    multi_steps: int = 1,
    mesh: Any = None,
    device: DeviceLike = "cuda",
) -> Callable[[TrainState, Mapping[str, Any], Optional[torch.Generator]], Tuple[TrainState, dict]]:
    """Build ``step(state, batch, generator) -> (state, metrics)``.

    :param loss_fn: ``(model, batch, generator) -> (loss, metrics)``, a mean
        over the batch (:mod:`~perceiver_io_tpu_torch.training.tasks`).
    :param grad_clip_norm: global-norm clipping after the gradient,
        ``g * min(1, clip / (norm + 1e-6))``; logs the pre-clip ``grad_norm``.
    :param grad_accum_steps: split the given batch into this many equal
        microbatches along dim 0 and average their gradients before the one
        update. As in the JAX package this DIVIDES the given batch (unlike
        Lightning's ``accumulate_grad_batches``, which multiplies it): the
        loss and gradient are the mean of the microbatch means. Peak
        activation memory is one microbatch's.
    :param device: where batches go; ``"cuda"`` by default, the CPU only
        when asked for.
    """
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if multi_steps != 1:
        raise NotImplementedError("multi_steps > 1 is not ported yet (ROADMAP.md A)")
    if mesh is not None:
        raise NotImplementedError("a training mesh is not ported yet (ROADMAP.md A)")
    dev = resolve_device(device)

    def step(state: TrainState, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None):
        model = state.model
        batch = to_device(batch, dev)
        model.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            loss, metrics = loss_fn(model, batch, generator)
            loss.backward()
        else:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum_steps:
                raise ValueError(f"batch dim {n} not divisible by grad_accum_steps={grad_accum_steps}")
            size = n // grad_accum_steps
            losses, micro_metrics = [], []
            for i in range(grad_accum_steps):
                micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                micro_loss, m = loss_fn(model, micro, generator)
                micro_loss.backward()
                losses.append(micro_loss.detach())
                micro_metrics.append(m)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(grad_accum_steps)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in micro_metrics]).mean() for k in micro_metrics[0]}
        metrics = {"loss": loss.detach(), **metrics}
        if grad_clip_norm is not None:
            grads = [p for p in model.parameters() if p.grad is not None]
            metrics["grad_norm"] = torch.nn.utils.clip_grad_norm_(grads, grad_clip_norm)
        return state.apply_gradients(), metrics

    return step


def make_eval_step(loss_fn: LossFn, *, device: DeviceLike = "cuda"):
    """``(state, batch) -> metrics`` with the deterministic loss, no grad."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: Mapping[str, Any]) -> dict:
        with torch.no_grad():
            loss, metrics = loss_fn(state.model, to_device(batch, dev), None)
        return {"loss": loss, **metrics}

    return step
