"""The training loop: step-based training with periodic validation,
best-``val_loss`` checkpoints, and loss / learning-rate logging (a
``metrics.jsonl`` always, TensorBoard when it can be imported). Counterpart
of ``perceiver_io_tpu/training/trainer.py`` on one device.

Each step's ``torch.Generator`` (prefix dropout) is seeded from
``(seed, step)``, the role of JAX's ``fold_in``, so a step's noise does not
depend on the steps before it. Metrics stay on the device until a log flush
reads them.

:class:`TrainerConfig` keeps the JAX field names and defaults. Not ported
yet, and raising ``NotImplementedError`` when asked for (``ROADMAP.md`` A):
``resume``, ``save_state_every_n_steps``, ``steps_per_execution > 1``, the
``skip`` and ``rollback`` non-finite policies, ``shard_seq``,
``profile_start``, and the chaos, tracer and snapshot-writer hooks.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.parallel.train_step import (
    TrainState,
    make_eval_step,
    make_train_step,
)
from perceiver_io_tpu_torch.training.checkpoint import BestCheckpointManager
from perceiver_io_tpu_torch.training.lrs import Schedule
from perceiver_io_tpu_torch.training.optim import OptimizerFactory
from perceiver_io_tpu_torch.training.tasks import LossFn


@dataclasses.dataclass
class TrainerConfig:
    """Trainer hyperparameters, with the JAX package's names and defaults
    (the ``--trainer.*`` surface of the reference CLI)."""

    max_steps: int
    val_check_interval: int = 1000
    log_every_n_steps: int = 50
    limit_val_batches: Optional[int] = None
    limit_test_batches: Optional[int] = None
    default_root_dir: str = "logs"
    max_checkpoints: int = 1
    grad_clip_norm: Optional[float] = None
    #: split each batch into N microbatches and average their gradients;
    #: DIVIDES the given batch (see ``make_train_step``)
    grad_accum_steps: int = 1
    steps_per_execution: int = 1
    seed: int = 0
    enable_checkpointing: bool = True
    enable_tensorboard: bool = True
    shard_seq: bool = False
    profile_start: Optional[int] = None
    save_state_every_n_steps: Optional[int] = None
    resume: Optional[str] = None
    #: halt (raise) when the mean train loss of a log window is non-finite;
    #: False turns the check off
    terminate_on_non_finite: bool = True
    non_finite_policy: str = "halt"
    non_finite_rollback_after: int = 3
    non_finite_max_rollbacks: int = 3


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md A)")


def _check_config(cfg: TrainerConfig) -> str:
    """The effective non-finite policy (``halt`` or ``off``); raises on what
    is not ported."""
    if cfg.non_finite_policy not in ("halt", "skip", "rollback"):
        raise ValueError(f"non_finite_policy must be halt|skip|rollback, got {cfg.non_finite_policy!r}")
    if cfg.non_finite_policy != "halt":
        raise _unported(f"non_finite_policy={cfg.non_finite_policy!r}")
    for what, unported in (
        ("resume", cfg.resume is not None),
        ("save_state_every_n_steps", cfg.save_state_every_n_steps is not None),
        ("steps_per_execution > 1", cfg.steps_per_execution != 1),
        ("shard_seq", cfg.shard_seq),
        ("profile_start", cfg.profile_start is not None),
    ):
        if unported:
            raise _unported(what)
    return "halt" if cfg.terminate_on_non_finite else "off"


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of optimizer step ``step``: a pure function of
    ``(seed, step)``."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _cycle(data: Iterable) -> Iterator:
    """``data`` over and over; a one-shot generator is refused at the first
    wrap-around."""
    while True:
        count = 0
        for batch in data:
            count += 1
            yield batch
        if count == 0:
            raise ValueError("train_data is exhausted and not re-iterable (one-shot generator?); "
                             "pass a list or a loader")


class Trainer:
    """Step-based fit and validation loop on one device.

    :param loss_fn: ``(model, batch, generator) -> (loss, metrics)`` (one of
        :mod:`perceiver_io_tpu_torch.training.tasks`).
    :param tx: the optimizer factory of
        :func:`~perceiver_io_tpu_torch.training.optim.make_optimizer`.
    :param model_config: written beside each checkpoint.
    :param lr_schedule: logged as ``train/lr`` at each flush.
    :param callbacks: ``(trainer, state, step, val_metrics)`` callables run
        after each validation pass; one that raises is logged and counted in
        ``fault_stats["callback_errors"]``, never fatal.
    :param device: ``"cuda"`` by default; the CPU only when asked for.
    """

    def __init__(
        self,
        config: TrainerConfig,
        loss_fn: LossFn,
        tx: OptimizerFactory,
        *,
        model_config: Any = None,
        lr_schedule: Optional[Schedule] = None,
        callbacks: Sequence[Callable] = (),
        device: DeviceLike = "cuda",
        chaos: Any = None,
        tracer: Any = None,
        snapshot_writer: Any = None,
    ):
        for what, hook in (("chaos", chaos), ("tracer", tracer), ("snapshot_writer", snapshot_writer)):
            if hook is not None:
                raise _unported(f"the trainer's {what} hook")
        self._policy = _check_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.tx = tx
        self.model_config = model_config
        self.lr_schedule = lr_schedule
        self.callbacks = list(callbacks)
        self.state: Optional[TrainState] = None
        self.fault_stats = {"callback_errors": 0}
        self._eval_step = make_eval_step(loss_fn, device=self.device)
        self._ckpt: Optional[BestCheckpointManager] = None
        if config.enable_checkpointing:
            self._ckpt = BestCheckpointManager(
                os.path.join(config.default_root_dir, "checkpoints"),
                max_to_keep=config.max_checkpoints,
            )
        self._metrics_file = None
        self._tb = None

    def _open_writers(self) -> None:
        cfg = self.config
        os.makedirs(cfg.default_root_dir, exist_ok=True)
        if self._metrics_file is None:
            self._metrics_file = open(os.path.join(cfg.default_root_dir, "metrics.jsonl"), "a")
        if cfg.enable_tensorboard and self._tb is None:
            try:  # TensorBoard only when it is installed, as in the JAX package
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._tb = SummaryWriter(os.path.join(cfg.default_root_dir, "tb"))

    def _close_writers(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def log_metrics(self, step: int, metrics: dict, prefix: str = "") -> None:
        if self._metrics_file is None:
            return
        scalars = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        self._metrics_file.write(json.dumps({"step": step, **scalars}) + "\n")
        self._metrics_file.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def setup_state(self, model: nn.Module) -> TrainState:
        """The train state of ``model`` (on the trainer's device) without
        fitting: the ``validate``-only entry."""
        devices = {p.device.type for p in model.parameters()}
        if devices != {self.device.type}:
            raise ValueError(f"the model lies on {sorted(devices)}, the trainer on {self.device}")
        self.state = TrainState.create(model, self.tx)
        return self.state

    def fit(self, model: nn.Module, train_data: Iterable,
            val_data: Optional[Callable[[], Iterable]] = None) -> TrainState:
        """Train ``model`` for ``max_steps`` optimizer steps.

        :param train_data: re-iterable of batch dicts (numpy arrays or
            tensors), cycled when exhausted.
        :param val_data: zero-argument callable returning a fresh validation
            iterable, called at every validation pass.
        """
        self._open_writers()
        try:
            self.setup_state(model)
            self._fit_loop(_cycle(train_data), val_data)
        finally:
            self._close_writers()
        return self.state

    def _fit_loop(self, stream: Iterator, val_data) -> None:
        cfg = self.config
        train_step = make_train_step(
            self.loss_fn, grad_clip_norm=cfg.grad_clip_norm,
            grad_accum_steps=cfg.grad_accum_steps, device=self.device,
        )
        window: list = []
        t0 = time.time()

        def flush(step_idx: int) -> None:
            nonlocal window, t0
            mean = {k: float(np.mean([float(m[k]) for m in window])) for k in window[0]}
            if self.lr_schedule is not None:
                mean["lr"] = float(self.lr_schedule(step_idx))
            mean["steps_per_sec"] = len(window) / (time.time() - t0)
            self.log_metrics(step_idx, mean, prefix="train/")
            window, t0 = [], time.time()
            if self._policy == "halt" and not np.isfinite(mean["loss"]):
                raise FloatingPointError(
                    f"train loss went non-finite at step {step_idx} ({mean['loss']}); halting"
                )

        for step_idx in range(1, cfg.max_steps + 1):
            batch = next(stream)
            generator = step_generator(cfg.seed, step_idx, self.device)
            self.state, metrics = train_step(self.state, batch, generator)
            window.append(metrics)
            if step_idx % cfg.log_every_n_steps == 0:
                flush(step_idx)
            if val_data is not None and step_idx % cfg.val_check_interval == 0:
                if window:  # a partial window, so steps_per_sec stays honest
                    flush(step_idx)
                val_metrics = self.validate(val_data())
                self.log_metrics(step_idx, val_metrics, prefix="val/")
                if self._ckpt is not None and "loss" in val_metrics:
                    self._ckpt.save(step_idx, self.state.model, self.model_config, val_metrics["loss"])
                self._run_callbacks(step_idx, val_metrics)
                t0 = time.time()

    def _run_callbacks(self, step_idx: int, val_metrics: dict) -> None:
        for cb in self.callbacks:
            try:
                cb(self, self.state, step_idx, val_metrics)
            except Exception:
                self.fault_stats["callback_errors"] += 1
                name = getattr(cb, "__name__", repr(cb))
                print(f"[trainer] validation callback {name} failed at step {step_idx}:\n"
                      f"{traceback.format_exc()}", file=sys.stderr, flush=True)
                self.log_metrics(step_idx, {"callback_errors": self.fault_stats["callback_errors"]})

    def validate(self, val_data: Iterable) -> dict:
        """Deterministic pass over ``val_data`` (at most
        ``limit_val_batches`` batches); mean metrics."""
        limit = self.config.limit_val_batches
        totals: dict = {}
        count = 0
        for i, batch in enumerate(val_data):
            if limit is not None and i >= limit:
                break
            for k, v in self._eval_step(self.state, batch).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        return {k: v / max(1, count) for k, v in totals.items()}
