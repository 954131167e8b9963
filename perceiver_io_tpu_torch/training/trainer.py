"""The training loop: step-based training with periodic validation,
best-``val_loss`` checkpoints, and loss / learning-rate logging (a
``metrics.jsonl`` always, TensorBoard when it can be imported). Counterpart
of ``perceiver_io_tpu/training/trainer.py`` on one device.

Each step's ``torch.Generator`` (prefix, attention and residual dropout) is
seeded from ``(seed, step)``, the role of JAX's ``fold_in``, so a step's
noise does not depend on the steps before it and a resumed run replays it.
Metrics stay on the device until a log flush reads them.

What makes a long run survivable is the JAX loop's, on one device:

- ``save_state_every_n_steps`` snapshots the train state
  (:class:`~.checkpoint.ResumeCheckpointManager`, ``<root>/resume``);
  ``resume=`` continues from the latest snapshot with the data stream
  fast-forwarded, so the losses equal the uninterrupted run's;
- SIGTERM (with snapshots on) finishes the step in flight, snapshots and
  returns, so ``resume=`` continues exactly;
- ``non_finite_policy``: ``halt`` raises at the log flush; ``skip`` drops a
  step whose loss is not finite; ``rollback`` also restores the latest
  snapshot after ``non_finite_rollback_after`` bad steps in a row and replays
  the batches since. Eager PyTorch updates in place, so under these two
  policies the step is taken in halves: gradients and loss, the check (one
  host sync a step, as in JAX), then the update or nothing;
- ``steps_per_execution=N`` runs blocks of N uniform steps with host work
  (logging, snapshots, validation) only at block ends, one logged mean a
  block, singly where a step needs host work;
- ``profile_start`` records ``torch.profiler`` over three steps into
  ``<root>/profile``; the ``chaos=`` registry is consulted once a step at
  ``trainer.step``.

:class:`TrainerConfig` keeps the JAX field names and defaults. Not ported
yet, and raising ``NotImplementedError`` when asked for (``ROADMAP.md`` A):
``shard_seq`` and the tracer and snapshot-writer hooks; the profiler
trigger is not an argument until it is ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import time
import traceback
from collections import deque
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.parallel.train_step import (
    TrainState,
    make_eval_step,
    make_gradient_step,
)
from perceiver_io_tpu_torch.training.checkpoint import BestCheckpointManager, ResumeCheckpointManager
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
    #: run N optimizer steps as one block, host work at its end (JAX's
    #: ``multi_steps``); steps that need host work (validation, snapshots,
    #: profiling) run singly
    steps_per_execution: int = 1
    seed: int = 0
    enable_checkpointing: bool = True
    enable_tensorboard: bool = True
    shard_seq: bool = False
    #: record torch.profiler over the steps [profile_start, profile_start + 3)
    #: into <default_root_dir>/profile (None: off)
    profile_start: Optional[int] = None
    #: snapshot the train state every N steps into <default_root_dir>/resume
    save_state_every_n_steps: Optional[int] = None
    #: continue from the latest snapshot in this directory (a <root>/resume
    #: dir or a root holding one)
    resume: Optional[str] = None
    #: halt (raise) when the mean train loss of a log window is non-finite;
    #: False turns every check off unless non_finite_policy is skip/rollback
    terminate_on_non_finite: bool = True
    #: halt | skip | rollback (module docstring); skip and rollback check
    #: every step's loss (one host sync a step) and run steps singly
    non_finite_policy: str = "halt"
    #: K non-finite steps in a row: rollback restores a snapshot, skip halts
    non_finite_rollback_after: int = 3
    #: raise after this many rollbacks in one fit
    non_finite_max_rollbacks: int = 3


#: steps traced per profiler capture: [profile_start, profile_start + _PROFILE_WINDOW)
_PROFILE_WINDOW = 3


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md A)")


def _check_config(cfg: TrainerConfig) -> str:
    """The effective non-finite policy: ``halt``, ``skip``, ``rollback`` or
    ``off`` (``terminate_on_non_finite=False`` under ``halt``); raises on
    what is not ported."""
    if cfg.non_finite_policy not in ("halt", "skip", "rollback"):
        raise ValueError(f"non_finite_policy must be halt|skip|rollback, got {cfg.non_finite_policy!r}")
    if cfg.shard_seq:
        raise _unported("shard_seq")
    if cfg.non_finite_policy != "halt":
        return cfg.non_finite_policy
    return "halt" if cfg.terminate_on_non_finite else "off"


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of optimizer step ``step``: a pure function of
    ``(seed, step)``."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _shapes(batch) -> list:
    return [tuple(np.shape(batch[k])) for k in sorted(batch)]


def _check_uniform_block(block: list, k_exec: int) -> None:
    """A block of ``steps_per_execution`` batches must share keys and shapes,
    as JAX's stacked block does (JAX's message, with both shape lists)."""
    ref, ref_shapes = sorted(block[0]), _shapes(block[0])
    for i, b in enumerate(block[1:], 1):
        if sorted(b) != ref or _shapes(b) != ref_shapes:
            raise ValueError(
                f"steps_per_execution={k_exec} requires fixed-shape batches, but batch {i} of "
                f"the block has leaves {_shapes(b)} vs the block's first batch {ref_shapes} — "
                "use a loader that drops or pads the last partial batch (built-in loaders use "
                "drop_last=True)"
            )


def _params_finite(model: nn.Module) -> bool:
    """Whether every floating parameter is finite (one host sync)."""
    flags = [torch.isfinite(p).all() for p in model.parameters() if p.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


class _BatchStream:
    """The trainer's seekable view of ``train_data`` (JAX ``_BatchStream``):
    cycles on exhaustion (refusing one-shot generators), counts batches
    handed out (``position``, 0-based), fast-forwards to a resume point and,
    with a replay buffer, rewinds to a recent position so that a rollback
    replays the batches the rolled-back steps took. The rewind replays from
    the buffer and never touches the underlying iterable."""

    def __init__(self, data: Iterable, *, replay_buffer: int = 0):
        self._data = data
        self._iter = iter(data)
        self.position = 0  # index of the next batch next() hands out
        self._pulled = 0  # batches pulled off the underlying iterator
        self._buffer: Optional[deque] = deque(maxlen=replay_buffer) if replay_buffer > 0 else None
        self._replay: deque = deque()

    def _pull(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = iter(self._data)
            try:
                return next(self._iter)
            except StopIteration:
                raise ValueError("train_data is exhausted and not re-iterable (one-shot generator?); "
                                 "pass a list or a loader") from None

    def next(self):
        if self._replay:
            pos, batch = self._replay.popleft()
            self.position = pos + 1
            return batch
        batch = self._pull()
        if self._buffer is not None:
            self._buffer.append((self.position, batch))
        self.position += 1
        self._pulled = self.position
        return batch

    def fast_forward(self, n: int) -> None:
        """Position a fresh stream so the next batch is batch ``n``: in O(1)
        through a loader's ``skip_batches``, else batch by batch."""
        if n <= 0:
            return
        if hasattr(self._data, "skip_batches") and hasattr(self._data, "__len__"):
            self._data.skip_batches(n)
            self._iter = iter(self._data)
            self.position = self._pulled = n
        else:
            for _ in range(n):
                self.next()

    def rewind_to(self, n: int) -> None:
        """Make batch ``n`` the next one again, replaying retained batches;
        everything already pulled must replay from the buffer."""
        if n > self.position:
            raise ValueError(f"rewind_to({n}) is ahead of position {self.position}")
        entries = dict(self._buffer or ())
        entries.update(self._replay)
        wanted = sorted((p, b) for p, b in entries.items() if p >= n)
        if [p for p, _ in wanted] != list(range(n, self._pulled)):
            raise RuntimeError(
                f"rollback to batch {n} exceeds the replay buffer (retained "
                f"{[p for p, _ in wanted]}, pulled {self._pulled}); raise the snapshot cadence "
                "coverage or lower non_finite_rollback_after"
            )
        self._replay = deque(wanted)
        self.position = n


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
    :param chaos: a :class:`~perceiver_io_tpu_torch.reliability.ChaosRegistry`
        consulted once per optimizer step at ``trainer.step``: a ``nan``
        fault replaces the step's reported loss with NaN, an ``error`` fault
        raises at the step boundary.
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
        for what, hook in (("tracer", tracer), ("snapshot_writer", snapshot_writer)):
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
        #: fault-recovery counters over this trainer's lifetime
        self.fault_stats = {"skipped_steps": 0, "rollbacks": 0, "callback_errors": 0}
        self._chaos = chaos
        self._preempted = False
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

    def log_text(self, step: int, tag: str, text: str) -> None:
        """Qualitative text (generated samples) as ``{"step": N, "text":
        {tag: text}}``, so scalar rows stay all-float."""
        if self._metrics_file is None:
            return
        self._metrics_file.write(json.dumps({"step": step, "text": {tag: text}}) + "\n")
        self._metrics_file.flush()
        if self._tb is not None:
            self._tb.add_text(tag, text, step)

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
        """Train ``model`` up to ``max_steps`` optimizer steps.

        :param train_data: re-iterable of batch dicts (numpy arrays or
            tensors; a list or a :class:`~perceiver_io_tpu_torch.data.DataLoader`),
            cycled when exhausted.
        :param val_data: zero-argument callable returning a fresh validation
            iterable, called at every validation pass.
        """
        cfg = self.config
        # SIGTERM (a preemption notice) with snapshots on: finish the step in
        # flight, snapshot, return. Signal handlers exist only in the main
        # thread; elsewhere the fit runs without one, as in JAX.
        prev_handler = None
        self._preempted = False
        self._open_writers()
        if cfg.save_state_every_n_steps is not None:
            def on_sigterm(signum, frame):
                self._preempted = True

            try:
                prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
            except ValueError:  # not the main thread
                prev_handler = None
        try:
            return self._fit_inner(model, train_data, val_data)
        finally:
            self._close_writers()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    @staticmethod
    def _resume_dir(path: str) -> str:
        """A ``<root>/resume`` dir or a root holding one."""
        sub = os.path.join(path, "resume")
        return sub if os.path.isdir(sub) else path

    def _fit_inner(self, model: nn.Module, train_data: Iterable, val_data) -> TrainState:
        cfg = self.config
        if self._policy == "rollback" and cfg.save_state_every_n_steps is None:
            raise ValueError("non_finite_policy='rollback' requires save_state_every_n_steps "
                             "(it restores the latest TrainState snapshot)")
        self.setup_state(model)
        start_step = 1
        if cfg.resume is not None:
            restore = ResumeCheckpointManager(self._resume_dir(cfg.resume), create=False)
            try:
                restore.restore_latest(self.state)
            finally:
                restore.close()
            start_step = self.state.step + 1
            self.log_metrics(start_step - 1, {"resumed_at": start_step - 1})

        resume_mgr: Optional[ResumeCheckpointManager] = None
        if cfg.save_state_every_n_steps is not None:
            resume_mgr = ResumeCheckpointManager(os.path.join(cfg.default_root_dir, "resume"))
        if self._policy == "rollback":
            stale = resume_mgr.latest_step
            if stale is not None and stale > start_step - 1:
                # a snapshot ahead of this run's start comes from an earlier
                # run into the same root: restoring it would graft a foreign
                # trajectory onto this run
                raise ValueError(
                    f"{os.path.join(cfg.default_root_dir, 'resume')} holds a step-{stale} snapshot "
                    f"from a previous run (this run starts at step {start_step}); pass resume= to "
                    "continue that run, or point default_root_dir at a fresh directory"
                )
            if stale is None:  # a restore point before the first periodic save
                resume_mgr.save(start_step - 1, self.state)

        replay = 0
        if self._policy == "rollback":  # one save window, the bad streak and a block
            replay = (cfg.save_state_every_n_steps + cfg.non_finite_rollback_after
                      + cfg.steps_per_execution + 1)
        stream = _BatchStream(train_data, replay_buffer=replay)
        stream.fast_forward(start_step - 1)  # batch n drives step n + 1
        try:
            self._fit_loop(stream, val_data, resume_mgr, start_step)
        finally:
            if resume_mgr is not None:
                resume_mgr.close()
        return self.state

    def _block_ok(self, start: int, k: int, val_data, resume_mgr) -> bool:
        """Whether steps ``[start, start + k - 1]`` may run as one block: no
        step inside it (the last is handled after the block) needs host
        work: validation, a snapshot or the profiler window."""
        cfg = self.config
        if start + k - 1 > cfg.max_steps or self._preempted:
            return False
        if self._policy in ("skip", "rollback"):
            return False
        for idx in range(start, start + k - 1):
            if resume_mgr is not None and idx % cfg.save_state_every_n_steps == 0:
                return False
            if val_data is not None and idx % cfg.val_check_interval == 0:
                return False
        if cfg.profile_start is not None and start + k > cfg.profile_start:
            if start <= cfg.profile_start + _PROFILE_WINDOW - 1:
                return False
        return True

    def _count_fault(self, key: str) -> None:
        self.fault_stats[key] += 1

    def _chaos_step_metrics(self, metrics: dict) -> dict:
        """Consult the chaos registry once for this step: a ``nan`` fault
        replaces the reported loss, an ``error`` fault raises."""
        fault = self._chaos.hit("trainer.step")
        if fault is None:
            return metrics
        if fault.kind == "error":
            raise fault.make_error()
        if fault.kind == "nan":
            metrics = dict(metrics)
            metrics["loss"] = float("nan")
        return metrics

    def _rollback(self, stream: _BatchStream, resume_mgr, step_idx: int) -> int:
        """Restore the latest snapshot and rewind the stream to it; the step
        to continue from. Raises after ``non_finite_max_rollbacks``."""
        cfg = self.config
        self._rollbacks_this_fit += 1
        if self._rollbacks_this_fit > cfg.non_finite_max_rollbacks:
            raise FloatingPointError(
                f"train loss stayed non-finite through {cfg.non_finite_max_rollbacks} rollbacks "
                f"(last at step {step_idx}); halting — lower the lr / tighten grad clip"
            )
        snap_step = resume_mgr.latest_step
        if snap_step is None or snap_step > stream.position:
            raise RuntimeError(f"rollback found no usable snapshot (latest={snap_step}, stream "
                               f"position={stream.position}) — the resume dir was modified mid-run?")
        resume_mgr.restore_latest(self.state)
        stream.rewind_to(snap_step)
        self._count_fault("rollbacks")
        self.log_metrics(step_idx, {"rollback_to_step": snap_step,
                                    "rollbacks": self.fault_stats["rollbacks"]})
        return snap_step + 1

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.config.default_root_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"trace_step{self.config.profile_start}.json"))

    def _fit_loop(self, stream: _BatchStream, val_data, resume_mgr, start_step: int) -> None:
        cfg = self.config
        grads = make_gradient_step(self.loss_fn, grad_clip_norm=cfg.grad_clip_norm,
                                   grad_accum_steps=cfg.grad_accum_steps, device=self.device)
        k_exec = cfg.steps_per_execution
        checking = self._policy in ("skip", "rollback")
        window: list = []
        t0 = time.time()
        profiler = None
        self._bad_streak = 0
        self._rollbacks_this_fit = 0
        snap_after_recovery = False

        def flush(step_idx: int) -> None:
            nonlocal window, t0
            mean = {k: float(np.mean([float(m[k]) for m in window])) for k in window[0]}
            if self.lr_schedule is not None:
                mean["lr"] = float(self.lr_schedule(step_idx))
            mean["steps_per_sec"] = len(window) / (time.time() - t0)
            self.log_metrics(step_idx, mean, prefix="train/")
            window, t0 = [], time.time()
            if self._policy == "halt" and not np.isfinite(mean.get("loss", 0.0)):
                raise FloatingPointError(
                    f"train loss went non-finite at step {step_idx} ({mean['loss']}); halting — "
                    "resume from the last snapshot with a lower lr / grad clip, or set "
                    "non_finite_policy=skip|rollback to recover in place"
                )

        step_idx = start_step
        while step_idx <= cfg.max_steps:
            if k_exec > 1 and self._block_ok(step_idx, k_exec, val_data, resume_mgr):
                block = [stream.next() for _ in range(k_exec)]
                _check_uniform_block(block, k_exec)
                per_step = []
                for i, batch in enumerate(block):  # metrics stay on the device
                    per_step.append(grads(self.state, batch, step_generator(cfg.seed, step_idx + i, self.device)))
                    self.state.apply_gradients()
                n_ran = k_exec
            else:
                batch = stream.next()
                generator = step_generator(cfg.seed, step_idx, self.device)
                if cfg.profile_start is not None and step_idx == cfg.profile_start:
                    profiler = self._start_profile()
                metrics = grads(self.state, batch, generator)
                if not checking:
                    self.state.apply_gradients()
                per_step = [metrics]
                n_ran = 1
                if profiler is not None and step_idx >= cfg.profile_start + _PROFILE_WINDOW - 1:
                    self._stop_profile(profiler)
                    profiler = None

            if self._chaos is not None:
                try:
                    per_step = [self._chaos_step_metrics(m) for m in per_step]
                except BaseException:
                    if checking:  # JAX raises after the step's update
                        self.state.apply_gradients()
                    raise

            if checking:
                # the step's update waits on its loss: one host sync a step
                if not np.isfinite(float(per_step[0].get("loss", 0.0))):
                    self.state.model.zero_grad(set_to_none=True)  # the update is dropped
                    self._bad_streak += 1
                    if self._bad_streak >= cfg.non_finite_rollback_after:
                        if self._policy == "rollback":
                            step_idx = self._rollback(stream, resume_mgr, step_idx)
                            self._bad_streak = 0
                            window, t0 = [], time.time()
                            if self._preempted:  # the restored state is the snapshot
                                self.log_metrics(step_idx, {"preempted_at": step_idx})
                                break
                            continue
                        raise FloatingPointError(
                            f"train loss non-finite for {self._bad_streak} consecutive steps (last "
                            f"at step {step_idx}) under non_finite_policy='skip'; halting — lower "
                            "the lr / tighten grad clip, or use 'rollback' with snapshots"
                        )
                    self._count_fault("skipped_steps")
                    snap_after_recovery = True
                    self.log_metrics(step_idx, {"non_finite_skipped": self.fault_stats["skipped_steps"]})
                    if resume_mgr is not None and self._preempted:
                        if _params_finite(self.state.model):
                            resume_mgr.save(step_idx, self.state)
                        self.log_metrics(step_idx, {"preempted_at": step_idx})
                        break
                    step_idx += 1
                    continue
                self.state.apply_gradients()
                self._bad_streak = 0

            window.extend(per_step)
            step_idx += n_ran - 1  # the bookkeeping below runs at the block's last step
            if window and step_idx % cfg.log_every_n_steps < n_ran and step_idx >= cfg.log_every_n_steps:
                flush(step_idx)

            if resume_mgr is not None and (step_idx % cfg.save_state_every_n_steps == 0
                                           or self._preempted or snap_after_recovery):
                # the loss was taken before the update, which may have
                # overflowed: check the state itself before keeping it
                if self._policy == "off" or _params_finite(self.state.model):
                    resume_mgr.save(step_idx, self.state)
                    snap_after_recovery = False
                elif self._policy == "rollback":
                    self.log_metrics(step_idx, {"snapshot_refused_non_finite": step_idx})
                else:
                    raise FloatingPointError(
                        f"params went non-finite by step {step_idx}; snapshot refused — resume "
                        "from the previous snapshot with a lower lr / grad clip"
                    )
            if resume_mgr is not None and self._preempted:
                self.log_metrics(step_idx, {"preempted_at": step_idx})
                break

            if val_data is not None and step_idx % cfg.val_check_interval == 0:
                if window:  # a partial window, so steps_per_sec stays honest
                    flush(step_idx)
                val_metrics = self.validate(val_data())
                self.log_metrics(step_idx, val_metrics, prefix="val/")
                if self._ckpt is not None and "loss" in val_metrics:
                    self._ckpt.save(step_idx, self.state.model, self.model_config, val_metrics["loss"])
                self._run_callbacks(step_idx, val_metrics)
                t0 = time.time()
            step_idx += 1
        if profiler is not None:  # max_steps ended inside the window
            self._stop_profile(profiler)

    def _run_callbacks(self, step_idx: int, val_metrics: dict) -> None:
        for cb in self.callbacks:
            try:
                cb(self, self.state, step_idx, val_metrics)
            except Exception:
                self._count_fault("callback_errors")
                name = getattr(cb, "__name__", repr(cb))
                print(f"[trainer] validation callback {name} failed at step {step_idx}:\n"
                      f"{traceback.format_exc()}", file=sys.stderr, flush=True)
                self.log_metrics(step_idx, {"callback_errors": self.fault_stats["callback_errors"]})

    def validate(self, val_data: Iterable) -> dict:
        """Deterministic pass over ``val_data`` (at most
        ``limit_val_batches`` batches); mean metrics."""
        return self._evaluate(val_data, self.config.limit_val_batches)

    def test(self, test_data: Iterable) -> dict:
        """Deterministic pass over the test split (at most
        ``limit_test_batches`` batches); mean metrics keyed ``test_*``."""
        metrics = self._evaluate(test_data, self.config.limit_test_batches)
        return {f"test_{k}": v for k, v in metrics.items()}

    def _evaluate(self, data: Iterable, limit: Optional[int]) -> dict:
        totals: dict = {}
        count = 0
        for i, batch in enumerate(data):
            if limit is not None and i >= limit:
                break
            for k, v in self._eval_step(self.state, batch).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        return {k: v / max(1, count) for k, v in totals.items()}
