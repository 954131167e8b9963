"""The training step, on one device or over a mesh. Counterpart of
``perceiver_io_tpu/parallel/train_step.py``: a :class:`TrainState` (step,
model, optimizer, scheduler and, under a mesh, the parameters'
placement), :func:`create_train_state`, :func:`make_gradient_step`,
:func:`make_train_step` and :func:`make_eval_step`.

PyTorch runs eagerly, so the step is a plain function that updates the
state in place (the model's parameters and the optimizer's moments) and
returns it. It is two halves: the gradients and metrics
(:func:`make_gradient_step`), then the update (``TrainState.apply_gradients``);
a caller that must look at the loss before the update (the trainer's
``skip`` and ``rollback`` policies) runs them apart. Metrics are device
tensors; nothing in the step waits for the device. ``multi_steps=N`` runs N
optimizer steps per call over stacked batches, a loop in place of JAX's
``lax.scan``, with stacked metrics left on the device.

Under a mesh (:func:`create_train_state` places the state; each rank runs
the step on its part of the batch, as ``torchrun`` runs one process per
device) the step gives the single-device trajectory:

- the loss functions' means are global (``collectives.batch_mean``: each
  rank's share of the global masked mean), and the shares and their
  gradients are summed over ``data`` x ``fsdp``; a loss function that
  takes its own means is averaged over the ranks instead;
- FSDP parameters are gathered once a step before the forward (one
  all-gather a type) and their gradients, accumulated over the
  microbatches, reduce-scattered after the backward (one reduce-scatter);
  tensor-parallel layers run on their share of the heads or hidden width
  (``models/core/modules.py``);
- with ``shard_seq`` each rank's sequence chunk is gathered at the model's
  input, and the attends of a model built with ``attention_impl="ring"``
  run the ring over ``seq`` (every other computation is repeated on the
  ``seq`` ranks: only attention's k/v are split);
- gradients are clipped by the global norm after the reduction;
- LAMB's trust ratios take each parameter's whole norm: a shard's squared
  norms are summed over the axes it is sharded on (:func:`_whole_norms`);
- microbatch ``i`` of ``grad_accum_steps`` is global rows
  ``[i·n/A, (i+1)·n/A)``, sharded over the batch axes, as JAX's;
- a rank's dropout and prefix noise are its rows (and, in a
  tensor-parallel attention, heads) of the global draw
  (``ops.attention.draw_view``).

A world of one is the unsharded step bit for bit: every collective over a
group of one is no call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.ops.attention import draw_view
from perceiver_io_tpu_torch.parallel import collectives
from perceiver_io_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_FSDP, AXIS_NAMES, AXIS_SEQ, BATCH_AXES
from perceiver_io_tpu_torch.parallel.partition import ParamPlacement, Sharding

if TYPE_CHECKING:  # the training package imports this module
    from perceiver_io_tpu_torch.training.optim import OptimizerFactory
    from perceiver_io_tpu_torch.training.tasks import LossFn


@dataclass
class TrainState:
    """Step counter, model (the parameters), optimizer, optional
    learning-rate scheduler and, under a mesh, the parameters' placement
    (the model then holds this rank's shards, and the optimizer's moments
    take their placement: JAX's ZeRO-style state)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    placement: Optional[ParamPlacement] = None

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerFactory) -> "TrainState":
        optimizer, scheduler = tx(model)
        return cls(step=0, model=model, optimizer=optimizer, scheduler=scheduler)

    @property
    def mesh(self):
        return None if self.placement is None else self.placement.mesh

    def _named_params(self) -> List[Tuple[str, nn.Parameter]]:
        return list(self.model.named_parameters())

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's ``state_dict`` on the CPU (under a mesh
        gathered: every rank takes part)."""
        sd = self.model.state_dict()
        if self.placement is not None:
            for name, p in self._named_params():
                sd[name] = self.placement.full(name, p.detach())
        return {k: v.detach().cpu() for k, v in sd.items()}

    def _moment_names(self) -> Dict[int, str]:
        """Optimizer state index -> parameter name (``state_dict`` order)."""
        names = {id(p): n for n, p in self._named_params()}
        flat = [p for g in self.optimizer.param_groups for p in g["params"]]
        return {i: names[id(p)] for i, p in enumerate(flat)}

    def optimizer_state_dict(self) -> dict:
        """The optimizer's ``state_dict`` with whole moments (gathered under
        a mesh), tensors on the CPU."""
        from perceiver_io_tpu_torch.training.checkpoint import _to_cpu  # training imports this module

        sd = self.optimizer.state_dict()
        if self.placement is not None:
            names = self._moment_names()
            for i, st in sd["state"].items():
                sd["state"][i] = {k: (self.placement.full(names[i], v)
                                      if torch.is_tensor(v) and v.dim() > 0 else v)
                                  for k, v in st.items()}
        return _to_cpu(sd)

    def snapshot(self) -> dict:
        """The whole train state as the resume snapshots hold it: the same
        on any mesh or none."""
        return {
            "step": int(self.step),
            "model": self.model_state_dict(),
            "optimizer": self.optimizer_state_dict(),
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
        }

    def load_model_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a whole model ``state_dict`` (each rank keeps its shards)."""
        if self.placement is not None:
            sd = dict(sd)
            for name in self.placement.specs:
                sd[name] = self.placement.local(name, sd[name])
        self.model.load_state_dict(sd, strict=True)

    def restore(self, snap: Mapping[str, Any]) -> "TrainState":
        """Load a :meth:`snapshot` (taken on any mesh or none)."""
        self.load_model_state_dict(snap["model"])
        opt = snap["optimizer"]
        if self.placement is not None:
            names = self._moment_names()
            opt = {**opt, "state": {i: {k: (self.placement.local(names[i], v)
                                             if torch.is_tensor(v) and v.dim() > 0 else v)
                                         for k, v in st.items()}
                                     for i, st in opt["state"].items()}}
        self.optimizer.load_state_dict(opt)
        if self.scheduler is not None:
            if snap["scheduler"] is None:
                raise ValueError("the snapshot holds no scheduler state, the live state has one")
            self.scheduler.load_state_dict(snap["scheduler"])
        self.step = snap["step"]
        return self

    def params_finite(self) -> bool:
        """Whether every floating parameter is finite, on every rank."""
        flags = [torch.isfinite(p).all() for p in self.model.parameters() if p.is_floating_point()]
        ok = torch.stack(flags).all() if flags else torch.tensor(True)
        if self.placement is not None:
            ok = collectives.all_reduce(ok.to(torch.int32), self.mesh.group(*AXIS_NAMES), op="min")
        return bool(ok)

    def apply_gradients(self) -> "TrainState":
        """One update from the gradients in the parameters' ``.grad``."""
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
        return self


def state_shardings(state_or_model, mesh, *, min_fsdp_size: int = 2**14) -> Dict[str, Sharding]:
    """``{parameter name: Sharding}`` of a train state (its placement) or
    a model (its inferred specs); an optimizer moment takes its
    parameter's."""
    if isinstance(state_or_model, TrainState) and state_or_model.placement is not None:
        specs = state_or_model.placement.specs
    else:
        from perceiver_io_tpu_torch.parallel.partition import infer_param_specs

        model = state_or_model.model if isinstance(state_or_model, TrainState) else state_or_model
        specs = infer_param_specs(model, mesh, min_fsdp_size=min_fsdp_size)
    return {name: Sharding(mesh, spec) for name, spec in specs.items()}


def create_train_state(model: nn.Module, tx: OptimizerFactory, mesh, *, min_fsdp_size: int = 2**14,
                       initial_params: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Tuple[TrainState, Dict[str, Sharding]]:
    """Place ``model`` on ``mesh`` and build its train state.

    Rank 0's parameters (``initial_params`` loaded first when given)
    reach every rank by a broadcast; each rank then keeps its shard of each
    parameter by the specs (:func:`~.partition.infer_param_specs`), the
    tensor-parallel layers get their group, and the optimizer is built
    over the shards, so its moments take their parameter's placement. A
    :class:`~perceiver_io_tpu_torch.training.optim.Lamb` over sharded
    parameters gets the reducer of whole norms (:func:`_whole_norms`).

    :return: ``(state, shardings)``, the second :func:`state_shardings`.
    """
    from perceiver_io_tpu_torch.training.optim import Lamb

    mesh.check_member()
    devices = {p.device for p in model.parameters()}
    if devices != {mesh.device}:
        raise ValueError(f"the model lies on {sorted(map(str, devices))}, the mesh's rank on {mesh.device}")
    if initial_params is not None:
        model.load_state_dict(initial_params, strict=True)
    placement = ParamPlacement(model, mesh, min_fsdp_size=min_fsdp_size)
    placement.shard_(model)
    placement.attach(model)
    state = TrainState.create(model, tx)
    state.placement = placement
    if isinstance(state.optimizer, Lamb) and any(placement.sharded_axes(n) for n in placement.specs):
        state.optimizer.norm_reducer = _whole_norms(placement, model)
    return state, state_shardings(state, mesh)


def to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


def make_gradient_step(
    loss_fn: LossFn,
    *,
    grad_clip_norm: Optional[float] = None,
    grad_accum_steps: int = 1,
    device: DeviceLike = "cuda",
    mesh: Any = None,
    shard_seq: bool = False,
) -> Callable[[TrainState, Mapping[str, Any], Optional[torch.Generator]], dict]:
    """Build ``grads(state, batch, generator) -> metrics``: the first half of
    the train step. It leaves the (accumulated, clipped) gradients in the
    parameters' ``.grad`` and changes nothing else; ``state.apply_gradients()``
    is the second half. Arguments as :func:`make_train_step`'s."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if mesh is not None:
        return _sharded_gradient_step(loss_fn, mesh, grad_clip_norm=grad_clip_norm,
                                      grad_accum_steps=grad_accum_steps, shard_seq=shard_seq)
    dev = resolve_device(device)

    def grads(state: TrainState, batch: Mapping[str, Any],
              generator: Optional[torch.Generator] = None) -> dict:
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
            params = [p for p in model.parameters() if p.grad is not None]
            metrics["grad_norm"] = torch.nn.utils.clip_grad_norm_(params, grad_clip_norm)
        return metrics

    return grads


def make_train_step(
    loss_fn: LossFn,
    *,
    grad_clip_norm: Optional[float] = None,
    grad_accum_steps: int = 1,
    multi_steps: int = 1,
    mesh: Any = None,
    shard_seq: bool = False,
    device: DeviceLike = "cuda",
) -> Callable[[TrainState, Any, Any], Tuple[TrainState, dict]]:
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
        activation memory is one microbatch's. The microbatches draw from
        the one generator in turn (JAX splits the key per microbatch).
    :param multi_steps: with N > 1 the returned function runs N optimizer
        steps per call: ``step(state, batches, generators) -> (state,
        metrics)`` where every batch entry has a leading N dim (numpy
        stacked, as JAX's), ``generators`` holds N generators (or is None)
        and every metric comes back stacked ``(N,)`` on the device.
    :param mesh: run over this mesh (module docstring); the state comes
        from :func:`create_train_state` and each batch is this rank's part,
        placed by :func:`~.partition.shard_batch` or
        :func:`~.multihost.shard_or_assemble` (``stacked_steps=True`` for
        ``multi_steps``). Batches go to the mesh's device.
    :param shard_seq: the batches' sequence dim is sharded over ``seq``.
    :param device: where batches go; ``"cuda"`` by default, the CPU only
        when asked for.
    """
    if multi_steps < 1:
        raise ValueError(f"multi_steps must be >= 1, got {multi_steps}")
    grads = make_gradient_step(loss_fn, grad_clip_norm=grad_clip_norm,
                               grad_accum_steps=grad_accum_steps, device=device, mesh=mesh,
                               shard_seq=shard_seq)

    def step(state: TrainState, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None):
        metrics = grads(state, batch, generator)
        return state.apply_gradients(), metrics

    if multi_steps == 1:
        return step

    def multi(state: TrainState, batches: Mapping[str, Any],
              generators: Optional[Sequence[Optional[torch.Generator]]] = None):
        if generators is None:
            generators = [None] * multi_steps
        if len(generators) != multi_steps:
            raise ValueError(f"{len(generators)} generators for multi_steps={multi_steps}")
        per_step = []
        for i in range(multi_steps):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()}, generators[i])
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return multi


def make_eval_step(loss_fn: LossFn, *, device: DeviceLike = "cuda", mesh: Any = None,
                   shard_seq: bool = False):
    """``(state, batch) -> metrics`` with the deterministic loss, no grad;
    under a mesh the batch is this rank's part and the metrics the global
    batch's."""
    if mesh is not None:
        def sharded(state: TrainState, batch: Mapping[str, Any]) -> dict:
            with torch.no_grad():
                metrics = _sharded_pass(loss_fn, state, mesh, batch, None, 1, shard_seq)[0]
            return metrics

        return sharded
    dev = resolve_device(device)

    def step(state: TrainState, batch: Mapping[str, Any]) -> dict:
        with torch.no_grad():
            loss, metrics = loss_fn(state.model, to_device(batch, dev), None)
        return {"loss": loss, **metrics}

    return step


def _batch_rows(batch: Dict[str, torch.Tensor]) -> int:
    return next(iter(batch.values())).shape[0]


def _microbatches(batch: Dict[str, torch.Tensor], mesh, accum: int) -> List[Tuple[dict, int, int]]:
    """``[(rows, offset, total)]`` of each microbatch for this rank: its
    rows of global rows ``[i·n/A, (i+1)·n/A)`` (JAX's microbatch ``i``),
    where they start in that microbatch and its global row count."""
    groups, g = mesh.axis_size(*BATCH_AXES), mesh.axis_index(*BATCH_AXES)
    local = _batch_rows(batch)
    if local % accum:
        raise ValueError(f"batch dim {local * groups} not divisible by grad_accum_steps={accum}")
    if accum > 1 and groups > 1:  # regroup: microbatch i spans every rank's rows
        group = mesh.group(*BATCH_AXES)
        batch = {k: collectives.all_gather(v, group, dim=0) for k, v in batch.items()}
    size = local // accum  # this rank's rows of one microbatch
    out = []
    for i in range(accum):
        start = i * size * groups + g * size if accum > 1 and groups > 1 else i * size
        out.append(({k: v[start:start + size] for k, v in batch.items()}, g * size, size * groups))
    return out


def _sharded_pass(loss_fn: LossFn, state: TrainState, mesh, batch: Mapping[str, Any],
                  generator: Optional[torch.Generator], accum: int, shard_seq: bool,
                  backward: bool = False) -> Tuple[dict, bool]:
    """The forward (and backward) of one step on this rank; returns the
    global metrics (loss first) and whether the loss took its means
    through ``batch_mean``."""
    placement = state.placement
    if placement is None or placement.mesh is not mesh:
        raise ValueError("the train state was not placed on this mesh (create_train_state)")
    model = state.model
    batch = to_device(batch, mesh.device)
    if shard_seq and mesh.shape[AXIS_SEQ] > 1:  # the chunks gathered at the model's input
        group = mesh.group(AXIS_SEQ)
        batch = {k: collectives.all_gather(v, group, dim=1) if v.dim() >= 2 else v for k, v in batch.items()}
    bgroup = mesh.group(*BATCH_AXES)
    values, used = [], True
    with mesh, placement.computing(model) as leaves:  # the parameters gathered once a step
        for micro, offset, total in _microbatches(batch, mesh, accum):
            with collectives.batch_reduction(bgroup) as ctx, draw_view(0, offset, total):
                loss, metrics = loss_fn(model, micro, generator)
                if backward:
                    loss.backward()
            used = used and ctx.used
            values.append(torch.stack([loss.detach()] + [m.detach().float() for m in metrics.values()]))
    if backward:
        placement.scatter_grads(model, leaves)
    keys = ["loss"] + list(metrics)
    stacked = torch.stack(values)  # (accum, 1 + metrics): one reduction for all of them
    stacked = collectives.all_reduce(stacked, bgroup)
    if not used:
        stacked = stacked / mesh.axis_size(*BATCH_AXES)
    means = stacked[0] if accum == 1 else stacked.mean(dim=0)
    return {k: means[i] for i, k in enumerate(keys)}, used


def _reduce_grads(state: TrainState, mean_over: int) -> None:
    """Sum each gradient over its batch axes (one flat all-reduce a group
    of parameters), then divide by ``mean_over``."""
    placement, mesh = state.placement, state.mesh
    buckets: Dict[Tuple[str, ...], list] = {}
    for name, p in state.model.named_parameters():
        if p.grad is not None:
            buckets.setdefault(placement.grad_axes(name), []).append(p.grad)
    for axes, grads in buckets.items():
        group = mesh.group(*axes)
        if group is not None:
            flat = collectives.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        if mean_over != 1:
            torch._foreach_div_(grads, float(mean_over))


def _clip(state: TrainState, clip: float) -> torch.Tensor:
    """Clip by the global gradient norm (``g * min(1, clip / (norm +
    1e-6))``, as ``clip_grad_norm_``) and return the norm. A sharded
    gradient's squares are summed over the axes it is sharded on."""
    placement, mesh = state.placement, state.mesh
    named = [(n, p.grad) for n, p in state.model.named_parameters() if p.grad is not None]
    sharded: Dict[Tuple[str, ...], list] = {}
    replicated = []
    for name, g in named:
        axes = placement.sharded_axes(name)
        (sharded.setdefault(axes, []) if axes else replicated).append(g)
    if not sharded:  # every gradient whole on every rank: the single-device formula
        return torch.nn.utils.clip_grad_norm_([p for p in state.model.parameters() if p.grad is not None],
                                              clip)
    sq = torch.zeros((), dtype=torch.float32, device=mesh.device)
    if replicated:
        sq = sq + torch.stack([g.float().pow(2).sum() for g in replicated]).sum()
    for axes, grads in sharded.items():
        part = torch.stack([g.float().pow(2).sum() for g in grads]).sum()
        sq = sq + collectives.all_reduce(part, mesh.group(*axes))
    norm = sq.sqrt()
    scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
    torch._foreach_mul_([g for _, g in named], scale)
    return norm


def _whole_norms(placement: ParamPlacement, model: nn.Module):
    """LAMB's norm reducer over ``placement``: the squared norms of the
    parameters sharded on one tuple of axes, stacked, in one all-reduce over
    those axes a step (as :func:`_clip` sums a sharded gradient's squares);
    a replicated parameter keeps its local norm."""
    axes_of = {id(p): placement.sharded_axes(n) for n, p in model.named_parameters()}
    mesh = placement.mesh

    def reduce(params: List[torch.Tensor], sq: torch.Tensor) -> torch.Tensor:
        rows: Dict[Tuple[str, ...], List[int]] = {}
        for i, p in enumerate(params):
            if axes_of[id(p)]:
                rows.setdefault(axes_of[id(p)], []).append(i)
        if not rows:
            return sq
        sq = sq.clone()
        for axes, index in rows.items():
            sq[index] = collectives.all_reduce(sq[index], mesh.group(*axes))
        return sq

    return reduce


def _sharded_gradient_step(loss_fn: LossFn, mesh, *, grad_clip_norm: Optional[float],
                           grad_accum_steps: int, shard_seq: bool):
    mesh.check_member()

    def grads(state: TrainState, batch: Mapping[str, Any],
              generator: Optional[torch.Generator] = None) -> dict:
        state.model.zero_grad(set_to_none=True)
        metrics, used = _sharded_pass(loss_fn, state, mesh, batch, generator, grad_accum_steps,
                                      shard_seq, backward=True)
        _reduce_grads(state, 1 if used else mesh.axis_size(*BATCH_AXES))
        if grad_accum_steps > 1:
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad.div_(grad_accum_steps)
        if grad_clip_norm is not None:
            metrics["grad_norm"] = _clip(state, grad_clip_norm)
        return metrics

    return grads
