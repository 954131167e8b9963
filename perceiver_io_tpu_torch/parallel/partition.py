"""Parameter and batch placement rules. Counterpart of
``perceiver_io_tpu/parallel/partition.py``.

The rules are the JAX package's, written on flax parameter paths and in
flax's coordinates: a ``Dense`` kernel is ``(in, out)`` there and the
port's ``Linear.weight`` is ``(out, in)`` (the converter transposes,
``convert/from_jax.py``). :func:`infer_param_specs` therefore names each
port parameter by its flax path, applies the rules to the flax shape and
transposes the spec back, so a column-parallel q/k/v (flax dim 1) shards
the port's dim 0, and FSDP's "largest still-unsharded divisible dim"
breaks a square weight's tie on flax's dim 0, the port's dim 1.

- **Tensor parallelism** (``model`` axis): q/k/v and the MLP's up
  projection column-parallel (their output dim and bias), o and the MLP's
  down projection row-parallel (their input dim; the bias replicated,
  added after the all-reduce).
- **FSDP** (``fsdp`` axis): every parameter of at least ``min_fsdp_size``
  elements is sharded on its largest still-unsharded, evenly divisible
  dimension.

A spec is a :class:`PartitionSpec`: per dimension an axis name, a tuple of
axis names (the batch axes) or None. :class:`ParamPlacement` applies the
specs to a model (each rank keeps its shard as the parameter, which the
optimizer then holds) and gives the tensors a step computes with.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from perceiver_io_tpu_torch.parallel import collectives
from perceiver_io_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_NAMES,
    AXIS_SEQ,
    BATCH_AXES,
    MeshConfig,
)


class PartitionSpec(tuple):
    """Per dimension, the mesh axis (or axes) it is sharded over, or None
    (JAX ``PartitionSpec``; compares as a tuple)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

# (path regex, dim) — dim of the flax kernel to shard over the `model` axis.
# Column-parallel (output dim): q/k/v projections, MLP up-projection.
# Row-parallel (input dim): attention output projection, MLP down-projection.
_TP_KERNEL_RULES: Tuple[Tuple[str, int], ...] = (
    (r"(q_proj|k_proj|v_proj)/kernel$", 1),
    (r"o_proj/kernel$", 0),
    (r"mlp/hidden/kernel$", 1),
    (r"mlp/out/kernel$", 0),
)

# Biases of column-parallel layers follow their kernel's output sharding;
# row-parallel biases stay replicated (added after the allreduce).
_TP_BIAS_RULES: Tuple[str, ...] = (
    r"(q_proj|k_proj|v_proj)/bias$",
    r"mlp/hidden/bias$",
)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a :class:`~.mesh.Mesh`, a :class:`~.mesh.MeshConfig`
    (resolved) or such a dict: the rules need no ranks."""
    if isinstance(mesh, MeshConfig):
        return dict(zip(AXIS_NAMES, mesh.shape))
    if isinstance(mesh, dict):
        return {a: int(mesh.get(a, 1)) for a in AXIS_NAMES}
    return dict(mesh.shape)


def _tp_spec(path: str, shape: Tuple[int, ...], model_size: int) -> list:
    spec: list = [None] * len(shape)
    if model_size <= 1:
        return spec
    for pattern, dim in _TP_KERNEL_RULES:
        if re.search(pattern, path) and shape[dim] % model_size == 0:
            spec[dim] = AXIS_MODEL
            return spec
    for pattern in _TP_BIAS_RULES:
        if re.search(pattern, path) and shape[-1] % model_size == 0:
            spec[-1] = AXIS_MODEL
            return spec
    return spec


def infer_param_spec(path: str, value: Any, mesh, *, min_fsdp_size: int = 2**14) -> PartitionSpec:
    """The spec of one parameter at flax path ``path`` and flax shape
    (``value`` or its shape): TP rules first, then FSDP shards the largest
    remaining dimension. ``min_fsdp_size`` keeps tiny leaves (norms,
    biases) replicated — gathering them costs more than storing them."""
    shape = tuple(value) if isinstance(value, (tuple, list, torch.Size)) else tuple(np.shape(value))
    sizes = axis_sizes(mesh)
    spec = _tp_spec(path, shape, sizes.get(AXIS_MODEL, 1))

    fsdp_size = sizes.get(AXIS_FSDP, 1)
    if fsdp_size > 1 and int(np.prod(shape, dtype=np.int64)) >= min_fsdp_size:
        dims = sorted(range(len(shape)), key=lambda d: shape[d], reverse=True)
        for d in dims:
            if spec[d] is None and shape[d] % fsdp_size == 0:
                spec[d] = AXIS_FSDP
                break
    return P(*spec)


_FLAX_LEAF = {nn.Linear: {"weight": "kernel"}, nn.LayerNorm: {"weight": "scale"},
              nn.Embedding: {"weight": "embedding"}}


def flax_path(model: nn.Module, name: str) -> Tuple[str, bool]:
    """``(flax path, transposed)`` of the port parameter ``name``: the
    weight bridge's map read backwards (``layers.<i>`` -> ``layers_<i>``,
    ``Linear.weight`` -> ``kernel``, transposed)."""
    mod_name, _, leaf = name.rpartition(".")
    module = model.get_submodule(mod_name) if mod_name else model
    flax_leaf = leaf
    for cls, leaves in _FLAX_LEAF.items():
        if isinstance(module, cls):
            flax_leaf = leaves.get(leaf, leaf)
    parts = re.sub(r"(^|\.)layers\.(\d+)(?=\.|$)", r"\1layers_\2", mod_name).split(".") if mod_name else []
    return "/".join(parts + [flax_leaf]), flax_leaf == "kernel"


def infer_param_specs(model: nn.Module, mesh, *, min_fsdp_size: int = 2**14) -> Dict[str, PartitionSpec]:
    """``{parameter name: spec}`` in the port's coordinates (module
    docstring), one entry per parameter of ``named_parameters()``."""
    specs = {}
    for name, p in model.named_parameters():
        path, transposed = flax_path(model, name)
        shape = tuple(p.shape)[::-1] if transposed else tuple(p.shape)
        spec = infer_param_spec(path, shape, mesh, min_fsdp_size=min_fsdp_size)
        specs[name] = P(*tuple(spec)[::-1]) if transposed else spec
    return specs


class Sharding:
    """A spec on a mesh (JAX ``NamedSharding``): which slice of a global
    array this rank holds."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r})"

    def local_slices(self, shape: Tuple[int, ...]) -> Tuple[slice, ...]:
        out = []
        for dim, size in enumerate(shape):
            entry = self.spec[dim] if dim < len(self.spec) else None
            if entry is None:
                out.append(slice(None))
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = self.mesh.axis_size(*axes)
            if size % n:
                raise ValueError(f"dim {dim} of {shape} does not divide {axes} ({n})")
            i = self.mesh.axis_index(*axes)
            out.append(slice(i * size // n, (i + 1) * size // n))
        return tuple(out)

    def local(self, x):
        """This rank's slice of the global ``x`` (numpy or tensor)."""
        return x[self.local_slices(tuple(np.shape(x)))]


def param_shardings(model_or_specs, mesh) -> Dict[str, Sharding]:
    """``{name: Sharding}`` for a model (its inferred specs) or a dict of
    specs."""
    specs = model_or_specs if isinstance(model_or_specs, dict) else infer_param_specs(model_or_specs, mesh)
    return {name: Sharding(mesh, spec) for name, spec in specs.items()}


def shard_params(model: nn.Module, mesh, *, min_fsdp_size: int = 2**14) -> "ParamPlacement":
    """Place ``model``'s parameters on the mesh by the inferred specs: rank
    0's values reach every rank by a broadcast, and each rank keeps its
    shard as the parameter (the moment FSDP materializes its shards)."""
    placement = ParamPlacement(model, mesh, min_fsdp_size=min_fsdp_size)
    placement.shard_(model)
    return placement


def _spec_dim(spec: PartitionSpec, axis: str) -> Optional[int]:
    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


class ParamPlacement:
    """The specs of a model's parameters on a mesh and what a step does
    with them.

    Storage follows JAX's specs exactly: each rank holds its slice over
    ``fsdp`` and ``model``. For the computation each parameter is gathered
    over ``fsdp`` (gradient reduce-scattered back); over ``model`` a
    parameter stays local where its layer runs tensor-parallel (an attention
    whose heads divide the axis, an MLP whose hidden width does) and is
    gathered where it does not: JAX keeps a leaf that does not divide
    replicated beside sharded neighbours, and a layer with such a mixed
    layout (an attention of one head whose 16 q/k channels shard) runs
    whole on every rank of the group.
    """

    def __init__(self, model: nn.Module, mesh, *, min_fsdp_size: int = 2**14,
                 specs: Optional[Dict[str, PartitionSpec]] = None):
        from perceiver_io_tpu_torch.models.core.modules import MLP, MultiHeadAttention

        self.mesh = mesh
        self.specs = specs if specs is not None else infer_param_specs(model, mesh, min_fsdp_size=min_fsdp_size)
        self.full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        model_size = mesh.shape[AXIS_MODEL]
        #: module names of the layers that run tensor-parallel
        self.tp_layers = []
        local_model: set = set()
        for mod_name, module in model.named_modules():
            if model_size == 1:
                break
            if isinstance(module, MultiHeadAttention):
                runs = module.num_heads % model_size == 0
            elif isinstance(module, MLP):
                runs = module.hidden.out_features % model_size == 0
            else:
                continue
            if runs:
                self.tp_layers.append(mod_name)
                local_model.update(f"{mod_name}.{n}" for n, _ in module.named_parameters())
        self._local_model = local_model

    def fsdp_dim(self, name: str) -> Optional[int]:
        return _spec_dim(self.specs[name], AXIS_FSDP)

    def model_dim(self, name: str) -> Optional[int]:
        return _spec_dim(self.specs[name], AXIS_MODEL)

    def gathers_model(self, name: str) -> bool:
        """Whether the step gathers ``name`` over ``model`` (its layer does
        not run tensor-parallel)."""
        return self.model_dim(name) is not None and name not in self._local_model

    def sharded_axes(self, name: str) -> Tuple[str, ...]:
        return tuple(a for a in (AXIS_FSDP, AXIS_MODEL) if _spec_dim(self.specs[name], a) is not None)

    def grad_axes(self, name: str) -> Tuple[str, ...]:
        """The axes a parameter's gradient is summed over after the
        backward: the batch axes, less ``fsdp`` where the gather's
        reduce-scatter summed it already."""
        return (AXIS_DATA,) if self.fsdp_dim(name) is not None else BATCH_AXES

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return Sharding(self.mesh, self.specs[name]).local(full)

    def shard_(self, model: nn.Module) -> None:
        """Broadcast rank 0's parameters over the mesh and keep each rank's
        shard as the parameter, in place."""
        group = self.mesh.group(*AXIS_NAMES)
        with torch.no_grad():
            for name, p in model.named_parameters():
                collectives.broadcast(p.data, group, src=0)
                if any(e is not None for e in self.specs[name]):
                    p.data = self.local(name, p.data).clone()

    def attach(self, model: nn.Module) -> None:
        """Give the tensor-parallel layers their group (``module.tp``)."""
        if not self.tp_layers:
            return
        tp = collectives.TensorParallel(self.mesh.group(AXIS_MODEL))
        for mod_name in self.tp_layers:
            model.get_submodule(mod_name).tp = tp

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole parameter (or a tensor of its placement, an optimizer
        moment), gathered over every sharded axis; no gradient."""
        t = shard
        for axis in (AXIS_FSDP, AXIS_MODEL):
            d = _spec_dim(self.specs[name], axis)
            if d is not None:
                t = collectives.all_gather(t, self.mesh.group(axis), dim=d)
        return t

    def _gather(self, named) -> Dict[str, torch.Tensor]:
        """The whole tensor of every sharded parameter: the FSDP shards of
        one type in one all-gather, then the ``model`` gathers."""
        full: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            by_type: Dict[torch.dtype, list] = {}
            for name, p in named:
                if self.fsdp_dim(name) is not None:
                    by_type.setdefault(p.dtype, []).append((name, p))
            for items in by_type.values():
                fulls = collectives.all_gather_flat([p.detach() for _, p in items], self.mesh.group(AXIS_FSDP),
                                                    [self.fsdp_dim(n) for n, _ in items])
                full.update((n, t) for (n, _), t in zip(items, fulls))
            for name, p in named:
                if self.gathers_model(name):
                    full[name] = collectives.all_gather(full.get(name, p.detach()), self.mesh.group(AXIS_MODEL),
                                                        dim=self.model_dim(name))
        return full

    @contextlib.contextmanager
    def computing(self, model: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
        """Within the block the model's modules read whole tensors in place of
        their shards (forward, and the backward's recomputes): leaves of the
        autograd graph, gathered once however many microbatches the block
        runs, their gradients accumulating there until
        :meth:`scatter_grads`. Yields the leaves by name; the shards come
        back after the block."""
        named = list(model.named_parameters())
        params = dict(named)
        leaves = {n: t.requires_grad_(params[n].requires_grad) for n, t in self._gather(named).items()}
        by_id = {id(p): leaves[n] for n, p in named if n in leaves}
        swapped = []
        for module in model.modules():
            for key, p in list(module._parameters.items()):
                if p is not None and id(p) in by_id:
                    swapped.append((module, key, p))
                    module._parameters[key] = by_id[id(p)]
        try:
            yield leaves
        finally:
            for module, key, p in swapped:
                module._parameters[key] = p

    def scatter_grads(self, model: nn.Module, leaves: Dict[str, torch.Tensor]) -> None:
        """Each whole tensor's gradient back to its parameter's shard: its
        slice over ``model`` where the layer ran whole on every rank (their
        gradients are equal), summed over ``fsdp`` and scattered (one
        reduce-scatter a type). A parameter no loss reached keeps no
        gradient, on every rank alike."""
        by_type: Dict[torch.dtype, list] = {}
        for name, p in model.named_parameters():
            g = leaves[name].grad if name in leaves else None
            if g is None:
                continue
            if self.gathers_model(name):
                group = self.mesh.group(AXIS_MODEL)
                g = g.chunk(collectives.group_size(group), dim=self.model_dim(name))[collectives.group_rank(group)]
            if self.fsdp_dim(name) is not None:
                by_type.setdefault(p.dtype, []).append((name, p, g))
            else:
                p.grad = g.contiguous() if p.grad is None else p.grad + g
        for items in by_type.values():
            shards = collectives.reduce_scatter_flat([g for _, _, g in items], self.mesh.group(AXIS_FSDP),
                                                     [self.fsdp_dim(n) for n, _, _ in items])
            for (_, p, _), s in zip(items, shards):
                p.grad = s.contiguous() if p.grad is None else p.grad + s


# -- serving KV / slot-state rules (docs/serving.md "Sharded serving") ------
#
# The slot engine's persistent decode state is the serving-side analogue of
# the param tree: named leaves with fixed layouts. Attention heads (dense
# per-slot caches, the paged pool's flat ``pool_k``/``pool_v``, the chunked
# prefill's staging caches) shard along ``model``; the slot dimension along
# ``data``. Pool arrays are not data-sharded: block tables address one shared
# pool. A dimension that does not divide its axis replicates.
#
# (name regex, per-dim axis template), matched against the leaf's path
# ("stack_k/0" for tuple entries).
SERVING_STATE_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # (pool_tokens, heads, head_dim): shared across slots, heads sharded
    (r"^(pool_k|pool_v)$", (None, AXIS_MODEL, None)),
    # (pool_tokens, heads, 1) int8-layout dequant scales
    (r"^(scale_k|scale_v)$", (None, AXIS_MODEL, None)),
    # (1, heads, n, head_dim) batch-1 staging caches (chunked prefill)
    (r"^(stage_k|stage_v)$", (None, AXIS_MODEL, None, None)),
    # (slots, heads, n, head_dim) dense per-slot caches
    (r"^(cross_k|cross_v|stack_k|stack_v)(/\d+)?$",
     (AXIS_DATA, AXIS_MODEL, None, None)),
    # (slots, n) / (slots, vocab) / (slots, pages)
    (r"^(window|logits|table)$", (AXIS_DATA, None)),
    # (slots,) per-row vectors (and the decode step's token output)
    (r"^(pad|length|m|steps|tokens)$", (AXIS_DATA,)),
)


def serving_state_spec(name: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """The spec of one slot-state leaf by name. Unknown names and
    non-divisible dimensions replicate."""
    sizes = axis_sizes(mesh)
    for pattern, template in SERVING_STATE_RULES:
        if re.search(pattern, name):
            spec: list = [None] * len(shape)
            for dim, axis in enumerate(template[: len(shape)]):
                if axis is None:
                    continue
                size = sizes.get(axis, 1)
                if size > 1 and shape[dim] % size == 0:
                    spec[dim] = axis
            return P(*spec)
    return P()


def _state_leaves(state, prefix: str = ""):
    if isinstance(state, dict):
        for k, v in state.items():
            yield from _state_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(state, (tuple, list)):
        for i, v in enumerate(state):
            yield from _state_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, state


def serving_state_specs(state, mesh) -> Dict[str, PartitionSpec]:
    """``{leaf path: spec}`` of a slot-engine state (a dict whose values
    are arrays or tuples of them; a tuple entry's path is ``name/i``)."""
    return {path: serving_state_spec(path, tuple(np.shape(v)), mesh) for path, v in _state_leaves(state)}


def batch_spec(mesh, *, ndim: int = 2, shard_seq: bool = False, stacked_steps: bool = False) -> PartitionSpec:
    """The spec of a batch array: leading dim over (data, fsdp), and
    optionally the sequence dim over ``seq`` (context parallelism).
    ``stacked_steps`` marks arrays with an extra leading steps dim —
    ``(n_steps, batch, ...)`` for ``multi_steps`` — never sharded."""
    spec: list = [BATCH_AXES] + [None] * (ndim - 1)
    if stacked_steps:
        spec = [None, BATCH_AXES] + [None] * (ndim - 2)
    seq_dim = 2 if stacked_steps else 1
    if shard_seq and ndim > seq_dim and axis_sizes(mesh).get(AXIS_SEQ, 1) > 1:
        spec[seq_dim] = AXIS_SEQ
    return P(*spec)


def batch_sharding(mesh, *, ndim: int = 2, shard_seq: bool = False, stacked_steps: bool = False) -> Sharding:
    return Sharding(mesh, batch_spec(mesh, ndim=ndim, shard_seq=shard_seq, stacked_steps=stacked_steps))


def shard_batch(batch, mesh, *, shard_seq: bool = False, stacked_steps: bool = False):
    """This rank's part of a global host batch (a dict of arrays or
    tensors): its rows over the batch axes and, with ``shard_seq``, its
    sequence chunk (:func:`batch_spec`)."""
    mesh.check_member()
    return {k: batch_sharding(mesh, ndim=np.ndim(v), shard_seq=shard_seq,
                              stacked_steps=stacked_steps).local(v)
            for k, v in batch.items()}
