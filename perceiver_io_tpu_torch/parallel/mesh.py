"""The device mesh over ``torch.distributed``. Counterpart of
``perceiver_io_tpu/parallel/mesh.py``.

One process (a rank) owns one device, as under ``torchrun``. A
:class:`Mesh` lays the ranks out on the JAX package's four named axes:

- ``data``: the batch is sharded, everything else replicated (DDP);
- ``fsdp``: the batch, the parameters and the optimizer state are sharded
  (ZeRO-3/FSDP); ``data`` and ``fsdp`` shard the batch together;
- ``model``: tensor parallelism (attention heads, the MLP's hidden width);
- ``seq``: sequence parallelism (ring attention).

Ranks are laid out row-major over ``(data, fsdp, model, seq)``, so ``seq``
and ``model`` are innermost, as ``mesh_utils`` places them on a TPU slice.
The mesh wraps a :class:`torch.distributed.device_mesh.DeviceMesh` with
those dimension names (``device_mesh``) and keeps the process groups the
runtime reduces over (:meth:`Mesh.group`). ``with mesh:`` makes it the
ambient mesh that ``dot_product_attention(impl="ring")`` reads
(:func:`current_mesh`), as JAX's ``with mesh:``.

A fully specified mesh smaller than the world uses the world's first ranks,
as JAX slices ``devices[:prod(shape)]``; every rank of the world takes part
in building it (group creation is collective), and a rank outside it raises
when it uses it (:meth:`Mesh.check_member`).
"""
from __future__ import annotations

import contextvars
import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"

AXIS_NAMES: Tuple[str, ...] = (AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_SEQ)

#: Axes over which the *batch* dimension is sharded.
BATCH_AXES: Tuple[str, ...] = (AXIS_DATA, AXIS_FSDP)


@dataclasses.dataclass
class MeshConfig:
    """Parallelism degrees. ``-1`` for exactly one axis means "all remaining
    ranks" (like the reference's ``--trainer.devices=-1``)."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1

    def resolve(self, num_devices: int) -> "MeshConfig":
        sizes = dataclasses.asdict(self)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if num_devices % fixed:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = num_devices // fixed
        elif fixed > num_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but only {num_devices} are available"
            )
        return MeshConfig(**sizes)

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.data, self.fsdp, self.model, self.seq)


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("perceiver_mesh", default=None)


def current_mesh() -> Optional["Mesh"]:
    """The mesh of the enclosing ``with mesh:`` block, or None."""
    return _AMBIENT.get()


class Mesh:
    """The ranks of one mesh and its process groups (build it with
    :func:`make_mesh`).

    :ivar shape: ``{axis: size}`` for the four axes (JAX ``mesh.shape``).
    :ivar ranks: the world ranks of the mesh, row-major over the axes.
    :ivar rank: this process's world rank; ``index`` its place in ``ranks``
        (None outside the mesh).
    :ivar device: the device this rank computes on.
    :ivar backend: the process group's backend (``nccl`` or ``gloo``).
    """

    def __init__(self, config: MeshConfig, ranks: Sequence[int], *, device: torch.device, backend: str):
        from torch.distributed.device_mesh import DeviceMesh

        self.config = config
        self.shape: Dict[str, int] = dict(zip(AXIS_NAMES, config.shape))
        self.axis_names = AXIS_NAMES
        self.size = math.prod(config.shape)
        self.ranks = list(ranks)
        self.rank = dist.get_rank()
        self.index = self.ranks.index(self.rank) if self.rank in self.ranks else None
        self.device = device
        self.backend = backend
        layout = np.asarray(self.ranks).reshape(config.shape)
        self.coords: Dict[str, int] = {}
        if self.index is not None:
            self.coords = dict(zip(AXIS_NAMES, np.unravel_index(self.index, config.shape)))
            self.coords = {k: int(v) for k, v in self.coords.items()}
        # bookkeeping only: the runtime's groups are the ones built below
        self.device_mesh = DeviceMesh("cpu", torch.as_tensor(layout), mesh_dim_names=AXIS_NAMES,
                                      _init_backend=False)
        self._groups: Dict[Tuple[str, ...], object] = {}
        # every axis set the runtime reduces over; each new_group call is
        # collective over the world, so every rank builds all of them in
        # one order, and a member list met twice reuses its group
        built: Dict[Tuple[int, ...], object] = {}
        for axes in _GROUP_AXES:
            if math.prod(self.shape[a] for a in axes) == 1:
                continue
            keep = [AXIS_NAMES.index(a) for a in axes]
            other = [i for i in range(4) if i not in keep]
            moved = np.transpose(layout, other + keep).reshape(-1, math.prod(layout.shape[i] for i in keep))
            for members in moved:
                members = tuple(int(r) for r in members)
                if members not in built:
                    built[members] = dist.new_group(list(members))
                if self.rank in members:
                    self._groups[axes] = built[members]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks}, device={self.device}, backend={self.backend!r})"

    def __enter__(self) -> "Mesh":
        self._tokens = getattr(self, "_tokens", [])
        self._tokens.append(_AMBIENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.reset(self._tokens.pop())

    def check_member(self) -> None:
        """Raise when this rank is outside the mesh."""
        if self.index is None:
            raise RuntimeError(f"rank {self.rank} is outside the mesh over ranks {self.ranks} "
                               f"({self.shape}); only those ranks may use it")

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, *axes: str) -> int:
        """This rank's row-major index over ``axes`` (JAX's ordinal of a
        ``PartitionSpec`` entry naming them)."""
        self.check_member()
        index = 0
        for a in axes:
            index = index * self.shape[a] + self.coords[a]
        return index

    def group(self, *axes: str):
        """The process group of this rank over ``axes`` (one of the axis
        sets the runtime uses), or None when their sizes multiply to 1."""
        axes = tuple(a for a in AXIS_NAMES if a in axes)
        if self.axis_size(*axes) == 1:
            return None
        self.check_member()
        if axes not in self._groups:
            raise KeyError(f"no process group over {axes}; built: {sorted(self._groups)}")
        return self._groups[axes]

    @property
    def is_trivial(self) -> bool:
        """Every axis of size 1: every placement is replication."""
        return self.size == 1


#: the axis sets the runtime reduces or gathers over: each axis, the batch
#: axes, each sharded-parameter combination and the whole mesh
_GROUP_AXES: Tuple[Tuple[str, ...], ...] = tuple(
    axes for n in range(1, 5) for axes in itertools.combinations(AXIS_NAMES, n)
)


def make_mesh(
    config: Optional[MeshConfig] = None,
    *,
    ranks: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
    device=None,
    **axis_sizes: int,
) -> Mesh:
    """Build a 4-axis mesh (data, fsdp, model, seq) over ``ranks`` (the
    world by default), bringing up the process group first if it is not
    (:func:`~perceiver_io_tpu_torch.parallel.multihost.initialize`, with
    ``backend`` and ``device``).

    ``make_mesh()`` -> every rank on the data axis (DDP parity);
    ``make_mesh(fsdp=2, data=1)`` -> fully sharded over 2 ranks.

    :param device: this rank's device; ``cuda:LOCAL_RANK`` by default (a
        rank without a card raises), the CPU only when asked for.
    :param backend: ``nccl`` for CUDA, ``gloo`` for the CPU by default; the
        caller may name another, never chosen by catching a failure.
    """
    from perceiver_io_tpu_torch.parallel import multihost

    if config is None:
        config = MeshConfig(**axis_sizes)
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")
    multihost.initialize(backend=backend, device=device)
    device = multihost.rank_device(device)
    ranks = list(ranks) if ranks is not None else list(range(dist.get_world_size()))
    config = config.resolve(len(ranks))
    ranks = ranks[: math.prod(config.shape)]  # fully-specified smaller mesh
    return Mesh(config, ranks, device=device, backend=dist.get_backend())


def device_slice(count: int, *, offset: int = 0, ranks: Optional[Sequence[int]] = None) -> list:
    """A contiguous rank subset ``[offset, offset + count)`` of ``ranks``
    (the world by default); raises when the slice overruns them."""
    if ranks is None:
        ranks = list(range(dist.get_world_size())) if dist.is_initialized() else [0]
    ranks = list(ranks)
    if count < 1:
        raise ValueError(f"device_slice count must be >= 1, got {count}")
    if offset < 0:
        raise ValueError(f"device_slice offset must be >= 0, got {offset}")
    if offset + count > len(ranks):
        raise ValueError(
            f"device slice [{offset}, {offset + count}) overruns the "
            f"{len(ranks)} available devices — shrink the mesh or the "
            "replica count (replicas x data x model devices must fit)"
        )
    return ranks[offset:offset + count]


def single_device_mesh(device=None, *, index: int = 0, backend: Optional[str] = None) -> Mesh:
    """A 1-rank mesh over rank ``index`` (all axes size 1: every placement
    collapses to replication)."""
    from perceiver_io_tpu_torch.parallel import multihost

    multihost.initialize(backend=backend, device=device)
    return make_mesh(MeshConfig(data=1), ranks=device_slice(1, offset=index), device=device)
