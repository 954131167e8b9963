"""Sharded serving runtime: the slot engine over a ``data`` x ``model``
serving mesh. Counterpart of ``perceiver_io_tpu/serving/sharding.py``.

The mesh is the training runtime's (:mod:`perceiver_io_tpu_torch.parallel`):
one process (rank) per device over ``torch.distributed``. A
:class:`ServingMeshSpec` resolves to a 2-axis mesh (``fsdp``/``seq`` pinned
at 1) over a contiguous **rank subset**
(:func:`~perceiver_io_tpu_torch.parallel.mesh.device_slice`: N replicas of
M-rank groups, the second scaling axis), and a :class:`ServingSharding`
places the slot engine's working set on it:

- **params**: the Megatron TP rules (``infer_param_specs``): q/k/v and the
  MLP's up projection column-parallel on ``model``, o and the MLP's down
  projection row-parallel, everything replicated across ``data``; every
  attention and MLP runs on its share with the ``model`` group's
  :class:`~perceiver_io_tpu_torch.parallel.collectives.TensorParallel`
  (one all-reduce after each row-parallel product);
- **slot state**: the serving rules
  (:data:`~perceiver_io_tpu_torch.parallel.partition.SERVING_STATE_RULES`):
  each rank allocates its **local** slice, slots over ``data`` and heads
  over ``model``. The paged pool's token dimension is not sharded across
  ``data``: block tables address one shared pool (prefix sharing maps pages
  across slots), so every data rank holds a replica of its heads' pool.
  Where GSPMD all-gathers each step's scattered rows into every replica,
  the decode step here all-gathers the rows its data ranks wrote over the
  ``data`` group and writes them into each replica; a batch-1 admission
  (prefill, chunk, finalize, page copy, swap restore) runs on every data
  rank, as JAX's spec drops the batch dimension of 1. After every step the
  data replicas of a pool are byte-equal.

**One scheduler.** Rank 0 of the world (the *driver*) runs the engine and
every host decision: the queue, admission, the pool allocator, the prefix
index, preemption, the autotuners, and the fleet and gateway above them.
Each device call of the slot engine is mirrored on the ranks of its group:
the driver sends a small plan (the op's name and its host arguments:
ints, block tables, token ids) over a gloo control group, and every rank
runs the op on its shard (:func:`follow` is the followers' loop; a
follower has no scheduler). The host logic is not replayed on every rank
because the engine decides on clocks (deadlines, the swap-rate
calibration that prices preemption victims, the autotuners' probe
timings): replayed ranks would diverge. A driver outside a replica's group
(the fleet's second group on) sends the plans all the same and takes each
op's result back from the group's first rank.

**Process groups are built collectively.** Every rank of the world
resolves a spec (:meth:`ServingMeshSpec.resolve`) or builds a
:class:`MeshGroupAllocator` at the same point, in the same order; later
resolutions of the same rank subset reuse those groups. Then the driver
builds engines while the other ranks call :func:`follow`, and the driver
ends their loops with :meth:`ServingSharding.stop` (or the allocator's).

Transport: the plans travel as pickled host objects over a gloo group (on
one card several ranks cannot use NCCL, and gloo's point-to-point refuses
CUDA tensors); the collectives inside an op are the mesh's own
(:mod:`~perceiver_io_tpu_torch.parallel.collectives`, counted).

Executor identity: the port compiles nothing per shape, so there are no
executor caches to key; :meth:`ServingSharding.fingerprint` and
:meth:`~ServingSharding.describe` carry over for the stats, the gauges and
``obs report``.
"""
from __future__ import annotations

import copy
import dataclasses
import weakref
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from perceiver_io_tpu_torch.parallel import collectives
from perceiver_io_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_NAMES,
    AXIS_SEQ,
    Mesh,
    MeshConfig,
    device_slice,
    make_mesh,
)
from perceiver_io_tpu_torch.parallel.partition import (
    ParamPlacement,
    Sharding,
    serving_state_spec,
    serving_state_specs,
)

#: the world rank that runs the scheduler
DRIVER_RANK = 0
#: a follower waits this long for the driver's next plan (an idle server
#: sends none)
CONTROL_TIMEOUT_S = 24 * 3600.0
#: ops whose result the driver reads (from the group's first rank when it is
#: not a member of the group)
RESULT_OPS = ("decode", "spec_round", "swap_extract", "warmup_steps", "digests")

#: (ranks, data, model) -> Mesh; ranks -> control group (None: one process)
_MESHES: Dict[tuple, Mesh] = {}
_CONTROLS: Dict[tuple, object] = {}


def _world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _control_ranks(ranks: Sequence[int]) -> tuple:
    return tuple(sorted({DRIVER_RANK, *ranks}))


def _control(ranks: Sequence[int]) -> None:
    """The control group of a mesh over ``ranks`` (the driver and the
    ranks; None for one process), built once."""
    members = _control_ranks(ranks)
    if members not in _CONTROLS:
        _CONTROLS[members] = None if len(members) == 1 else dist.new_group(
            list(members), backend="gloo", timeout=timedelta(seconds=CONTROL_TIMEOUT_S))


def _build(ranks: Sequence[int], data: int, model: int, *, device=None) -> Mesh:
    """The mesh over ``ranks`` and its control group, built once (every rank
    of the world calls this at the same point the first time)."""
    key = (tuple(ranks), data, model)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(MeshConfig(data=data, fsdp=1, model=model, seq=1), ranks=list(ranks),
                                 device=device)
    _control(ranks)
    return _MESHES[key]


@dataclasses.dataclass(frozen=True)
class ServingMeshSpec:
    """Declarative serving-mesh geometry: ``data`` x ``model`` ranks at
    ``device_offset`` into the world's rank list. ``data`` shards the slots
    (they must divide evenly), ``model`` the attention heads and KV caches
    (heads must divide evenly); fsdp/seq are pinned at 1.

    ``device_offset`` is the fleet hook: replica i of an M-rank fleet
    resolves at offset ``i*M``, so replicas own disjoint subsets
    (:func:`fleet_mesh_specs`)."""

    data: int = 1
    model: int = 1
    device_offset: int = 0

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(
                f"mesh axis sizes must be >= 1, got data={self.data} "
                f"model={self.model}"
            )
        if self.device_offset < 0:
            raise ValueError(
                f"device_offset must be >= 0, got {self.device_offset}"
            )

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    def resolve(self, ranks: Optional[Sequence[int]] = None, *, device=None) -> "ServingSharding":
        """Claim the rank subset and build the resolved sharding. The first
        resolution of a subset builds its process groups: every rank of the
        world calls it then (module docstring).

        :param ranks: the ranks to slice (the world by default).
        :param device: this rank's device (``cuda:LOCAL_RANK`` by default).
        """
        subset = device_slice(self.num_devices, offset=self.device_offset, ranks=ranks)
        return ServingSharding(self, _build(subset, self.data, self.model, device=device))


class ServingSharding:
    """A resolved serving mesh: the placement of the slot engine's params
    and state, and the control channel of its step driver. Built by
    :meth:`ServingMeshSpec.resolve` (or :func:`as_serving_sharding` from a
    4-axis :class:`~perceiver_io_tpu_torch.parallel.mesh.Mesh` whose
    fsdp/seq axes are 1)."""

    def __init__(self, spec: ServingMeshSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh
        self.data_size = int(mesh.shape[AXIS_DATA])
        self.model_size = int(mesh.shape[AXIS_MODEL])
        self.num_devices = self.data_size * self.model_size
        self.ranks = list(mesh.ranks)
        self.device = mesh.device
        #: whether this rank holds a shard (a driver outside the group does not)
        self.is_member = mesh.index is not None
        self.data_index = mesh.coords.get(AXIS_DATA, 0) if self.is_member else 0
        self.model_index = mesh.coords.get(AXIS_MODEL, 0) if self.is_member else 0
        self._control = _CONTROLS.get(_control_ranks(self.ranks))
        if self._control is None and len(_control_ranks(self.ranks)) > 1:
            raise RuntimeError(
                f"the serving mesh over ranks {self.ranks} has no control group: resolve it on every "
                "rank of the world first (ServingMeshSpec.resolve, or as_serving_sharding(mesh) on "
                "every rank)")
        #: plans sent (driver) or run (follower)
        self.plans = 0
        #: (allocator, group) when this sharding came from a
        #: :class:`MeshGroupAllocator` (see :meth:`release`)
        self._allocator_claim = None

    def release(self) -> None:
        """Free this sharding's :class:`MeshGroupAllocator` group claim
        explicitly (idempotent; no-op for shardings resolved directly).
        ``Replica.restart`` calls it on the crashed engine's sharding before
        re-running the factory, so the rebuild reclaims the crashed group
        deterministically instead of waiting for the garbage collector."""
        claim = self._allocator_claim
        if claim is None:
            return
        self._allocator_claim = None
        allocator, group = claim
        ref = allocator._claims.get(group)
        if ref is not None and ref() is self:
            del allocator._claims[group]

    # -- identity ------------------------------------------------------------
    def fingerprint(self) -> Tuple:
        """Axis sizes and the concrete ranks (JAX's device ids): two fleet
        replicas of one geometry on disjoint subsets differ."""
        return ("mesh", self.data_size, self.model_size, tuple(self.ranks))

    def describe(self) -> str:
        """``data x model @ devices + first rank``, as the stats render it."""
        return f"{self.data_size}x{self.model_size}@{self.num_devices}dev+{self.ranks[0]}"

    # -- groups and rows -----------------------------------------------------
    @property
    def data_group(self):
        return self.mesh.group(AXIS_DATA) if self.is_member else None

    @property
    def group(self):
        """The whole mesh's group (None for one rank)."""
        return self.mesh.group(*AXIS_NAMES) if self.is_member else None

    def local_rows(self, slots: int) -> Tuple[int, int]:
        """``(first slot, slot count)`` of this rank's rows of ``slots``."""
        per = slots // self.data_size
        return self.data_index * per, per

    # -- placement -----------------------------------------------------------
    def put_params(self, model):
        """This rank's tensor-parallel model: the parameters of the group's
        first rank reach every rank (one broadcast a type, the parameters
        laid end to end), each rank
        keeps its ``model``-axis slice of every attention and MLP that runs
        tensor-parallel (``infer_param_specs``; a layer whose heads or width
        do not divide the axis stays whole, as JAX replicates a leaf that
        does not divide) and those layers get the ``model`` group's
        ``tp``. Over ``model > 1`` the model is a copy (the caller's is left
        as it is); otherwise the caller's, in place."""
        self.mesh.check_member()
        if self.model_size > 1:
            model = copy.deepcopy(model)
        placement = ParamPlacement(model, self.mesh)
        group = self.group
        with torch.no_grad():
            if group is not None:
                by_type: Dict[torch.dtype, list] = {}
                for p in model.parameters():
                    by_type.setdefault(p.dtype, []).append(p)
                for params in by_type.values():
                    flat = collectives.broadcast(torch.cat([p.data.reshape(-1) for p in params]), group, src=0)
                    for p, part in zip(params, flat.split([p.numel() for p in params])):
                        p.data.copy_(part.view_as(p))
                    del flat
            for name, p in model.named_parameters():
                if placement.model_dim(name) is not None and not placement.gathers_model(name):
                    p.data = placement.local(name, p.data).clone()
        placement.attach(model)
        return model

    def put_state(self, state):
        """This rank's local slice of a whole slot-state dict (the serving
        rules; a tuple entry's path is ``name/i``)."""
        specs = serving_state_specs(state, self.mesh)

        def local(value, path):
            if isinstance(value, (list, tuple)):
                return type(value)(local(v, f"{path}/{i}") for i, v in enumerate(value))
            return Sharding(self.mesh, specs[path]).local(value)

        return {k: local(v, k) for k, v in state.items()}

    def put_leaf(self, name: str, value):
        """This rank's local slice of one whole state leaf (``table``: its
        data rank's rows)."""
        return Sharding(self.mesh, serving_state_spec(name, tuple(np.shape(value)), self.mesh)).local(value)

    # -- the step driver's channel ----------------------------------------------
    @property
    def transports(self) -> bool:
        """Whether plans travel (another process takes part)."""
        return self._control is not None

    def send(self, op: str, args: dict) -> None:
        """Driver: broadcast one plan to the group's followers."""
        if self._control is None:
            return
        self.plans += 1
        dist.broadcast_object_list([(op, args)], src=DRIVER_RANK, group=self._control)

    def receive(self) -> tuple:
        """Follower: the driver's next ``(op, args)``."""
        box = [None]
        dist.broadcast_object_list(box, src=DRIVER_RANK, group=self._control)
        self.plans += 1
        return box[0]

    def reply(self, value=None):
        """One op's result from the group's first rank to the control group
        (the driver outside the group reads it); every member calls it."""
        box = [value]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self._control)
        return box[0]

    def stop(self) -> None:
        """Driver: end the followers' loops (:func:`follow`)."""
        self.send("stop", {})


def follow(sharding: "ServingSharding", model) -> int:
    """The followers' loop: receive each plan and run its op on this rank's
    shard; an ``init`` plan (a new engine on the group) builds the shard
    again from ``model`` (this rank's copy of the model, on its device).
    Returns the number of plans run when the driver sends ``stop``."""
    from perceiver_io_tpu_torch.serving.slots import _SlotDevice

    sharding.mesh.check_member()
    if sharding.transports and _world_rank() == DRIVER_RANK:
        raise RuntimeError("the driver rank runs the engine; only the other ranks follow")
    shard = None
    ran = 0
    while True:
        op, args = sharding.receive()
        if op == "stop":
            return ran
        if op == "init":
            shard = None
            shard = _SlotDevice.from_plan(model, sharding, args)
        else:
            reply = args.pop("_reply", False)
            with torch.no_grad():
                result = getattr(shard, op)(**args)
            if reply:
                sharding.reply(_on_host(result) if _world_rank() == sharding.ranks[0] else None)
        ran += 1


def _on_host(value):
    """An op's result with its tensors on the host (it travels pickled)."""
    if isinstance(value, torch.Tensor):
        return value.cpu()
    if isinstance(value, tuple):
        return tuple(_on_host(v) for v in value)
    return value


def as_serving_sharding(mesh: Union[None, ServingMeshSpec, ServingSharding, Mesh]) -> Optional[ServingSharding]:
    """Coerce the slot engine's ``mesh=`` argument: None passes through
    (unsharded), a spec resolves against the world, a 4-axis
    :class:`~perceiver_io_tpu_torch.parallel.mesh.Mesh` is accepted when its
    fsdp/seq axes are 1 (the training-mesh reuse case)."""
    if mesh is None or isinstance(mesh, ServingSharding):
        return mesh
    if isinstance(mesh, ServingMeshSpec):
        return mesh.resolve()
    if isinstance(mesh, Mesh):
        shape = dict(mesh.shape)
        extra = {
            a: s for a, s in shape.items()
            if a not in (AXIS_DATA, AXIS_MODEL) and s > 1
        }
        if extra:
            raise ValueError(
                f"serving meshes use only ({AXIS_DATA!r}, {AXIS_MODEL!r}); "
                f"got extra axes {extra} — serving holds no optimizer state "
                f"to {AXIS_FSDP}-shard and no {AXIS_SEQ} ring"
            )
        _control(mesh.ranks)
        spec = ServingMeshSpec(
            data=int(shape.get(AXIS_DATA, 1)),
            model=int(shape.get(AXIS_MODEL, 1)),
            device_offset=int(mesh.ranks[0]),
        )
        return ServingSharding(spec, mesh)
    raise TypeError(
        "mesh must be None, a ServingMeshSpec, a ServingSharding, or a "
        f"parallel.Mesh, got {type(mesh).__name__}"
    )


def fleet_mesh_specs(
    spec: ServingMeshSpec,
    replicas: int,
    *,
    ranks: Optional[Sequence[int]] = None,
) -> Tuple[ServingMeshSpec, ...]:
    """Disjoint per-replica mesh specs: replica i at rank offset
    ``spec.device_offset + i * spec.num_devices``. Validates that the whole
    fleet fits the world up front (an over-subscribed fleet must fail at
    launch, not alias ranks silently mid-scale-up)."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    per = spec.num_devices
    # validate the LAST slice; earlier ones are subsets of the budget
    device_slice(per, offset=spec.device_offset + (replicas - 1) * per, ranks=ranks)
    return tuple(
        dataclasses.replace(spec, device_offset=spec.device_offset + i * per)
        for i in range(replicas)
    )


class MeshGroupAllocator:
    """Hands each engine spawn a disjoint rank group: the engine-factory
    form the serve CLI uses. Every factory call (initial spawn, crash
    rebuild, autoscaler scale-up) ``acquire()``s the first FREE group of
    ``spec.num_devices`` ranks.

    A group is busy while an engine built on it is alive: claims are
    weakrefs to the :class:`ServingSharding` the engine holds, plus an
    explicit :meth:`ServingSharding.release` (``Replica.restart`` releases
    the crashed engine's claim before re-running its factory). Only when
    every group is claimed does the allocator wrap round-robin.

    Every rank of the world builds the allocator at the same point: its
    constructor builds each group's process groups. Then the driver
    acquires and the other ranks :meth:`follow` their group."""

    def __init__(self, spec: ServingMeshSpec, *, ranks: Optional[Sequence[int]] = None, device=None):
        from perceiver_io_tpu_torch.parallel import multihost

        multihost.initialize(device=device)
        all_ranks = list(ranks) if ranks is not None else list(range(dist.get_world_size()))
        self.spec = spec
        self.groups = max(1, (len(all_ranks) - spec.device_offset) // spec.num_devices)
        self._meshes = []
        for group in range(self.groups):
            offset = spec.device_offset + group * spec.num_devices
            subset = device_slice(spec.num_devices, offset=offset, ranks=all_ranks)
            self._meshes.append(_build(subset, spec.data, spec.model, device=device))
        self._claims: dict = {}  # group index -> weakref to its ServingSharding
        self._wrap = 0

    def _sharding(self, group: int) -> ServingSharding:
        spec = dataclasses.replace(
            self.spec, device_offset=self.spec.device_offset + group * self.spec.num_devices)
        return ServingSharding(spec, self._meshes[group])

    def acquire(self) -> ServingSharding:
        """Resolve the first free group (round-robin wrap when none is)."""
        free = [
            i for i in range(self.groups)
            if (ref := self._claims.get(i)) is None or ref() is None
        ]
        if free:
            group = free[0]
        else:
            group = self._wrap % self.groups
            self._wrap += 1
        sharding = self._sharding(group)
        self._claims[group] = weakref.ref(sharding)
        sharding._allocator_claim = (self, group)
        return sharding

    def member_group(self) -> Optional[int]:
        """The group this rank belongs to (None: none)."""
        rank = _world_rank()
        for group, mesh in enumerate(self._meshes):
            if rank in mesh.ranks:
                return group
        return None

    def follow(self, model) -> int:
        """Follower: run this rank's group until the driver stops it (0 for
        a rank in no group)."""
        group = self.member_group()
        return 0 if group is None else follow(self._sharding(group), model)

    def stop(self) -> None:
        """Driver: end every group's followers."""
        for group in range(self.groups):
            self._sharding(group).stop()


# ---------------------------------------------------------------- probe main
def _probe_main(argv: Optional[list] = None) -> int:
    """Self-contained sharded-serving probe: under ``torchrun
    --nproc_per_node=<data x model> -m
    perceiver_io_tpu_torch.serving.sharding --data D --model M``, every rank
    builds a tiny CLM from one seed and resolves the mesh; the driver serves
    ragged greedy prompts through a slot engine on it and prints ONE JSON
    line (tokens/s, per-shard resident bytes, the emitted tokens, the steps
    warmup drove); the other ranks follow. ``--device=cpu`` runs on the
    CPU (gloo)."""
    import argparse
    import json
    import time

    parser = argparse.ArgumentParser(description=_probe_main.__doc__)
    parser.add_argument("--data", type=int, default=1)
    parser.add_argument("--model", type=int, default=1)
    parser.add_argument("--device-offset", type=int, default=0)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--new-tokens", type=int, default=8)
    parser.add_argument("--kv-layout", default="dense",
                        choices=("dense", "paged", "paged_int8"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from perceiver_io_tpu_torch.inference.generate import GenerationConfig
    from perceiver_io_tpu_torch.inference.samplers import SamplingConfig
    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.parallel import multihost
    # the canonical classes, not this file's bindings: under ``python -m``
    # this module runs as ``__main__``
    from perceiver_io_tpu_torch.serving import BucketTable, SlotServingEngine
    from perceiver_io_tpu_torch.serving import ServingMeshSpec as _CanonicalSpec

    multihost.initialize(device=args.device)
    device = multihost.rank_device(args.device)
    cfg = CausalLanguageModelConfig(
        vocab_size=93, max_seq_len=64, max_latents=16, num_channels=32,
        num_heads=4, num_self_attention_layers=2, cross_attention_dropout=0.0,
    )
    model = CausalLanguageModel(cfg, seed=0, device=device)
    sharding = _CanonicalSpec(data=args.data, model=args.model,
                              device_offset=args.device_offset).resolve(device=device)
    if _world_rank() != DRIVER_RANK:
        if sharding.is_member:
            follow(sharding, model)
        multihost.shutdown()
        return 0
    gen = GenerationConfig(max_new_tokens=args.new_tokens, num_latents=4,
                           sampling=SamplingConfig(temperature=0.0))
    engine = SlotServingEngine(
        model, gen, BucketTable(prompt_lens=(16, 32), batch_sizes=(1,)),
        slots=args.slots, mesh=sharding, kv_layout=args.kv_layout, device=device,
    )
    steps = engine.warmup()
    rng = np.random.default_rng(args.seed)
    prompts = [
        rng.integers(1, 93, size=int(n)).astype(np.int32)
        for n in rng.integers(8, 28, size=args.requests)
    ]
    t0 = time.monotonic()
    outs = engine.serve(prompts)
    wall = time.monotonic() - t0
    stats = engine.stats()
    sharding.stop()
    resident = int(stats.get("kv_pool", {}).get("resident_bytes", 0)) or int(
        engine.registry.gauge("kv_cache_resident_bytes") or 0
    )
    record = {
        "devices": dist.get_world_size(),
        "mesh": {"data": args.data, "model": args.model},
        "kv_layout": engine.kv_layout,
        "warmup_steps": steps,
        "tokens_generated": int(stats["tokens_generated"]),
        "tokens_per_s": round(stats["tokens_generated"] / max(wall, 1e-9), 2),
        "wall_s": round(wall, 3),
        "resident_bytes": resident,
        "per_shard_resident_bytes": resident // max(1, args.model),
        "tokens": [np.asarray(o).tolist() for o in outs],
    }
    print(json.dumps(record))
    multihost.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(_probe_main())
