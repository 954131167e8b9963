"""Parallelism and the multi-process runtime over ``torch.distributed``.
Counterpart of ``perceiver_io_tpu/parallel``.

One process per device (``torchrun``), laid out on a :class:`Mesh` with
the JAX package's axes:

- ``data``: batch sharded, gradients summed (DDP);
- ``fsdp``: batch, parameters and optimizer state sharded, parameters
  gathered before use and gradients reduce-scattered (FSDP/ZeRO-3);
- ``model``: tensor parallelism (heads, MLP hidden width; Megatron's
  column- and row-parallel layers);
- ``seq``: sequence parallelism (ring attention).

GSPMD writes the JAX package's collectives; here every one is a call
through :mod:`~perceiver_io_tpu_torch.parallel.collectives`, counted by
kind.
"""
from perceiver_io_tpu_torch.parallel.mesh import Mesh, MeshConfig, current_mesh, make_mesh, single_device_mesh
from perceiver_io_tpu_torch.parallel.multihost import (
    global_batch,
    initialize,
    is_multihost,
    shard_or_assemble,
)
from perceiver_io_tpu_torch.parallel.partition import (
    batch_sharding,
    batch_spec,
    infer_param_specs,
    param_shardings,
    shard_batch,
    shard_params,
)
from perceiver_io_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded
from perceiver_io_tpu_torch.parallel.train_step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_gradient_step,
    make_train_step,
    state_shardings,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "initialize",
    "is_multihost",
    "global_batch",
    "shard_or_assemble",
    "batch_sharding",
    "infer_param_specs",
    "param_shardings",
    "shard_batch",
    "shard_params",
    "ring_attention",
    "ring_attention_sharded",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
    "state_shardings",
    # the port's own
    "Mesh",
    "batch_spec",
    "current_mesh",
    "make_gradient_step",
    "single_device_mesh",
]
