"""The multi-process runtime. Counterpart of
``perceiver_io_tpu/parallel/multihost.py``.

The port runs one process per device, as ``torchrun`` starts them:

1. :func:`initialize` brings up the ``torch.distributed`` process group,
   from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
   ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit
   arguments; a lone process without that environment is a world of one
   over an in-process store. It is idempotent.
2. Build the mesh over the world (:func:`~.mesh.make_mesh`).
3. Each rank loads its own slice of the data
   (:func:`perceiver_io_tpu_torch.data.loader.host_shard_info` reads the
   rank) and :func:`global_batch` turns the ranks' rows into each rank's
   part of the global batch: the global batch is the ranks' rows in rank
   order, as JAX's ``make_array_from_process_local_data`` lays it out.
4. The train step is then the same in one process or many.

:func:`shard_or_assemble` dispatches between :func:`~.partition.shard_batch`
(one process: the batch given is the global batch) and :func:`global_batch`
(several: the batch given is this rank's rows).
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from perceiver_io_tpu_torch._device import resolve_device
from perceiver_io_tpu_torch.parallel import collectives
from perceiver_io_tpu_torch.parallel.partition import shard_batch


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it names one, else (None, or
    ``cuda`` without an index) ``cuda:LOCAL_RANK``, raising without a card."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    return dev


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 600.0,
) -> None:
    """Bring up the process group (idempotent: a second call returns).

    :param init_method: a rendezvous URL (``tcp://localhost:<port>``,
        ``file://<path>``); None reads ``torchrun``'s environment
        (``env://``), or, without ``WORLD_SIZE`` there and without
        ``world_size``, makes a world of one over an in-process store.
    :param backend: ``nccl`` when the rank's device is CUDA, ``gloo`` on the
        CPU, unless named.
    :param device: the rank's device (:func:`rank_device`); a CUDA device
        becomes the current one.
    """
    if dist.is_initialized():
        return
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = timedelta(seconds=timeout_s)
    if init_method is None and world_size is None and "WORLD_SIZE" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
        return
    if init_method is None:
        init_method = "env://"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kwargs)


def is_initialized() -> bool:
    """Whether the process group is up (a world of one counts)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_multihost() -> bool:
    """More than one process (JAX ``process_count() > 1``)."""
    return process_count() > 1


def shutdown() -> None:
    """Tear the process group down (a no-op when it is not up)."""
    if is_initialized():
        dist.destroy_process_group()


def _global_rows(x: np.ndarray, dim: int, mesh) -> np.ndarray:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (one
    ``all_gather`` over the mesh)."""
    t = torch.as_tensor(np.ascontiguousarray(x))
    return collectives.all_gather(t, mesh.group(*mesh.axis_names), dim=dim).numpy()


def global_batch(batch, mesh, *, shard_seq: bool = False, stacked_steps: bool = False):
    """Each rank's part of the global batch from the rows it loaded.

    Every rank passes its *local* rows (from its own loader shard); the
    global batch is all ranks' rows in rank order. When the mesh is the
    batch axes alone over the whole world (``model = seq = 1``), a rank's
    rows are its shard and nothing moves; otherwise the rows are gathered
    (token ids: small) and each rank takes its shard
    (:func:`~.partition.shard_batch`). With ``stacked_steps`` the leaves
    carry a leading steps dim and the batch dim is dim 1.
    """
    mesh.check_member()
    dim = 1 if stacked_steps else 0
    if mesh.size != dist.get_world_size():
        raise ValueError(f"global_batch needs the mesh over the whole world ({dist.get_world_size()} "
                         f"ranks), got {mesh.size}")
    if mesh.shape["model"] == 1 and mesh.shape["seq"] == 1:
        return {k: np.asarray(v) for k, v in batch.items()}
    full = {k: _global_rows(np.asarray(v), dim, mesh) for k, v in batch.items()}
    return shard_batch(full, mesh, shard_seq=shard_seq, stacked_steps=stacked_steps)


def shard_or_assemble(batch, mesh, *, shard_seq: bool = False, stacked_steps: bool = False):
    """One process: :func:`~.partition.shard_batch` of the global batch.
    Several: :func:`global_batch` of this rank's rows."""
    if is_multihost():
        return global_batch(batch, mesh, shard_seq=shard_seq, stacked_steps=stacked_steps)
    return shard_batch(batch, mesh, shard_seq=shard_seq, stacked_steps=stacked_steps)
