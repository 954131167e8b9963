"""Every collective of the parallel runtime, counted. The counterpart of
what GSPMD emits for the JAX package from its sharding annotations: here
each ``all_reduce``, ``all_gather``, ``reduce_scatter``, ``broadcast`` and
ring ``send_recv`` is a call through this module, which counts calls and
bytes by kind (:data:`counts`, the role the kernels' launch counters play
for K1-K4). The bytes of a call are what this rank puts in: the tensor
reduced, gathered from, scattered or sent.

A group of one rank is no call at all: every function returns its input
(or a copy) and counts nothing, so a world of one runs the single-device
arithmetic.

Transport. With NCCL every tensor lies on the rank's card (a CPU tensor is
moved there and back). gloo takes CUDA tensors for ``all_reduce``,
``broadcast``, ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
(it stages them through the host itself), but not for point-to-point: its
``send``/``recv`` of a CUDA tensor fails ("Bad address", NVIDIA H100,
torch 2.11). So on a gloo group a CUDA tensor's ring exchange is staged
through host memory here, explicitly, and counted in
``counts["send_recv"]["host_staged"]``. That is the one-card form (several
ranks on one device, where NCCL refuses); with one card per rank the
backend is NCCL and nothing is staged.

FSDP's pair moves many tensors of one type in one call each way
(:func:`all_gather_flat`, :func:`reduce_scatter_flat`).
:class:`TensorParallel`'s autograd functions carry a tensor-parallel
layer's gradients: ``enter`` (identity forward, all-reduce backward) and
``reduce`` (all-reduce forward, identity backward), Megatron's *f* and *g*.
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "send_recv")

#: ``{kind: {"calls": n, "bytes": n}}`` since :func:`reset_counts`;
#: ``send_recv`` also counts ``host_staged`` calls
counts = {k: {"calls": 0, "bytes": 0} for k in KINDS}
counts["send_recv"]["host_staged"] = 0


def reset_counts() -> None:
    for k in KINDS:
        counts[k].update(calls=0, bytes=0)
    counts["send_recv"]["host_staged"] = 0


def read_counts() -> dict:
    return copy.deepcopy(counts)


def _count(kind: str, t: torch.Tensor) -> None:
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += t.numel() * t.element_size()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _on_card(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend takes it: NCCL wants the card."""
    if not t.is_cuda and dist.get_backend(group) == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the group (``sum``, ``max`` or ``min``), in place
    where ``t`` can be; returns the result."""
    if group_size(group) == 1:
        return t
    _count("all_reduce", t)
    work = _on_card(t, group)
    dist.all_reduce(work, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                              "min": dist.ReduceOp.MIN}[op], group=group)
    if work is not t:
        t.copy_(work)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    _count("all_gather", t)
    work = _on_card(t.contiguous().reshape((-1,) + tuple(t.shape[1:]) if t.dim() else (1,)), group)
    out = torch.empty((n * work.shape[0],) + tuple(work.shape[1:]), dtype=work.dtype, device=work.device)
    dist.all_gather_into_tensor(out, work, group=group)
    parts = out.view((n,) + tuple(t.shape)).unbind(0)
    return torch.cat(parts, dim=dim).to(t.device) if t.dim() else torch.stack(parts).to(t.device)


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk (along dim 0) of the group's summed ``t``."""
    n = group_size(group)
    if n == 1:
        return t
    _count("reduce_scatter", t)
    work = _on_card(t.contiguous(), group)
    out = torch.empty((work.shape[0] // n,) + tuple(work.shape[1:]), dtype=work.dtype, device=work.device)
    dist.reduce_scatter_tensor(out, work, group=group)
    return out.to(t.device)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank, in place."""
    if group_size(group) == 1:
        return t
    _count("broadcast", t)
    work = _on_card(t, group)
    dist.broadcast(work, src=dist.get_global_rank(group, src), group=group)
    if work is not t:
        t.copy_(work)
    return t


def barrier(group) -> None:
    """Wait for every rank of the group (no data; not counted)."""
    if group_size(group) > 1:
        dist.barrier(group=group)


def ring_shift(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> List[torch.Tensor]:
    """Each tensor sent to group rank ``r + shift`` and the one of rank
    ``r - shift`` received, in one ``batch_isend_irecv``. On a gloo group a
    CUDA tensor goes through host memory (module docstring)."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    r = group_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    staged = dist.get_backend(group) == "gloo"
    ops, received, devices = [], [], []
    for t in tensors:
        work = t.contiguous()
        devices.append(work.device)
        if staged and work.is_cuda:
            work = work.cpu()
            counts["send_recv"]["host_staged"] += 1
        else:
            work = _on_card(work, group)
        _count("send_recv", work)
        into = torch.empty_like(work)
        ops += [dist.P2POp(dist.isend, work, dst, group=group), dist.P2POp(dist.irecv, into, src, group=group)]
        received.append(into)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [x.to(d) for x, d in zip(received, devices)]


def all_gather_flat(shards: Sequence[torch.Tensor], group, dims: Sequence[int]) -> List[torch.Tensor]:
    """Whole tensors from the group's shards (each along its ``dims``
    entry), many tensors of one type in one all-gather: their shards laid
    end to end."""
    n = group_size(group)
    if n == 1 or not shards:
        return list(shards)
    rows = all_gather(torch.cat([s.reshape(-1) for s in shards]), group).view(n, -1)
    fulls, off = [], 0
    for s, d in zip(shards, dims):
        k = s.numel()
        fulls.append(torch.cat([rows[r, off:off + k].view(s.shape) for r in range(n)], dim=d))
        off += k
    return fulls


def reduce_scatter_flat(fulls: Sequence[torch.Tensor], group, dims: Sequence[int]) -> List[torch.Tensor]:
    """This rank's shard (along each ``dims`` entry) of each tensor summed
    over the group, many tensors of one type in one reduce-scatter."""
    n = group_size(group)
    if n == 1 or not fulls:
        return list(fulls)
    pieces = [f.chunk(n, dim=d) for f, d in zip(fulls, dims)]
    mine = reduce_scatter(torch.cat([torch.cat([p[r].reshape(-1) for p in pieces]) for r in range(n)]), group)
    out, off = [], 0
    for p in pieces:
        shape = p[0].shape
        out.append(mine[off:off + shape.numel()].view(shape))
        off += shape.numel()
    return out


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorParallel:
    """A layer's tensor-parallel group: the layer holds ``1 / size`` of its
    heads (or hidden width) and runs column-parallel into them and
    row-parallel out of them (``enter`` before, ``reduce`` after)."""

    def __init__(self, group):
        self.group = group
        self.size = group_size(group)
        self.rank = group_rank(group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; the gradient is summed over the group."""
        return _Enter.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The group's partial sums added; identity backward."""
        return _Reduce.apply(x, self.group)

    def local(self, total: int) -> int:
        return total // self.size

    def __repr__(self) -> str:
        return f"TensorParallel(size={self.size}, rank={self.rank})"


class BatchReduction:
    """The group a step's batch is sharded over, for :func:`batch_mean`;
    ``used`` says whether the loss function took its means through it."""

    def __init__(self, group):
        self.group = group
        self.used = False


_REDUCTION: contextvars.ContextVar = contextvars.ContextVar("perceiver_batch_reduction", default=None)


@contextlib.contextmanager
def batch_reduction(group):
    """Within the block :func:`batch_mean` divides by the count over the
    group's whole batch; yields the :class:`BatchReduction`."""
    ctx = BatchReduction(group)
    token = _REDUCTION.set(ctx)
    try:
        yield ctx
    finally:
        _REDUCTION.reset(token)


def reducing() -> bool:
    """Whether a sharded step's :func:`batch_reduction` is in force."""
    return _REDUCTION.get() is not None


def batch_mean(total: torch.Tensor, count) -> torch.Tensor:
    """``total / max(1, count)``. Inside a sharded step the count is the
    whole batch's (summed over the batch group, no gradient), so this
    rank's value is its share of the global mean and the step sums the
    shares: a masked mean over rows that the ranks split unevenly stays
    the single-device one (JAX's global ``nll.sum() / valid.sum()``)."""
    count = torch.as_tensor(count, device=total.device)
    ctx = _REDUCTION.get()
    if ctx is not None:
        ctx.used = True
        if ctx.group is not None:
            count = all_reduce(count.detach().clone(), ctx.group)
    return total / count.clamp(min=1)
