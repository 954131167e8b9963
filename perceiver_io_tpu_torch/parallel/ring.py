"""Ring attention: sequence parallelism over the ``seq`` mesh axis.
Counterpart of ``perceiver_io_tpu/parallel/ring.py``.

Each rank holds one contiguous chunk of q and of k/v; the k/v chunks
rotate around the ring (one ``batch_isend_irecv`` a step, counted by
:mod:`~.collectives`) while each rank folds every visiting chunk into an
online-softmax accumulator (running max, running sum), the JAX body's
arithmetic. The body is plain PyTorch, as JAX's is einsum outside any
Pallas kernel. ``send``/``recv`` carry no gradient, so the backward is
written out (:class:`_RingFunction`): the visiting chunks rotate again,
each rank adds its rows' share of dk/dv to the accumulators that travel
with them, and one more hop brings each chunk's dk/dv home.

Masking as :func:`perceiver_io_tpu_torch.ops.attention.dot_product_attention`:
right-aligned causal over the *global* lengths (offset
``(j_loc - i_loc) * axis_size``) and boolean key pad masks (True = pad).
Global q row ``s·i_loc + r``, global kv column ``src·j_loc + c`` for the
chunk that started on rank ``src``. A row that sees no key returns 0.

- :func:`ring_attention`: the per-rank body, for callers that hold their
  chunks;
- :func:`ring_attention_sharded`: takes the whole q/k/v on every rank of
  the ``seq`` group (every other computation there is repeated), runs the
  ring on this rank's chunk and gathers the output; its backward gathers
  dq/dk/dv the same way, so every rank holds the whole gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from perceiver_io_tpu_torch.parallel import collectives

_MASK = -0.7 * float(torch.finfo(torch.float32).max)


def _allowed(pad_t, causal, s, src, i_loc, j_loc, offset, device):
    allowed = None
    if pad_t is not None:
        allowed = ~pad_t.bool()[:, None, None, :]
    if causal:
        rows = s * i_loc + torch.arange(i_loc, device=device)[:, None]
        cols = src * j_loc + torch.arange(j_loc, device=device)[None, :]
        cm = (cols <= rows + offset)[None, None]
        allowed = cm if allowed is None else allowed & cm
    return allowed


def _forward(q, k, v, pad, group, causal):
    n, s = collectives.group_size(group), collectives.group_rank(group)
    b, h, i_loc, _ = q.shape
    j_loc, dv = k.shape[2], v.shape[3]
    offset = (j_loc - i_loc) * n if causal else None
    m = torch.full((b, h, i_loc, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, i_loc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, i_loc, dv), dtype=torch.float32, device=q.device)
    k_t, v_t, pad_t = k, v, pad
    for t in range(n):
        src = (s - t) % n
        logits = torch.einsum("bhic,bhjc->bhij", q.float(), k_t.float())
        allowed = _allowed(pad_t, causal, s, src, i_loc, j_loc, offset, q.device)
        if allowed is not None:
            logits = torch.where(allowed, logits, _MASK)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        if allowed is not None:
            p = torch.where(allowed, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhij,bhjc->bhic", p.to(v_t.dtype), v_t).float()
        m = m_new
        if t + 1 < n:
            k_t, v_t, *rest = collectives.ring_shift([k_t, v_t] + ([pad_t] if pad_t is not None else []), group)
            pad_t = rest[0] if rest else None
    safe_l = torch.where(l > 0.0, l, torch.ones_like(l))
    lse = torch.where(l > 0.0, m + torch.log(safe_l), torch.full_like(l, float("inf")))
    return (acc / safe_l).to(q.dtype), lse


def _backward(q, k, v, pad, o, lse, do, group, causal):
    n, s = collectives.group_size(group), collectives.group_rank(group)
    i_loc, j_loc = q.shape[2], k.shape[2]
    offset = (j_loc - i_loc) * n if causal else None
    qf, dof = q.float(), do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros_like(qf)
    k_t, v_t, pad_t = k, v, pad
    dk_t = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_t = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for t in range(n):
        src = (s - t) % n
        logits = torch.einsum("bhic,bhjc->bhij", qf, k_t.float())
        p = torch.exp(logits - lse)  # lse = inf on rows that see no key: p = 0
        allowed = _allowed(pad_t, causal, s, src, i_loc, j_loc, offset, q.device)
        if allowed is not None:
            p = torch.where(allowed, p, 0.0)
        dv_t = dv_t + torch.einsum("bhij,bhic->bhjc", p, dof)
        dp = torch.einsum("bhic,bhjc->bhij", dof, v_t.float())
        ds = p * (dp - delta)
        dq = dq + torch.einsum("bhij,bhjc->bhic", ds, k_t.float())
        dk_t = dk_t + torch.einsum("bhij,bhic->bhjc", ds, qf)
        if t + 1 < n:
            moved = collectives.ring_shift([k_t, v_t, dk_t, dv_t] + ([pad_t] if pad_t is not None else []), group)
            k_t, v_t, dk_t, dv_t = moved[:4]
            pad_t = moved[4] if pad_t is not None else None
    if n > 1:  # the chunk this rank holds started on rank s + 1: one more hop home
        dk_t, dv_t = collectives.ring_shift([dk_t, dv_t], group)
    return dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype)


class _RingFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad, group, causal):
        o, lse = _forward(q, k, v, pad, group, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.pad, ctx.group, ctx.causal = pad, group, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, ctx.pad, o, lse, do, ctx.group, ctx.causal)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, axis_name: str = "seq",
                   axis_size: Optional[int] = None, pad_mask: Optional[torch.Tensor] = None,
                   causal: bool = False, mesh=None) -> torch.Tensor:
    """The per-rank ring attention body over this rank's chunks.

    :param q: local ``(b, h, i_loc, d)`` pre-scaled queries (this rank's
        chunk of the global query).
    :param k: local ``(b, h, j_loc, d)`` keys; ``v`` ``(b, h, j_loc, dv)``.
    :param pad_mask: local boolean ``(b, j_loc)``, True marks padding.
    :param axis_name: the mesh axis the sequence is sharded over.
    :param axis_size: the axis' size when given (checked against the mesh).
    :param causal: right-aligned causal over the *global* lengths.
    :param mesh: the mesh; the ambient one (``with mesh:``) by default.
    :return: local ``(b, h, i_loc, dv)`` output chunk.
    """
    from perceiver_io_tpu_torch.parallel.mesh import current_mesh

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("ring_attention needs a mesh (pass mesh= or enter `with mesh:`)")
    if axis_size is not None and axis_size != mesh.shape[axis_name]:
        raise ValueError(f"axis_size={axis_size} but the mesh's {axis_name!r} axis is {mesh.shape[axis_name]}")
    return _RingFunction.apply(q, k, v, pad_mask, mesh.group(axis_name), causal)


class _RingSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pad, group, causal):
        n, s = collectives.group_size(group), collectives.group_rank(group)
        i_loc, j_loc = q.shape[2] // n, k.shape[2] // n
        qs = q[:, :, s * i_loc:(s + 1) * i_loc].contiguous()
        ks = k[:, :, s * j_loc:(s + 1) * j_loc].contiguous()
        vs = v[:, :, s * j_loc:(s + 1) * j_loc].contiguous()
        ps = None if pad is None else pad[:, s * j_loc:(s + 1) * j_loc].contiguous()
        o, lse = _forward(qs, ks, vs, ps, group, causal)
        ctx.save_for_backward(qs, ks, vs, o, lse)
        ctx.pad, ctx.group, ctx.causal = ps, group, causal
        return collectives.all_gather(o, group, dim=2)

    @staticmethod
    def backward(ctx, do):
        qs, ks, vs, o, lse = ctx.saved_tensors
        n, s = collectives.group_size(ctx.group), collectives.group_rank(ctx.group)
        i_loc = qs.shape[2]
        dos = do[:, :, s * i_loc:(s + 1) * i_loc].contiguous()
        dq, dk, dv = _backward(qs, ks, vs, ctx.pad, o, lse, dos, ctx.group, ctx.causal)
        grads = [collectives.all_gather(g, ctx.group, dim=2) for g in (dq, dk, dv)]
        return grads[0], grads[1], grads[2], None, None, None


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                           axis_name: str = "seq", pad_mask: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """Ring attention over the whole q/k/v held by every rank of the
    ``axis_name`` group: each rank runs the ring on its chunk and the
    output (and, in the backward, dq/dk/dv) is gathered."""
    if causal and k.shape[2] < q.shape[2]:
        raise ValueError("causal ring attention requires kv_len >= q_len")
    n_seq = mesh.shape[axis_name]
    if q.shape[2] % n_seq or k.shape[2] % n_seq:
        raise ValueError(
            f"q_len={q.shape[2]} and kv_len={k.shape[2]} must divide the "
            f"'{axis_name}' axis size {n_seq}"
        )
    return _RingSharded.apply(q, k, v, pad_mask, mesh.group(axis_name), causal)
