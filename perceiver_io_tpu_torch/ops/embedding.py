"""A token embedding whose gradient is the same on every run.

``nn.Embedding``'s CUDA backward adds each token's output gradient into its
row of the table with atomics (``compute_grad_weight_atomic_accumulate``),
so the order of the additions, and with it the rounding of a row that many
tokens share, changes from run to run: a training run on the card was not
bit-reproducible (the masked LM's CLI fit and ``Trainer.fit`` from the same
seeds drifted apart in the last step's loss). The JAX package's gradient is
a scatter-add that XLA sums in a fixed order. :class:`Embedding` keeps
``nn.Embedding``'s parameters, initialisation and forward, and gives the
backward a fixed order on every device: the tokens are sorted by id
(stable, so a row's tokens stay in token order) and each id's rows are
summed in that order in fp32 (:func:`embedding_grad`). The per-id counts are
integer sums, exact in any order, and nothing waits on the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable


def embedding_grad(grad: torch.Tensor, ids: torch.Tensor, num_weights: int) -> torch.Tensor:
    """The gradient of an embedding table of ``num_weights`` rows with
    respect to a lookup of ``ids``: each row the sum, in token order and in
    fp32, of the output gradients ``grad`` (``ids.shape + (channels,)``) of
    the tokens that read it; 0 for a row no token reads. In ``grad``'s type."""
    flat = ids.reshape(-1)
    rows = grad.reshape(flat.numel(), -1).float()
    counts = torch.zeros(num_weights, dtype=torch.long, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.long))
    order = torch.argsort(flat, stable=True)
    out = torch.segment_reduce(rows[order], "sum", lengths=counts, unsafe=True)
    return out.to(grad.dtype)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.num_weights = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return None, embedding_grad(grad, ids, ctx.num_weights)


class Embedding(nn.Embedding):
    """``nn.Embedding`` (same parameter, initialisation and forward) whose
    weight gradient comes from :func:`embedding_grad`. It takes no
    ``padding_idx``, ``max_norm`` or sparse gradient."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.padding_idx is not None or self.max_norm is not None or self.sparse:
            raise ValueError("Embedding takes no padding_idx, max_norm or sparse gradient")
        return _Lookup.apply(ids, self.weight)
