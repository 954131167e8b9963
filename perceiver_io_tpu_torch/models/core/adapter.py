"""Adapters and query providers. Counterpart of
``perceiver_io_tpu/models/core/adapter.py``: an input adapter turns a task's
input into the encoder's ``(b, m, c)`` input, an output adapter maps the
decoder's cross-attention output to the task's output, and a query provider
holds a trainable query array (the encoder's latents, most decoders' output
queries). :func:`rotary_frequencies` gives the rotary angles of a token grid
(the sequence models' input adapter, ``models/sequence.py``, computes the
same inline)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_tpu_torch.ops.position import frequency_position_encoding, positions


class InputAdapter(nn.Module):
    """Base class: subclasses expose ``num_input_channels``."""

    @property
    def num_input_channels(self) -> int:
        raise NotImplementedError


class TrainableQueryProvider(nn.Module):
    """A learnable ``(num_queries, channels)`` array, returned as ``(1, n, c)``
    in ``dtype`` (the parameter is ``query``, as in JAX). Its initial values
    are normal(``init_scale``) from the model's seeded init."""

    def __init__(self, num_queries: int, num_query_channels: int, init_scale: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_scale = init_scale
        self.dtype = dtype
        self.query = nn.Parameter(torch.empty(num_queries, num_query_channels))

    @property
    def num_query_channels(self) -> int:
        return self.query.shape[1]

    def forward(self, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.query[None].to(self.dtype)


class ClassificationOutputAdapter(nn.Module):
    """Linear head over the output queries; a single query's axis is
    squeezed away."""

    def __init__(self, num_classes: int, num_output_query_channels: int, init_scale: float = 0.02,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(num_output_query_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype), self.linear.bias.to(self.dtype))
        return x[:, 0] if x.shape[1] == 1 else x


def rotary_frequencies(x_shape, rotated_channels_per_head: int,
                       abs_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The frequency position encoding of a ``(b, n)`` token grid, the angles
    of Perceiver AR's rotary embeddings: ``(b, n, rotated_channels_per_head)``.

    :param abs_pos: ``(b, n)`` positions (shifted for left padding); default
        ``0..n-1``.
    """
    b, n = x_shape
    if abs_pos is None:
        abs_pos = positions(b, n)
    return frequency_position_encoding(abs_pos, rotated_channels_per_head)
