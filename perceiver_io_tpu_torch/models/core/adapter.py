"""Adapter base class (counterpart of ``perceiver_io_tpu/models/core/adapter.py``;
the query providers and classification head come with the encoder families)."""
from __future__ import annotations

from torch import nn


class InputAdapter(nn.Module):
    """Base class: subclasses expose ``num_input_channels``."""

    @property
    def num_input_channels(self) -> int:
        raise NotImplementedError
