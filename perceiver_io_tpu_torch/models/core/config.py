"""Perceiver AR hyperparameters, with the JAX package's field names
(``perceiver_io_tpu/models/core/config.py``), so a config dict round-trips
between the two packages. The dropout rates reach the model: prefix dropout
acts in train mode, attention and residual dropout raise there, and
activation checkpointing and offloading raise when set (not ported yet)."""
from __future__ import annotations

from dataclasses import asdict, dataclass, fields
from typing import Any, Dict, Optional


@dataclass
class PerceiverARConfig:
    num_heads: int = 8
    max_heads_parallel: Optional[int] = None
    num_self_attention_layers: int = 8
    self_attention_widening_factor: int = 4
    cross_attention_widening_factor: int = 4
    cross_attention_dropout: float = 0.5
    post_attention_dropout: float = 0.0
    residual_dropout: float = 0.0
    activation_checkpointing: bool = False
    activation_offloading: bool = False

    def base_kwargs(self) -> Dict[str, Any]:
        names = [f.name for f in fields(PerceiverARConfig)]
        return {k: v for k, v in asdict(self).items() if k in names}
