"""Shared text components: the encoder config, the token input adapter and
:func:`make_text_encoder`, which makes the text Perceiver IO encoder.
Counterpart of ``perceiver_io_tpu/models/text/common.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from perceiver_io_tpu_torch.models.core.adapter import InputAdapter
from perceiver_io_tpu_torch.models.core.config import EncoderConfig, register_config
from perceiver_io_tpu_torch.models.core.modules import PerceiverEncoder
from perceiver_io_tpu_torch.ops.embedding import Embedding
from perceiver_io_tpu_torch.ops.position import positions


@register_config
@dataclass
class TextEncoderConfig(EncoderConfig):
    """``params`` points at a checkpoint to warm-start the encoder from (a
    pretrained masked LM)."""

    vocab_size: int = 10003
    max_seq_len: int = 256
    num_input_channels: int = 64
    params: Optional[str] = None
    freeze: bool = False


class TextInputAdapter(InputAdapter):
    """Token embedding plus a learned absolute position embedding, for the
    (non-rotary) Perceiver IO encoders; returns the embedded input in
    ``dtype``. A sequence longer than ``max_seq_len`` raises ``ValueError``,
    as in JAX."""

    def __init__(self, vocab_size: int, max_seq_len: int, num_channels: int, abs_pos_emb: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.num_channels = num_channels
        self.abs_pos_emb = abs_pos_emb
        self.dtype = dtype
        self.txt_embedding = Embedding(vocab_size, num_channels)
        if abs_pos_emb:
            self.pos_embedding = Embedding(max_seq_len, num_channels)

    @property
    def num_input_channels(self) -> int:
        return self.num_channels

    def forward(self, x: torch.Tensor, abs_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.shape[1] > self.max_seq_len:
            raise ValueError(f"sequence length ({x.shape[1]}) exceeds max_seq_len ({self.max_seq_len})")
        emb = self.txt_embedding(x)
        if self.abs_pos_emb:
            if abs_pos is None:
                abs_pos = positions(*x.shape, device=x.device)
            emb = emb + self.pos_embedding(abs_pos)
        return emb.to(self.dtype)

    @property
    def embeddings(self) -> torch.Tensor:
        """``(vocab, channels)`` embedding table, for the tied output head."""
        return self.txt_embedding.weight


def make_text_encoder(config: TextEncoderConfig, num_latents: int, num_latent_channels: int,
                      activation_checkpointing: bool = False, activation_offloading: bool = False,
                      dtype: torch.dtype = torch.float32, attention_impl: str = "auto") -> PerceiverEncoder:
    """The text Perceiver IO encoder of ``config``. Freezing
    (``config.freeze``) acts in the optimizer, not on the module."""
    adapter = TextInputAdapter(config.vocab_size, config.max_seq_len, config.num_input_channels,
                               dtype=dtype)
    return PerceiverEncoder(
        adapter, num_latents, num_latent_channels,
        activation_checkpointing=activation_checkpointing, activation_offloading=activation_offloading,
        dtype=dtype, attention_impl=attention_impl, **config.base_kwargs(),
    )
