"""Autoregressive sequence model over a token vocabulary: the backbone of
the text CLM. Counterpart of ``perceiver_io_tpu/models/sequence.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.models.core.adapter import InputAdapter
from perceiver_io_tpu_torch.models.core.config import PerceiverARConfig, register_config
from perceiver_io_tpu_torch.models.core.modules import (
    LAYER_NORM_EPS,
    PerceiverAR,
    init_weights,
    layer_norm,
)
from perceiver_io_tpu_torch.ops.embedding import Embedding
from perceiver_io_tpu_torch.ops.position import frequency_position_encoding, positions


@register_config
@dataclass
class SequenceModelConfig(PerceiverARConfig):
    vocab_size: int = 262
    max_seq_len: int = 4096
    max_latents: int = 512
    num_channels: int = 512
    output_norm: bool = False
    output_bias: bool = True
    abs_pos_emb: bool = True
    init_scale: float = 0.02

    @property
    def max_prefix_len(self) -> int:
        return self.max_seq_len - self.max_latents

    @property
    def rotated_channels_per_head(self) -> int:
        """Rotary on all head channels, or half of them when a learned
        absolute position embedding is used too."""
        n = self.num_channels // self.num_heads
        return n // 2 if self.abs_pos_emb else n


class SequenceInputAdapter(InputAdapter):
    """Token embedding plus optional learned absolute position embedding,
    and the rotary angles of the positions."""

    def __init__(self, vocab_size: int, max_seq_len: int, num_channels: int,
                 rotated_channels_per_head: int, abs_pos_emb: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_channels = num_channels
        self.rotated_channels_per_head = rotated_channels_per_head
        self.abs_pos_emb = abs_pos_emb
        self.dtype = dtype
        self.txt_embedding = Embedding(vocab_size, num_channels)
        if abs_pos_emb:
            self.pos_embedding = Embedding(max_seq_len, num_channels)

    @property
    def num_input_channels(self) -> int:
        return self.num_channels

    def forward(self, x: torch.Tensor, abs_pos: Optional[torch.Tensor] = None):
        if abs_pos is None:
            abs_pos = positions(*x.shape, device=x.device)
        emb = self.txt_embedding(x)
        if self.abs_pos_emb:
            emb = emb + self.pos_embedding(abs_pos)
        frq = frequency_position_encoding(abs_pos, self.rotated_channels_per_head)
        return emb.to(self.dtype), frq

    @property
    def embeddings(self) -> torch.Tensor:
        """``(vocab, channels)`` embedding table, for the tied output head."""
        return self.txt_embedding.weight


class TiedOutputAdapter(nn.Module):
    """Logits ``x . E^T (+ bias)``: the weight-tied output head."""

    def __init__(self, vocab_size: int, emb_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bias = nn.Parameter(torch.zeros(vocab_size)) if emb_bias else None

    def forward(self, x: torch.Tensor, txt_embedding: torch.Tensor) -> torch.Tensor:
        logits = x @ txt_embedding.to(self.dtype).T
        if self.bias is not None:
            logits = logits + self.bias.to(self.dtype)
        return logits


class AutoregressiveSequenceModel(nn.Module):
    """Perceiver AR over a token vocabulary with tied input/output embeddings.

    Weights are made from ``seed`` with a ``torch.Generator`` on ``device``
    (the JAX package's initialisers); load trained or JAX weights with
    ``load_state_dict`` (see :mod:`perceiver_io_tpu_torch.convert.from_jax`).

    :param dtype: computation type; parameters stay fp32 (an inference
        pipeline may store them in bf16: ``pipelines.cast_float_params``).
    :param device: ``"cuda"`` by default; the CPU only when asked for.
    """

    def __init__(self, config: SequenceModelConfig, *, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.dtype = dtype
        with torch.device("meta"):
            adapter = SequenceInputAdapter(
                config.vocab_size, config.max_seq_len, config.num_channels,
                config.rotated_channels_per_head, config.abs_pos_emb, dtype=dtype,
            )
            kwargs = config.base_kwargs()
            self.perceiver_ar = PerceiverAR(adapter, dtype=dtype, attention_impl=attention_impl,
                                            **kwargs)
            if config.output_norm:
                self.out_norm = nn.LayerNorm(config.num_channels, eps=LAYER_NORM_EPS)
            self.output_adapter = TiedOutputAdapter(config.vocab_size, config.output_bias, dtype)
        self.to_empty(device=dev)
        init_weights(self, config.init_scale, torch.Generator(device=dev).manual_seed(seed))
        if self.output_adapter.bias is not None:
            nn.init.zeros_(self.output_adapter.bias)

    @property
    def device(self) -> torch.device:
        return self.perceiver_ar.input_adapter.embeddings.device

    @property
    def max_seq_len(self) -> int:
        return self.config.max_seq_len

    @property
    def max_latents(self) -> int:
        return self.config.max_latents

    @property
    def max_prefix_len(self) -> int:
        return self.config.max_prefix_len

    def head(self, x_last: torch.Tensor) -> torch.Tensor:
        """Next-token logits ``(b, vocab)`` of the last latent ``(b, c)``."""
        if self.config.output_norm:
            x_last = layer_norm(self.out_norm, x_last, self.dtype)
        return self.output_adapter(x_last[:, None], self.perceiver_ar.input_adapter.embeddings)[:, 0]

    def forward(self, x: torch.Tensor, prefix_len: int,
                pad_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:return: ``(b, n - prefix_len, vocab_size)`` logits of the latent
        positions (next-token predictions).

        :param deterministic: False is train mode (prefix dropout drawn from
            ``generator``, a ``torch.Generator`` on the model's device)."""
        if x.shape[1] > self.max_seq_len:
            raise ValueError(
                f"sequence length ({x.shape[1]}) exceeds max_seq_len ({self.max_seq_len})"
            )
        if prefix_len > self.max_prefix_len:
            raise ValueError(
                f"prefix_len ({prefix_len}) exceeds max_prefix_len ({self.max_prefix_len})"
            )
        x_latent = self.perceiver_ar(x, prefix_len, pad_mask, deterministic, generator)
        if self.config.output_norm:
            x_latent = layer_norm(self.out_norm, x_latent, self.dtype)
        return self.output_adapter(x_latent, self.perceiver_ar.input_adapter.embeddings)
