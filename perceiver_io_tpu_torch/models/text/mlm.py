"""Masked language model (Perceiver IO). Counterpart of
``perceiver_io_tpu/models/text/mlm.py``: the text encoder and a decoder of
``max_seq_len`` trainable output queries, with a weight-tied output head
(``num_output_query_channels=None``: logits against the encoder's token
embedding) or an untied linear one."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.models.core.adapter import TrainableQueryProvider
from perceiver_io_tpu_torch.models.core.config import DecoderConfig, PerceiverIOConfig, register_config
from perceiver_io_tpu_torch.models.core.modules import PerceiverDecoder, init_weights
from perceiver_io_tpu_torch.models.sequence import TiedOutputAdapter
from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig, make_text_encoder


@register_config
@dataclass
class TextDecoderConfig(DecoderConfig):
    """``num_output_query_channels=None`` selects the weight-tied output
    head."""

    num_output_query_channels: Optional[int] = None
    vocab_size: int = 10003
    max_seq_len: int = 512


MaskedLanguageModelConfig = PerceiverIOConfig[TextEncoderConfig, TextDecoderConfig]


class UntiedTextOutputAdapter(nn.Module):
    """Linear vocabulary projection (the untied head)."""

    def __init__(self, vocab_size: int, num_output_query_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(num_output_query_channels, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype), self.linear.bias.to(self.dtype))


class MaskedLanguageModel(nn.Module):
    """Text encoder plus a decoder of ``max_seq_len`` trainable output
    queries; the logits are cut to the input's length.

    Weights are made from ``seed`` with a ``torch.Generator`` on ``device``
    (the JAX package's initialisers); load trained or JAX weights with
    ``load_state_dict`` (:mod:`perceiver_io_tpu_torch.convert.from_jax`).

    :param dtype: computation type; parameters stay fp32.
    :param device: ``"cuda"`` by default; the CPU only when asked for.
    """

    def __init__(self, config: MaskedLanguageModelConfig, *, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.dtype = dtype
        enc, dec = config.encoder, config.decoder
        ckpt = dict(activation_checkpointing=config.activation_checkpointing,
                    activation_offloading=config.activation_offloading)
        with torch.device("meta"):
            self.encoder = make_text_encoder(enc, config.num_latents, config.num_latent_channels,
                                             dtype=dtype, attention_impl=attention_impl, **ckpt)
            if self.tied:
                channels = enc.num_input_channels
                output_adapter = TiedOutputAdapter(dec.vocab_size, dtype=dtype)
            else:
                channels = dec.num_output_query_channels
                output_adapter = UntiedTextOutputAdapter(dec.vocab_size, channels, dtype=dtype)
            self.decoder = PerceiverDecoder(
                output_adapter, TrainableQueryProvider(dec.max_seq_len, channels, dec.init_scale, dtype),
                config.num_latent_channels, channels, dtype=dtype, attention_impl=attention_impl,
                **ckpt, **dec.base_kwargs(),
            )
        self.to_empty(device=dev)
        init_weights(self, enc.init_scale, torch.Generator(device=dev).manual_seed(seed))
        if self.tied:
            nn.init.zeros_(self.decoder.output_adapter.bias)

    @property
    def tied(self) -> bool:
        return self.config.decoder.num_output_query_channels is None

    @property
    def device(self) -> torch.device:
        return self.encoder.input_adapter.embeddings.device

    def forward(self, x_masked: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:return: ``(b, n, vocab_size)`` logits of the ``(b, n)`` token ids.

        :param deterministic: False is train mode (dropout drawn from
            ``generator``, a ``torch.Generator`` on the model's device)."""
        n = x_masked.shape[1]
        x_latent = self.encoder(x_masked, pad_mask=pad_mask, deterministic=deterministic, generator=generator)
        kwargs = {"txt_embedding": self.encoder.input_adapter.embeddings} if self.tied else {}
        logits = self.decoder(x_latent, deterministic=deterministic, generator=generator, **kwargs)
        return logits[:, :n, :]
