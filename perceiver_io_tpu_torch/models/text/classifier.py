"""Text classifier (Perceiver IO). Counterpart of
``perceiver_io_tpu/models/text/classifier.py``: the text encoder and a
decoder of trainable output queries (one, in the CLI's configuration) with
a linear classification head.

Two-stage training (warm start from a masked LM's encoder, then a frozen
encoder) acts in the CLI and the optimizer: ``TextEncoderConfig.params``
names the saved model whose encoder is loaded, ``TextEncoderConfig.freeze``
leaves the encoder out of the optimizer
(``perceiver_io_tpu_torch/scripts/text/classifier.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.models.core.adapter import ClassificationOutputAdapter, TrainableQueryProvider
from perceiver_io_tpu_torch.models.core.config import ClassificationDecoderConfig, PerceiverIOConfig
from perceiver_io_tpu_torch.models.core.modules import PerceiverDecoder, init_weights
from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig, make_text_encoder

TextClassifierConfig = PerceiverIOConfig[TextEncoderConfig, ClassificationDecoderConfig]


def classification_decoder(config: PerceiverIOConfig, dtype: torch.dtype,
                           attention_impl: str) -> PerceiverDecoder:
    """The classifiers' decoder: ``num_output_queries`` trainable queries
    cross-attend to the latents, and a linear head maps them to the classes
    (a single query's axis squeezed away)."""
    dec = config.decoder
    return PerceiverDecoder(
        ClassificationOutputAdapter(dec.num_classes, dec.num_output_query_channels, dec.init_scale, dtype),
        TrainableQueryProvider(dec.num_output_queries, dec.num_output_query_channels, dec.init_scale, dtype),
        config.num_latent_channels, dec.num_output_query_channels, dtype=dtype,
        attention_impl=attention_impl, activation_checkpointing=config.activation_checkpointing,
        activation_offloading=config.activation_offloading, **dec.base_kwargs(),
    )


class TextClassifier(nn.Module):
    """Text encoder plus a classification decoder: ``(b, n)`` token ids ->
    ``(b, num_classes)`` logits.

    Weights are made from ``seed`` with a ``torch.Generator`` on ``device``
    (the JAX package's initialisers); load trained or JAX weights with
    ``load_state_dict`` (:mod:`perceiver_io_tpu_torch.convert.from_jax`).

    :param dtype: computation type; parameters stay fp32.
    :param device: ``"cuda"`` by default; the CPU only when asked for.
    """

    def __init__(self, config: TextClassifierConfig, *, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.dtype = dtype
        with torch.device("meta"):
            self.encoder = make_text_encoder(
                config.encoder, config.num_latents, config.num_latent_channels,
                activation_checkpointing=config.activation_checkpointing,
                activation_offloading=config.activation_offloading, dtype=dtype,
                attention_impl=attention_impl)
            self.decoder = classification_decoder(config, dtype, attention_impl)
        self.to_empty(device=dev)
        init_weights(self, config.encoder.init_scale, torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.encoder.input_adapter.embeddings.device

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:return: ``(b, num_classes)`` logits (``(b, queries, classes)``
        with more than one output query).

        :param deterministic: False is train mode (dropout drawn from
            ``generator``, a ``torch.Generator`` on the model's device)."""
        x_latent = self.encoder(x, pad_mask=pad_mask, deterministic=deterministic, generator=generator)
        return self.decoder(x_latent, deterministic=deterministic, generator=generator)
