"""Image classifier (Perceiver IO) with Fourier-feature position encodings.
Counterpart of ``perceiver_io_tpu/models/vision/image_classifier.py``:
channels-last pixels with their Fourier features go through the Perceiver
IO encoder, and a classification decoder reads the latents. The encoder's
cross-attention q/k channels default to the adapter's input channels (3 +
2 * (2 * bands + 1) for an RGB image), its v channels to the q/k ones."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.models.core.adapter import InputAdapter
from perceiver_io_tpu_torch.models.core.config import (
    ClassificationDecoderConfig,
    EncoderConfig,
    PerceiverIOConfig,
    register_config,
)
from perceiver_io_tpu_torch.models.core.modules import PerceiverEncoder, init_weights
from perceiver_io_tpu_torch.models.text.classifier import classification_decoder
from perceiver_io_tpu_torch.ops.position import FourierPositionEncoding


@register_config
@dataclass
class ImageEncoderConfig(EncoderConfig):
    image_shape: Tuple[int, int, int] = (224, 224, 3)
    num_frequency_bands: int = 32


ImageClassifierConfig = PerceiverIOConfig[ImageEncoderConfig, ClassificationDecoderConfig]


class ImageInputAdapter(InputAdapter):
    """``(b, h, w, c)`` pixels -> ``(b, h * w, c + fourier channels)`` in
    ``dtype``: the pixels flattened channels-last, their Fourier position
    features concatenated. A batch of another image shape raises
    ``ValueError``, as in JAX. No parameters."""

    def __init__(self, image_shape: Tuple[int, int, int], num_frequency_bands: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.dtype = dtype
        self.position_encoding = FourierPositionEncoding(self.image_shape[:-1], num_frequency_bands)

    @property
    def num_input_channels(self) -> int:
        return self.image_shape[-1] + self.position_encoding.num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, *d = x.shape
        if tuple(d) != self.image_shape:
            raise ValueError(f"Input image shape {tuple(d)} different from required shape {self.image_shape}")
        x = x.reshape(b, -1, self.image_shape[-1])
        pos = self.position_encoding(b, device=x.device)
        return torch.cat([x.float(), pos], dim=-1).to(self.dtype)


def image_encoder(config: ImageClassifierConfig, dtype: torch.dtype = torch.float32,
                  attention_impl: str = "auto") -> PerceiverEncoder:
    """The image classifier's encoder: the Fourier pixel adapter and the
    Perceiver IO encoder, its cross-attention q/k channels the adapter's
    input channels unless set."""
    enc = config.encoder
    adapter = ImageInputAdapter(enc.image_shape, enc.num_frequency_bands, dtype)
    kwargs = enc.base_kwargs()
    if kwargs["num_cross_attention_qk_channels"] is None:
        kwargs["num_cross_attention_qk_channels"] = adapter.num_input_channels
    return PerceiverEncoder(
        adapter, config.num_latents, config.num_latent_channels,
        activation_checkpointing=config.activation_checkpointing,
        activation_offloading=config.activation_offloading, dtype=dtype, attention_impl=attention_impl,
        **kwargs)


class ImageClassifier(nn.Module):
    """Image encoder plus a classification decoder: ``(b, h, w, c)`` float
    pixels -> ``(b, num_classes)`` logits.

    Weights are made from ``seed`` with a ``torch.Generator`` on ``device``;
    load trained or JAX weights with ``load_state_dict``
    (:mod:`perceiver_io_tpu_torch.convert.from_jax`).

    :param dtype: computation type; parameters stay fp32.
    :param device: ``"cuda"`` by default; the CPU only when asked for.
    """

    def __init__(self, config: ImageClassifierConfig, *, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.dtype = dtype
        with torch.device("meta"):
            self.encoder = image_encoder(config, dtype, attention_impl)
            self.decoder = classification_decoder(config, dtype, attention_impl)
        self.to_empty(device=dev)
        init_weights(self, config.encoder.init_scale, torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.encoder.latent_provider.query.device

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:return: ``(b, num_classes)`` logits of ``(b, h, w, c)`` pixels.

        :param deterministic: False is train mode (dropout drawn from
            ``generator``)."""
        x_latent = self.encoder(x, deterministic=deterministic, generator=generator)
        return self.decoder(x_latent, deterministic=deterministic, generator=generator)
