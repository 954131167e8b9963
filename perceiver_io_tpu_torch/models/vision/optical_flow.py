"""Optical flow (Perceiver IO). Counterpart of
``perceiver_io_tpu/models/vision/optical_flow.py``: two frames of 3 x 3
pixel-patch features go through a linear layer, their 2-D Fourier position
features are concatenated, and the Perceiver IO encoder reads the result;
the decoder's queries are that adapted input itself (one query per pixel),
and a linear head gives each pixel's two flow channels. The encoder's
cross-attention q/k and v channels default to the adapter's channels
(64 + 2 * (2 * 64 + 1) = 322 at the published width)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.models.core.adapter import InputAdapter
from perceiver_io_tpu_torch.models.core.config import (
    DecoderConfig,
    EncoderConfig,
    PerceiverIOConfig,
    register_config,
)
from perceiver_io_tpu_torch.models.core.modules import PerceiverDecoder, PerceiverEncoder, dense, init_weights
from perceiver_io_tpu_torch.ops.position import FourierPositionEncoding


@register_config
@dataclass
class OpticalFlowEncoderConfig(EncoderConfig):
    image_shape: Tuple[int, int] = (368, 496)
    num_patch_input_channels: int = 27
    num_patch_hidden_channels: int = 64
    num_frequency_bands: int = 64


@register_config
@dataclass
class OpticalFlowDecoderConfig(DecoderConfig):
    image_shape: Tuple[int, int] = (368, 496)
    rescale_factor: float = 100.0


OpticalFlowConfig = PerceiverIOConfig[OpticalFlowEncoderConfig, OpticalFlowDecoderConfig]


class OpticalFlowInputAdapter(InputAdapter):
    """``(b, 2, c, h, w)`` frame pair -> ``(b, h * w, hidden + fourier
    channels)`` in ``dtype``: the frames concatenated in channels (``(b, h,
    w, t * c)``, JAX's transpose order), a linear layer to
    ``num_patch_hidden_channels``, then the pixels' Fourier position
    features."""

    def __init__(self, image_shape: Tuple[int, int], num_patch_input_channels: int,
                 num_patch_hidden_channels: int, num_frequency_bands: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_patch_hidden_channels = num_patch_hidden_channels
        self.dtype = dtype
        self.position_encoding = FourierPositionEncoding(self.image_shape, num_frequency_bands)
        self.linear = nn.Linear(2 * num_patch_input_channels, num_patch_hidden_channels)

    @property
    def num_input_channels(self) -> int:
        return self.num_patch_hidden_channels + self.position_encoding.num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c, h, w = x.shape
        x = x.permute(0, 3, 4, 1, 2).reshape(b, h * w, t * c)
        x = dense(self.linear, x, self.dtype)
        pos = self.position_encoding(b, device=x.device)
        return torch.cat([x.float(), pos], dim=-1).to(self.dtype)


class OpticalFlowOutputAdapter(nn.Module):
    """A linear layer to the two flow channels, divided by
    ``rescale_factor``, reshaped to ``(b, h, w, 2)``."""

    def __init__(self, image_shape: Tuple[int, int], num_output_query_channels: int,
                 num_output_image_channels: int = 2, rescale_factor: float = 100.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.rescale_factor = rescale_factor
        self.dtype = dtype
        self.linear = nn.Linear(num_output_query_channels, num_output_image_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(self.linear, x, self.dtype) / self.rescale_factor
        return x.reshape(x.shape[0], *self.image_shape, x.shape[-1])


class OpticalFlow(nn.Module):
    """The optical-flow Perceiver IO: ``(b, 2, c, h, w)`` frame-pair patch
    features -> ``(b, h, w, 2)`` flow. The decoder has no query provider:
    its queries are the encoder's adapted input.

    Weights are made from ``seed`` with a ``torch.Generator`` on ``device``;
    load trained or JAX weights with ``load_state_dict``
    (:mod:`perceiver_io_tpu_torch.convert`).

    :param dtype: computation type; parameters stay fp32.
    :param device: ``"cuda"`` by default; the CPU only when asked for.
    """

    def __init__(self, config: OpticalFlowConfig, *, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.dtype = dtype
        enc, dec = config.encoder, config.decoder
        ckpt = dict(activation_checkpointing=config.activation_checkpointing,
                    activation_offloading=config.activation_offloading)
        with torch.device("meta"):
            adapter = OpticalFlowInputAdapter(enc.image_shape, enc.num_patch_input_channels,
                                              enc.num_patch_hidden_channels, enc.num_frequency_bands, dtype)
            channels = adapter.num_input_channels
            kwargs = enc.base_kwargs()
            for key in ("num_cross_attention_qk_channels", "num_cross_attention_v_channels"):
                if kwargs[key] is None:
                    kwargs[key] = channels
            self.encoder = PerceiverEncoder(adapter, config.num_latents, config.num_latent_channels, dtype=dtype,
                                            attention_impl=attention_impl, **ckpt, **kwargs)
            self.decoder = PerceiverDecoder(
                OpticalFlowOutputAdapter(dec.image_shape, channels, rescale_factor=dec.rescale_factor, dtype=dtype),
                None, config.num_latent_channels, channels, dtype=dtype, attention_impl=attention_impl,
                **ckpt, **dec.base_kwargs())
        self.to_empty(device=dev)
        init_weights(self, enc.init_scale, torch.Generator(device=dev).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.encoder.latent_provider.query.device

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:return: ``(b, h, w, 2)`` flow of ``(b, 2, c, h, w)`` features."""
        x_latent, x_adapted = self.encoder(x, return_adapted_input=True, deterministic=deterministic,
                                           generator=generator)
        return self.decoder(x_latent, x_adapted=x_adapted, deterministic=deterministic, generator=generator)
