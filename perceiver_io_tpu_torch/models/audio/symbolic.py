"""Symbolic audio model (Perceiver AR over MIDI event tokens): the sequence
model with a 389-token event vocabulary (388 events and the pad token).
Counterpart of ``perceiver_io_tpu/models/audio/symbolic.py``."""
from __future__ import annotations

from dataclasses import dataclass

from perceiver_io_tpu_torch.models.core.config import register_config
from perceiver_io_tpu_torch.models.sequence import AutoregressiveSequenceModel, SequenceModelConfig


@register_config
@dataclass
class SymbolicAudioModelConfig(SequenceModelConfig):
    """The reference's defaults. The GiantMIDI checkpoint's widths are
    ``max_seq_len=6144, max_latents=2048, num_channels=768,
    num_self_attention_layers=12`` (head dim 96 over the default 8 heads)."""

    vocab_size: int = 389
    max_seq_len: int = 4096
    max_latents: int = 1024
    num_channels: int = 512


class SymbolicAudioModel(AutoregressiveSequenceModel):
    """Perceiver AR symbolic audio model."""
