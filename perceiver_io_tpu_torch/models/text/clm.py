"""Causal language model (Perceiver AR): the sequence model with the text
defaults. Counterpart of ``perceiver_io_tpu/models/text/clm.py``."""
from __future__ import annotations

from dataclasses import dataclass

from perceiver_io_tpu_torch.models.core.config import register_config
from perceiver_io_tpu_torch.models.sequence import AutoregressiveSequenceModel, SequenceModelConfig


@register_config
@dataclass
class CausalLanguageModelConfig(SequenceModelConfig):
    vocab_size: int = 262
    max_seq_len: int = 4096
    max_latents: int = 512
    num_channels: int = 512


class CausalLanguageModel(AutoregressiveSequenceModel):
    """Perceiver AR causal language model."""
