"""Models of the port and :func:`model_for_config`, the dispatch from a
config to its model class. Counterpart of ``perceiver_io_tpu/models``; the
Perceiver AR sequence-model families are ported: the causal LM and the
symbolic-audio model."""
from __future__ import annotations

from typing import Any, Optional

import torch

from perceiver_io_tpu_torch._device import DeviceLike


def model_for_config(config: Any, *, dtype: Optional[torch.dtype] = None,
                     attention_impl: str = "auto", device: DeviceLike = "cuda", seed: int = 0):
    """The model of ``config``'s family, with weights made from ``seed``
    (load trained ones with ``load_state_dict``)."""
    from perceiver_io_tpu_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig
    from perceiver_io_tpu_torch.models.sequence import AutoregressiveSequenceModel, SequenceModelConfig
    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig

    kwargs = dict(dtype=dtype or torch.float32, attention_impl=attention_impl, device=device, seed=seed)
    if isinstance(config, CausalLanguageModelConfig):
        return CausalLanguageModel(config, **kwargs)
    if isinstance(config, SymbolicAudioModelConfig):
        return SymbolicAudioModel(config, **kwargs)
    if isinstance(config, SequenceModelConfig):
        return AutoregressiveSequenceModel(config, **kwargs)
    raise ValueError(f"no model of the port for config {type(config).__name__}")


__all__ = ["model_for_config"]
