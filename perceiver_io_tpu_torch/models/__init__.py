"""Models of the port and :func:`model_for_config`, the dispatch from a
config to its model class. Counterpart of ``perceiver_io_tpu/models``; the
Perceiver AR sequence-model families (the causal LM and the
symbolic-audio model) and the Perceiver IO masked LM, text classifier,
image classifier and optical-flow model are ported."""
from __future__ import annotations

from typing import Any, Optional

import torch

from perceiver_io_tpu_torch._device import DeviceLike


def import_task_modules() -> None:
    """Import every ported task-model module: importing one registers its
    config dataclasses (``models.core.config.register_config``), which is
    what lets a checkpoint's config rebuild before any model was imported."""
    import perceiver_io_tpu_torch.models.audio.symbolic  # noqa: F401
    import perceiver_io_tpu_torch.models.text.clm  # noqa: F401
    import perceiver_io_tpu_torch.models.text.classifier  # noqa: F401
    import perceiver_io_tpu_torch.models.text.mlm  # noqa: F401
    import perceiver_io_tpu_torch.models.vision.image_classifier  # noqa: F401
    import perceiver_io_tpu_torch.models.vision.optical_flow  # noqa: F401


def model_for_config(config: Any, *, dtype: Optional[torch.dtype] = None,
                     attention_impl: str = "auto", device: DeviceLike = "cuda", seed: int = 0):
    """The model of ``config``'s family, with weights made from ``seed``
    (load trained ones with ``load_state_dict``)."""
    from perceiver_io_tpu_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig
    from perceiver_io_tpu_torch.models.core.config import ClassificationDecoderConfig, PerceiverIOConfig
    from perceiver_io_tpu_torch.models.sequence import AutoregressiveSequenceModel, SequenceModelConfig
    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
    from perceiver_io_tpu_torch.models.text.classifier import TextClassifier
    from perceiver_io_tpu_torch.models.text.mlm import MaskedLanguageModel, TextDecoderConfig
    from perceiver_io_tpu_torch.models.vision.image_classifier import ImageClassifier, ImageEncoderConfig
    from perceiver_io_tpu_torch.models.vision.optical_flow import OpticalFlow, OpticalFlowEncoderConfig

    kwargs = dict(dtype=dtype or torch.float32, attention_impl=attention_impl, device=device, seed=seed)
    if isinstance(config, CausalLanguageModelConfig):
        return CausalLanguageModel(config, **kwargs)
    if isinstance(config, SymbolicAudioModelConfig):
        return SymbolicAudioModel(config, **kwargs)
    if isinstance(config, SequenceModelConfig):
        return AutoregressiveSequenceModel(config, **kwargs)
    if isinstance(config, PerceiverIOConfig) and isinstance(config.encoder, TextEncoderConfig):
        if isinstance(config.decoder, TextDecoderConfig):
            return MaskedLanguageModel(config, **kwargs)
        if isinstance(config.decoder, ClassificationDecoderConfig):
            return TextClassifier(config, **kwargs)
    if (isinstance(config, PerceiverIOConfig) and isinstance(config.encoder, ImageEncoderConfig)
            and isinstance(config.decoder, ClassificationDecoderConfig)):
        return ImageClassifier(config, **kwargs)
    if isinstance(config, PerceiverIOConfig) and isinstance(config.encoder, OpticalFlowEncoderConfig):
        return OpticalFlow(config, **kwargs)
    raise ValueError(f"no model of the port for config {type(config).__name__}")


__all__ = ["import_task_modules", "model_for_config"]
