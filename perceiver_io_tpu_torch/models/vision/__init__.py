"""Vision models of the port: the Fourier image classifier. Counterpart of
``perceiver_io_tpu/models/vision``; optical flow is not ported yet
(``ROADMAP.md`` A.3)."""
from perceiver_io_tpu_torch.models.vision.image_classifier import (
    ImageClassifier,
    ImageClassifierConfig,
    ImageEncoderConfig,
    ImageInputAdapter,
)

__all__ = ["ImageClassifier", "ImageClassifierConfig", "ImageEncoderConfig", "ImageInputAdapter"]
