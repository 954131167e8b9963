"""Vision models of the port: the Fourier image classifier and the
optical-flow Perceiver IO. Counterpart of ``perceiver_io_tpu/models/vision``."""
from perceiver_io_tpu_torch.models.vision.image_classifier import (
    ImageClassifier,
    ImageClassifierConfig,
    ImageEncoderConfig,
    ImageInputAdapter,
)
from perceiver_io_tpu_torch.models.vision.optical_flow import (
    OpticalFlow,
    OpticalFlowConfig,
    OpticalFlowDecoderConfig,
    OpticalFlowEncoderConfig,
    OpticalFlowInputAdapter,
    OpticalFlowOutputAdapter,
)

__all__ = ["ImageClassifier", "ImageClassifierConfig", "ImageEncoderConfig", "ImageInputAdapter", "OpticalFlow",
           "OpticalFlowConfig", "OpticalFlowDecoderConfig", "OpticalFlowEncoderConfig", "OpticalFlowInputAdapter",
           "OpticalFlowOutputAdapter"]
