"""Vision data of the port: image preprocessing and the MNIST and synthetic
image data modules (:mod:`.image`), ImageNet preprocessing
(:mod:`.imagenet`), the optical-flow processor and renderer
(:mod:`.optical_flow`) and video frame I/O (:mod:`.video`). Counterpart of
``perceiver_io_tpu/data/vision``."""
from perceiver_io_tpu_torch.data.vision.image import (
    ImagePreprocessor,
    MNISTDataModule,
    SyntheticImageDataModule,
    random_crop_and_flip,
)
from perceiver_io_tpu_torch.data.vision.imagenet import ImageNetPreprocessor, resize_bilinear
from perceiver_io_tpu_torch.data.vision.optical_flow import OpticalFlowProcessor, render_optical_flow

__all__ = [
    "ImagePreprocessor",
    "ImageNetPreprocessor",
    "resize_bilinear",
    "MNISTDataModule",
    "SyntheticImageDataModule",
    "random_crop_and_flip",
    "OpticalFlowProcessor",
    "render_optical_flow",
]
