"""Vision data of the port: image preprocessing and the MNIST and synthetic
image data modules (:mod:`.image`), ImageNet preprocessing
(:mod:`.imagenet`). Counterpart of ``perceiver_io_tpu/data/vision``; the
optical-flow processor and the video helpers are not ported yet
(``ROADMAP.md`` A.3)."""
from perceiver_io_tpu_torch.data.vision.image import (
    ImagePreprocessor,
    MNISTDataModule,
    SyntheticImageDataModule,
    random_crop_and_flip,
)
from perceiver_io_tpu_torch.data.vision.imagenet import ImageNetPreprocessor, resize_bilinear

__all__ = [
    "ImagePreprocessor",
    "ImageNetPreprocessor",
    "resize_bilinear",
    "MNISTDataModule",
    "SyntheticImageDataModule",
    "random_crop_and_flip",
]
