"""Image classifier CLI (counterpart of
``perceiver_io_tpu/scripts/vision/image_classifier.py``; reference
``perceiver/scripts/vision/image_classifier.py``):

    python -m perceiver_io_tpu_torch.scripts.vision.image_classifier fit \
        --data=mnist --trainer.max_steps=5000

The defaults are JAX's: 32 latents of 128 channels, 32 Fourier bands, one
output query of 128 channels, fp32 compute.
``--data=mnist`` reads MNIST from a local HF datasets cache;
``--data=synthetic`` needs no data. Add ``--device=cpu`` to run on the CPU.
"""
from __future__ import annotations

from perceiver_io_tpu_torch.data.vision import MNISTDataModule, SyntheticImageDataModule
from perceiver_io_tpu_torch.models.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.models.vision.image_classifier import (
    ImageClassifier,
    ImageClassifierConfig,
    ImageEncoderConfig,
)
from perceiver_io_tpu_torch.scripts.cli import CLI, ModelFamily
from perceiver_io_tpu_torch.training.tasks import image_classifier_loss_fn

DATA = {"mnist": MNISTDataModule, "synthetic": SyntheticImageDataModule}


def _link(dm, values):
    values.setdefault("model.encoder.image_shape", dm.image_shape)
    values.setdefault("model.decoder.num_classes", dm.num_classes)


FAMILY = ModelFamily(
    name="perceiver_io_tpu_torch.scripts.vision.image_classifier",
    config_class=ImageClassifierConfig,
    nested={"encoder": ImageEncoderConfig, "decoder": ClassificationDecoderConfig},
    data_registry=DATA,
    build_model=lambda cfg, dm, **kw: ImageClassifier(cfg, **kw),
    make_loss=lambda model, cfg: image_classifier_loss_fn(model),
    link=_link,
    # Paper config of the reference CLI (``vision/image_classifier.py:8-30``):
    # 32 latents x 128 channels on MNIST.
    defaults={
        "model.num_latents": 32,
        "model.num_latent_channels": 128,
        "model.encoder.num_frequency_bands": 32,
        "model.decoder.num_output_query_channels": 128,
        "lr_scheduler.name": "cosine",
        "lr_scheduler.warmup_steps": 500,
    },
)


def main(argv=None):
    return CLI(FAMILY).main(argv)


if __name__ == "__main__":
    main()
