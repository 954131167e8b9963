"""Text classifier CLI (counterpart of
``perceiver_io_tpu/scripts/text/classifier.py``; reference
``perceiver/scripts/text/classifier.py``):

    python -m perceiver_io_tpu_torch.scripts.text.classifier fit --data=imdb \
        --model.encoder.params=<mlm dir> --model.encoder.freeze=true

Two-stage training: ``--model.encoder.params=<dir>`` warm-starts the
encoder from a masked LM saved by ``save_pretrained`` (or a trainer
checkpoint dir), ``--model.encoder.freeze=true`` leaves the encoder out of
the optimizer (the decoder-only stage; its gradients are still computed, as
under JAX's masked optimizer). The defaults are JAX's: 256 latents of 1280
channels, the encoder's q/k and v channels unset (8 heads of 160), one
output query of 1280 channels over 8 heads, fp32 compute. Add
``--device=cpu`` to run on the CPU.
"""
from __future__ import annotations

from perceiver_io_tpu_torch.data.text.sources import ImdbDataModule, ListDataModule, SyntheticTextDataModule
from perceiver_io_tpu_torch.models.core.config import ClassificationDecoderConfig
from perceiver_io_tpu_torch.models.text.classifier import TextClassifier, TextClassifierConfig
from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
from perceiver_io_tpu_torch.scripts.cli import CLI, ModelFamily
from perceiver_io_tpu_torch.training.tasks import classifier_loss_fn

DATA = {
    "synthetic": SyntheticTextDataModule,
    "imdb": ImdbDataModule,
    "list": ListDataModule,
}


def _link(dm, values):
    values.setdefault("model.encoder.vocab_size", dm.vocab_size)
    values.setdefault("model.encoder.max_seq_len", dm.max_seq_len)
    if dm.num_classes is not None:
        values.setdefault("model.decoder.num_classes", dm.num_classes)


def _initial_params(model, cfg, dm) -> None:
    """Warm start: the encoder's weights from the saved model at
    ``cfg.encoder.params`` (its ``encoder`` submodule; strict)."""
    if cfg.encoder.params is None:
        return
    from perceiver_io_tpu_torch.training.checkpoint import load_subtree

    model.encoder.load_state_dict(load_subtree(cfg.encoder.params, "encoder"), strict=True)


FAMILY = ModelFamily(
    name="perceiver_io_tpu_torch.scripts.text.classifier",
    config_class=TextClassifierConfig,
    nested={"encoder": TextEncoderConfig, "decoder": ClassificationDecoderConfig},
    data_registry=DATA,
    build_model=lambda cfg, dm, **kw: TextClassifier(cfg, **kw),
    make_loss=lambda model, cfg: classifier_loss_fn(model),
    link=_link,
    initial_params=_initial_params,
    frozen_prefixes=lambda cfg: ("encoder",) if cfg.encoder.freeze else (),
    defaults={
        "data.task": "clf",
        "model.num_latents": 256,
        "model.num_latent_channels": 1280,
        "model.decoder.num_output_query_channels": 1280,
        "lr_scheduler.name": "constant",
        "lr_scheduler.warmup_steps": 100,
    },
)


def main(argv=None):
    return CLI(FAMILY).main(argv)


if __name__ == "__main__":
    main()
