"""Masked language model CLI (counterpart of
``perceiver_io_tpu/scripts/text/mlm.py``; reference
``perceiver/scripts/text/mlm.py``):

    python -m perceiver_io_tpu_torch.scripts.text.mlm fit --data=synthetic \
        --data.dataset_dir=.cache/synthetic --trainer.max_steps=10000

Add ``--device=cpu`` to run on the CPU. The defaults are JAX's: 256
latents of 1280 channels, and the encoder's and decoder's q/k and v channels
unset, which makes every encoder head 160 wide, q and k included. The
published language-perceiver widths (qk 256 over 8 heads, v 1280 in the
encoder, ``d_model`` 768) are set through flags, e.g.
``--model.encoder.num_cross_attention_qk_channels=256
--model.encoder.num_cross_attention_v_channels=1280``.
``serve`` refuses this family's checkpoints: it serves text generation.
"""
from __future__ import annotations

import torch

from perceiver_io_tpu_torch.data.text.sources import (
    BookCorpusDataModule,
    ImdbDataModule,
    ListDataModule,
    SyntheticTextDataModule,
    WikipediaDataModule,
    WikiTextDataModule,
)
from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
from perceiver_io_tpu_torch.models.text.mlm import (
    MaskedLanguageModel,
    MaskedLanguageModelConfig,
    TextDecoderConfig,
)
from perceiver_io_tpu_torch.scripts.cli import CLI, ModelFamily
from perceiver_io_tpu_torch.training.tasks import mlm_loss_fn

DATA = {
    "synthetic": SyntheticTextDataModule,
    "wikitext": WikiTextDataModule,
    "imdb": ImdbDataModule,
    "bookcorpus": BookCorpusDataModule,
    "wikipedia": WikipediaDataModule,
    "list": ListDataModule,
}


def _link(dm, values):
    """data.vocab_size/max_seq_len → encoder and decoder (reference
    ``mlm.py:12-16``)."""
    values.setdefault("model.encoder.vocab_size", dm.vocab_size)
    values.setdefault("model.encoder.max_seq_len", dm.max_seq_len)
    values.setdefault("model.decoder.vocab_size", dm.vocab_size)
    values.setdefault("model.decoder.max_seq_len", dm.max_seq_len)


FAMILY = ModelFamily(
    name="perceiver_io_tpu_torch.scripts.text.mlm",
    config_class=MaskedLanguageModelConfig,
    nested={"encoder": TextEncoderConfig, "decoder": TextDecoderConfig},
    data_registry=DATA,
    build_model=lambda cfg, dm, **kw: MaskedLanguageModel(cfg, dtype=torch.bfloat16, **kw),
    make_loss=lambda model, cfg: mlm_loss_fn(model),
    link=_link,
    # Paper config of the reference CLI (``mlm.py:18-40``); the CLI pins
    # the data task.
    defaults={
        "data.task": "mlm",
        "model.num_latents": 256,
        "model.num_latent_channels": 1280,
        "lr_scheduler.name": "cosine",
        "lr_scheduler.warmup_steps": 1000,
    },
)


def main(argv=None):
    return CLI(FAMILY).main(argv)


if __name__ == "__main__":
    main()
