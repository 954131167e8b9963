"""Causal language model CLI (counterpart of
``perceiver_io_tpu/scripts/text/clm.py``; reference
``perceiver/scripts/text/clm.py``):

    python -m perceiver_io_tpu_torch.scripts.text.clm fit --data=synthetic \
        --data.dataset_dir=.cache/synthetic --trainer.max_steps=10000
    python -m perceiver_io_tpu_torch.scripts.text.clm serve \
        --ckpt=logs/checkpoints --serve.prompts=prompts.txt

Add ``--device=cpu`` to run on the CPU.
"""
from __future__ import annotations

import torch

from perceiver_io_tpu_torch.data.text.sources import (
    BookCorpusDataModule,
    Enwik8DataModule,
    ListDataModule,
    SyntheticTextDataModule,
    WikipediaDataModule,
    WikiTextDataModule,
)
from perceiver_io_tpu_torch.data.text.streaming import C4DataModule
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.scripts.cli import CLI, ModelFamily
from perceiver_io_tpu_torch.training.tasks import clm_loss_fn

DATA = {
    "synthetic": SyntheticTextDataModule,
    "wikitext": WikiTextDataModule,
    "enwik8": Enwik8DataModule,
    "bookcorpus": BookCorpusDataModule,
    "wikipedia": WikipediaDataModule,
    "c4": C4DataModule,
    "list": ListDataModule,
}


def _link(dm, values):
    """data.vocab_size/max_seq_len → model.* (reference ``clm.py:12-14``)."""
    values.setdefault("model.vocab_size", dm.vocab_size)
    values.setdefault("model.max_seq_len", dm.max_seq_len)


FAMILY = ModelFamily(
    name="perceiver_io_tpu_torch.scripts.text.clm",
    config_class=CausalLanguageModelConfig,
    data_registry=DATA,
    build_model=lambda cfg, dm, **kw: CausalLanguageModel(cfg, dtype=torch.bfloat16, **kw),
    make_loss=lambda model, cfg: clm_loss_fn(model, cfg.max_latents),
    link=_link,
    # Paper config of the reference CLI (``scripts/text/clm.py:16-23``).
    defaults={
        "data.task": "clm",
        "data.padding_side": "left",
        "model.max_latents": 512,
        "model.num_channels": 512,
        "lr_scheduler.name": "cosine",
        "lr_scheduler.warmup_steps": 200,
    },
)


def main(argv=None):
    return CLI(FAMILY).main(argv)


if __name__ == "__main__":
    main()
