"""Symbolic audio model CLI (counterpart of
``perceiver_io_tpu/scripts/audio/symbolic.py``; reference
``perceiver/scripts/audio/symbolic.py``):

    python -m perceiver_io_tpu_torch.scripts.audio.symbolic fit --data=synthetic \
        --data.max_seq_len=6144 --trainer.max_steps=10000

Add ``--device=cpu`` to run on the CPU. ``serve`` refuses this family's
checkpoints: it decodes with the byte tokenizer.
"""
from __future__ import annotations

import torch

from perceiver_io_tpu_torch.data.audio import (
    GiantMidiPianoDataModule,
    MaestroV3DataModule,
    SymbolicAudioDataModule,
    SyntheticSymbolicAudioDataModule,
)
from perceiver_io_tpu_torch.models.audio.symbolic import (
    SymbolicAudioModel,
    SymbolicAudioModelConfig,
)
from perceiver_io_tpu_torch.scripts.cli import CLI, ModelFamily
from perceiver_io_tpu_torch.training.tasks import clm_loss_fn

DATA = {
    "synthetic": SyntheticSymbolicAudioDataModule,
    "maestro": MaestroV3DataModule,
    "giantmidi": GiantMidiPianoDataModule,
    "symbolic": SymbolicAudioDataModule,
}


def _link(dm, values):
    values.setdefault("model.vocab_size", dm.vocab_size)
    values.setdefault("model.max_seq_len", dm.max_seq_len)


FAMILY = ModelFamily(
    name="perceiver_io_tpu_torch.scripts.audio.symbolic",
    config_class=SymbolicAudioModelConfig,
    data_registry=DATA,
    build_model=lambda cfg, dm, **kw: SymbolicAudioModel(cfg, dtype=torch.bfloat16, **kw),
    make_loss=lambda model, cfg: clm_loss_fn(model, cfg.max_latents),
    link=_link,
    # Paper config (reference ``audio/symbolic.py:9-29``): GiantMIDI model,
    # 6144 ctx / 2048 latents when trained at full scale.
    defaults={
        "model.max_latents": 2048,
        "model.num_channels": 768,
        "lr_scheduler.name": "cosine",
        "lr_scheduler.warmup_steps": 500,
    },
)


def main(argv=None):
    return CLI(FAMILY).main(argv)


if __name__ == "__main__":
    main()
