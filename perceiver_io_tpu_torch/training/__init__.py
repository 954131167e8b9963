"""Training layer: the CLM loss, learning-rate schedules, the optimizer
factory (AdamW, Adam, SGD, LAMB), checkpoints (best ``val_loss``, resume
snapshots, pretrained dirs), the step-based trainer and its text-sampling
callback. Counterpart of ``perceiver_io_tpu/training``."""
from perceiver_io_tpu_torch.training.callbacks import MaskFillingCallback, TextSamplingCallback
from perceiver_io_tpu_torch.training.checkpoint import (
    BestCheckpointManager,
    ResumeCheckpointManager,
    load_config,
    load_pretrained,
    load_subtree,
    save_pretrained,
)
from perceiver_io_tpu_torch.training.lrs import constant_with_warmup, cosine_with_warmup
from perceiver_io_tpu_torch.training.optim import Lamb, make_optimizer
from perceiver_io_tpu_torch.training.tasks import (
    IGNORE_INDEX,
    classifier_loss_fn,
    clm_loss_fn,
    image_classifier_loss_fn,
    masked_cross_entropy,
    mlm_loss_fn,
)
from perceiver_io_tpu_torch.training.trainer import Trainer, TrainerConfig

__all__ = [
    "BestCheckpointManager",
    "IGNORE_INDEX",
    "Lamb",
    "ResumeCheckpointManager",
    "MaskFillingCallback",
    "TextSamplingCallback",
    "Trainer",
    "TrainerConfig",
    "classifier_loss_fn",
    "clm_loss_fn",
    "image_classifier_loss_fn",
    "mlm_loss_fn",
    "constant_with_warmup",
    "cosine_with_warmup",
    "load_config",
    "load_pretrained",
    "load_subtree",
    "make_optimizer",
    "masked_cross_entropy",
    "save_pretrained",
]
