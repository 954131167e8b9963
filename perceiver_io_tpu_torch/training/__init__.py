"""Training layer: the CLM loss, learning-rate schedules, the optimizer
factory, best-``val_loss`` checkpoints and the step-based trainer.
Counterpart of ``perceiver_io_tpu/training``."""
from perceiver_io_tpu_torch.training.checkpoint import BestCheckpointManager
from perceiver_io_tpu_torch.training.lrs import constant_with_warmup, cosine_with_warmup
from perceiver_io_tpu_torch.training.optim import make_optimizer
from perceiver_io_tpu_torch.training.tasks import IGNORE_INDEX, clm_loss_fn, masked_cross_entropy
from perceiver_io_tpu_torch.training.trainer import Trainer, TrainerConfig

__all__ = [
    "BestCheckpointManager",
    "IGNORE_INDEX",
    "Trainer",
    "TrainerConfig",
    "clm_loss_fn",
    "constant_with_warmup",
    "cosine_with_warmup",
    "make_optimizer",
    "masked_cross_entropy",
]
