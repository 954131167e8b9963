"""The training step on one device (``TrainState``, ``make_train_step``,
``make_eval_step``). Counterpart of ``perceiver_io_tpu/parallel``; meshes
over ``torch.distributed`` are not ported yet."""
from perceiver_io_tpu_torch.parallel.train_step import (
    TrainState,
    make_eval_step,
    make_train_step,
)

__all__ = ["TrainState", "make_eval_step", "make_train_step"]
