"""Cross-cutting utilities: analytic FLOP and parameter counts
(:mod:`.flops`). Counterpart of ``perceiver_io_tpu/utils``; its profiling
helpers (``utils/profiling.py``) come with observability (``ROADMAP.md``
A.4)."""
from perceiver_io_tpu_torch.utils.flops import (
    ComputeEstimator,
    count_params,
    flops_approx,
    num_training_steps,
    num_training_tokens,
    training_flops,
    training_flops_per_step,
)

__all__ = [
    "ComputeEstimator",
    "count_params",
    "flops_approx",
    "num_training_tokens",
    "num_training_steps",
    "training_flops",
    "training_flops_per_step",
]
