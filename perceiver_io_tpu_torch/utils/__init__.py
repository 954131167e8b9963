"""Cross-cutting utilities: analytic FLOP and parameter counts
(:mod:`.flops`) and ``torch.profiler`` tracing and step timing
(:mod:`.profiling`). Counterpart of ``perceiver_io_tpu/utils``."""
from perceiver_io_tpu_torch.utils.flops import (
    ComputeEstimator,
    count_params,
    flops_approx,
    num_training_steps,
    num_training_tokens,
    training_flops,
    training_flops_per_step,
)
from perceiver_io_tpu_torch.utils.profiling import StepTimer, trace

__all__ = [
    "ComputeEstimator",
    "count_params",
    "flops_approx",
    "num_training_tokens",
    "num_training_steps",
    "training_flops",
    "training_flops_per_step",
    "StepTimer",
    "trace",
]
