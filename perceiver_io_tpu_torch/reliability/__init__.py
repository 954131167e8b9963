"""Fault-tolerance layer of the port: the serving queue's backpressure
signal (:class:`QueueFull`), the deterministic chaos registry
(:mod:`.chaos`, consulted by the trainer at ``trainer.step``) and
exponential-backoff retry (:mod:`.retry`, used by ``data.loader`` and the
streaming text pipeline).
Counterpart of ``perceiver_io_tpu/reliability``."""
from __future__ import annotations


class QueueFull(RuntimeError):
    """Backpressure: the serving queue is at ``max_queue``; the request was
    shed, not enqueued."""


from perceiver_io_tpu_torch.reliability.chaos import (  # noqa: E402
    ChaosRegistry,
    FakeClock,
    Fault,
    InjectedFault,
)
from perceiver_io_tpu_torch.reliability.retry import (  # noqa: E402
    RetryPolicy,
    call_with_retry,
    resilient_source,
)

__all__ = [
    "QueueFull",
    "ChaosRegistry",
    "FakeClock",
    "Fault",
    "InjectedFault",
    "RetryPolicy",
    "call_with_retry",
    "resilient_source",
]
