"""Fault-tolerance signals shared by the serving engines. Only the queue's
backpressure signal is ported so far."""
from __future__ import annotations


class QueueFull(RuntimeError):
    """Backpressure: the serving queue is at ``max_queue``; the request was
    shed, not enqueued."""


__all__ = ["QueueFull"]
