"""Profiling: ``torch.profiler`` capture and step timing.

Counterpart of ``perceiver_io_tpu/utils/profiling.py``. :func:`trace` wraps a
region in a ``torch.profiler`` capture (CPU and, with a card, CUDA
activities) and writes a Chrome trace into ``log_dir``, viewable in Perfetto
or ``chrome://tracing``; :class:`StepTimer` measures steady-state step time
with ``torch.cuda.synchronize()`` fencing, so host dispatch cannot hide
device time.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

#: peak dense bf16 tensor-core rate of one NVIDIA H100 SXM (989 TFLOP/s),
#: the default ``peak_flops`` of :meth:`StepTimer.measure` on such a card
H100_BF16_PEAK_FLOPS = 989e12


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``<log_dir>/trace.json`` (a Chrome trace):

        with trace("logs/profile"):
            loss = step(batch)

    The card is synchronised before the capture stops, so the kernels the
    region launched are in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def peak_flops_for(device_name: Optional[str]) -> Optional[float]:
    """The default peak rate for a card by name: the H100's bf16 dense rate
    for an H100, else None (no rate is assumed for another card)."""
    if device_name and "H100" in device_name:
        return H100_BF16_PEAK_FLOPS
    return None


class StepTimer:
    """Steady-state step timing: warmup steps excluded, the card's queue
    drained before and after the timed loop."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup

    def measure(
        self,
        step_fn: Callable[[], object],
        *,
        iters: int = 20,
        flops_per_step: Optional[int] = None,
        peak_flops: Optional[float] = None,
        registry=None,
        name: str = "step_timer",
    ) -> dict:
        """:param step_fn: zero-arg callable that launches one step.
        :param flops_per_step: if given, report achieved FLOP/s.
        :param peak_flops: if also given, report MFU against it; None takes
            :func:`peak_flops_for` the card in use (the H100's bf16 rate).
        :param registry: optional
            :class:`~perceiver_io_tpu_torch.observability.MetricsRegistry`:
            the measured numbers are published as ``<name>_*`` gauges.
        """
        for _ in range(self.warmup):
            step_fn()
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            step_fn()
        _sync()
        dt = (time.perf_counter() - t0) / iters

        result = {"step_time_s": dt, "steps_per_sec": 1.0 / dt}
        if flops_per_step:
            result["flops_per_sec"] = flops_per_step / dt
            if peak_flops is None and torch.cuda.is_available():
                peak_flops = peak_flops_for(torch.cuda.get_device_name(0))
            if peak_flops:
                result["mfu"] = flops_per_step / dt / peak_flops
        if registry is not None:
            registry.set_gauge(f"{name}_step_time_ms", dt * 1e3)
            registry.set_gauge(f"{name}_steps_per_sec", result["steps_per_sec"])
            if "flops_per_sec" in result:
                registry.set_gauge(f"{name}_flops_per_sec", result["flops_per_sec"])
            if "mfu" in result:
                registry.set_gauge(f"{name}_mfu", result["mfu"])
        return result
