"""Span-threshold profiler trigger: capture a ``torch.profiler`` trace of
the next step when the step-time p95 regresses (counterpart of
``perceiver_io_tpu/observability/trigger.py``).

A steady-state p95 regression is exactly the moment a profile is worth its
overhead — and exactly the moment nobody is watching to start one by hand.
:class:`ProfilerTrigger` watches per-step durations (the trainer feeds it
its ``trainer.step`` span times), freezes a baseline p95 over the first
``min_samples`` healthy steps, and arms a one-shot capture when the rolling
p95 exceeds ``factor ×`` that baseline. The trainer then wraps the *next*
step in :func:`perceiver_io_tpu_torch.utils.profiling.trace`, writing a
Chrome trace (``trace.json``) into ``log_dir`` — so the trace shows
a representative regressed step, not the tail of whatever blip armed it.

``capture_fn`` is injectable (tests count captures without touching the real
profiler); a cooldown keeps a sustained regression from re-arming every
step and burying the run in trace files.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Callable, Optional

from perceiver_io_tpu_torch.observability.registry import Histogram


class ProfilerTrigger:
    """Arm a one-shot profiler capture on step-time p95 regression.

    :param log_dir: where captures land (``<dir>/regress-step<N>``).
    :param factor: rolling p95 must exceed ``factor * baseline_p95`` to arm.
    :param min_samples: observations used to freeze the baseline p95 (also
        the rolling-window size).
    :param cooldown: observations to ignore after a capture before re-arming.
    :param max_captures: hard cap on captures per trigger lifetime.
    :param warmup: observations discarded BEFORE the baseline starts —
        compile steps are orders of magnitude slower than steady state, and
        even one in the baseline window would freeze an inflated p95 that no
        real regression could ever exceed (the same exclusion
        ``utils/profiling.StepTimer`` applies).
    :param capture_fn: ``(log_dir) -> context manager`` — defaults to
        :func:`perceiver_io_tpu_torch.utils.profiling.trace`; injectable for tests.
    """

    def __init__(self, log_dir: str, *, factor: float = 1.5,
                 min_samples: int = 20, cooldown: int = 100,
                 max_captures: int = 3, warmup: int = 3,
                 capture_fn: Optional[Callable] = None):
        if factor < 0:
            raise ValueError(f"factor must be >= 0, got {factor}")
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        self.log_dir = log_dir
        self.factor = factor
        self.min_samples = min_samples
        self.cooldown = cooldown
        self.max_captures = max_captures
        self._warmup_left = warmup
        self._capture_fn = capture_fn
        self._baseline: deque = deque(maxlen=min_samples)
        self.baseline_p95: Optional[float] = None
        self._window: deque = deque(maxlen=min_samples)
        self._cooldown_left = 0
        self._armed = False
        self.captures = 0

    def observe(self, duration_ms: float) -> bool:
        """Feed one step duration; returns True when this observation armed
        a capture (the caller profiles its *next* step)."""
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return False
        if self.baseline_p95 is None:
            self._baseline.append(float(duration_ms))
            if len(self._baseline) >= self.min_samples:
                hist = Histogram(window=self.min_samples)
                for v in self._baseline:
                    hist.observe(v)
                self.baseline_p95 = hist.percentile(95.0)
            return False
        self._window.append(float(duration_ms))
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return False
        if self._armed or self.captures >= self.max_captures:
            return False
        if len(self._window) < self._window.maxlen:
            # a p95 over 1-2 samples is just the last blip; require a full
            # window so one GC pause / co-tenant spike cannot burn a capture
            # (and its cooldown) on a perfectly healthy run
            return False
        hist = Histogram(window=len(self._window))
        for v in self._window:
            hist.observe(v)
        p95 = hist.percentile(95.0)
        if p95 is not None and p95 > self.factor * self.baseline_p95:
            self._armed = True
            return True
        return False

    @property
    def armed(self) -> bool:
        """Whether the next step should be captured."""
        return self._armed

    def arm(self) -> bool:
        """Arm a capture of the next step directly — the external-signal
        path (an :class:`~perceiver_io_tpu_torch.observability.slo.SLOMonitor`
        breach arms a capture even when the regression lives in queueing,
        not step time). Respects the capture budget and cooldown exactly
        like :meth:`observe`; returns whether the trigger is now armed."""
        if self.captures >= self.max_captures or self._cooldown_left > 0:
            return self._armed
        self._armed = True
        return True

    @contextlib.contextmanager
    def capture(self, *, step: Optional[int] = None):
        """Run the enclosed (regressed) step under a profiler capture and
        disarm; enters the cooldown window afterwards."""
        self._armed = False
        self.captures += 1
        self._cooldown_left = self.cooldown
        target = self.log_dir
        if step is not None:
            import os

            target = os.path.join(self.log_dir, f"regress-step{step}")
        if self._capture_fn is not None:
            cm = self._capture_fn(target)
        else:
            from perceiver_io_tpu_torch.utils.profiling import trace

            cm = trace(target)
        with cm:
            yield
