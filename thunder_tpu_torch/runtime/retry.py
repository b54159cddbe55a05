"""Retry/timeout/backoff policy engine.

The port's own copy of ``thunder_tpu/runtime/retry.py``. Per-domain policies with jittered exponential backoff and deadline budgets,
plus the exception classifier that decides what a failure *means*:

- ``retryable`` — transient (device error, preemption, injected transient
  fault): back off and try again.
- ``fatal`` — never retry (``KeyboardInterrupt``, programming errors, a
  *sticky* CUDA error: an illegal address, a trap, a launch failure
  leaves the CUDA context unusable, so nothing in this process can run a
  kernel again — restarting the process is the supervisor's work; a
  kernel build failure; a device allocation failure; and a quarantined
  kernel called on the card, where no plain version may stand in);
  re-raise immediately.
- ``degradable`` — the failure names a component that can be disabled
  (:class:`~thunder_tpu_torch.runtime.faults.KernelExecutionError` carries a
  claim id): quarantine it and run on the next rung down rather than
  retrying the same kernel.

:class:`RestartBudget` is the sliding-window restart counter the supervisor
uses instead of a per-lifetime cap — a job that fails once a day for a week
is healthy; one that fails five times in ten minutes is not.
"""

from __future__ import annotations

import random
import re
import time
from collections import deque
from typing import Callable

import torch

from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.runtime.faults import (
    QUARANTINED,
    InjectedFault,
    KernelBuildError,
    KernelExecutionError,
)

RETRYABLE = "retryable"
FATAL = "fatal"
DEGRADABLE = "degradable"


# CUDA errors after which the context is unusable (cudaError_t codes:
# illegal address, launch timeout, device assert, hardware stack error,
# illegal instruction, misaligned address, invalid address space, invalid
# PC, launch failure), and the words PyTorch's own messages use for them
STICKY_CUDA_ERRORS = frozenset((700, 702, 710, 714, 715, 716, 717, 718, 719))
_STICKY_WORDS = ("illegal memory access", "an illegal instruction", "misaligned address",
                 "unspecified launch failure", "device-side assert", "hardware stack error",
                 "invalid program counter", "the launch timed out")
_CUDA_ERROR = re.compile(r"CUDA error (\d+)")


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """True when ``exc``, or the error it was raised from, reports a sticky
    CUDA error (``cudaex``'s launch error names the code: "CUDA error 700")."""
    while exc is not None:
        msg = str(exc)
        m = _CUDA_ERROR.search(msg)
        if (m and int(m.group(1)) in STICKY_CUDA_ERRORS) or any(w in msg for w in _STICKY_WORDS):
            return True
        exc = exc.__cause__
    return False


def classify(exc: BaseException) -> str:
    """Default exception classifier (override per call site as needed)."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return FATAL
    if is_sticky_cuda_error(exc):
        return FATAL
    if isinstance(exc, (KernelBuildError, torch.cuda.OutOfMemoryError)):
        return FATAL
    if isinstance(exc, KernelExecutionError):
        return FATAL if exc.phase == QUARANTINED else DEGRADABLE
    if isinstance(exc, InjectedFault):
        return RETRYABLE
    if isinstance(exc, (OSError, RuntimeError)):
        return RETRYABLE
    return FATAL


class RetryPolicy:
    """Jittered exponential backoff with an optional deadline budget.

    ``delay_s(attempt)`` is deterministic for a given ``seed``:
    ``base * multiplier**(attempt-1)`` capped at ``max_delay_s``, scaled by
    a uniform jitter in ``[1-jitter, 1+jitter]``.
    """

    def __init__(self, *, max_attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 5.0, multiplier: float = 2.0,
                 jitter: float = 0.25, deadline_s: float | None = None,
                 seed: int = 0):
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline_s = deadline_s
        self._rng = random.Random(seed)

    def delay_s(self, attempt: int) -> float:
        d = min(self.base_delay_s * self.multiplier ** max(attempt - 1, 0),
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(d, 0.0)


# per-domain defaults: compiles are expensive (few, patient attempts);
# dispatch/collective failures are cheap to retry; checkpoint IO sits between
DEFAULT_POLICIES: dict[str, RetryPolicy] = {
    "compile": RetryPolicy(max_attempts=2, base_delay_s=1.0, max_delay_s=30.0),
    "dispatch": RetryPolicy(max_attempts=3, base_delay_s=0.05),
    "collective": RetryPolicy(max_attempts=3, base_delay_s=0.2, max_delay_s=10.0),
    "checkpoint_io": RetryPolicy(max_attempts=4, base_delay_s=0.5, max_delay_s=30.0),
    "step": RetryPolicy(max_attempts=3, base_delay_s=0.5, max_delay_s=60.0),
}


def policy_for(domain: str) -> RetryPolicy:
    return DEFAULT_POLICIES.get(domain, RetryPolicy())


def call_with_retry(fn: Callable, *args, policy: RetryPolicy | None = None,
                    domain: str = "", classify_fn: Callable = classify,
                    sleep: Callable[[float], None] = time.sleep,
                    clock: Callable[[], float] = time.monotonic,
                    on_retry: Callable | None = None, **kwargs):
    """Run ``fn`` under ``policy``. Retries ``retryable`` failures with
    backoff until attempts or the deadline budget run out; ``fatal`` and
    ``degradable`` failures propagate immediately (degradation is the
    caller's job, not a blind re-run's)."""
    policy = policy or (policy_for(domain) if domain else RetryPolicy())
    start = clock()
    failures = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if classify_fn(e) != RETRYABLE:
                raise
            failures += 1
            if failures >= policy.max_attempts:
                raise
            d = policy.delay_s(failures)
            if policy.deadline_s is not None and \
                    clock() - start + d > policy.deadline_s:
                raise
            _observe.inc("runtime.retries")
            _observe.observe_value("runtime.backoff_ms", d * 1e3)
            _observe.event("retry", domain=domain, attempt=failures,
                           delay_s=d, error=repr(e))
            if on_retry is not None:
                on_retry(failures, d, e)
            sleep(d)


class RestartBudget:
    """Sliding-window restart counter: at most ``max_restarts`` restarts per
    ``window_s`` seconds (``None`` = lifetime window, the legacy behavior).

    ``record()`` logs one restart and returns whether the budget still
    allows it; old restarts age out of the window, so a long-lived job is
    judged by its recent stability, not its history."""

    def __init__(self, max_restarts: int = 3, window_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_restarts = max_restarts
        self.window_s = window_s
        self._clock = clock
        self._events: deque[float] = deque()

    def _prune(self, now: float) -> None:
        if self.window_s is None:
            return
        while self._events and now - self._events[0] > self.window_s:
            self._events.popleft()

    def record(self) -> bool:
        now = self._clock()
        self._events.append(now)
        self._prune(now)
        return len(self._events) <= self.max_restarts

    @property
    def in_window(self) -> int:
        self._prune(self._clock())
        return len(self._events)

    def describe(self) -> str:
        """One-line budget state for events/reports:
        ``2/3 restarts in 600s window``."""
        window = "lifetime" if self.window_s is None else f"{self.window_s:g}s"
        return f"{self.in_window}/{self.max_restarts} restarts in {window} window"
