"""Typed serving errors: the request-SLO and engine-lifecycle vocabulary;
the counterpart of ``thunder_tpu/serving/errors.py``.

- :class:`ServingError` — base for everything below.
- :class:`AdmissionRejected` — the request never became (or stopped being)
  resident for capacity or lifecycle reasons: admissions stopped by a
  drain, or the bounded admission queue shed it under priority pressure.
- :class:`InfeasibleRequest` — the request could never run on this engine
  (context window or total page pool too small); raised at ``submit()`` so
  it fails fast instead of queueing forever. Also a ``ValueError``.
- :class:`DeadlineExceeded` — the request's deadline passed before it
  completed (shed from the queue, evicted mid-flight, or drained past the
  bound).
- :class:`EngineFault` — the engine's device state is lost (a failing
  dispatch consumed the page pools): a blind retry cannot help, so the
  engine escalates to its supervisor, whose restart (pool rebuild and
  re-prefill of every in-flight request) is the only recovery rung.
- :class:`EngineStallError` — a ``drain()`` step made no progress while
  requests remain; names the stuck requests.
- :class:`RestartBudgetExceeded` — the supervisor's sliding-window restart
  budget ran out; the failure escalates to the caller.

Every per-engine error carries ``engine_id``. :class:`RestartState` is not
an error: it is the typed record of what a rebuild after a crash must
reproduce, carried on :class:`EngineFault`.

The reference's ``ShardingGeometryError`` comes with tensor-parallel
meshes, which the port does not have yet (ROADMAP A.3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class RestartState:
    """Everything a rebuild after a crash needs to recreate the KV pool
    exactly: its geometry, dtype and device. The port's engines run on one
    device, so the mesh the reference also records is always the trivial
    one."""

    geometry: Any
    dtype: Any
    device: Any = None

    def describe(self) -> dict:
        return {"n_layers": self.geometry.n_layers,
                "kv_heads": self.geometry.kv_heads,
                "num_pages": self.geometry.num_pages,
                "tp_degree": 1, "mesh_shape": [1]}


class ServingError(RuntimeError):
    """Base class for typed serving-engine errors."""


class AdmissionRejected(ServingError):
    """The engine refused or revoked admission for capacity or lifecycle
    reasons — draining, a full bounded queue, or priority shedding."""

    def __init__(self, message: str, *, request_id: int | None = None,
                 engine_id: str | None = None):
        super().__init__(message)
        self.request_id = request_id
        self.engine_id = engine_id


class InfeasibleRequest(AdmissionRejected, ValueError):
    """The request can never run on this engine."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before completion."""

    def __init__(self, message: str, *, request_id: int | None = None,
                 deadline_s: float | None = None, engine_id: str | None = None):
        super().__init__(message)
        self.request_id = request_id
        self.deadline_s = deadline_s
        self.engine_id = engine_id


class EngineFault(ServingError):
    """Device state lost mid-dispatch (the page pools consumed by a failing
    step): per-step retry is impossible; only a supervised engine restart
    can recover. Carries the dispatch ``domain`` that escalated."""

    def __init__(self, message: str, *, domain: str = "",
                 restart_state: RestartState | None = None,
                 engine_id: str | None = None):
        super().__init__(message)
        self.domain = domain
        self.restart_state = restart_state
        self.engine_id = engine_id


class EngineStallError(ServingError):
    """``drain()`` found a step with no progress while requests remain;
    ``stuck`` holds ``(request_id, state)`` pairs."""

    def __init__(self, message: str, *, stuck: list | None = None):
        super().__init__(message)
        self.stuck = list(stuck or [])


class RestartBudgetExceeded(ServingError):
    """The supervisor's sliding-window restart budget is exhausted."""

    def __init__(self, message: str, *, in_window: int = 0,
                 max_restarts: int = 0, engine_id: str | None = None):
        super().__init__(message)
        self.in_window = in_window
        self.max_restarts = max_restarts
        self.engine_id = engine_id
