"""Supervised serving-engine lifecycle: crash recovery and graceful drain;
the counterpart of ``thunder_tpu/serving/supervisor.py``.

- **Crash recovery.** When a dispatch fault consumes the page pools, the
  engine escalates :class:`~thunder_tpu_torch.serving.errors.EngineFault`;
  the supervisor rebuilds the pools and the decode binding
  (:meth:`ServingEngine.rebuild_after_fault`) and re-admits every in-flight
  request by re-prefilling its prompt and generated tokens, the engine's
  recompute-on-resume discipline carried from preemption to a crash.
- **Restart budget.** Each restart charges a
  :class:`~thunder_tpu_torch.runtime.retry.RestartBudget` sliding window; an
  engine failing faster than restarts can mask escalates
  :class:`~thunder_tpu_torch.serving.errors.RestartBudgetExceeded`.
- **Graceful drain and shutdown.** :meth:`EngineSupervisor.drain` stops
  admissions, finishes residents under an optional wall-clock bound (expiry
  sheds the rest with ``DeadlineExceeded``) and records the episode in the
  ``serving.drain_ms`` histogram.
- **SLO floor.** With ``slo_floor=`` set, an on-time ratio below the floor
  over at least ``min_slo_samples`` terminal requests emits
  ``serving_slo_collapse`` and dumps a postmortem, once until
  :meth:`EngineSupervisor.rearm_slo`.

Left out so far (ROADMAP A.3, after A.2): the stall watchdog
(``heartbeat_path=``, ``stall_timeout_s=``, ``on_stall=``; it needs
``elastic.py``'s ``Heartbeat``/``Watchdog``), the statusz snapshots
(``statusz_dir=``, A.4), and the postmortem bundle's Perfetto timeline and
decode-program decision log (A.4's exporters and decisions). An argument
for a part left out raises ``NotImplementedError``. The bundle holds the
flight ring, the engine's state, a registry snapshot and a manifest.

>>> sup = EngineSupervisor(engine, max_restarts=3, restart_window_s=600.0)
>>> req = sup.submit(prompt, max_new_tokens=32, deadline_s=30.0)
>>> sup.drain(deadline_s=120.0)   # stop admissions, finish residents
>>> sup.shutdown()
"""

from __future__ import annotations

import json
import os
import time

from thunder_tpu_torch.observe import flight as _flight
from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.runtime import retry as _retry
from thunder_tpu_torch.serving.errors import (
    EngineFault,
    EngineStallError,
    RestartBudgetExceeded,
)
from thunder_tpu_torch.serving.scheduler import Request, ServingEngine

_LEFT_OUT = {
    "heartbeat_path": "the stall watchdog (ROADMAP A.3, after elastic.py in A.2)",
    "stall_timeout_s": "the stall watchdog (ROADMAP A.3, after elastic.py in A.2)",
    "on_stall": "the stall watchdog (ROADMAP A.3, after elastic.py in A.2)",
    "statusz_dir": "statusz snapshots (ROADMAP A.4)",
    "statusz_interval_s": "statusz snapshots (ROADMAP A.4)",
}


class EngineSupervisor:
    """Wraps a :class:`ServingEngine` with the restart and drain lifecycle.
    Route all traffic through it (``submit``/``step``/``drain``) so faults
    recover transparently.

    With ``postmortem_dir=`` set, every typed serving failure —
    ``EngineFault`` (even when the restart recovers it),
    ``EngineStallError``, ``RestartBudgetExceeded``, and an SLO collapse
    below ``slo_floor`` — dumps a postmortem bundle: the always-on flight
    ring, the engine's state (:meth:`ServingEngine.describe_state`), a
    registry snapshot and a manifest with the restart budget."""

    def __init__(self, engine: ServingEngine, *,
                 restart_budget: _retry.RestartBudget | None = None,
                 max_restarts: int = 3, restart_window_s: float = 600.0,
                 postmortem_dir: str | None = None,
                 slo_floor: float | None = None, min_slo_samples: int = 8,
                 **left_out):
        for name in left_out:
            if name not in _LEFT_OUT:
                raise TypeError(f"EngineSupervisor got an unexpected keyword argument {name!r}")
            raise NotImplementedError(f"EngineSupervisor({name}=...): "
                                      f"{_LEFT_OUT[name]} is not ported yet")
        self.engine = engine
        self._obs = engine.obs
        self.budget = restart_budget or _retry.RestartBudget(
            max_restarts=max_restarts, window_s=restart_window_s)
        self.restarts = 0
        self.postmortem_dir = postmortem_dir
        self.slo_floor = slo_floor
        self.min_slo_samples = int(min_slo_samples)
        self._slo_collapsed = False     # latched: one bundle per collapse
        # (attained, total, reset generation) at the last (re)arm: attaching
        # to a warm engine must not judge its earlier history
        self._slo_base = (engine._slo_attained, engine._slo_total, engine._slo_resets)

    # -- request traffic ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, **kwargs) -> Request:
        """Delegates to the engine (a draining engine raises
        ``AdmissionRejected`` there)."""
        return self.engine.submit(prompt, max_new_tokens, **kwargs)

    def step(self) -> bool:
        """One supervised engine iteration: an ``EngineFault`` becomes a
        budget-charged restart instead of a crash. Returns whether progress
        was made (a restart counts)."""
        try:
            worked = self.engine.step()
        except EngineFault as e:
            # the black box first, while the engine still shows the crash
            self.dump_postmortem(e)
            self._restart(e)
            return True
        self._check_slo()
        return worked

    def drain(self, *, deadline_s: float | None = None,
              max_steps: int = 1_000_000) -> list[Request]:
        """Graceful drain: stop admissions, then run residents and queued
        requests to completion under ``deadline_s`` (wall clock); on expiry
        the rest is shed with ``DeadlineExceeded``. A no-progress step
        raises ``EngineStallError``; each step is supervised, so a fault
        mid-drain restarts and drains on. Records ``serving.drain_ms`` and
        returns the completed list."""
        eng = self.engine
        eng.stop_admissions()
        t0 = time.perf_counter()
        t0_us = _observe._now_us()
        try:
            for _ in range(max_steps):
                if eng.idle:
                    break
                if deadline_s is not None and time.perf_counter() - t0 > deadline_s:
                    victims = eng.shed_outstanding(
                        f"drain wall-clock bound ({deadline_s}s) expired")
                    self._obs.event("serving_drain_bound_expired",
                                    shed=[r.request_id for r in victims])
                    break
                if not self.step():
                    raise eng._stall_error("no-progress step during drain")
            else:
                if not eng.idle:
                    raise eng._stall_error(f"no completion in {max_steps} drain steps")
        except EngineStallError as e:
            self.dump_postmortem(e)
            raise
        finally:
            self._obs.observe_value("serving.drain_ms", (time.perf_counter() - t0) * 1e3)
            self._obs.record_span("drain", "serving:sched", t0_us, _observe._now_us() - t0_us,
                                  {"completed": len(eng.completed), "shed": len(eng.shed)})
        return eng.completed

    def shutdown(self, *, deadline_s: float | None = None) -> list[Request]:
        """Drain (bounded when ``deadline_s`` is given), then close.
        Terminal: the engine stays non-admitting."""
        try:
            return self.drain(deadline_s=deadline_s)
        finally:
            self.close()

    def close(self) -> None:
        """Release the supervisor (idempotent; it holds no thread or file
        until the watchdog and statusz are ported). Does not drain."""

    # -- SLO floor ----------------------------------------------------------
    def _check_slo(self) -> None:
        """When the on-time ratio over terminal requests since the last
        (re)arm falls below ``slo_floor``, with at least
        ``min_slo_samples`` of them, emit ``serving_slo_collapse`` and dump
        once until :meth:`rearm_slo`."""
        if self.slo_floor is None or self._slo_collapsed:
            return
        eng = self.engine
        base_a, base_t, base_gen = self._slo_base
        if eng._slo_resets != base_gen:  # the engine's window was reset
            self._slo_base = (0, 0, eng._slo_resets)
            base_a, base_t = 0, 0
        total = eng._slo_total - base_t
        if total < max(self.min_slo_samples, 1):
            return
        ratio = (eng._slo_attained - base_a) / total
        if ratio < self.slo_floor:
            self._slo_collapsed = True
            self._obs.event("serving_slo_collapse", attainment=round(ratio, 4),
                            floor=self.slo_floor, samples=total)
            self.dump_postmortem(RuntimeError(
                f"SLO attainment collapsed: {ratio:.3f} < floor {self.slo_floor:g} over "
                f"{total} terminal requests"), tag="slo_collapse")

    def rearm_slo(self) -> None:
        """Un-latch the SLO-collapse detector and start a fresh window."""
        self._slo_collapsed = False
        eng = self.engine
        self._slo_base = (eng._slo_attained, eng._slo_total, eng._slo_resets)

    # -- postmortem and recovery --------------------------------------------
    def dump_postmortem(self, cause: BaseException | str, tag: str | None = None) -> str | None:
        """Write the bundle for ``cause`` under ``postmortem_dir`` (None when
        unset). Never raises: a failed part is named in the manifest."""
        if self.postmortem_dir is None:
            return None
        label = tag or (type(cause).__name__ if isinstance(cause, BaseException)
                        else "incident")
        try:
            base = os.path.join(self.postmortem_dir,
                                f"postmortem-step{self.engine._step_count:06d}-{label}")
            path, i = base, 1
            while os.path.exists(path):
                path = f"{base}.{i}"
                i += 1
            os.makedirs(path)
        except Exception:
            return None
        errors: list[str] = []

        def part(fname: str, build) -> None:
            try:
                obj = build()
                with open(os.path.join(path, fname), "w") as f:
                    json.dump(obj, f, default=str)
            except Exception as e:  # a partial bundle beats none
                errors.append(f"{fname}: {e!r}")

        n_flight = 0
        try:
            with open(os.path.join(path, "flight.jsonl"), "w") as f:
                for rec in _flight.snapshot():
                    f.write(json.dumps(rec, default=str) + "\n")
                    n_flight += 1
        except Exception as e:
            errors.append(f"flight.jsonl: {e!r}")
        part("engine.json", self.engine.describe_state)
        part("registry.json", _observe.snapshot)
        part("MANIFEST.json", lambda: {
            "engine_id": self.engine.engine_id,
            "cause": repr(cause),
            "cause_type": type(cause).__name__ if isinstance(cause, BaseException) else "str",
            "created_s": time.time(),
            "step": self.engine._step_count,
            "restarts": self.restarts,
            "budget": self.budget.describe(),
            "flight_records": n_flight,
            "registry_enabled": _observe.is_enabled(),
            "errors": errors,
            "files": ["flight.jsonl", "engine.json", "registry.json"],
        })
        self._obs.inc("serving.postmortems")
        self._obs.event("serving_postmortem", path=path, cause=repr(cause))
        return path

    def _restart(self, cause: BaseException) -> None:
        """The engine-level rung: charge the budget, rebuild the pools and
        the binding, re-admit the in-flight requests."""
        if not self.budget.record():
            self._obs.event("serving_restart_budget_exhausted", cause=repr(cause),
                            budget=self.budget.describe())
            err = RestartBudgetExceeded(
                f"engine restart budget exhausted ({self.budget.describe()}); last "
                f"fault: {cause!r}", in_window=self.budget.in_window,
                max_restarts=self.budget.max_restarts, engine_id=self.engine.engine_id)
            self.dump_postmortem(err)
            raise err from cause
        t0 = time.perf_counter()
        recovered = self.engine.rebuild_after_fault(getattr(cause, "restart_state", None))
        self.restarts += 1
        self._obs.inc("serving.engine_restarts")
        self._obs.event("serving_engine_restart", cause=repr(cause),
                        recovered=[r.request_id for r in recovered],
                        restart_ms=(time.perf_counter() - t0) * 1e3,
                        budget=self.budget.describe())
