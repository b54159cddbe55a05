"""Kernel quarantine: remember which kernels are broken, route around them.

The port's own copy of ``thunder_tpu/runtime/quarantine.py``. When a routed
kernel fails (``runtime.faults.KernelExecutionError``, raised by the kernel
guard of ``ops/nn.py`` and ``ops/optim.py``), the caller adds its claim id
(``cuda.<kernel>``) with :func:`get_quarantine().add(claim_id)`; the routers
and the serving runner read the set as explicit state (:func:`is_routed_off`)
and take the next kernel rung down:

- ``cuda.decode_layer`` → ``ops.nn.decode_layer_subblocks`` (the
  ``attn_subblock`` and ``mlp_subblock`` kernels), and the serving
  runner's next compile plans those two in its place;
- ``cuda.attn_subblock`` / ``cuda.mlp_subblock`` → the per-op rung's
  kernels (``rms_norm``/``rms_norm_residual``, ``linear_act``,
  ``paged_decode_attention``) in that sub-block's place: the block
  planner plans no quarantined claim (the serving runner's traced steps),
  and ``models.llama`` takes the per-op rung (the planned train step);
- any other kernel has no kernel rung below it: on the card its router
  raises a fatal ``KernelExecutionError`` (the port runs no plain version
  there); on the CPU it runs its plain version, as it always does there.

A kernel whose own source did not build (``cudaex.build_failures``) is
quarantined like a failed launch, at its first launch. A refusal
(``cudaex.refusal``), a failure of the whole build or an allocation failure
never enters the quarantine.

Persistence: :func:`configure` points the quarantine at a directory; the set
is written there as JSON (to a temporary file, then renamed) and merged with
what a previous process recorded, so a restarted process skips the
known-bad kernel. ``THUNDER_TPU_TORCH_QUARANTINE_DIR`` configures it from
the environment.

Every mutation bumps a process-wide *epoch*, which is part of ``jit``'s
guard key; the serving engine re-binds its decode step when the epoch
moves.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar

from thunder_tpu_torch.observe import registry as _observe

_FILENAME = "kernel_quarantine.json"

_epoch = 0
_epoch_lock = threading.Lock()


def _bump_epoch() -> None:
    global _epoch
    with _epoch_lock:
        _epoch += 1


def epoch() -> int:
    """Monotonic counter of quarantine mutations: a binding made at an
    older epoch (the serving engine's decode layer) is stale."""
    return _epoch


class KernelQuarantine:
    """The quarantine set: claim id -> {reason, phase, time, count}."""

    def __init__(self, path: str | None = None):
        self._lock = threading.Lock()
        self._kernels: dict[str, dict] = {}
        self._path: str | None = None
        if path is not None:
            self.attach(path)

    # -- persistence --------------------------------------------------------
    def attach(self, path: str) -> None:
        """Bind to ``path`` (a JSON file): merge whatever a previous process
        quarantined there, then persist the union."""
        path = os.path.abspath(path)
        with self._lock:
            self._path = path
            disk = self._load(path)
            for k, rec in disk.items():
                self._kernels.setdefault(k, rec)
            self._persist()
        _bump_epoch()
        _observe.set_gauge("runtime.quarantined_kernels", len(self._kernels))

    @staticmethod
    def _load(path: str) -> dict:
        try:
            with open(path) as f:
                data = json.load(f)
            kernels = data.get("kernels", {})
            return kernels if isinstance(kernels, dict) else {}
        except Exception:
            return {}  # missing or torn file: start empty, rewrite on add

    def _persist(self) -> None:
        if self._path is None:
            return
        tmp = self._path + ".tmp"
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"version": 1, "kernels": self._kernels}, f, indent=2)
        os.replace(tmp, self._path)

    # -- mutation -----------------------------------------------------------
    def add(self, claim_id: str, *, reason: str = "", phase: str = "runtime") -> None:
        with self._lock:
            rec = self._kernels.get(claim_id)
            if rec is None:
                self._kernels[claim_id] = {"reason": reason, "phase": phase,
                                           "time": time.time(), "count": 1}
            else:
                rec["count"] = rec.get("count", 0) + 1
                rec["reason"] = reason or rec.get("reason", "")
            self._persist()
            n = len(self._kernels)
        _bump_epoch()
        _observe.set_gauge("runtime.quarantined_kernels", n)
        _observe.event("kernel_quarantined", claim=claim_id, reason=reason,
                       phase=phase)

    def remove(self, claim_id: str) -> None:
        with self._lock:
            self._kernels.pop(claim_id, None)
            self._persist()
            n = len(self._kernels)
        _bump_epoch()
        _observe.set_gauge("runtime.quarantined_kernels", n)

    def clear(self) -> None:
        with self._lock:
            self._kernels.clear()
            self._persist()
        _bump_epoch()
        _observe.set_gauge("runtime.quarantined_kernels", 0)

    # -- queries ------------------------------------------------------------
    def reason(self, claim_id: str) -> str | None:
        rec = self._kernels.get(claim_id)
        if rec is None:
            return None
        return rec.get("reason") or f"quarantined at {rec.get('phase', '?')} time"

    def ids(self) -> tuple[str, ...]:
        return tuple(self._kernels)

    def __contains__(self, claim_id: str) -> bool:
        return claim_id in self._kernels

    def __len__(self) -> int:
        return len(self._kernels)

    @property
    def path(self) -> str | None:
        return self._path


# ---------------------------------------------------------------------------
# the process-wide quarantine
# ---------------------------------------------------------------------------

_active = KernelQuarantine()


def get_quarantine() -> KernelQuarantine:
    return _active


def configure(directory: str) -> KernelQuarantine:
    """Persist the quarantine set under ``directory``: loads claim ids a
    previous process recorded there."""
    _active.attach(os.path.join(str(directory), _FILENAME))
    return _active


def reset(path: str | None = None) -> KernelQuarantine:
    """Replace the process quarantine with a fresh instance (test harness:
    simulates a process restart; pass ``path`` to re-read a persisted set)."""
    global _active
    _active = KernelQuarantine(path)
    _bump_epoch()
    _observe.set_gauge("runtime.quarantined_kernels", len(_active))
    return _active


def is_quarantined(claim_id: str) -> bool:
    return claim_id in _active


# temporary (non-persisted) claim disables: the numerics bisection re-runs
# a step with candidate kernels disabled to attribute a silent fault — these
# suppressions route a claim exactly like a quarantine entry but never touch
# the persisted set. A ContextVar (not a module global): suppression is
# visible only to the bisection's own call chain — a step on another thread
# never sees an unrelated probe's disables, and two concurrent bisections
# cannot clobber each other's suppression sets. The stored dict is treated
# as immutable (each suppress() installs a fresh copy)
_suppressed: ContextVar[dict] = ContextVar("quarantine_suppressed", default={})


@contextmanager
def suppress(claim_ids, reason: str = "bisection probe"):
    """Temporarily treat ``claim_ids`` as quarantined (scoped to this context,
    never persisted). Nests: inner suppressions stack on top of outer ones."""
    merged = dict(_suppressed.get())
    for c in claim_ids:
        merged[c] = reason
    tok = _suppressed.set(merged)
    try:
        yield
    finally:
        _suppressed.reset(tok)


def is_routed_off(claim_id: str) -> bool:
    """True when the routers must not send ``claim_id`` to its kernel: it is
    quarantined, or suppressed in this context. The routers' per-call
    check: two dict lookups."""
    return claim_id in _active._kernels or claim_id in _suppressed.get()


def quarantine_reason(claim_id: str) -> str | None:
    r = _suppressed.get().get(claim_id)
    if r is not None:
        return r
    return _active.reason(claim_id)


if os.environ.get("THUNDER_TPU_TORCH_QUARANTINE_DIR"):
    configure(os.environ["THUNDER_TPU_TORCH_QUARANTINE_DIR"])
