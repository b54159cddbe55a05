"""Always-on flight recorder: the observability black box.

The port's own copy of ``thunder_tpu/observe/flight.py``.

The process registry (``registry.py``) is opt-in — every metric and event
is dropped until ``observe.enable()`` runs, which is the right contract
for a compiler (near-zero cost on hot paths) but the wrong one for a
serving incident: a production ``EngineFault`` or stall with the registry
off leaves no record of the seconds that preceded it. The flight recorder
closes that gap:

- **Always on.** The registry's write paths (``event``, ``set_gauge``,
  ``record_span``) append to this ring *before* the ``_enabled`` gate.
  Counters (``inc``) and histogram samples (``observe_value``) stay out —
  counters are the per-call hot path, every counter-worthy serving
  incident also emits an event, and a histogram sample duplicates an edge
  the ring already holds as a span or event.
- **Bounded.** One fixed-size deque (default ``DEFAULT_CAPACITY``
  records); old records fall off the far end. A serving process that runs
  for a month holds the last seconds-to-minutes of lifecycle history, not
  the month.
- **Cheap.** ONE bounded-deque append per record (lock-free — a single
  GIL-atomic C call). No serialization, no I/O, no per-record allocation
  beyond the dict the caller already built.
- **Thread-safe.** Appends and ``snapshot()``'s C-level materialize are
  GIL-atomic; ``snapshot()`` returns copies, so a postmortem dump never
  races the scheduler thread still recording into the ring.

Record shapes (all carry ``type`` and ``ts_us``):

- ``{"type": "event", "kind": ..., **fields}`` — registry events.
- ``{"type": "gauge", "name": ..., "value": ...}`` — gauge sets, WITH
  timestamps (the registry only keeps the latest gauge value; the ring
  keeps the recent time series, which is what the Perfetto counter tracks
  render).
- ``{"type": "span", "name", "cat", "dur_us", "tid", "args"}`` — span
  edges (request lifecycle phases, scheduler iterations, dispatches).

Records emitted through a scoped ``observe.labeled(engine="e0")`` handle
additionally carry ``"labels": {"engine": "e0"}`` — the exporters group
them into per-engine Perfetto process tracks, and a fleet postmortem can
attribute every ring record to the engine that wrote it even though N
engines share the one ring.

``observe.reset()`` / ``observe.enable(clear=True)`` do NOT clear the
ring (labeled records included) — the black box must survive registry
resets (benchmarks reset the registry between rounds; an incident bundle
still wants the history). Clear it explicitly with :func:`clear`.
"""

from __future__ import annotations

import threading
import time
from collections import deque

DEFAULT_CAPACITY = 8192

# epoch anchor so record timestamps are wall-clock-meaningful while deltas
# come from the monotonic clock (registry.py imports this clock — the ring
# and the registry must agree on the timeline for merged exports)
_EPOCH_US = time.time() * 1e6 - time.perf_counter_ns() / 1e3


def _now_us() -> float:
    return _EPOCH_US + time.perf_counter_ns() / 1e3


class FlightRecorder:
    """Fixed-capacity ring of recent observability records.

    ``append`` is LOCK-FREE: a bounded ``deque.append`` is a single C call
    (atomic under the GIL), and this is the always-on cost every recording
    entry point pays — serving decode steps record several gauges and
    spans per iteration, so the append must stay at deque-append cost.
    ``snapshot`` materializes the ring with one C-level ``list()`` (also
    atomic w.r.t. appends) and copies records outside any critical
    section; ``clear``/``resize`` swap the deque under a lock and are
    config-time operations, not hot-path ones."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()   # clear/resize swaps only
        self._ring: deque = deque(maxlen=int(capacity))
        self.total = 0          # records ever appended (advisory)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    @property
    def dropped(self) -> int:
        """Records the ring has overwritten (advisory)."""
        return max(0, self.total - len(self._ring))

    def append(self, rec: dict) -> None:
        self._ring.append(rec)
        self.total += 1

    def snapshot(self) -> list[dict]:
        """Copies of the ring contents, oldest first (one nested-dict level
        deep-copied — span ``args`` — so consumers never alias live state)."""
        recs = list(self._ring)         # one atomic C-level materialize
        return [{k: dict(v) if isinstance(v, dict) else v
                 for k, v in r.items()} for r in recs]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.total = 0

    def resize(self, capacity: int) -> None:
        """Swap in a ring of the new capacity, keeping the newest records
        that fit. ``append`` is lock-free, so a record appended exactly
        while the swap runs can land in the abandoned deque — the sweep
        below re-homes any such stragglers (found by identity after the
        last copied record). A thread that read the old ring reference
        before the publish and appends after the sweep can still lose ONE
        record; resize is a rare config-time operation, not a hot path, so
        that instruction-wide window is accepted rather than putting a
        lock on every append."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        with self._lock:
            old = self._ring
            kept = list(old)            # atomic C-level materialize
            new = deque(kept, maxlen=int(capacity))
            self._ring = new            # publish: new appends land here
            after = list(old)           # sweep stragglers that raced in
            idx = 0
            if kept:
                for i in range(len(after) - 1, -1, -1):
                    if after[i] is kept[-1]:
                        idx = i + 1
                        break
            for rec in after[idx:]:
                new.append(rec)


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def append(rec: dict) -> None:
    """Low-level append (the registry's hook). ``rec`` must already carry
    ``type`` and ``ts_us``."""
    _recorder.append(rec)


def snapshot() -> list[dict]:
    return _recorder.snapshot()


def clear() -> None:
    _recorder.clear()


def configure(capacity: int) -> None:
    """Resize the ring (keeps the newest records that fit)."""
    _recorder.resize(capacity)
