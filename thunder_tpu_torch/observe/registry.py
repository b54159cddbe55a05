"""Process-wide event/metric registry: counters, gauges, histograms, spans.

The port's own copy of ``thunder_tpu/observe/registry.py``, name for name.
The instrumentation contract for the runtime stack:

- **Near-zero cost when disabled.** Every recording entry point checks one
  module-level boolean first and returns immediately; ``span()`` records
  only its clock reads. The hot paths (the kernel guard per routed call,
  the serving scheduler per step) pay a single predictable branch.
- **Thread-safe when enabled.** Mutations take one lock; ``snapshot()``
  returns plain-dict copies so readers never race recorders.
- **Bounded.** Events and spans live in deques with a max length — a
  long-running serving process with observability left on cannot grow
  memory without bound.
- **Black-boxed.** Events, gauge sets, and span edges ALSO land in the
  always-on flight recorder (``flight.py``) *before* the enabled gate —
  one bounded deque append — so a postmortem after a fault has the recent
  history even when the registry was never enabled. Counters and histogram
  samples stay out of the ring: ``inc`` is the per-call hot path, every
  counter-worthy incident also emits an event, and a histogram sample
  duplicates an edge the ring already holds as a span or event (the
  aggregate lives in the registry).

Metric names are dotted (``runtime.faults_injected``,
``serving.decode_rebinds``, ``runtime.grad_norm``).

**Labels.** ``labeled(engine="e0")`` returns a scoped handle whose
``inc``/``set_gauge``/``observe_value``/``event``/``record_span``/``span``
mirror the module entry points but additionally key a parallel series store
on ``(name, frozen labels)`` and stamp the label dict onto every flight-ring
record. Unlabeled paths are untouched — same records, same single
enabled-boolean check — and labeled writes *also* update the unlabeled
series (the process-wide view stays whole; the labeled view disambiguates).
``reset()``/``enable(clear=True)`` clear labeled series for ALL label sets;
the flight ring survives either, labels and all.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from thunder_tpu_torch.observe import flight as _flight
from thunder_tpu_torch.observe.flight import _now_us

MAX_EVENTS = 65536
MAX_SPANS = 65536

# histogram bucket ladder (unitless; walltimes are recorded in ms)
HIST_BOUNDS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
               250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    __slots__ = ("count", "total", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets = [0] * (len(HIST_BOUNDS) + 1)  # last = +Inf

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        for i, b in enumerate(HIST_BOUNDS):
            if value <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": dict(zip([*map(str, HIST_BOUNDS), "+Inf"], self.buckets))}


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self.events: deque = deque(maxlen=MAX_EVENTS)
        self.spans: deque = deque(maxlen=MAX_SPANS)
        # labeled series: keyed (name, tuple(sorted (k, v) pairs)) — one
        # flat dict per metric family, every label set an independent series
        self.labeled_counters: dict[tuple, float] = {}
        self.labeled_gauges: dict[tuple, float] = {}
        self.labeled_histograms: dict[tuple, Histogram] = {}

    def clear(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self.events.clear()
            self.spans.clear()
            self.labeled_counters.clear()
            self.labeled_gauges.clear()
            self.labeled_histograms.clear()


_registry = Registry()
_enabled = False

# the wall-clock/monotonic epoch anchor lives in flight.py (imported above
# as _now_us) — the registry and the flight ring must share one timeline


def enable(*, clear: bool = False) -> None:
    """Turn instrumentation on process-wide. ``clear=True`` resets all
    previously recorded metrics/events first (the flight ring is NOT
    cleared — the black box survives registry resets)."""
    global _enabled
    if clear:
        _registry.clear()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear all recorded metrics, events, and spans (enabled state is kept)."""
    _registry.clear()


def get_registry() -> Registry:
    return _registry


# ---------------------------------------------------------------------------
# recording entry points (each begins with the enabled check)
# ---------------------------------------------------------------------------

def inc(name: str, value: float = 1.0) -> None:
    if not _enabled:
        return
    with _registry._lock:
        _registry.counters[name] = _registry.counters.get(name, 0.0) + value


def set_gauge(name: str, value: float) -> None:
    value = float(value)
    # always-on: gauge moves are the flight ring's counter-track time series
    _flight.append({"type": "gauge", "name": name, "value": value,
                    "ts_us": _now_us()})
    if not _enabled:
        return
    with _registry._lock:
        _registry.gauges[name] = value


def observe_value(name: str, value: float) -> None:
    # registry-only by design: histogram samples don't ring-append — every
    # sample the serving layer records duplicates an edge the ring already
    # holds as a span or event, and doubling lifecycle edges would halve
    # the black box's usable pre-incident history
    if not _enabled:
        return
    with _registry._lock:
        h = _registry.histograms.get(name)
        if h is None:
            h = _registry.histograms[name] = Histogram()
        h.observe(value)


def event(kind: str, **fields: Any) -> None:
    rec = {"kind": kind, "ts_us": _now_us(), **fields}
    _flight.append({"type": "event", **rec})
    if not _enabled:
        return
    with _registry._lock:
        _registry.events.append(rec)


def record_span(name: str, cat: str, ts_us: float, dur_us: float,
                args: dict | None = None) -> None:
    rec = {"name": name, "cat": cat, "ts_us": ts_us, "dur_us": dur_us,
           "tid": threading.get_ident(), "args": args or {}}
    _flight.append({"type": "span", **rec})
    # gate like every other write path (this wrote to the registry
    # unconditionally before — a disabled process accumulated spans)
    if not _enabled:
        return
    with _registry._lock:
        _registry.spans.append(rec)


# ---------------------------------------------------------------------------
# labeled series
# ---------------------------------------------------------------------------

def labels_key(labels: dict) -> tuple:
    """Canonical frozen form of a label dict: sorted ``(key, str(value))``
    pairs. This is the second element of every labeled-series key."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Labeled:
    """Scoped recording handle that stamps a fixed label set.

    Mirrors the module entry points (``inc``/``set_gauge``/``observe_value``/
    ``event``/``record_span``/``span``) with identical gating — one enabled
    boolean, flight-ring appends before the gate — but every write ALSO
    lands in the labeled series keyed ``(name, frozen labels)``, and every
    ring record carries ``labels`` so exporters can group per engine.
    Unlabeled series still receive the write (last-writer-wins for gauges,
    summed for counters): the process-wide view stays whole, the labeled
    view is the disambiguated one."""

    __slots__ = ("_key", "_dict")

    def __init__(self, **labels: Any):
        if not labels:
            raise ValueError("labeled() needs at least one label, e.g. engine='e0'")
        self._key = labels_key(labels)
        self._dict = dict(self._key)

    @property
    def labels(self) -> dict:
        return dict(self._dict)

    def inc(self, name: str, value: float = 1.0) -> None:
        if not _enabled:
            return
        with _registry._lock:
            _registry.counters[name] = _registry.counters.get(name, 0.0) + value
            key = (name, self._key)
            _registry.labeled_counters[key] = \
                _registry.labeled_counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        value = float(value)
        _flight.append({"type": "gauge", "name": name, "value": value,
                        "labels": dict(self._dict), "ts_us": _now_us()})
        if not _enabled:
            return
        with _registry._lock:
            _registry.gauges[name] = value
            _registry.labeled_gauges[(name, self._key)] = value

    def observe_value(self, name: str, value: float) -> None:
        if not _enabled:
            return
        with _registry._lock:
            h = _registry.histograms.get(name)
            if h is None:
                h = _registry.histograms[name] = Histogram()
            h.observe(value)
            key = (name, self._key)
            lh = _registry.labeled_histograms.get(key)
            if lh is None:
                lh = _registry.labeled_histograms[key] = Histogram()
            lh.observe(value)

    def event(self, kind: str, **fields: Any) -> None:
        rec = {"kind": kind, "ts_us": _now_us(),
               "labels": dict(self._dict), **fields}
        _flight.append({"type": "event", **rec})
        if not _enabled:
            return
        with _registry._lock:
            _registry.events.append(rec)

    def record_span(self, name: str, cat: str, ts_us: float, dur_us: float,
                    args: dict | None = None) -> None:
        rec = {"name": name, "cat": cat, "ts_us": ts_us, "dur_us": dur_us,
               "tid": threading.get_ident(), "labels": dict(self._dict),
               "args": args or {}}
        _flight.append({"type": "span", **rec})
        if not _enabled:
            return
        with _registry._lock:
            _registry.spans.append(rec)

    def span(self, name: str, cat: str = "serving", args: dict | None = None):
        return _SpanCM(name, cat, args, rec=self)

    def snapshot(self) -> dict:
        """This label set's series only, keyed by bare metric name — the
        per-engine view a consumer (bench, statusz) reads without caring
        which other engines share the process."""
        k = self._key
        with _registry._lock:
            return {
                "labels": dict(self._dict),
                "counters": {n: v for (n, l), v in
                             _registry.labeled_counters.items() if l == k},
                "gauges": {n: v for (n, l), v in
                           _registry.labeled_gauges.items() if l == k},
                "histograms": {n: h.to_dict() for (n, l), h in
                               _registry.labeled_histograms.items() if l == k},
            }


def labeled(**labels: Any) -> Labeled:
    """Scoped handle recording under a frozen label set: see :class:`Labeled`."""
    return Labeled(**labels)


def engines_seen() -> list[str]:
    """Sorted ``engine`` label values present in any labeled series — how a
    fleet consumer discovers which engines shared this process's registry."""
    out = set()
    with _registry._lock:
        for store in (_registry.labeled_counters, _registry.labeled_gauges,
                      _registry.labeled_histograms):
            for (_, lbls) in store:
                for k, v in lbls:
                    if k == "engine":
                        out.add(v)
    return sorted(out)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _SpanCM:
    __slots__ = ("name", "cat", "args", "rec", "_t0", "_ts")

    def __init__(self, name, cat, args, rec=None):
        self.name = name
        self.cat = cat
        self.args = args
        self.rec = rec  # a Labeled handle, or None for the module path

    def __enter__(self):
        self._ts = _now_us()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur_ns = time.perf_counter_ns() - self._t0
        # record_span is itself always-on (flight ring) and gates the
        # registry write; the derived histogram sample is registry-only
        # (observe_value doesn't ring-append — the ring already holds the
        # span edge with its duration)
        r = self.rec
        if r is None:
            record_span(self.name, self.cat, self._ts, dur_ns / 1e3, self.args)
            observe_value(f"{self.cat}.{self.name}.ms", dur_ns / 1e6)
        else:
            r.record_span(self.name, self.cat, self._ts, dur_ns / 1e3, self.args)
            r.observe_value(f"{self.cat}.{self.name}.ms", dur_ns / 1e6)
        return False


def span(name: str, cat: str = "compile", args: dict | None = None):
    """Timed span context manager. Records into the process registry when
    enabled, and into the always-on flight ring regardless — a span edge is
    black-box history. (The reference's per-compile pass-time sink has no
    counterpart: the port compiles no traces.)"""
    return _SpanCM(name, cat, args)


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

def _copy_rec(rec: dict) -> dict:
    # records hold one level of nested dicts (span args, decision cost);
    # copy that level too so a mutated snapshot never aliases live registry
    # state (and exporters never race a recorder mutating a shared dict)
    return {k: dict(v) if isinstance(v, dict) else v for k, v in rec.items()}


def snapshot() -> dict:
    """Plain-dict copy of all metrics/events/spans (safe to mutate/serialize).

    Labeled series come back as lists of records (``{"name", "labels",
    "value"}``, histograms with the bucket dict inlined) — JSON-safe, and
    the shape exporters render without re-deriving label keys."""
    with _registry._lock:
        return {
            "counters": dict(_registry.counters),
            "gauges": dict(_registry.gauges),
            "histograms": {k: h.to_dict() for k, h in _registry.histograms.items()},
            "events": [_copy_rec(e) for e in _registry.events],
            "spans": [_copy_rec(s) for s in _registry.spans],
            "labeled": {
                "counters": [{"name": n, "labels": dict(l), "value": v}
                             for (n, l), v in _registry.labeled_counters.items()],
                "gauges": [{"name": n, "labels": dict(l), "value": v}
                           for (n, l), v in _registry.labeled_gauges.items()],
                "histograms": [{"name": n, "labels": dict(l), **h.to_dict()}
                               for (n, l), h in _registry.labeled_histograms.items()],
            },
        }
