"""thunder_tpu_torch.observe: the process-wide metric registry and the
always-on flight recorder, the port's counterparts of
``thunder_tpu/observe/registry.py`` and ``flight.py``.

- ``registry``: counters, gauges, histograms, events and spans, with one
  boolean check per write while the registry is off (``enable``/
  ``disable``/``is_enabled``/``reset``), ``labeled(engine=...)`` handles
  and ``snapshot()``;
- ``flight``: the bounded ring the registry's ``event``, ``set_gauge`` and
  ``record_span`` feed before the enabled gate, so a fault leaves a record
  even with the registry off.

The runtime modules (``runtime.faults``, ``retry``, ``quarantine``,
``sentinel``) and the serving engine write here. The reference's exporters,
explain, census, profile and calibration layers are not ported yet.

    from thunder_tpu_torch import observe
    observe.enable(clear=True)
    ...
    observe.snapshot()["counters"]
"""

from __future__ import annotations

from thunder_tpu_torch.observe import flight  # noqa: F401
from thunder_tpu_torch.observe.registry import (  # noqa: F401
    Labeled,
    disable,
    enable,
    engines_seen,
    event,
    get_registry,
    inc,
    is_enabled,
    labeled,
    observe_value,
    record_span,
    reset,
    set_gauge,
    snapshot,
    span,
)
