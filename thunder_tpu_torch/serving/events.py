"""The serving event vocabulary; the counterpart of
``thunder_tpu/serving/events.py``.

Every ``observe.event()`` the port's serving layer emits uses a kind from
``EVENT_KINDS`` (held both ways by ``tests/test_torch_port_supervisor.py``:
a kind emitted but missing here fails, and so does a kind here that no code
emits). It is the reference's vocabulary without the kinds of the parts
not ported yet (ROADMAP A.3): ``serving_mesh`` (tensor-parallel meshes),
``serving_engine_stalled`` (the supervisor's watchdog),
``serving_health_transition`` and ``serving_fleet_postmortem``
(``health.py``), and ``serving_route_*`` (``router.py``).

Lifecycle kinds trace one request end to end (always recorded in the
flight ring, registry on or off)::

    serving_submitted -> serving_admitted -> serving_prefill_chunk(s)
      -> serving_first_token -> serving_complete
    (with serving_preempt / serving_engine_restart detours re-entering at
     serving_admitted, and serving_shed as the error terminal)
"""

from __future__ import annotations

EVENT_KINDS = frozenset({
    # request lifecycle
    "serving_submitted",            # request entered the admission queue
    "serving_admitted",             # request took a decode slot (also resume)
    "serving_prefill_chunk",        # one prompt chunk written to KV pages
    "serving_first_token",          # first sampled token (TTFT edge)
    "serving_complete",             # terminal: finished (EOS / max tokens)
    "serving_shed",                 # terminal: removed with a typed error
    "serving_preempt",              # evicted to the queue (page pressure)
    "serving_prefix_hit",           # admission probe matched cached prompt pages
    "serving_fork",                 # best-of clone forked a primary's block table
    "serving_cache_evict",          # allocator reclaimed parked prefix-cache pages
    # engine lifecycle / supervision
    "serving_decode_bind",          # decode step (re)bound to a rung
    "serving_decode_rebind",        # re-bind forced by a quarantine-epoch move
    "serving_admission_fault",      # contained admission-domain fault
    "serving_engine_restart",       # supervisor crash recovery
    "serving_drain_bound_expired",  # drain wall-clock bound shed the rest
    "serving_restart_budget_exhausted",  # restart rung refused; escalating
    "serving_slo_collapse",         # rolling SLO attainment fell below floor
    "serving_postmortem",           # black-box bundle written to disk
})
