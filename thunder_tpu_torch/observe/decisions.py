"""The per-compile decision log: every claim and rejection, every fusion
accepted or refused, with the cost-model numbers behind each verdict.

The counterpart of ``thunder_tpu/observe/decisions.py``. A compile collects
its decisions into ``CompileStats.last_decisions`` (a sink
:func:`collect` installs), so the log is read without turning on the
process-wide registry; while the registry is on, each decision is also an
event. A record::

    {"kind": "claim" | "fusion" | "block",
     "op": <symbol name or pattern>,
     "executor": <name> | None,
     "decision": "claimed" | "rejected" | "decomposed" | "fallback"
                 | "merged" | "rewritten" | "bucketed" | a block kind,
     "reason": <short string>,
     "cost": {<cost-model inputs and estimates>} | None}
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar

from thunder_tpu_torch.observe import registry as _registry

_sink: ContextVar[list | None] = ContextVar("thunder_tpu_torch_decision_sink", default=None)


@contextmanager
def collect():
    """Install a fresh decision sink; yields the list decisions go to."""
    decisions: list[dict] = []
    tok = _sink.set(decisions)
    try:
        yield decisions
    finally:
        _sink.reset(tok)


def active() -> bool:
    return _sink.get() is not None or _registry.is_enabled()


def current_log() -> list | None:
    """The live decision list of the compile in progress (the list that
    becomes ``CompileStats.last_decisions``), or None outside one."""
    return _sink.get()


def record(kind: str, op: str, executor: str | None, decision: str,
           reason: str = "", cost: dict | None = None) -> None:
    sink = _sink.get()
    if sink is None and not _registry.is_enabled():
        return
    rec = {"kind": kind, "op": op, "executor": executor,
           "decision": decision, "reason": reason, "cost": cost}
    if sink is not None:
        sink.append(rec)
    _registry.event("decision", decision_kind=kind, op=op, executor=executor,
                    decision=decision, reason=reason, cost=cost)
