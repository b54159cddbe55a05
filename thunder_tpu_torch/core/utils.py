"""Trace dataflow analysis: producers/consumers, free variables.

The counterpart of ``thunder_tpu/core/utils.py`` (``produced_vars``,
``consumed_vars``, ``producers``, ``consumers``, ``free_vars``): analyses recurse into
subsymbols (a composite consumes/produces everything its decomposition
does) and are memoized per BoundSymbol, which is dataflow-immutable after
construction.
"""

from __future__ import annotations

from thunder_tpu_torch.core.proxies import Variable
from thunder_tpu_torch.core.symbol import BoundSymbol


def produced_vars(bsym: BoundSymbol) -> frozenset[Variable]:
    cached = bsym._produced_cache
    if cached is not None:
        return cached
    out = {Variable(p) for p in bsym.flat_proxy_outs()}
    for sub in bsym.subsymbols:
        out |= produced_vars(sub)
    result = frozenset(out)
    bsym._produced_cache = result
    return result


def consumed_vars(bsym: BoundSymbol) -> frozenset[Variable]:
    """Free proxy inputs of a bound symbol (recursing into subsymbols)."""
    cached = bsym._consumed_cache
    if cached is not None:
        return cached
    produced: set[Variable] = set()
    consumed: set[Variable] = set()

    def walk(b: BoundSymbol):
        for p in b.flat_proxy_args():
            v = Variable(p)
            if v not in produced:
                consumed.add(v)
        for sub in b.subsymbols:
            walk(sub)
            for p in sub.flat_proxy_outs():
                produced.add(Variable(p))
        for p in b.flat_proxy_outs():
            produced.add(Variable(p))

    walk(bsym)
    result = frozenset(consumed)
    bsym._consumed_cache = result
    return result


def producers(bsyms) -> dict[Variable, BoundSymbol]:
    """Each variable's first producer among ``bsyms``."""
    m: dict[Variable, BoundSymbol] = {}
    for bsym in bsyms:
        for v in produced_vars(bsym):
            m.setdefault(v, bsym)
    return m


def consumers(bsyms) -> dict[Variable, list[BoundSymbol]]:
    """Each variable's consumers among ``bsyms``, in order."""
    m: dict[Variable, list[BoundSymbol]] = {}
    for bsym in bsyms:
        for v in consumed_vars(bsym):
            m.setdefault(v, []).append(bsym)
    return m


def free_vars(bsyms) -> list[Variable]:
    """Proxies the bound symbols read but do not produce, in first-read
    order."""
    produced: set[Variable] = set()
    out: list[Variable] = []
    seen: set[Variable] = set()
    for b in bsyms:
        for v in consumed_vars(b):
            if v not in produced and v not in seen:
                seen.add(v)
                out.append(v)
        produced |= produced_vars(b)
    return out
