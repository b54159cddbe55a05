"""Pattern matching over traces: declarative bsym-chain rewrites.

The counterpart of ``thunder_tpu/core/patterns.py``. A :class:`Pattern` is
an ordered chain of predicates; step ``i+1`` must consume an output of step
``i`` (dataflow-connected, not necessarily adjacent). :func:`rewrite`
splices in a build function's replacement where no intermediate value escapes the
chain, or, for multi-output fusions, where the replacement produces every
escaping value.
"""

from __future__ import annotations

from typing import Callable

from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, Variable
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace
from thunder_tpu_torch.core.utils import consumed_vars


class Pattern:
    def __init__(self, name: str = "pattern"):
        self.name = name
        self.steps: list[Callable[[BoundSymbol, dict], bool]] = []

    def step(self, pred: Callable[[BoundSymbol, dict], bool]) -> "Pattern":
        self.steps.append(pred)
        return self

    def find(self, trc: TraceCtx, consumers=None) -> list[tuple[list[int], dict]]:
        """All non-overlapping matches, each as (bsym indices, env)."""
        bsyms = trc.bound_symbols
        taken: set[int] = set()
        matches: list[tuple[list[int], dict]] = []
        if consumers is None:
            consumers = _consumer_index(bsyms)
        for start in range(len(bsyms)):
            if start in taken:
                continue
            env: dict = {}
            chain = [start]
            if not self._try(bsyms, start, 0, chain, env, taken, consumers):
                continue
            if any(i in taken for i in chain):
                continue
            matches.append((chain, env))
            taken.update(chain)
        return matches

    def _try(self, bsyms, idx, step, chain, env, taken, consumers) -> bool:
        b = bsyms[idx]
        if b.sym.id in (PrimIDs.PYTHON_RETURN, PrimIDs.PYTHON_DEL):
            return False
        try:
            ok = self.steps[step](b, env)
        except Exception:
            ok = False
        if not ok:
            return False
        if step == len(self.steps) - 1:
            del chain[step + 1:]
            return True
        cand: set[int] = set()
        for o in b.flat_proxy_outs():
            cand.update(j for j in consumers.get(Variable(o), ()) if j > idx)
        for j in sorted(cand):
            if j in taken:
                continue
            chain[step + 1:] = [j]
            saved = dict(env)
            if self._try(bsyms, j, step + 1, chain, env, taken, consumers):
                return True
            env.clear()
            env.update(saved)
        return False


def _consumer_index(bsyms) -> dict[Variable, list[int]]:
    consumers: dict[Variable, list[int]] = {}
    for i, b in enumerate(bsyms):
        for a in b.flat_proxy_args():
            consumers.setdefault(Variable(a), []).append(i)
    return consumers


def _escapees(bsyms, idxs, trc, consumers) -> set[Variable]:
    """Vars produced inside the match and consumed outside it (or returned)."""
    inside = set(idxs)
    produced = {Variable(o) for i in idxs for o in bsyms[i].flat_proxy_outs()}
    escaped = {v for v in produced if any(j not in inside for j in consumers.get(v, ()))}
    for o in tree_flatten(trc.output)[0]:
        if isinstance(o, Proxy) and Variable(o) in produced:
            escaped.add(Variable(o))
    return escaped


def rewrite(trc: TraceCtx, pattern: Pattern, build, allow_escaping_last: bool = True,
            allow_escaping_intermediates: bool = False) -> TraceCtx:
    """Replace each match with ``build(trc, matched_bsyms, env)``'s bsyms."""
    bsyms = list(trc.bound_symbols)
    consumers = _consumer_index(bsyms)
    matches = pattern.find(trc, consumers)
    if not matches:
        return trc
    to_replace: dict[int, list[BoundSymbol]] = {}
    dropped: set[int] = set()
    for idxs, env in matches:
        last = idxs[-1]
        esc = _escapees(bsyms, idxs, trc, consumers)
        last_outs = {Variable(o) for o in bsyms[last].flat_proxy_outs()}
        inner_escapes = esc - (last_outs if allow_escaping_last else set())
        if inner_escapes and not allow_escaping_intermediates:
            continue
        if inner_escapes:
            # the replacement lands at the last matched index: a consumer of
            # an escaping intermediate between the matched bsyms would read
            # it before the fused op defines it
            inside = set(idxs)
            if any(j not in inside and inner_escapes & consumed_vars(bsyms[j])
                   for j in range(idxs[0] + 1, last)):
                continue
        replacement = build(trc, [bsyms[i] for i in idxs], env)
        if replacement is None:
            continue
        if inner_escapes:
            produced = {Variable(o) for b in replacement for o in b.flat_proxy_outs()}
            if not inner_escapes <= produced:
                continue
        to_replace[last] = replacement
        dropped.update(i for i in idxs if i != last)
    if not to_replace:
        return trc
    new = from_trace(trc)
    out: list[BoundSymbol] = []
    for i, b in enumerate(bsyms):
        if i in dropped:
            continue
        out.extend(to_replace[i] if i in to_replace else [b])
    new.bound_symbols = out
    new.set_provenance(f"Pattern rewrite ({pattern.name})")
    return new
