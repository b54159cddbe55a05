"""Common trace-to-trace transforms: DCE, CSE, the user ``Transform`` and
the bound-symbol DAG utilities.

The counterpart of ``thunder_tpu/core/transform_common.py``: ``dce``,
``cse``, the :class:`Transform` whose hooks ``jit(transforms=)`` calls
(before DCE/CSE, after the claims, around each cached entry's calls),
:func:`visitor_transform` and the dataflow DAG of a bound-symbol list
(:func:`bsym_list_to_dag`, :func:`toposort_bsym_dag`). In-place torch ops
never reach a trace: the torch front end functionalizes them while tracing.
"""

from __future__ import annotations

from enum import Enum, auto

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, Variable
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace
from thunder_tpu_torch.core.utils import consumed_vars, consumers, produced_vars, producers


def dce(trc: TraceCtx) -> TraceCtx:
    """Dead-code elimination over top-level bound symbols."""
    needed: set[Variable] = set()
    keep: list[BoundSymbol] = []
    for bsym in reversed(trc.bound_symbols):
        if (OpTags.DONT_DCE in bsym.sym.tags
                or bsym.sym.id in (PrimIDs.PYTHON_RETURN, PrimIDs.PYTHON_DEL)
                or any(v in needed for v in produced_vars(bsym))):
            keep.append(bsym)
            needed |= consumed_vars(bsym)
    new = from_trace(trc)
    new.bound_symbols = list(reversed(keep))
    new.set_provenance("Dead code elimination")
    return new


def cse(trc: TraceCtx) -> TraceCtx:
    """Common-subexpression elimination (effectful ops are kept)."""
    seen: dict = {}
    swap: dict[Variable, Proxy] = {}
    out: list[BoundSymbol] = []
    for bsym in trc.bound_symbols:
        if swap:
            bsym = bsym.from_bsym_swap_proxies(swap, skip_output=True)
        if OpTags.DONT_DCE in bsym.sym.tags or bsym.sym.id is PrimIDs.PYTHON_RETURN:
            out.append(bsym)
            continue
        key = bsym.rhs
        prev = seen.get(key)
        if prev is None:
            seen[key] = bsym
            out.append(bsym)
        else:
            for old, new in zip(bsym.flat_proxy_outs(), prev.flat_proxy_outs()):
                swap[Variable(old)] = new
    new = from_trace(trc)
    new.bound_symbols = out
    new.set_provenance("Common subexpression elimination")
    return new



class Transform:
    """A user transform with the reference's three hooks
    (``thunder_tpu/core/transform_common.py:70``). ``jit(transforms=[...])``
    calls ``transform_traces_pre_prologue`` on the traced program before
    DCE/CSE and ``transform_trace_post_optimization`` on the execution trace
    after the claims, before ``del`` insertion. A transform may also
    define ``wrap_run_fn(jfn, entry, inner)``, which wraps each cached
    entry's calls (the first transform's wrapper outermost); runtime inputs
    a transform appends to the trace's signature are fed by its wrapper."""

    def transform_traces_pre_prologue(self, prologue_trc, computation_trc, epilogue_trc,
                                      **kwargs):
        return prologue_trc, computation_trc, epilogue_trc

    def transform_trace_post_optimization(self, trc: TraceCtx, **kwargs) -> TraceCtx:
        return trc

    def transform_module(self, model):
        return model


# ---------------------------------------------------------------------------
# the visitor transform and the bound-symbol DAG
# (thunder_tpu/core/transform_common.py:90-213)
# ---------------------------------------------------------------------------

class VisitType(Enum):
    """What :func:`visitor_transform`'s callback asked for, a bound symbol."""

    NO_OP = auto()          # keep the original; drop anything recorded
    REPLACE = auto()        # drop the original; splice in what was recorded
    INSERT_BEFORE = auto()  # what was recorded goes before the original
    INSERT_AFTER = auto()   # what was recorded goes after the original


def visitor_transform(trc: TraceCtx, visit, *, provenance: str | None = None) -> TraceCtx:
    """``trc`` rebuilt by ``visit(bsym) -> VisitType`` for each bound symbol:
    the ops the callback records (by calling ops under the trace context)
    are spliced in as the returned :class:`VisitType` says. A REPLACE
    rebinds the replaced symbol's consumers to the outputs of the last
    recorded op, position by position."""
    from thunder_tpu_torch.core.trace import tracectx

    new = from_trace(trc)
    swap: dict[Variable, Proxy] = {}
    with tracectx(new):
        for bsym in trc.bound_symbols:
            if swap:
                bsym = bsym.from_bsym_swap_proxies(swap, skip_output=True)
            scope: list[BoundSymbol] = []
            new.push_scope(scope)
            try:
                vt = visit(bsym)
            finally:
                new.pop_scope()
            if vt is VisitType.REPLACE:
                new.bound_symbols.extend(scope)
                if scope:
                    old_outs = bsym.flat_proxy_outs()
                    repl_outs = scope[-1].flat_proxy_outs()
                    check(len(old_outs) == len(repl_outs),
                          lambda: f"visitor REPLACE: the replaced op has {len(old_outs)} proxy "
                                  f"outputs but the last recorded op has {len(repl_outs)}; "
                                  "record a last op producing all the replacements")
                    for old, repl in zip(old_outs, repl_outs):
                        if old is not repl:
                            swap[Variable(old)] = repl
            elif vt is VisitType.INSERT_BEFORE:
                new.bound_symbols.extend(scope)
                new.bound_symbols.append(bsym)
            elif vt is VisitType.INSERT_AFTER:
                new.bound_symbols.append(bsym)
                new.bound_symbols.extend(scope)
            else:
                new.bound_symbols.append(bsym)
    if provenance is not None:
        new.set_provenance(provenance)
    return new


class Node:
    """A DAG node holding one bound symbol: its parents produce its inputs,
    its children consume its outputs."""

    __slots__ = ("bsym", "parents", "children")

    def __init__(self, bsym: BoundSymbol):
        self.bsym = bsym
        self.parents: list[Node] = []
        self.children: list[Node] = []

    def __repr__(self):
        return f"Node({self.bsym.sym.name})"


def bsym_list_to_dag(bsyms) -> tuple[list[Node], list[Node]]:
    """The dataflow DAG over a bound-symbol list: ``(roots, leaves)``."""
    bsyms = list(bsyms)
    prod, cons = producers(bsyms), consumers(bsyms)
    nodes = [Node(b) for b in bsyms]
    by_bsym = {id(b): n for b, n in zip(bsyms, nodes)}
    roots, leaves = [], []
    for node in nodes:
        seen_parents = set()
        for v in consumed_vars(node.bsym):
            p = prod.get(v)
            if p is not None and id(p) != id(node.bsym) and id(p) not in seen_parents:
                seen_parents.add(id(p))
                node.parents.append(by_bsym[id(p)])
        seen_children = set()
        for v in produced_vars(node.bsym):
            for c in cons.get(v, ()):
                if id(c) != id(node.bsym) and id(c) not in seen_children:
                    seen_children.add(id(c))
                    node.children.append(by_bsym[id(c)])
        if not node.parents:
            roots.append(node)
        if not node.children:
            leaves.append(node)
    return roots, leaves


def toposort_bsym_dag(start_nodes: list[Node], order: str = "top_down",
                      selector=None) -> list[BoundSymbol]:
    """A topological order of a bound-symbol DAG. ``order`` is "top_down"
    (from the roots) or "bottom_up" (from the leaves; the result is still in
    execution order). ``selector(eligible) -> int`` picks among the nodes
    ready to be placed (the first, unless given)."""
    check(order in ("top_down", "bottom_up"), lambda: f"unknown toposort order {order!r}")
    if selector is None:
        selector = lambda eligible: 0  # noqa: E731
    done: set[int] = set()
    out: list[BoundSymbol] = []
    eligible = list(start_nodes)
    while eligible:
        node = eligible.pop(selector(eligible))
        out.append(node.bsym)
        done.add(id(node))
        nxt = node.parents if order == "bottom_up" else node.children
        for cand in nxt:
            deps = cand.children if order == "bottom_up" else cand.parents
            if id(cand) not in done and all(id(d) in done for d in deps):
                eligible.append(cand)
    return list(reversed(out)) if order == "bottom_up" else out
