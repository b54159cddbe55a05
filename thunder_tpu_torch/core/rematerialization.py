"""Activation checkpointing: the counterpart of
``thunder_tpu/core/rematerialization.py`` ``checkpoint`` (:327).

Called inside a traced function (under ``thunder_tpu_torch.jit``),
``checkpoint(fn)`` emits the reference's ``checkpoint_N`` composite: the
forward runs the region as recorded, and its VJP re-traces the region in
the backward, so the region's intermediates are recomputed there instead of
saved, and only its inputs are kept. The recompute's inputs pass through an
``opt_barrier`` tied to the incoming cotangent: without that pin, CSE would
merge the recompute back into the forward and the saved activations would
return. Tensors the region closes over (the rope tables) become explicit
region inputs.

Called eagerly, the same contract is ``torch.utils.checkpoint`` in its
non-reentrant form: the region runs once in the forward with its saved
tensors dropped, and again in the backward to rebuild them.
:func:`recomputing` tells code inside an eager region which of the two runs
it is in: the reference's fusion passes see the forward region and its
recomputed copy as two traces and fuse them differently, and an eager
region that wants the same kernel calls as the reference's trace reads it
(``models/llama._remat_block``). Under ``jit`` the epilogue pass makes that
difference itself, and ``recomputing()`` stays False.

The reference's min-cut: :func:`find_cut` chooses what a split forward
(``core.transforms.forward_and_backward_from_trace``) saves for its
backward, and :func:`rematerialize_forward_and_backward` rewrites the pair
to save that and recompute the rest. The reference runs networkx's
max-flow; here a max-flow of its own (Dinic's, over exact integer
capacities) stands in, so nothing beyond the standard library is needed.
The torch-autograd bridge does not apply it, as the reference's does not;
``rematerialize_all_gather`` comes with the distributed transforms (ROADMAP
A.2).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
from collections import deque
from typing import Any

import torch.utils.checkpoint

from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, get_tracectx
from thunder_tpu_torch.observe import registry as _observe

_state = threading.local()
_ckpt_ids = itertools.count()


def recomputing() -> bool:
    """True while an eager checkpointed region is being recomputed in the
    backward."""
    return getattr(_state, "recomputing", False)


class _Recompute:
    """The context a region's recompute runs in. Every backward through a
    retained graph recomputes the region again in the same context object,
    so it may be entered more than once."""

    def __enter__(self):
        self._before = recomputing()
        _state.recomputing = True

    def __exit__(self, *exc):
        _state.recomputing = self._before


def _contexts():
    return contextlib.nullcontext(), _Recompute()


def checkpoint_region(fn):
    """The trace-level region over proxies: ``fn`` takes and returns
    TensorProxies; calling the result inside a trace records one
    ``checkpoint_N`` composite whose VJP recomputes ``fn``."""
    from thunder_tpu_torch.core.transforms import (
        _env_map, _trace_subfn, augmented_forward, backward_pass, eval_trace,
        promote_free_vars, register_vjp)

    def wrapped(*args):
        inner, inner_inputs, _ = _trace_subfn(fn, args, {})
        frees = promote_free_vars(inner, inner_inputs)
        inner_inputs = inner.args
        sid = f"checkpoint_{next(_ckpt_ids)}"
        sym = Symbol("checkpoint", lambda *ps: eval_trace(inner, *ps), id=sid)

        @register_vjp(sid)
        def _ckpt_vjp(*rargs):
            out = sym(*rargs)

            def pullback(g):
                # recompute the region from its inputs pinned to the cotangent
                g_tensors = [x for x in (g if isinstance(g, (tuple, list)) else (g,))
                             if isinstance(x, TensorProxy)]
                slots = [i for i, leaf in enumerate(rargs) if isinstance(leaf, TensorProxy)]
                pinned_args = list(rargs)
                if slots and g_tensors:
                    pinned = prims.opt_barrier(*[rargs[i] for i in slots], *g_tensors)
                    for k, i in enumerate(slots):
                        pinned_args[i] = pinned[k]
                env = {Variable(p): leaf for p, leaf in zip(inner_inputs, pinned_args)}
                records = augmented_forward(inner.bound_symbols, env)
                re_out = _env_map(env, inner.output)
                out_flat = [o for o in tree_flatten(re_out)[0]
                            if isinstance(o, TensorProxy) and o.dtype.is_inexact]
                g_flat = list(g) if isinstance(g, (tuple, list)) else [g]
                grads: dict[Variable, Any] = {Variable(o): ct for o, ct in zip(out_flat, g_flat)
                                              if ct is not None}
                backward_pass(records, grads)
                # the gradients of the pinned inputs belong to the caller's
                return [(orig, grads.get(Variable(pin)))
                        for orig, pin in zip(rargs, pinned_args) if isinstance(orig, TensorProxy)]

            return out, pullback

        # only proxy leaves are the symbol's args; constants are baked into
        # the region's trace
        return sym(*[a for a in tree_flatten(args)[0] if isinstance(a, Proxy)], *frees)

    return wrapped


def checkpoint(fn):
    """``fn`` as a checkpointed region: called with tensors (or trees of
    them) it returns what ``fn`` returns, saves only its inputs for the
    backward, and recomputes ``fn`` there; under ``jit`` as a trace-level
    region (:func:`checkpoint_region`), eagerly through
    ``torch.utils.checkpoint``."""

    @functools.wraps(fn)
    def wrapped(*args):
        if get_tracectx() is not None:
            from thunder_tpu_torch.torch import on_proxies, on_torch

            return on_torch(checkpoint_region(on_proxies(fn)))(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=_contexts)

    return wrapped


# ---------------------------------------------------------------------------
# the min-cut: what a split forward saves for its backward
# ---------------------------------------------------------------------------

_SKIP_IDS = (PrimIDs.PYTHON_RETURN, PrimIDs.COMMENT, PrimIDs.PYTHON_DEL)

# ops the backward must not recompute: the products, where a recompute costs
# real FLOPs (the cut saves their outputs or something cheaper downstream)
_EXPENSIVE_IDS = {PrimIDs.DOT_GENERAL}
_EXPENSIVE_NAMES = {"matmul", "linear", "conv1d", "conv2d", "scaled_dot_product_attention",
                    "cross_entropy"}

# Capacities are exact integers in units of 1e-6 byte: a tensor of b bytes
# costs b * 10**6, a value that is free to keep (a trace input, a number)
# costs 1, the reference's 1e-6 (below any real tensor's, a 1-byte bool
# scalar's 10**6), and an infinite edge costs one more than every finite
# capacity of the graph together, so no minimum cut crosses one. Python
# integers do not overflow: an 8.4 GB float32 logits tensor keeps its
# exact cost.
_UNITS_PER_BYTE = 10 ** 6
_FREE = 1


def _is_expensive(bsym: BoundSymbol) -> bool:
    if bsym.sym.id in _EXPENSIVE_IDS or bsym.sym.name in _EXPENSIVE_NAMES:
        return True
    # a composite holding an expensive op is expensive to recompute
    return any(_is_expensive(s) for s in bsym.subsymbols)


def _save_cost(p: Proxy) -> float:
    """The bytes saving ``p`` keeps alive (1e-6 for a number or a string)."""
    if isinstance(p, TensorProxy):
        return float(max(p.numel, 1) * p.dtype.bytes)
    return 1e-6


def _capacity(p: Proxy, free: bool) -> int:
    if free or not isinstance(p, TensorProxy):
        return _FREE
    return max(p.numel, 1) * p.dtype.bytes * _UNITS_PER_BYTE


class _FlowGraph:
    """A directed graph for max-flow: edge ``e`` and its residual twin
    ``e ^ 1``. An edge added again keeps its last capacity (networkx's
    ``DiGraph.add_edge``); ``None`` is an infinite capacity."""

    def __init__(self):
        self.index: dict = {}
        self.edges: dict[tuple[int, int], int | None] = {}

    def node(self, key) -> int:
        return self.index.setdefault(key, len(self.index))

    def add_edge(self, u, v, capacity: int | None) -> None:
        self.edges[(self.node(u), self.node(v))] = capacity

    def sink_side(self, source, sink) -> set | None:
        """The nodes that can still reach ``sink`` once a maximum flow from
        ``source`` runs (the sink side of the minimum cut networkx's
        ``minimum_cut`` returns); None when no path joins them."""
        if source not in self.index or sink not in self.index:
            return None
        n, s, t = len(self.index), self.index[source], self.index[sink]
        inf = sum(c for c in self.edges.values() if c is not None) + 1
        to: list[int] = []
        cap: list[int] = []
        adj: list[list[int]] = [[] for _ in range(n)]
        for (u, v), c in self.edges.items():
            adj[u].append(len(to))
            to.append(v)
            cap.append(inf if c is None else c)
            adj[v].append(len(to))
            to.append(u)
            cap.append(0)
        if not _levels(adj, to, cap, s, t):
            return None
        while True:
            level = _levels(adj, to, cap, s, t)
            if level is None:
                break
            _blocking_flow(adj, to, cap, level, s, t)
        reach = {t}
        todo = deque([t])
        while todo:
            v = todo.popleft()
            for e in adj[v]:
                w = to[e]
                if cap[e ^ 1] > 0 and w not in reach:
                    reach.add(w)
                    todo.append(w)
        names = {i: key for key, i in self.index.items()}
        return {names[i] for i in reach}


def _levels(adj, to, cap, s, t) -> list[int] | None:
    """BFS levels over edges with residual capacity; None when ``t`` is cut
    off from ``s``."""
    level = [-1] * len(adj)
    level[s] = 0
    todo = deque([s])
    while todo:
        u = todo.popleft()
        for e in adj[u]:
            if cap[e] > 0 and level[to[e]] < 0:
                level[to[e]] = level[u] + 1
                todo.append(to[e])
    return level if level[t] >= 0 else None


def _blocking_flow(adj, to, cap, level, s, t) -> None:
    """Dinic's blocking flow on the level graph, one augmenting path at a
    time by an explicit-stack search (traces are deeper than Python's
    recursion limit)."""
    it = [0] * len(adj)
    while True:
        path: list[int] = []
        u = s
        while u != t:
            while it[u] < len(adj[u]):
                e = adj[u][it[u]]
                if cap[e] > 0 and level[to[e]] == level[u] + 1:
                    break
                it[u] += 1
            else:
                if u == s:
                    return
                level[u] = -1            # a dead end: never enter it again
                e = path.pop()
                u = to[e ^ 1]
                it[u] += 1
                continue
            path.append(e)
            u = to[e]
        push = min(cap[e] for e in path)
        for e in path:
            cap[e] -= push
            cap[e ^ 1] += push


def find_cut(fwd: TraceCtx, required: list[Proxy]) -> set[str]:
    """Min-cut over the forward dataflow graph between the trace inputs
    (free sources: the parameters and inputs stay alive through the
    backward anyway) and the values the backward requires. Returns the names
    of the proxies to save; the backward recomputes everything else from
    them. Each proxy is split into an in and an out node joined by its
    save cost; dataflow edges are infinite, and so is an edge from the
    source into the output of an op the backward must not recompute."""
    with _observe.span("remat.find_cut"):
        return _find_cut_impl(fwd, required)


def _find_cut_impl(fwd: TraceCtx, required: list[Proxy]) -> set[str]:
    g = _FlowGraph()
    arg_names = {p.name for p in fwd.args if isinstance(p, Proxy)}
    produced: dict[str, BoundSymbol] = {}
    for bsym in fwd.bound_symbols:
        if bsym.sym.id not in _SKIP_IDS:
            for o in bsym.flat_proxy_outs():
                produced[o.name] = bsym

    def add_proxy(p: Proxy, free: bool = False):
        g.add_edge(("in", p.name), ("out", p.name), _capacity(p, free))

    for p in fwd.args:
        if isinstance(p, Proxy):
            add_proxy(p, free=True)
            g.add_edge("SRC", ("in", p.name), None)
    for bsym in fwd.bound_symbols:
        if bsym.sym.id in _SKIP_IDS:
            continue
        expensive = _is_expensive(bsym)
        for o in bsym.flat_proxy_outs():
            add_proxy(o)
            if expensive:
                g.add_edge("SRC", ("in", o.name), None)
            for a in bsym.flat_proxy_args():
                if a.name in produced or a.name in arg_names:
                    g.add_edge(("out", a.name), ("in", o.name), None)
    for r in required:
        if isinstance(r, Proxy) and (r.name in produced or r.name in arg_names):
            g.add_edge(("out", r.name), "SNK", None)

    sink_side = g.sink_side("SRC", "SNK")
    if sink_side is None:
        return {r.name for r in required if isinstance(r, Proxy)}
    names = {key[1] for key in g.index if isinstance(key, tuple)}
    return {n for n in names if ("in", n) not in sink_side and ("out", n) in sink_side}


def rematerialize_forward_and_backward(fwd: TraceCtx, bwd: TraceCtx) -> tuple[TraceCtx, TraceCtx]:
    """Jointly minimize the saved-for-backward bytes of a split pair
    (``forward_and_backward_from_trace``): run :func:`find_cut`, shrink the
    forward's saved list to the cut, and prepend to the backward the
    forward's bound symbols that recompute every other value it reads."""
    from thunder_tpu_torch.core.transform_common import dce

    with _observe.span("remat.forward_and_backward"):
        return _remat_fwd_bwd_impl(fwd, bwd, dce)


def _remat_fwd_bwd_impl(fwd: TraceCtx, bwd: TraceCtx, dce) -> tuple[TraceCtx, TraceCtx]:
    out, old_saved = fwd.output
    old_saved_names = {p.name for p in old_saved if isinstance(p, Proxy)}
    cotangents = [p for p in bwd.args if p.name not in old_saved_names]
    required = [p for p in bwd.args if p.name in old_saved_names]

    saved_names = find_cut(fwd, required)
    produced: dict[str, BoundSymbol] = {}
    name_to_proxy: dict[str, Proxy] = {p.name: p for p in fwd.args if isinstance(p, Proxy)}
    for bsym in fwd.bound_symbols:
        for o in bsym.flat_proxy_outs():
            name_to_proxy[o.name] = o
            if bsym.sym.id not in _SKIP_IDS:
                produced[o.name] = bsym

    new_saved = [name_to_proxy[n] for n in sorted(saved_names) if n in name_to_proxy]
    if _observe.is_enabled():
        old_bytes = sum(_save_cost(p) for p in old_saved if isinstance(p, Proxy))
        new_bytes = sum(_save_cost(p) for p in new_saved)
        _observe.set_gauge("remat.saved_bytes", new_bytes)
        _observe.event("remat", n_saved_before=len(old_saved), n_saved_after=len(new_saved),
                       saved_bytes_before=old_bytes, saved_bytes_after=new_bytes)

    # the recompute: the producers (in forward order) of every required
    # value not saved, transitively
    needed_bsyms: list[BoundSymbol] = []
    have = set(saved_names)
    visiting: set[str] = set()

    def resolve(name: str):
        if name in have or name in visiting:
            return
        visiting.add(name)
        bsym = produced.get(name)
        check(bsym is not None, lambda: f"remat: {name} has no producer and is not saved")
        for a in bsym.flat_proxy_args():
            if a.name not in have:
                resolve(a.name)
        if name not in have:
            needed_bsyms.append(bsym)
            for o in bsym.flat_proxy_outs():
                have.add(o.name)

    for r in required:
        resolve(r.name)

    new_fwd = from_trace(fwd)
    new_fwd.bound_symbols = [b for b in fwd.bound_symbols
                             if b.sym.id is not PrimIDs.PYTHON_RETURN]
    new_fwd.bound_symbols.append(prims.python_return.bind((out, tuple(new_saved)), output=None))
    new_fwd.output = (out, tuple(new_saved))
    new_fwd = dce(new_fwd)
    new_fwd.set_provenance("Augmented forward (rematerialized)")

    new_bwd = from_trace(bwd)
    new_bwd.args = list(new_saved) + list(cotangents)
    new_bwd.bound_symbols = [b.from_bsym() for b in needed_bsyms] + list(bwd.bound_symbols)
    new_bwd.output = bwd.output
    new_bwd.set_provenance("Backward (rematerialized)")
    return new_fwd, new_bwd
