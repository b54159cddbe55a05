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

The reference's min-cut (``find_cut``, ``rematerialize_forward_and_backward``)
goes with ``jit(nn.Module)`` (ROADMAP A.7).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
from typing import Any

import torch.utils.checkpoint

from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import Symbol
from thunder_tpu_torch.core.trace import get_tracectx

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
