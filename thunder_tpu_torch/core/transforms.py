"""Program transforms: trace replay and trace-level autograd (VJP).

The counterpart of ``thunder_tpu/core/transforms.py``: a closure-based rule
registry in which each differentiable prim registers a rule that emits its
primal output *and returns a pullback*; both directions are recorded as
ordinary trace operations, so a differentiated program is itself a
printable, executable trace. A composite without a registered rule is
differentiated through its decomposition (``augmented_forward`` replays its
subsymbols); a composite with one (``nn.rms_norm``, attention,
cross-entropy, a checkpointed region) keeps its claimable form.

:func:`inline_value_and_grad` differentiates a function inside the trace
being built, so a whole train step (forward, backward, optimizer) compiles
into one trace. :func:`forward_and_backward_from_trace` splits a traced
computation into an augmented forward and a backward program, the two
halves the torch-autograd bridge runs (``torch/autograd_bridge.py``); the
min-cut that shrinks what passes between them is
``core.rematerialization.rematerialize_forward_and_backward``. The
reference's forward mode and batching (``jvp_call``, ``vmap_call``) are not
ported yet (ROADMAP A.7.7).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.fusion_passes import plan_blocks_for_autodiff
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable
from thunder_tpu_torch.core.pytree import leaf_positions, tree_flatten, tree_map, tree_unflatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, get_tracectx, tracectx
from thunder_tpu_torch.core.utils import free_vars

_SKIP_IDS = (PrimIDs.PYTHON_RETURN, PrimIDs.COMMENT, PrimIDs.PYTHON_DEL)

# ---------------------------------------------------------------------------
# trace evaluation (replay)
# ---------------------------------------------------------------------------


def _env_map(env: dict, x):
    if isinstance(x, Proxy):
        v = Variable(x)
        return env[v] if v in env else x
    if isinstance(x, tuple):
        return tuple(_env_map(env, i) for i in x)
    if isinstance(x, list):
        return [_env_map(env, i) for i in x]
    if isinstance(x, dict):
        return {k: _env_map(env, v) for k, v in x.items()}
    return x


def _bind_outputs(env: dict, old_out, new_out):
    old_flat, _ = tree_flatten(old_out)
    new_flat, _ = tree_flatten(new_out)
    for o, n in zip(old_flat, new_flat):
        if isinstance(o, Proxy):
            env[Variable(o)] = n


def _reemit(bsym: BoundSymbol, env: dict) -> None:
    """Re-emit an impl-only symbol (a lifted constant) verbatim."""
    cur = get_tracectx()
    if cur is not None:
        cur.add_bound_symbol(bsym.from_bsym())
    for o in bsym.flat_proxy_outs():
        env.setdefault(Variable(o), o)


def eval_trace(trc: TraceCtx, *args):
    """Replay a trace's operations under the current trace context. Returns
    the trace's output."""
    env: dict = {}
    check(len(args) == len(trc.args),
          lambda: f"eval_trace: expected {len(trc.args)} args, got {len(args)}")
    for p, a in zip(trc.args, args):
        env[Variable(p)] = a
    result = None
    for bsym in trc.bound_symbols:
        if bsym.sym.id is PrimIDs.PYTHON_RETURN:
            result = _env_map(env, bsym.args[0]) if bsym.args else None
            break
        if bsym.sym.id in _SKIP_IDS:
            continue
        if bsym.sym.meta is None:
            _reemit(bsym, env)
            continue
        out = bsym.sym(*_env_map(env, bsym.args), **_env_map(env, bsym.kwargs))
        _bind_outputs(env, bsym.output, out)
    return result


# ---------------------------------------------------------------------------
# VJP rule registry
# ---------------------------------------------------------------------------

_vjp_rules: dict[Any, Callable] = {}

# prims that are not differentiable (gradients stop here)
_NONDIFF = {
    PrimIDs.EQ, PrimIDs.NE, PrimIDs.GE, PrimIDs.GT, PrimIDs.LE, PrimIDs.LT,
    PrimIDs.BITWISE_AND, PrimIDs.BITWISE_OR, PrimIDs.BITWISE_XOR, PrimIDs.BITWISE_NOT,
    PrimIDs.LOGICAL_NOT, PrimIDs.SIGN, PrimIDs.FLOOR, PrimIDs.CEIL, PrimIDs.ROUND,
    PrimIDs.TRUNC, PrimIDs.ISNAN, PrimIDs.ISINF, PrimIDs.ISFINITE, PrimIDs.ARGMAX,
    PrimIDs.ARGMIN, PrimIDs.IOTA, PrimIDs.FULL, PrimIDs.ITEM, PrimIDs.FMOD,
    PrimIDs.REMAINDER, PrimIDs.FLOOR_DIV, PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA,
    PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE, PrimIDs.CHECK_STRING_VALUE,
    PrimIDs.CHECK_LITERAL_LIKE, PrimIDs.COMMENT,
}


def register_vjp(op_id):
    def deco(rule):
        _vjp_rules[op_id] = rule
        return rule

    return deco


def has_vjp_rule(op_id) -> bool:
    return op_id in _vjp_rules


def _is_float_tensor(x) -> bool:
    return isinstance(x, TensorProxy) and x.dtype.is_inexact


# ---------------------------------------------------------------------------
# augmented forward + backward passes
# ---------------------------------------------------------------------------

class PullbackRecord:
    __slots__ = ("out", "pullback")

    def __init__(self, out, pullback):
        self.out = out
        self.pullback = pullback


def augmented_forward(bsyms: Sequence[BoundSymbol], env: dict) -> list[PullbackRecord]:
    """Replay ``bsyms`` under the current trace, collecting pullbacks.

    ``env`` maps the original trace's proxies (by Variable) to replayed
    values; it is updated in place."""
    records: list[PullbackRecord] = []
    for bsym in bsyms:
        sym_id = bsym.sym.id
        if sym_id in _SKIP_IDS:
            continue
        if bsym.sym.meta is None:
            _reemit(bsym, env)
            continue
        margs = _env_map(env, bsym.args)
        mkwargs = _env_map(env, bsym.kwargs)
        rule = _vjp_rules.get(sym_id)
        res = rule(*margs, **mkwargs) if rule is not None else None
        if res is NotImplemented:   # the rule declines these arguments
            res = None
        if res is not None:
            out, pullback = res
            records.append(PullbackRecord(out, pullback))
            _bind_outputs(env, bsym.output, out)
        elif bsym.subsymbols:
            records.extend(augmented_forward(bsym.subsymbols, env))
            # a composite's outputs are its subsymbols' outputs
            for o in tree_flatten(bsym.output)[0]:
                if isinstance(o, Proxy) and Variable(o) not in env:
                    env[Variable(o)] = o
        else:
            # an alias composite (eval-mode or p=0 dropout): every output is
            # an input, so gradients flow through the shared value
            arg_vars = {Variable(a) for a in bsym.flat_proxy_args()}
            out_proxies = bsym.flat_proxy_outs()
            if out_proxies and all(Variable(o) in arg_vars for o in out_proxies):
                _bind_outputs(env, bsym.output, _env_map(env, bsym.output))
                continue
            if sym_id not in _NONDIFF and any(_is_float_tensor(o) for o in out_proxies) \
                    and any(_is_float_tensor(a) for a in bsym.flat_proxy_args()):
                raise NotImplementedError(f"no VJP rule for prim {bsym.sym.name} (id={sym_id})")
            out = bsym.sym(*margs, **mkwargs)
            _bind_outputs(env, bsym.output, out)
    return records


def backward_pass(records: list[PullbackRecord], grads: dict[Variable, Any]) -> dict:
    """Walk the pullbacks in reverse, accumulating cotangents keyed by
    Variable. A gradient takes its primal's dtype (torch's convention)."""
    from thunder_tpu_torch import ops

    def put_grad(p, g):
        if g is None or not isinstance(p, TensorProxy) or not p.dtype.is_inexact:
            return
        if isinstance(g, TensorProxy) and g.dtype != p.dtype:
            g = ops.convert_element_type(g, p.dtype)
        v = Variable(p)
        grads[v] = ops.add(grads[v], g) if v in grads else g

    for rec in reversed(records):
        out_flat = [o for o in tree_flatten(rec.out)[0] if isinstance(o, Proxy)]
        gs = [grads.get(Variable(o)) for o in out_flat]
        if all(g is None for g in gs):
            continue
        pairs = rec.pullback(gs[0] if len(gs) == 1 else tuple(gs))
        if pairs is None:
            continue
        for p, g in pairs:
            put_grad(p, g)
    return grads


# ---------------------------------------------------------------------------
# sub-traces and value_and_grad
# ---------------------------------------------------------------------------

def _trace_subfn(fn, args, kwargs, grad_leaves: Sequence[int] = ()) -> tuple:
    """Trace ``fn`` into a detached TraceCtx with fresh input proxies that
    mirror the (possibly proxy) arguments. ``grad_leaves`` are the flat
    positions of ``(args, kwargs)`` whose proxies need a gradient (the
    differentiated inputs); an input mirroring a value that needs one in
    the enclosing trace needs one too. Returns ``(trace, input_proxies,
    out)``."""
    inner = TraceCtx("subfn")
    outer = get_tracectx()
    if outer is not None:
        # share the name registry so replayed proxies do not collide
        inner._names = outer._names
        inner._counters = outer._counters
    outer_grad = outer.grad_names if outer is not None and outer.grad_names else set()
    grad_leaves = set(grad_leaves)
    names: set[str] = set()
    with tracectx(inner):
        flat, treedef = tree_flatten((args, kwargs))
        proxies = []
        for i, leaf in enumerate(flat):
            if isinstance(leaf, TensorProxy):
                check(getattr(leaf, "distparallel_type", None) is None,
                      "a distributed (sharded or replicated) proxy in a differentiated "
                      "region: the distributed transforms are not ported yet (ROADMAP A.2)",
                      NotImplementedError)
                p = TensorProxy(shape=leaf.shape, dtype=leaf.dtype, device=leaf.device)
                if p.dtype.is_inexact and (i in grad_leaves or leaf.name in outer_grad):
                    names.add(p.name)
                proxies.append(p)
            else:
                proxies.append(leaf)
        inner.grad_names = names
        pargs, pkwargs = tree_unflatten(treedef, proxies)
        out = fn(*pargs, **pkwargs)
        prims.python_return(out)
    inner.grad_names = None
    inner.output = out
    inner.args = [p for p in proxies if isinstance(p, Proxy)]
    return inner, list(inner.args), out


def promote_free_vars(inner: TraceCtx, inner_inputs) -> list:
    """Promote the enclosing trace's proxies a sub-trace closes over to
    explicit inputs (appended to ``inner.args``), so dataflow analyses see
    them. Returns them in order: callers pass them as extra symbol args."""
    input_set = {Variable(p) for p in inner_inputs}
    frees = [v.proxy for v in free_vars(inner.bound_symbols) if v not in input_set]
    inner.args = list(inner_inputs) + frees
    return frees


def inline_value_and_grad(fn, argnums=0, has_aux: bool = False):
    """Differentiate ``fn`` inline in the trace being built (under ``jit``).

    Returns a callable ``(*args) -> (value, grads)`` where ``grads`` has the
    structure of ``args[argnums]`` (a tuple of such when ``argnums`` is a
    tuple). The loss must be a scalar float tensor."""
    argnums_t = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    def transformed(*args, **kwargs):
        from thunder_tpu_torch import ops

        check(get_tracectx() is not None,
              "value_and_grad must run under tracing (wrap with thunder_tpu_torch.jit)")
        inner, inner_inputs, _ = _trace_subfn(fn, args, kwargs,
                                              leaf_positions(args, argnums_t))
        # the block planner before the pullback replay: a planned sub-block
        # meets its VJP rule and stays claimable in both directions
        inner = plan_blocks_for_autodiff(inner)
        env: dict = {}
        j = 0
        for leaf in tree_flatten((args, kwargs))[0]:
            if isinstance(leaf, Proxy):
                env[Variable(inner_inputs[j])] = leaf
                j += 1
        check(j == len(inner_inputs), "value_and_grad: argument flattening mismatch")
        records = augmented_forward(inner.bound_symbols, env)
        out = _env_map(env, inner.output)
        if has_aux:
            check(isinstance(out, tuple) and len(out) == 2,
                  "has_aux=True requires fn to return (loss, aux)")
            loss, aux = out
        else:
            loss = out
        check(isinstance(loss, TensorProxy) and loss.numel == 1 and loss.dtype.is_inexact,
              lambda: f"grad requires a scalar float loss, got {loss}")
        grads: dict[Variable, Any] = {Variable(loss): ops.ones_like(loss)}
        prims.comment("backward pass begins")
        backward_pass(records, grads)
        prims.comment("backward pass ends")

        def grad_of(x):
            if isinstance(x, TensorProxy):
                g = grads.get(Variable(x))
                return g if g is not None else ops.zeros_like(x)
            return None

        grad_results = tuple(tree_map(grad_of, args[i]) for i in argnums_t)
        gout = grad_results[0] if isinstance(argnums, int) else grad_results
        return ((loss, aux), gout) if has_aux else (loss, gout)

    return transformed


def forward_and_backward_from_trace(trc: TraceCtx, needs_grad: Sequence[bool] | None = None
                                    ) -> tuple[TraceCtx, TraceCtx, list]:
    """Split a computation trace into an augmented forward trace returning
    ``(outputs, saved_for_backward)`` and a backward trace
    ``(saved_for_backward..., cotangents...) -> grads``, one gradient (or
    None) per input of ``trc``. There is one cotangent per float tensor
    leaf of the outputs, in flatten order; a proxy that fills several output
    slots accumulates their cotangents. ``needs_grad`` (one flag per input
    of ``trc``) leaves out the gradients nobody takes: the backward returns
    None for those inputs, computes none of their work, and the forward
    saves only what the rest reads."""
    from thunder_tpu_torch import ops
    from thunder_tpu_torch.core.transform_common import dce

    trc = plan_blocks_for_autodiff(trc)
    fwd = from_trace(trc)
    fwd.fn_name = "augmented_forward"
    env: dict = {Variable(p): p for p in trc.args}
    with tracectx(fwd):
        records = augmented_forward(trc.bound_symbols, env)
        out = _env_map(env, trc.output)
    out_flat = [o for o in tree_flatten(out)[0] if _is_float_tensor(o)]

    bwd = TraceCtx("backward")
    bwd._names = set(fwd._names)
    bwd._counters = dict(fwd._counters)
    with tracectx(bwd):
        cotangents = [TensorProxy(f"ct{i}", shape=o.shape, dtype=o.dtype, device=o.device)
                      for i, o in enumerate(out_flat)]
        grads: dict[Variable, Any] = {}
        for o, ct in zip(out_flat, cotangents):
            v = Variable(o)
            grads[v] = ops.add(grads[v], ct) if v in grads else ct
        backward_pass(records, grads)
        wanted = needs_grad if needs_grad is not None else [True] * len(trc.args)
        input_grads = tuple(grads.get(Variable(p)) if isinstance(p, TensorProxy) and want
                            else None for p, want in zip(trc.args, wanted, strict=True))
        prims.python_return(input_grads)
    bwd.output = input_grads
    if needs_grad is not None:
        bwd = dce(bwd)

    # saved for the backward: what it reads and does not make, cotangents aside
    ct_names = {c.name for c in cotangents}
    saved = [v.proxy for v in free_vars(bwd.bound_symbols) if v.proxy.name not in ct_names]
    bwd.args = list(saved) + list(cotangents)
    with tracectx(fwd):
        prims.python_return((out, tuple(saved)))
    fwd.output = (out, tuple(saved))
    fwd.set_provenance("Augmented forward pass")
    bwd.set_provenance("Backward pass")
    return fwd, bwd, saved


# ---------------------------------------------------------------------------
# VJP rules for prims (the reference's formulas)
# ---------------------------------------------------------------------------

def _O():
    from thunder_tpu_torch import ops

    return ops


def _pairs(*pairs):
    return [(p, g) for p, g in pairs if isinstance(p, TensorProxy)]


def _register_unary(pid, prim, dfn):
    """``dfn(g, a, out) -> grad_a``"""

    def rule(a):
        out = prim(a)
        return out, lambda g: _pairs((a, dfn(g, a, out)))

    _vjp_rules[pid] = rule


_SQRT_PI = 2.0 / math.sqrt(math.pi)

_register_unary(PrimIDs.NEG, prims.neg, lambda g, a, o: _O().neg(g))
_register_unary(PrimIDs.ABS, prims.abs, lambda g, a, o: _O().mul(g, _O().sign(a)))
_register_unary(PrimIDs.EXP, prims.exp, lambda g, a, o: _O().mul(g, o))
_register_unary(PrimIDs.EXP2, prims.exp2,
                lambda g, a, o: _O().mul(_O().mul(g, o), math.log(2.0)))
_register_unary(PrimIDs.EXPM1, prims.expm1, lambda g, a, o: _O().mul(g, _O().add(o, 1.0)))
_register_unary(PrimIDs.LOG, prims.log, lambda g, a, o: _O().true_divide(g, a))
_register_unary(PrimIDs.LOG1P, prims.log1p,
                lambda g, a, o: _O().true_divide(g, _O().add(a, 1.0)))
_register_unary(PrimIDs.LOG2, prims.log2,
                lambda g, a, o: _O().true_divide(g, _O().mul(a, math.log(2.0))))
_register_unary(PrimIDs.LOG10, prims.log10,
                lambda g, a, o: _O().true_divide(g, _O().mul(a, math.log(10.0))))
_register_unary(PrimIDs.SQRT, prims.sqrt,
                lambda g, a, o: _O().true_divide(g, _O().mul(2.0, o)))
_register_unary(PrimIDs.RSQRT, prims.rsqrt,
                lambda g, a, o: _O().mul(_O().mul(-0.5, g), _O().mul(o, _O().mul(o, o))))
_register_unary(PrimIDs.SIN, prims.sin, lambda g, a, o: _O().mul(g, _O().cos(a)))
_register_unary(PrimIDs.COS, prims.cos, lambda g, a, o: _O().neg(_O().mul(g, _O().sin(a))))
_register_unary(PrimIDs.TAN, prims.tan,
                lambda g, a, o: _O().mul(g, _O().add(1.0, _O().mul(o, o))))
_register_unary(PrimIDs.TANH, prims.tanh,
                lambda g, a, o: _O().mul(g, _O().sub(1.0, _O().mul(o, o))))
_register_unary(PrimIDs.SINH, prims.sinh, lambda g, a, o: _O().mul(g, _O().cosh(a)))
_register_unary(PrimIDs.COSH, prims.cosh, lambda g, a, o: _O().mul(g, _O().sinh(a)))
_register_unary(PrimIDs.ASIN, prims.asin,
                lambda g, a, o: _O().true_divide(g, _O().sqrt(_O().sub(1.0, _O().mul(a, a)))))
_register_unary(PrimIDs.ACOS, prims.acos,
                lambda g, a, o: _O().neg(_O().true_divide(
                    g, _O().sqrt(_O().sub(1.0, _O().mul(a, a))))))
_register_unary(PrimIDs.ATAN, prims.atan,
                lambda g, a, o: _O().true_divide(g, _O().add(1.0, _O().mul(a, a))))
_register_unary(PrimIDs.ERF, prims.erf,
                lambda g, a, o: _O().mul(g, _O().mul(_SQRT_PI,
                                                     _O().exp(_O().neg(_O().mul(a, a))))))
_register_unary(PrimIDs.ERFC, prims.erfc,
                lambda g, a, o: _O().neg(_O().mul(g, _O().mul(
                    _SQRT_PI, _O().exp(_O().neg(_O().mul(a, a)))))))
_register_unary(PrimIDs.RECIPROCAL, prims.reciprocal,
                lambda g, a, o: _O().neg(_O().mul(g, _O().mul(o, o))))


@register_vjp(PrimIDs.DYNAMIC_SLICE)
def _dynamic_slice_vjp(a, start_indices, slice_sizes):
    out = prims.dynamic_slice(a, start_indices, slice_sizes)

    def pullback(g):
        return _pairs((a, prims.dynamic_update_slice(_O().zeros_like(a), g, start_indices)))

    return out, pullback


@register_vjp(PrimIDs.DYNAMIC_UPDATE_SLICE)
def _dynamic_update_slice_vjp(a, update, start_indices):
    out = prims.dynamic_update_slice(a, update, start_indices)

    def pullback(g):
        gu = prims.dynamic_slice(g, start_indices, tuple(update.shape))
        ga = prims.dynamic_update_slice(g, _O().zeros_like(update), start_indices)
        return _pairs((a, ga), (update, gu))

    return out, pullback


@register_vjp(PrimIDs.CUMSUM)
def _cumsum_vjp(a, dim):
    out = prims.cumsum(a, dim)

    def pullback(g):
        ops = _O()
        return _pairs((a, ops.flip(ops.cumsum(ops.flip(g, dim), dim), dim)))

    return out, pullback


@register_vjp(PrimIDs.ADD)
def _add_vjp(a, b):
    out = prims.add(a, b)
    return out, lambda g: _pairs((a, g), (b, g))


@register_vjp(PrimIDs.SUB)
def _sub_vjp(a, b):
    out = prims.sub(a, b)
    return out, lambda g: _pairs((a, g), (b, _O().neg(g)))


@register_vjp(PrimIDs.MUL)
def _mul_vjp(a, b):
    out = prims.mul(a, b)
    return out, lambda g: _pairs((a, _O().mul(g, b)), (b, _O().mul(g, a)))


@register_vjp(PrimIDs.DIV)
def _div_vjp(a, b):
    out = prims.div(a, b)

    def pullback(g):
        ops = _O()
        ga = ops.true_divide(g, b)
        gb = ops.neg(ops.true_divide(ops.mul(g, out), b))
        return _pairs((a, ga), (b, gb))

    return out, pullback


@register_vjp(PrimIDs.POW)
def _pow_vjp(a, b):
    out = prims.pow(a, b)

    def pullback(g):
        ops = _O()
        ga = (ops.mul(g, ops.mul(b, ops.pow(a, ops.sub(b, 1.0))))
              if isinstance(a, TensorProxy) else None)
        gb = None
        if isinstance(b, TensorProxy):
            if isinstance(a, TensorProxy):
                loga = ops.where(ops.gt(a, 0.0), ops.log(ops.maximum(a, 1e-45)),
                                 ops.zeros_like(a))
            else:
                loga = math.log(a) if a > 0 else 0.0
            gb = ops.mul(g, ops.mul(out, loga))
        return _pairs((a, ga), (b, gb))

    return out, pullback


def _minmax_vjp(prim, a_wins, b_wins):
    def rule(a, b):
        out = prim(a, b)

        def pullback(g):
            ops = _O()
            mask = a_wins(a, b) if isinstance(a, TensorProxy) else b_wins(b, a)
            maskf = ops.convert_element_type(mask, g.dtype)
            return _pairs((a, ops.mul(g, maskf)), (b, ops.mul(g, ops.sub(1.0, maskf))))

        return out, pullback

    return rule


_vjp_rules[PrimIDs.MAXIMUM] = _minmax_vjp(prims.maximum, lambda a, b: _O().ge(a, b),
                                          lambda b, a: _O().le(b, a))
_vjp_rules[PrimIDs.MINIMUM] = _minmax_vjp(prims.minimum, lambda a, b: _O().le(a, b),
                                          lambda b, a: _O().ge(b, a))


@register_vjp(PrimIDs.ATAN2)
def _atan2_vjp(a, b):
    out = prims.atan2(a, b)

    def pullback(g):
        ops = _O()
        denom = ops.add(ops.mul(a, a), ops.mul(b, b))
        return _pairs((a, ops.true_divide(ops.mul(g, b), denom)),
                      (b, ops.neg(ops.true_divide(ops.mul(g, a), denom))))

    return out, pullback


@register_vjp(PrimIDs.WHERE)
def _where_vjp(pred, a, b):
    out = prims.where(pred, a, b)

    def pullback(g):
        ops = _O()
        ga = ops.where(pred, g, ops.zeros_like(g)) if isinstance(a, TensorProxy) else None
        gb = ops.where(pred, ops.zeros_like(g), g) if isinstance(b, TensorProxy) else None
        return _pairs((a, ga), (b, gb))

    return out, pullback


@register_vjp(PrimIDs.CONVERT_ELEMENT_TYPE)
def _convert_vjp(a, dtype):
    out = prims.convert_element_type(a, dtype)

    def pullback(g):
        if isinstance(a, TensorProxy) and a.dtype.is_inexact:
            return _pairs((a, _O().convert_element_type(g, a.dtype)))
        return None

    return out, pullback


@register_vjp(PrimIDs.DETACH)
def _detach_vjp(a):
    return prims.detach(a), lambda g: None


@register_vjp(PrimIDs.BROADCAST_IN_DIM)
def _broadcast_in_dim_vjp(a, shape, broadcast_dimensions):
    out = prims.broadcast_in_dim(a, shape, broadcast_dimensions)
    bdims = tuple(broadcast_dimensions)

    def pullback(g):
        reduce_dims = [d for d in range(len(shape)) if d not in bdims]
        for i, d in enumerate(bdims):
            if a.shape[i] == 1 and shape[d] != 1:
                reduce_dims.append(d)
        ga = prims.sum(g, tuple(sorted(reduce_dims))) if reduce_dims else g
        return _pairs((a, _O().reshape(ga, a.shape)))

    return out, pullback


@register_vjp(PrimIDs.RESHAPE)
def _reshape_vjp(a, shape):
    out = prims.reshape(a, shape)
    return out, lambda g: _pairs((a, _O().reshape(g, a.shape)))


@register_vjp(PrimIDs.SQUEEZE)
def _squeeze_vjp(a, dims):
    out = prims.squeeze(a, dims)
    return out, lambda g: _pairs((a, _O().reshape(g, a.shape)))


@register_vjp(PrimIDs.TRANSPOSE)
def _transpose_vjp(a, permutation):
    out = prims.transpose(a, permutation)
    perm = tuple(permutation)

    def pullback(g):
        inv = [0] * len(perm)
        for i, p in enumerate(perm):
            inv[p] = i
        return _pairs((a, prims.transpose(g, tuple(inv))))

    return out, pullback


@register_vjp(PrimIDs.SLICE)
def _slice_vjp(a, start_indices, end_indices, strides=None):
    out = prims.slice_prim(a, start_indices, end_indices, strides)
    st = tuple(strides) if strides is not None else (1,) * a.ndim

    def pullback(g):
        cfg = []
        for d, (s, stride) in enumerate(zip(start_indices, st)):
            osz = out.shape[d]
            covered = s + (osz - 1) * stride + 1 if osz > 0 else s
            cfg.append((s, a.shape[d] - covered, stride - 1))
        return _pairs((a, prims.pad(g, 0.0, tuple(cfg))))

    return out, pullback


@register_vjp(PrimIDs.PAD)
def _pad_vjp(a, padding_value, padding_config):
    out = prims.pad(a, padding_value, padding_config)

    def pullback(g):
        starts, ends, strides = [], [], []
        for (lo, hi, interior), s in zip(padding_config, a.shape):
            starts.append(lo)
            ends.append(lo + s + max(0, s - 1) * interior)
            strides.append(interior + 1)
        return _pairs((a, prims.slice_prim(g, starts, ends, strides)))

    return out, pullback


@register_vjp(PrimIDs.CAT)
def _cat_vjp(tensors, dim):
    out = prims.cat(tensors, dim)

    def pullback(g):
        pairs, off = [], 0
        for t in tensors:
            starts = [0] * t.ndim
            ends = list(g.shape)
            starts[dim], ends[dim] = off, off + t.shape[dim]
            pairs.append((t, prims.slice_prim(g, starts, ends)))
            off += t.shape[dim]
        return _pairs(*pairs)

    return out, pullback


@register_vjp(PrimIDs.FLIP)
def _flip_vjp(a, dims):
    out = prims.flip(a, dims)
    return out, lambda g: _pairs((a, prims.flip(g, dims)))


def _keep_shape(a, dims_t):
    return tuple(1 if i in dims_t else s for i, s in enumerate(a.shape))


@register_vjp(PrimIDs.SUM)
def _sum_vjp(a, dims):
    out = prims.sum(a, dims)
    dims_t = tuple(dims)

    def pullback(g):
        ops = _O()
        return _pairs((a, ops.expand_to(ops.reshape(g, _keep_shape(a, dims_t)), a.shape)))

    return out, pullback


@register_vjp(PrimIDs.PROD)
def _prod_vjp(a, dims):
    out = prims.prod(a, dims)
    dims_t = tuple(dims)

    def pullback(g):
        ops = _O()
        keep = _keep_shape(a, dims_t)
        gb = ops.expand_to(ops.reshape(g, keep), a.shape)
        ob = ops.expand_to(ops.reshape(out, keep), a.shape)
        return _pairs((a, ops.true_divide(ops.mul(gb, ob), a)))

    return out, pullback


def _minmax_reduction_vjp(prim):
    def rule(a, dims):
        out = prim(a, dims)
        dims_t = tuple(dims)

        def pullback(g):
            ops = _O()
            keep = _keep_shape(a, dims_t)
            ob = ops.expand_to(ops.reshape(out, keep), a.shape)
            gb = ops.expand_to(ops.reshape(g, keep), a.shape)
            mask = ops.convert_element_type(ops.eq(a, ob), g.dtype)
            counts = ops.expand_to(ops.reshape(prims.sum(mask, dims_t), keep), a.shape)
            return _pairs((a, ops.true_divide(ops.mul(gb, mask), counts)))

        return out, pullback

    return rule


_vjp_rules[PrimIDs.AMAX] = _minmax_reduction_vjp(prims.amax)
_vjp_rules[PrimIDs.AMIN] = _minmax_reduction_vjp(prims.amin)


@register_vjp(PrimIDs.TAKE)
def _take_vjp(a, indices, dim):
    out = prims.take(a, indices, dim)

    def pullback(g):
        ops = _O()
        n = indices.numel if isinstance(indices, TensorProxy) else 1
        g2 = ops.reshape(g, a.shape[:dim] + (n,) + a.shape[dim + 1:])
        idx_flat = ops.reshape(indices, (n,))
        # row-wise scatter (one index per slice): the embedding gradient
        return _pairs((a, prims.index_add(ops.zeros_like(a), idx_flat, g2, dim)))

    return out, pullback


@register_vjp(PrimIDs.TAKE_ALONG_AXIS)
def _take_along_axis_vjp(a, indices, dim):
    out = prims.take_along_axis(a, indices, dim)
    return out, lambda g: _pairs((a, prims.scatter_add(_O().zeros_like(a), indices, g, dim)))


@register_vjp(PrimIDs.INDEX_ADD)
def _index_add_vjp(a, indices, value, dim):
    out = prims.index_add(a, indices, value, dim)
    return out, lambda g: _pairs((a, g), (value, prims.take(g, indices, dim)))


@register_vjp(PrimIDs.SCATTER_ADD)
def _scatter_add_vjp(a, indices, value, dim):
    out = prims.scatter_add(a, indices, value, dim)
    return out, lambda g: _pairs((a, g), (value, prims.take_along_axis(g, indices, dim)))


@register_vjp(PrimIDs.INDEX_PUT)
def _index_put_vjp(a, indices, values, accumulate):
    out = prims.index_put(a, indices, values, accumulate)

    def pullback(g):
        from thunder_tpu_torch.core import dtypes as _dt

        ops = _O()
        # k-tensor advanced indexing over the k leading dims: linearize the
        # jointly broadcast indices over their row-major strides, then the
        # gradient's gather and zero-scatter are the 1-D case on the
        # flattened view
        k = len(indices)
        lead = tuple(int(s) for s in a.shape[:k])
        tail = tuple(int(s) for s in a.shape[k:])
        L = math.prod(lead)
        bshape = ()
        for t in indices:
            bshape = ops.compute_broadcast_shape(bshape, tuple(getattr(t, "shape", ())))
        N = math.prod(bshape)
        linear = ops.linearize_indices(indices, list(lead), bshape)
        if isinstance(linear, TensorProxy):
            lin_flat = ops.reshape(linear, (N,))
        else:
            lin_flat = ops.full((N,), int(linear), dtype=_dt.int32, device=a.device)
        g_flat = ops.reshape(g, (L,) + tail) if k > 1 else g
        g_sel = prims.take(g_flat, lin_flat, 0)
        if accumulate:
            g_a = g
        else:
            # replace semantics: with duplicate indices only the winning
            # write reaches the output; zero the grads of overwritten rows
            ids = prims.iota(N, dtype=_dt.int32, device=a.device)
            writer = prims.index_put(ops.full((L,), -1, dtype=_dt.int32, device=a.device),
                                     (lin_flat,), ids, False)
            win = ops.eq(prims.take(writer, lin_flat, 0), ids)
            g_sel = ops.where(ops.reshape(win, (N,) + (1,) * (g_sel.ndim - 1)),
                              g_sel, ops.zeros_like(g_sel))
            g_a = prims.index_put(g_flat, (lin_flat,), ops.zeros_like(g_sel), False)
            g_a = ops.reshape(g_a, tuple(int(s) for s in a.shape)) if k > 1 else g_a
        g_sel = ops.reshape(g_sel, bshape + tail)
        if not isinstance(values, TensorProxy):
            return _pairs((a, g_a))
        # values may have broadcast against the indexed slice: sum to shape
        if tuple(g_sel.shape) != tuple(values.shape):
            extra = g_sel.ndim - values.ndim
            if extra:
                g_sel = ops.sum(g_sel, dim=tuple(range(extra)))
            reduce_dims = tuple(i for i, (gs, vs) in enumerate(zip(g_sel.shape, values.shape))
                                if gs != vs)
            if reduce_dims:
                g_sel = ops.sum(g_sel, dim=reduce_dims, keepdim=True)
        return _pairs((a, g_a), (values, g_sel))

    return out, pullback


@register_vjp(PrimIDs.DOT_GENERAL)
def _dot_general_vjp(a, b, *, contract_dims, batch_dims=((), ()), preferred_element_type=None):
    out = prims.dot_general(a, b, contract_dims=contract_dims, batch_dims=batch_dims,
                            preferred_element_type=preferred_element_type)
    (ac, bc), (ab, bb) = contract_dims, batch_dims
    ac, bc, ab, bb = tuple(ac), tuple(bc), tuple(ab), tuple(bb)
    a_free = [d for d in range(a.ndim) if d not in ac and d not in ab]
    b_free = [d for d in range(b.ndim) if d not in bc and d not in bb]
    nb = len(ab)

    def pullback(g):
        ops = _O()
        # grad_a: contract g's b_free dims with b's free dims
        g_bfree_pos = tuple(range(nb + len(a_free), nb + len(a_free) + len(b_free)))
        ga_t = prims.dot_general(g, b, contract_dims=(g_bfree_pos, tuple(b_free)),
                                 batch_dims=(tuple(range(nb)), bb))
        # ga_t dims: [batch (ab order), a_free, b's contract dims ~ a's]
        src = [0] * a.ndim
        for i, d in enumerate(ab):
            src[d] = i
        for j, d in enumerate(a_free):
            src[d] = nb + j
        for idx, bd in enumerate(sorted(bc)):
            src[ac[bc.index(bd)]] = nb + len(a_free) + idx
        ga = prims.transpose(ga_t, tuple(src)) if tuple(src) != tuple(range(a.ndim)) else ga_t
        if ga.dtype is not a.dtype:
            ga = ops.convert_element_type(ga, a.dtype)
        # grad_b: contract g's a_free dims with a's free dims
        g_afree_pos = tuple(range(nb, nb + len(a_free)))
        gb_t = prims.dot_general(g, a, contract_dims=(g_afree_pos, tuple(a_free)),
                                 batch_dims=(tuple(range(nb)), ab))
        srcb = [0] * b.ndim
        for i, d in enumerate(bb):
            srcb[d] = i
        for j, d in enumerate(b_free):
            srcb[d] = nb + j
        for idx, ad in enumerate(sorted(ac)):
            srcb[bc[ac.index(ad)]] = nb + len(b_free) + idx
        gb = prims.transpose(gb_t, tuple(srcb)) if tuple(srcb) != tuple(range(b.ndim)) else gb_t
        if gb.dtype is not b.dtype:
            gb = ops.convert_element_type(gb, b.dtype)
        return _pairs((a, ga), (b, gb))

    return out, pullback


@register_vjp(PrimIDs.OPT_BARRIER)
def _opt_barrier_vjp(*args):
    out = prims.opt_barrier(*args)

    def pullback(g):
        gs = list(g) if isinstance(g, (tuple, list)) else [g]
        return list(zip(args, gs))   # identity, one to one with the operands

    return out, pullback
