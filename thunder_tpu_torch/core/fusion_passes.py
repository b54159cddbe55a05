"""The epilogue fusion pass: pattern rewrites into claimable composites.

The counterpart of the epilogue half of ``thunder_tpu/core/fusion_passes.py``
(``_some_executor_claims`` :305, ``_build_composite`` :328,
``_rms_residual_pattern`` :353, ``_linear_act_pattern`` :412,
``epilogue_fusion_pass`` :1447), run at the top of
``transform_for_execution`` before the claim pass:

- ``add(residual, x)`` followed by ``nn.rms_norm`` of the sum becomes
  ``nn.rms_norm_residual``, which produces both the residual stream and the
  normed value (the escaping-intermediate form of ``patterns.rewrite``);
- ``nn.linear`` followed by relu, silu or gelu becomes ``nn.linear_act``.

A match is rewritten only where an executor in the stack claims the fused
composite for those arguments, so a CPU trace keeps its ops as they are.
The reference's horizontal, block and optimizer passes and its cost model
are not ported yet (ROADMAP A.7).
"""

from __future__ import annotations

from thunder_tpu_torch.core.patterns import Pattern, rewrite
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, tracectx
from thunder_tpu_torch.observe import registry as _observe

EPILOGUE_MARKER = "epilogue fusion"


def _some_executor_claims(executors, op_id: str, args, kwargs) -> bool:
    """Would an executor in the stack claim the fused composite?"""
    for ex in executors:
        impl = ex.implmap.get(op_id)
        if impl is None or impl.symbol is None:
            continue
        try:
            if impl.checker is None or impl.checker(*args, **kwargs):
                return True
        except Exception:
            continue
    return False


def _build_composite(trc: TraceCtx, op, args, kwargs, old_outs) -> list[BoundSymbol] | None:
    """Trace ``op(*args, **kwargs)`` into fresh bsyms and rebind its outputs
    to ``old_outs`` (the proxies downstream consumers already reference)."""
    tmp = TraceCtx("epilogue_fusion")
    tmp._names = trc._names
    tmp._counters = trc._counters
    with tracectx(tmp):
        out = op(*args, **kwargs)
    new_flat = [o for o in tree_flatten(out)[0] if isinstance(o, Proxy)]
    if len(new_flat) != len(old_outs):
        return None
    for n, o in zip(new_flat, old_outs):
        if (getattr(n, "dtype", None) != getattr(o, "dtype", None)
                or tuple(getattr(n, "shape", ())) != tuple(getattr(o, "shape", ()))):
            return None
    swap = {Variable(n): o for n, o in zip(new_flat, old_outs) if n.name != o.name}
    return [b.from_bsym_swap_proxies(swap) for b in tmp.bound_symbols]


def _rms_residual_pattern(executors):
    def is_residual_add(b, env):
        if b.sym.id not in (PrimIDs.ADD, "ops.add") or len(b.args) != 2:
            return False
        r, x = b.args
        if not (isinstance(r, TensorProxy) and isinstance(x, TensorProxy)):
            return False
        if tuple(r.shape) != tuple(x.shape) or r.dtype != x.dtype:
            return False
        env["add_out"] = b.flat_proxy_outs()[0]
        return True

    def is_trailing_rms(b, env):
        if b.sym.id != "nn.rms_norm":
            return False
        a = b.args[0] if b.args else None
        if not isinstance(a, Proxy) or a.name != env["add_out"].name:
            return False
        dim = b.kwargs.get("dim", b.args[3] if len(b.args) > 3 else -1)
        return dim in (-1, a.ndim - 1)

    p = Pattern("rms_norm_residual").step(is_residual_add).step(is_trailing_rms)

    def build(trc, matched, env):
        from thunder_tpu_torch.ops import composites

        add_b, rms_b = matched
        res, x = add_b.args
        h = add_b.flat_proxy_outs()[0]
        normed = rms_b.flat_proxy_outs()[0]
        weight = rms_b.args[1] if len(rms_b.args) > 1 else rms_b.kwargs.get("weight")
        eps = rms_b.kwargs.get("eps", rms_b.args[2] if len(rms_b.args) > 2 else 1e-5)
        if not _some_executor_claims(executors, "nn.rms_norm_residual", (res, x, weight),
                                     {"eps": eps}):
            return None
        repl = _build_composite(trc, composites.rms_norm_residual, (res, x, weight),
                                {"eps": eps}, [h, normed])
        if repl:
            repl[-1].header = f"{EPILOGUE_MARKER}: residual add absorbed into rms_norm"
            _observe.inc("fusion.epilogue_fusions")
        return repl

    return p, build


_ACT_IDS = {"ops.relu": "relu", "ops.silu": "silu", "ops.gelu": "gelu"}


def _linear_act_pattern(executors):
    def is_linear(b, env):
        if b.sym.id != "nn.linear":
            return False
        env["lin_out"] = b.flat_proxy_outs()[0]
        return True

    def is_act(b, env):
        act = _ACT_IDS.get(b.sym.id)
        if act is None:
            return False
        a = b.args[0] if b.args else None
        if not isinstance(a, Proxy) or a.name != env["lin_out"].name:
            return False
        if act == "gelu":
            approx = b.kwargs.get("approximate", b.args[1] if len(b.args) > 1 else "none")
            act = "gelu_tanh" if approx == "tanh" else "gelu"
        env["act"] = act
        return True

    p = Pattern("linear_act").step(is_linear).step(is_act)

    def build(trc, matched, env):
        from thunder_tpu_torch.ops import composites

        lin_b, act_b = matched
        a, w = lin_b.args[0], lin_b.args[1]
        bias = lin_b.args[2] if len(lin_b.args) > 2 else lin_b.kwargs.get("bias")
        act = env["act"]
        if not _some_executor_claims(executors, "nn.linear_act", (a, w, bias), {"act": act}):
            return None
        repl = _build_composite(trc, composites.linear_act, (a, w, bias), {"act": act},
                                [act_b.flat_proxy_outs()[0]])
        if repl:
            repl[-1].header = f"{EPILOGUE_MARKER}: {act} epilogue fused into linear"
            _observe.inc("fusion.epilogue_fusions")
        return repl

    return p, build


def epilogue_fusion_pass(trc: TraceCtx, executors) -> TraceCtx:
    """Rewrite elementwise-epilogue chains into claimable fused composites."""
    ids = {b.sym.id for b in trc.bound_symbols}
    if "nn.rms_norm" in ids:
        p, build = _rms_residual_pattern(executors)
        trc = rewrite(trc, p, build, allow_escaping_intermediates=True)
    if "nn.linear" in ids and not ids.isdisjoint(_ACT_IDS):
        p, build = _linear_act_pattern(executors)
        trc = rewrite(trc, p, build)
    return trc
