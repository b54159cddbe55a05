"""Trace -> executable-trace passes: the epilogue pass, executor claiming,
``del`` insertion.

The counterpart of ``thunder_tpu/executors/passes.py`` (``claim_bsym``
:48, ``transform_for_execution`` :150, ``del_last_used`` :252). Each bound
symbol is offered to the executors in priority order; an executor
substitutes its own symbol, whose runtime callable the generated program
calls; an unclaimed composite is decomposed and its subsymbols offered
again; an unclaimed prim runs on the always-on torch executor.

Only the epilogue pass runs before the claim pass: the reference's block,
horizontal and optimizer passes, its region annotations and its fusion
executors are not ported yet (ROADMAP A.7). No fallback on the card: a
claim the quarantine routes off is still claimed, and its router raises a
fatal ``KernelExecutionError`` when it runs on the card; a claim whose
kernel refuses the arguments (``cudaex.refusal``) raises that reason here,
at compile time, instead of decomposing.
"""

from __future__ import annotations

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace
from thunder_tpu_torch.core.transform_common import dce
from thunder_tpu_torch.core.utils import consumed_vars
from thunder_tpu_torch.observe import registry as _observe

_PASSTHROUGH_IDS = (PrimIDs.PYTHON_RETURN, PrimIDs.PYTHON_DEL)


def claim_bsym(bsym: BoundSymbol, executors) -> list[BoundSymbol]:
    if bsym.sym.id in _PASSTHROUGH_IDS or bsym.sym.executor is not None:
        return [bsym]
    for ex in executors:
        impl = ex.get_impl(bsym)
        if impl is None or impl.symbol is None or not ex.can_execute(bsym):
            continue
        reason = impl.refusal(*bsym.args, **bsym.kwargs) if impl.refusal is not None else None
        check(reason is None,
              lambda: f"{impl.symbol.id}: the kernel refuses the arguments of {bsym.sym.name} "
                      f"({reason}); the port runs no decomposition on the card in its place",
              ValueError)
        claimed = impl.symbol.bind(*bsym.args, output=bsym.output, subsymbols=bsym.subsymbols,
                                   **bsym.kwargs)
        claimed.header = bsym.header
        return [claimed]
    from thunder_tpu_torch.executors.eagertorch import get_eager_impl

    if bsym.sym.is_prim:
        check(get_eager_impl(bsym.sym) is not None or bsym.sym.python_impl is not None,
              lambda: f"no executor can run prim {bsym.sym.name}")
        return [bsym]
    if not bsym.subsymbols:
        # identity composite (eval-mode dropout returns its input)
        arg_names = {p.name for p in bsym.flat_proxy_args()}
        outs = bsym.flat_proxy_outs()
        if outs and all(p.name in arg_names for p in outs):
            return []
    check(bsym.subsymbols, lambda: f"unclaimed symbol {bsym.sym.name} has no decomposition")
    out: list[BoundSymbol] = []
    for sub in bsym.subsymbols:
        out.extend(claim_bsym(sub, executors))
    return out


def transform_for_execution(trc: TraceCtx, executors) -> TraceCtx:
    """The epilogue pass, the claim pass, then DCE. A trace whose inputs lie
    on the card needs the ``cuda`` executor in its stack: without it every
    composite would decompose there in place of its kernel."""
    from thunder_tpu_torch.core.fusion_passes import epilogue_fusion_pass

    on_card = [a.name for a in trc.args
               if isinstance(a, TensorProxy) and a.device.type == "cuda"]
    check(not on_card or any(ex.name == "cuda" for ex in executors),
          lambda: f"the executor stack {[ex.name for ex in executors]} leaves out cuda, and "
                  f"{on_card} lie on the card: the port runs no decomposition there in place "
                  f"of a kernel", ValueError)

    with _observe.span("epilogue_fusion"):
        trc = epilogue_fusion_pass(trc, executors)
    with _observe.span("claim"):
        ex_bsyms: list[BoundSymbol] = []
        for bsym in trc.bound_symbols:
            ex_bsyms.extend(claim_bsym(bsym, executors))
        new = from_trace(trc)
        new.bound_symbols = ex_bsyms
    new = dce(new)
    new.set_provenance("Transform for execution")
    return new


def del_last_used(trc: TraceCtx) -> TraceCtx:
    """Insert ``del`` statements after each proxy's last use, so the
    generated program releases intermediates as soon as it can."""
    from thunder_tpu_torch.core import prims

    out_vars = {Variable(o) for o in tree_flatten(trc.output)[0] if isinstance(o, Proxy)}
    arg_vars = {Variable(a) for a in trc.args}
    visible: set[Variable] = set(arg_vars)
    for bsym in trc.bound_symbols:
        for p in bsym.flat_proxy_outs():
            visible.add(Variable(p))
    last_use: dict[Variable, int] = {}
    for i, bsym in enumerate(trc.bound_symbols):
        for v in consumed_vars(bsym):
            if v in visible:
                last_use[v] = i
    dels_at: dict[int, list[Proxy]] = {}
    for v, i in last_use.items():
        if v not in out_vars and v not in arg_vars:
            dels_at.setdefault(i, []).append(v.proxy)
    new = from_trace(trc)
    bsyms: list[BoundSymbol] = []
    for i, bsym in enumerate(trc.bound_symbols):
        bsyms.append(bsym)
        if i in dels_at and bsym.sym.id is not PrimIDs.PYTHON_RETURN:
            bsyms.append(prims.python_del.bind(*sorted(dels_at[i], key=lambda p: p.name),
                                               output=None))
    new.bound_symbols = bsyms
    new.set_provenance("Delete last used")
    return new
