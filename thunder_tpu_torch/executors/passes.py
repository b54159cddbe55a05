"""Trace -> executable-trace passes: the fusion passes, executor claiming,
the fusion executors' regions, ``del`` insertion, and the in-place writes
of donated inputs.

The counterpart of ``thunder_tpu/executors/passes.py`` (``claim_bsym``
:48, ``transform_for_execution`` :150, ``del_last_used`` :252). The fusion
passes of ``core/fusion_passes.py`` run first, in the reference's order
(block, horizontal, epilogue, optimizer), then each bound symbol is offered
to the operator executors in priority order; an executor substitutes its
own symbol, whose runtime callable the generated program calls; an
unclaimed composite is decomposed and its subsymbols offered again; an
unclaimed prim runs on the always-on torch executor. Then every
``FusionExecutor`` of the stack runs its fusion pass (the ``region``
executor groups unclaimed elementwise prims into regions, each one
generated kernel on the card), and DCE, as the reference does
(``thunder_tpu/executors/passes.py:206``). Every verdict goes to the
decision log (``observe/decisions.py``) while one is collected.

Nothing falls back on the card: a claim the quarantine routes off is
still claimed, and its router raises a fatal ``KernelExecutionError`` when
it runs on the card; a claim whose kernel refuses the arguments
(``cudaex.refusal``) raises that reason here, at compile time, instead of
decomposing. The reference's region annotations and its claims'
cost-model gate (``ImplInfo.profitable``, which weighs a claim against
leaving the op in a fusion region) are not ported: the gate waits for
reductions in regions (ROADMAP A.7.4).
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
from thunder_tpu_torch.executors import FusionExecutor
from thunder_tpu_torch.observe import decisions as _decisions
from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.runtime import quarantine as _quarantine

_PASSTHROUGH_IDS = (PrimIDs.PYTHON_RETURN, PrimIDs.PYTHON_DEL, PrimIDs.COMMENT)


def claim_bsym(bsym: BoundSymbol, executors) -> list[BoundSymbol]:
    if bsym.sym.id in _PASSTHROUGH_IDS or bsym.sym.executor is not None:
        return [bsym]
    log = _decisions.active()   # one flag read a bound symbol while no log is kept
    for ex in executors:
        if isinstance(ex, FusionExecutor):
            continue   # fusion executors run as whole-trace passes afterwards
        impl = ex.get_impl(bsym)
        if impl is None or impl.symbol is None:
            continue
        if not ex.can_execute(bsym):
            if log:
                _decisions.record("claim", bsym.sym.name, ex.name, "rejected",
                                  "checker refused (device, shape or dtype)")
            continue
        reason = impl.refusal(*bsym.args, **bsym.kwargs) if impl.refusal is not None else None
        check(reason is None,
              lambda: f"{impl.symbol.id}: the kernel refuses the arguments of {bsym.sym.name} "
                      f"({reason}); the port runs no decomposition on the card in its place",
              ValueError)
        if log:
            qreason = _quarantine.quarantine_reason(impl.symbol.id)
            _decisions.record("claim", bsym.sym.name, ex.name, "claimed",
                              f"quarantined ({qreason}): its router raises on the card"
                              if qreason is not None else "")
        claimed = impl.symbol.bind(*bsym.args, output=bsym.output, subsymbols=bsym.subsymbols,
                                   **bsym.kwargs)
        claimed.header = bsym.header
        return [claimed]
    from thunder_tpu_torch.executors.eagertorch import get_eager_impl

    if bsym.sym.is_prim:
        check(get_eager_impl(bsym.sym) is not None or bsym.sym.python_impl is not None,
              lambda: f"no executor can run prim {bsym.sym.name}")
        if log:
            _decisions.record("claim", bsym.sym.name, "torch", "fallback",
                              "unclaimed prim runs on the torch executor")
        return [bsym]
    if not bsym.subsymbols:
        # identity composite (eval-mode dropout returns its input)
        arg_names = {p.name for p in bsym.flat_proxy_args()}
        outs = bsym.flat_proxy_outs()
        if outs and all(p.name in arg_names for p in outs):
            return []
    check(bsym.subsymbols, lambda: f"unclaimed symbol {bsym.sym.name} has no decomposition")
    if log:
        _decisions.record("claim", bsym.sym.name, None, "decomposed",
                          f"no executor claims the composite; re-offering its "
                          f"{len(bsym.subsymbols)} subsymbols")
    out: list[BoundSymbol] = []
    for sub in bsym.subsymbols:
        out.extend(claim_bsym(sub, executors))
    return out


def transform_for_execution(trc: TraceCtx, executors) -> TraceCtx:
    """The fusion passes (block, horizontal, epilogue, optimizer), the claim
    pass, each fusion executor's pass in stack order, then DCE. A trace
    whose inputs lie on the card needs the ``cuda`` executor in its stack:
    without it every composite would decompose there in place of its
    kernel."""
    from thunder_tpu_torch.core.fusion_passes import (
        block_fusion_pass, epilogue_fusion_pass, horizontal_fusion_pass, optimizer_fusion_pass)

    on_card = [a.name for a in trc.args
               if isinstance(a, TensorProxy) and a.device.type == "cuda"]
    check(not on_card or any(ex.name == "cuda" for ex in executors),
          lambda: f"the executor stack {[ex.name for ex in executors]} leaves out cuda, and "
                  f"{on_card} lie on the card: the port runs no decomposition there in place "
                  f"of a kernel", ValueError)

    # before claiming: the block planner first, since it wants whole
    # sub-block chains, which the horizontal merge (gate and up share the
    # normed input) and the epilogue pass (add -> rms_norm) would carve up.
    # A training trace was planned before autodiff (its chains are prims
    # here, and the anchor scan returns at once); this serves grad-free traces
    with _observe.span("block_fusion"):
        trc = block_fusion_pass(trc, executors)
    with _observe.span("horizontal_fusion"):
        trc = horizontal_fusion_pass(trc)
    with _observe.span("epilogue_fusion"):
        trc = epilogue_fusion_pass(trc, executors)
    with _observe.span("optimizer_fusion"):
        trc = optimizer_fusion_pass(trc, executors)
    with _observe.span("claim"):
        ex_bsyms: list[BoundSymbol] = []
        for bsym in trc.bound_symbols:
            ex_bsyms.extend(claim_bsym(bsym, executors))
        new = from_trace(trc)
        new.bound_symbols = ex_bsyms
    for ex in executors:
        if isinstance(ex, FusionExecutor):
            with _observe.span(f"fusion_pass:{ex.name}"):
                new = ex.fusion_pass(new)
    new = dce(new)
    new.set_provenance("Transform for execution")
    return new


# executor callables that may overwrite their inputs: callable -> ``targets``
_in_place_writers: dict = {}


def writes_in_place(fn, targets) -> None:
    """Declare the executor callable ``fn`` a writer of its inputs.
    ``targets(*args, **kwargs)``, on the bound symbol's arguments, lists the
    groups it may overwrite, each a list of ``(input, dtype it is stored
    in)``; ``fn`` takes ``donated=``, one tuple of flags a group, and writes
    a copy of each input whose flag is false."""
    _in_place_writers[fn] = targets


# the torch executor's prims that write their first argument in place when
# it is marked ``donated=True`` (eagertorch ``_scatter``,
# ``_dynamic_update_slice``): the serving programs' pool writes
_PRIM_WRITERS = (PrimIDs.SCATTER, PrimIDs.DYNAMIC_UPDATE_SLICE)


def _writer_targets(b: BoundSymbol):
    """The groups of ``(input, dtype it is stored in)`` that bound symbol
    ``b`` may write in place, and whether it is one of the torch executor's
    prims; None for a symbol that writes nothing."""
    if b.sym.executor is not None and b.sym.python_impl in _in_place_writers:
        return _in_place_writers[b.sym.python_impl](*b.args, **b.kwargs), False
    if (b.sym.executor is None and b.sym.id in _PRIM_WRITERS and b.args
            and isinstance(b.args[0], TensorProxy)):
        return [[(b.args[0], b.args[0].dtype)]], True
    return None


def _versions(bsyms, donated: set[str], enabled: set) -> dict:
    """Label every name that may share storage with a donated input:
    ``name -> (root, version, plain)``. A view the torch executor makes
    (``eagertorch.MAY_ALIAS``: reshape, permute, a same-dtype convert, ...)
    keeps its input's label, ``plain`` only through reshapes; an in-place
    prim write in ``enabled`` (its position) makes the next version of its
    target's root."""
    from thunder_tpu_torch.executors.eagertorch import MAY_ALIAS

    label = {n: (n, 0, True) for n in donated}
    for i, b in enumerate(bsyms):
        if b.sym.executor is not None:
            continue
        if b.sym.id in MAY_ALIAS:
            src = next((label[p.name] for p in b.flat_proxy_args() if p.name in label), None)
            if src is not None:
                plain = src[2] and b.sym.id is PrimIDs.RESHAPE
                for o in b.flat_proxy_outs():
                    label[o.name] = (src[0], src[1], plain)
        elif i in enabled and b.args[0].name in label:
            r, v, _ = label[b.args[0].name]
            for o in b.flat_proxy_outs():
                label[o.name] = (r, v + 1, True)
    return label


def donate_in_place(trc: TraceCtx, donated: set[str]) -> tuple[TraceCtx, bool]:
    """Let each writer write the donated inputs it updates in place
    (``jit(donate_argnums=)``): the claimed writers (:func:`writes_in_place`)
    and the torch executor's ``scatter`` and ``dynamic_update_slice``. A
    target is written in place only where it is a donated input (for a
    prim, or a reshape of one, or the output of an earlier in-place write of
    one: the storage's next version), in the dtype it is stored in, passed
    to the writer once, and where no bound symbol after the writer reads
    that version, nor returns it. A claimed writer's ``donated`` argument
    says which of its targets (every other is copied first); a prim written
    in place gets ``donated=True``. Returns the trace and the names of the
    donated inputs written in place."""
    bsyms = list(trc.bound_symbols)
    writers = {i: w for i, b in enumerate(bsyms) if (w := _writer_targets(b)) is not None}
    if not writers:
        return trc, frozenset()
    out_names = [o.name for o in tree_flatten(trc.output)[0] if isinstance(o, Proxy)]
    enabled = {i for i, (_, prim) in writers.items() if prim}
    while True:
        label = _versions(bsyms, donated, enabled)
        last_read: dict[tuple, int] = {}
        for i, b in enumerate(bsyms):
            for v in consumed_vars(b):
                lab = label.get(v.proxy.name)
                if lab is not None:
                    last_read[lab[:2]] = i
        returned = {label[n][:2] for n in out_names if n in label}

        def in_place(i, t, dt, prim):
            lab = label.get(t.name)
            if lab is None or t.dtype != dt or not (lab[2] if prim else t.name in donated):
                return False
            passed = [label[p.name][0] for p in bsyms[i].flat_proxy_args() if p.name in label]
            return (last_read.get(lab[:2], -1) <= i and lab[:2] not in returned
                    and passed.count(lab[0]) == 1)

        marks = {i: tuple(tuple(in_place(i, t, dt, prim) for t, dt in group) for group in groups)
                 for i, (groups, prim) in writers.items()}
        still = {i for i in enabled if marks[i][0][0]}
        if still == enabled:
            break
        enabled = still
    written = set()
    for i, (groups, prim) in writers.items():
        b = bsyms[i]
        if prim:
            if i in enabled:
                bsyms[i] = b.from_bsym(kwargs={**b.kwargs, "donated": True})
                written.add(label[b.args[0].name][0])
        else:
            written.update(t.name for group, flags in zip(groups, marks[i])
                           for (t, _), flag in zip(group, flags) if flag)
            bsyms[i] = b.from_bsym(kwargs={**b.kwargs, "donated": marks[i]})
    new = from_trace(trc)
    new.bound_symbols = bsyms
    new.provenance = trc.provenance
    return new, frozenset(written)


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
