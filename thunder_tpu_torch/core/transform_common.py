"""Common trace-to-trace transforms: DCE and CSE.

The counterpart of ``thunder_tpu/core/transform_common.py`` (``dce``,
``cse``; its ``Transform`` hooks wait for ``jit(transforms=)``, ROADMAP
A.7). In-place torch ops never reach a trace: the torch front end
functionalizes them while tracing.
"""

from __future__ import annotations

from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, Variable
from thunder_tpu_torch.core.symbol import BoundSymbol
from thunder_tpu_torch.core.trace import TraceCtx, from_trace
from thunder_tpu_torch.core.utils import consumed_vars, produced_vars


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

