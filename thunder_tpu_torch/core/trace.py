"""TraceCtx: the multi-stage, printable, executable trace container.

The counterpart of ``thunder_tpu/core/trace.py``. A trace is a linear list
of BoundSymbols over proxies; it prints as a Python program
(:meth:`TraceCtx.python`) and compiles to a callable
(:meth:`TraceCtx.python_callable`). Each stage of the pipeline records a
provenance line, so every stage can be read.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.codeutils import SigInfo, type_comment
from thunder_tpu_torch.core.proxies import Proxy


class TraceProvenance:
    def __init__(self, pss: str):
        self.pss = pss

    def __repr__(self):
        return f"# Constructed by {self.pss}"


_tracectx: ContextVar = ContextVar("thunder_tpu_torch_tracectx", default=None)


def get_tracectx() -> "TraceCtx | None":
    return _tracectx.get()


@contextmanager
def tracectx(trace: "TraceCtx | None"):
    tok = _tracectx.set(trace)
    try:
        yield trace
    finally:
        _tracectx.reset(tok)


class TraceCtx:
    def __init__(self, fn_name: str = "computation"):
        self.fn_name = fn_name
        self.args: list[Proxy] = []
        self.bound_symbols: list = []
        self._scopes: list[list] = [self.bound_symbols]
        self.provenance: TraceProvenance | None = None
        self._names: set[str] = set()
        self._counters: dict[str, int] = {}
        self.output: Any = None
        # inside a value_and_grad region: the names of the values that need
        # a gradient (the differentiated inputs and what is computed from
        # them); None elsewhere
        self.grad_names: set[str] | None = None

    # -- names -------------------------------------------------------------
    def make_name(self, prefix: str = "t") -> str:
        ctr = self._counters.get(prefix, 0)
        while True:
            name = f"{prefix}{ctr}"
            ctr += 1
            if name not in self._names:
                break
        self._counters[prefix] = ctr
        self._names.add(name)
        return name

    def register_name(self, name: str) -> None:
        self._names.add(name)

    # -- recording ---------------------------------------------------------
    def add_bound_symbol(self, bsym) -> None:
        self._scopes[-1].append(bsym)

    def push_scope(self, scope: list) -> None:
        self._scopes.append(scope)

    def pop_scope(self) -> list:
        check(len(self._scopes) > 1, "cannot pop the root scope")
        return self._scopes.pop()

    # -- codegen -----------------------------------------------------------
    def siginfo(self) -> SigInfo:
        return SigInfo(self.fn_name, [a.name for a in self.args])

    def python(self) -> str:
        lines: list[str] = []
        if self.provenance is not None:
            lines.append(repr(self.provenance))
        lines.append("import torch")
        lines.append("from thunder_tpu_torch.core import dtypes")
        lines.append("")
        lines.append(self.siginfo().prettyprint())
        for a in self.args:
            tc = type_comment(a)
            if tc is not None:
                lines.append(f"  # {tc}")
        for bsym in self.bound_symbols:
            lines.extend(bsym.python(indent=1))
        if not self.bound_symbols or self.bound_symbols[-1].sym.name != "python_return":
            lines.append("  return None")
        return "\n".join(lines)

    def python_ctx(self) -> dict[str, Any]:
        """The names the generated source references: executor callables and
        the dtypes module."""
        import torch

        from thunder_tpu_torch.core import dtypes as _dt

        ctx: dict[str, Any] = {"dtypes": _dt, "torch": torch}
        for bsym in self.bound_symbols:
            bsym.gather_ctx(ctx)
        return ctx

    def python_callable(self) -> Callable:
        source = self.python()
        module_ns: dict[str, Any] = dict(self.python_ctx())
        exec(compile(source, f"thunder_tpu_torch.gen_{self.fn_name}", "exec"), module_ns)
        fn = module_ns[self.siginfo().name]
        fn._trace = self
        fn.__source__ = source
        return fn

    def __repr__(self):
        return self.python()

    def set_provenance(self, pss: str) -> "TraceCtx":
        self.provenance = TraceProvenance(pss)
        return self


def from_trace(trc: TraceCtx) -> TraceCtx:
    """New empty trace inheriting signature and names from ``trc``."""
    new = TraceCtx(trc.fn_name)
    new.args = list(trc.args)
    new._names = set(trc._names)
    new._counters = dict(trc._counters)
    new.output = trc.output
    return new


def copy_trace(trc: TraceCtx) -> TraceCtx:
    """A copy of ``trc`` that a pass may rewrite in place (its signature,
    bound symbols and name table are lists and sets of its own), with the
    attributes the tracer set on ``trc`` (``input_proxies``, ...)."""
    new = from_trace(trc)
    vars(new).update({k: v for k, v in vars(trc).items() if k not in vars(new)})
    new.provenance = trc.provenance
    new.grad_names = None if trc.grad_names is None else set(trc.grad_names)
    new.bound_symbols = list(trc.bound_symbols)
    new._scopes = [new.bound_symbols]
    return new
