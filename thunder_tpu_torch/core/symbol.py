"""Symbol and BoundSymbol: the ops of the trace IR.

The counterpart of ``thunder_tpu/core/symbol.py``. Calling a ``Symbol``
under a trace context runs its meta (which computes the output proxies and,
for a composite, records its decomposition as subsymbols) and appends a
``BoundSymbol``. Executors later claim bound symbols, swapping in symbols
that carry a ``python_impl``; the generated program calls those impls.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.codeutils import prettyprint, sanitize_name, type_comment
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable, variableify
from thunder_tpu_torch.core.pytree import tree_flatten, tree_map
from thunder_tpu_torch.core.trace import get_tracectx


# prims the generated program writes as statements, not calls
_NO_CALL = ("python_return", "python_del", "comment")


def _is_raw_tensor(x) -> bool:
    return not isinstance(x, Proxy) and hasattr(x, "shape") and hasattr(x, "dtype")


def _lift_constant_tensors(trc, args, kwargs):
    """Lift concrete tensors (closure-captured torch tensors or numpy arrays)
    into named constant-producing bound symbols, so traces never embed raw
    tensors."""
    flat, _ = tree_flatten((args, kwargs))
    if not any(_is_raw_tensor(x) for x in flat):
        return args, kwargs

    def lift(x):
        if not _is_raw_tensor(x):
            return x
        cache = getattr(trc, "_const_cache", None)
        if cache is None:
            cache = trc._const_cache = {}
        if id(x) in cache:
            return cache[id(x)]
        import torch

        from thunder_tpu_torch.core import dtypes as _dt

        value = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        idx = getattr(trc, "_const_counter", 0)
        trc._const_counter = idx + 1
        out = TensorProxy(shape=value.shape, dtype=_dt.to_dtype(value.dtype), device=value.device)
        csym = Symbol(f"const_tensor{idx}", None, id=f"const_tensor:{idx}:{id(x)}",
                      is_prim=True, python_impl=lambda _v=value: _v)
        trc.add_bound_symbol(csym.bind(output=out))
        cache[id(x)] = out
        return out

    return tree_map(lift, (args, kwargs), is_leaf=lambda x: _is_raw_tensor(x) or isinstance(x, Proxy))


class Symbol:
    """A traceable operation.

    ``meta`` computes the output proxies (a prim's only computes metadata; a
    composite's calls other symbols, recorded as subsymbols). ``id`` is the
    stable identifier executors claim by; ``executor`` is set on executor
    symbols, whose ``python_impl`` the generated program calls.
    """

    __slots__ = ("name", "meta", "id", "is_prim", "executor", "python_impl", "tags")

    def __init__(self, name: str, meta: Callable | None = None, *, id: Any = None,
                 is_prim: bool = False, executor=None, python_impl: Callable | None = None,
                 tags: frozenset | None = None):
        self.name = name
        self.meta = meta
        self.id = id
        self.is_prim = is_prim
        self.executor = executor
        self.python_impl = python_impl
        self.tags = tags or frozenset()

    def codegen_name(self) -> str:
        if self.executor is not None:
            return sanitize_name(f"{self.executor.name}_{self.name}")
        return sanitize_name(self.name)

    def __repr__(self):
        return f"[Symbol {self.name}]"

    def __call__(self, *args, **kwargs):
        trc = get_tracectx()
        check(trc is not None,
              lambda: f"symbol {self.name} called outside a trace context; use thunder_tpu_torch.jit")
        args, kwargs = _lift_constant_tensors(trc, args, kwargs)
        if self.is_prim:
            result = self.meta(*args, **kwargs)
            subsymbols: list = []
        else:
            scope: list = []
            trc.push_scope(scope)
            try:
                result = self.meta(*args, **kwargs)
            finally:
                trc.pop_scope()
            subsymbols = scope
        trc.add_bound_symbol(BoundSymbol(self, args, kwargs, result, subsymbols))
        if trc.grad_names:
            _propagate_requires_grad(trc.grad_names, args, kwargs, result)
        return result

    def bind(self, *args, output, subsymbols=(), **kwargs) -> "BoundSymbol":
        """A BoundSymbol made without tracing (trace transforms use it)."""
        return BoundSymbol(self, args, kwargs, output, list(subsymbols))


class BoundSymbol:
    # _consumed_cache/_produced_cache memoize core.utils.consumed_vars /
    # produced_vars; safe because every rewrite builds a new BoundSymbol
    __slots__ = ("sym", "args", "kwargs", "output", "subsymbols", "header",
                 "_consumed_cache", "_produced_cache")

    def __init__(self, sym: Symbol, args: Sequence, kwargs: dict, output: Any, subsymbols: list):
        self.sym = sym
        self.args = tuple(args)
        self.kwargs = dict(kwargs)
        self.output = output
        self.subsymbols = subsymbols
        self.header: str | None = None
        self._consumed_cache: frozenset | None = None
        self._produced_cache: frozenset | None = None

    # -- dataflow ----------------------------------------------------------
    def flat_args(self) -> list:
        return tree_flatten((self.args, self.kwargs))[0]

    def flat_proxy_args(self) -> list[Proxy]:
        return [a for a in self.flat_args() if isinstance(a, Proxy)]

    def flat_outs(self) -> list:
        return tree_flatten(self.output)[0]

    def flat_proxy_outs(self) -> list[Proxy]:
        return [o for o in self.flat_outs() if isinstance(o, Proxy)]

    @property
    def rhs(self):
        """Hashable right-hand side for CSE: the symbol, its arguments and
        its outputs' metadata."""
        out_meta = tuple((tuple(getattr(p, "shape", ())), getattr(getattr(p, "dtype", None), "name", None))
                         for p in self.flat_proxy_outs())
        return (self.sym.id if self.sym.id is not None else self.sym.name,
                tuple(_hashable(variableify(a)) for a in self.flat_args()), out_meta)

    # -- rewriting ---------------------------------------------------------
    def from_bsym(self, **changes) -> "BoundSymbol":
        kw = dict(sym=self.sym, args=self.args, kwargs=self.kwargs, output=self.output,
                  subsymbols=self.subsymbols)
        kw.update(changes)
        b = BoundSymbol(kw["sym"], kw["args"], kw["kwargs"], kw["output"], list(kw["subsymbols"]))
        b.header = self.header
        return b

    def from_bsym_swap_proxies(self, swap_map: dict[Variable, Proxy],
                               skip_output: bool = False) -> "BoundSymbol":
        """A copy with proxies replaced per ``swap_map``."""

        def swap(x):
            if isinstance(x, Proxy):
                return swap_map.get(Variable(x), x)
            if isinstance(x, tuple):
                return tuple(swap(i) for i in x)
            if isinstance(x, list):
                return [swap(i) for i in x]
            if isinstance(x, dict):
                return {k: swap(v) for k, v in x.items()}
            return x

        b = BoundSymbol(self.sym, swap(self.args), swap(self.kwargs),
                        self.output if skip_output else swap(self.output),
                        [s.from_bsym_swap_proxies(swap_map, skip_output=skip_output)
                         for s in self.subsymbols])
        b.header = self.header
        return b

    # -- codegen -----------------------------------------------------------
    def python(self, indent: int = 1) -> list[str]:
        pad = "  " * indent
        lines = []
        if self.header:
            for h in self.header.splitlines():
                lines.append(f"{pad}# {h}")
        if self.sym.name == "python_return":
            lines.append(f"{pad}return {prettyprint(self.args[0]) if self.args else 'None'}")
            return lines
        if self.sym.name == "python_del":
            lines.append(f"{pad}del {', '.join(prettyprint(a) for a in self.args)}")
            return lines
        if self.sym.name == "comment":
            lines.append(f"{pad}# {self.args[0]}")
            return lines
        argstr = ", ".join([prettyprint(a) for a in self.args]
                           + [f"{k}={prettyprint(v)}" for k, v in self.kwargs.items()])
        outs = self.flat_proxy_outs()
        lhs = prettyprint(self.output) + " = " if self.output is not None and self.flat_outs() else ""
        comment = f"  # {type_comment(outs[0])}" if len(outs) == 1 and isinstance(outs[0], TensorProxy) else ""
        lines.append(f"{pad}{lhs}{self.sym.codegen_name()}({argstr}){comment}")
        return lines

    def gather_ctx(self, ctx: dict[str, Any]) -> None:
        if self.sym.name in _NO_CALL:
            return
        impl = self._resolve_impl()
        check(impl is not None, lambda: f"no executable implementation for symbol {self.sym.name!r} "
                                        f"(id={self.sym.id}); run transform_for_execution first")
        ctx[self.sym.codegen_name()] = impl

    def _resolve_impl(self):
        if self.sym.python_impl is not None:
            return self.sym.python_impl
        from thunder_tpu_torch.executors.eagertorch import get_eager_impl

        impl = get_eager_impl(self.sym)
        if impl is not None or not self.subsymbols:
            return impl
        bsym = self

        def composite_impl(*args, **kwargs):
            # an unclaimed composite runs its decomposition
            env: dict = {}
            spec, _ = tree_flatten((bsym.args, bsym.kwargs))
            vals, _ = tree_flatten((args, kwargs))
            for s, v in zip(spec, vals):
                if isinstance(s, Proxy):
                    env[s.name] = v
            run_bsyms(bsym.subsymbols, env)
            return _subst(env, bsym.output)

        return composite_impl

    def __repr__(self):
        return "\n".join(self.python(indent=0))


def _propagate_requires_grad(names: set, args, kwargs, result) -> None:
    """Inside a ``value_and_grad`` region: a floating output of an op that
    reads a value needing a gradient needs one too (``requires_grad``)."""
    if any(isinstance(a, Proxy) and a.name in names for a in tree_flatten((args, kwargs))[0]):
        for o in tree_flatten(result)[0]:
            if isinstance(o, TensorProxy) and o.dtype.is_inexact:
                names.add(o.name)


def _hashable(x):
    if isinstance(x, list):
        return tuple(_hashable(i) for i in x)
    if isinstance(x, slice):
        return ("slice", x.start, x.stop, x.step)
    if isinstance(x, dict):
        return tuple(sorted((k, _hashable(v)) for k, v in x.items()))
    return x


def _subst(env: dict, x):
    if isinstance(x, Proxy):
        return env[x.name]
    if isinstance(x, (tuple, list)):
        return type(x)(_subst(env, i) for i in x)
    if isinstance(x, dict):
        return {k: _subst(env, v) for k, v in x.items()}
    return x


def run_bsyms(bsyms, env: dict) -> None:
    """Interpret bound symbols over ``env`` (proxy name -> value)."""
    for b in bsyms:
        if b.sym.name in _NO_CALL:
            continue
        out = b._resolve_impl()(*_subst(env, b.args), **_subst(env, b.kwargs))
        outs, _ = tree_flatten(b.output)
        vals, _ = tree_flatten(out)
        for o, v in zip(outs, vals):
            if isinstance(o, Proxy):
                env[o.name] = v
