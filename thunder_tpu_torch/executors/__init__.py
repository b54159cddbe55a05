"""Executors of the port: prioritized operation claiming.

The counterpart of ``thunder_tpu/executors/__init__.py`` (``ImplInfo``,
``OperatorExecutor``, ``register_operator``, ``register_implementation``,
the registry and :func:`resolve_executors`). Every operation in a trace may
be claimed by an executor, which substitutes its own symbol carrying a
runtime callable. Executors are offered each bound symbol in priority
order: ``cuda`` (:mod:`~thunder_tpu_torch.executors.cudaex_claims`, the
hand-written kernels of :mod:`~thunder_tpu_torch.executors.cudaex`) first,
then the always-on ``torch`` executor
(:mod:`~thunder_tpu_torch.executors.eagertorch`), which runs every prim as
one torch call. The reference's fusion executors (XLA regions) have no
counterpart yet (ROADMAP A.7.4).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol


class ImplInfo:
    """How an executor implements one symbol id: ``checker`` says whether it
    claims the bound symbol's arguments; ``refusal``, where given, says why
    its kernel would not take arguments the checker claims (None where it
    takes them), and the claim pass raises that reason."""

    __slots__ = ("symbol", "checker", "refusal")

    def __init__(self, symbol: Symbol | None = None, checker: Callable | None = None,
                 refusal: Callable | None = None):
        self.symbol = symbol
        self.checker = checker
        self.refusal = refusal


class OperatorExecutor:
    """An executor providing per-op runtime callables: ``implmap`` maps a
    symbol id to its :class:`ImplInfo`."""

    def __init__(self, name: str, version: str = "0.1"):
        self.name = name
        self.version = version
        self.implmap: dict[Any, ImplInfo] = {}

    def can_execute(self, bsym: BoundSymbol) -> bool:
        impl = self.implmap.get(bsym.sym.id)
        if impl is None:
            return False
        if impl.checker is not None:
            try:
                return bool(impl.checker(*bsym.args, **bsym.kwargs))
            except Exception:
                return False
        return True

    def get_impl(self, bsym: BoundSymbol) -> ImplInfo | None:
        return self.implmap.get(bsym.sym.id)

    def __repr__(self):
        return f"<Executor {self.name}>"

    def register_operator(self, name: str, *, meta: Callable | None = None, fn: Callable,
                          like: Symbol | None = None, id: str | None = None) -> Symbol:
        """The executor's symbol ``name`` (codegen name ``<executor>_<name>``)
        running ``fn``; its id, the claim id, is ``<executor>.<name>`` unless
        ``id`` names another (two symbols claiming for one kernel share its
        id). The port's kernel callables are the routers of ``ops/``, which
        run behind their own kernel guard, so ``fn`` is not wrapped again."""
        if meta is None and like is not None:
            meta = like.meta
        return Symbol(name, meta, id=id or f"{self.name}.{name}", is_prim=True, executor=self,
                      python_impl=fn, tags=like.tags if like is not None else None)

    def register_implementation(self, id_or_sym, op: Symbol | None = None, *,
                                checker: Callable | None = None,
                                refusal: Callable | None = None) -> None:
        sym_id = id_or_sym.id if isinstance(id_or_sym, Symbol) else id_or_sym
        self.implmap[sym_id] = ImplInfo(symbol=op, checker=checker, refusal=refusal)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_executor_map: dict[str, OperatorExecutor] = {}
_default_executors: list[OperatorExecutor] = []
_always_executors: list[OperatorExecutor] = []


def register_executor(ex: OperatorExecutor, *, default: bool = False, always: bool = False):
    _executor_map[ex.name] = ex
    if default and ex not in _default_executors:
        _default_executors.append(ex)
    if always and ex not in _always_executors:
        _always_executors.append(ex)
    return ex


def _ensure_builtin_executors() -> None:
    from thunder_tpu_torch.executors import cudaex_claims, eagertorch  # noqa: F401


def get_executor(name: str) -> OperatorExecutor | None:
    _ensure_builtin_executors()
    return _executor_map.get(name)


def get_default_executors() -> tuple[OperatorExecutor, ...]:
    _ensure_builtin_executors()
    return tuple(_default_executors)


def get_always_executors() -> tuple[OperatorExecutor, ...]:
    _ensure_builtin_executors()
    return tuple(_always_executors)


def resolve_executors(executors: Sequence | None) -> tuple[OperatorExecutor, ...]:
    """The executor stack: the defaults when ``executors`` is None, else the
    named or given ones; the always-on executors close the stack."""
    if executors is None:
        return get_default_executors() + tuple(
            a for a in get_always_executors() if a not in _default_executors)
    out = []
    for e in executors:
        if isinstance(e, OperatorExecutor):
            out.append(e)
        elif isinstance(e, str):
            ex = get_executor(e)
            check(ex is not None, lambda: f"unknown executor {e!r}; known: {list(_executor_map)}")
            out.append(ex)
        else:
            raise TypeError(f"cannot resolve executor from {e!r}")
    for a in get_always_executors():
        if a not in out:
            out.append(a)
    return tuple(out)
