"""Executors of the port: prioritized operation claiming and region fusion.

The counterpart of ``thunder_tpu/executors/__init__.py`` (``ImplInfo``,
``OperatorExecutor``, ``register_operator``, ``register_implementation``,
``FusionExecutor`` with its optimization fuel, the registry and
:func:`resolve_executors`). Every operation in a trace may be claimed by an
executor, which substitutes its own symbol carrying a runtime callable.
Executors are offered each bound symbol in priority order: ``cuda``
(:mod:`~thunder_tpu_torch.executors.cudaex_claims`, the hand-written
kernels of :mod:`~thunder_tpu_torch.executors.cudaex`) first, then the
always-on ``torch`` executor (:mod:`~thunder_tpu_torch.executors.eagertorch`),
which runs every unclaimed prim as one torch call. After the claims, each
``FusionExecutor`` of the stack groups whole regions of the trace into one
callable: ``region`` (:mod:`~thunder_tpu_torch.executors.regionex`, the
counterpart of the reference's XLA executor), whose elementwise regions
each run as one generated kernel on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol


class ImplInfo:
    """How an executor implements one symbol id: ``checker`` says whether it
    claims the bound symbol's arguments (can it); ``profitable``, where
    given, says whether it should (the cost-model gate: a legal claim may
    lose to leaving the op to the region executor), asked with the bound
    symbol; ``refusal``, where given, says why its kernel would not take
    arguments the checker claims (None where it takes them), and the claim
    pass raises that reason."""

    __slots__ = ("symbol", "checker", "refusal", "profitable")

    def __init__(self, symbol: Symbol | None = None, checker: Callable | None = None,
                 refusal: Callable | None = None, profitable: Callable | None = None):
        self.symbol = symbol
        self.checker = checker
        self.refusal = refusal
        self.profitable = profitable


class Executor:
    """An executor: ``implmap`` maps a symbol id to its :class:`ImplInfo`."""

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


class OperatorExecutor(Executor):
    """An executor providing per-op runtime callables."""

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
                                refusal: Callable | None = None,
                                profitable: Callable | None = None) -> None:
        sym_id = id_or_sym.id if isinstance(id_or_sym, Symbol) else id_or_sym
        self.implmap[sym_id] = ImplInfo(symbol=op, checker=checker, refusal=refusal,
                                        profitable=profitable)


class FusionExecutor(Executor):
    """An executor that fuses whole regions of the trace after the claim
    pass (:meth:`fusion_pass`). Its optimization fuel (the reference's, read
    from ``<NAME>_OPTIMIZATION_FUEL`` when the executor is made) bounds how
    many bound symbols it may take, to bisect a fault to one fusion."""

    def __init__(self, name: str, version: str = "0.1"):
        super().__init__(name, version)
        import os

        fuel = os.environ.get(f"{name.upper()}_OPTIMIZATION_FUEL")
        self._fuel = int(fuel) if fuel else None

    def get_fuel(self, amount: int = 1) -> bool:
        if self._fuel is None:
            return True
        if self._fuel < amount:
            return False
        self._fuel -= amount
        return True

    def fusion_pass(self, trace):
        raise NotImplementedError

    def can_fuse(self, bsym: BoundSymbol) -> bool:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_executor_map: dict[str, Executor] = {}
_default_executors: list[Executor] = []
_always_executors: list[Executor] = []


def register_executor(ex: Executor, *, default: bool = False, always: bool = False):
    _executor_map[ex.name] = ex
    if default and ex not in _default_executors:
        _default_executors.append(ex)
    if always and ex not in _always_executors:
        _always_executors.append(ex)
    return ex


def _ensure_builtin_executors() -> None:
    from thunder_tpu_torch.executors import cudaex_claims, eagertorch, regionex  # noqa: F401


def get_executor(name: str) -> Executor | None:
    _ensure_builtin_executors()
    return _executor_map.get(name)


def get_default_executors() -> tuple[Executor, ...]:
    _ensure_builtin_executors()
    return tuple(_default_executors)


def get_always_executors() -> tuple[Executor, ...]:
    _ensure_builtin_executors()
    return tuple(_always_executors)


def resolve_executors(executors: Sequence | None) -> tuple[Executor, ...]:
    """The executor stack: the defaults when ``executors`` is None, else the
    named or given ones; the always-on executors close the stack."""
    if executors is None:
        return get_default_executors() + tuple(
            a for a in get_always_executors() if a not in _default_executors)
    out = []
    for e in executors:
        if isinstance(e, Executor):
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


# the region executor registers its kernel's launch counter beside the
# hand-written kernels' (``cudaex.register_generated``) when imported: it is
# imported with the package, so every count read carries it
from thunder_tpu_torch.executors import regionex as _regionex  # noqa: E402, F401
