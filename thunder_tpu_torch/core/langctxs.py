"""Language contexts: pluggable resolution of operation namespaces.

The counterpart of ``thunder_tpu/core/langctxs.py`` (``LanguageContext``,
``resolve_method``, ``langctx``, ``Languages``): the ``ops`` language (the
torch-capability surface of :mod:`thunder_tpu_torch.ops`) and the
``prims`` language, registered at first use. The reference's numpy dialect
is not ported yet (ROADMAP A.7).
"""

from __future__ import annotations

from contextlib import contextmanager
from enum import Enum
from typing import Callable


class Languages(Enum):
    OPS = "ops"
    PRIMS = "prims"


class LanguageContext:
    def __init__(self, name: str):
        self.name = name
        self._methods: dict[str, Callable] = {}

    def register_method(self, name: str, fn: Callable) -> None:
        self._methods[name] = fn

    def get_method(self, name: str) -> Callable | None:
        return self._methods.get(name)


_registry: dict[str, LanguageContext] = {}
_stack: list[str] = []


def _name(lang) -> str:
    return lang.value if isinstance(lang, Languages) else lang


def get_langctx(lang: Languages | str | None = None) -> LanguageContext:
    name = _name(lang) if lang is not None else (_stack[-1] if _stack else Languages.OPS.value)
    if name not in _registry:
        _bootstrap()
    return _registry[name]


def resolve_method(name: str, lang: Languages | str | None = None) -> Callable:
    ctx = get_langctx(lang)
    fn = ctx.get_method(name)
    if fn is None:
        raise AttributeError(f"language {ctx.name!r} has no method {name!r}")
    return fn


@contextmanager
def langctx(lang: Languages | str):
    _stack.append(_name(lang))
    try:
        yield get_langctx(lang)
    finally:
        _stack.pop()


def _bootstrap() -> None:
    """Register the built-in languages: every public callable of a module."""
    from thunder_tpu_torch import ops as _ops
    from thunder_tpu_torch.core import prims as _prims

    for lang, mod in ((Languages.OPS, _ops), (Languages.PRIMS, _prims)):
        if lang.value in _registry:
            continue
        ctx = LanguageContext(lang.value)
        for n in dir(mod):
            f = getattr(mod, n)
            if callable(f) and not n.startswith("_") and not isinstance(f, type):
                ctx.register_method(n, f)
        _registry[lang.value] = ctx
