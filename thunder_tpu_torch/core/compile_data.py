"""Compile options: free-form flags that the passes query by name.

The counterpart of ``thunder_tpu/core/compile_data.py``.
``thunder_tpu_torch.jit(fn, **compile_options)`` accepts free-form options
(``block_fusion``, ``horizontal_fusion``, ``fused_optimizer``,
``epilogue_fusion``); a pass reads one with
:func:`get_compile_option`, and every read registers the option with its
description, so ``thunder_tpu_torch.last_compile_options`` reports which
options a compile read and which passed options nothing read.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Any

_compile_ctx: ContextVar = ContextVar("thunder_tpu_torch_compile_ctx", default=None)


class CompileContext:
    """The options passed to ``jit`` and the options the passes read during
    one compile. ``executors`` is the compiling function's executor stack:
    the planner that runs before autodiff (``plan_blocks_for_autodiff``)
    reads it here to ask which composites the stack claims."""

    __slots__ = ("options", "queried", "executors")

    def __init__(self, options: dict[str, Any], executors: Any = None):
        self.options = dict(options)
        self.queried: dict[str, str] = {}   # name -> description
        self.executors = executors


class compile_context:
    def __init__(self, ctx: CompileContext):
        self.ctx = ctx
        self.token = None

    def __enter__(self):
        self.token = _compile_ctx.set(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _compile_ctx.reset(self.token)
        return False


def get_compile_data() -> CompileContext | None:
    return _compile_ctx.get()


def get_compile_option(name: str, description: str, default: Any = None) -> Any:
    """A compile option's value (``default`` outside a compile or where it
    was not passed). The read is registered with its description."""
    ctx = _compile_ctx.get()
    if ctx is None:
        return default
    ctx.queried[name] = description
    return ctx.options.get(name, default)


def used_and_unused_options(ctx: CompileContext) -> tuple[dict, set]:
    """(the options read, with their descriptions; the names passed but
    never read)."""
    unused = set(ctx.options) - set(ctx.queried)
    return dict(ctx.queried), unused
