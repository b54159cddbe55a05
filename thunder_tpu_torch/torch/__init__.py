"""The torch front end: trace PyTorch functions into the port's IR.

The counterpart of ``thunder_tpu/torch/__init__.py``'s function path. No
bytecode interpreter: the ``__torch_function__`` protocol and a
``TorchFunctionMode`` (:class:`_TraceMode`) send every ``torch.*``,
``torch.nn.functional.*`` and tensor-method call that unmodified code makes
on a :class:`TorchProxy` into the op layer, through the function map
:data:`_torch_to_thunder_function_map`. Factories (``torch.arange``,
``torch.zeros``, ...) trace too, so ``torch.arange(n, device=x.device)``
records an ``iota`` on ``x``'s device rather than running. The routers of
:mod:`thunder_tpu_torch.ops.nn` take the same path: each carries the
standard ``has_torch_function``/``handle_torch_function`` entry, and the
map sends it to its composite, so the port's models trace as they are
written. In-place tensor methods (``add_``, ``copy_``, ``x[i] = v``) are
functionalized while tracing: the wrapper rebinds its proxy to the
out-of-place result, so traces are pure SSA.

:func:`jit` is the reference's ``jit`` (:2110): a function gives a
:class:`ThunderTorchFunction`, an ``nn.Module`` a :class:`ThunderModule`
(traced with its parameters and buffers as inputs through
:func:`trace_torch_module`; :func:`functional_call` is the same trace
inside a traced function). A call with grad enabled and an input that
requires grad runs through the torch-autograd bridge
(:mod:`thunder_tpu_torch.torch.autograd_bridge`), so ``loss.backward()``
and a stock ``torch.optim`` train through the compiled programs. While a
trace runs, a user's ``torch.autograd.Function`` records its ``forward`` as
a composite whose VJP rule is the user's ``backward``, and
``torch.utils.checkpoint.checkpoint`` records a trace-level checkpointed
region (the lookasides, patched in by :class:`_TraceMode` and restored
after). The alias audit (:func:`_alias_pattern`) keys the cache by the
inputs' overlapping storage and raises :class:`AliasedInputMutationError`
on an in-place write through an input that overlaps another. The vmap shim
and most of the map are not ported yet (ROADMAP A.7.7).

:func:`on_proxies` and :func:`on_torch` adapt torch-level functions to the
proxy-level trace transforms and back (``thunder_tpu_torch.value_and_grad``,
``checkpoint`` under ``jit``, a traced ``AdamW.update``); inside a
``value_and_grad`` region ``requires_grad`` reports True for the
differentiated inputs and everything computed from them, so code that
branches on it (``ops.nn._needs_grad``) takes its training branch.
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from thunder_tpu_torch import ThunderTPUFunction, ops
from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.devices import device_string
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from thunder_tpu_torch.ops import composites as cnn
from thunder_tpu_torch.ops import nn as tnn

__all__ = ["TorchProxy", "jit", "register_torch_op", "_torch_to_thunder_function_map",
           "on_proxies", "on_torch", "ThunderModule", "ThunderTorchFunction", "functional_call",
           "trace_torch_module", "AliasedInputMutationError"]

# ---------------------------------------------------------------------------
# the function map + dispatch
# ---------------------------------------------------------------------------

_torch_to_thunder_function_map: dict[Any, Callable] = {}


def register_torch_op(torch_fn, thunder_fn: Callable | None = None):
    """Map a torch callable to an implementation over the op layer. Usable
    as a decorator."""

    def deco(fn):
        _torch_to_thunder_function_map[torch_fn] = fn
        return fn

    return deco(thunder_fn) if thunder_fn is not None else deco


def _unwrap(x):
    if isinstance(x, TorchProxy):
        return x._p
    if isinstance(x, torch.dtype):
        return dtypes.to_dtype(x)
    if isinstance(x, torch.Size):
        return tuple(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap(i) for i in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def _wrap(x):
    if isinstance(x, TensorProxy):
        return TorchProxy(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_wrap(i) for i in x)
    if isinstance(x, dict):
        return {k: _wrap(v) for k, v in x.items()}
    return x


def _has_wrapper(args, kwargs) -> bool:
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, TorchProxy):
            return True
        if isinstance(a, (tuple, list)) and any(isinstance(i, TorchProxy) for i in a):
            return True
    return False


# routers that write some of their positional tensor arguments in place:
# router -> (fn, positions); ``fn`` takes the unwrapped arguments and
# returns ``(result, new values of those arguments)``, and the dispatch
# rebinds each argument's wrapper to its new value (functionalization)
_in_place_routers: dict[Any, tuple[Callable, tuple[int, ...]]] = {}


def _dispatch(func, args, kwargs):
    in_place = _in_place_routers.get(func)
    if in_place is not None:
        fn, positions = in_place
        check(all(i < len(args) and isinstance(args[i], TorchProxy) for i in positions),
              lambda: f"{getattr(func, '__name__', func)} writes its arguments at positions "
                      f"{positions} in place: pass them positionally, as traced tensors")
        out, new = fn(*_unwrap(args), **_unwrap(kwargs or {}))
        for i, p in zip(positions, new):
            object.__setattr__(args[i], "_p", p)
        return _wrap(out)
    mapped = _torch_to_thunder_function_map.get(func)
    if mapped is None:
        name = getattr(func, "__name__", None) or str(func)
        raise NotImplementedError(
            f"torch operation {name!r} has no thunder_tpu_torch mapping; register one with "
            f"thunder_tpu_torch.torch.register_torch_op")
    return _wrap(mapped(*_unwrap(args), **_unwrap(kwargs or {})))


class _TraceMode(TorchFunctionMode):
    """Active while a torch function is traced: routes every torch call that
    involves a :class:`TorchProxy`, and the factories, into the map; every
    other call (real tensors only) runs as it is. While it is active,
    ``torch.autograd.Function.apply`` and ``torch.utils.checkpoint.checkpoint``
    are the lookasides (:func:`_patch_trace_lookasides`): process-wide
    patches, so tracing is single-threaded, as ``torch.jit.trace`` is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_wrapper(args, kwargs) or func in _FACTORY_FUNCTIONS:
            return _dispatch(func, args, kwargs)
        return func(*args, **kwargs)

    def __enter__(self):
        _patch_trace_lookasides()
        try:
            return super().__enter__()
        except BaseException:
            _unpatch_trace_lookasides()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _unpatch_trace_lookasides()


# ---------------------------------------------------------------------------
# TorchProxy: the tensor-like wrapper
# ---------------------------------------------------------------------------

class TorchProxy:
    """Stand-in for a ``torch.Tensor`` while tracing. Holds a TensorProxy;
    torch functions, methods and operators on it record trace operations.
    In-place methods rebind ``_p`` (functionalization). ``device`` and
    ``is_cuda`` report the proxy's real device."""

    __slots__ = ("_p", "_orig_p")

    def __init__(self, p: TensorProxy):
        object.__setattr__(self, "_p", p)
        object.__setattr__(self, "_orig_p", p)   # an in-place write rebinds _p alone

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _dispatch(func, args, kwargs or {})

    # -- metadata ----------------------------------------------------------
    @property
    def shape(self) -> torch.Size:
        return torch.Size(self._p.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._p.dtype.torch

    @property
    def device(self) -> torch.device:
        return torch.device(device_string(self._p.device))

    @property
    def is_cuda(self) -> bool:
        return self._p.device.type == "cuda"

    @property
    def ndim(self) -> int:
        return self._p.ndim

    @property
    def requires_grad(self) -> bool:
        # inside a value_and_grad region: the differentiated inputs and what
        # is computed from them, as a torch tensor reports it under autograd
        from thunder_tpu_torch.core.trace import get_tracectx

        trc = get_tracectx()
        return bool(trc is not None and trc.grad_names and self._p.name in trc.grad_names)

    @property
    def grad(self):
        return None

    @property
    def T(self):
        return _wrap(self._p.T)

    @property
    def mT(self):
        return _wrap(self._p.mT)

    def size(self, dim: int | None = None):
        return self.shape if dim is None else int(self._p.shape[dim])

    def dim(self) -> int:
        return self._p.ndim

    def numel(self) -> int:
        return self._p.numel

    def element_size(self) -> int:
        return self._p.dtype.bytes

    def is_floating_point(self) -> bool:
        return self._p.dtype.is_float

    def is_contiguous(self, *args, **kwargs) -> bool:
        return True

    def __len__(self) -> int:
        check(self._p.ndim > 0, "len() of a 0-d tensor")
        return int(self._p.shape[0])

    def __repr__(self):
        return f"TorchProxy({self._p!r})"

    def __bool__(self):
        raise RuntimeError("bool() on a traced tensor is data-dependent Python control flow, "
                           "which a trace cannot hold; use torch.where")

    def __hash__(self):
        return id(self)

    # -- operators ---------------------------------------------------------
    def __add__(self, o):
        return _wrap(ops.add(self._p, _unwrap(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return _wrap(ops.sub(self._p, _unwrap(o)))

    def __rsub__(self, o):
        return _wrap(ops.sub(_unwrap(o), self._p))

    def __mul__(self, o):
        return _wrap(ops.mul(self._p, _unwrap(o)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _wrap(ops.true_divide(self._p, _unwrap(o)))

    def __rtruediv__(self, o):
        return _wrap(ops.true_divide(_unwrap(o), self._p))

    def __floordiv__(self, o):
        return _wrap(ops.floor_divide(self._p, _unwrap(o)))

    def __mod__(self, o):
        return _wrap(ops.remainder(self._p, _unwrap(o)))

    def __pow__(self, o):
        return _wrap(ops.pow(self._p, _unwrap(o)))

    def __rpow__(self, o):
        return _wrap(ops.pow(_unwrap(o), self._p))

    def __matmul__(self, o):
        return _wrap(ops.matmul(self._p, _unwrap(o)))

    def __rmatmul__(self, o):
        return _wrap(ops.matmul(_unwrap(o), self._p))

    def __neg__(self):
        return _wrap(ops.neg(self._p))

    def __abs__(self):
        return _wrap(ops.abs(self._p))

    def __invert__(self):
        return _wrap(ops.bitwise_not(self._p))

    def __and__(self, o):
        return _wrap(ops.bitwise_and(self._p, _unwrap(o)))

    def __or__(self, o):
        return _wrap(ops.bitwise_or(self._p, _unwrap(o)))

    def __eq__(self, o):
        return _wrap(ops.eq(self._p, _unwrap(o)))

    def __ne__(self, o):
        return _wrap(ops.ne(self._p, _unwrap(o)))

    def __lt__(self, o):
        return _wrap(ops.lt(self._p, _unwrap(o)))

    def __le__(self, o):
        return _wrap(ops.le(self._p, _unwrap(o)))

    def __gt__(self, o):
        return _wrap(ops.gt(self._p, _unwrap(o)))

    def __ge__(self, o):
        return _wrap(ops.ge(self._p, _unwrap(o)))

    def __getitem__(self, idx):
        return _wrap(ops.getitem(self._p, _unwrap(idx)))

    def __setitem__(self, idx, val):
        # functionalized in-place write: rebind the underlying proxy
        object.__setattr__(self, "_p", ops.setitem(self._p, _unwrap(idx), _unwrap(val)))

    # -- methods (the method table) ----------------------------------------
    def __getattr__(self, name: str):
        meth = _TENSOR_METHODS.get(name)
        if meth is None:
            raise AttributeError(f"TorchProxy has no method {name!r}; register it in "
                                 f"thunder_tpu_torch.torch._TENSOR_METHODS")
        proxy = self

        def bound(*args, **kwargs):
            out = meth(proxy._p, *_unwrap(args), **_unwrap(kwargs))
            if name.endswith("_") and not name.endswith("__"):
                # in-place: functionalize by rebinding the wrapper's proxy
                object.__setattr__(proxy, "_p", out)
                return proxy
            return _wrap(out)

        bound.__name__ = name
        return bound


# ---------------------------------------------------------------------------
# adapters: torch signatures -> ops
# ---------------------------------------------------------------------------

def _normalize_shape(shape) -> tuple:
    """f(2, 3) == f((2, 3)) == f(torch.Size([2, 3]))."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        return tuple(shape[0])
    return tuple(shape)


def _t_add(a, b, *, alpha=1, out=None):
    check(out is None, "out= is not supported (functional traces)")
    return ops.add(a, ops.mul(b, alpha) if alpha != 1 else b)


def _t_sub(a, b, *, alpha=1, out=None):
    check(out is None, "out= is not supported (functional traces)")
    return ops.sub(a, ops.mul(b, alpha) if alpha != 1 else b)


def _t_div(a, b, *, rounding_mode=None, out=None):
    if rounding_mode is None:
        return ops.true_divide(a, b)
    if rounding_mode == "floor":
        return ops.floor_divide(a, b)
    check(rounding_mode == "trunc", lambda: f"unknown rounding_mode {rounding_mode!r}")
    return ops.trunc(ops.true_divide(a, b))


def _t_transpose(a, dim0: int, dim1: int):
    perm = list(range(a.ndim))
    perm[dim0], perm[dim1] = perm[dim1], perm[dim0]
    return ops.transpose(a, perm)


def _t_permute(a, *dims):
    return ops.transpose(a, _normalize_shape(dims))


def _t_reshape(a, *shape):
    return ops.reshape(a, _normalize_shape(shape))


def _t_expand(a, *shape):
    return ops.expand(a, _normalize_shape(shape))


def _t_mean(a, dim=None, keepdim=False, *, dtype=None, out=None):
    return ops.mean(a, dim=dim, keepdim=keepdim, dtype=dtype)


def _t_sum(a, dim=None, keepdim=False, *, dtype=None, out=None):
    out_ = ops.sum(a, dim=dim, keepdim=keepdim)
    return ops.convert_element_type(out_, dtype) if dtype is not None else out_


def _t_var(a, dim=None, *, correction=None, unbiased=None, keepdim=False):
    if correction is None:
        correction = 1 if (unbiased is None or unbiased) else 0
    return ops.var(a, dim=dim, correction=correction, keepdim=keepdim)


def _t_std(a, dim=None, *, correction=None, unbiased=None, keepdim=False):
    if correction is None:
        correction = 1 if (unbiased is None or unbiased) else 0
    return ops.std(a, dim=dim, correction=correction, keepdim=keepdim)


def _t_max(a, b_or_dim=None, keepdim=False, *, dim=None, out=None):
    if dim is not None:
        b_or_dim = dim
    if b_or_dim is None:
        return ops.amax(a)
    if not isinstance(b_or_dim, int):
        return ops.maximum(a, b_or_dim)
    return ops.max_with_indices(a, b_or_dim, keepdim=keepdim)


def _t_min(a, b_or_dim=None, keepdim=False, *, dim=None, out=None):
    if dim is not None:
        b_or_dim = dim
    if b_or_dim is None:
        return ops.amin(a)
    if not isinstance(b_or_dim, int):
        return ops.minimum(a, b_or_dim)
    return ops.amin(a, dim=b_or_dim, keepdim=keepdim), ops.argmin(a, dim=b_or_dim,
                                                                   keepdim=keepdim)


def _t_clamp(a, min=None, max=None, *, out=None):
    return ops.clamp(a, min=min, max=max)


def _same_device(a, device):
    if device is not None and not isinstance(device, (dtypes.dtype, TensorProxy)):
        d = torch.device(device)
        check(d.type == a.device.type and (d.index is None or device_string(d)
                                           == device_string(a.device)),
              lambda: f"moving a traced tensor from {a.device} to {d} is not supported yet",
              NotImplementedError)


def _t_to(a, *args, **kwargs):
    """Tensor.to(dtype) / .to(device) / .to(device, dtype) / .to(other); the
    device must be the tensor's own."""
    dtype = kwargs.get("dtype")
    _same_device(a, kwargs.get("device"))
    for x in args:
        if isinstance(x, dtypes.dtype):
            dtype = x
        elif isinstance(x, TensorProxy):
            dtype = x.dtype
        else:
            _same_device(a, x)
    return ops.convert_element_type(a, dtype) if dtype is not None else a


def _t_unbind(a, dim=0):
    return tuple(ops.squeeze(s, dim) for s in ops.split(a, 1, dim=dim)) if a.shape[dim] else ()


def _t_narrow(a, dim, start, length):
    return ops.narrow(a, dim, start, length)


def _t_select(a, dim, index):
    idx = [slice(None)] * a.ndim
    idx[dim] = int(index)
    return ops.getitem(a, tuple(idx))


def _t_copy_(a, src):
    # functionalized copy_: the result is the (broadcast, cast) source
    if not isinstance(src, TensorProxy):
        return ops.full_like(a, src)
    out = src if tuple(src.shape) == tuple(a.shape) else ops.expand(src, tuple(a.shape))
    return ops.convert_element_type(out, a.dtype)


def _t_softmax(a, dim=None, *, dtype=None, _stacklevel=None):
    check(dim is not None, "softmax requires dim")
    return ops.softmax(a, dim=dim, dtype=dtype)


def _t_log_softmax(a, dim=None, *, dtype=None, _stacklevel=None):
    check(dim is not None, "log_softmax requires dim")
    return ops.log_softmax(a, dim=dim, dtype=dtype)


def _t_embedding(ids, weight, padding_idx=None, max_norm=None, norm_type=2.0,
                 scale_grad_by_freq=False, sparse=False):
    check(max_norm is None and not scale_grad_by_freq and not sparse,
          "embedding: max_norm/scale_grad_by_freq/sparse unsupported")
    return cnn.embedding(ids, weight, padding_idx=padding_idx)


def _t_layer_norm(a, normalized_shape, weight=None, bias=None, eps=1e-5):
    return cnn.layer_norm(a, tuple(normalized_shape), weight, bias, eps=eps)


def _t_rms_norm(a, normalized_shape, weight=None, eps=None):
    return cnn.rms_norm(a, weight, eps=1e-6 if eps is None else eps)


def _t_cross_entropy(logits, target, weight=None, size_average=None, ignore_index=-100,
                     reduce=None, reduction="mean", label_smoothing=0.0):
    return cnn.cross_entropy(logits, target, weight=weight, ignore_index=ignore_index,
                             reduction=reduction, label_smoothing=label_smoothing)


def _t_sdpa(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None,
            enable_gqa=False):
    check(not enable_gqa or q.shape[-3] == k.shape[-3],
          "scaled_dot_product_attention(enable_gqa=True) with fewer kv heads is not "
          "supported yet: expand k and v to the query heads", NotImplementedError)
    return cnn.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
                                            is_causal=is_causal, scale=scale)


def _t_pad(a, pad, mode="constant", value=None):
    check(mode == "constant", "only constant padding supported")
    cfg = [(0, 0, 0)] * a.ndim
    for i in range(len(pad) // 2):
        cfg[a.ndim - 1 - i] = (int(pad[2 * i]), int(pad[2 * i + 1]), 0)
    return ops.pad(a, tuple(cfg), value=0 if value is None else value)


def _factory_dtype(dtype, default):
    return dtypes.to_dtype(dtype) if dtype is not None else default


def _t_arange(start, end=None, step=1, *, dtype=None, device=None, layout=None,
              requires_grad=False, out=None, pin_memory=False):
    return ops.arange(start, end, step, dtype=dtype, device=device)


def _t_zeros(*shape, dtype=None, device=None, layout=None, requires_grad=False, out=None,
             pin_memory=False):
    return ops.full(_normalize_shape(shape), 0, dtype=_factory_dtype(dtype, dtypes.float32),
                    device=device)


def _t_ones(*shape, dtype=None, device=None, layout=None, requires_grad=False, out=None,
            pin_memory=False):
    return ops.full(_normalize_shape(shape), 1, dtype=_factory_dtype(dtype, dtypes.float32),
                    device=device)


def _t_full(shape, fill_value, *, dtype=None, device=None, layout=None, requires_grad=False,
            out=None, pin_memory=False):
    return ops.full(tuple(shape), fill_value, dtype=dtype, device=device)


def _t_like(fill):
    def like(a, *, dtype=None, device=None, **kw):
        return ops.full_like(a, fill, dtype=dtype, device=device)

    return like


def _t_cat(tensors, dim=0, *, out=None):
    return ops.cat(list(tensors), dim=dim)


def _t_stack(tensors, dim=0, *, out=None):
    return ops.stack(list(tensors), dim=dim)


def _t_where(cond, a=None, b=None):
    check(a is not None and b is not None, "only where(cond, a, b) supported")
    return ops.where(cond, a, b)


def _t_cumsum(a, dim, *, dtype=None, out=None):
    out_ = ops.cumsum(a, dim)
    return ops.convert_element_type(out_, dtype) if dtype is not None else out_


def _t_flip(a, dims):
    return ops.flip(a, dims if isinstance(dims, (tuple, list)) else (dims,))


def _t_repeat_interleave(a, repeats, dim=None):
    check(isinstance(repeats, int), "only int repeats supported")
    if dim is None:
        a, dim = ops.reshape(a, (a.numel,)), 0
    a_moved = ops.movedim(a, dim, 0) if dim != 0 else a
    out = ops.repeat_interleave_dim0(a_moved, repeats)
    return ops.movedim(out, 0, dim) if dim != 0 else out


def _simple(op):
    def fn(a, *, out=None):
        return op(a)

    return fn


def _binary(op):
    def fn(a, b, *, out=None):
        return op(a, b)

    return fn


# Factories trace unconditionally (the reference runs the deterministic ones
# eagerly as trace constants): a factory on the card must record an op on
# the card, not run one where the trace is built
_FACTORY_FUNCTIONS = {torch.arange, torch.zeros, torch.ones, torch.full, torch.empty}

for _tf, _fn in {
    torch.add: _t_add, torch.sub: _t_sub, torch.subtract: _t_sub,
    torch.mul: _binary(ops.mul), torch.multiply: _binary(ops.mul),
    torch.div: _t_div, torch.divide: _t_div, torch.true_divide: _t_div,
    torch.floor_divide: _binary(ops.floor_divide), torch.remainder: _binary(ops.remainder),
    torch.fmod: _binary(ops.fmod), torch.pow: _binary(ops.pow),
    torch.matmul: _binary(ops.matmul), torch.bmm: _binary(ops.matmul),
    torch.mm: _binary(ops.matmul), torch.outer: _binary(ops.outer),
    torch.maximum: _binary(ops.maximum), torch.minimum: _binary(ops.minimum),
    torch.max: _t_max, torch.min: _t_min,
    torch.amax: (lambda a, dim=None, keepdim=False, *, out=None:
                 ops.amax(a, dim=dim, keepdim=keepdim)),
    torch.amin: (lambda a, dim=None, keepdim=False, *, out=None:
                 ops.amin(a, dim=dim, keepdim=keepdim)),
    torch.argmax: (lambda a, dim=None, keepdim=False: ops.argmax(a, dim=dim, keepdim=keepdim)),
    torch.argmin: (lambda a, dim=None, keepdim=False: ops.argmin(a, dim=dim, keepdim=keepdim)),
    torch.mean: _t_mean, torch.sum: _t_sum, torch.var: _t_var, torch.std: _t_std,
    torch.prod: (lambda a, dim=None, keepdim=False, *, dtype=None:
                 ops.prod(a, dim=dim, keepdim=keepdim)),
    torch.all: (lambda a, dim=None, keepdim=False: ops.all_(a, dim=dim, keepdim=keepdim)),
    torch.any: (lambda a, dim=None, keepdim=False: ops.any_(a, dim=dim, keepdim=keepdim)),
    torch.abs: _simple(ops.abs), torch.neg: _simple(ops.neg), torch.exp: _simple(ops.exp),
    torch.log: _simple(ops.log), torch.log2: _simple(ops.log2), torch.log1p: _simple(ops.log1p),
    torch.expm1: _simple(ops.expm1), torch.sqrt: _simple(ops.sqrt),
    torch.rsqrt: _simple(ops.rsqrt), torch.sin: _simple(ops.sin), torch.cos: _simple(ops.cos),
    torch.tan: _simple(ops.tan), torch.tanh: _simple(ops.tanh), torch.erf: _simple(ops.erf),
    torch.sigmoid: _simple(ops.sigmoid), torch.floor: _simple(ops.floor),
    torch.ceil: _simple(ops.ceil), torch.round: _simple(ops.round),
    torch.trunc: _simple(ops.trunc), torch.sign: _simple(ops.sign),
    torch.reciprocal: _simple(ops.reciprocal), torch.isnan: _simple(ops.isnan),
    torch.isinf: _simple(ops.isinf), torch.isfinite: _simple(ops.isfinite),
    torch.logical_not: _simple(ops.logical_not), torch.logical_and: _binary(ops.logical_and),
    torch.logical_or: _binary(ops.logical_or),
    torch.eq: _binary(ops.eq), torch.ne: _binary(ops.ne), torch.lt: _binary(ops.lt),
    torch.le: _binary(ops.le), torch.gt: _binary(ops.gt), torch.ge: _binary(ops.ge),
    torch.clamp: _t_clamp, torch.clip: _t_clamp,
    torch.where: _t_where, torch.masked_fill: ops.masked_fill, torch.lerp: ops.lerp,
    torch.reshape: _t_reshape, torch.permute: _t_permute, torch.transpose: _t_transpose,
    torch.flatten: (lambda a, start_dim=0, end_dim=-1: ops.flatten(a, start_dim, end_dim)),
    torch.squeeze: (lambda a, dim=None: ops.squeeze(a, dim)),
    torch.unsqueeze: ops.unsqueeze, torch.movedim: ops.movedim,
    torch.cat: _t_cat, torch.concat: _t_cat, torch.stack: _t_stack,
    torch.split: (lambda a, split_size_or_sections, dim=0:
                  ops.split(a, split_size_or_sections, dim=dim)),
    torch.chunk: (lambda a, chunks, dim=0: ops.chunk(a, chunks, dim=dim)),
    torch.unbind: _t_unbind, torch.narrow: _t_narrow, torch.select: _t_select,
    torch.tril: (lambda a, diagonal=0, *, out=None: ops.tril(a, diagonal)),
    torch.triu: (lambda a, diagonal=0, *, out=None: ops.triu(a, diagonal)),
    torch.gather: (lambda a, dim, index, *, sparse_grad=False, out=None:
                   ops.gather(a, dim, index)),
    torch.index_select: (lambda a, dim, index: ops.take(a, index, dim=dim)),
    torch.cumsum: _t_cumsum, torch.flip: _t_flip,
    torch.repeat_interleave: _t_repeat_interleave,
    torch.softmax: _t_softmax, torch.log_softmax: _t_log_softmax,
    torch.relu: _simple(ops.relu),
    torch.clamp_min: (lambda a, m: ops.clamp(a, min=m)),
    torch.clamp_max: (lambda a, m: ops.clamp(a, max=m)),
    torch.arange: _t_arange, torch.zeros: _t_zeros, torch.ones: _t_ones, torch.full: _t_full,
    torch.empty: _t_zeros,
    torch.zeros_like: _t_like(0), torch.ones_like: _t_like(1), torch.empty_like: _t_like(0),
    torch.full_like: (lambda a, fill_value, *, dtype=None, device=None, **kw:
                      ops.full_like(a, fill_value, dtype=dtype, device=device)),
    # torch.nn.functional
    F.linear: (lambda a, w, bias=None: ops.linear(a, w, bias)),
    F.embedding: _t_embedding, F.layer_norm: _t_layer_norm, F.rms_norm: _t_rms_norm,
    F.dropout: (lambda a, p=0.5, training=True, inplace=False: cnn.dropout(a, p, training)),
    F.gelu: (lambda a, *, approximate="none": ops.gelu(a, approximate=approximate)),
    F.relu: (lambda a, inplace=False: ops.relu(a)),
    F.silu: (lambda a, inplace=False: ops.silu(a)),
    F.leaky_relu: (lambda a, negative_slope=0.01, inplace=False:
                   ops.leaky_relu(a, negative_slope)),
    F.softplus: (lambda a, beta=1.0, threshold=20.0: ops.softplus(a, beta, threshold)),
    F.sigmoid: _simple(ops.sigmoid), F.tanh: _simple(ops.tanh),
    F.softmax: _t_softmax, F.log_softmax: _t_log_softmax,
    F.scaled_dot_product_attention: _t_sdpa,
    F.cross_entropy: _t_cross_entropy,
    F.mse_loss: (lambda input, target, size_average=None, reduce=None, reduction="mean",
                 weight=None: cnn.mse_loss(input, target, reduction=reduction)),
    F.pad: _t_pad,
    # the routers of ops/nn.py record their composites; the fused norm and
    # the GEMM epilogue record their decompositions (``.meta``: add then
    # rms_norm, linear then the activation), the ops the reference's layers
    # trace, which the epilogue pass fuses again wherever no block is planned
    tnn.rms_norm: (lambda a, weight=None, eps=1e-5: cnn.rms_norm(a, weight, eps=eps)),
    tnn.rms_norm_residual: (lambda residual, a, weight=None, eps=1e-5:
                            cnn.rms_norm_residual.meta(residual, a, weight, eps=eps)),
    tnn.linear_act: (lambda a, w, bias=None, act="relu":
                     cnn.linear_act.meta(a, w, bias, act=act)),
    tnn.silu: _simple(ops.silu),
    tnn.mlp_subblock: (lambda residual, x, w_norm, w_gate, w_up, w_down, act="silu", eps=1e-5:
                       cnn.mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, act=act,
                                        eps=eps)),
    tnn.scaled_dot_product_attention: (lambda q, k, v, is_causal=False, scale=None:
                                       cnn.scaled_dot_product_attention(
                                           q, k, v, is_causal=is_causal, scale=scale)),
    tnn.sdpa_fwd: (lambda q, k, v, is_causal=False, scale=None:
                   cnn.sdpa_fwd(q, k, v, is_causal, scale)),
    tnn.ce_fwd: (lambda logits, target, ignore_index=-100:
                 cnn.ce_fwd(logits, target, ignore_index)),
    tnn.cross_entropy: (lambda logits, target, ignore_index=-100:
                        cnn.cross_entropy(logits, target, ignore_index=ignore_index)),
    tnn.fused_linear_cross_entropy: (lambda h, w, target, *, chunk=None, ignore_index=-100:
                                     cnn.fused_linear_cross_entropy(
                                         h, w, target, chunk=chunk,
                                         ignore_index=ignore_index)),
    tnn.paged_decode_attention: (lambda q, k_pages, v_pages, block_tables, lengths, scale=None:
                                 cnn.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                                            lengths, scale=scale)),
}.items():
    _torch_to_thunder_function_map[_tf] = _fn


def _t_decode_row_write(pool, rows, flat_positions):
    KV, P, ps, hd = pool.shape
    flat = cnn.decode_row_write(ops.reshape(pool, (KV, P * ps, hd)), rows, flat_positions)
    return None, (ops.reshape(flat, tuple(pool.shape)),)


def _t_attn_subblock(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                     lengths, write_pos, eps=1e-5, scale=None):
    out, kp, vp = cnn.attn_subblock(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                                    block_tables, lengths, write_pos, eps=eps, scale=scale)
    return out, (kp, vp)


def _t_decode_layer(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                    lengths, write_pos, mlp_norm, w_gate, w_up, w_down, act="silu", eps=1e-5,
                    scale=None):
    out, kp, vp = cnn.decode_layer(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                                   block_tables, lengths, write_pos, mlp_norm, w_gate, w_up,
                                   w_down, act=act, eps=eps, scale=scale)
    return out, (kp, vp)


# the serving decode's routers write the page pools in place: under a trace
# their composites return the updated pools, and the pools' wrappers are
# rebound to them
_in_place_routers.update({
    tnn.decode_row_write: (_t_decode_row_write, (0,)),
    tnn.attn_subblock: (_t_attn_subblock, (8, 9)),
    tnn.decode_layer: (_t_decode_layer, (8, 9)),
})

# tensor methods, reached through TorchProxy attributes and through the
# method descriptors when a real tensor meets a proxy
_TENSOR_METHODS: dict[str, Callable] = {
    "view": _t_reshape, "reshape": _t_reshape,
    "view_as": (lambda a, o: ops.reshape(a, tuple(o.shape))),
    "permute": _t_permute, "transpose": _t_transpose, "t": (lambda a: a.T),
    "flatten": (lambda a, start_dim=0, end_dim=-1: ops.flatten(a, start_dim, end_dim)),
    "squeeze": (lambda a, dim=None: ops.squeeze(a, dim)), "unsqueeze": ops.unsqueeze,
    "expand": _t_expand, "expand_as": (lambda a, o: ops.expand(a, tuple(o.shape))),
    "contiguous": (lambda a, *args, **kwargs: a), "clone": (lambda a, **kw: a),
    "detach": ops.detach, "to": _t_to, "type_as": (lambda a, o: ops.convert_element_type(a, o.dtype)),
    "cuda": (lambda a, *args, **kwargs: _t_to(a, "cuda")),
    "cpu": (lambda a, *args, **kwargs: _t_to(a, "cpu")),
    "float": (lambda a: ops.convert_element_type(a, dtypes.float32)),
    "double": (lambda a: ops.convert_element_type(a, dtypes.float64)),
    "half": (lambda a: ops.convert_element_type(a, dtypes.float16)),
    "bfloat16": (lambda a: ops.convert_element_type(a, dtypes.bfloat16)),
    "item": ops.item,
    "long": (lambda a: ops.convert_element_type(a, dtypes.int64)),
    "int": (lambda a: ops.convert_element_type(a, dtypes.int32)),
    "bool": (lambda a: ops.convert_element_type(a, dtypes.bool8)),
    "sum": _t_sum, "mean": _t_mean, "var": _t_var, "std": _t_std,
    "max": _t_max, "min": _t_min,
    "amax": (lambda a, dim=None, keepdim=False: ops.amax(a, dim=dim, keepdim=keepdim)),
    "amin": (lambda a, dim=None, keepdim=False: ops.amin(a, dim=dim, keepdim=keepdim)),
    "argmax": (lambda a, dim=None, keepdim=False: ops.argmax(a, dim=dim, keepdim=keepdim)),
    "argmin": (lambda a, dim=None, keepdim=False: ops.argmin(a, dim=dim, keepdim=keepdim)),
    "abs": _simple(ops.abs), "neg": _simple(ops.neg), "exp": _simple(ops.exp),
    "log": _simple(ops.log), "sqrt": _simple(ops.sqrt), "rsqrt": _simple(ops.rsqrt),
    "sin": _simple(ops.sin), "cos": _simple(ops.cos), "tanh": _simple(ops.tanh),
    "sigmoid": _simple(ops.sigmoid), "relu": _simple(ops.relu),
    "add": _t_add, "sub": _t_sub, "mul": _binary(ops.mul), "div": _t_div,
    "pow": _binary(ops.pow), "matmul": _binary(ops.matmul),
    "eq": _binary(ops.eq), "ne": _binary(ops.ne), "lt": _binary(ops.lt),
    "gt": _binary(ops.gt), "clamp": _t_clamp, "masked_fill": ops.masked_fill,
    "softmax": _t_softmax, "log_softmax": _t_log_softmax,
    "split": (lambda a, split_size, dim=0: ops.split(a, split_size, dim=dim)),
    "chunk": (lambda a, chunks, dim=0: ops.chunk(a, chunks, dim=dim)),
    "unbind": _t_unbind, "narrow": _t_narrow, "select": _t_select,
    "gather": (lambda a, dim, index: ops.gather(a, dim, index)),
    "cumsum": _t_cumsum, "flip": _t_flip, "repeat_interleave": _t_repeat_interleave,
    "new_zeros": (lambda a, *shape, dtype=None, **kw:
                  ops.full(_normalize_shape(shape), 0, dtype=dtype or a.dtype, device=a.device)),
    # in-place (functionalized by rebinding)
    "add_": _t_add, "sub_": _t_sub, "mul_": _binary(ops.mul), "div_": _t_div,
    "clamp_": _t_clamp, "masked_fill_": ops.masked_fill, "copy_": _t_copy_,
    "zero_": (lambda a: ops.zeros_like(a)), "fill_": (lambda a, v: ops.full_like(a, v)),
    "exp_": _simple(ops.exp), "neg_": _simple(ops.neg),
}

for _name, _impl in _TENSOR_METHODS.items():
    _desc = getattr(torch.Tensor, _name, None)
    if _desc is not None and _desc not in _torch_to_thunder_function_map:
        _torch_to_thunder_function_map[_desc] = _impl
for _dunder, _op in {"__add__": ops.add, "__sub__": ops.sub, "__mul__": ops.mul,
                     "__truediv__": ops.true_divide, "__matmul__": ops.matmul,
                     "__pow__": ops.pow}.items():
    _torch_to_thunder_function_map[getattr(torch.Tensor, _dunder)] = _op
    _torch_to_thunder_function_map[getattr(torch.Tensor, "__r" + _dunder[2:])] = \
        (lambda op: lambda a, b: op(b, a))(_op)


# ---------------------------------------------------------------------------
# adapters between torch-level functions and the proxy-level transforms
# ---------------------------------------------------------------------------

def _unwrap_out(out):
    return tree_map(lambda x: x._p if isinstance(x, TorchProxy) else x, out,
                    is_leaf=lambda x: isinstance(x, (TorchProxy, Proxy)))


def on_proxies(fn):
    """A torch-level function (it takes and returns :class:`TorchProxy`
    trees) as a function of TensorProxies, for the trace transforms of
    :mod:`thunder_tpu_torch.core`."""

    def inner(*args, **kwargs):
        return _unwrap_out(fn(*_wrap(args), **_wrap(kwargs)))

    return inner


def on_torch(transformed):
    """A transform's TensorProxy-level function as a torch-level one: the
    inverse adapter of :func:`on_proxies`."""

    def outer(*args, **kwargs):
        return _wrap(transformed(*_unwrap_out(args), **_unwrap_out(kwargs)))

    return outer


# ---------------------------------------------------------------------------
# the torch.autograd.Function and torch.utils.checkpoint lookasides
# ---------------------------------------------------------------------------

class _TraceFunctionCtx:
    """Stand-in for ``FunctionCtx`` while a user's ``torch.autograd.Function``
    is traced: records what ``save_for_backward`` saves and the tensors set
    as plain attributes (``ctx.x = x``); the same object is handed to the
    user's ``backward`` with those swapped for the values the pullback
    replays."""

    def __init__(self, needs_input_grad=()):
        object.__setattr__(self, "_tensor_attrs", {})
        self._to_save = ()
        self._materialize_grads = True
        self.needs_input_grad = tuple(needs_input_grad)

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if not name.startswith("_") and name != "needs_input_grad":
            if isinstance(value, TorchProxy):
                self._tensor_attrs[name] = value
            else:
                self._tensor_attrs.pop(name, None)

    def save_for_backward(self, *tensors):
        self._to_save = tensors

    def save_for_forward(self, *tensors):   # forward-mode saves: unused here
        pass

    @property
    def saved_tensors(self):
        return tuple(self._to_save)

    def mark_non_differentiable(self, *tensors):
        pass

    def mark_dirty(self, *tensors):
        pass

    def set_materialize_grads(self, value: bool):
        self._materialize_grads = bool(value)


def _to_torch_value(v):
    """A traced region's input as user torch code sees it: a TensorProxy
    becomes its :class:`TorchProxy`."""
    if isinstance(v, TensorProxy):
        return TorchProxy(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_to_torch_value(i) for i in v)
    if isinstance(v, dict):
        return {k: _to_torch_value(x) for k, x in v.items()}
    return v


_autograd_fn_ids = itertools.count()


def _trace_autograd_function(cls, args, kwargs):
    """``MyFn.apply(*args)`` while tracing: the user's ``forward`` becomes a
    composite symbol (its traced ops as subsymbols, so executors claim into
    it), and the user's ``backward`` is registered as that symbol's VJP rule:
    the gradients follow the user's derivative, not autodiff of the
    forward."""
    from thunder_tpu_torch.core.symbol import Symbol
    from thunder_tpu_torch.core.trace import get_tracectx
    from thunder_tpu_torch.core.transforms import (
        _trace_subfn, eval_trace, promote_free_vars, register_vjp)

    trc = get_tracectx()
    check(trc is not None, "autograd.Function tracing requires an active trace")
    core_args = _unwrap(args)
    core_kwargs = _unwrap(kwargs or {})

    # ctx.needs_input_grad: a real tensor's requires_grad; a traced tensor's
    # where the trace tracks gradients (a grad region, the bridge), else
    # whether it is a float tensor
    def _arg_needs_grad(orig, a):
        if isinstance(orig, torch.Tensor):
            return bool(orig.requires_grad)
        if isinstance(orig, TorchProxy) and trc.grad_names is not None:
            return orig.requires_grad
        return isinstance(a, TensorProxy) and a.dtype.is_inexact

    needs = tuple(_arg_needs_grad(orig, a) for orig, a in zip(args, core_args))
    # new-style Functions define forward without ctx, plus a setup_context
    base_setup = getattr(torch.autograd.Function, "setup_context", None)
    new_style = base_setup is not None and getattr(cls, "setup_context", None) is not base_setup
    holder: dict = {}

    def _fwd(*a, **kw):
        ctx = _TraceFunctionCtx(needs)
        holder["ctx"] = ctx
        wa = tuple(_to_torch_value(x) for x in a)
        wkw = {k: _to_torch_value(v) for k, v in kw.items()}
        with _TraceMode():
            if new_style:
                out = cls.forward(*wa, **wkw)
                cls.setup_context(ctx, tuple(wa), out)
            else:
                out = cls.forward(ctx, *wa, **wkw)
        holder["attr_names"] = list(ctx._tensor_attrs)
        saved = (tuple(_unwrap(t) for t in ctx._to_save)
                 + tuple(_unwrap(v) for v in ctx._tensor_attrs.values()))
        return _unwrap(out), saved

    inner, inner_inputs, _ = _trace_subfn(_fwd, core_args, core_kwargs)
    frees = promote_free_vars(inner, inner_inputs)
    sid = f"autograd_function_{cls.__name__}_{next(_autograd_fn_ids)}"

    def meta(*ps):
        out, _saved = eval_trace(inner, *ps)
        return out

    sym = Symbol(f"autograd_function_{cls.__name__}", meta, id=sid)

    # each positional arg of apply's position among the proxy inputs (the
    # user's backward returns one gradient per positional arg)
    arg_to_proxy_idx: dict[int, int] = {}
    pi = 0
    for i, a in enumerate(core_args):
        leaves = tree_flatten(a)[0]
        if len(leaves) == 1 and isinstance(leaves[0], Proxy):
            arg_to_proxy_idx[i] = pi
        pi += sum(1 for leaf in leaves if isinstance(leaf, Proxy))

    @register_vjp(sid)
    def _fn_vjp(*rargs):
        out, saved = eval_trace(inner, *rargs)

        def pullback(g):
            out_flat = [o for o in tree_flatten(out)[0] if isinstance(o, Proxy)]
            gs = list(g) if isinstance(g, (tuple, list)) else [g]
            ctx = holder["ctx"]
            if ctx._materialize_grads:
                gs = [ops.full(tuple(o.shape), 0.0, dtype=o.dtype, device=o.device)
                      if gg is None else gg for gg, o in zip(gs, out_flat)]
            attr_names = holder.get("attr_names", [])
            n_save = len(saved) - len(attr_names)
            ctx._to_save = tuple(_wrap(x) for x in saved[:n_save])
            for name, val in zip(attr_names, saved[n_save:]):
                object.__setattr__(ctx, name, _wrap(val))
            with _TraceMode():
                gin = cls.backward(ctx, *[_wrap(gg) for gg in gs])
            gin = gin if isinstance(gin, tuple) else (gin,)
            return [(rargs[arg_to_proxy_idx[i]], _unwrap(gg)) for i, gg in enumerate(gin)
                    if gg is not None and i in arg_to_proxy_idx]

        return out, pullback

    proxy_args = [a for a in tree_flatten((core_args, core_kwargs))[0]
                  if isinstance(a, Proxy)] + frees
    return _wrap(sym(*proxy_args))


# checkpoint()'s own keyword arguments: every other one goes to ``function``
_CKPT_CONTROL_KWARGS = frozenset(("context_fn", "determinism_check", "debug", "early_stop",
                                  "preserve_rng_state"))


def _traced_checkpoint(function, *args, use_reentrant=None, **ckpt_kwargs):
    """``torch.utils.checkpoint.checkpoint`` while tracing: on traced tensors
    a trace-level checkpointed region (``core.rematerialization``), whose
    backward recomputes the region instead of saving its intermediates; on
    real tensors the original."""
    if not _has_wrapper(args, ckpt_kwargs):
        return _ORIG_CHECKPOINT(function, *args, use_reentrant=use_reentrant, **ckpt_kwargs)
    from thunder_tpu_torch.core.rematerialization import checkpoint_region

    fn_kwargs = {k: v for k, v in ckpt_kwargs.items() if k not in _CKPT_CONTROL_KWARGS}
    core_args = _unwrap(args)
    core_kw = {k: _unwrap(v) for k, v in fn_kwargs.items()}
    kw_keys = list(core_kw)

    # the function's keyword arguments become region inputs too, so a traced
    # keyword (a mask) takes part in the region
    def inner(*ps):
        a, kvals = ps[:len(core_args)], ps[len(core_args):]
        with _TraceMode():
            return _unwrap(function(*(_to_torch_value(x) for x in a),
                                    **{k: _to_torch_value(v) for k, v in zip(kw_keys, kvals)}))

    return _wrap(checkpoint_region(inner)(*core_args, *core_kw.values()))


# the patch state: a depth count makes nested _TraceMode entries idempotent
_ORIG_FUNCTION_APPLY: tuple | None = None
_ORIG_CHECKPOINT = None
_CHECKPOINT_CELL = None   # the closure cell of checkpoint's _disable_dynamo wrapper
_lookaside_patch_depth = 0


def _patch_trace_lookasides():
    global _ORIG_FUNCTION_APPLY, _ORIG_CHECKPOINT, _CHECKPOINT_CELL, _lookaside_patch_depth
    if _lookaside_patch_depth == 0:
        import torch.utils.checkpoint as tuc

        for klass in torch.autograd.Function.__mro__:
            if "apply" in klass.__dict__:
                _ORIG_FUNCTION_APPLY = (klass, klass.__dict__["apply"])
                break
        orig_desc = _ORIG_FUNCTION_APPLY[1]

        def _traced_apply(cls, *args, **kwargs):
            if not _has_wrapper(args, kwargs):
                return orig_desc.__get__(None, cls)(*args, **kwargs)
            if cls is tuc.CheckpointFunction:
                # the reentrant form: CheckpointFunction.apply(fn, preserve_rng_state, *args)
                return _traced_checkpoint(args[0], *args[2:])
            return _trace_autograd_function(cls, args, kwargs)

        torch.autograd.Function.apply = classmethod(_traced_apply)
        # torch.utils.checkpoint.checkpoint is a _disable_dynamo wrapper
        # closing over the implementation in a ``fn`` cell: swapping the cell
        # reroutes every early-bound reference to the wrapper too
        # (``from torch.utils.checkpoint import checkpoint`` at import time)
        wrapper = tuc.checkpoint
        _CHECKPOINT_CELL = None
        freevars = getattr(wrapper.__code__, "co_freevars", ())
        if "fn" in freevars and wrapper.__closure__ is not None:
            cell = wrapper.__closure__[freevars.index("fn")]
            if callable(cell.cell_contents):
                _CHECKPOINT_CELL = cell
        if _CHECKPOINT_CELL is not None:
            _ORIG_CHECKPOINT = _CHECKPOINT_CELL.cell_contents
            _CHECKPOINT_CELL.cell_contents = _traced_checkpoint
        else:   # no wrapper: patch the module attribute
            _ORIG_CHECKPOINT = wrapper
            tuc.checkpoint = _traced_checkpoint
    _lookaside_patch_depth += 1


def _unpatch_trace_lookasides():
    global _lookaside_patch_depth
    _lookaside_patch_depth -= 1
    if _lookaside_patch_depth == 0:
        import torch.utils.checkpoint as tuc

        klass, desc = _ORIG_FUNCTION_APPLY
        if klass is torch.autograd.Function:
            torch.autograd.Function.apply = desc
        else:   # it was inherited: remove the patch to restore inheritance
            del torch.autograd.Function.apply
        if _CHECKPOINT_CELL is not None:
            _CHECKPOINT_CELL.cell_contents = _ORIG_CHECKPOINT
        else:
            tuc.checkpoint = _ORIG_CHECKPOINT


# ---------------------------------------------------------------------------
# the alias audit: inputs that share storage
# ---------------------------------------------------------------------------

class AliasedInputMutationError(RuntimeError):
    """An in-place op wrote through an input whose storage overlaps another
    input's. The functionalized trace treats the two as independent tensors,
    so the write would not show through the other view, as it would in
    eager torch: the reference refuses it too."""


def _alias_spans(flat):
    """Byte spans of the tensor leaves: ``(leaf index, storage pointer,
    start byte, end byte)``. An empty tensor has none."""
    from torch._subclasses.fake_tensor import FakeTensor

    spans = []
    for i, t in enumerate(flat):
        if (not isinstance(t, torch.Tensor) or isinstance(t, FakeTensor) or t.numel() == 0
                or t.device.type == "meta"):
            continue   # no storage to share
        ptr = t.untyped_storage().data_ptr()
        esz = t.element_size()
        start = t.storage_offset() * esz
        extent = 1 + sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride()))
        spans.append((i, ptr, start, start + extent * esz))
    return spans


def _alias_pattern(flat):
    """The call's alias pattern ``(shared_groups, overlap_indices)``: the
    groups of leaf indices that share one storage, and the leaves whose
    bytes intersect another leaf's (mutating one of those is the hole)."""
    by_ptr: dict = {}
    for rec in _alias_spans(flat):
        by_ptr.setdefault(rec[1], []).append(rec)
    groups = []
    overlap: set = set()
    for recs in by_ptr.values():
        if len(recs) < 2:
            continue
        groups.append(tuple(sorted(r[0] for r in recs)))
        for a in recs:
            for b in recs:
                if a[0] != b[0] and a[2] < b[3] and b[2] < a[3]:
                    overlap.add(a[0])
    return tuple(sorted(groups)), frozenset(overlap)


def _alias_key(overlap) -> tuple:
    """The overlap set as guard-key material (empty for none)."""
    return ("alias", tuple(sorted(overlap))) if overlap else ()


def _audit_aliased_mutation(wargs, wkw, overlap_indices) -> None:
    """Raise where an input in ``overlap_indices`` (flat indices of
    ``(args, kwargs)``) was written in place while the trace ran."""
    if not overlap_indices:
        return
    wflat, _ = tree_flatten((wargs, wkw))
    for i, w in enumerate(wflat):
        if isinstance(w, TorchProxy) and i in overlap_indices and w._p is not w._orig_p:
            raise AliasedInputMutationError(
                f"input #{i} was mutated in-place but overlaps another input's storage "
                f"(indices {sorted(overlap_indices)}); the compiled trace cannot propagate the "
                f"write to the other view. Pass .clone()d tensors or make the op out-of-place.")


# the overlap set of the call being traced (the audit's input)
_INPUT_OVERLAP: ContextVar[frozenset] = ContextVar("input_overlap", default=frozenset())


@contextmanager
def _auditing(overlap):
    tok = _INPUT_OVERLAP.set(overlap)
    try:
        yield
    finally:
        _INPUT_OVERLAP.reset(tok)


# ---------------------------------------------------------------------------
# tracing a module: its parameters and buffers as inputs
# ---------------------------------------------------------------------------

def _resolve(module: torch.nn.Module, qual: str):
    parts = qual.split(".")
    mod = module
    for p in parts[:-1]:
        mod = getattr(mod, p)
    return mod, parts[-1]


class _patched_module:
    """Put :class:`TorchProxy` stand-ins in place of a module's parameters
    and buffers for one trace, and the real ones back after."""

    def __init__(self, module, wrapped_params: dict, wrapped_buffers: dict):
        self.module = module
        self.wp = wrapped_params
        self.wb = wrapped_buffers
        self.saved: list = []

    def __enter__(self):
        for qual, w in list(self.wp.items()) + list(self.wb.items()):
            mod, leaf = _resolve(self.module, qual)
            for d_name in ("_parameters", "_buffers"):
                d = getattr(mod, d_name)
                if leaf in d:
                    self.saved.append((d, leaf, d[leaf]))
                    d[leaf] = w
                    break
        return self

    def __exit__(self, *exc):
        for d, leaf, orig in reversed(self.saved):
            d[leaf] = orig
        return False


def trace_torch_module(module: torch.nn.Module, params: dict, buffers: dict, args: tuple,
                       kwargs: dict, arg_overlap=frozenset()):
    """Run ``module.forward`` over proxies: ``params`` and ``buffers`` map
    qualified names to TensorProxies, ``args``/``kwargs`` hold TensorProxy
    leaves. Returns ``(output, mutated_buffers)``: a buffer the module writes
    in place comes back as an output (the epilogue), for the caller to write
    into the live module. ``arg_overlap``: the flat indices of ``(args,
    kwargs)`` whose storage overlaps another input's; an in-place write
    through one of them raises."""
    wp = {k: TorchProxy(v) if isinstance(v, TensorProxy) else v for k, v in params.items()}
    wb = {k: TorchProxy(v) if isinstance(v, TensorProxy) else v for k, v in buffers.items()}
    with _patched_module(module, wp, wb), _TraceMode():
        wa = _wrap(args)
        wk = _wrap(kwargs or {})
        out = module(*wa, **wk)
        _audit_aliased_mutation(wa, wk, arg_overlap)
    mutated = {k: w._p for k, w in wb.items()
               if isinstance(w, TorchProxy) and w._p is not w._orig_p}
    return _unwrap_out(out), mutated


def _tied_names(module: torch.nn.Module) -> dict[str, str]:
    """Each duplicate name of a shared parameter or buffer (GPT-2's
    ``lm_head.weight`` is ``transformer.wte.weight``) mapped to its
    canonical name, the one ``named_parameters()`` keeps."""
    tied: dict[str, str] = {}
    by_id: dict[int, str] = {}
    for k, v in (list(module.named_parameters(remove_duplicate=False))
                 + list(module.named_buffers(remove_duplicate=False))):
        if id(v) in by_id:
            tied[k] = by_id[id(v)]
        else:
            by_id[id(v)] = k
    return tied


def _route_tied(tied: dict, params: dict, buffers: dict) -> None:
    """Point every duplicate site at its canonical entry, so both uses of a
    tied weight trace to one input (and its gradient sums both)."""
    for dup, canon in tied.items():
        if dup not in params and dup not in buffers:
            if canon in params:
                params[dup] = params[canon]
            elif canon in buffers:
                buffers[dup] = buffers[canon]


def functional_call(module: torch.nn.Module, params_and_buffers: dict, args: tuple = (),
                    kwargs: dict | None = None, *, training: bool | None = None):
    """Call ``module`` inside a traced function with ``params_and_buffers``
    (traced tensors, by qualified name) in place of its own, the traceable
    ``torch.func.functional_call``: under ``jit`` and
    ``thunder_tpu_torch.grad`` the parameters are explicit, differentiable
    inputs. Tied weights route to their canonical name. Returns
    ``(output, mutated_buffers)``."""
    buffer_names = {k for k, _ in module.named_buffers()}
    pab = _unwrap(dict(params_and_buffers))
    params = {k: v for k, v in pab.items() if k not in buffer_names}
    buffers = {k: v for k, v in pab.items() if k in buffer_names}
    _route_tied(_tied_names(module), params, buffers)
    prev = module.training
    if training is not None:
        module.train(training)
    try:
        out, mutated = trace_torch_module(module, params, buffers, _unwrap(tuple(args)),
                                          _unwrap(kwargs or {}))
    finally:
        module.train(prev)
    return _wrap(out), _wrap(mutated)


# ---------------------------------------------------------------------------
# ThunderModule
# ---------------------------------------------------------------------------

def _module_device(module: torch.nn.Module):
    """The device of a module's state (its first parameter or buffer), None
    for a module without state."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return None


class ThunderModule:
    """``jit`` of an ``nn.Module`` (the reference's ``ThunderModule``). The
    port keeps no copy of the module's state: every call reads the live
    module's parameters and buffers, so an optimizer stepping them in place
    and ``load_state_dict`` on either object are seen by the next call. A
    buffer the module writes in place is written back into the live module
    after each call (the reference's epilogue).

    A call with grad enabled and a parameter or input that requires grad
    runs through the torch-autograd bridge: the output is tracked by torch's
    autograd, and ``backward()`` accumulates into each parameter's
    ``.grad``. Any other call runs the grad-free program of the module's
    functional form. Either cache is keyed by the training flag, the
    state's shapes, dtypes and devices, the inputs and their alias pattern.
    ``torch_autograd=False`` takes the grad-free program always.

    Transforms may shadow parameters and buffers through
    ``_overrides_parameters``/``_overrides_buffers`` (name -> tensor): the
    grad-free program reads an override in place of the live tensor, a
    written buffer that is overridden updates its override, and
    ``named_parameters``/``state_dict`` report the overrides. A module with
    overridden parameters never takes the bridge."""

    def __init__(self, module: torch.nn.Module, **jit_kwargs):
        check(jit_kwargs.get("seq_buckets") is None,
              "jit(module, seq_buckets=...) is not ported yet (ROADMAP A.7.7)",
              NotImplementedError)
        jit_kwargs.pop("seq_buckets", None)
        self._torch_module = module
        self._tied = _tied_names(module)
        self._overrides_parameters: dict = {}
        self._overrides_buffers: dict = {}
        self._training = module.training
        self._grad_sync = True
        self._torch_autograd = jit_kwargs.pop("torch_autograd", True)
        self._autograd_cache: dict = {}
        self._device = jit_kwargs.pop("device", None)
        jit_kwargs.setdefault("fn_name", type(module).__name__)
        self._jfn = ThunderTPUFunction(self._functional, **jit_kwargs)

    def _functional(self, params, buffers, training, args, kwargs):
        """The traced function: the module over its state as inputs."""
        module = self._torch_module
        params, buffers = dict(params), dict(buffers)
        _route_tied(self._tied, params, buffers)
        prev = module.training
        module.train(training)
        try:
            return trace_torch_module(module, params, buffers, args, kwargs,
                                      arg_overlap=_INPUT_OVERLAP.get())
        finally:
            module.train(prev)

    def _state(self):
        module = self._torch_module
        return list(module.named_parameters()), list(module.named_buffers())

    def _write_back(self, mutated: dict) -> None:
        if mutated:
            buffers = dict(self._torch_module.named_buffers())
            with torch.no_grad():
                for name, val in mutated.items():
                    if name in self._overrides_buffers:
                        self._overrides_buffers[name] = val
                    else:
                        buffers[name].copy_(val)

    def __call__(self, *args, **kwargs):
        from thunder_tpu_torch.torch.autograd_bridge import call_with_torch_autograd

        self._jfn.device = self._device if self._device is not None else _module_device(
            self._torch_module)
        flat, treedef = self._jfn._flatten(args, kwargs)   # numpy leaves onto the device
        args, kwargs = tree_unflatten(treedef, flat)
        params, buffers = self._state()
        if self._torch_autograd and torch.is_grad_enabled() and not self._overrides_parameters \
                and (any(t.requires_grad for _, t in params)
                     or any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat)):
            check(not self._jfn.transforms,
                  "jit(module, transforms=...) through the torch-autograd bridge is not "
                  "ported: call it under torch.no_grad(), or pass torch_autograd=False",
                  NotImplementedError)
            return call_with_torch_autograd(self, args, kwargs)
        p, b = dict(params), dict(buffers)
        p.update(self._overrides_parameters)
        b.update(self._overrides_buffers)
        overlap = _alias_pattern(flat)[1]
        with _auditing(overlap):
            state_args = (p, b, self._training, args, kwargs)
            entry, jflat = self._jfn._entry_for(state_args, {}, _alias_key(overlap))
        out, mutated = self._jfn._run_contained(entry, [jflat[i] for i in entry.tensor_indices],
                                                call=(state_args, {}))
        self._write_back(mutated)
        return out

    # -- mode and state -----------------------------------------------------
    def train(self, mode: bool = True):
        self._training = mode
        return self

    def eval(self):
        return self.train(False)

    @property
    def training(self) -> bool:
        return self._training

    def named_parameters(self):
        """The live module's parameters (tied duplicates once), each
        override in place of its parameter."""
        for k, v in self._torch_module.named_parameters():
            yield k, self._overrides_parameters.get(k, v)

    def parameters_dict(self) -> dict:
        return dict(self.named_parameters())

    def update_parameters(self, new_params: dict) -> None:
        """Write trained parameter values into the live module."""
        live = self.parameters_dict()
        with torch.no_grad():
            for k, v in new_params.items():
                live[k].copy_(v)

    def state_dict(self) -> dict:
        """Copies of the parameters (tied duplicates once) and buffers, the
        overrides in place of what they shadow."""
        params, buffers = self._state()
        over = {**self._overrides_parameters, **self._overrides_buffers}
        return {k: over.get(k, v).detach().clone() for k, v in params + buffers}

    def load_state_dict(self, sd: dict, strict: bool = True) -> None:
        params, buffers = self._state()
        live = dict(params + buffers)
        for k, v in sd.items():
            if k not in live:
                check(not strict, lambda: f"unexpected key {k!r} in state_dict")
                continue
            with torch.no_grad():
                live[k].copy_(torch.as_tensor(v).to(live[k].dtype))
        if strict:
            missing = set(live) - set(sd)
            check(not missing, lambda: f"missing keys in state_dict: {sorted(missing)}")

    @contextmanager
    def no_sync(self):
        """Gradient accumulation without synchronization (the reference's
        ``ThunderModule.no_sync``): through the bridge every ``backward()``
        accumulates into ``.grad`` as torch does, so microbatches accumulate
        there; this sets ``_grad_sync`` for the distributed transforms that
        read it (ROADMAP A.2)."""
        self._grad_sync = False
        try:
            yield
        finally:
            self._grad_sync = True


# ---------------------------------------------------------------------------
# jit
# ---------------------------------------------------------------------------

class ThunderTorchFunction(ThunderTPUFunction):
    """``jit`` of a torch-calling function. The alias pattern of each call's
    inputs joins the guard key and arms the audit of the trace; a call with
    grad enabled and an input that requires grad runs through the
    torch-autograd bridge (unless ``torch_autograd=False``): its outputs are
    tracked by torch's autograd and ``backward()`` runs the compiled
    backward."""

    def __init__(self, traced, torch_fn, *, torch_autograd: bool = True, **jit_kwargs):
        super().__init__(traced, **jit_kwargs)
        self._torch_fn = torch_fn if torch_autograd else None
        self._autograd_cache: dict = {}

    def _entry_for(self, args, kwargs, extra: tuple = ()):
        overlap = _alias_pattern(tree_flatten((args, kwargs))[0])[1]
        with _auditing(overlap):
            return super()._entry_for(args, kwargs, extra + _alias_key(overlap))

    def __call__(self, *args, **kwargs):
        if self._torch_fn is not None and torch.is_grad_enabled():
            flat, treedef = self._flatten(args, kwargs)
            if any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
                from thunder_tpu_torch.torch.autograd_bridge import (
                    call_function_with_torch_autograd)

                check(not self.transforms,
                      "jit(fn, transforms=...) through the torch-autograd bridge is not ported: "
                      "call it under torch.no_grad(), or pass torch_autograd=False",
                      NotImplementedError)

                return call_function_with_torch_autograd(self, *tree_unflatten(treedef, flat))
        return super().__call__(*args, **kwargs)


def jit(fn, **jit_kwargs):
    """Compile a torch-calling function (:class:`ThunderTorchFunction`: its
    tensor arguments are traced as :class:`TorchProxy`\\ s under
    :class:`_TraceMode`) or an ``nn.Module`` (:class:`ThunderModule`)."""
    if isinstance(fn, torch.nn.Module):
        return ThunderModule(fn, **jit_kwargs)

    def traced(*args, **kwargs):
        with _TraceMode():
            wargs, wkw = _wrap(args), _wrap(kwargs)
            out = fn(*wargs, **wkw)
            _audit_aliased_mutation(wargs, wkw, _INPUT_OVERLAP.get())
        return _unwrap_out(out)

    traced.__name__ = getattr(fn, "__name__", "fn")
    jit_kwargs.setdefault("fn_name", traced.__name__)
    return ThunderTorchFunction(traced, fn, **jit_kwargs)
