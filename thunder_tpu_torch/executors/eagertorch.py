"""The always-on torch executor: one torch call per prim.

The counterpart of ``thunder_tpu/executors/eagerjax.py``: every prim the
port's traces hold runs here, op by op, on whatever device its tensors live
on, so every trace can run whether or not an operator executor claims
anything. ``dot_general`` is ``torch.matmul`` (``a @ w.T`` for the
``linear`` contraction, the same ATen path ``F.linear`` takes without a
bias) or ``torch.einsum`` for any other layout: a plain product outside any
kernel of the port. The prologue's guard prims raise :class:`GuardFailure`.

Six composites run as one implementation each rather than through their
decomposition: ``nn.one_hot`` (built in its int32 output dtype, with no
int64 intermediate), and, for tensors off the card, the plain versions of
the kernels' composites ``nn.sdpa_bwd``, ``nn.mlp_subblock``,
``nn.mlp_subblock_bwd``, ``optim.adamw_step`` and ``optim.fused_adamw``,
the last through the card's claim's own callable
(``ops.optim.fused_adamw_into``), which on the CPU runs the plain version
into the donated inputs the claim pass marks.
"""

from __future__ import annotations

import operator
from numbers import Number

import torch
import torch.nn.functional as F

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.devices import device_string
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.symbol import Symbol
from thunder_tpu_torch.executors import OperatorExecutor, register_executor


class GuardFailure(AssertionError):
    """Raised by the prologue's guard prims when a call's inputs do not match
    a cache entry."""


ex = OperatorExecutor("torch")
register_executor(ex, always=True)

_impls: dict = {}


def impl(prim_id):
    def deco(fn):
        _impls[prim_id] = fn
        return fn

    return deco


def get_eager_impl(sym: Symbol):
    return _impls.get(sym.id)


# -- prologue guards ----------------------------------------------------------

def _guard(cond, msg):
    if not cond:
        raise GuardFailure(msg)


@impl(PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA)
def _check_tensor(t, shape, dtype, device_str):
    _guard(isinstance(t, torch.Tensor), f"expected a tensor, got {type(t)}")
    _guard(tuple(t.shape) == tuple(shape), f"shape changed: expected {shape}, got {tuple(t.shape)}")
    _guard(t.dtype == dtype.torch, f"dtype changed: expected {dtype}, got {t.dtype}")
    _guard(device_string(t.device) == device_str,
           f"device changed: expected {device_str}, got {t.device}")


@impl(PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE)
def _check_number(n, v):
    _guard(type(n) is type(v) and n == v, f"number changed: expected {v!r}, got {n!r}")


@impl(PrimIDs.CHECK_STRING_VALUE)
def _check_string(s, v):
    _guard(s == v, f"string changed: expected {v!r}, got {s!r}")


@impl(PrimIDs.CHECK_LITERAL_LIKE)
def _check_literal(x, v):
    _guard(type(x) is type(v), f"input type changed: expected {type(v)}, got {type(x)}")


# the prims whose implementation below may return its input itself or a view
# of it (an in-place write of the input shows through such an output)
MAY_ALIAS = frozenset({
    PrimIDs.CONVERT_ELEMENT_TYPE, PrimIDs.DETACH, PrimIDs.BROADCAST_IN_DIM, PrimIDs.RESHAPE,
    PrimIDs.SLICE, PrimIDs.SQUEEZE, PrimIDs.TRANSPOSE, PrimIDs.DYNAMIC_SLICE,
    PrimIDs.OPT_BARRIER})


# -- dtype, creation ----------------------------------------------------------

@impl(PrimIDs.CONVERT_ELEMENT_TYPE)
def _convert_element_type(a, dtype):
    return a.to(dtype.torch)


@impl(PrimIDs.DETACH)
def _detach(a):
    return a.detach()


@impl(PrimIDs.FULL)
def _full(shape, fill_value, dtype, device=None):
    return torch.full(tuple(shape), fill_value, dtype=dtype.torch, device=device)


@impl(PrimIDs.IOTA)
def _iota(length, *, start=0, step=1, dtype=dtypes.int64, device=None):
    if all(isinstance(x, int) for x in (start, step)):
        return torch.arange(start, start + length * step, step, dtype=dtype.torch, device=device)
    r = torch.arange(length, dtype=torch.float64, device=device) * step + start
    return r.to(dtype.torch)


# -- shape --------------------------------------------------------------------

@impl(PrimIDs.BROADCAST_IN_DIM)
def _broadcast_in_dim(a, shape, broadcast_dimensions):
    view = [1] * len(shape)
    for i, d in enumerate(broadcast_dimensions):
        view[d] = a.shape[i]
    return a.reshape(view).expand(tuple(shape))


@impl(PrimIDs.CAT)
def _cat(tensors, dim):
    return torch.cat(list(tensors), dim)


@impl(PrimIDs.FLIP)
def _flip(a, dims):
    return torch.flip(a, tuple(dims))


@impl(PrimIDs.RESHAPE)
def _reshape(a, shape):
    return a.reshape(tuple(shape))


@impl(PrimIDs.SLICE)
def _slice(a, start_indices, end_indices, strides=None):
    strides = strides or [1] * a.ndim
    return a[tuple(slice(s, e, st) for s, e, st in zip(start_indices, end_indices, strides))]


@impl(PrimIDs.SQUEEZE)
def _squeeze(a, dims):
    return a.squeeze(tuple(dims))


@impl(PrimIDs.TRANSPOSE)
def _transpose(a, permutation):
    return a.permute(tuple(permutation))


@impl(PrimIDs.PAD)
def _pad(a, padding_value, padding_config):
    if any(interior for _, _, interior in padding_config):
        # interior padding (the VJP of a strided slice): the input lands on
        # every (interior + 1)-th element after the low edge
        shape = [lo + hi + s + max(s - 1, 0) * i
                 for (lo, hi, i), s in zip(padding_config, a.shape)]
        out = torch.full(shape, padding_value, dtype=a.dtype, device=a.device)
        out[tuple(slice(lo, lo + max(s - 1, 0) * (i + 1) + 1, i + 1)
                  for (lo, _, i), s in zip(padding_config, a.shape))] = a
        return out
    pads = []
    for lo, hi, _ in reversed(padding_config):
        pads += [lo, hi]
    return F.pad(a, pads, value=padding_value)


@impl(PrimIDs.TAKE)
def _take(a, indices, dim):
    out = torch.index_select(a, dim, indices.reshape(-1))
    return out.reshape(a.shape[:dim] + indices.shape + a.shape[dim + 1:])


@impl(PrimIDs.TAKE_ALONG_AXIS)
def _take_along_axis(a, indices, dim):
    return torch.gather(a, dim, indices.long())


@impl(PrimIDs.INDEX_PUT)
def _index_put(a, indices, values, accumulate):
    return a.index_put(tuple(i.long() for i in indices), values, accumulate)


@impl(PrimIDs.INDEX_ADD)
def _index_add(a, indices, value, dim):
    if a.is_cuda:
        # index_add's CUDA kernel adds duplicate rows with atomics, in the
        # order they land; index_put's accumulation sorts them first, so a
        # program (and its CUDA graph's replay) gives the same bits each run
        out = a.movedim(dim, 0).index_put((indices.long(),), value.movedim(dim, 0),
                                          accumulate=True)
        return out.movedim(0, dim)
    return torch.index_add(a, dim, indices.long(), value)


@impl(PrimIDs.SCATTER_ADD)
def _scatter_add(a, indices, value, dim):
    return torch.scatter_add(a, dim, indices.long(), value)


@impl(PrimIDs.SCATTER)
def _scatter(a, indices, value, dim, donated=False):
    """Replace semantics; ``donated`` (``passes.donate_in_place``) writes
    ``a`` itself, a donated input nothing reads after this write. Duplicate
    indices leave one of their values, any one."""
    if donated:
        return a.scatter_(dim, indices.long(), value)
    return torch.scatter(a, dim, indices.long(), value)


def _update_index(a, starts, sizes):
    """The index of the region ``[start, start + size)`` per dim: slices
    where every start is a Python int; else index tensors built on the
    device from the 0-d tensor starts (clamped into range, as the
    reference's ``dynamic_update_slice`` clamps them), so no start is read
    on the host (a captured program may not read the device)."""
    if all(isinstance(s, int) for s in starts):
        return tuple(slice(s, s + n) for s, n in zip(starts, sizes))
    dynamic = [d for d, s in enumerate(starts) if not isinstance(s, int)]
    if len(dynamic) == 1:   # one index tensor among slices keeps its place
        d = dynamic[0]
        s = starts[d].clamp(0, a.shape[d] - sizes[d])
        return tuple(torch.arange(n, device=a.device) + s if i == d else slice(s_, s_ + n)
                     for i, (s_, n) in enumerate(zip(starts, sizes)))
    idx = []
    for d, (s, n) in enumerate(zip(starts, sizes)):
        hi = a.shape[d] - n
        s = s.clamp(0, hi) if isinstance(s, torch.Tensor) else min(max(int(s), 0), hi)
        shape = [1] * a.ndim
        shape[d] = n
        idx.append((torch.arange(n, device=a.device) + s).reshape(shape))
    return tuple(idx)


@impl(PrimIDs.DYNAMIC_SLICE)
def _dynamic_slice(a, start_indices, slice_sizes):
    return a[_update_index(a, start_indices, slice_sizes)]


@impl(PrimIDs.OPT_BARRIER)
def _opt_barrier(*args):
    # identity: the barrier is a trace-level device (it keeps CSE from merging
    # a recompute into the forward); the program runs its ops in order
    return args


@impl(PrimIDs.DYNAMIC_UPDATE_SLICE)
def _dynamic_update_slice(a, update, start_indices, donated=False):
    """``donated``: as :func:`_scatter`'s."""
    out = a if donated else a.clone()
    out[_update_index(a, start_indices, update.shape)] = update
    return out


# -- elementwise --------------------------------------------------------------

for _pid, _fn in {
    PrimIDs.ABS: torch.abs, PrimIDs.ACOS: torch.acos, PrimIDs.ASIN: torch.asin,
    PrimIDs.ATAN: torch.atan, PrimIDs.BITWISE_NOT: torch.bitwise_not, PrimIDs.CEIL: torch.ceil,
    PrimIDs.COS: torch.cos, PrimIDs.COSH: torch.cosh, PrimIDs.ERF: torch.erf,
    PrimIDs.ERFC: torch.erfc, PrimIDs.EXP: torch.exp, PrimIDs.EXP2: torch.exp2,
    PrimIDs.EXPM1: torch.expm1, PrimIDs.FLOOR: torch.floor, PrimIDs.ISFINITE: torch.isfinite,
    PrimIDs.ISINF: torch.isinf, PrimIDs.ISNAN: torch.isnan, PrimIDs.LOG: torch.log,
    PrimIDs.LOG10: torch.log10, PrimIDs.LOG1P: torch.log1p, PrimIDs.LOG2: torch.log2,
    PrimIDs.LOGICAL_NOT: torch.logical_not, PrimIDs.NEG: torch.neg,
    PrimIDs.RECIPROCAL: torch.reciprocal, PrimIDs.ROUND: torch.round, PrimIDs.RSQRT: torch.rsqrt,
    PrimIDs.SIGN: torch.sign, PrimIDs.SIN: torch.sin, PrimIDs.SINH: torch.sinh,
    PrimIDs.SQRT: torch.sqrt, PrimIDs.TAN: torch.tan, PrimIDs.TANH: torch.tanh,
    PrimIDs.TRUNC: torch.trunc,
    # binary prims take a Python number on either side: the operators do
    PrimIDs.ADD: operator.add, PrimIDs.SUB: operator.sub, PrimIDs.MUL: operator.mul,
    PrimIDs.DIV: operator.truediv, PrimIDs.POW: operator.pow, PrimIDs.REMAINDER: operator.mod,
    PrimIDs.FLOOR_DIV: operator.floordiv, PrimIDs.EQ: operator.eq, PrimIDs.NE: operator.ne,
    PrimIDs.LT: operator.lt, PrimIDs.LE: operator.le, PrimIDs.GT: operator.gt,
    PrimIDs.GE: operator.ge, PrimIDs.BITWISE_AND: operator.and_,
    PrimIDs.BITWISE_OR: operator.or_, PrimIDs.BITWISE_XOR: operator.xor,
}.items():
    _impls[_pid] = _fn


def _tensor_pair(a, b):
    like = a if isinstance(a, torch.Tensor) else b
    return tuple(x if isinstance(x, torch.Tensor) else torch.tensor(x, device=like.device)
                 for x in (a, b))


@impl(PrimIDs.MAXIMUM)
def _maximum(a, b):
    if isinstance(b, Number):
        return torch.clamp(a, min=b)
    if isinstance(a, Number):
        return torch.clamp(b, min=a)
    return torch.maximum(a, b)


@impl(PrimIDs.MINIMUM)
def _minimum(a, b):
    if isinstance(b, Number):
        return torch.clamp(a, max=b)
    if isinstance(a, Number):
        return torch.clamp(b, max=a)
    return torch.minimum(a, b)


@impl(PrimIDs.ATAN2)
def _atan2(a, b):
    return torch.atan2(*_tensor_pair(a, b))


@impl(PrimIDs.FMOD)
def _fmod(a, b):
    return torch.fmod(a, b) if isinstance(a, torch.Tensor) else torch.fmod(*_tensor_pair(a, b))


@impl(PrimIDs.WHERE)
def _where(pred, a, b):
    return torch.where(pred, a, b)


# -- reductions ---------------------------------------------------------------

@impl(PrimIDs.SUM)
def _sum(a, dims):
    # torch.sum over an empty dim list reduces every dim; the prim reduces none
    return torch.sum(a, tuple(dims)) if dims else a.clone()


@impl(PrimIDs.PROD)
def _prod(a, dims):
    out = a if dims else a.clone()
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, d)
    return out


@impl(PrimIDs.AMAX)
def _amax(a, dims):
    return torch.amax(a, tuple(dims)) if dims else a.clone()


@impl(PrimIDs.AMIN)
def _amin(a, dims):
    return torch.amin(a, tuple(dims)) if dims else a.clone()


@impl(PrimIDs.ARGMAX)
def _argmax(a, dim):
    return torch.argmax(a, dim)


@impl(PrimIDs.ARGMIN)
def _argmin(a, dim):
    return torch.argmin(a, dim)


@impl(PrimIDs.CUMSUM)
def _cumsum(a, dim):
    return torch.cumsum(a, dim)


# -- contraction --------------------------------------------------------------

_LETTERS = "abcdefghijklmnopqrstuvwxyz"


@impl(PrimIDs.DOT_GENERAL)
def _dot_general(a, b, *, contract_dims, batch_dims=((), ()), preferred_element_type=None):
    (ac, bc), (ab, bb) = tuple(map(tuple, contract_dims)), tuple(map(tuple, batch_dims))
    dt = preferred_element_type.torch if preferred_element_type is not None \
        else torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    nb = len(ab)
    if not ab and b.ndim == 2 and ac == (a.ndim - 1,) and bc == (1,):
        return torch.matmul(a, b.t())            # the linear contraction
    if a.ndim == b.ndim == 2 and ac == (1,) and bc == (0,) and not ab:
        return torch.matmul(a, b)
    if (ab == bb == tuple(range(nb)) and a.ndim == b.ndim == nb + 2
            and ac == (nb + 1,) and bc == (nb,)):
        return torch.matmul(a, b)                 # batched matmul
    la = list(_LETTERS[:a.ndim])
    lb = list(_LETTERS[a.ndim:a.ndim + b.ndim])
    for i, j in zip(ac + ab, bc + bb):
        lb[j] = la[i]
    out = [la[i] for i in ab] + [la[i] for i in range(a.ndim) if i not in ac and i not in ab] \
        + [lb[j] for j in range(b.ndim) if j not in bc and j not in bb]
    return torch.einsum(f"{''.join(la)},{''.join(lb)}->{''.join(out)}", a, b)


@impl(PrimIDs.ITEM)
def _item(a):
    return a.item()


# -- composites run whole ------------------------------------------------------

def _off_card(*args, **kwargs) -> bool:
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.core.pytree import tree_flatten

    return all(t.device.type != "cuda" for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, TensorProxy))


def _one_hot(ids, num_classes):
    classes = torch.arange(num_classes, dtype=ids.dtype, device=ids.device)
    return (ids.unsqueeze(-1) == classes).to(torch.int32)


def _sdpa_bwd(g, q, k, v, out, lse, is_causal=False, scale=None):
    from thunder_tpu_torch.ops.nn import sdpa_bwd_plain

    return sdpa_bwd_plain(g, q, k, v, out, lse, is_causal, scale)


def _mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, *, act="silu", eps=1e-5):
    from thunder_tpu_torch.ops.nn import mlp_subblock_plain

    return mlp_subblock_plain(residual, x, w_norm, w_gate, w_up, w_down, act, eps)


def _mlp_subblock_bwd(g, residual, x, w_norm, w_gate, w_up, w_down, *, act="silu", eps=1e-5):
    from thunder_tpu_torch.ops.nn import mlp_subblock_bwd_plain

    return mlp_subblock_bwd_plain(g, residual, x, w_norm, w_gate, w_up, w_down, act, eps)


def _stored(t, dtype):
    return t.to(dtype.torch if dtype is not None else t.dtype)


def _adamw_step(p, g, m, v, bc1, bc2, *, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, state_dtype=None, v_dtype=None):
    from thunder_tpu_torch.ops.optim import adamw_step_plain

    # the moments taken to float32 first, so each is rounded once, to the
    # dtype it is stored in
    p_new, m_new, v_new = adamw_step_plain(p, g, m.float(), v.float(), bc1, bc2, lr=lr,
                                           beta1=beta1, beta2=beta2, eps=eps,
                                           weight_decay=weight_decay)
    return p_new, _stored(m_new, state_dtype or dtypes.to_dtype(m.dtype)), \
        _stored(v_new, v_dtype or dtypes.to_dtype(v.dtype))


def _fused_adamw_checker(params, grads, ms, vs, bc1, bc2, *, state_dtype=None, v_dtype=None,
                         **hyper):
    # moments in other dtypes than the stored ones take the per-parameter
    # decomposition, which converts them
    from thunder_tpu_torch.ops.optim import moments_stored

    return _off_card(params, grads, ms, vs) and moments_stored(ms, vs, state_dtype, v_dtype)


def _register_composites() -> None:
    from thunder_tpu_torch import ops
    from thunder_tpu_torch.ops import optim

    for name, op_id, fn, checker in (
            ("one_hot", "nn.one_hot", _one_hot, None),
            ("sdpa_bwd", "nn.sdpa_bwd", _sdpa_bwd, _off_card),
            ("mlp_subblock", "nn.mlp_subblock", _mlp_subblock, _off_card),
            ("mlp_subblock_bwd", "nn.mlp_subblock_bwd", _mlp_subblock_bwd, _off_card),
            ("adamw_step", "optim.adamw_step", _adamw_step, _off_card),
            ("fused_adamw", "optim.fused_adamw", optim.fused_adamw_into, _fused_adamw_checker)):
        sym = ex.register_operator(name, meta=ops.get_op(op_id).meta, fn=fn)
        ex.register_implementation(op_id, sym, checker=checker)


_register_composites()
