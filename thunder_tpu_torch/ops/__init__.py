"""The port's operation language ("ops") and its eager routers.

Two halves, as in the JAX package:

- this module is the counterpart of ``thunder_tpu/ops/__init__.py``: the
  traceable tensor operations ``jit`` records, which decompose into the
  prims of :mod:`thunder_tpu_torch.core.prims` and add broadcasting and
  type promotion. Elementwise, reduction, activation and contraction ops
  are Symbols with the reference's stable ids (``ops.add``, ``nn.linear``,
  ...), so the epilogue pass and the executors match them as the
  reference's do; shape ops are plain functions over prims, as there. The
  reference's nn composites are in :mod:`thunder_tpu_torch.ops.composites`
  and re-exported here (``ops.rms_norm``, ``ops.scaled_dot_product_attention``,
  ...). Only the ops this slice's functions reach are ported
  (ROADMAP A.7);
- :mod:`thunder_tpu_torch.ops.nn` and :mod:`thunder_tpu_torch.ops.optim`
  hold the eager routers the models call, each sending a CUDA tensor to its
  hand-written kernel. Under ``jit`` a router called on traced tensors
  records its composite instead.
"""

from __future__ import annotations

import builtins
import math
import operator as _pyop
from numbers import Number
from typing import Sequence

from thunder_tpu_torch.core import dtypes, prims
from thunder_tpu_torch.core.baseutils import canonicalize_dim, canonicalize_dims, check
from thunder_tpu_torch.core.devices import to_device
from thunder_tpu_torch.core.proxies import NumberProxy, TensorProxy, pyval
from thunder_tpu_torch.core.symbol import Symbol

_opsym_registry: dict[str, Symbol] = {}


def opsymbol(fn=None, *, name: str | None = None, id: str | None = None):
    """Register ``fn`` as a traceable composite Symbol with a stable id."""

    def deco(fn):
        sname = name or fn.__name__
        sym = Symbol(sname, fn, id=id or f"ops.{sname}", is_prim=False)
        _opsym_registry[sym.id] = sym
        return sym

    return deco(fn) if fn is not None else deco


def get_op(op_id: str) -> Symbol | None:
    return _opsym_registry.get(op_id)


def _tensor_like(a, opname: str):
    check(isinstance(a, TensorProxy) or hasattr(a, "ndim"),
          lambda: f"{opname}: expected a tensor, got {type(a).__name__}", exc_type=TypeError)
    return a


# ---------------------------------------------------------------------------
# broadcasting / promotion helpers
# ---------------------------------------------------------------------------

def compute_broadcast_shape(*shapes) -> tuple[int, ...]:
    out: list[int] = []
    for shape in shapes:
        if shape is None:
            continue
        shape = list(shape)
        diff = len(shape) - len(out)
        if diff > 0:
            out = [1] * diff + out
        for i in range(1, len(shape) + 1):
            s = shape[-i]
            if out[-i] == 1:
                out[-i] = s
            else:
                check(s == 1 or s == out[-i], lambda: f"shapes {shapes} are not broadcastable")
    return tuple(out)


def expand_to(a: TensorProxy, shape: Sequence[int]) -> TensorProxy:
    """Right-aligned broadcast of ``a`` to ``shape``."""
    shape = tuple(shape)
    if a.shape == shape:
        return a
    offset = len(shape) - a.ndim
    check(offset >= 0, lambda: f"cannot broadcast rank {a.ndim} to {shape}")
    return prims.broadcast_in_dim(a, shape, tuple(range(offset, len(shape))))


broadcast_to = expand_to


def maybe_broadcast(*args):
    shapes = [a.shape for a in args if isinstance(a, TensorProxy)]
    if not shapes:
        return args
    common = compute_broadcast_shape(*shapes)
    return tuple(expand_to(a, common) if isinstance(a, TensorProxy) else a for a in args)


def _float_promote(a):
    if isinstance(a, TensorProxy) and a.dtype.is_exact:
        return prims.convert_element_type(a, dtypes.float32)
    if isinstance(a, (bool, int)):
        return float(a)
    return a


# ---------------------------------------------------------------------------
# dtype, creation
# ---------------------------------------------------------------------------

def convert_element_type(a, dt):
    dt = dtypes.to_dtype(dt)
    if isinstance(a, TensorProxy):
        if a.dtype is dt:
            return a
        return prims.convert_element_type(a, dt)
    return a


to = convert_element_type


def detach(a):
    return prims.detach(a)


def item(a):
    return prims.item(a)


def _default_dtype_for(v) -> dtypes.dtype:
    if isinstance(v, bool):
        return dtypes.bool8
    if isinstance(v, int):
        return dtypes.int64
    return dtypes.float32


def full(shape, fill_value, *, dtype=None, device=None):
    shape = tuple(int(s) for s in shape)
    check(all(s >= 0 for s in shape), lambda: f"full: shape must be nonnegative, got {shape}")
    dtype = dtypes.to_dtype(dtype) if dtype is not None else _default_dtype_for(pyval(fill_value))
    return prims.full(shape, pyval(fill_value), dtype, to_device(device))


def full_like(a, fill_value, *, dtype=None, device=None):
    _tensor_like(a, "full_like")
    return full(a.shape, fill_value, dtype=dtype or a.dtype, device=device or a.device)


def zeros(*shape, dtype=None, device=None):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return full(shape, 0.0 if dtype is None else 0, dtype=dtype or dtypes.float32, device=device)


def ones(*shape, dtype=None, device=None):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return full(shape, 1.0 if dtype is None else 1, dtype=dtype or dtypes.float32, device=device)


def zeros_like(a, *, dtype=None, device=None):
    return full_like(a, 0, dtype=dtype, device=device)


def ones_like(a, *, dtype=None, device=None):
    return full_like(a, 1, dtype=dtype, device=device)


def arange(start, end=None, step=1, *, dtype=None, device=None):
    if end is None:
        start, end = 0, start
    start, end, step = pyval(start), pyval(end), pyval(step)
    check(step != 0, "arange: step must be nonzero")
    if dtype is None:
        dtype = dtypes.int64 if all(isinstance(x, int) for x in (start, end, step)) else dtypes.float32
    length = builtins.max(0, math.ceil((end - start) / step))
    return prims.iota(length, start=start, step=step, dtype=dtypes.to_dtype(dtype),
                      device=to_device(device))


def tril_mask(rows: int, cols: int, diagonal: int = 0, *, device=None):
    """Boolean lower-triangular mask built from iota compares."""
    device = to_device(device)
    r = prims.iota(rows, dtype=dtypes.int64, device=device)
    c = prims.iota(cols, dtype=dtypes.int64, device=device)
    r2 = expand_to(reshape(r, (rows, 1)), (rows, cols))
    c2 = expand_to(reshape(c, (1, cols)), (rows, cols))
    return ge(add(r2, diagonal), c2)


def tril(a, diagonal: int = 0):
    mask = tril_mask(a.shape[-2], a.shape[-1], diagonal, device=a.device)
    return where(expand_to(mask, a.shape), a, zeros_like(a))


def triu(a, diagonal: int = 0):
    mask = tril_mask(a.shape[-2], a.shape[-1], diagonal - 1, device=a.device)
    return where(expand_to(mask, a.shape), zeros_like(a), a)


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------

def _make_unary(name: str, prim, *, float_promote: bool = False, py=None):
    def meta(a):
        if isinstance(a, Number):
            check(py is not None, lambda: f"{name} of a python number is unsupported")
            return py(a)
        check(isinstance(a, (TensorProxy, NumberProxy)) or hasattr(a, "shape"),
              lambda: f"{name}: expected a tensor or number, got {type(a).__name__}",
              exc_type=TypeError)
        if float_promote:
            a = _float_promote(a)
        return prim(a)

    meta.__name__ = name
    return opsymbol(meta, name=name)


abs = _make_unary("abs", prims.abs, py=_pyop.abs)
acos = _make_unary("acos", prims.acos, float_promote=True, py=math.acos)
asin = _make_unary("asin", prims.asin, float_promote=True, py=math.asin)
atan = _make_unary("atan", prims.atan, float_promote=True, py=math.atan)
bitwise_not = _make_unary("bitwise_not", prims.bitwise_not, py=_pyop.invert)
ceil = _make_unary("ceil", prims.ceil, py=math.ceil)
cos = _make_unary("cos", prims.cos, float_promote=True, py=math.cos)
cosh = _make_unary("cosh", prims.cosh, float_promote=True, py=math.cosh)
erf = _make_unary("erf", prims.erf, float_promote=True, py=math.erf)
erfc = _make_unary("erfc", prims.erfc, float_promote=True, py=math.erfc)
exp = _make_unary("exp", prims.exp, float_promote=True, py=math.exp)
exp2 = _make_unary("exp2", prims.exp2, float_promote=True, py=lambda x: 2.0 ** x)
expm1 = _make_unary("expm1", prims.expm1, float_promote=True, py=math.expm1)
floor = _make_unary("floor", prims.floor, py=math.floor)
isfinite = _make_unary("isfinite", prims.isfinite, py=math.isfinite)
isinf = _make_unary("isinf", prims.isinf, py=math.isinf)
isnan = _make_unary("isnan", prims.isnan, py=math.isnan)
log = _make_unary("log", prims.log, float_promote=True, py=math.log)
log10 = _make_unary("log10", prims.log10, float_promote=True, py=math.log10)
log1p = _make_unary("log1p", prims.log1p, float_promote=True, py=math.log1p)
log2 = _make_unary("log2", prims.log2, float_promote=True, py=math.log2)
logical_not = _make_unary("logical_not", prims.logical_not, py=_pyop.not_)
neg = _make_unary("neg", prims.neg, py=_pyop.neg)
reciprocal = _make_unary("reciprocal", prims.reciprocal, float_promote=True, py=lambda x: 1.0 / x)
round = _make_unary("round", prims.round)
rsqrt = _make_unary("rsqrt", prims.rsqrt, float_promote=True, py=lambda x: 1.0 / math.sqrt(x))
sign = _make_unary("sign", prims.sign)
sin = _make_unary("sin", prims.sin, float_promote=True, py=math.sin)
sinh = _make_unary("sinh", prims.sinh, float_promote=True, py=math.sinh)
sqrt = _make_unary("sqrt", prims.sqrt, float_promote=True, py=math.sqrt)
tan = _make_unary("tan", prims.tan, float_promote=True, py=math.tan)
tanh = _make_unary("tanh", prims.tanh, float_promote=True, py=math.tanh)
trunc = _make_unary("trunc", prims.trunc, py=math.trunc)


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------

def _make_binary(name: str, prim, *, py=None, float_promote: bool = False):
    def meta(a, b):
        if isinstance(a, Number) and isinstance(b, Number):
            check(py is not None, lambda: f"{name} of two python numbers is unsupported")
            return py(pyval(a), pyval(b))
        for x in (a, b):
            check(isinstance(x, (TensorProxy, NumberProxy, Number)) or hasattr(x, "shape"),
                  lambda: f"{name}: expected tensors or numbers, got {type(x).__name__}",
                  exc_type=TypeError)
        if float_promote:
            a, b = _float_promote(a), _float_promote(b)
        a, b = maybe_broadcast(a, b)
        return prim(a, b)

    meta.__name__ = name
    return opsymbol(meta, name=name)


add = _make_binary("add", prims.add, py=_pyop.add)
atan2 = _make_binary("atan2", prims.atan2, py=math.atan2, float_promote=True)
bitwise_and = _make_binary("bitwise_and", prims.bitwise_and, py=_pyop.and_)
bitwise_or = _make_binary("bitwise_or", prims.bitwise_or, py=_pyop.or_)
bitwise_xor = _make_binary("bitwise_xor", prims.bitwise_xor, py=_pyop.xor)
eq = _make_binary("eq", prims.eq, py=_pyop.eq)
fmod = _make_binary("fmod", prims.fmod, py=math.fmod)
ge = _make_binary("ge", prims.ge, py=_pyop.ge)
gt = _make_binary("gt", prims.gt, py=_pyop.gt)
le = _make_binary("le", prims.le, py=_pyop.le)
lt = _make_binary("lt", prims.lt, py=_pyop.lt)
maximum = _make_binary("maximum", prims.maximum, py=builtins.max)
minimum = _make_binary("minimum", prims.minimum, py=builtins.min)
mul = _make_binary("mul", prims.mul, py=_pyop.mul)
ne = _make_binary("ne", prims.ne, py=_pyop.ne)
pow = _make_binary("pow", prims.pow, py=_pyop.pow)
remainder = _make_binary("remainder", prims.remainder, py=_pyop.mod)
sub = _make_binary("sub", prims.sub, py=_pyop.sub)
true_divide = _make_binary("true_divide", prims.div, py=_pyop.truediv, float_promote=True)
div = true_divide


@opsymbol
def floor_divide(a, b):
    if isinstance(a, Number) and isinstance(b, Number):
        return pyval(a) // pyval(b)
    a, b = maybe_broadcast(a, b)
    ts = [t for t in (a, b) if isinstance(t, TensorProxy)]
    if any(t.dtype.is_float for t in ts):
        return prims.floor(prims.div(a, b))
    return prims.floor_div(a, b)


def _to_bool(a):
    if isinstance(a, TensorProxy) and not a.dtype.is_bool:
        return ne(a, 0)
    return a


def logical_and(a, b):
    return bitwise_and(_to_bool(a), _to_bool(b))


def logical_or(a, b):
    return bitwise_or(_to_bool(a), _to_bool(b))


# ---------------------------------------------------------------------------
# ternary / conditional
# ---------------------------------------------------------------------------

@opsymbol
def where(pred, a, b):
    pred, a, b = maybe_broadcast(pred, a, b)
    return prims.where(pred, a, b)


@opsymbol
def clamp(a, min=None, max=None):
    check(min is not None or max is not None, "clamp: at least one of min or max must be given")
    out = a
    if min is not None:
        out = maximum(out, min)
    if max is not None:
        out = minimum(out, max)
    return out


@opsymbol
def masked_fill(a, mask, value):
    return where(mask, full_like(a, pyval(value)) if isinstance(value, Number) else value, a)


@opsymbol
def lerp(start, end, weight):
    return add(start, mul(sub(end, start), weight))


# ---------------------------------------------------------------------------
# shape ops (plain functions over prims, as in the reference)
# ---------------------------------------------------------------------------

def reshape(a, shape):
    shape = tuple(int(pyval(s)) for s in shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        inferred = a.numel // known if known else 0
        shape = tuple(inferred if s == -1 else s for s in shape)
    if shape == a.shape:
        return a
    return prims.reshape(a, shape)


def flatten(a, start_dim=0, end_dim=-1):
    _tensor_like(a, "flatten")
    if a.ndim == 0:
        return reshape(a, (1,))
    start_dim = canonicalize_dim(a.ndim, start_dim)
    end_dim = canonicalize_dim(a.ndim, end_dim)
    merged = math.prod(a.shape[start_dim:end_dim + 1])
    return reshape(a, a.shape[:start_dim] + (merged,) + a.shape[end_dim + 1:])


def transpose(a, permutation):
    _tensor_like(a, "transpose")
    perm = canonicalize_dims(a.ndim, tuple(permutation))
    if perm == tuple(range(a.ndim)):
        return a
    return prims.transpose(a, perm)


permute = transpose


def movedim(a, src, dst):
    _tensor_like(a, "movedim")
    src = canonicalize_dims(a.ndim, src)
    dst = canonicalize_dims(a.ndim, dst)
    perm = [i for i in range(a.ndim) if i not in src]
    for d, s in sorted(zip(dst, src)):
        perm.insert(d, s)
    return transpose(a, perm)


def squeeze(a, dim=None):
    _tensor_like(a, "squeeze")
    if dim is None:
        dims = tuple(i for i, s in enumerate(a.shape) if s == 1)
    else:
        dims = canonicalize_dims(a.ndim, dim if isinstance(dim, (tuple, list)) else (dim,))
        dims = tuple(d for d in dims if a.shape[d] == 1)
    if not dims:
        return a
    return prims.squeeze(a, dims)


def unsqueeze(a, dim):
    _tensor_like(a, "unsqueeze")
    dim = canonicalize_dim(a.ndim + 1, dim)
    return reshape(a, a.shape[:dim] + (1,) + a.shape[dim:])


def expand(a, shape):
    """torch-style expand: -1 keeps the dim."""
    shape = tuple(int(pyval(s)) for s in shape)
    offset = len(shape) - a.ndim
    check(offset >= 0, lambda: f"expand to smaller rank: {a.shape} -> {shape}")
    out = []
    for i, s in enumerate(shape):
        out.append(s if i < offset or s != -1 else a.shape[i - offset])
    return expand_to(a, tuple(out))


def cat(tensors, dim=0):
    tensors = list(tensors)
    if len(tensors) == 1:
        return tensors[0]
    return prims.cat(tensors, canonicalize_dim(tensors[0].ndim, dim))


def stack(tensors, dim=0):
    return cat([unsqueeze(t, dim) for t in tensors], dim)


def split(a, split_size, dim=0):
    _tensor_like(a, "split")
    dim = canonicalize_dim(a.ndim, dim)
    n = a.shape[dim]
    if isinstance(split_size, int):
        sizes = [split_size] * (n // split_size)
        if n % split_size:
            sizes.append(n % split_size)
    else:
        sizes = list(split_size)
    outs, off = [], 0
    for s in sizes:
        starts = [0] * a.ndim
        ends = list(a.shape)
        starts[dim], ends[dim] = off, off + s
        outs.append(prims.slice_prim(a, starts, ends))
        off += s
    return tuple(outs)


def chunk(a, chunks, dim=0):
    _tensor_like(a, "chunk")
    n = a.shape[canonicalize_dim(a.ndim, dim)]
    return split(a, -(-n // chunks), dim)


def flip(a, dims):
    _tensor_like(a, "flip")
    return prims.flip(a, canonicalize_dims(
        a.ndim, tuple(dims) if isinstance(dims, (tuple, list)) else (dims,)))


def pad(a, padding_config, value=0):
    """lax-style padding config: ((lo, hi, interior), ...) per dim."""
    _tensor_like(a, "pad")
    return prims.pad(a, value, tuple(padding_config))


def take(a, indices, dim=0):
    _tensor_like(a, "take")
    return prims.take(a, indices, canonicalize_dim(a.ndim, dim))


index_select = take


def gather(a, dim, index):
    _tensor_like(a, "gather")
    return prims.take_along_axis(a, index, canonicalize_dim(a.ndim, dim))


def take_along_axis(a, idx, dim):
    _tensor_like(a, "take_along_axis")
    return prims.take_along_axis(a, idx, canonicalize_dim(a.ndim, dim))


def index_put(a, indices, values, accumulate=False):
    return prims.index_put(a, tuple(indices), values, bool(accumulate))


def linearize_indices(indices, sizes, bshape):
    """Row-major linearization of jointly broadcast integer indices over
    dims of the given ``sizes``: the linear index broadcast to ``bshape``,
    or a Python int when every index is an int. Negatives are normalized;
    the arithmetic runs in int32, refused for extents past 2**31. The
    ``index_put`` VJP's gradient gather reads it."""
    check(math.prod(sizes) < 2 ** 31,
          lambda: f"indexed extent {math.prod(sizes)} overflows int32 linearization",
          NotImplementedError)
    strides, acc = [], 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    strides.reverse()
    linear = None
    for t, s, st in zip(indices, sizes, strides):
        if isinstance(t, TensorProxy):
            t = convert_element_type(t, dtypes.int32)
            t = broadcast_to(where(lt(t, 0), add(t, s), t), bshape)
            term = mul(t, st) if st != 1 else t
        else:
            term = (int(t) % s) * st
        if linear is None:
            linear = term
        elif isinstance(linear, int) and isinstance(term, int):
            linear = linear + term
        else:
            linear = add(linear, term)
    return linear


def repeat_interleave_dim0(a, repeats: int):
    return reshape(expand_to(unsqueeze(a, 1), (a.shape[0], repeats) + a.shape[1:]),
                   (a.shape[0] * repeats,) + a.shape[1:])


def setitem(a, idx, val):
    """Functional ``a[idx] = val`` for basic indexing (ints, slices of step
    1, Ellipsis): returns the updated tensor. The torch front end's
    ``TorchProxy.__setitem__`` rebinds through it (functionalization). The
    reference's stepped and advanced-index writes are not ported yet."""
    _tensor_like(a, "setitem")
    if not isinstance(idx, tuple):
        idx = (idx,)
    check(not any(isinstance(i, TensorProxy) for i in idx),
          "setitem: tensor indices are not supported yet", NotImplementedError)
    n_spec = len([i for i in idx if i is not Ellipsis])
    idx = tuple(j for i in idx
                for j in ((slice(None),) * (a.ndim - n_spec) if i is Ellipsis else (i,)))
    idx = idx + (slice(None),) * (a.ndim - len(idx))
    check(len(idx) == a.ndim, lambda: f"setitem: too many indices for rank {a.ndim}")
    starts, sizes, keep_dim = [], [], []
    for d, i in enumerate(idx):
        n = int(a.shape[d])
        if isinstance(i, (int, NumberProxy)):
            i = int(pyval(i))
            check(-n <= i < n, lambda: f"setitem: index {i} out of range for dim {d}", IndexError)
            starts.append(i % n)
            sizes.append(1)
            keep_dim.append(False)
        else:
            check(isinstance(i, slice), lambda: f"setitem: unsupported index {i!r}",
                  NotImplementedError)
            s0, e0, st = i.indices(n)
            check(st == 1, "setitem: stepped slices are not supported yet", NotImplementedError)
            starts.append(s0)
            sizes.append(builtins.max(e0 - s0, 0))
            keep_dim.append(True)
    if any(s == 0 for s in sizes):
        return a
    region = tuple(sizes)
    if isinstance(val, TensorProxy):
        v = val
        for d, kd in enumerate(keep_dim):
            if not kd and v.ndim < len(region):
                v = unsqueeze(v, builtins.min(d, v.ndim))
        if v.ndim < len(region):
            v = reshape(v, (1,) * (len(region) - v.ndim) + tuple(v.shape))
        v = expand_to(v, region) if tuple(v.shape) != region else v
    else:
        v = full(region, pyval(val), dtype=a.dtype, device=a.device)
    return prims.dynamic_update_slice(a, convert_element_type(v, a.dtype), tuple(starts))


def narrow(a, dim, start, length):
    """``length`` elements of ``a`` along ``dim`` from ``start`` (a
    negative start counts from the end), as a slice."""
    d = canonicalize_dim(a.ndim, dim)
    start, length = int(pyval(start)), int(pyval(length))
    if start < 0:
        start += int(a.shape[d])
    check(0 <= start and length >= 0 and start + length <= a.shape[d],
          lambda: f"narrow: [{start}, {start + length}) out of bounds for dim {d} of size "
                  f"{a.shape[d]}")
    idx = [slice(None)] * a.ndim
    idx[d] = slice(start, start + length)
    return getitem(a, tuple(idx))


def getitem(a, idx):
    """Basic indexing (ints, slices, None, Ellipsis) and one integer-tensor
    index; decomposes to slice/squeeze/take prims."""
    _tensor_like(a, "getitem")
    if not isinstance(idx, tuple):
        idx = (idx,)
    n_specified = len([i for i in idx if i is not None and i is not Ellipsis])
    ell = [i for i, x in enumerate(idx) if x is Ellipsis]
    if ell:
        pos = ell[0]
        idx = idx[:pos] + (slice(None),) * (a.ndim - n_specified) + idx[pos + 1:]
    else:
        idx = idx + (slice(None),) * (a.ndim - n_specified)

    tensor_positions = [i for i, x in enumerate(idx) if isinstance(x, TensorProxy)]
    if tensor_positions:
        check(len(tensor_positions) == 1 and idx[tensor_positions[0]].dtype.is_int,
              "getitem: one integer tensor index is supported (the reference's "
              "multi-tensor and boolean indexing are not ported yet)", NotImplementedError)
        tp = tensor_positions[0]
        dim = len([x for x in idx[:tp] if isinstance(x, slice) or x is None])
        rest = list(idx)
        t = rest[tp]
        rest[tp] = slice(None)
        nontrivial = any(not (isinstance(x, slice) and x == slice(None)) for x in rest)
        out = getitem(a, tuple(rest)) if nontrivial else a
        return take(out, t, dim)

    starts, ends, strides = [], [], []
    squeeze_dims, unsqueeze_positions = [], []
    dim = 0
    out_dim = 0
    for x in idx:
        if x is None:
            unsqueeze_positions.append(out_dim)
            out_dim += 1
            continue
        size = a.shape[dim]
        if isinstance(x, (int, NumberProxy)):
            x = int(pyval(x))
            x = x + size if x < 0 else x
            check(0 <= x < size, lambda: f"index {x} out of range for dim {dim} (size {size})",
                  IndexError)
            starts.append(x); ends.append(x + 1); strides.append(1)
            squeeze_dims.append(dim)
        elif isinstance(x, slice):
            start, stop, step = x.indices(size)
            check(step > 0, "negative slice steps are not supported; use flip()")
            starts.append(start); ends.append(builtins.max(start, stop)); strides.append(step)
            out_dim += 1
        else:
            raise TypeError(f"unsupported index {x!r}")
        dim += 1

    out = a
    if (any(s != 0 for s in starts) or any(e != s for e, s in zip(ends, a.shape))
            or any(st != 1 for st in strides)):
        out = prims.slice_prim(a, starts, ends, strides)
    if squeeze_dims:
        out = prims.squeeze(out, tuple(squeeze_dims))
    for p in unsqueeze_positions:
        out = unsqueeze(out, p)
    return out


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduce_dims(a, dim) -> tuple[int, ...]:
    check(isinstance(a, TensorProxy) or hasattr(a, "ndim"),
          lambda: f"reduction: expected a tensor, got {type(a).__name__}", exc_type=TypeError)
    if dim is None:
        return tuple(range(a.ndim))
    return canonicalize_dims(a.ndim, dim if isinstance(dim, (tuple, list)) else (dim,))


def _restore_keepdim(out, a, dims):
    return reshape(out, tuple(1 if i in dims else s for i, s in enumerate(a.shape)))


def _make_reduction_op(name, prim):
    def meta(a, dim=None, keepdim=False, dtype=None):
        dims = _reduce_dims(a, dim)
        if dtype is not None:
            a = convert_element_type(a, dtype)
        out = prim(a, dims)
        if keepdim:
            out = _restore_keepdim(out, a, dims)
        return out

    meta.__name__ = name
    return opsymbol(meta, name=name)


sum = _make_reduction_op("sum", prims.sum)
prod = _make_reduction_op("prod", prims.prod)
amax = _make_reduction_op("amax", prims.amax)
amin = _make_reduction_op("amin", prims.amin)


@opsymbol
def mean(a, dim=None, keepdim=False, dtype=None):
    dims = _reduce_dims(a, dim)
    n = math.prod(a.shape[d] for d in dims)
    if dtype is not None:
        a = convert_element_type(a, dtype)
    elif a.dtype.is_exact:
        a = convert_element_type(a, dtypes.float32)
    out = true_divide(prims.sum(a, dims), n)
    if keepdim:
        out = _restore_keepdim(out, a, dims)
    return out


@opsymbol
def var_mean(a, dim=None, correction=1, keepdim=False):
    dims = _reduce_dims(a, dim)
    n = math.prod(a.shape[d] for d in dims)
    if a.dtype.is_exact:
        a = convert_element_type(a, dtypes.float32)
    m = mean(a, dim, keepdim=True)
    centered = sub(a, m)
    v = true_divide(prims.sum(prims.mul(centered, centered), dims), builtins.max(n - correction, 1))
    if keepdim:
        return _restore_keepdim(v, a, dims), m
    return v, squeeze(m, dims)


@opsymbol
def var(a, dim=None, correction=1, keepdim=False):
    v, _ = var_mean(a, dim, correction=correction, keepdim=keepdim)
    return v


@opsymbol
def std(a, dim=None, correction=1, keepdim=False):
    return sqrt(var(a, dim, correction=correction, keepdim=keepdim))


@opsymbol
def argmax(a, dim=None, keepdim=False):
    out = prims.argmax(a, dim if dim is None else canonicalize_dim(a.ndim, dim))
    if keepdim and dim is not None:
        out = _restore_keepdim(out, a, (canonicalize_dim(a.ndim, dim),))
    return out


@opsymbol
def argmin(a, dim=None, keepdim=False):
    out = prims.argmin(a, dim if dim is None else canonicalize_dim(a.ndim, dim))
    if keepdim and dim is not None:
        out = _restore_keepdim(out, a, (canonicalize_dim(a.ndim, dim),))
    return out


@opsymbol
def max_with_indices(a, dim, keepdim=False):
    _tensor_like(a, "max_with_indices")
    return amax(a, dim, keepdim=keepdim), argmax(a, dim, keepdim=keepdim)


def all_(a, dim=None, keepdim=False):
    b = _to_bool(a)
    return convert_element_type(amin(convert_element_type(b, dtypes.uint8), dim, keepdim=keepdim),
                                dtypes.bool8)


def any_(a, dim=None, keepdim=False):
    b = _to_bool(a)
    return convert_element_type(amax(convert_element_type(b, dtypes.uint8), dim, keepdim=keepdim),
                                dtypes.bool8)


def cumsum(a, dim):
    _tensor_like(a, "cumsum")
    return prims.cumsum(a, canonicalize_dim(a.ndim, dim))


# ---------------------------------------------------------------------------
# contraction: everything decomposes into dot_general
# ---------------------------------------------------------------------------

@opsymbol
def matmul(a, b):
    check(isinstance(a, TensorProxy) and isinstance(b, TensorProxy), "matmul expects tensors")
    if a.ndim == 1 and b.ndim == 1:
        return prims.dot_general(a, b, contract_dims=((0,), (0,)))
    if a.ndim == 1:
        return squeeze(matmul(unsqueeze(a, 0), b), -2)
    if b.ndim == 1:
        return squeeze(matmul(a, unsqueeze(b, 1)), -1)
    if a.ndim == 2 and b.ndim == 2:
        return prims.dot_general(a, b, contract_dims=((1,), (0,)))
    batch = compute_broadcast_shape(a.shape[:-2], b.shape[:-2])
    a = expand_to(a, batch + a.shape[-2:])
    b = expand_to(b, batch + b.shape[-2:])
    nb = len(batch)
    return prims.dot_general(a, b, contract_dims=((nb + 1,), (nb,)),
                             batch_dims=(tuple(range(nb)), tuple(range(nb))))


@opsymbol(id="nn.linear")
def linear(a, w, bias=None):
    """``a @ w.T (+ bias)``; w is ``(out_features, in_features)``, torch's
    layout. (The reference's tensor-parallel and fp8 branches are not
    ported yet.)"""
    out = prims.dot_general(a, w, contract_dims=((a.ndim - 1,), (1,)))
    if bias is not None:
        out = add(out, bias)
    return out


@opsymbol
def outer(a, b):
    return mul(unsqueeze(a, 1), unsqueeze(b, 0))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@opsymbol
def sigmoid(a):
    a = _float_promote(a)
    return true_divide(1.0, add(1.0, exp(neg(a))))


@opsymbol
def relu(a):
    return maximum(a, zeros_like(a) if isinstance(a, TensorProxy) else 0)


@opsymbol
def silu(a):
    return mul(a, sigmoid(a))


@opsymbol
def gelu(a, approximate: str = "none"):
    a = _float_promote(a)
    if approximate == "tanh":
        inner = mul(math.sqrt(2.0 / math.pi), add(a, mul(0.044715, mul(a, mul(a, a)))))
        return mul(mul(0.5, a), add(1.0, tanh(inner)))
    return mul(mul(0.5, a), add(1.0, erf(true_divide(a, math.sqrt(2.0)))))


@opsymbol
def softplus(a, beta=1.0, threshold=20.0):
    scaled = mul(a, beta)
    soft = true_divide(log1p(exp(scaled)), beta)
    return where(gt(scaled, threshold), a, soft)


@opsymbol
def leaky_relu(a, negative_slope=0.01):
    return where(ge(a, 0), a, mul(a, negative_slope))


@opsymbol
def softmax(a, dim=-1, dtype=None):
    _tensor_like(a, "softmax")
    d = canonicalize_dim(a.ndim, dim)
    if dtype is not None:
        a = convert_element_type(a, dtype)
    x = _float_promote(a)
    m = amax(x, d, keepdim=True)
    e = exp(sub(x, m))
    return true_divide(e, sum(e, d, keepdim=True))


@opsymbol
def log_softmax(a, dim=-1, dtype=None):
    _tensor_like(a, "log_softmax")
    d = canonicalize_dim(a.ndim, dim)
    if dtype is not None:
        a = convert_element_type(a, dtype)
    x = _float_promote(a)
    m = amax(x, d, keepdim=True)
    shifted = sub(x, m)
    return sub(shifted, log(sum(exp(shifted), d, keepdim=True)))


# the nn composites live in ops.composites; re-export them as the reference
# re-exports its ops.nn entry points
from thunder_tpu_torch.ops import composites  # noqa: E402
from thunder_tpu_torch.ops.composites import (  # noqa: E402,F401
    ce_fwd,
    cross_entropy,
    dropout,
    embedding,
    layer_norm,
    linear_act,
    mse_loss,
    one_hot,
    rms_norm,
    rms_norm_residual,
    scaled_dot_product_attention,
    sdpa_bwd,
    sdpa_fwd,
)
