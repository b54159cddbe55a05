"""The primitive operations of the port's traces.

The counterpart of ``thunder_tpu/core/prims.py``: the prims this slice's
ops reach, with the reference's names and metas. ``dot_general`` is the
contraction prim ``matmul`` and ``linear`` decompose into; shape prims
follow the reference's (``broadcast_in_dim``, ``slice_prim``,
``transpose``). ``comment``, ``opt_barrier``, ``index_add``,
``scatter_add`` and ``dynamic_slice`` are the prims the VJP rules of
:mod:`thunder_tpu_torch.core.transforms` emit. Metas only compute output metadata and enforce the strict
contracts (same shapes for elementwise prims); broadcasting and promotion
happen in the op layer. The torch implementation of every prim is in
:mod:`thunder_tpu_torch.executors.eagertorch`. The reference's RNG,
collective, convolution, sort and replace-scatter prims are not ported
yet.
"""

from __future__ import annotations

import math
from enum import Enum, auto
from typing import Sequence

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.baseutils import canonicalize_dims, check
from thunder_tpu_torch.core.devices import default_device
from thunder_tpu_torch.core.proxies import NumberProxy, TensorProxy, pyval
from thunder_tpu_torch.core.symbol import Symbol


class PrimIDs(Enum):
    PYTHON_RETURN = auto(); PYTHON_DEL = auto(); COMMENT = auto(); OPT_BARRIER = auto()
    CHECK_TENSOR_SHAPE_AND_METADATA = auto(); CHECK_NUMBER_TYPE_AND_VALUE = auto()
    CHECK_STRING_VALUE = auto(); CHECK_LITERAL_LIKE = auto()
    CONVERT_ELEMENT_TYPE = auto(); DETACH = auto()
    FULL = auto(); IOTA = auto()
    BROADCAST_IN_DIM = auto(); CAT = auto(); FLIP = auto(); RESHAPE = auto(); SLICE = auto()
    SQUEEZE = auto(); TRANSPOSE = auto(); PAD = auto()
    TAKE = auto(); TAKE_ALONG_AXIS = auto(); INDEX_PUT = auto(); DYNAMIC_UPDATE_SLICE = auto()
    SCATTER_ADD = auto(); INDEX_ADD = auto(); DYNAMIC_SLICE = auto(); SCATTER = auto()
    ABS = auto(); ACOS = auto(); ASIN = auto(); ATAN = auto(); BITWISE_NOT = auto()
    CEIL = auto(); COS = auto(); COSH = auto(); ERF = auto(); ERFC = auto(); EXP = auto()
    EXP2 = auto(); EXPM1 = auto(); FLOOR = auto(); ISFINITE = auto(); ISINF = auto()
    ISNAN = auto(); LOG = auto(); LOG10 = auto(); LOG1P = auto(); LOG2 = auto()
    LOGICAL_NOT = auto(); NEG = auto(); RECIPROCAL = auto(); ROUND = auto(); RSQRT = auto()
    SIGN = auto(); SIN = auto(); SINH = auto(); SQRT = auto(); TAN = auto(); TANH = auto()
    TRUNC = auto()
    ADD = auto(); ATAN2 = auto(); BITWISE_AND = auto(); BITWISE_OR = auto()
    BITWISE_XOR = auto(); DIV = auto(); EQ = auto(); FMOD = auto(); GE = auto(); GT = auto()
    LE = auto(); LT = auto(); MAXIMUM = auto(); MINIMUM = auto(); MUL = auto(); NE = auto()
    POW = auto(); REMAINDER = auto(); SUB = auto(); FLOOR_DIV = auto()
    WHERE = auto()
    SUM = auto(); PROD = auto(); AMAX = auto(); AMIN = auto(); ARGMAX = auto(); ARGMIN = auto()
    CUMSUM = auto()
    DOT_GENERAL = auto()
    ITEM = auto()


class OpTags(Enum):
    SHAPE_OP = auto()
    REDUCTION_OP = auto()
    MATMUL_OP = auto()
    ELEMENTWISE_OP = auto()
    DONT_DCE = auto()
    CHECK_OP = auto()
    DEVICE_SYNC_OP = auto()


def make_prim(prim_id, name: str, meta, *, tags: Sequence[OpTags] = ()) -> Symbol:
    return Symbol(name, meta, id=prim_id, is_prim=True, tags=frozenset(tags))


# ---------------------------------------------------------------------------
# meta helpers
# ---------------------------------------------------------------------------

def _tensor_args(args) -> list[TensorProxy]:
    return [a for a in args if isinstance(a, TensorProxy)]


def _same_shape(*ts: TensorProxy) -> tuple[int, ...]:
    shapes = {t.shape for t in ts}
    check(len(shapes) <= 1, lambda: f"elementwise prim requires equal shapes, got {shapes}")
    return ts[0].shape


def _result_dtype(*args) -> dtypes.dtype:
    return dtypes.promote(*[a.dtype if isinstance(a, TensorProxy) else type(pyval(a))
                            for a in args])


def _make_ew_unary(pid, name, *, out_dtype=None, float_only=False):
    def meta(a):
        check(isinstance(a, TensorProxy), lambda: f"expected TensorProxy, got {type(a)}")
        if float_only:
            check(a.dtype.is_inexact, lambda: f"{name} requires floating dtype, got {a.dtype}")
        return TensorProxy(shape=a.shape, dtype=out_dtype or a.dtype, device=a.device)

    return make_prim(pid, name, meta, tags=(OpTags.ELEMENTWISE_OP,))


def _make_ew_binary(pid, name, *, bool_out=False):
    def meta(a, b):
        ts = _tensor_args((a, b))
        check(len(ts) >= 1, lambda: f"{name}: at least one operand must be a tensor")
        shape = _same_shape(*ts)
        dtype = dtypes.bool8 if bool_out else _result_dtype(a, b)
        return TensorProxy(shape=shape, dtype=dtype, device=ts[0].device)

    return make_prim(pid, name, meta, tags=(OpTags.ELEMENTWISE_OP,))


# ---------------------------------------------------------------------------
# utility and prologue prims
# ---------------------------------------------------------------------------

python_return = make_prim(PrimIDs.PYTHON_RETURN, "python_return", lambda v: None,
                          tags=(OpTags.DONT_DCE,))
python_del = make_prim(PrimIDs.PYTHON_DEL, "python_del", lambda *args: None,
                       tags=(OpTags.DONT_DCE,))
comment = make_prim(PrimIDs.COMMENT, "comment", lambda s: None, tags=(OpTags.DONT_DCE,))


def _opt_barrier_meta(*args):
    """Identity over its operands, with outputs of their own: it pins a
    checkpointed region's recompute to the cotangent, so CSE (which keys on
    operand identity) cannot merge the recompute back into the forward's
    saved values."""
    for a in args:
        check(isinstance(a, TensorProxy), "opt_barrier operands must be tensors")
    return tuple(TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device) for a in args)


opt_barrier = make_prim(PrimIDs.OPT_BARRIER, "opt_barrier", _opt_barrier_meta)

check_tensor_shape_and_metadata = make_prim(
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, "check_tensor_shape_and_metadata",
    lambda t, shape, dtype, device_str: None, tags=(OpTags.CHECK_OP, OpTags.DONT_DCE))
check_number_type_and_value = make_prim(
    PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE, "check_number_type_and_value", lambda n, v: None,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE))
check_string_value = make_prim(
    PrimIDs.CHECK_STRING_VALUE, "check_string_value", lambda s, v: None,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE))
check_literal_like = make_prim(
    PrimIDs.CHECK_LITERAL_LIKE, "check_literal_like", lambda x, v: None,
    tags=(OpTags.CHECK_OP, OpTags.DONT_DCE))


# ---------------------------------------------------------------------------
# dtype, creation
# ---------------------------------------------------------------------------

def _convert_element_type_meta(a: TensorProxy, dtype) -> TensorProxy:
    check(isinstance(a, TensorProxy), lambda: f"convert_element_type expects a tensor, got {type(a)}")
    return TensorProxy(shape=a.shape, dtype=dtypes.to_dtype(dtype), device=a.device)


convert_element_type = make_prim(PrimIDs.CONVERT_ELEMENT_TYPE, "convert_element_type",
                                 _convert_element_type_meta)
detach = make_prim(PrimIDs.DETACH, "detach",
                   lambda a: TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device))


def _full_meta(shape: Sequence[int], fill_value, dtype, device=None) -> TensorProxy:
    return TensorProxy(shape=tuple(shape), dtype=dtypes.to_dtype(dtype),
                       device=device or default_device())


full = make_prim(PrimIDs.FULL, "full", _full_meta)


def _iota_meta(length: int, *, start=0, step=1, dtype=dtypes.int64, device=None) -> TensorProxy:
    return TensorProxy(shape=(int(pyval(length)),), dtype=dtypes.to_dtype(dtype),
                       device=device or default_device())


iota = make_prim(PrimIDs.IOTA, "iota", _iota_meta)


# ---------------------------------------------------------------------------
# shape prims
# ---------------------------------------------------------------------------

def _broadcast_in_dim_meta(a: TensorProxy, shape: Sequence[int],
                           broadcast_dimensions: Sequence[int]) -> TensorProxy:
    shape = tuple(int(pyval(s)) for s in shape)
    bdims = tuple(broadcast_dimensions)
    check(len(bdims) == a.ndim,
          lambda: f"broadcast_in_dim: len(broadcast_dimensions)={len(bdims)} != rank {a.ndim}")
    for i, d in enumerate(bdims):
        check(a.shape[i] == 1 or a.shape[i] == shape[d],
              lambda: f"broadcast_in_dim: input dim {i} (size {a.shape[i]}) incompatible "
                      f"with output dim {d} (size {shape[d]})")
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


broadcast_in_dim = make_prim(PrimIDs.BROADCAST_IN_DIM, "broadcast_in_dim",
                             _broadcast_in_dim_meta, tags=(OpTags.SHAPE_OP,))


def _cat_meta(tensors: Sequence[TensorProxy], dim: int) -> TensorProxy:
    check(len(tensors) > 0, "cat of zero tensors")
    a = tensors[0]
    dim = canonicalize_dims(a.ndim, dim)[0]
    total = 0
    for t in tensors:
        check(t.ndim == a.ndim, "cat: rank mismatch")
        for i in range(a.ndim):
            if i != dim:
                check(t.shape[i] == a.shape[i], lambda: f"cat: shape mismatch on dim {i}")
        total += t.shape[dim]
    shape = list(a.shape)
    shape[dim] = total
    return TensorProxy(shape=tuple(shape), dtype=_result_dtype(*tensors), device=a.device)


cat = make_prim(PrimIDs.CAT, "cat", _cat_meta, tags=(OpTags.SHAPE_OP,))
flip = make_prim(PrimIDs.FLIP, "flip",
                 lambda a, dims: TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device),
                 tags=(OpTags.SHAPE_OP,))


def _reshape_meta(a: TensorProxy, shape: Sequence[int]) -> TensorProxy:
    shape = tuple(int(pyval(s)) for s in shape)
    check(math.prod(shape) == a.numel,
          lambda: f"reshape: cannot reshape {a.shape} ({a.numel} elems) to {shape}")
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


reshape = make_prim(PrimIDs.RESHAPE, "reshape", _reshape_meta, tags=(OpTags.SHAPE_OP,))


def _slice_meta(a: TensorProxy, start_indices: Sequence[int], end_indices: Sequence[int],
                strides: Sequence[int] | None = None) -> TensorProxy:
    strides = strides or [1] * a.ndim
    shape = []
    for s, e, st, n in zip(start_indices, end_indices, strides, a.shape):
        s, e, st = int(pyval(s)), int(pyval(e)), int(pyval(st))
        check(0 <= s <= e <= n and st > 0, lambda: f"bad slice [{s}:{e}:{st}] for dim of size {n}")
        shape.append((e - s + st - 1) // st)
    return TensorProxy(shape=tuple(shape), dtype=a.dtype, device=a.device)


slice_prim = make_prim(PrimIDs.SLICE, "slice_prim", _slice_meta, tags=(OpTags.SHAPE_OP,))


def _squeeze_meta(a: TensorProxy, dims: Sequence[int]) -> TensorProxy:
    dims = set(canonicalize_dims(a.ndim, tuple(dims)))
    for d in dims:
        check(a.shape[d] == 1, lambda: f"squeeze: dim {d} has size {a.shape[d]} != 1")
    return TensorProxy(shape=tuple(s for i, s in enumerate(a.shape) if i not in dims),
                       dtype=a.dtype, device=a.device)


squeeze = make_prim(PrimIDs.SQUEEZE, "squeeze", _squeeze_meta, tags=(OpTags.SHAPE_OP,))


def _transpose_meta(a: TensorProxy, permutation: Sequence[int]) -> TensorProxy:
    perm = tuple(permutation)
    check(sorted(perm) == list(range(a.ndim)), lambda: f"invalid permutation {perm} for rank {a.ndim}")
    return TensorProxy(shape=tuple(a.shape[p] for p in perm), dtype=a.dtype, device=a.device)


transpose = make_prim(PrimIDs.TRANSPOSE, "transpose", _transpose_meta, tags=(OpTags.SHAPE_OP,))


def _pad_meta(a: TensorProxy, padding_value, padding_config) -> TensorProxy:
    # lax.pad semantics: ``interior`` elements between neighbours (the VJP
    # of a strided slice); negative edge padding is not taken
    check(len(padding_config) == a.ndim, "pad: config length != rank")
    check(all(lo >= 0 and hi >= 0 and interior >= 0 for lo, hi, interior in padding_config),
          "pad: negative padding is not supported", NotImplementedError)
    shape = tuple(lo + hi + s + max(s - 1, 0) * interior
                  for (lo, hi, interior), s in zip(padding_config, a.shape))
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


pad = make_prim(PrimIDs.PAD, "pad", _pad_meta, tags=(OpTags.SHAPE_OP,))


def _take_meta(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    dim = canonicalize_dims(a.ndim, dim)[0]
    check(indices.dtype.is_int, "take: indices must be integer")
    return TensorProxy(shape=a.shape[:dim] + indices.shape + a.shape[dim + 1:],
                       dtype=a.dtype, device=a.device)


take = make_prim(PrimIDs.TAKE, "take", _take_meta)


def _take_along_axis_meta(a: TensorProxy, indices: TensorProxy, dim: int) -> TensorProxy:
    check(indices.ndim == a.ndim, "take_along_axis: rank mismatch")
    return TensorProxy(shape=indices.shape, dtype=a.dtype, device=a.device)


take_along_axis = make_prim(PrimIDs.TAKE_ALONG_AXIS, "take_along_axis", _take_along_axis_meta)
index_put = make_prim(
    PrimIDs.INDEX_PUT, "index_put",
    lambda a, indices, values, accumulate: TensorProxy(shape=a.shape, dtype=a.dtype,
                                                       device=a.device))
dynamic_update_slice = make_prim(
    PrimIDs.DYNAMIC_UPDATE_SLICE, "dynamic_update_slice",
    lambda a, update, start_indices: TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device))
dynamic_slice = make_prim(
    PrimIDs.DYNAMIC_SLICE, "dynamic_slice",
    lambda a, start_indices, slice_sizes: TensorProxy(
        shape=tuple(int(s) for s in slice_sizes), dtype=a.dtype, device=a.device))
# torch ``scatter_add`` semantics: a per-element index tensor along ``dim``
scatter_add = make_prim(
    PrimIDs.SCATTER_ADD, "scatter_add",
    lambda a, indices, value, dim: TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device))
# torch ``scatter`` semantics (replace, not accumulate; the reference's
# ``prims.scatter``, prims.py:485): a per-element index tensor along ``dim``
scatter = make_prim(
    PrimIDs.SCATTER, "scatter",
    lambda a, indices, value, dim: TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device))


def _index_add_meta(a: TensorProxy, indices: TensorProxy, value: TensorProxy,
                    dim: int) -> TensorProxy:
    """Row-wise scatter-add: ``indices`` is rank-1 (n,), ``value`` has
    ``a``'s shape with ``dim`` replaced by n, and each slice ``value[..., i,
    ...]`` is added to ``a[..., indices[i], ...]`` (torch ``index_add``)."""
    check(indices.ndim == 1, "index_add: indices must be rank-1")
    check(0 <= dim < a.ndim, lambda: f"index_add: dim {dim} out of range for rank {a.ndim}")
    expected = a.shape[:dim] + (indices.shape[0],) + a.shape[dim + 1:]
    check(tuple(value.shape) == expected,
          lambda: f"index_add: value shape {value.shape} != {expected}")
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


index_add = make_prim(PrimIDs.INDEX_ADD, "index_add", _index_add_meta)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

abs = _make_ew_unary(PrimIDs.ABS, "abs")
acos = _make_ew_unary(PrimIDs.ACOS, "acos", float_only=True)
asin = _make_ew_unary(PrimIDs.ASIN, "asin", float_only=True)
atan = _make_ew_unary(PrimIDs.ATAN, "atan", float_only=True)
bitwise_not = _make_ew_unary(PrimIDs.BITWISE_NOT, "bitwise_not")
ceil = _make_ew_unary(PrimIDs.CEIL, "ceil")
cos = _make_ew_unary(PrimIDs.COS, "cos", float_only=True)
cosh = _make_ew_unary(PrimIDs.COSH, "cosh", float_only=True)
erf = _make_ew_unary(PrimIDs.ERF, "erf", float_only=True)
erfc = _make_ew_unary(PrimIDs.ERFC, "erfc", float_only=True)
exp = _make_ew_unary(PrimIDs.EXP, "exp", float_only=True)
exp2 = _make_ew_unary(PrimIDs.EXP2, "exp2", float_only=True)
expm1 = _make_ew_unary(PrimIDs.EXPM1, "expm1", float_only=True)
floor = _make_ew_unary(PrimIDs.FLOOR, "floor")
isfinite = _make_ew_unary(PrimIDs.ISFINITE, "isfinite", out_dtype=dtypes.bool8)
isinf = _make_ew_unary(PrimIDs.ISINF, "isinf", out_dtype=dtypes.bool8)
isnan = _make_ew_unary(PrimIDs.ISNAN, "isnan", out_dtype=dtypes.bool8)
log = _make_ew_unary(PrimIDs.LOG, "log", float_only=True)
log10 = _make_ew_unary(PrimIDs.LOG10, "log10", float_only=True)
log1p = _make_ew_unary(PrimIDs.LOG1P, "log1p", float_only=True)
log2 = _make_ew_unary(PrimIDs.LOG2, "log2", float_only=True)
logical_not = _make_ew_unary(PrimIDs.LOGICAL_NOT, "logical_not", out_dtype=dtypes.bool8)
neg = _make_ew_unary(PrimIDs.NEG, "neg")
reciprocal = _make_ew_unary(PrimIDs.RECIPROCAL, "reciprocal", float_only=True)
round = _make_ew_unary(PrimIDs.ROUND, "round")
rsqrt = _make_ew_unary(PrimIDs.RSQRT, "rsqrt", float_only=True)
sign = _make_ew_unary(PrimIDs.SIGN, "sign")
sin = _make_ew_unary(PrimIDs.SIN, "sin", float_only=True)
sinh = _make_ew_unary(PrimIDs.SINH, "sinh", float_only=True)
sqrt = _make_ew_unary(PrimIDs.SQRT, "sqrt", float_only=True)
tan = _make_ew_unary(PrimIDs.TAN, "tan", float_only=True)
tanh = _make_ew_unary(PrimIDs.TANH, "tanh", float_only=True)
trunc = _make_ew_unary(PrimIDs.TRUNC, "trunc")

add = _make_ew_binary(PrimIDs.ADD, "add")
atan2 = _make_ew_binary(PrimIDs.ATAN2, "atan2")
bitwise_and = _make_ew_binary(PrimIDs.BITWISE_AND, "bitwise_and")
bitwise_or = _make_ew_binary(PrimIDs.BITWISE_OR, "bitwise_or")
bitwise_xor = _make_ew_binary(PrimIDs.BITWISE_XOR, "bitwise_xor")


def _div_meta(a, b):
    # true division: integer operands give a float result
    ts = _tensor_args((a, b))
    check(len(ts) >= 1, "div: at least one operand must be a tensor")
    shape = _same_shape(*ts)
    dtype = _result_dtype(a, b)
    if not dtype.is_inexact:
        dtype = dtypes.float32
    return TensorProxy(shape=shape, dtype=dtype, device=ts[0].device)


div = make_prim(PrimIDs.DIV, "div", _div_meta, tags=(OpTags.ELEMENTWISE_OP,))
eq = _make_ew_binary(PrimIDs.EQ, "eq", bool_out=True)
fmod = _make_ew_binary(PrimIDs.FMOD, "fmod")
ge = _make_ew_binary(PrimIDs.GE, "ge", bool_out=True)
gt = _make_ew_binary(PrimIDs.GT, "gt", bool_out=True)
le = _make_ew_binary(PrimIDs.LE, "le", bool_out=True)
lt = _make_ew_binary(PrimIDs.LT, "lt", bool_out=True)
maximum = _make_ew_binary(PrimIDs.MAXIMUM, "maximum")
minimum = _make_ew_binary(PrimIDs.MINIMUM, "minimum")
mul = _make_ew_binary(PrimIDs.MUL, "mul")
ne = _make_ew_binary(PrimIDs.NE, "ne", bool_out=True)
pow = _make_ew_binary(PrimIDs.POW, "pow")
remainder = _make_ew_binary(PrimIDs.REMAINDER, "remainder")
floor_div = _make_ew_binary(PrimIDs.FLOOR_DIV, "floor_div")
sub = _make_ew_binary(PrimIDs.SUB, "sub")


def _where_meta(pred, a, b) -> TensorProxy:
    ts = _tensor_args((pred, a, b))
    check(len(ts) >= 1, "where: at least one operand must be a tensor")
    shape = _same_shape(*ts)
    return TensorProxy(shape=shape, dtype=_result_dtype(a, b), device=ts[0].device)


where = make_prim(PrimIDs.WHERE, "where", _where_meta, tags=(OpTags.ELEMENTWISE_OP,))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduction_shape(a: TensorProxy, dims) -> tuple[int, ...]:
    dims = set(dims)
    return tuple(s for i, s in enumerate(a.shape) if i not in dims)


def _make_reduction(pid, name, *, widen_exact: bool = False):
    def meta(a: TensorProxy, dims: Sequence[int]) -> TensorProxy:
        dims = canonicalize_dims(a.ndim, tuple(dims))
        # torch sums and multiplies integers and bools in int64
        dtype = dtypes.int64 if widen_exact and a.dtype.is_exact else a.dtype
        return TensorProxy(shape=_reduction_shape(a, dims), dtype=dtype, device=a.device)

    return make_prim(pid, name, meta, tags=(OpTags.REDUCTION_OP,))


sum = _make_reduction(PrimIDs.SUM, "sum", widen_exact=True)
prod = _make_reduction(PrimIDs.PROD, "prod", widen_exact=True)
amax = _make_reduction(PrimIDs.AMAX, "amax")
amin = _make_reduction(PrimIDs.AMIN, "amin")


def _arg_reduction_meta(a: TensorProxy, dim: int | None) -> TensorProxy:
    # index results are int64, as torch computes them
    if dim is None:
        return TensorProxy(shape=(), dtype=dtypes.int64, device=a.device)
    d = canonicalize_dims(a.ndim, dim)[0]
    return TensorProxy(shape=_reduction_shape(a, (d,)), dtype=dtypes.int64, device=a.device)


argmax = make_prim(PrimIDs.ARGMAX, "argmax", _arg_reduction_meta, tags=(OpTags.REDUCTION_OP,))
argmin = make_prim(PrimIDs.ARGMIN, "argmin", _arg_reduction_meta, tags=(OpTags.REDUCTION_OP,))
cumsum = make_prim(PrimIDs.CUMSUM, "cumsum", lambda a, dim: TensorProxy(
    shape=a.shape, dtype=dtypes.int64 if a.dtype.is_exact else a.dtype, device=a.device))


# ---------------------------------------------------------------------------
# contraction
# ---------------------------------------------------------------------------

def _dot_general_meta(a: TensorProxy, b: TensorProxy, *, contract_dims, batch_dims=((), ()),
                      preferred_element_type=None) -> TensorProxy:
    (ac, bc), (ab, bb) = contract_dims, batch_dims
    check(len(ac) == len(bc), "dot_general: contracting dim count mismatch")
    check(len(ab) == len(bb), "dot_general: batch dim count mismatch")
    for i, j in zip(ac, bc):
        check(a.shape[i] == b.shape[j],
              lambda: f"dot_general: contract dim mismatch a.shape[{i}]={a.shape[i]} "
                      f"b.shape[{j}]={b.shape[j]}")
    for i, j in zip(ab, bb):
        check(a.shape[i] == b.shape[j], "dot_general: batch dim mismatch")
    batch_shape = tuple(a.shape[i] for i in ab)
    a_free = tuple(s for i, s in enumerate(a.shape) if i not in ac and i not in ab)
    b_free = tuple(s for i, s in enumerate(b.shape) if i not in bc and i not in bb)
    out_dtype = preferred_element_type or dtypes.promote(a.dtype, b.dtype)
    return TensorProxy(shape=batch_shape + a_free + b_free, dtype=dtypes.to_dtype(out_dtype),
                       device=a.device)


dot_general = make_prim(PrimIDs.DOT_GENERAL, "dot_general", _dot_general_meta,
                        tags=(OpTags.MATMUL_OP,))


def _item_meta(a: TensorProxy) -> NumberProxy:
    check(a.numel == 1, "item() requires a 1-element tensor")
    py = float if a.dtype.is_float else (bool if a.dtype.is_bool else int)
    return NumberProxy(py(0), python_type=py)


item = make_prim(PrimIDs.ITEM, "item", _item_meta, tags=(OpTags.DEVICE_SYNC_OP,))
