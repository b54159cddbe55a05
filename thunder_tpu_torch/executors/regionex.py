"""The region executor: regions of a program as generated kernels.

The counterpart of ``thunder_tpu/executors/xla.py`` (``XLAFusionExecutor``
:77), which hands each fused region to ``jax.jit`` and lets XLA fuse it,
reductions included (its ``can_fuse`` :84-99 takes any prim with an eager
implementation). Here the ``region`` fusion executor groups the unclaimed
prims of an execution trace that it can generate (every prim tagged
``ELEMENTWISE_OP``, ``broadcast_in_dim``, ``convert_element_type``,
``sum``/``amax``/``amin``/``argmax``/``argmin`` over the trailing dims of
their input, and the ``reshape``/``squeeze`` views that only add or drop 1s,
as ``keepdim`` does; never a reduction over a leading or middle dim, a
``prod`` or ``cumsum``, a view of another kind, a host-sync op or anything
another executor claimed) with the reference's dataflow partitioner
(:mod:`~thunder_tpu_torch.executors.data_dependent_partition`), splits each
group into row spaces and output shapes (:func:`split_row_spaces`), and
binds each part of at least ``region_min_region_size`` members as one
symbol ``region.fusion<i>``, its members kept as subsymbols.

A region is one row space ``(S, r)``: S its iteration shape, r how many of
S's trailing dims its reductions reduce. Its members are the elementwise,
broadcast and convert members of shape S, the reductions of S over its last
r dims, the per-row members of the kept shape (S without its last r dims,
with or without 1s) that read a reduction's result or that only the row
space reads, and the broadcasts of per-row values back to S. A region of
one output shape without reductions is the r = 0 case.

A region's callable (:class:`Region`) runs its plain version for tensors on
the CPU: the members' torch implementations in order (the reference's
``run_bsyms``). For tensors on the card it launches one kernel generated
from its members as CUDA C++ for ``sm_90a`` (:func:`region_source`, or
:func:`reduce_source` for a region with reductions), compiled by ``nvcc``
and bound with ``ctypes`` as the hand-written kernels of
:mod:`~thunder_tpu_torch.executors.cudaex` are, or raises. It replaces no
Pallas kernel: it stands for the XLA fusions the reference's regions
become. It is bound by bytes (each input read once, each output written
once). An elementwise region is one pass over its iteration space, every
intermediate kept in registers. A region with reductions is one CTA a row
of S (grid-striding over the rows): a pass over the row for each reduction
level (a reduction whose input depends on an earlier reduction's result is
a level deeper), then the per-row members of that level, broadcast to the
CTA, and a last pass for the outputs of S that follow the last level; each
pass recomputes from the inputs the members of S it needs, so nothing of
shape S but the region's outputs is written. The block reductions combine
in a fixed order (``csrc/region.cuh``), so two launches on the same inputs
agree bit for bit.

Numerics: the region equals its plain chain, but for the order of a sum's
terms. Each op computes as torch's CUDA kernel does: 16-bit values in
float32 (opmath), each member's result rounded to the dtype the trace gives
it (``__float2bfloat16_rn`` / ``__float2half_rn``); no FMA contraction
(``--fmad=false``); constants as exact hex literals, converted as torch
converts a Python scalar (to the compute type); the device math functions
torch calls (``expf``, ``logf``, ``rsqrtf``, ``sinf``, ``cosf``; no fast
math); ``t / c`` as torch computes it, ``t * (1 / c)``, and ``c / t`` as
``reciprocal(t) * c``; integer ``floor_divide`` by a constant rounded toward
minus infinity. Bool and integer members keep their dtypes. A ``sum``
accumulates as torch's does (float32 for the 16-bit floats and float32,
rounded once to its dtype; float64; int64 for bools and integers), in
another order than torch's kernel; ``amax``/``amin`` propagate NaN;
``argmax``/``argmin`` take the lowest index among equal extremes, a NaN
counting as the extreme.

Source and build: a region's source depends only on its ops, constants,
dtypes and rank; sizes and each input's strides (its torch strides,
composed with a member's broadcast: stride 0 on a broadcast dim) are
launch arguments, so one source serves every shape. The first launch of
any region of a program compiles every region of that program not built
yet, by one ``nvcc`` into one library in ``thunder_tpu_torch/_build/``
under a hash of its source; a library already there is loaded without
``nvcc`` (:func:`build_regions`, :func:`nvcc_seconds`). A region whose source does not build raises
``KernelBuildError`` naming it at its first launch (its log in
``cudaex.build_failures()``, where :data:`KERNEL` is registered); nothing
runs the plain chain on the card in its place.

Launches: each one counts under the ``region`` entry of
``cudaex.launch_counts()`` (design ``contiguous``, ``strided`` or
``reduce``), on ``torch.cuda.current_stream()``; its arguments follow from
shapes and strides, so a CUDA graph captures it (``cudagraphex``). 64-bit
indices where the iteration space or an offset passes 2^31 - 1.

The reference's ``xla_absorb_claimed`` is not ported: a hand-written
kernel cannot run inside a generated one (ROADMAP C).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import Proxy, TensorProxy, Variable
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.core.symbol import BoundSymbol, Symbol, run_bsyms
from thunder_tpu_torch.core.trace import TraceCtx, from_trace
from thunder_tpu_torch.core.utils import consumed_vars, produced_vars
from thunder_tpu_torch.executors import FusionExecutor, cudaex, register_executor
from thunder_tpu_torch.observe import decisions as _decisions
from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.runtime.faults import KernelBuildError, KernelLaunchError

_NOFUSE_IDS = frozenset(getattr(PrimIDs, n) for n in (
    "PYTHON_RETURN", "COMMENT", "PYTHON_DEL", "PYTHON_PRINT", "SINK", "ITEM", "UNPACK_TRIVIAL",
    "DEVICE_PUT", "CHECK_TENSOR_SHAPE_AND_METADATA", "CHECK_NUMBER_TYPE_AND_VALUE",
    "CHECK_STRING_VALUE", "CHECK_LITERAL_LIKE") if hasattr(PrimIDs, n))

# the nvcc flags of a region library: no FMA contraction, no fast math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
              "-shared", "-Xcompiler", "-fPIC")
THREADS = 256
BLOCKS_PER_SM = 8
# a region with row reductions: at most this many threads a CTA, and rows
# that do not fill the card split across clusters of up to MAX_CLUSTER CTAs
# (the portable cluster size), each taking at least CLUSTER_MIN_PART of its row
ROW_THREADS = 1024
MAX_CLUSTER = 8
CLUSTER_MIN_PART = 2048
# kernel parameters past this many bytes (pointers, sizes, strides) split
# nothing: such a group stays unfused
MAX_PARAM_BYTES = 4000
HEADER = cudaex.CSRC / "region.cuh"
# the partitions of the last PARTITION_CACHE program texts (RegionExecutor._units)
PARTITION_CACHE = 64
_PARTITIONS: dict = {}

# -- dtypes -------------------------------------------------------------------

# dtype name -> (storage C type, compute C type)
_CTYPES = {
    "float32": ("float", "float"), "bfloat16": ("__nv_bfloat16", "float"),
    "float16": ("__half", "float"), "float64": ("double", "double"), "bool8": ("bool", "bool"),
    "uint8": ("uint8_t", "uint8_t"), "int8": ("int8_t", "int8_t"),
    "int16": ("int16_t", "int16_t"), "int32": ("int32_t", "int32_t"),
    "int64": ("int64_t", "int64_t")}


def _ct(dt: dtypes.dtype) -> str:
    return _CTYPES[dt.name][1]


def _round(expr: str, dt: dtypes.dtype) -> str:
    """``expr`` (in the compute type) rounded to ``dt`` and held in its
    compute type."""
    if dt.name == "bfloat16":
        return f"ttr::rnd_bf16({expr})"
    if dt.name == "float16":
        return f"ttr::rnd_f16({expr})"
    return f"(({_ct(dt)})({expr}))"


def _convert(expr: str, src: dtypes.dtype, dst: dtypes.dtype) -> str:
    """A value of ``src`` (in its compute type) as ``dst`` would hold it,
    converted as torch's ``.to(dst)`` converts."""
    if dst.is_bool:
        return f"(({expr}) != 0)"
    if dst.name in ("bfloat16", "float16"):
        return _round(f"(float)({expr})", dst)
    return f"(({_ct(dst)})({expr}))"


def _literal(value, dt: dtypes.dtype) -> str:
    """The Python scalar ``value`` as torch converts it for an operand of
    compute type ``_ct(dt)``: exact hex literals for floats."""
    ct = _ct(dt)
    if ct == "bool":
        return "true" if value else "false"
    if ct == "float":
        f = float(np.float32(value))
        if math.isnan(f):
            return "__int_as_float(0x7fc00000)"
        if math.isinf(f):
            return "__int_as_float(0x7f800000)" if f > 0 else "__int_as_float(0xff800000)"
        return f"{f.hex()}f"
    if ct == "double":
        f = float(value)
        if math.isnan(f):
            return "__longlong_as_double(0x7ff8000000000000LL)"
        if math.isinf(f):
            return ("__longlong_as_double(0x7ff0000000000000LL)" if f > 0
                    else "__longlong_as_double(0xfff0000000000000LL)")
        return f.hex()
    v = int(value)
    return f"(({ct})(-9223372036854775807LL - 1))" if v == -2 ** 63 else f"(({ct})({v}LL))"


def _load(ref: str, dt: dtypes.dtype) -> str:
    if dt.name == "bfloat16":
        return f"__bfloat162float({ref})"
    if dt.name == "float16":
        return f"__half2float({ref})"
    return ref


def _store(v: str, dt: dtypes.dtype) -> str:
    if dt.name == "bfloat16":
        return f"__float2bfloat16_rn({v})"
    if dt.name == "float16":
        return f"__float2half_rn({v})"
    return v


def _offsets(rank: int, nloads: int) -> list[str]:
    """Each load's element offset of flat index ``i``: ``i`` itself where
    every load is dense over the iteration space, else the coordinates of
    ``i`` times the load's strides."""
    lines = ["    if (a.contiguous) {", *(f"      o[{k}] = i;" for k in range(nloads)),
             "    } else {", *(f"      o[{k}] = 0;" for k in range(nloads))]
    if rank:
        lines += ["      I r = i;",
                  f"      for (int d = {rank - 1}; d >= 0; --d) {{",
                  "        const I sz = static_cast<I>(a.size[d]);",
                  "        const I c = r % sz;",
                  "        r /= sz;",
                  *(f"        o[{k}] += c * static_cast<I>(a.stride[{k}][d]);"
                    for k in range(nloads)),
                  "      }"]
    return lines + ["    }"]


def _inverse(value, dt: dtypes.dtype) -> str:
    """``1 / value`` computed in the compute type, as torch's ``t / c``
    computes it on the host before it multiplies."""
    if _ct(dt) == "double":
        return _literal(1.0 / float(value), dt)
    return _literal(np.float32(1.0) / np.float32(value), dt)


# -- ops ----------------------------------------------------------------------

_FLOAT_UNARY = {
    PrimIDs.EXP: "exp", PrimIDs.LOG: "log", PrimIDs.SIN: "sin", PrimIDs.COS: "cos",
    PrimIDs.TANH: "tanh", PrimIDs.SQRT: "sqrt", PrimIDs.RSQRT: "rsqrt", PrimIDs.ERF: "erf",
    PrimIDs.ERFC: "erfc", PrimIDs.LOG1P: "log1p", PrimIDs.EXPM1: "expm1",
    PrimIDs.EXP2: "exp2", PrimIDs.LOG2: "log2", PrimIDs.LOG10: "log10", PrimIDs.TAN: "tan",
    PrimIDs.ATAN: "atan", PrimIDs.ASIN: "asin", PrimIDs.ACOS: "acos", PrimIDs.SINH: "sinh",
    PrimIDs.COSH: "cosh", PrimIDs.FLOOR: "floor", PrimIDs.CEIL: "ceil", PrimIDs.TRUNC: "trunc",
    PrimIDs.ROUND: "nearbyint"}
# the ops whose device functions may differ from the chain's in the last
# place (held within 1 ulp of the output dtype; every other op bit for bit)
TRANSCENDENTAL = frozenset(set(_FLOAT_UNARY) - {
    PrimIDs.SQRT, PrimIDs.FLOOR, PrimIDs.CEIL, PrimIDs.TRUNC, PrimIDs.ROUND} | {PrimIDs.POW})
_ARITH = {PrimIDs.ADD: "+", PrimIDs.SUB: "-", PrimIDs.MUL: "*"}
_COMPARE = {PrimIDs.EQ: "==", PrimIDs.NE: "!=", PrimIDs.LT: "<", PrimIDs.LE: "<=",
            PrimIDs.GT: ">", PrimIDs.GE: ">="}
_BITWISE = {PrimIDs.BITWISE_AND: "&", PrimIDs.BITWISE_OR: "|", PrimIDs.BITWISE_XOR: "^"}
_UNARY_OTHER = (PrimIDs.NEG, PrimIDs.ABS, PrimIDs.RECIPROCAL, PrimIDs.LOGICAL_NOT,
                PrimIDs.BITWISE_NOT, PrimIDs.ISNAN, PrimIDs.ISINF, PrimIDs.ISFINITE)


def _is_number(x) -> bool:
    return isinstance(x, (bool, int, float)) and not isinstance(x, Proxy)


def _dtype_of(x):
    return x.dtype if isinstance(x, TensorProxy) else type(x)


_REDUCTIONS = (PrimIDs.SUM, PrimIDs.AMAX, PrimIDs.AMIN, PrimIDs.ARGMAX, PrimIDs.ARGMIN)
# the dtypes amax, amin, argmax and argmin take in a region (each shuffled
# as itself between a warp's lanes)
_EXTREME_DTYPES = ("float32", "bfloat16", "float16", "float64", "int32", "int64")
# the longest row a region reduces: one CTA reads the whole row
MAX_ROW = 1 << 20


def _reduced_dims(b: BoundSymbol) -> tuple | None:
    """The dims the reduction ``b`` reduces (sorted), None for any other
    member."""
    if b.sym.id not in _REDUCTIONS or not b.args or not isinstance(b.args[0], TensorProxy):
        return None
    nd = b.args[0].ndim
    if b.sym.id in (PrimIDs.ARGMAX, PrimIDs.ARGMIN):
        dim = b.args[1] if len(b.args) > 1 else None
        if dim is None:
            return tuple(range(nd))
        return (dim % nd,) if nd else None
    return tuple(sorted(d % nd for d in b.args[1])) if nd else None


def trailing_r(b: BoundSymbol) -> int | None:
    """How many trailing dims the reduction ``b`` reduces, where it reduces
    trailing dims only (1 or more, over more than one element and at most
    :data:`MAX_ROW`); None for any other member or reduction."""
    dims = _reduced_dims(b)
    if not dims:
        return None
    a = b.args[0]
    r = len(dims)
    if dims != tuple(range(a.ndim - r, a.ndim)):
        return None
    n = math.prod(a.shape[a.ndim - r:])
    return r if 1 < n <= MAX_ROW else None


def is_unit_view(b: BoundSymbol) -> bool:
    """Is ``b`` a ``reshape`` or ``squeeze`` that only adds or drops dims of
    size 1 (``keepdim``'s view of a reduction's result)?"""
    if b.sym.id not in (PrimIDs.RESHAPE, PrimIDs.SQUEEZE) or not b.args:
        return False
    a, outs = b.args[0], b.flat_proxy_outs()
    if not isinstance(a, TensorProxy) or len(outs) != 1:
        return False
    return _non_unit(a.shape) == _non_unit(outs[0].shape)


def _non_unit(shape) -> list:
    return [s for s in shape if s != 1]


def _supported(b: BoundSymbol) -> bool:
    """Can :func:`region_source` or :func:`reduce_source` generate the
    member ``b`` exactly?"""
    pid, args = b.sym.id, b.args
    outs = b.flat_proxy_outs()
    if len(outs) != 1 or not isinstance(outs[0], TensorProxy) or b.kwargs:
        return False
    out = outs[0]
    tensors = [a for a in args if isinstance(a, TensorProxy)]
    if not tensors or any(t.dtype.name not in _CTYPES for t in tensors + [out]):
        return False
    if any(t.device != out.device for t in tensors):
        return False
    if pid in (PrimIDs.BROADCAST_IN_DIM, PrimIDs.CONVERT_ELEMENT_TYPE):
        return True
    if pid in _REDUCTIONS:
        if trailing_r(b) is None:
            return False
        if pid is PrimIDs.SUM:
            return True
        return tensors[0].dtype.name in _EXTREME_DTYPES
    if pid in (PrimIDs.RESHAPE, PrimIDs.SQUEEZE):
        return is_unit_view(b)
    operands = args
    if not all(isinstance(a, TensorProxy) or _is_number(a) for a in operands):
        return False
    if pid in _FLOAT_UNARY:
        return out.dtype.is_float
    if pid in _UNARY_OTHER:
        if pid is PrimIDs.RECIPROCAL:
            return out.dtype.is_float
        if pid in (PrimIDs.NEG, PrimIDs.ABS):
            return not out.dtype.is_bool
        return True
    if pid in _ARITH or pid is PrimIDs.DIV:
        return not out.dtype.is_bool
    if pid in _COMPARE:
        return True
    if pid in _BITWISE:
        return not out.dtype.is_float
    if pid in (PrimIDs.MAXIMUM, PrimIDs.MINIMUM):
        # torch.clamp keeps the tensor's dtype: only where the prim's does too
        num = [a for a in operands if _is_number(a)]
        return not num or tensors[0].dtype == out.dtype
    if pid is PrimIDs.POW:
        # powf of a float base and a tensor exponent; a number exponent takes
        # torch's special cases (x * x, sqrt, ...) and stays unfused
        return (out.dtype.name in ("float32", "float64") and isinstance(operands[1], TensorProxy)
                and all(_dtype_of(a) in (float, out.dtype) for a in operands))
    if pid is PrimIDs.WHERE:
        return isinstance(operands[0], TensorProxy) and operands[0].dtype.is_bool
    if pid is PrimIDs.FLOOR_DIV:
        # integers by a nonzero integer constant (torch's floor_divide)
        c = operands[1]
        return (out.dtype.is_exact and not out.dtype.is_bool
                and isinstance(operands[0], TensorProxy) and operands[0].dtype == out.dtype
                and isinstance(c, int) and not isinstance(c, bool) and c != 0)
    return False


def _math(fn: str, ct: str) -> str:
    return f"{fn}f" if ct == "float" else fn


def _member_expr(b: BoundSymbol, val) -> str:
    """The expression, in the member's compute type and rounded to its
    dtype, of member ``b``; ``val(a, dt)`` is operand ``a`` in the compute
    type of dtype ``dt`` (a value's variable or a literal)."""
    pid, args = b.sym.id, b.args
    out = b.flat_proxy_outs()[0]
    dt = out.dtype
    ct = _ct(dt)
    if pid is PrimIDs.CONVERT_ELEMENT_TYPE:
        return _convert(val(args[0], None), args[0].dtype, dt)
    if pid is PrimIDs.BROADCAST_IN_DIM:
        return val(args[0], None)
    if pid in _FLOAT_UNARY:
        return _round(f"{_math(_FLOAT_UNARY[pid], ct)}({val(args[0], dt)})", dt)
    if pid is PrimIDs.NEG:
        return _round(f"-({val(args[0], dt)})", dt)
    if pid is PrimIDs.ABS:
        x = val(args[0], dt)
        return _round(f"{_math('fabs', ct)}({x})" if dt.is_float
                      else f"(({x}) < 0 ? -({x}) : ({x}))", dt)
    if pid is PrimIDs.RECIPROCAL:
        return _round(f"(({ct})1) / ({val(args[0], dt)})", dt)
    if pid is PrimIDs.LOGICAL_NOT:
        return f"!(({val(args[0], None)}) != 0)"
    if pid is PrimIDs.BITWISE_NOT:
        x = val(args[0], dt)
        return f"!({x})" if dt.is_bool else _round(f"~({x})", dt)
    if pid in (PrimIDs.ISNAN, PrimIDs.ISINF, PrimIDs.ISFINITE):
        a = args[0]
        if not a.dtype.is_float:
            return "true" if pid is PrimIDs.ISFINITE else "false"
        x = val(a, None)
        return {PrimIDs.ISNAN: f"(({x}) != ({x}))", PrimIDs.ISINF: f"isinf({x})",
                PrimIDs.ISFINITE: f"isfinite({x})"}[pid]
    if pid in _COMPARE:
        common = dtypes.promote(*(_dtype_of(a) for a in args))
        return f"(({val(args[0], common)}) {_COMPARE[pid]} ({val(args[1], common)}))"
    if pid in _BITWISE:
        return _round(f"({val(args[0], dt)}) {_BITWISE[pid]} ({val(args[1], dt)})", dt)
    if pid in _ARITH:
        return _round(f"({val(args[0], dt)}) {_ARITH[pid]} ({val(args[1], dt)})", dt)
    if pid is PrimIDs.DIV:
        a, c = args
        if _is_number(c):      # torch: t * (1 / c), the inverse taken in the compute type
            return _round(f"({val(a, dt)}) * {_inverse(c, dt)}", dt)
        if _is_number(a):      # torch's __rtruediv__: reciprocal(t) * c
            return _round(f"{_round(f'(({ct})1) / ({val(c, dt)})', dt)} * {_literal(a, dt)}", dt)
        return _round(f"({val(a, dt)}) / ({val(c, dt)})", dt)
    if pid in (PrimIDs.MAXIMUM, PrimIDs.MINIMUM):
        fn = "max" if pid is PrimIDs.MAXIMUM else "min"
        a, c = args
        if not dt.is_float:
            return _round(f"{fn}(({val(a, dt)}), ({val(c, dt)}))", dt)
        f = _math(f"f{fn}", ct)
        if _is_number(a):
            a, c = c, a
        x, y = val(a, dt), val(c, dt)
        if _is_number(c):      # torch.clamp: NaN stays, else max with the bound
            return _round(f"(({x}) != ({x}) ? ({x}) : {f}(({x}), ({y})))", dt)
        return _round(f"(({x}) != ({x}) ? ({x}) : (({y}) != ({y}) ? ({y}) : {f}(({x}), ({y}))))",
                      dt)
    if pid is PrimIDs.POW:
        return _round(f"{_math('pow', ct)}(({val(args[0], dt)}), ({val(args[1], dt)}))", dt)
    if pid is PrimIDs.WHERE:
        p, a, c = args
        return _round(f"(({val(p, None)}) ? ({val(a, dt)}) : ({val(c, dt)}))", dt)
    if pid is PrimIDs.FLOOR_DIV:
        return f"ttr::floor_div<{ct}>(({val(args[0], dt)}), {_literal(args[1], dt)})"
    raise AssertionError(f"region: no code for {b.sym.name}")


# -- the generated source -----------------------------------------------------

@dataclass
class RegionSpec:
    """What a region's kernel reads and writes: ``loads`` one
    ``(input index, broadcast dims or None)`` for each distinct read of an
    input (a member's broadcast reads its input through its own strides),
    ``source`` the generated CUDA C++, ``entry`` its C entry point (named by
    a hash of the source), ``transcendental`` whether a member's device
    function may differ from the chain's in the last place. A region with
    row reductions (:func:`reduce_source`) has ``rows`` set: ``(S, r)``,
    its row space (the members' iteration shape and how many of its trailing
    dims they reduce); its ``loads`` are then ``(input index, "S" or "K",
    iteration shape, broadcast dims or None)``: a read at each element of
    ``S`` or once a row."""

    loads: list
    source: str
    entry: str
    transcendental: bool
    rows: tuple | None = None
    param_bytes: int = 0


def region_source(members: list[BoundSymbol], inputs: list[Proxy],
                  outputs: list[TensorProxy]) -> RegionSpec:
    """Generate the kernel of one region: its members in order, each held
    in a register of its compute type, over the iteration space of the
    members' common output shape."""
    shape = tuple(outputs[0].shape)
    rank = len(shape)
    in_index = {p.name: i for i, p in enumerate(inputs)}
    loads: list[tuple] = []
    load_of: dict[tuple, int] = {}
    var: dict[str, str] = {}          # proxy name -> variable holding it
    body: list[str] = []

    def load(p: TensorProxy, bdims) -> str:
        key = (in_index[p.name], None if bdims is None else tuple(bdims))
        if key not in load_of:
            load_of[key] = len(loads)
            loads.append(key)
            k = load_of[key]
            body.append(f"    const {_ct(p.dtype)} l{k} = "
                        f"{_load(f'(({_CTYPES[p.dtype.name][0]}*)a.p[{key[0]}])[o[{k}]]', p.dtype)};")
        return f"l{load_of[key]}"

    def val(a, dt) -> str:
        if _is_number(a):
            return _literal(a, dt)
        src = var[a.name] if a.name in var else load(a, None)
        if dt is None:
            return src
        return _convert(src, a.dtype, dt) if a.dtype != dt else src

    for j, b in enumerate(members):
        out = b.flat_proxy_outs()[0]
        if b.sym.id is PrimIDs.BROADCAST_IN_DIM and b.args[0].name not in var:
            expr = load(b.args[0], b.args[2])
        else:
            expr = _member_expr(b, val)
        body.append(f"    const {_ct(out.dtype)} v{j} = {expr};")
        var[out.name] = f"v{j}"
    ni = len(inputs)
    for k, o in enumerate(outputs):
        body.append(f"    (({_CTYPES[o.dtype.name][0]}*)a.p[{ni + k}])[i] = "
                    f"{_store(var[o.name], o.dtype)};")
    nl, rr = max(len(loads), 1), max(rank, 1)
    summary = ", ".join(b.sym.name for b in members)
    src = "\n".join([
        f"// region: {summary} -> {', '.join(o.dtype.name for o in outputs)}, rank {rank}",
        "namespace {",
        "struct Args@ {",
        f"  void* p[{ni + len(outputs)}];",
        f"  long long size[{rr}];",
        f"  long long stride[{nl}][{rr}];",
        "  long long n;",
        "  int contiguous;",
        "};",
        "template <typename I>",
        f"__global__ void __launch_bounds__({THREADS}) tt_region_kernel@(const Args@ a) {{",
        "  const I n = static_cast<I>(a.n);",
        "  for (I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;",
        "       i += static_cast<I>(gridDim.x) * blockDim.x) {",
        f"    I o[{nl}];",
        *_offsets(rank, len(loads)),
        *body,
        "  }",
        "}",
        "}  // namespace",
        'extern "C" int @entry(void* const* ptrs, const long long* meta, int idx64, int blocks,',
        "                      void* stream) {",
        "  Args@ a;",
        f"  for (int k = 0; k < {ni + len(outputs)}; ++k) a.p[k] = ptrs[k];",
        "  a.n = meta[0];",
        "  a.contiguous = static_cast<int>(meta[1]);",
        f"  for (int d = 0; d < {rank}; ++d) a.size[d] = meta[2 + d];",
        f"  for (int k = 0; k < {len(loads)}; ++k)",
        f"    for (int d = 0; d < {rank}; ++d) a.stride[k][d] = meta[2 + {rank} + k * {rank} + d];",
        "  auto s = static_cast<cudaStream_t>(stream);",
        "  if (idx64) tt_region_kernel@<long long><<<blocks, " + str(THREADS) + ", 0, s>>>(a);",
        "  else tt_region_kernel@<int><<<blocks, " + str(THREADS) + ", 0, s>>>(a);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
    ])
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    entry = f"tt_region_{digest}"
    src = src.replace("@entry", entry).replace("@", f"_{digest}")
    return RegionSpec(loads, src, entry, any(b.sym.id in TRANSCENDENTAL for b in members))


def row_roles(members: list[BoundSymbol]) -> tuple[tuple, int, dict] | None:
    """The row space ``(S, r)`` of a region's members and each member's
    role (``"S"``: of shape S; ``"red"``: a reduction of S over its last r
    dims; ``"K"``: a per-row value, of the kept shape with or without its
    1s); None for a region without reductions."""
    reds = [b for b in members if b.sym.id in _REDUCTIONS]
    if not reds:
        return None
    S = tuple(reds[0].args[0].shape)
    r = trailing_r(reds[0])
    roles = {}
    for b in members:
        if b.sym.id in _REDUCTIONS:
            roles[id(b)] = "red"
        else:
            roles[id(b)] = "S" if tuple(b.flat_proxy_outs()[0].shape) == S else "K"
    return S, r, roles


_VAR = re.compile(r"\b[vlk]\d+\b")


def _acc_type(dt: dtypes.dtype) -> str:
    """The accumulator of a sum of ``dt`` (torch's: float32 for the 16-bit
    floats and float32, float64 for float64, int64 for bools and integers)."""
    if dt.is_exact:
        return "long long"
    return "double" if dt.name == "float64" else "float"


def reduce_source(members: list[BoundSymbol], inputs: list[Proxy],
                  outputs: list[TensorProxy]) -> RegionSpec:
    """Generate the kernel of a region with row reductions: one CTA a row
    of its row space ``(S, r)`` (:func:`row_roles`), a pass over the row
    for each reduction level (a reduction reads members of S computed from
    per-row values of earlier levels), the per-row members after each
    level, and a last pass for the outputs of S that follow the last level.
    Each pass recomputes the members of S it needs from the inputs; nothing
    of shape S but the outputs is written."""
    S, r, roles = row_roles(members)
    K = S[:len(S) - r]
    in_index = {p.name: i for i, p in enumerate(inputs)}
    loads: list[tuple] = []
    load_of: dict[tuple, int] = {}
    var: dict[str, str] = {}           # proxy name -> variable holding it
    depth: dict[str, int] = {}         # proxy name -> reduction level it needs
    s_lines: list[tuple[int, str]] = []   # the per-element body, (level, line)
    k_lines: list[tuple[int, str]] = []   # the per-row statements, (level, line)
    reds: list[tuple] = []             # (level, member index, member, operand)

    def load(p: TensorProxy, mode: str, shape, bdims) -> str:
        key = (in_index[p.name], mode, tuple(shape), None if bdims is None else tuple(bdims))
        if key not in load_of:
            load_of[key] = len(loads)
            loads.append(key)
            k = load_of[key]
            # a read of S: the row's base offset (computed once a row) plus
            # the column's; a per-row read: its offset from the row
            at = f"(a.dense[{k}] ? i : rb{k} + offc@(a, {k}, col))" if mode == "S" \
                else f"off@(a, {k}, row)"
            ref = f"(({_CTYPES[p.dtype.name][0]}*)a.p[{key[0]}])[{at}]"
            (s_lines if mode == "S" else k_lines).append(
                (0, f"const {_ct(p.dtype)} l{k} = {_load(ref, p.dtype)};"))
        return f"l{load_of[key]}"

    def valf(mode: str):
        def val(a, dt) -> str:
            if _is_number(a):
                return _literal(a, dt)
            if a.name in var:
                src = var[a.name]
            else:
                src = load(a, mode, S if mode == "S" else a.shape, None)
            if dt is None:
                return src
            return _convert(src, a.dtype, dt) if a.dtype != dt else src
        return val

    for j, b in enumerate(members):
        out = b.flat_proxy_outs()[0]
        role = roles[id(b)]
        level = max((depth.get(p.name, 0) for p in b.flat_proxy_args()), default=0)
        if role == "red":
            x = b.args[0]
            xv = var[x.name] if x.name in var else load(x, "S", S, None)
            reds.append((level + 1, j, b, xv))
            depth[out.name] = level + 1
            var[out.name] = f"k{j}"
            continue
        depth[out.name] = level
        pid = b.sym.id
        a0 = b.args[0]
        if pid is PrimIDs.BROADCAST_IN_DIM and a0.name not in var:
            expr = load(a0, role, S if role == "S" else out.shape, b.args[2])
        elif pid in (PrimIDs.RESHAPE, PrimIDs.SQUEEZE):
            # a unit view: the same value a row
            expr = var[a0.name] if a0.name in var else load(a0, "K", a0.shape, None)
        else:
            expr = _member_expr(b, valf(role))
        name = f"v{j}" if role == "S" else f"k{j}"
        (s_lines if role == "S" else k_lines).append(
            (level, f"const {_ct(out.dtype)} {name} = {expr};"))
        var[out.name] = name
    levels = max(lv for lv, *_ in reds)
    ni = len(inputs)
    s_out, k_out = {}, []
    for k, o in enumerate(outputs):
        store = f"(({_CTYPES[o.dtype.name][0]}*)a.p[{ni + k}])"
        if tuple(o.shape) == S and var[o.name].startswith("v"):
            at = max(depth[o.name] + 1, 1)
            s_out.setdefault(at, []).append(f"      {store}[i] = {_store(var[o.name], o.dtype)};")
        else:
            k_out.append(f"      {store}[row] = {_store(var[o.name], o.dtype)};")
    passes = max([levels, *s_out])
    nl, rr = max(len(loads), 1), max([len(sh) for _, _, sh, _ in loads] + [1])
    body = ["  for (I row = static_cast<I>(blockIdx.x) / C; row < rows;",
            "       row += static_cast<I>(gridDim.x) / C) {"]
    body += [f"    const I rb{k} = offr@(a, {k}, row);"
             for k, (_, mode, _, _) in enumerate(loads) if mode == "S"]
    body += [f"    {line}" for lv, line in k_lines if lv == 0]
    for p in range(1, passes + 1):
        here = [rd for rd in reds if rd[0] == p]
        for _, j, b, _ in here:
            x = b.args[0]
            if b.sym.id is PrimIDs.SUM:
                body.append(f"    {_acc_type(x.dtype)} acc{j} = 0;")
            elif b.sym.id in (PrimIDs.AMAX, PrimIDs.AMIN):
                body.append(f"    {_ct(x.dtype)} acc{j} = ttr::"
                            f"{'lowest' if b.sym.id is PrimIDs.AMAX else 'highest'}"
                            f"<{_ct(x.dtype)}>();")
            else:
                body.append(f"    {_ct(x.dtype)} av{j} = 0; long long ai{j} = -1;")
        # unrolled, so that a thread has several loads of its row in flight
        body += ["#pragma unroll 4",
                 "    for (I col = c0 + static_cast<I>(threadIdx.x); col < c1; col += blockDim.x) {",
                 "      const I i = row * R + col;"]
        # the members of S this pass reads: what its reductions and stores need
        need = set()
        for _, j, b, xv in here:
            need.add(xv)
        for line in s_out.get(p, []):
            need.update(_VAR.findall(line.split("=", 1)[1]))
        keep = []
        for lv, line in reversed([(lv, line) for lv, line in s_lines if lv <= p - 1]):
            name, expr = line.split(" = ", 1)
            if name.rsplit(" ", 1)[1] in need:
                keep.append(line)
                need.update(_VAR.findall(expr))
        body += [f"      {line}" for line in reversed(keep)]
        for _, j, b, xv in here:
            x = b.args[0]
            if b.sym.id is PrimIDs.SUM:
                body.append(f"      acc{j} += static_cast<{_acc_type(x.dtype)}>({xv});")
            elif b.sym.id in (PrimIDs.AMAX, PrimIDs.AMIN):
                op = "MaxNan" if b.sym.id is PrimIDs.AMAX else "MinNan"
                body.append(f"      acc{j} = ttr::{op}()(acc{j}, {xv});")
            else:
                mx = "true" if b.sym.id is PrimIDs.ARGMAX else "false"
                body.append(f"      ttr::arg_step<{mx}>(av{j}, ai{j}, {xv}, "
                            f"static_cast<long long>(col));")
        body += s_out.get(p, [])
        body.append("    }")
        for _, j, b, _ in here:
            x, out = b.args[0], b.flat_proxy_outs()[0]
            if b.sym.id is PrimIDs.ARGMAX or b.sym.id is PrimIDs.ARGMIN:
                mx = "true" if b.sym.id is PrimIDs.ARGMAX else "false"
                ct = _ct(x.dtype)
                body += [f"    ttr::block_arg<{mx}>(av{j}, ai{j}, smem);",
                         f"    const long long k{j} = C > 1 ? ttr::cluster_arg<{mx}>(av{j}, "
                         f"ai{j}, ({ct}*)cslot, (long long*)(cslot + 8)) : ai{j};"]
                continue
            if b.sym.id is PrimIDs.SUM:
                at, op, ident = _acc_type(x.dtype), "ttr::Sum()", f"({_acc_type(x.dtype)})0"
            else:
                mx = b.sym.id is PrimIDs.AMAX
                at, op = _ct(x.dtype), f"ttr::{'MaxNan' if mx else 'MinNan'}()"
                ident = f"ttr::{'lowest' if mx else 'highest'}<{at}>()"
            body += [f"    {at} t{j} = ttr::block_reduce<{at}>(acc{j}, {op}, {ident}, smem);",
                     f"    if (C > 1) t{j} = ttr::cluster_reduce<{at}>(t{j}, {op}, ({at}*)cslot);"]
            total = f"t{j}" if b.sym.id is not PrimIDs.SUM else _round(f"t{j}", out.dtype)
            body.append(f"    const {_ct(out.dtype)} k{j} = {total};")
        body += [f"    {line}" for lv, line in k_lines if lv == p]
    if k_out:
        body += ["    if (threadIdx.x == 0 && rank == 0) {", *k_out, "    }"]
    body.append("  }")
    # a read of S: its row dims are the leading rr - r of its padded shape
    cols = ([f"  return col * static_cast<I>(a.stride[k][{rr - 1}]);"] if r == 1 else
            ["  I o = 0;",
             f"  for (int d = {rr - 1}; d >= {rr - r}; --d) {{",
             "    const I sz = static_cast<I>(a.size[k][d]);",
             "    o += (col % sz) * static_cast<I>(a.stride[k][d]);",
             "    col /= sz;",
             "  }",
             "  return o;"])
    summary = ", ".join(b.sym.name for b in members)
    src = "\n".join([
        f"// region: {summary} -> {', '.join(o.dtype.name for o in outputs)}, "
        f"rows of rank {len(K)} reducing {r}",
        "namespace {",
        "struct Args@ {",
        f"  void* p[{ni + len(outputs)}];",
        f"  long long size[{nl}][{rr}];",
        f"  long long stride[{nl}][{rr}];",
        f"  int dense[{nl}];",
        "  long long rows;",
        "  long long R;",
        "  int cluster;",
        "};",
        "template <typename I>",
        "__device__ __forceinline__ I off@(const Args@& a, int k, I i) {",
        "  if (a.dense[k]) return i;",
        "  I o = 0;",
        f"  for (int d = {rr - 1}; d >= 0; --d) {{",
        "    const I sz = static_cast<I>(a.size[k][d]);",
        "    o += (i % sz) * static_cast<I>(a.stride[k][d]);",
        "    i /= sz;",
        "  }",
        "  return o;",
        "}",
        "template <typename I>",
        "__device__ __forceinline__ I offr@(const Args@& a, int k, I row) {",
        "  if (a.dense[k]) return row * static_cast<I>(a.R);",
        "  I o = 0;",
        f"  for (int d = {rr - r - 1}; d >= 0; --d) {{",
        "    const I sz = static_cast<I>(a.size[k][d]);",
        "    o += (row % sz) * static_cast<I>(a.stride[k][d]);",
        "    row /= sz;",
        "  }",
        "  return o;",
        "}",
        "template <typename I>",
        "__device__ __forceinline__ I offc@(const Args@& a, int k, I col) {",
        *cols,
        "}",
        "template <typename I>",
        f"__global__ void __launch_bounds__({ROW_THREADS}) tt_region_kernel@(const Args@ a) {{",
        "  __shared__ __align__(16) unsigned char smem[32 * 16];",
        "  __shared__ __align__(16) unsigned char cslot[16];",
        "  const I rows = static_cast<I>(a.rows);",
        "  const I R = static_cast<I>(a.R);",
        "  const int C = a.cluster;",
        "  const unsigned rank = C > 1 ? cooperative_groups::this_cluster().block_rank() : 0u;",
        "  const I chunk = (R + C - 1) / C;",
        "  const I c0 = static_cast<I>(rank) * chunk;",
        "  const I c1 = c0 + chunk < R ? c0 + chunk : R;",
        *body,
        "}",
        "}  // namespace",
        'extern "C" int @entry(void* const* ptrs, const long long* meta, int idx64, int blocks,',
        "                      void* stream) {",
        "  Args@ a;",
        f"  for (int k = 0; k < {ni + len(outputs)}; ++k) a.p[k] = ptrs[k];",
        "  a.rows = meta[0];",
        "  a.R = meta[1];",
        "  const int threads = static_cast<int>(meta[2]);",
        "  a.cluster = static_cast<int>(meta[3]);",
        f"  for (int k = 0; k < {len(loads)}; ++k) {{",
        f"    a.dense[k] = static_cast<int>(meta[4 + k * {2 * rr + 1}]);",
        f"    for (int d = 0; d < {rr}; ++d) {{",
        f"      a.size[k][d] = meta[5 + k * {2 * rr + 1} + d];",
        f"      a.stride[k][d] = meta[5 + k * {2 * rr + 1} + {rr} + d];",
        "    }",
        "  }",
        "  auto s = static_cast<cudaStream_t>(stream);",
        "  if (a.cluster > 1) {",
        "    cudaLaunchConfig_t cfg = {};",
        "    cfg.gridDim = dim3(blocks);",
        "    cfg.blockDim = dim3(threads);",
        "    cfg.stream = s;",
        "    cudaLaunchAttribute attr[1];",
        "    attr[0].id = cudaLaunchAttributeClusterDimension;",
        "    attr[0].val.clusterDim.x = a.cluster;",
        "    attr[0].val.clusterDim.y = 1;",
        "    attr[0].val.clusterDim.z = 1;",
        "    cfg.attrs = attr;",
        "    cfg.numAttrs = 1;",
        "    const cudaError_t e = idx64 ? cudaLaunchKernelEx(&cfg, tt_region_kernel@<long long>, a)",
        "                                : cudaLaunchKernelEx(&cfg, tt_region_kernel@<int>, a);",
        "    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());",
        "  }",
        "  if (idx64) tt_region_kernel@<long long><<<blocks, threads, 0, s>>>(a);",
        "  else tt_region_kernel@<int><<<blocks, threads, 0, s>>>(a);",
        "  return static_cast<int>(cudaGetLastError());",
        "}",
    ])
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    entry = f"tt_region_{digest}"
    src = src.replace("@entry", entry).replace("@", f"_{digest}")
    param_bytes = 8 * (ni + len(outputs)) + nl * (16 * rr + 4) + 24
    return RegionSpec(loads, src, entry, any(b.sym.id in TRANSCENDENTAL for b in members),
                      rows=(S, r), param_bytes=param_bytes)


# -- build ----------------------------------------------------------------------

_lock = threading.Lock()
_bound: dict[str, object] = {}        # entry -> ctypes function
_failures: dict[str, str] = {}        # entry -> nvcc log
_nvcc_s = 0.0
_nvcc_runs = 0


# every region's generated kernel counts its launches under one entry,
# beside the hand-written kernels; it stands for the reference's XLA
# fusion regions, not for a Pallas function
KERNEL = cudaex.register_generated(
    cudaex.Kernel("region", "thunder_tpu_torch/csrc/region.cuh",
                  "thunder_tpu/executors/xla.py:77", "tt_region_<hash>", ()),
    lambda: {f"region:{entry}": log for entry, log in _failures.items()})


def nvcc_seconds() -> float:
    """Seconds this process spent in ``nvcc`` for regions."""
    return _nvcc_s


def nvcc_runs() -> int:
    """The ``nvcc`` processes this process started for regions."""
    return _nvcc_runs


def build_failures() -> dict[str, str]:
    """The generated region kernels that did not build, each with its log."""
    return dict(_failures)


def _library(src: str) -> Path:
    """The library of ``src``, named by a hash of it and the flags."""
    key = hashlib.sha256((" ".join(NVCC_FLAGS) + HEADER.read_text() + src).encode()
                         ).hexdigest()[:16]
    return cudaex.BUILD_DIR / f"regions-{key}.so"


def _run_nvcc(nvcc: str, src: str) -> tuple[Path, subprocess.Popen]:
    global _nvcc_runs
    _nvcc_runs += 1
    lib = _library(src)
    cu = lib.with_suffix(f".{os.getpid()}.cu")
    cu.write_text(src)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(cudaex.CSRC), "-o", str(tmp), str(cu)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _library_source(specs) -> str:
    return "\n".join([f'#include "{HEADER.name}"', *(s.source for s in specs)]) + "\n"


def _bind(lib: Path, specs) -> None:
    handle = ctypes.CDLL(str(lib))
    for s in specs:
        fn = getattr(handle, s.entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[s.entry] = fn


def _finish(lib: Path, p: subprocess.Popen) -> str | None:
    """Wait for one nvcc; the log where it failed, else None (the library
    moved into place)."""
    log, _ = p.communicate()
    cu = lib.with_suffix(f".{os.getpid()}.cu")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cu.unlink(missing_ok=True)
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc exited {p.returncode}\n{log}"
    os.replace(tmp, lib)
    return None


def build_regions(specs) -> float:
    """Build and bind every region of ``specs`` not bound yet: one ``nvcc``
    over all of them (a library already built is loaded without one).
    Where that build fails, each region is built alone, all at once, so a
    region whose source fails stops only itself: its log goes to
    :func:`build_failures`. Returns the nvcc seconds spent."""
    global _nvcc_s
    if not torch.cuda.is_available():
        raise KernelBuildError("thunder_tpu_torch region kernels need a CUDA device; none is "
                               "available")
    with _lock:
        todo = list({s.entry: s for s in specs
                     if s.entry not in _bound and s.entry not in _failures}.values())
        if not todo:
            return 0.0
        cudaex.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _library_source(todo)
        lib = _library(src)
        if lib.exists():
            _bind(lib, todo)
            return 0.0
        nvcc = cudaex._nvcc()
        t0 = time.perf_counter()
        lib, p = _run_nvcc(nvcc, src)
        err = _finish(lib, p)
        if err is None:
            _bind(lib, todo)
        else:
            runs = [(s, *_run_nvcc(nvcc, _library_source([s]))) for s in todo]
            for s, one, q in runs:
                e = _finish(one, q)
                if e is None:
                    _bind(one, [s])
                else:
                    _failures[s.entry] = f"{s.entry}: {e}"
        dt = time.perf_counter() - t0
        _nvcc_s += dt
        return dt


# -- the region callable --------------------------------------------------------

class Region:
    """The callable of one region bound symbol: the members' plain chain
    for tensors off the card, one generated kernel on the card. ``program``
    lists every region of the same execution trace, built together at the
    first launch of any of them."""

    def __init__(self, name: str, members: list[BoundSymbol], inputs: list[Proxy],
                 outputs: list[TensorProxy], program: list):
        self.name = name
        self.members = members
        self.inputs = inputs
        self.input_names = [p.name for p in inputs]
        self.output_names = [p.name for p in outputs]
        self.outputs = outputs
        if any(b.sym.id in _REDUCTIONS for b in members):
            self.spec = reduce_source(members, inputs, outputs)
            self.shape = self.spec.rows[0]
        else:
            self.spec = region_source(members, inputs, outputs)
            self.shape = tuple(outputs[0].shape)
        self.program = program
        # the names the plain chain lets go after each member: its last read
        # of a value, or the value's making where nothing reads it and it is
        # no output (the chain holds no more at once than the program would)
        last = {}
        for j, b in enumerate(members):
            for p in b.flat_proxy_args():
                last[p.name] = j
            for p in b.flat_proxy_outs():
                last.setdefault(p.name, j)
        keep = set(self.output_names)
        self._drops = [[] for _ in members]
        for name, j in last.items():
            if name not in keep:
                self._drops[j].append(name)

    def __repr__(self):
        return f"<Region {self.name}: {len(self.members)} ops>"

    @property
    def kernel(self) -> str | None:
        """The launch counter its calls add to: :data:`KERNEL`'s on the
        card, none off it (the plain chain launches no kernel)."""
        return KERNEL.name if self.outputs[0].device.type == "cuda" else None

    def plain(self, *vals):
        """The members' torch implementations in order (the reference's
        ``run_bsyms``); an output that shares storage with an input is
        copied, so a region's outputs are fresh tensors on every device."""
        env = dict(zip(self.input_names, vals))
        for b, drop in zip(self.members, self._drops):
            run_bsyms([b], env)
            for name in drop:
                del env[name]
        ins = [v for v in vals if isinstance(v, torch.Tensor)]
        out = []
        for n in self.output_names:
            t = env[n]
            if any(t.untyped_storage().data_ptr() == v.untyped_storage().data_ptr()
                   for v in ins):
                t = t.clone()
            out.append(t)
        return tuple(out)

    def __call__(self, *vals):
        tensors = [v for v in vals if isinstance(v, torch.Tensor)]
        if tensors and tensors[0].device.type == "cuda":
            return launch(self, vals)
        return self.plain(*vals)


def _strides(t: torch.Tensor, shape: tuple, bdims) -> list[int]:
    """``t``'s strides over the iteration space ``shape``: its own, or
    composed with a broadcast (0 on every dim it does not cover, or covers
    at size 1)."""
    if bdims is None:
        return [s if n != 1 else 0 for s, n in zip(t.stride(), shape)]
    out = [0] * len(shape)
    for i, d in enumerate(bdims):
        if t.shape[i] == shape[d] and shape[d] != 1:
            out[d] = t.stride(i)
    return out


def _contiguous_strides(shape: tuple) -> list[int]:
    out, acc = [0] * len(shape), 1
    for d in range(len(shape) - 1, -1, -1):
        out[d] = acc if shape[d] != 1 else 0
        acc *= shape[d]
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(region: Region, vals) -> tuple:
    """One launch of ``region``'s generated kernel on the card (building
    the program's regions first where they are not); raises for tensors off
    the card, for a region whose source did not build, and for a launch
    that returns a CUDA error."""
    spec = region.spec
    tensors = [v for v in vals if isinstance(v, torch.Tensor)]
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{region.name}: the kernel takes CUDA tensors on one card, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if spec.entry not in _bound and spec.entry not in _failures:
        build_regions([r.spec for r in region.program] or [spec])
    fn = _bound.get(spec.entry)
    if fn is None:
        raise KernelBuildError(f"{region.name}: its generated source did not build, so this "
                               f"region cannot launch:\n{_failures.get(spec.entry)}",
                               kernel="region")
    if spec.rows is not None:
        return _launch_rows(region, fn, vals, dev)
    shape = region.shape
    n = math.prod(shape)
    outs = [torch.empty(shape, dtype=o.dtype.torch, device=dev) for o in region.outputs]
    if n == 0:
        return tuple(outs)
    strides = [_strides(vals[i], shape, bdims) for i, bdims in spec.loads]
    dense = _contiguous_strides(shape)
    contiguous = all(s == dense for s in strides)
    reach = max([n] + [sum(abs(s) * (e - 1) for s, e in zip(st, shape)) + 1 for st in strides])
    idx64 = reach > 2 ** 31 - 1
    meta = [n, int(contiguous), *shape, *(s for st in strides for s in st)]
    ptrs = [v.data_ptr() if isinstance(v, torch.Tensor) else 0 for v in vals]
    ptrs += [o.data_ptr() for o in outs]
    blocks = max(1, min(-(-n // THREADS), _sm_count(dev.index) * BLOCKS_PER_SM))
    rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(meta))(*meta),
            int(idx64), blocks, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(f"{region.name}: kernel launch failed with CUDA error {rc}")
    cudaex.count_launch("region", "contiguous" if contiguous else "strided")
    return tuple(outs)


def _view_strides(t: torch.Tensor, shape: tuple) -> list[int]:
    """``t``'s strides over ``shape``, which has ``t``'s dims of size above 1
    in the same order (a view that adds or drops 1s): 0 on every dim of
    size 1."""
    own = [st for st, n in zip(t.stride(), t.shape) if n != 1]
    out, k = [], 0
    for n in shape:
        if n == 1:
            out.append(0)
        else:
            out.append(own[k])
            k += 1
    return out


def row_launch(rows: int, R: int, sms: int) -> tuple[int, int, int]:
    """``(cluster, threads, blocks)`` of a launch over ``rows`` rows of
    ``R``: where the rows fill the card, one CTA a row of up to
    :data:`THREADS` threads, 8 CTAs an SM grid-striding over the rows;
    where they do not, each row split across a cluster of up to
    :data:`MAX_CLUSTER` CTAs (a part of at least :data:`CLUSTER_MIN_PART`
    elements each) of up to :data:`ROW_THREADS` threads."""
    def fit(n, cap):
        return min(cap, max(32, -(-n // 32) * 32))

    if rows >= sms:
        return 1, fit(R, THREADS), min(rows, sms * BLOCKS_PER_SM)
    c = max(1, min(MAX_CLUSTER, sms // rows, R // CLUSTER_MIN_PART))
    return c, fit(-(-R // c), ROW_THREADS), rows * c


def sum_depth(rows: int, R: int, sms: int) -> int:
    """The most roundings one summand goes through in a region's float sum
    of a row of ``R`` (the order of the kernel :func:`row_launch` gives
    ``rows`` rows on ``sms`` SMs): its thread's running sum over its
    columns, the two shuffle trees of ``ttr::block_reduce`` (5 levels each)
    and the cluster's partials in rank order. Such a sum is within
    ``d u / (1 - d u) sum|x_i|`` of the exact sum (d this depth, u the
    accumulator's unit roundoff)."""
    cluster, threads, _ = row_launch(rows, R, sms)
    return -(-(-(-R // cluster)) // threads) - 1 + 10 + cluster - 1


def _launch_rows(region: Region, fn, vals, dev) -> tuple:
    """One launch of a region with row reductions: one CTA a row of its row
    space, grid-striding over the rows."""
    spec = region.spec
    S, r = spec.rows
    rows, R = math.prod(S[:len(S) - r]), math.prod(S[len(S) - r:])
    outs = [torch.empty(tuple(o.shape), dtype=o.dtype.torch, device=dev)
            for o in region.outputs]
    if rows == 0:
        return tuple(outs)
    rr = max([len(sh) for _, _, sh, _ in spec.loads] + [1])
    cluster, threads, blocks = row_launch(rows, R, _sm_count(dev.index))
    meta = [rows, R, threads, cluster]
    reach = rows * R
    for i, mode, shape, bdims in spec.loads:
        t = vals[i]
        if bdims is not None:
            st = _strides(t, shape, bdims)
        elif mode == "S":
            st = _strides(t, shape, None)
        else:
            st = _view_strides(t, shape)
        reach = max(reach, sum(abs(x) * (e - 1) for x, e in zip(st, shape)) + 1)
        pad = rr - len(shape)
        meta += [int(st == _contiguous_strides(shape)), *([1] * pad), *shape,
                 *([0] * pad), *st]
    ptrs = [v.data_ptr() if isinstance(v, torch.Tensor) else 0 for v in vals]
    ptrs += [o.data_ptr() for o in outs]
    rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(meta))(*meta),
            int(reach > 2 ** 31 - 1), blocks, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(f"{region.name}: kernel launch failed with CUDA error {rc}")
    cudaex.count_launch("region", "reduce")
    return tuple(outs)


# -- the executor ---------------------------------------------------------------

class RegionExecutor(FusionExecutor):
    """Dataflow regions of unclaimed elementwise prims and row reductions,
    each one generated kernel on the card (the counterpart of
    ``XLAFusionExecutor``)."""

    def __init__(self, name: str = "region", min_region_size: int = 2):
        super().__init__(name)
        self.min_region_size = min_region_size

    def can_fuse(self, bsym: BoundSymbol) -> bool:
        sym = bsym.sym
        if sym.executor is not None or sym.id in _NOFUSE_IDS:
            return False
        if OpTags.DEVICE_SYNC_OP in sym.tags:
            return False
        if (OpTags.ELEMENTWISE_OP not in sym.tags and sym.id not in _REDUCTIONS
                and sym.id not in (PrimIDs.BROADCAST_IN_DIM, PrimIDs.CONVERT_ELEMENT_TYPE,
                                   PrimIDs.RESHAPE, PrimIDs.SQUEEZE)):
            return False
        from thunder_tpu_torch.executors.eagertorch import get_eager_impl

        return get_eager_impl(sym) is not None and _supported(bsym)

    def fusion_pass(self, trc: TraceCtx) -> TraceCtx:
        from thunder_tpu_torch.core.compile_data import get_compile_option

        if get_compile_option("region_disable_fusion",
                              "skip region fusion entirely (every prim runs as one torch call); "
                              "bisection/debugging aid", False):
            return trc
        min_region_size = get_compile_option(
            "region_min_region_size",
            "minimum bound symbols per region; smaller ones stay torch calls",
            self.min_region_size)
        partitioner = get_compile_option(
            "region_partitioner",
            "region formation: 'dataflow' (the data-dependent partitioner: maximal regions "
            "under the dataflow graph) or 'contiguous' (greedy program-order runs)", "dataflow")
        check(partitioner in ("dataflow", "contiguous"),
              lambda: f"region_partitioner must be 'dataflow' or 'contiguous', got "
                      f"{partitioner!r}", ValueError)
        live_out = {Variable(o) for o in tree_flatten(trc.output)[0] if isinstance(o, Proxy)}
        # fuel is spent once a bound symbol, and the same answer serves the
        # grouping and the emission (fuel bisection depends on it)
        fuel_ok = {id(b): self.can_fuse(b) and self.get_fuel() for b in trc.bound_symbols}
        units = self._units(trc, partitioner, fuel_ok)
        # for unit i: what the units after it, and the program's return, read
        needed_after: list[set[Variable]] = [set()] * len(units)
        acc: set[Variable] = set(live_out)
        for i in range(len(units) - 1, -1, -1):
            needed_after[i] = set(acc)
            for b in units[i]:
                acc |= consumed_vars(b)
        new = from_trace(trc)
        program: list[Region] = []
        bsyms: list[BoundSymbol] = []
        for i, unit in enumerate(units):
            region = None
            if len(unit) >= min_region_size and all(fuel_ok[id(b)] for b in unit):
                region = self._make_region(unit, needed_after[i], len(program), program)
            if region is None:
                bsyms.extend(unit)
            else:
                bsyms.append(region)
        new.bound_symbols = bsyms
        new.set_provenance("Region fusion pass")
        return new

    def _units(self, trc: TraceCtx, partitioner: str, fuel_ok: dict) -> list[list[BoundSymbol]]:
        """The program's bound symbols partitioned (``partitioner``), each
        group split into row spaces and output shapes
        (:func:`split_row_spaces`). The same program text partitions the
        same way, so a program compiled again (another engine's, a new
        guard key's) takes the last partition of its text (without fuel:
        fuel is spent a bound symbol)."""
        from thunder_tpu_torch.executors.data_dependent_partition import fuse_bound_symbols

        bsyms = trc.bound_symbols
        key = (partitioner, trc.python()) if self._fuel is None else None
        cached = _PARTITIONS.get(key) if key is not None else None
        if cached is not None:
            return [[bsyms[i] for i in unit] for unit in cached]
        if partitioner == "dataflow":
            groups = fuse_bound_symbols(bsyms, lambda b: fuel_ok[id(b)])
        else:
            groups, current = [], []
            for bsym in bsyms:
                if fuel_ok[id(bsym)]:
                    current.append(bsym)
                    continue
                if current:
                    groups.append(current)
                    current = []
                groups.append([bsym])
            if current:
                groups.append(current)
        units: list[list[BoundSymbol]] = []
        for g in groups:
            units.extend(split_row_spaces(g) if len(g) > 1 else [g])
        if key is not None:
            at = {id(b): i for i, b in enumerate(bsyms)}
            while len(_PARTITIONS) >= PARTITION_CACHE:
                _PARTITIONS.pop(next(iter(_PARTITIONS)))
            _PARTITIONS[key] = [[at[id(b)] for b in unit] for unit in units]
        return units

    def _make_region(self, members, needed_later, idx, program) -> BoundSymbol | None:
        produced: set[Variable] = set()
        inputs: list[Proxy] = []
        seen: set[str] = set()
        for b in members:
            for v in sorted(consumed_vars(b), key=lambda v: v.proxy.name):
                if v not in produced and v.proxy.name not in seen:
                    seen.add(v.proxy.name)
                    inputs.append(v.proxy)
            produced |= produced_vars(b)
        outputs = sorted((v.proxy for v in produced if v in needed_later), key=lambda p: p.name)
        if not outputs:
            return None
        param_bytes = 8 * (len(inputs) + len(outputs) + len(outputs[0].shape) * (1 + len(inputs)))
        if param_bytes > MAX_PARAM_BYTES:
            return None
        name = f"region.fusion{idx}"
        fn = Region(name, list(members), inputs, outputs, program)
        if fn.spec.param_bytes > MAX_PARAM_BYTES:
            return None
        program.append(fn)
        sym = Symbol(f"fusion{idx}", None, id=name, is_prim=True, executor=self, python_impl=fn)
        bsym = sym.bind(*inputs, output=tuple(outputs), subsymbols=list(members))
        _observe.inc("fusion.region_regions")
        if _decisions.active():
            nbytes = sum(math.prod(p.shape) * p.dtype.bytes
                         for p in inputs + outputs if isinstance(p, TensorProxy))
            _decisions.record("fusion", name, self.name, "fused",
                              f"{len(members)} ops into one generated kernel",
                              cost={"ops": len(members), "boundary_bytes": nbytes,
                                    "shape": list(fn.shape),
                                    "reduced_dims": fn.spec.rows[1] if fn.spec.rows else 0})
        notes = [b.header for b in members if b.header]
        if notes:
            bsym.header = "\n".join(notes)
        return bsym


def _out_shape(b: BoundSymbol) -> tuple:
    return tuple(b.flat_proxy_outs()[0].shape)


def _kept(shape, S: tuple, r: int) -> bool:
    """Is ``shape`` a per-row shape of the row space ``(S, r)``: the kept
    dims ``S[:-r]``, with or without 1s?"""
    return _non_unit(shape) == _non_unit(S[:len(S) - r])


def _reads_own_row(b: BoundSymbol, S: tuple, r: int) -> bool:
    """Does the ``broadcast_in_dim`` ``b`` of a per-row value of ``(S, r)``
    give each element (of S, or of its own per-row shape) its own row's
    value?"""
    src, shape, bdims = b.args[0].shape, tuple(b.args[1]), tuple(b.args[2])
    kept = [(i, n) for i, n in enumerate(src) if n != 1]
    if shape == S:
        want = [d for d in range(len(S) - r) if S[d] != 1]
    else:
        want = [d for d, n in enumerate(shape) if n != 1]
    return [bdims[i] for i, _ in kept] == want and all(shape[bdims[i]] == n for i, n in kept)


def _order(units: list[list[BoundSymbol]]) -> list[list[BoundSymbol]] | None:
    """``units`` in an order that makes every unit's inputs before it; None
    where their dependencies form a cycle."""
    made = [set().union(*(produced_vars(b) for b in u)) for u in units]
    deps = [{j for j in range(len(units)) if j != k and any(consumed_vars(b) & made[j]
                                                               for b in units[k])}
            for k in range(len(units))]
    order, done = [], set()
    while len(order) < len(units):
        ready = [k for k in range(len(units)) if k not in done and deps[k] <= done]
        if not ready:
            return None
        order.append(ready[0])
        done.add(ready[0])
    return [units[k] for k in order]


def _plan(group: list[BoundSymbol], rows: bool, kept: bool) -> list[list[BoundSymbol]] | None:
    """One partition of a group into regions' units. Without ``rows``, one
    unit a members' output shape, every reduction and unit view alone. With
    ``rows``, a row space ``(S, r)`` for each shape S that a member reduces
    over its r trailing dims: its unit takes the members of shape S and
    those reductions; with ``kept`` also the per-row members of its kept
    shape that read a reduction's result (in program order) or that only
    its row space reads (in reverse order), and the unit views between
    them. None where the units' dependencies form a cycle."""
    key: dict[int, tuple] = {}
    space: dict[tuple, int] = {}
    if rows:
        for b in group:
            if b.sym.id in _REDUCTIONS:
                space.setdefault(tuple(b.args[0].shape), trailing_r(b))
    for b in group:
        if b.sym.id in _REDUCTIONS:
            S = tuple(b.args[0].shape)
            key[id(b)] = ("row", S) if space.get(S) == trailing_r(b) else ("one", id(b))
        elif is_unit_view(b):
            key[id(b)] = ("one", id(b))
        elif _out_shape(b) in space:
            key[id(b)] = ("row", _out_shape(b))
        else:
            key[id(b)] = ("shape", _out_shape(b))
    produced = {p.name: b for b in group for p in b.flat_proxy_outs()}
    per_row: dict[str, tuple] = {}      # a per-row value -> the S of its row space

    def kept_ok(b, S) -> bool:
        """May ``b`` join row space S as a per-row member: each operand it
        reads there per row, and a broadcast its own row's value."""
        if b.sym.id is PrimIDs.BROADCAST_IN_DIM and b.args[0].name in per_row:
            return _reads_own_row(b, S, space[S])
        return True

    for b in group:
        if b.sym.id in _REDUCTIONS and key[id(b)][0] == "row":
            per_row[b.flat_proxy_outs()[0].name] = tuple(b.args[0].shape)
        elif kept and key[id(b)][0] != "row" and b.sym.id not in _REDUCTIONS:
            spaces = {per_row[p.name] for p in b.flat_proxy_args() if p.name in per_row}
            S = next(iter(spaces)) if len(spaces) == 1 else None
            if S is not None and _kept(_out_shape(b), S, space[S]) and kept_ok(b, S):
                key[id(b)] = ("row", S)
                per_row[b.flat_proxy_outs()[0].name] = S
    if kept:
        readers: dict[str, list] = {}
        for b in group:
            for p in b.flat_proxy_args():
                readers.setdefault(p.name, []).append(b)
        for b in reversed(group):
            if key[id(b)][0] == "row" or b.sym.id in _REDUCTIONS:
                continue
            out = b.flat_proxy_outs()[0]
            users = readers.get(out.name, [])
            if not users or users[0].sym.id in _REDUCTIONS:
                continue
            S = key[id(users[0])][1]
            if (key[id(users[0])][0] != "row" or any(key[id(u)] != ("row", S) for u in users)
                    or not _kept(out.shape, S, space[S]) or not kept_ok(b, S)):
                continue
            # a broadcast of it to S must give each element its own row's value
            if all(u.sym.id is not PrimIDs.BROADCAST_IN_DIM or _reads_own_row(u, S, space[S])
                   for u in users if _out_shape(u) == S):
                key[id(b)] = ("row", S)
                per_row[out.name] = S
    # a broadcast of S that reads a per-row value of its own row space must
    # give each element its row's value; else it stays out
    for b in group:
        k = key[id(b)]
        if (k[0] == "row" and b.sym.id is PrimIDs.BROADCAST_IN_DIM and _out_shape(b) == k[1]
                and tuple(b.args[0].shape) != k[1] and b.args[0].name in produced
                and key[id(produced[b.args[0].name])] == k
                and not _reads_own_row(b, k[1], space[k[1]])):
            key[id(b)] = ("one", id(b))
    units: dict[tuple, list] = {}
    for b in group:
        units.setdefault(key[id(b)], []).append(b)
    return _order(list(units.values()))


def split_row_spaces(group: list[BoundSymbol]) -> list[list[BoundSymbol]]:
    """A partitioner group as regions' units, in an order that keeps every
    unit's inputs produced before it: each row space (its members of shape
    S, its reductions of S's trailing dims, its per-row members; see
    :func:`_plan`) one unit, every other member in one unit a output shape
    (the elementwise regions), unit views and any other reduction alone.
    Where a row space's per-row members would close a cycle through another
    unit they stay out; where its reductions would, they stay out too; a
    group that still forms a cycle (none is known) stays as its members,
    each alone."""
    for rows, kept in ((True, True), (True, False), (False, False)):
        units = _plan(group, rows, kept)
        if units is not None:
            return units
    return [[b] for b in group]


ex = RegionExecutor()
register_executor(ex, default=True)
