"""The region executor: regions of a program as generated kernels.

The counterpart of ``thunder_tpu/executors/xla.py`` (``XLAFusionExecutor``
:77), which hands each fused region to ``jax.jit`` and lets XLA fuse it,
reductions included (its ``can_fuse`` :84-99 takes any prim with an eager
implementation). Here the ``region`` fusion executor groups the unclaimed
prims of an execution trace that it can generate (every prim tagged
``ELEMENTWISE_OP``, ``broadcast_in_dim``, ``convert_element_type``,
``sum``/``prod``/``amax``/``amin`` over any dims of their input that hold
more than one element, ``argmax``/``argmin`` over its last dim, and the
``reshape``/``squeeze`` views that only add or drop 1s, as ``keepdim``
does; never ``cumsum``, a view of another kind, a host-sync op or anything
another executor claimed) with the reference's dataflow partitioner
(:mod:`~thunder_tpu_torch.executors.data_dependent_partition`), splits each
group into spaces and output shapes (:func:`split_row_spaces`), and binds
each part of at least ``region_min_region_size`` members as one symbol
``region.fusion<i>``, its members kept as subsymbols.

A region is one space ``(S, D)``: S its iteration shape, D the dims its
reductions reduce. Where D is S's last r dims it is a row space ``(S,
r)``: its members are the elementwise, broadcast and convert members of
shape S, the reductions of S over its last r dims, the sums of S over
every kept dim (a norm weight's column sum, :func:`is_column_sum`), the
per-row members of the kept shape (S without its last r dims, with or
without 1s) that read a reduction's result or that only the row space
reads, and the broadcasts of per-row values back to S. Other dims make a
column space: its members of shape S read only the inputs, its reductions
reduce D, its per-kept members follow them. A region of one output shape
without reductions is the elementwise case.

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
intermediate kept in registers. A row space is one CTA a row of S
(grid-striding over the rows): a pass over the row for each reduction
level (a reduction whose input depends on an earlier reduction's result is
a level deeper), then the per-row members of that level, broadcast to the
CTA, and a last pass for the outputs of S that follow the last level; each
pass computes the members of S it needs from the inputs, so nothing of
shape S but the region's outputs is written. The inputs of S that two
passes read are staged in shared memory once a row where they fit (16-byte
copies where the row is contiguous and aligned): the row is read from
device memory once. Its column sums accumulate each CTA's rows in shared
memory, one partial a CTA, summed as a fixed tree by a second kernel. A
column space is one CTA a tile of kept elements, a thread each, its thread
rows each a strided share of the reduced elements in order, the reduced
extent split across a cluster where the tiles do not fill the card. Every
combination runs in a fixed order (``csrc/region.cuh``), so two launches on
the same inputs agree bit for bit.

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
another order than torch's kernel; a ``prod`` likewise (int64 products
wrap as torch's do); ``amax``/``amin`` propagate NaN;
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
``cudaex.launch_counts()`` (design ``contiguous``, ``strided``, ``smem``,
``reduce``, ``smem_partials``, ``reduce_partials`` or ``column``), on
``torch.cuda.current_stream()``; its arguments follow from shapes and
strides and its scratch (the column sums' partials) comes from
``torch.empty``, so a CUDA graph captures it (``cudagraphex``). 64-bit
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
from dataclasses import dataclass, field
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


_REDUCTIONS = (PrimIDs.SUM, PrimIDs.PROD, PrimIDs.AMAX, PrimIDs.AMIN, PrimIDs.ARGMAX,
               PrimIDs.ARGMIN)
_ARG = (PrimIDs.ARGMAX, PrimIDs.ARGMIN)
# the dtypes amax, amin, argmax and argmin take in a region (each shuffled
# as itself between a warp's lanes)
_EXTREME_DTYPES = ("float32", "bfloat16", "float16", "float64", "int32", "int64")
# the most elements a region reduces into one value: one CTA (or cluster)
# reads them all
MAX_ROW = 1 << 20
# dynamic shared memory a CTA of a region with row reductions may take (set
# at bind time; the H100 allows 227 KB a CTA, 228 KB an SM)
SMEM_BUDGET = 200 * 1024
SMEM_PER_SM = 228 * 1024
# a column sum joins a row space where its accumulators (one a column of
# the row) take at most this many bytes of a CTA's shared memory
COLUMN_SUM_BYTES = 64 * 1024
# a reduction over other dims than the trailing ones (the column design):
# CTAs of COLUMN_THREADS threads, the reduced extent split across a cluster
# where the kept tiles do not fill the card, at least CLUSTER_MIN_ROWS
# reduced elements a thread row of a CTA
COLUMN_THREADS = 256
CLUSTER_MIN_ROWS = 16
COLUMN_ALONE = 32
COLUMN_UNROLL = 4
# the column sums' finishing pass: CTAs of FINISH_X columns by FINISH_Y
# lanes (csrc/region.cuh finish_columns)
FINISH_X, FINISH_Y = 8, 32


def _reduced_dims(b: BoundSymbol) -> tuple | None:
    """The dims the reduction ``b`` reduces (sorted), None for any other
    member."""
    if b.sym.id not in _REDUCTIONS or not b.args or not isinstance(b.args[0], TensorProxy):
        return None
    nd = b.args[0].ndim
    if b.sym.id in _ARG:
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


def reduced_extent(b: BoundSymbol) -> int:
    """How many elements the reduction ``b`` reduces into each value."""
    a = b.args[0]
    return math.prod(a.shape[d] for d in _reduced_dims(b))


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
        # argmax/argmin over one trailing dim; the others over any dims
        # that hold more than one element
        if pid in _ARG:
            if trailing_r(b) is None:
                return False
        elif not _reduced_dims(b) or not 1 < reduced_extent(b) <= MAX_ROW:
            return False
        if pid in (PrimIDs.SUM, PrimIDs.PROD):
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
    function may differ from the chain's in the last place, ``design``
    ``"elementwise"``, ``"row"`` or ``"column"``. A region with row
    reductions (:func:`reduce_source`) has ``rows`` set: ``(S, r)``, its
    row space (the members' iteration shape and how many of its trailing
    dims they reduce); its ``loads`` are then ``(input index, "S" or "K",
    iteration shape, broadcast dims or None)``: a read at each element of
    ``S`` or once a row; ``staged`` the loads two passes read, each with
    its element's bytes (kept in shared memory where they fit);
    ``col_sums`` its column sums, each as (output index, accumulator
    C type). A region of the column design (:func:`column_source`) has
    ``cols`` set: ``(S, D)``, its space and the dims its reductions
    reduce; ``s_outs`` its outputs of shape S."""

    loads: list
    source: str
    entry: str
    transcendental: bool
    rows: tuple | None = None
    param_bytes: int = 0
    design: str = "elementwise"
    staged: list = field(default_factory=list)
    col_sums: list = field(default_factory=list)
    cols: tuple | None = None
    s_outs: list = field(default_factory=list)


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


def reduction_space(members: list[BoundSymbol]) -> tuple | None:
    """The space a region's reductions reduce: ``("row", S, r)`` where one
    of them reduces the last r dims of S (the row design,
    :func:`reduce_source`), ``("column", S, D)`` where they reduce the dims
    D of S, not trailing ones (the column design, :func:`column_source`);
    None for a region without reductions."""
    reds = [b for b in members if b.sym.id in _REDUCTIONS]
    if not reds:
        return None
    for b in reds:
        r = trailing_r(b)
        if r:
            return "row", tuple(b.args[0].shape), r
    return "column", tuple(reds[0].args[0].shape), _reduced_dims(reds[0])


_ACC_BYTES = {"float": 4, "double": 8, "long long": 8}
_ACC_TORCH = {"float": torch.float32, "double": torch.float64, "long long": torch.int64}


def is_column_sum(b: BoundSymbol, S: tuple, r: int) -> bool:
    """Is ``b`` a ``sum`` of the row space ``(S, r)`` over its kept dims
    (each of them that holds more than one element), whose accumulators
    (one a column of the row) fit in :data:`COLUMN_SUM_BYTES`: a norm
    weight's column sum, which joins the row space (:func:`reduce_source`)?"""
    if b.sym.id is not PrimIDs.SUM or tuple(b.args[0].shape) != S:
        return False
    dims = set(_reduced_dims(b) or ())
    kept = set(range(len(S) - r))
    if not dims or not dims <= kept or not {d for d in kept if S[d] != 1} <= dims:
        return False
    return math.prod(S[len(S) - r:]) * _ACC_BYTES[_acc_type(b.args[0].dtype)] <= COLUMN_SUM_BYTES


def row_roles(members: list[BoundSymbol]) -> tuple[tuple, int, dict] | None:
    """The row space ``(S, r)`` of a region's members and each member's
    role (``"S"``: of shape S; ``"red"``: a reduction of S over its last r
    dims; ``"col"``: a sum of S over its kept dims, :func:`is_column_sum`;
    ``"K"``: a per-row value, of the kept shape with or without its 1s);
    None for a region without row reductions."""
    space = reduction_space(members)
    if space is None or space[0] != "row":
        return None
    _, S, r = space
    roles = {}
    for b in members:
        if b.sym.id in _REDUCTIONS:
            row = tuple(b.args[0].shape) == S and trailing_r(b) == r
            roles[id(b)] = "red" if row else "col"
        else:
            roles[id(b)] = "S" if tuple(b.flat_proxy_outs()[0].shape) == S else "K"
    return S, r, roles


_VAR = re.compile(r"\b[vlk]\d+\b")


def _acc_type(dt: dtypes.dtype) -> str:
    """The accumulator of a sum or product of ``dt`` (torch's: float32 for
    the 16-bit floats and float32, float64 for float64, int64 for bools and
    integers)."""
    if dt.is_exact:
        return "long long"
    return "double" if dt.name == "float64" else "float"


def _reduction_parts(b: BoundSymbol) -> tuple[str, str, str]:
    """``(accumulator type, combining op, identity)`` of the reduction
    ``b`` (``sum``, ``prod``, ``amax``, ``amin``)."""
    x = b.args[0]
    if b.sym.id is PrimIDs.SUM:
        at = _acc_type(x.dtype)
        return at, "ttr::Sum()", f"({at})0"
    if b.sym.id is PrimIDs.PROD:
        at = _acc_type(x.dtype)
        return at, "ttr::Prod()", f"({at})1"
    mx = b.sym.id is PrimIDs.AMAX
    at = _ct(x.dtype)
    return at, f"ttr::{'MaxNan' if mx else 'MinNan'}()", f"ttr::{'lowest' if mx else 'highest'}<{at}>()"


def _total(b: BoundSymbol, t: str) -> str:
    """A reduction's total ``t`` (its accumulator) as its result: a sum or
    product rounded once to its dtype."""
    if b.sym.id in (PrimIDs.SUM, PrimIDs.PROD):
        return _round(t, b.flat_proxy_outs()[0].dtype)
    return t


def _named(src: str) -> tuple[str, str]:
    """``src`` with its ``@`` names made unique by a hash of it, and its
    entry point."""
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    entry = f"tt_region_{digest}"
    return src.replace("@entry", entry).replace("@", f"_{digest}"), entry


def _launcher(kernel: str, grid: str, block: str, smem: str) -> list[str]:
    """The lines of an entry point that launch ``kernel`` with ``{I}`` its
    index type (``long long`` where ``idx64``) on ``grid`` CTAs of
    ``block`` threads with ``smem`` bytes of dynamic shared memory, in
    clusters of ``a.cluster`` CTAs where it is above 1; ``rc`` holds the
    CUDA error."""
    k64, k32 = kernel.format(I="long long"), kernel.format(I="int")
    return [
        "  if (a.cluster > 1) {",
        "    cudaLaunchConfig_t cfg = {};",
        f"    cfg.gridDim = dim3({grid});",
        f"    cfg.blockDim = {block};",
        f"    cfg.dynamicSmemBytes = {smem};",
        "    cfg.stream = s;",
        "    cudaLaunchAttribute attr[1];",
        "    attr[0].id = cudaLaunchAttributeClusterDimension;",
        "    attr[0].val.clusterDim.x = a.cluster;",
        "    attr[0].val.clusterDim.y = 1;",
        "    attr[0].val.clusterDim.z = 1;",
        "    cfg.attrs = attr;",
        "    cfg.numAttrs = 1;",
        f"    rc = idx64 ? cudaLaunchKernelEx(&cfg, {k64}, a)",
        f"               : cudaLaunchKernelEx(&cfg, {k32}, a);",
        "  } else {",
        f"    if (idx64) {k64}<<<{grid}, {block}, {smem}, s>>>(a);",
        f"    else {k32}<<<{grid}, {block}, {smem}, s>>>(a);",
        "    rc = cudaSuccess;",
        "  }",
        "  if (rc == cudaSuccess) rc = cudaGetLastError();",
    ]


def _off_fn(name: str, lo: str, hi: str, var: str, dense: str | None = None) -> list[str]:
    """A device function ``name(a, k, var)``: the element offset of
    descriptor k at index ``var`` decomposed over its dims ``lo`` to
    ``hi`` - 1 (innermost last)."""
    return ["template <typename I>",
            f"__device__ __forceinline__ I {name}(const Args@& a, int k, I {var}) {{",
            *([f"  if (a.dense[k]) return {dense};"] if dense else []),
            "  I o = 0;",
            f"  for (int d = {hi} - 1; d >= {lo}; --d) {{",
            "    const I sz = static_cast<I>(a.size[k][d]);",
            f"    o += ({var} % sz) * static_cast<I>(a.stride[k][d]);",
            f"    {var} /= sz;",
            "  }",
            "  return o;",
            "}"]


def reduce_source(members: list[BoundSymbol], inputs: list[Proxy],
                  outputs: list[TensorProxy]) -> RegionSpec:
    """Generate the kernel of a region with row reductions: one CTA a row
    of its row space ``(S, r)`` (:func:`row_roles`), a pass over the row
    for each reduction level (a reduction reads members of S computed from
    per-row values of earlier levels), the per-row members after each
    level, and a last pass for the outputs of S that follow the last level.
    Each pass computes the members of S it needs from the inputs; nothing
    of shape S but the outputs is written. The inputs of S that two passes
    read are staged in shared memory once a row where they fit (a launch
    argument: design ``smem``), else each pass reads them again (design
    ``reduce``). A column sum (:func:`is_column_sum`) accumulates the
    CTA's rows in shared memory, one partial a CTA, which a second kernel
    sums as a tree (``ttr::finish_columns``)."""
    S, r, roles = row_roles(members)
    in_index = {p.name: i for i, p in enumerate(inputs)}
    loads: list[tuple] = []
    load_of: dict[tuple, int] = {}
    load_dt: dict[int, dtypes.dtype] = {}
    var: dict[str, str] = {}           # proxy name -> variable holding it
    depth: dict[str, int] = {}         # proxy name -> reduction level it needs
    s_lines: list[tuple[int, str]] = []   # the per-element body, (level, line)
    k_lines: list[tuple[int, str]] = []   # the per-row statements, (level, line)
    reds: list[tuple] = []             # (level, member index, member, operand)
    cols: list[tuple] = []             # the column sums, likewise

    def load(p: TensorProxy, mode: str, shape, bdims) -> str:
        key = (in_index[p.name], mode, tuple(shape), None if bdims is None else tuple(bdims))
        if key not in load_of:
            load_of[key] = len(loads)
            loads.append(key)
            k = load_of[key]
            load_dt[k] = p.dtype
            if mode == "S":
                # the read is filled in once the passes that read it are known
                s_lines.append((0, f"const {_ct(p.dtype)} l{k} = @L{k}@;"))
            else:
                ref = f"ttr::ld(({_CTYPES[p.dtype.name][0]}*)a.p[{key[0]}] + off@(a, {k}, row))"
                k_lines.append((0, f"const {_ct(p.dtype)} l{k} = {_load(ref, p.dtype)};"))
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
        if role in ("red", "col"):
            x = b.args[0]
            xv = var[x.name] if x.name in var else load(x, "S", S, None)
            (reds if role == "red" else cols).append((level + 1, j, b, xv))
            if role == "red":
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
    col_of = {b.flat_proxy_outs()[0].name: j for _, j, b, _ in cols}
    levels = max(lv for lv, *_ in reds + cols)
    ni, no = len(inputs), len(outputs)
    s_out, k_out, finish = {}, [], []
    for k, o in enumerate(outputs):
        store = f"(({_CTYPES[o.dtype.name][0]}*)a.p[{ni + k}])"
        if o.name in col_of:
            finish.append((k, o, col_of[o.name]))     # written by the finishing pass
        elif tuple(o.shape) == S and var[o.name].startswith("v"):
            at = max(depth[o.name] + 1, 1)
            s_out.setdefault(at, []).append(f"      {store}[i] = {_store(var[o.name], o.dtype)};")
        else:
            k_out.append(f"      {store}[row] = {_store(var[o.name], o.dtype)};")
    passes = max([levels, *s_out])
    # the members of S each pass reads: what its reductions and stores need
    plan, read_in = [], {}
    for p in range(1, passes + 1):
        here = [rd for rd in reds if rd[0] == p]
        here_cols = [c for c in cols if c[0] == p]
        need = {xv for *_, xv in here + here_cols}
        for line in s_out.get(p, []):
            need.update(_VAR.findall(line.split("=", 1)[1]))
        keep = []
        for lv, line in reversed([(lv, line) for lv, line in s_lines if lv <= p - 1]):
            name, expr = line.split(" = ", 1)
            if name.rsplit(" ", 1)[1] in need:
                keep.append(line)
                need.update(_VAR.findall(expr))
        keep.reverse()
        for line in keep:
            m = re.match(r"const \S+ l(\d+) = @L", line)
            if m:
                read_in.setdefault(int(m.group(1)), set()).add(p)
        plan.append((p, here, here_cols, keep))
    # the inputs of S that two passes or more read: staged where they fit
    staged = sorted(k for k, ps in read_in.items() if len(ps) > 1)

    def read(k: int) -> str:
        # a dense load's row offset and column stride give its index too
        i, dt = loads[k][0], load_dt[k]
        at = f"rb{k} + offc@(a, {k}, col)" if r == 1 else f"a.dense[{k}] ? i : rb{k} + offc@(a, {k}, col)"
        ref = f"ttr::ld(({_CTYPES[dt.name][0]}*)a.p[{i}] + ({at}))"
        if k in staged:
            ref = f"(STAGED ? st{k}[col - c0] : {ref})"
        return _load(ref, dt)

    body = ["  size_t at = 0;"]
    for k in staged:
        st = _CTYPES[load_dt[k].name][0]
        body += [f"  {st}* st{k} = reinterpret_cast<{st}*>(dyn@ + at);",
                 f"  if (STAGED) at += ttr::align16(static_cast<size_t>(chunk) * sizeof({st}));"]
    for _, j, b, _ in cols:
        acc = _acc_type(b.args[0].dtype)
        body += [f"  {acc}* cs{j} = reinterpret_cast<{acc}*>(dyn@ + at);",
                 f"  at += ttr::align16(static_cast<size_t>(chunk) * sizeof({acc}));"]
    def stage(k: int, rb: str, indent: str) -> list[str]:
        i, st = loads[k][0], _CTYPES[load_dt[k].name][0]
        return [f"{indent}if (a.rowc[{k}])",
                f"{indent}  ttr::stage_row<{st}, I>(st{k}, (({st}*)a.p[{i}]) + {rb} + c0, c1 - c0,"
                f" a.vec[{k}] != 0);",
                f"{indent}else",
                f"{indent}  for (I e = c0 + static_cast<I>(threadIdx.x); e < c1; e += blockDim.x)",
                f"{indent}    st{k}[e - c0] = ttr::ld(({st}*)a.p[{i}] + {rb} + offc@(a, {k}, e));"]

    if staged:
        # an input the same for every row (a norm's weight): staged once
        body.append("  if (STAGED) {")
        for k in staged:
            body += [f"    if (a.inv[{k}]) {{", *stage(k, "0", "      "), "    }"]
        body += ["    __syncthreads();", "  }"]
    # the rows in groups (a column sum's partial a group: its order does not
    # depend on how many CTAs run), each CTA (cluster) a group at a time
    body += ["  const I G = static_cast<I>(a.groups);",
             "  for (I g = static_cast<I>(blockIdx.x) / C; g < G; g += static_cast<I>(gridDim.x) / C) {"]
    if cols:
        body += ["  for (I e = c0 + static_cast<I>(threadIdx.x); e < c1; e += blockDim.x) {",
                 *(f"    cs{j}[e - c0] = 0;" for _, j, _, _ in cols), "  }"]
    body += ["  for (I row = g; row < rows; row += G) {"]
    body += [f"    const I rb{k} = offr@(a, {k}, row);"
             for k, (_, mode, _, _) in enumerate(loads) if mode == "S"]
    if staged:
        body.append("    if (STAGED) {")
        for k in staged:
            body += [f"      if (!a.inv[{k}]) {{", *stage(k, f"rb{k}", "        "), "      }"]
        body += ["      __syncthreads();", "    }"]
    body += [f"    {line}" for lv, line in k_lines if lv == 0]
    for p, here, here_cols, keep in plan:
        for _, j, b, _ in here:
            x = b.args[0]
            if b.sym.id in _ARG:
                body.append(f"    {_ct(x.dtype)} av{j} = 0; long long ai{j} = -1;")
            else:
                at, _, ident = _reduction_parts(b)
                body.append(f"    {at} acc{j} = {ident};")
        # unrolled, so that a thread has several loads of its row in flight
        body += ["#pragma unroll 4",
                 "    for (I col = c0 + static_cast<I>(threadIdx.x); col < c1; col += blockDim.x) {",
                 "      const I i = row * R + col;"]
        for line in keep:
            m = re.match(r"(const \S+ l(\d+) = )@L\d+@;", line)
            body.append(f"      {m.group(1)}{read(int(m.group(2)))};" if m else f"      {line}")
        for _, j, b, xv in here:
            x = b.args[0]
            if b.sym.id in _ARG:
                mx = "true" if b.sym.id is PrimIDs.ARGMAX else "false"
                body.append(f"      ttr::arg_step<{mx}>(av{j}, ai{j}, {xv}, "
                            f"static_cast<long long>(col));")
            else:
                at, op, _ = _reduction_parts(b)
                body.append(f"      acc{j} = {op}(acc{j}, static_cast<{at}>({xv}));")
        for _, j, b, xv in here_cols:
            body.append(f"      cs{j}[col - c0] += static_cast<{_acc_type(b.args[0].dtype)}>({xv});")
        body += s_out.get(p, [])
        body.append("    }")
        for _, j, b, _ in here:
            x = b.args[0]
            if b.sym.id in _ARG:
                mx = "true" if b.sym.id is PrimIDs.ARGMAX else "false"
                ct = _ct(x.dtype)
                body += [f"    ttr::block_arg<{mx}>(av{j}, ai{j}, smem);",
                         f"    const long long k{j} = C > 1 ? ttr::cluster_arg<{mx}>(av{j}, "
                         f"ai{j}, ({ct}*)cslot, (long long*)(cslot + 8)) : ai{j};"]
                continue
            at, op, ident = _reduction_parts(b)
            out = b.flat_proxy_outs()[0]
            body += [f"    {at} t{j} = ttr::block_reduce<{at}>(acc{j}, {op}, {ident}, smem);",
                     f"    if (C > 1) t{j} = ttr::cluster_reduce<{at}>(t{j}, {op}, ({at}*)cslot);",
                     f"    const {_ct(out.dtype)} k{j} = {_total(b, f't{j}')};"]
        body += [f"    {line}" for lv, line in k_lines if lv == p]
    if k_out:
        body += ["    if (threadIdx.x == 0 && rank == 0) {", *k_out, "    }"]
    if staged:
        body.append("    if (STAGED) __syncthreads();")
    body.append("  }")
    for q, (_, j, b, _) in enumerate(cols):
        acc = _acc_type(b.args[0].dtype)
        body += ["  for (I e = c0 + static_cast<I>(threadIdx.x); e < c1; e += blockDim.x)",
                 f"    (({acc}*)a.p[{ni + no + q}])[g * R + e] = cs{j}[e - c0];"]
    body.append("  }")
    nl = max(len(loads), 1)
    rr = max([len(sh) for _, _, sh, _ in loads] + [1])
    # a read of S: its row dims are the leading rr - r of its padded shape
    variants = [f"{t}, {b}" for t in ("int", "long long")
                for b in (("true", "false") if staged else ("false",))]
    offc_fn = (["template <typename I>",
                "__device__ __forceinline__ I offc@(const Args@& a, int k, I col) {",
                f"  return col * static_cast<I>(a.stride[k][{rr - 1}]);", "}"] if r == 1
               else _off_fn("offc@", str(rr - r), str(rr), "col"))
    col_ptr = {j: ni + no + q for q, (_, j, _, _) in enumerate(cols)}
    finishing = []
    for k, o, j in finish:
        acc = _acc_type(members[j].args[0].dtype)
        st = _CTYPES[o.dtype.name][0]
        finishing += [
            "  if (rc == cudaSuccess) {",
            f"    ttr::finish_columns<{acc}, {st}><<<static_cast<unsigned>((a.R + ttr::FINISH_X - 1)"
            " / ttr::FINISH_X), dim3(ttr::FINISH_X, ttr::FINISH_Y), 0, s>>>(",
            f"        (const {acc}*)ptrs[{col_ptr[j]}], parts, a.R, ({st}*)ptrs[{ni + k}]);",
            "    rc = cudaGetLastError();",
            "  }"]
    summary = ", ".join(b.sym.name for b in members)
    src = "\n".join([
        f"// region: {summary} -> {', '.join(o.dtype.name for o in outputs)}, "
        f"rows of rank {len(S) - r} reducing {r}",
        "namespace {",
        "struct Args@ {",
        f"  void* p[{ni + no + len(cols)}];",
        f"  long long size[{nl}][{rr}];",
        f"  long long stride[{nl}][{rr}];",
        f"  int dense[{nl}];",
        f"  int rowc[{nl}];",
        f"  int vec[{nl}];",
        f"  int inv[{nl}];",
        "  long long rows;",
        "  long long R;",
        "  long long groups;",
        "  int cluster;",
        "};",
        *_off_fn("off@", "0", str(rr), "i", dense="i"),
        *_off_fn("offr@", "0", str(rr - r), "row", dense="row * static_cast<I>(a.R)"),
        *offc_fn,
        # STAGED: the inputs two passes read are kept in shared memory
        "template <typename I, bool STAGED>",
        f"__global__ void __launch_bounds__({ROW_THREADS}) tt_region_kernel@(const Args@ a) {{",
        "  __shared__ __align__(16) unsigned char smem[32 * 16];",
        "  __shared__ __align__(16) unsigned char cslot[16];",
        "  extern __shared__ __align__(16) unsigned char dyn@[];",
        "  const I rows = static_cast<I>(a.rows);",
        "  const I R = static_cast<I>(a.R);",
        "  const int C = a.cluster;",
        "  const unsigned rank = C > 1 ? cooperative_groups::this_cluster().block_rank() : 0u;",
        "  const I chunk = C > 1 ? ((R + C - 1) / C + 15) / 16 * 16 : R;",
        "  const I c0 = static_cast<I>(rank) * chunk < R ? static_cast<I>(rank) * chunk : R;",
        "  const I c1 = c0 + chunk < R ? c0 + chunk : R;",
        *body,
        "}",
        "}  // namespace",
        'extern "C" int @entry_setup() {',
        "  cudaError_t e = cudaSuccess;",
        *(f"  if (e == cudaSuccess) e = cudaFuncSetAttribute(tt_region_kernel@<{t}>, "
          f"cudaFuncAttributeMaxDynamicSharedMemorySize, {SMEM_BUDGET});"
          for t in variants),
        "  return static_cast<int>(e);",
        "}",
        'extern "C" int @entry(void* const* ptrs, const long long* meta, int idx64, int blocks,',
        "                      void* stream) {",
        "  Args@ a;",
        f"  for (int k = 0; k < {ni + no + len(cols)}; ++k) a.p[k] = ptrs[k];",
        "  a.rows = meta[0];",
        "  a.R = meta[1];",
        "  const int threads = static_cast<int>(meta[2]);",
        "  a.cluster = static_cast<int>(meta[3]);",
        "  const bool staged = meta[4] != 0;",
        "  const size_t smem_bytes = static_cast<size_t>(meta[5]);",
        "  a.groups = meta[6];",
        "  const long long parts = a.groups;",
        "  (void)parts;",
        f"  for (int k = 0; k < {len(loads)}; ++k) {{",
        f"    const long long* m = meta + 7 + k * {2 * rr + 4};",
        "    a.dense[k] = static_cast<int>(m[0]);",
        "    a.rowc[k] = static_cast<int>(m[1]);",
        "    a.vec[k] = static_cast<int>(m[2]);",
        "    a.inv[k] = static_cast<int>(m[3]);",
        f"    for (int d = 0; d < {rr}; ++d) {{",
        "      a.size[k][d] = m[4 + d];",
        f"      a.stride[k][d] = m[4 + {rr} + d];",
        "    }",
        "  }",
        "  auto s = static_cast<cudaStream_t>(stream);",
        "  cudaError_t rc;",
        *(["  if (staged) {",
           *_launcher("tt_region_kernel@<{I}, true>", "blocks", "dim3(threads)", "smem_bytes"),
           "  } else {"] if staged else ["  (void)staged;", "  {"]),
        *_launcher("tt_region_kernel@<{I}, false>", "blocks", "dim3(threads)", "smem_bytes"),
        "  }",
        *finishing,
        "  return static_cast<int>(rc);",
        "}",
    ])
    src, entry = _named(src)
    param_bytes = 8 * (ni + no + len(cols)) + nl * (16 * rr + 16) + 40
    return RegionSpec(loads, src, entry, any(b.sym.id in TRANSCENDENTAL for b in members),
                      rows=(S, r), param_bytes=param_bytes, design="row",
                      staged=[(k, load_dt[k].bytes) for k in staged],
                      col_sums=[(k, _acc_type(members[j].args[0].dtype)) for k, _, j in finish])


def column_source(members: list[BoundSymbol], inputs: list[Proxy],
                  outputs: list[TensorProxy]) -> RegionSpec:
    """Generate the kernel of a region whose reductions reduce the dims D
    of its space S, not trailing ones (the column design): a CTA a tile of
    kept elements, one a thread column, its thread rows each a strided
    share of the reduced elements in order; the members of S in that loop,
    then the reductions' totals combined down the thread rows as a fixed
    tree (``ttr::tile_reduce``) and across a cluster's CTAs in rank order
    where the reduced extent is split, then the per-kept members. The
    members of S read only the inputs (no reduction's result)."""
    _, S, D = reduction_space(members)
    nr = len(D)
    in_index = {p.name: i for i, p in enumerate(inputs)}
    loads: list[tuple] = []
    load_of: dict[tuple, int] = {}
    var: dict[str, str] = {}
    depth: dict[str, int] = {}
    s_lines: list[str] = []
    k_lines: list[tuple[int, str]] = []
    reds: list[tuple] = []

    def load(p: TensorProxy, mode: str, shape, bdims) -> str:
        key = (in_index[p.name], mode, tuple(shape), None if bdims is None else tuple(bdims))
        if key not in load_of:
            load_of[key] = len(loads)
            loads.append(key)
            k = load_of[key]
            at = f"kb{k} + offj@(a, {k}, j)" if mode == "S" else f"off@(a, {k}, kq)"
            line = (f"const {_ct(p.dtype)} l{k} = "
                    f"{_load(f'ttr::ld(({_CTYPES[p.dtype.name][0]}*)a.p[{key[0]}] + {at})', p.dtype)};")
            if mode == "S":
                s_lines.append(line)
            else:
                k_lines.append((0, line))
        return f"l{load_of[key]}"

    def valf(mode: str):
        def val(a, dt) -> str:
            if _is_number(a):
                return _literal(a, dt)
            src = var[a.name] if a.name in var else load(
                a, mode, S if mode == "S" else a.shape, None)
            if dt is None:
                return src
            return _convert(src, a.dtype, dt) if a.dtype != dt else src
        return val

    for j, b in enumerate(members):
        out = b.flat_proxy_outs()[0]
        level = max((depth.get(p.name, 0) for p in b.flat_proxy_args()), default=0)
        if b.sym.id in _REDUCTIONS:
            x = b.args[0]
            reds.append((j, b, var[x.name] if x.name in var else load(x, "S", S, None)))
            depth[out.name] = 1
            var[out.name] = f"k{j}"
            continue
        depth[out.name] = level
        role = "S" if tuple(out.shape) == S else "K"
        pid, a0 = b.sym.id, b.args[0]
        if pid is PrimIDs.BROADCAST_IN_DIM and a0.name not in var:
            expr = load(a0, role, S if role == "S" else out.shape, b.args[2])
        elif pid in (PrimIDs.RESHAPE, PrimIDs.SQUEEZE):
            expr = var[a0.name] if a0.name in var else load(a0, "K", a0.shape, None)
        else:
            expr = _member_expr(b, valf(role))
        name = f"v{j}" if role == "S" else f"k{j}"
        line = f"const {_ct(out.dtype)} {name} = {expr};"
        if role == "S":
            s_lines.append(line)
        else:
            k_lines.append((level, line))
        var[out.name] = name
    ni, no = len(inputs), len(outputs)
    descs = [(mode, sh) for _, mode, sh, _ in loads]
    s_stores, k_stores, s_outs = [], [], []
    for k, o in enumerate(outputs):
        store = f"(({_CTYPES[o.dtype.name][0]}*)a.p[{ni + k}])"
        if tuple(o.shape) == S:
            d = len(descs)
            descs.append(("S", S))
            s_outs.append(k)
            s_stores.append(f"        {store}[kb{d} + offj@(a, {d}, j)] = "
                            f"{_store(var[o.name], o.dtype)};")
        else:
            k_stores.append(f"      {store}[kk] = {_store(var[o.name], o.dtype)};")
    nd = len(descs)
    rr = max([len(sh) for _, sh in descs] + [len(S)])
    nred = len(reds)
    kb = [f"const I kb{d} = offk@(a, {d}, kq);" for d, (mode, _) in enumerate(descs)
          if mode == "S"]
    accs = [f"{_reduction_parts(b)[0]} acc{j} = {_reduction_parts(b)[2]};" for j, b, _ in reds]
    adds = [f"  acc{j} = {op}(acc{j}, static_cast<{at}>({xv}));"
            for j, b, xv in reds for at, op, _ in [_reduction_parts(b)]]
    totals = [f"const {_ct(b.flat_proxy_outs()[0].dtype)} k{j} = {_total(b, f't{j}')};"
              for j, b, _ in reds]
    # a lone thread row and no cluster (a few terms each): COLUMN_UNROLL
    # neighbouring kept elements a thread at a time, each summing its terms
    # in order, so that their reads are in flight together and share cache
    # lines; no tree, no barrier
    # the innermost kept dim's extent (the same in every descriptor of S):
    # within it, a thread's neighbouring elements step by its stride
    s_descs = [d for d, (mode, _) in enumerate(descs) if mode == "S"]
    inner = f"a.size[{s_descs[0]}][{rr - nr - 1}]" if s_descs and rr > nr else "1"
    body = ["  if (blockDim.y == 1 && C == 1) {",
            f"    const I step = static_cast<I>(gridDim.x) * blockDim.x * {COLUMN_UNROLL};",
            f"    for (I base = static_cast<I>(blockIdx.x) * blockDim.x * {COLUMN_UNROLL}; "
            "base < nK; base += step) {",
            f"      const I kq0 = base + static_cast<I>(threadIdx.x) * {COLUMN_UNROLL};",
            f"      const I in0 = static_cast<I>({inner});",
            f"      const bool run = kq0 % in0 + {COLUMN_UNROLL} <= in0;",
            *(f"      const I kb{d}_0 = offk@(a, {d}, kq0 < nK ? kq0 : 0);" for d in s_descs),
            "#pragma unroll",
            f"      for (int u = 0; u < {COLUMN_UNROLL}; ++u) {{",
            "        const I kq = kq0 + u;",
            "        if (kq < nK) {",
            "          const I kk = kq;",
            *(f"          const I kb{d} = run ? kb{d}_0 + static_cast<I>(u) * "
              f"static_cast<I>(a.stride[{d}][{rr - nr - 1}]) : offk@(a, {d}, kq);"
              for d in s_descs),
            *(f"          {line}" for lv, line in k_lines if lv == 0),
            *(f"          {line}" for line in accs),
            "#pragma unroll 4",
            "          for (I j = 0; j < nR; ++j) {",
            *(f"            {line}" for line in s_lines),
            *(f"          {line}" for line in adds),
            *(f"    {line}" for line in s_stores),
            "          }",
            *(f"          {_reduction_parts(b)[0]} t{j} = acc{j};" for j, b, _ in reds),
            *(f"          {line}" for line in totals),
            *(f"          {line}" for lv, line in k_lines if lv > 0),
            *(f"    {line}" for line in k_stores),
            "        }",
            "      }",
            "    }",
            "    return;",
            "  }"]
    body += ["  for (I tile = static_cast<I>(blockIdx.x) / C; tile < tiles;",
             "       tile += static_cast<I>(gridDim.x) / C) {",
             "    const I kk = tile * static_cast<I>(blockDim.x) + static_cast<I>(threadIdx.x);",
             "    const bool live = kk < nK;",
             "    const I kq = live ? kk : 0;",
             *(f"    {line}" for line in kb),
             *(f"    {line}" for lv, line in k_lines if lv == 0),
             *(f"    {line}" for line in accs),
             "    if (live) {",
             "#pragma unroll 4",
             "      for (I j = j0 + static_cast<I>(threadIdx.y); j < j1; j += blockDim.y) {",
             *(f"        {line}" for line in s_lines),
             *(f"      {line}" for line in adds),
             *s_stores, "      }", "    }"]
    for q, (j, b, _) in enumerate(reds):
        at, op, _ = _reduction_parts(b)
        body += [f"    {at} t{j} = ttr::tile_reduce<{at}>(acc{j}, {op}, "
                 f"reinterpret_cast<{at}*>(red[{q}]));",
                 f"    if (C > 1) t{j} = ttr::tile_cluster_reduce<{at}>({op}, "
                 f"reinterpret_cast<{at}*>(red[{q}]));"]
    body += [*(f"    {line}" for line in totals),
             "    if (live && threadIdx.y == 0 && rank == 0) {",
             *(f"      {line}" for lv, line in k_lines if lv > 0), *k_stores, "    }", "  }"]
    summary = ", ".join(b.sym.name for b in members)
    src = "\n".join([
        f"// region: {summary} -> {', '.join(o.dtype.name for o in outputs)}, "
        f"columns of rank {len(S)} reducing dims {', '.join(map(str, D))}",
        "namespace {",
        "struct Args@ {",
        f"  void* p[{ni + no}];",
        f"  long long size[{nd}][{rr}];",
        f"  long long stride[{nd}][{rr}];",
        "  long long nK;",
        "  long long nR;",
        "  int cluster;",
        "};",
        # a per-kept read: over its own (padded) shape; a read or write of S:
        # its kept dims lead its padded dims, its reduced dims close them
        *_off_fn("off@", "0", str(rr), "i"),
        *_off_fn("offk@", "0", str(rr - nr), "i"),
        # one reduced dim: j is its index (j < nR)
        *(["template <typename I>",
           "__device__ __forceinline__ I offj@(const Args@& a, int k, I j) {",
           f"  return j * static_cast<I>(a.stride[k][{rr - 1}]);", "}"] if nr == 1
          else _off_fn("offj@", str(rr - nr), str(rr), "j")),
        "template <typename I>",
        f"__global__ void __launch_bounds__({COLUMN_THREADS}) tt_region_kernel@(const Args@ a) {{",
        f"  __shared__ __align__(16) unsigned char red[{nred}][{COLUMN_THREADS} * 8];",
        "  const I nK = static_cast<I>(a.nK);",
        "  const I nR = static_cast<I>(a.nR);",
        "  const int C = a.cluster;",
        "  const unsigned rank = C > 1 ? cooperative_groups::this_cluster().block_rank() : 0u;",
        "  const I chunk = (nR + C - 1) / C;",
        "  const I j0 = static_cast<I>(rank) * chunk < nR ? static_cast<I>(rank) * chunk : nR;",
        "  const I j1 = j0 + chunk < nR ? j0 + chunk : nR;",
        "  const I tiles = (nK + static_cast<I>(blockDim.x) - 1) / static_cast<I>(blockDim.x);",
        *body,
        "}",
        "}  // namespace",
        'extern "C" int @entry(void* const* ptrs, const long long* meta, int idx64, int blocks,',
        "                      void* stream) {",
        "  Args@ a;",
        f"  for (int k = 0; k < {ni + no}; ++k) a.p[k] = ptrs[k];",
        "  a.nK = meta[0];",
        "  a.nR = meta[1];",
        "  const dim3 threads(static_cast<unsigned>(meta[2]), static_cast<unsigned>(meta[3]));",
        "  a.cluster = static_cast<int>(meta[4]);",
        f"  for (int k = 0; k < {nd}; ++k)",
        f"    for (int d = 0; d < {rr}; ++d) {{",
        f"      a.size[k][d] = meta[5 + k * {2 * rr} + d];",
        f"      a.stride[k][d] = meta[5 + k * {2 * rr} + {rr} + d];",
        "    }",
        "  auto s = static_cast<cudaStream_t>(stream);",
        "  cudaError_t rc;",
        *_launcher("tt_region_kernel@<{I}>", "blocks", "threads", "0"),
        "  return static_cast<int>(rc);",
        "}",
    ])
    src, entry = _named(src)
    param_bytes = 8 * (ni + no) + nd * 16 * rr + 24
    return RegionSpec(loads, src, entry, any(b.sym.id in TRANSCENDENTAL for b in members),
                      param_bytes=param_bytes, design="column", cols=(S, D), s_outs=s_outs)


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
        if s.rows is not None:
            # the row design's dynamic shared memory, up to SMEM_BUDGET a CTA
            setup = getattr(handle, f"{s.entry}_setup")
            setup.restype = ctypes.c_int
            rc = setup()
            if rc != 0:
                raise KernelLaunchError(f"{s.entry}: cudaFuncSetAttribute failed with CUDA "
                                        f"error {rc}")
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
        space = reduction_space(members)
        if space is not None:
            gen = reduce_source if space[0] == "row" else column_source
            self.spec = gen(members, inputs, outputs)
            self.shape = space[1]
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


def launch(region: Region, vals, stage: bool = True) -> tuple:
    """One launch of ``region``'s generated kernel on the card (building
    the program's regions first where they are not); raises for tensors off
    the card or of another shape or dtype than the region's inputs, for a
    region whose source did not build, and for a launch that returns a
    CUDA error. ``stage`` False launches a region with row reductions
    without staging its rows in shared memory (design ``reduce``: each
    pass reads its row again; the same order, so the same bits), to
    measure what the staging saves."""
    spec = region.spec
    tensors = [v for v in vals if isinstance(v, torch.Tensor)]
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{region.name}: the kernel takes CUDA tensors on one card, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    for p, v in zip(region.inputs, vals):
        if isinstance(p, TensorProxy) and (
                not isinstance(v, torch.Tensor) or tuple(v.shape) != tuple(p.shape)
                or v.dtype != p.dtype.torch):
            raise ValueError(f"{region.name}: input {p.name} must be a {p.dtype.name} tensor of "
                             f"shape {tuple(p.shape)}, got "
                             f"{tuple(v.shape) if isinstance(v, torch.Tensor) else type(v)}")
    if spec.entry not in _bound and spec.entry not in _failures:
        build_regions([r.spec for r in region.program] or [spec])
    fn = _bound.get(spec.entry)
    if fn is None:
        raise KernelBuildError(f"{region.name}: its generated source did not build, so this "
                               f"region cannot launch:\n{_failures.get(spec.entry)}",
                               kernel="region")
    if spec.rows is not None:
        return _launch_rows(region, fn, vals, dev, stage)
    if spec.cols is not None:
        return _launch_cols(region, fn, vals, dev)
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


def row_launch(rows: int, R: int, sms: int, smem: int = 0) -> tuple[int, int, int]:
    """``(cluster, threads, blocks)`` of a launch over ``rows`` rows of
    ``R``: where the rows fill the card, one CTA a row of up to
    :data:`THREADS` threads, up to 8 CTAs an SM (fewer where each takes
    ``smem`` bytes of dynamic shared memory) grid-striding over the rows;
    where they do not, each row split across a cluster of up to
    :data:`MAX_CLUSTER` CTAs (a part of at least :data:`CLUSTER_MIN_PART`
    elements each) of up to :data:`ROW_THREADS` threads."""
    def fit(n, cap):
        return min(cap, max(32, -(-n // 32) * 32))

    if rows >= sms:
        threads = fit(R, THREADS)
        per_sm = min(BLOCKS_PER_SM, 2048 // threads, SMEM_PER_SM // (smem + 1024 + 528))
        return 1, threads, min(rows, sms * max(per_sm, 1))
    c = max(1, min(MAX_CLUSTER, sms // rows, R // CLUSTER_MIN_PART))
    return c, fit(-(-R // c), ROW_THREADS), rows * c


def row_part(R: int, cluster: int) -> int:
    """The columns of a row each CTA of a cluster takes (a multiple of 16
    where the row is split)."""
    return R if cluster == 1 else -(-(-(-R // cluster)) // 16) * 16


def row_plan(spec: RegionSpec, rows: int, R: int, sms: int, stage: bool = True) -> dict:
    """The launch of a region with row reductions over ``rows`` rows of
    ``R`` on ``sms`` SMs: :func:`row_launch`'s ``cluster``, ``threads`` and
    ``blocks``; ``staged`` whether the inputs two passes read are staged:
    where ``stage`` and they fit in shared memory beside the column sums'
    accumulators (:data:`SMEM_BUDGET`; design ``smem``, else ``reduce``);
    ``smem`` the dynamic shared memory a CTA takes; ``parts`` the column
    sums' partials (one a cluster of CTAs); ``design`` its launch
    counter's design. The rows go in ``parts``
    groups (row g, g + parts, ...; a CTA, or a cluster, a group at a
    time), each group a partial of every column sum: as many as the CTAs
    without column sums; with them, as many as the CTAs of a launch
    without shared memory, so that a column sum's order does not depend on
    what else the region stages."""
    cluster, threads, _ = row_launch(rows, R, sms)
    part = row_part(R, cluster)

    def a16(n):
        return -(-n // 16) * 16

    rowbytes = sum(a16(part * b) for _, b in spec.staged)
    cols = sum(a16(part * _ACC_BYTES[acc]) for _, acc in spec.col_sums)
    staged = stage and bool(spec.staged) and rowbytes + cols <= SMEM_BUDGET
    smem = cols + (rowbytes if staged else 0)
    cluster, threads, blocks = row_launch(rows, R, sms, smem)
    design = ("smem" if staged else "reduce") + ("_partials" if spec.col_sums else "")
    parts = (row_launch(rows, R, sms)[2] if spec.col_sums else blocks) // cluster
    return dict(cluster=cluster, threads=threads, blocks=blocks, staged=staged, smem=smem,
                parts=parts, design=design)


def tree_depth(n: int) -> int:
    """The most roundings one term goes through in ``ttr::tree_sum`` of
    ``n`` terms (a binary counter of subtrees, folded from the newest)."""
    stack: list[tuple[int, int]] = []      # (level, deepest term's roundings)
    for _ in range(n):
        lvl, d = 0, 0
        while stack and stack[-1][0] == lvl:
            d = max(d, stack.pop()[1]) + 1
            lvl += 1
        stack.append((lvl, d))
    if not stack:
        return 0
    d = stack[-1][1]
    for _, dk in reversed(stack[:-1]):
        d = max(d, dk) + 1
    return d


def sum_depth(rows: int, R: int, sms: int) -> int:
    """The most roundings one summand goes through in a region's float sum
    of a row of ``R`` (the order of the kernel :func:`row_launch` gives
    ``rows`` rows on ``sms`` SMs): its thread's running sum over its
    columns, the two shuffle trees of ``ttr::block_reduce`` (5 levels each)
    and the cluster's partials in rank order. Such a sum is within
    ``d u / (1 - d u) sum|x_i|`` of the exact sum (d this depth, u the
    accumulator's unit roundoff)."""
    cluster, threads, _ = row_launch(rows, R, sms)
    return -(-row_part(R, cluster) // threads) - 1 + 10 + cluster - 1


def partials_depth(rows: int, plan: dict) -> int:
    """The most roundings one summand goes through in a column sum of a
    row space of ``rows`` rows launched as ``plan`` (:func:`row_plan`):
    its group's running sum over its rows, then
    ``ttr::finish_columns``: a lane's tree over its block of partials and
    the tree over the :data:`FINISH_Y` lanes."""
    parts = plan["parts"]
    return (-(-rows // parts) - 1 + tree_depth(-(-parts // FINISH_Y))
            + FINISH_Y.bit_length() - 1)


def column_launch(nK: int, nR: int, sms: int) -> tuple[int, int, int, int]:
    """``(cluster, tx, ty, blocks)`` of a column-design launch over ``nK``
    kept elements, each reducing ``nR``: CTAs of :data:`COLUMN_THREADS`
    threads, ``tx`` kept elements by ``ty`` thread rows (``ty`` a power of
    two up to 8 and up to ``nR``; 1 where ``nR`` is at most
    :data:`COLUMN_ALONE`: a thread sums its element's few terms alone, with
    no tree and no barrier a tile), up to 8 CTAs an SM grid-striding over
    the tiles; where the tiles do not fill the card, the reduced extent
    split across a cluster of up to :data:`MAX_CLUSTER` CTAs, at least
    :data:`CLUSTER_MIN_ROWS` reduced elements a thread row each."""
    ty = 1
    while ty < 8 and 2 * ty <= nR and nR > COLUMN_ALONE:
        ty *= 2
    tx = COLUMN_THREADS // ty
    tiles = -(-nK // tx)
    if tiles >= sms:
        if ty == 1:     # COLUMN_UNROLL tiles a thread at a time
            tiles = -(-tiles // COLUMN_UNROLL)
        return 1, tx, ty, min(tiles, sms * BLOCKS_PER_SM)
    c = max(1, min(MAX_CLUSTER, sms // tiles, nR // (ty * CLUSTER_MIN_ROWS)))
    return c, tx, ty, tiles * c


def column_depth(nK: int, nR: int, sms: int) -> int:
    """The most roundings one summand goes through in a column-design sum
    (:func:`column_launch`): its thread's running sum over its share of
    the reduced elements, the tree down the tile's ``ty`` thread rows, the
    cluster's partials in rank order."""
    cluster, _, ty, _ = column_launch(nK, nR, sms)
    return -(-(-(-nR // cluster)) // ty) - 1 + ty.bit_length() - 1 + cluster - 1


def space_sizes(spec: RegionSpec) -> tuple[int, int]:
    """``(kept, reduced)``: the rows and the row length of a row-design
    region, the kept and reduced elements of a column-design one."""
    if spec.rows is not None:
        S, r = spec.rows
        return math.prod(S[:len(S) - r]), math.prod(S[len(S) - r:])
    S, D = spec.cols
    return math.prod(n for d, n in enumerate(S) if d not in D), math.prod(S[d] for d in D)


def sum_depths(region: Region, sms: int) -> list[int]:
    """The depth (:func:`sum_depth`, :func:`partials_depth`,
    :func:`column_depth`) of each ``sum`` of a float input among
    ``region``'s members, in order, launched on ``sms`` SMs."""
    spec = region.spec
    nK, nR = space_sizes(spec)
    sums = [b for b in region.members if b.sym.id is PrimIDs.SUM and b.args[0].dtype.is_float]
    if spec.cols is not None:
        return [column_depth(nK, nR, sms)] * len(sums)
    S, r = spec.rows
    plan = row_plan(spec, nK, nR, sms)
    return [sum_depth(nK, nR, sms) if tuple(b.args[0].shape) == S and trailing_r(b) == r
            else partials_depth(nK, plan) for b in sums]


def _load_strides(t: torch.Tensor, mode: str, shape: tuple, bdims) -> list[int]:
    if bdims is not None:
        return _strides(t, shape, bdims)
    if mode == "S":
        return _strides(t, shape, None)
    return _view_strides(t, shape)


def _launch_rows(region: Region, fn, vals, dev, stage: bool) -> tuple:
    """One launch of a region with row reductions: one CTA a row of its row
    space, grid-striding over the rows (:func:`row_plan`), then the column
    sums' finishing pass."""
    spec = region.spec
    S, r = spec.rows
    rows, R = space_sizes(spec)
    outs = [torch.empty(tuple(o.shape), dtype=o.dtype.torch, device=dev)
            for o in region.outputs]
    if rows == 0:
        for k, _ in spec.col_sums:
            outs[k].zero_()
        return tuple(outs)
    rr = max([len(sh) for _, _, sh, _ in spec.loads] + [1])
    plan = row_plan(spec, rows, R, _sm_count(dev.index), stage)
    cluster = plan["cluster"]
    meta = [rows, R, plan["threads"], cluster, int(plan["staged"]), plan["smem"], plan["parts"]]
    reach = max(rows * R, plan["parts"] * R)
    for i, mode, shape, bdims in spec.loads:
        t = vals[i]
        st = _load_strides(t, mode, shape, bdims)
        reach = max(reach, sum(abs(x) * (e - 1) for x, e in zip(st, shape)) + 1)
        pad = rr - len(shape)
        dense = st == _contiguous_strides(shape)
        # the row's columns contiguous from the row's first: 16-byte copies
        # where the row and every part of it start 16-byte aligned
        trail = shape[len(shape) - r:]
        rowc = mode == "S" and st[len(shape) - r:] == _contiguous_strides(trail)
        el = t.element_size()
        vec = rowc and t.data_ptr() % 16 == 0 and all(
            (x * el) % 16 == 0 for x in st[:len(shape) - r])
        # the same for every row: no stride on a kept dim
        inv = mode == "S" and not any(st[:len(shape) - r])
        meta += [int(dense), int(rowc), int(vec), int(inv), *([1] * pad), *shape, *([0] * pad),
                 *st]
    parts = [torch.empty((plan["parts"], R), dtype=_ACC_TORCH[acc], device=dev)
             for _, acc in spec.col_sums]
    ptrs = [v.data_ptr() if isinstance(v, torch.Tensor) else 0 for v in vals]
    ptrs += [o.data_ptr() for o in outs] + [p.data_ptr() for p in parts]
    rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(meta))(*meta),
            int(reach > 2 ** 31 - 1), plan["blocks"], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(f"{region.name}: kernel launch failed with CUDA error {rc}")
    cudaex.count_launch("region", plan["design"])
    return tuple(outs)


def _launch_cols(region: Region, fn, vals, dev) -> tuple:
    """One launch of a region of the column design (:func:`column_launch`)."""
    spec = region.spec
    S, D = spec.cols
    nK, nR = space_sizes(spec)
    outs = [torch.empty(tuple(o.shape), dtype=o.dtype.torch, device=dev)
            for o in region.outputs]
    if nK == 0:
        return tuple(outs)
    perm = [d for d in range(len(S)) if d not in D] + list(D)
    descs = [(_load_strides(vals[i], mode, shape, bdims), mode, shape)
             for i, mode, shape, bdims in spec.loads]
    descs += [(_contiguous_strides(S), "S", S) for _ in spec.s_outs]
    rr = max([len(sh) for _, _, sh in descs] + [len(S)])
    cluster, tx, ty, blocks = column_launch(nK, nR, _sm_count(dev.index))
    meta = [nK, nR, tx, ty, cluster]
    reach = nK * nR
    for st, mode, shape in descs:
        reach = max(reach, sum(abs(x) * (e - 1) for x, e in zip(st, shape)) + 1)
        if mode == "S":
            shape, st = [shape[d] for d in perm], [st[d] for d in perm]
        pad = rr - len(shape)
        meta += [*([1] * pad), *shape, *([0] * pad), *st]
    ptrs = [v.data_ptr() if isinstance(v, torch.Tensor) else 0 for v in vals]
    ptrs += [o.data_ptr() for o in outs]
    rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(meta))(*meta),
            int(reach > 2 ** 31 - 1), blocks, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelLaunchError(f"{region.name}: kernel launch failed with CUDA error {rc}")
    cudaex.count_launch("region", "column")
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
                                    "design": fn.spec.design,
                                    "reduced_dims": (fn.spec.rows[1] if fn.spec.rows else
                                                     len(fn.spec.cols[1]) if fn.spec.cols
                                                     else 0)})
        notes = [b.header for b in members if b.header]
        if notes:
            bsym.header = "\n".join(notes)
        return bsym


def _out_shape(b: BoundSymbol) -> tuple:
    return tuple(b.flat_proxy_outs()[0].shape)


def _kept(shape, S: tuple, D: tuple) -> bool:
    """Is ``shape`` a per-row shape of the space ``(S, D)``: S without its
    reduced dims D, with or without 1s?"""
    return _non_unit(shape) == _non_unit([n for d, n in enumerate(S) if d not in D])


def _reads_own_row(b: BoundSymbol, S: tuple, D: tuple) -> bool:
    """Does the ``broadcast_in_dim`` ``b`` of a per-row value of ``(S, D)``
    give each element (of S, or of its own per-row shape) its own row's
    value?"""
    src, shape, bdims = b.args[0].shape, tuple(b.args[1]), tuple(b.args[2])
    kept = [(i, n) for i, n in enumerate(src) if n != 1]
    if shape == S:
        want = [d for d in range(len(S)) if d not in D and S[d] != 1]
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


def _spaces(group: list[BoundSymbol]) -> dict[tuple, tuple]:
    """Each shape S a reduction of the group reduces: ``("row", D)`` where
    one reduces its trailing dims D (the first such), else ``("column", D)``
    with the dims D of its first reduction."""
    space: dict[tuple, tuple] = {}
    for b in group:
        if b.sym.id in _REDUCTIONS and trailing_r(b):
            S = tuple(b.args[0].shape)
            space.setdefault(S, ("row", tuple(range(len(S) - trailing_r(b), len(S)))))
    for b in group:
        if b.sym.id in _REDUCTIONS and not trailing_r(b):
            space.setdefault(tuple(b.args[0].shape), ("column", _reduced_dims(b)))
    return space


def _joins(b: BoundSymbol, space: dict) -> str | None:
    """How the reduction ``b`` joins its input shape's space: ``"red"``
    (a row reduction, or a column-design reduction over the space's dims),
    ``"col"`` (a column sum of a row space, :func:`is_column_sum`), None
    where it stays alone."""
    S = tuple(b.args[0].shape)
    design, D = space.get(S, (None, None))
    if design == "row":
        if trailing_r(b) == len(D):
            return "red"
        return "col" if is_column_sum(b, S, len(D)) else None
    if design == "column" and b.sym.id not in _ARG and _reduced_dims(b) == D:
        return "red"
    return None


def _plan(group: list[BoundSymbol], rows: bool, kept: bool) -> list[list[BoundSymbol]] | None:
    """One partition of a group into regions' units. Without ``rows``, one
    unit a members' output shape, every reduction and unit view alone. With
    ``rows``, a space for each shape S that a member reduces
    (:func:`_spaces`): its unit takes the members of shape S and the
    reductions that join it (:func:`_joins`); with ``kept`` also the
    per-row members of its kept shape that read a reduction's result (in
    program order) or that only its space reads (in reverse order), and
    the unit views between them. A member that reads a column sum's result
    leaves its row space (a second kernel writes that result), and so does
    a member of S or a reduction that reads a column-design reduction's
    result (that design makes one pass). None where the units'
    dependencies form a cycle."""
    key: dict[int, tuple] = {}
    space = _spaces(group) if rows else {}
    joins = {id(b): _joins(b, space) for b in group if b.sym.id in _REDUCTIONS}
    for b in group:
        if b.sym.id in _REDUCTIONS:
            key[id(b)] = ("row", tuple(b.args[0].shape)) if joins[id(b)] else ("one", id(b))
        elif is_unit_view(b):
            key[id(b)] = ("one", id(b))
        elif _out_shape(b) in space:
            key[id(b)] = ("row", _out_shape(b))
        else:
            key[id(b)] = ("shape", _out_shape(b))
    produced = {p.name: b for b in group for p in b.flat_proxy_outs()}
    per_row: dict[str, tuple] = {}      # a per-row value -> the S of its space

    def kept_ok(b, S) -> bool:
        """May ``b`` join space S as a per-row member: each operand it
        reads there per row, and a broadcast its own row's value."""
        if b.sym.id is PrimIDs.BROADCAST_IN_DIM and b.args[0].name in per_row:
            return _reads_own_row(b, S, space[S][1])
        return True

    for b in group:
        if b.sym.id in _REDUCTIONS and joins[id(b)] == "red":
            per_row[b.flat_proxy_outs()[0].name] = tuple(b.args[0].shape)
        elif kept and key[id(b)][0] != "row" and b.sym.id not in _REDUCTIONS:
            spaces = {per_row[p.name] for p in b.flat_proxy_args() if p.name in per_row}
            S = next(iter(spaces)) if len(spaces) == 1 else None
            if S is not None and _kept(_out_shape(b), S, space[S][1]) and kept_ok(b, S):
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
                    or not _kept(out.shape, S, space[S][1]) or not kept_ok(b, S)):
                continue
            # a broadcast of it to S must give each element its own row's value
            if all(u.sym.id is not PrimIDs.BROADCAST_IN_DIM
                   or _reads_own_row(u, S, space[S][1]) for u in users if _out_shape(u) == S):
                key[id(b)] = ("row", S)
                per_row[out.name] = S
    # a broadcast of S that reads a per-row value of its own space must give
    # each element its row's value; else it stays out
    for b in group:
        k = key[id(b)]
        if (k[0] == "row" and b.sym.id is PrimIDs.BROADCAST_IN_DIM and _out_shape(b) == k[1]
                and tuple(b.args[0].shape) != k[1] and b.args[0].name in produced
                and key[id(produced[b.args[0].name])] == k
                and not _reads_own_row(b, k[1], space[k[1]][1])):
            key[id(b)] = ("one", id(b))
    for S, (design, _) in space.items():
        _eject(group, key, joins, ("row", S), design)
    # an elementwise unit must not both feed a space's unit and read its
    # results (a norm weight converted for the backward, its gradient after
    # the column sum): each splits by the spaces' units before it
    stage: dict[int, int] = {}
    for b in group:
        s = 0
        for p in b.flat_proxy_args():
            q = produced.get(p.name)
            if q is not None:
                s = max(s, stage[id(q)] + (key[id(q)][0] == "row" and key[id(q)] != key[id(b)]))
        stage[id(b)] = s
        if key[id(b)][0] == "shape":
            key[id(b)] = (*key[id(b)], s)
    units: dict[tuple, list] = {}
    for b in group:
        units.setdefault(key[id(b)], []).append(b)
    return _order(list(units.values()))


def _eject(group, key: dict, joins: dict, unit: tuple, design: str) -> None:
    """Take out of ``unit`` (a space's key) the members its kernel cannot
    compute: in a row space, whatever reads a column sum's result; in a
    column space, a member of S or a reduction that reads a reduction's
    result. So does a member that reads a value some member outside the
    unit made from such a result (else the units would form a cycle)."""
    S = unit[1]
    inside: set[str] = set()     # results the unit's per-kept members may read
    outside: set[str] = set()    # values made outside the unit from them
    for b in group:
        names = {p.name for p in b.flat_proxy_args()}
        outs = {p.name for p in b.flat_proxy_outs()}
        if key[id(b)] != unit:
            if names & (inside | outside):
                outside |= outs
            continue
        if b.sym.id in _REDUCTIONS and (design == "column" or joins[id(b)] == "col"):
            # a reduction's result: a column sum's is read by nothing in its unit
            if not names & (inside | outside):
                (outside if joins[id(b)] == "col" else inside).update(outs)
                continue
        elif not names & (inside | outside):
            continue
        elif (design == "column" and not names & outside and _out_shape(b) != S
              and b.sym.id not in _REDUCTIONS):
            inside |= outs          # a per-kept member after the reductions
            continue
        key[id(b)] = (("one", id(b)) if b.sym.id in _REDUCTIONS or is_unit_view(b)
                      else ("shape", _out_shape(b)))
        outside |= outs


def split_row_spaces(group: list[BoundSymbol]) -> list[list[BoundSymbol]]:
    """A partitioner group as regions' units, in an order that keeps every
    unit's inputs produced before it: each space (its members of shape S,
    its reductions, its per-row members; see :func:`_plan`) one unit,
    every other member in one unit a output shape and stage (the
    elementwise regions), unit views and any other reduction alone. Where
    a space's per-row members would close a cycle through another unit
    they stay out; where its reductions would, they stay out too; a group
    that still forms a cycle (none is known) stays as its members, each
    alone."""
    for rows, kept in ((True, True), (True, False), (False, False)):
        units = _plan(group, rows, kept)
        if units is not None:
            return units
    return [[b] for b in group]


ex = RegionExecutor()
register_executor(ex, default=True)
