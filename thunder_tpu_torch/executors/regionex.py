"""The region executor: elementwise regions of a program as generated kernels.

The counterpart of ``thunder_tpu/executors/xla.py`` (``XLAFusionExecutor``
:77), which hands each fused region to ``jax.jit`` and lets XLA fuse it.
Here the ``region`` fusion executor groups the unclaimed elementwise prims
of an execution trace (every prim tagged ``ELEMENTWISE_OP``, plus
``broadcast_in_dim`` and ``convert_element_type``; never a reduction, a
view of another kind, a host-sync op or anything another executor claimed)
with the reference's dataflow partitioner
(:mod:`~thunder_tpu_torch.executors.data_dependent_partition`), splits each
group by its members' output shape (one iteration space a region), and
binds each part of at least ``region_min_region_size`` members as one
symbol ``region.fusion<i>``, its members kept as subsymbols.

A region's callable (:class:`Region`) runs its plain version for tensors on
the CPU: the members' torch implementations in order (the reference's
``run_bsyms``). For tensors on the card it launches one kernel generated
from its members as CUDA C++ for ``sm_90a`` (:func:`region_source`),
compiled by ``nvcc`` and bound with ``ctypes`` as the hand-written kernels
of :mod:`~thunder_tpu_torch.executors.cudaex` are, or raises. It replaces no
Pallas kernel: it stands for the XLA fusions the reference's regions
become. It is bound by bytes (each input read once, each output written
once); the design is one pass over the region's iteration space, every
intermediate kept in registers.

Numerics: the region equals its plain chain. Each op computes as torch's
CUDA kernel does: 16-bit values in float32 (opmath), each member's result
rounded to the dtype the trace gives it (``__float2bfloat16_rn`` /
``__float2half_rn``); no FMA contraction (``--fmad=false``); constants as
exact hex literals, converted as torch converts a Python scalar (to the
compute type); the device math functions torch calls (``expf``, ``logf``,
``rsqrtf``, ``sinf``, ``cosf``; no fast math); ``t / c`` as torch computes
it, ``t * (1 / c)``, and ``c / t`` as ``reciprocal(t) * c``. Bool and
integer members keep their dtypes.

Source and build: a region's source depends only on its ops, constants,
dtypes and rank; sizes and each input's strides (its torch strides,
composed with a member's broadcast: stride 0 on a broadcast dim) are
launch arguments, so one source serves every shape. The first launch of
any region of a program compiles every region of that program not built
yet in one ``nvcc`` call, into ``thunder_tpu_torch/_build/`` under a hash
of the source; a library already there is loaded without ``nvcc``
(:func:`build_regions`, :func:`nvcc_seconds`). A region whose source does
not build raises ``KernelBuildError`` naming it at its first launch (its
log in ``cudaex.build_failures()``, where :data:`KERNEL` is registered);
nothing runs the plain chain on the card in its place.

Launches: each one counts under the ``region`` entry of
``cudaex.launch_counts()`` (design ``contiguous`` or ``strided``), on
``torch.cuda.current_stream()``; its arguments follow from shapes and
strides, so a CUDA graph captures it (``cudagraphex``). 64-bit indices
where the iteration space or an offset passes 2^31 - 1.

The reference's ``xla_absorb_claimed`` is not ported: a hand-written
kernel cannot run inside a generated one (ROADMAP C).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
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


def _supported(b: BoundSymbol) -> bool:
    """Can :func:`region_source` generate the member ``b`` exactly?"""
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
    raise AssertionError(f"region: no code for {b.sym.name}")


# -- the generated source -----------------------------------------------------

@dataclass
class RegionSpec:
    """What a region's kernel reads and writes: ``loads`` one
    ``(input index, broadcast dims or None)`` for each distinct read of an
    input (a member's broadcast reads its input through its own strides),
    ``source`` the generated CUDA C++, ``entry`` its C entry point (named by
    a hash of the source), ``transcendental`` whether a member's device
    function may differ from the chain's in the last place."""

    loads: list
    source: str
    entry: str
    transcendental: bool


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


# -- build ----------------------------------------------------------------------

_lock = threading.Lock()
_bound: dict[str, object] = {}        # entry -> ctypes function
_failures: dict[str, str] = {}        # entry -> nvcc log
_nvcc_s = 0.0


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


def build_failures() -> dict[str, str]:
    """The generated region kernels that did not build, each with its log."""
    return dict(_failures)


def _library(src: str) -> Path:
    """The library of ``src``, named by a hash of it and the flags."""
    key = hashlib.sha256((" ".join(NVCC_FLAGS) + src).encode()).hexdigest()[:16]
    return cudaex.BUILD_DIR / f"regions-{key}.so"


def _run_nvcc(nvcc: str, src: str) -> tuple[Path, subprocess.Popen]:
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
        self.shape = tuple(outputs[0].shape)
        self.spec = region_source(members, inputs, outputs)
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


# -- the executor ---------------------------------------------------------------

class RegionExecutor(FusionExecutor):
    """Dataflow regions of unclaimed elementwise prims, each one generated
    kernel on the card (the counterpart of ``XLAFusionExecutor``)."""

    def __init__(self, name: str = "region", min_region_size: int = 2):
        super().__init__(name)
        self.min_region_size = min_region_size

    def can_fuse(self, bsym: BoundSymbol) -> bool:
        sym = bsym.sym
        if sym.executor is not None or sym.id in _NOFUSE_IDS:
            return False
        if OpTags.DEVICE_SYNC_OP in sym.tags:
            return False
        if (OpTags.ELEMENTWISE_OP not in sym.tags
                and sym.id not in (PrimIDs.BROADCAST_IN_DIM, PrimIDs.CONVERT_ELEMENT_TYPE)):
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
        group split by output shape. The same program text partitions the
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
            units.extend(_split_by_shape(g) if len(g) > 1 else [g])
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
                                    "shape": list(outputs[0].shape)})
        notes = [b.header for b in members if b.header]
        if notes:
            bsym.header = "\n".join(notes)
        return bsym


def _out_shape(b: BoundSymbol) -> tuple:
    return tuple(b.flat_proxy_outs()[0].shape)


def _split_by_shape(group: list[BoundSymbol]) -> list[list[BoundSymbol]]:
    """One part a members' output shape, in an order that keeps every
    part's inputs produced before it (data crosses parts only into a
    ``broadcast_in_dim``, from a smaller shape to a larger one, so the parts
    form no cycle). A group whose parts would (none is known) stays as its
    members, each alone."""
    parts: dict[tuple, list[BoundSymbol]] = {}
    for b in group:
        parts.setdefault(_out_shape(b), []).append(b)
    if len(parts) == 1:
        return [group]
    keys = list(parts)
    made = {k: set().union(*(produced_vars(b) for b in parts[k])) for k in keys}
    deps = {k: {j for j in keys if j != k and any(consumed_vars(b) & made[j] for b in parts[k])}
            for k in keys}
    order, done = [], set()
    while len(order) < len(keys):
        ready = [k for k in keys if k not in done and deps[k] <= done]
        if not ready:
            return [[b] for b in group]
        order.append(ready[0])
        done.add(ready[0])
    return [parts[k] for k in order]


ex = RegionExecutor()
register_executor(ex, default=True)
