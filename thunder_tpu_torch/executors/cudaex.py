"""Hand-written Hopper kernels of the port: build, binding, wrappers.

The counterpart of ``thunder_tpu/executors/pallasex.py``: one hand-written
kernel for every Pallas kernel there, the ones the serving steps and the
single-device train steps run at both their per-op and planned rungs. The
serving planned rung's ``decode_layer`` and ``attn_subblock`` are one
cooperative kernel (``csrc/decode_layer.cuh``) built as two libraries, with
and without the MLP phases; ``fused_adamw``, ``fused_adamw_slab`` and their
health passes (``fused_adamw_health``, ``fused_adamw_slab_health``: the
numerics guard's non-finite counts and grad norm, computed before the
update it gates) are four entries of one library (``csrc/fused_adamw.cu``). Each kernel is CUDA C++ for
``sm_90a`` in ``thunder_tpu_torch/csrc/``; its source note names the Pallas
function it replaces, its bound on an H100, and what its design does about
that bound.

Build: at first use, :func:`build` runs one ``nvcc`` per ``csrc/*.cu``
source, all started together, into ``thunder_tpu_torch/_build/``. Each
shared library is named by a hash of every ``csrc`` file and the flags, so a
changed source rebuilds and an unchanged one loads from disk. Each library
exports plain C entry points, bound here with ``ctypes``: pointers and the
stream travel as ``c_void_p``, and the entry returns ``cudaGetLastError()``,
which the wrapper turns into an exception.

Inputs: the kernels take float32, bfloat16 and float16. A wrapper makes a
read-only operand dense (:func:`_dense`: contiguous and 16-byte aligned, a
copy only where it is neither), promotes operands of mixed dtypes to the
dtype the reference's decomposition computes in (:func:`promote`; the
norms take a weight dtype of its own instead, which keeps the
decomposition's rounding of the normed row), zero-pads a 16-bit attention
head dim off the multiples of 16 (:func:`sdpa_head_dim`) and
``linear_act``'s K on the tile path (:func:`tile_k`), and slices the
results back. A tensor a kernel works on in place (parameters, moments, KV
pools) is never copied: it must be contiguous and aligned.

Refusals: each wrapper checks what remains (float64, which the reference
never makes; shapes that are not the op's; the in-place rule; a
mixed-dtype fused sub-block, whose decomposition rounds where no kernel
here does) and raises the reason before any launch. :func:`refusal` gives
that reason (None where the kernel takes the arguments) for any kernel by
name, called with its wrapper's arguments: the counterpart of pallasex's
``_*_checker`` functions, except that on the card a refusal is an error,
never a fallback to the plain version. A build that cannot start (no
card, no ``nvcc``) or in which every source fails raises
``runtime.faults.KernelBuildError`` for the whole set: no single kernel is
at fault, and it is fatal. A source that fails while others build stops
only its own kernels: :func:`build` binds every library that compiled and
keeps the ``nvcc`` log of the failed source against its kernels
(:func:`build_failures`), and such a kernel raises a ``KernelBuildError``
naming it (``.kernel``) at its first launch, which the routers' kernel
guard attributes to the kernel's claim, as it does a launch that returns a
CUDA error (``runtime.faults.KernelLaunchError``): the quarantine then
takes the kernel rung below it, where there is one.

Wrappers: outputs are allocated with ``torch.empty``; the kernel runs on
``torch.cuda.current_stream()`` and does not synchronise. Every wrapper adds
one to its kernel's ``launches`` count where it launches, and nowhere else.
A wrapper takes CUDA tensors only: the routing of CPU tensors to the plain
versions lives in :mod:`thunder_tpu_torch.ops`, and so does the routing of a
quarantined kernel (``runtime.quarantine``) to the kernel rung below it.

Designs: ``sdpa_fwd``, ``sdpa_bwd``, ``rms_norm``, ``rms_norm_residual``,
``linear_act``, ``decode_layer`` and ``attn_subblock`` each hold more than
one kernel design, and the wrapper picks one by a fixed rule of shape and
dtype (:func:`sdpa_fwd_design`, :func:`sdpa_bwd_design`,
:func:`rms_norm_design`, :func:`rms_norm_residual_design`,
:func:`linear_act_path`, :func:`decode_design`), passes it to the C entry,
which refuses a design the inputs do not fit, and counts the launch under
it as well (:func:`design_counts`). ``mlp_subblock``, ``mlp_subblock_bwd``
and ``linear_act``'s tile path run on gemm.cuh's mainloops, chosen by dtype
alone (:func:`gemm_design`: the TMA + wgmma one for 16-bit types, the FMA
one for float32), and count their launches by it; ``paged_decode_attention``
counts its one design, ``split`` (the context split across blocks, sized by
:func:`paged_geometry`). ``linear_act``'s decode path and the decode
layer's 16-bit products share one weight stream (``csrc/wstream.cuh``). A
launch never falls back to another design.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from thunder_tpu_torch.runtime.faults import KernelBuildError, KernelLaunchError

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIXTEEN_BIT = (torch.bfloat16, torch.float16)
ACTIVATIONS = {"relu": 0, "silu": 1, "gelu": 2, "gelu_tanh": 3}


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, its C
    entry point, and the count of its launches."""

    name: str
    source: str            # repo-relative path of the .cu file
    replaces: str          # file:line of the Pallas function it replaces
    symbol: str            # exported C entry point
    argtypes: tuple
    launches: int = 0
    designs: dict = field(default_factory=dict)   # launches by design, where it has several
    fn: object = field(default=None, repr=False)
    build_error: str | None = field(default=None, repr=False)   # its source's nvcc log


_ADAMW_ARGS = (_P, _I, _L, _P, _P) + (_F,) * 7 + (_I, _I, _I, _I, _I, _P)
_ADAMW_HEALTH_ARGS = (_P, _I, _L, _P, _P, _P) + (_F,) * 7 + (_I, _I, _I, _I, _I, _P)
# the health pass stands for the reference guard's XLA reductions over the
# update's inputs and outputs (its non-finite counts and grad norm)
_HEALTH_REPLACES = "thunder_tpu/transforms/numerics_guard.py:240"

KERNELS = {k.name: k for k in (
    Kernel("rms_norm", "thunder_tpu_torch/csrc/rms_norm.cu",
           "thunder_tpu/executors/pallasex.py:738", "tt_rms_norm",
           (_P, _P, _P, _L, _I, _F, _I, _I, _I, _I, _P)),
    Kernel("rms_norm_residual", "thunder_tpu_torch/csrc/rms_norm_residual.cu",
           "thunder_tpu/executors/pallasex.py:811", "tt_rms_norm_residual",
           (_P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _I, _I, _P)),
    Kernel("linear_act", "thunder_tpu_torch/csrc/linear_act.cu",
           "thunder_tpu/executors/pallasex.py:896", "tt_linear_act",
           (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    Kernel("paged_decode_attention",
           "thunder_tpu_torch/csrc/paged_decode_attention.cu",
           "thunder_tpu/executors/pallasex.py:1316", "tt_paged_decode_attention",
           (_P,) * 7 + (_I,) * 9 + (_F, _I, _I, _P)),
    Kernel("sdpa_fwd", "thunder_tpu_torch/csrc/sdpa_fwd.cu",
           "thunder_tpu/executors/pallasex.py:214", "tt_sdpa_fwd",
           (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P)),
    Kernel("sdpa_bwd", "thunder_tpu_torch/csrc/sdpa_bwd.cu",
           "thunder_tpu/executors/pallasex.py:537", "tt_sdpa_bwd",
           (_P,) * 10 + (_I, _I, _I, _I, _F, _I, _I, _I, _I, _P)),
    Kernel("ce_fwd", "thunder_tpu_torch/csrc/ce_fwd.cu",
           "thunder_tpu/executors/pallasex.py:686", "tt_ce_fwd",
           (_P, _P, _P, _P, _L, _I, _L, _I, _I, _P)),
    Kernel("fused_adamw", "thunder_tpu_torch/csrc/fused_adamw.cu",
           "thunder_tpu/executors/pallasex.py:1944", "tt_fused_adamw", _ADAMW_ARGS),
    Kernel("fused_adamw_slab", "thunder_tpu_torch/csrc/fused_adamw.cu",
           "thunder_tpu/executors/pallasex.py:1966", "tt_fused_adamw_slab", _ADAMW_ARGS),
    Kernel("fused_adamw_health", "thunder_tpu_torch/csrc/fused_adamw.cu", _HEALTH_REPLACES,
           "tt_fused_adamw_health", _ADAMW_HEALTH_ARGS),
    Kernel("fused_adamw_slab_health", "thunder_tpu_torch/csrc/fused_adamw.cu", _HEALTH_REPLACES,
           "tt_fused_adamw_slab_health", _ADAMW_HEALTH_ARGS),
    Kernel("mlp_subblock", "thunder_tpu_torch/csrc/mlp_subblock.cu",
           "thunder_tpu/executors/pallasex.py:1039", "tt_mlp_subblock",
           (_P,) * 10 + (_I, _I, _I, _I, _F, _I, _I, _P)),
    Kernel("mlp_subblock_bwd", "thunder_tpu_torch/csrc/mlp_subblock_bwd.cu",
           "thunder_tpu/executors/pallasex.py:1161", "tt_mlp_subblock_bwd",
           (_P,) * 20 + (_I, _I, _I, _I, _F, _I, _I, _P)),
    Kernel("decode_layer", "thunder_tpu_torch/csrc/decode_layer.cu",
           "thunder_tpu/executors/pallasex.py:1751", "tt_decode_layer",
           (_P,) * 24 + (_I,) * 12 + (_F, _F, _I, _I, _I, _P)),
    Kernel("attn_subblock", "thunder_tpu_torch/csrc/attn_subblock.cu",
           "thunder_tpu/executors/pallasex.py:1743", "tt_attn_subblock",
           (_P,) * 18 + (_I,) * 10 + (_F, _F, _I, _I, _I, _P)),
)}

_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    """Set every kernel's launch and design counts to 0."""
    for k in KERNELS.values():
        k.launches = 0
        k.designs.clear()


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def design_counts() -> dict[str, dict[str, int]]:
    """Launches by design of the kernels that have several:
    ``{"sdpa_fwd": {"wgmma": 4}, ...}``."""
    return {name: dict(k.designs) for name, k in KERNELS.items() if k.designs}


def count_snapshot() -> dict[str, tuple[int, dict[str, int]]]:
    """Every kernel's launch count and launches by design, to take a
    difference of later (:func:`count_delta`)."""
    return {name: (k.launches, dict(k.designs)) for name, k in KERNELS.items()}


def count_delta(before: dict) -> dict[str, tuple[int, dict[str, int]]]:
    """The launches (and launches by design) counted since ``before``, a
    :func:`count_snapshot`; kernels with none left out."""
    out = {}
    for name, k in KERNELS.items():
        n0, d0 = before.get(name, (0, {}))
        designs = {d: c - d0.get(d, 0) for d, c in k.designs.items() if c != d0.get(d, 0)}
        if k.launches != n0 or designs:
            out[name] = (k.launches - n0, designs)
    return out


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times a :func:`count_delta` to the counters. A CUDA
    graph counts its captured launches so: once taken off after the
    capture (the host counted them while the card ran nothing), and once
    added on every replay (the card runs them then)."""
    for name, (n, designs) in delta.items():
        k = KERNELS[name]
        k.launches += sign * n
        for d, c in designs.items():
            k.designs[d] = k.designs.get(d, 0) + sign * c


# the host buffers a capture's launches read from while its graph lives
# (set by :func:`keep_host_buffers`); None outside a capture
_capture_keep: list | None = None


@contextlib.contextmanager
def keep_host_buffers(keep: list):
    """While a CUDA graph is captured, every host buffer a launch copies
    from (``fused_adamw``'s pointer table) is appended to ``keep``: a
    replay reads the same host address again, so the buffer must live as
    long as the graph."""
    global _capture_keep
    prev, _capture_keep = _capture_keep, keep
    try:
        yield keep
    finally:
        _capture_keep = prev


# sdpa_fwd's designs, by the code the C entry takes (csrc/sdpa_fwd.cu)
SDPA_FWD_DESIGNS = ("fma", "mma", "wgmma")
# head dims of the TMA + wgmma design: llama3-8b's 128, and 64
SDPA_WGMMA_HEAD_DIMS = (64, 128)


def sdpa_head_dim(dtype: torch.dtype, hd: int) -> int:
    """The head dim the attention kernels run at for inputs of ``dtype`` and
    head dim ``hd``: the 16-bit kernels' tensor-core products take multiples
    of 16, so a 16-bit head dim off them is zero-padded to the next one
    (zero columns add nothing to q k^T, and the padded columns of the output
    and the gradients are sliced off); float32 runs at ``hd``."""
    return -(-hd // 16) * 16 if dtype in _SIXTEEN_BIT else hd


def sdpa_fwd_design(dtype: torch.dtype, hd: int) -> str:
    """The ``sdpa_fwd`` design that inputs of ``dtype`` and head dim ``hd``
    take: ``"wgmma"`` for bf16 or fp16 at hd 64 or 128, ``"mma"`` (mma.sync)
    for bf16 or fp16 at other head dims (padded to a multiple of 16),
    ``"fma"`` for float32."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if sdpa_head_dim(dtype, hd) in SDPA_WGMMA_HEAD_DIMS else "mma"


# sdpa_bwd's designs and the rule that picks one are the forward's
# (csrc/sdpa_bwd.cu takes the same codes): "wgmma" for bf16 or fp16 at hd 64
# or 128, "mma" for the other 16-bit head dims, "fma" for float32
SDPA_BWD_DESIGNS = SDPA_FWD_DESIGNS
sdpa_bwd_design = sdpa_fwd_design
# the rows sdpa_bwd's scratch pads T to (the wgmma design's lse and delta)
SDPA_BWD_ROW_PAD = 128


# rms_norm's designs, by the code the C entry takes (csrc/rms_norm.cu)
RMS_NORM_DESIGNS = ("scalar", "vector")
# the longest row the vector design holds in registers, in 16-byte accesses
RMS_NORM_MAX_VECTORS = 4096


def rms_norm_design(dtype: torch.dtype, D: int) -> str:
    """The ``rms_norm`` design that rows of ``D`` values of ``dtype`` take:
    ``"vector"`` (one read of the row into registers in 16-byte accesses)
    where every row starts on 16 bytes (D a multiple of 16 bytes' worth of
    values) and the row fits the registers (at most 4096 accesses, 8 per
    thread); ``"scalar"`` (a block per row, two sweeps) otherwise."""
    per16 = 128 // torch.finfo(dtype).bits
    return "vector" if D % per16 == 0 and D // per16 <= RMS_NORM_MAX_VECTORS else "scalar"


def rms_norm_residual_design(dtype: torch.dtype, D: int) -> str:
    """The ``rms_norm_residual`` design that rows of ``D`` values of ``dtype``
    take: ``rms_norm``'s rule (:func:`rms_norm_design`), since both designs
    hold one row of the same values in registers (``csrc/rms_row.cuh``);
    ``"vector"`` reads r and x once and writes h and y once, ``"scalar"``
    sweeps the row twice."""
    return rms_norm_design(dtype, D)


# linear_act's paths, by the code the C entry takes (csrc/linear_act.cu)
LINEAR_ACT_PATHS = ("tile", "stream")
LINEAR_ACT_STREAM_MAX_ROWS = 16   # two n-tiles of 8 activation rows


def linear_act_path(dtype: torch.dtype, M: int) -> str:
    """The ``linear_act`` path that ``M`` rows of ``dtype`` take:
    ``"stream"`` (the weight-streaming decode kernel) for bf16 or fp16 at
    M <= 16, ``"tile"`` (gemm.cuh's mainloops) otherwise."""
    return "stream" if dtype in _SIXTEEN_BIT and M <= LINEAR_ACT_STREAM_MAX_ROWS else "tile"


def gemm_design(dtype: torch.dtype) -> str:
    """The mainloop of ``mlp_subblock``, ``mlp_subblock_bwd`` and
    ``linear_act``'s tile path for ``dtype`` (gemm.cuh): ``"wgmma"`` (TMA +
    wgmma) for bf16 and fp16, ``"fma"`` (cp.async + FMA) for float32, where
    wgmma in tf32 would change the numerics."""
    return "wgmma" if dtype in _SIXTEEN_BIT else "fma"


def linear_act_design(dtype: torch.dtype, M: int) -> str:
    """The design a ``linear_act`` launch is counted under: ``"stream"``, or
    the tile path's mainloop (:func:`gemm_design`)."""
    path = linear_act_path(dtype, M)
    return path if path == "stream" else gemm_design(dtype)


def tile_k(dtype: torch.dtype, K: int) -> int:
    """The depth the tile path runs at: ``K`` rounded up to 16 bytes' worth
    of elements (TMA and the 16-byte copies need rows on that alignment); A
    and W are zero-padded along K to it where it differs."""
    per16 = 128 // torch.finfo(dtype).bits
    return -(-K // per16) * per16


def pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` zero-padded along its last dim to ``n`` (``t`` itself where it
    is that wide already)."""
    if t.shape[-1] == n:
        return t
    out = t.new_zeros(t.shape[:-1] + (n,))
    out[..., :t.shape[-1]] = t
    return out


def promoted_dtype(*tensors) -> torch.dtype:
    """The common dtype of the tensors (None entries skipped), the dtype the
    reference's decomposition computes a mixed-dtype op in
    (``torch.promote_types``, as JAX promotes)."""
    dts = [t.dtype for t in tensors if t is not None]
    dt = dts[0]
    for d in dts[1:]:
        dt = torch.promote_types(dt, d)
    return dt


def promote(*tensors):
    """The tensors (None entries kept) cast to :func:`promoted_dtype`."""
    dt = promoted_dtype(*tensors)
    return tuple(t if t is None or t.dtype == dt else t.to(dt) for t in tensors)


def _dense(t):
    """A read-only operand as the kernels read it: contiguous and 16-byte
    aligned (a copy only where ``t`` is neither). A tensor a kernel writes
    in place is never copied: its wrapper refuses it instead."""
    if t is None:
        return None
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "thunder_tpu_torch are built from csrc/ at first use")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, float]:
    """Compile (or load from ``_build/``) every kernel and bind its entry
    point. Returns the seconds each source took to compile (0.0 for a
    library found already built). Raises when there is no CUDA card, when
    ``nvcc`` is missing, or when no source compiles. A source that fails
    while others compile raises nothing here: its kernels keep its log
    (:func:`build_failures`) and raise at their first launch."""
    if not torch.cuda.is_available():
        raise KernelBuildError("thunder_tpu_torch kernels need a CUDA device; "
                           "none is available")
    with _build_lock:
        if all(k.fn is not None or k.build_error is not None for k in KERNELS.values()):
            return {Path(k.source).stem: 0.0 for k in KERNELS.values()}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        key = _source_key()
        # one library per source: entries of one .cu file share it
        libs = {Path(k.source).stem: BUILD_DIR / f"{Path(k.source).stem}-{key}.so"
                for k in KERNELS.values()}
        todo = [stem for stem, lib in libs.items() if not lib.exists()]
        procs, t0 = {}, time.perf_counter()
        nvcc = _nvcc() if todo else ""
        for stem in todo:
            tmp = libs[stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        seconds = {stem: 0.0 for stem in libs}
        errors = {}
        for stem, (tmp, p) in procs.items():
            log, _ = p.communicate()
            seconds[stem] = time.perf_counter() - t0
            if p.returncode != 0:
                errors[stem] = f"{stem}: nvcc exited {p.returncode}\n{log}"
            else:
                os.replace(tmp, libs[stem])
        if errors and len(errors) == len(libs):
            # the toolchain fails on every source: no kernel is at fault
            raise KernelBuildError("kernel build failed:\n" + "\n".join(errors.values()))
        for k in KERNELS.values():
            stem = Path(k.source).stem
            if stem in errors:
                k.build_error = errors[stem]
                continue
            try:
                fn = getattr(ctypes.CDLL(str(libs[stem])), k.symbol)
            except (OSError, AttributeError) as e:
                k.build_error = f"{k.name}: cannot bind {k.symbol}: {e}"
                continue
            fn.argtypes = list(k.argtypes)
            fn.restype = ctypes.c_int
            k.fn = fn
        return seconds


def build_failures() -> dict[str, str]:
    """The kernels whose source did not build (or whose entry point did not
    bind), each with its log; empty when every kernel is bound."""
    return {name: k.build_error for name, k in KERNELS.items() if k.build_error is not None}


def _launch(name: str, *args, design: str | None = None) -> None:
    k = KERNELS[name]
    if k.fn is None:
        build()
        if k.fn is None:
            raise KernelBuildError(f"{name}: its source {k.source} did not build, so this "
                                   f"kernel cannot launch:\n{k.build_error}", kernel=name)
    rc = k.fn(*args)
    if rc != 0:
        raise KernelLaunchError(f"{k.name}: kernel launch failed with CUDA error {rc}")
    k.launches += 1
    if design is not None:
        k.designs[design] = k.designs.get(design, 0) + 1


# ---------------------------------------------------------------------------
# what each kernel takes: a refusal function per wrapper returns why the
# kernel does not take its arguments (None when it does), and the wrapper
# raises the reason
# ---------------------------------------------------------------------------

def _tensors_refusal(name: str, *tensors, dtype: torch.dtype,
                     in_place: bool = False) -> str | None:
    """Why the tensors given (None entries skipped) are not all on one
    device, of ``dtype``, and (``in_place``: tensors the kernel writes in
    place, which a copy would lose the update of) contiguous and 16-byte
    aligned. Read-only operands need neither: their wrapper passes them
    through :func:`_dense`."""
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            return f"{name}: tensors on {dev} and {t.device}"
        if t.dtype != dtype:
            return f"{name}: dtype {t.dtype} where {dtype} is required"
        if in_place and not t.is_contiguous():
            return (f"{name}: tensor of shape {tuple(t.shape)} is not contiguous (the kernel "
                    f"works on it in place: a copy would lose its update or copy a whole pool)")
    if in_place and _unaligned(*tensors):
        return f"{name}: tensors the kernel writes in place must be 16-byte aligned"
    return None


def _dtype_refusal(name: str, t: torch.Tensor) -> str | None:
    if t.dtype not in _DTYPE_CODES:
        return (f"{name}: dtype {t.dtype} not supported (float32, bfloat16 or float16; the "
                f"reference makes no other floating arrays)")
    return None


def _floats_refusal(name: str, x: torch.Tensor, *others, in_place: bool = False) -> str | None:
    """Why ``x`` is not float32, bfloat16 or float16, or ``x`` and ``others``
    do not share its dtype and device (and, ``in_place``, contiguity)."""
    return _dtype_refusal(name, x) or _tensors_refusal(name, x, *others, dtype=x.dtype,
                                                       in_place=in_place)


def _unaligned(*tensors) -> bool:
    return any(t.data_ptr() % 16 for t in tensors if t is not None)


def _refuse(reason: str | None) -> None:
    if reason:
        raise ValueError(reason)


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rms_refusal(name: str, x, weight, *others) -> str | None:
    """x (and ``others`` of its dtype) against a weight of any float dtype:
    the kernels take the weight's dtype as a type of their own."""
    if x.ndim == 0:
        return f"{name}: a scalar has no rows"
    reason = _floats_refusal(name, x, *others)
    if not reason and weight is not None:
        reason = _dtype_refusal(name, weight)
        if not reason and weight.device != x.device:
            reason = f"{name}: weight on {weight.device}, x on {x.device}"
    D = x.shape[-1]
    if not reason and weight is not None and tuple(weight.shape) != (D,):
        reason = f"{name}: weight {tuple(weight.shape)} for rows of {D}"
    return reason


def _norm_out_dtype(x: torch.Tensor, weight) -> torch.dtype:
    """The norms' output dtype: x's, or the promoted dtype where the weight's
    differs (the reference multiplies the x-dtype row by the weight)."""
    return x.dtype if weight is None else torch.promote_types(x.dtype, weight.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, eps: float) -> torch.Tensor:
    """``rms_norm`` over the last dim of a ``(..., D)`` tensor; the weight
    may be of another float dtype, and the output is then float32 (the
    promoted dtype), the normalised row still rounded to x's dtype first."""
    name = "rms_norm"
    _refuse(_rms_refusal(name, x, weight))
    _require_cuda(name, x)
    x, weight = _dense(x), _dense(weight)
    D = x.shape[-1]
    out = torch.empty(x.shape, dtype=_norm_out_dtype(x, weight), device=x.device)
    design = rms_norm_design(x.dtype, D)
    _launch(name, x.data_ptr(), None if weight is None else weight.data_ptr(),
            out.data_ptr(), x.numel() // max(D, 1), D, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[(weight if weight is not None else x).dtype],
            RMS_NORM_DESIGNS.index(design), x.device.index, _stream(x), design=design)
    return out


def _rms_residual_refusal(residual, x, weight) -> str | None:
    name = "rms_norm_residual"
    if residual.shape != x.shape:
        return f"{name}: residual {tuple(residual.shape)} != input {tuple(x.shape)}"
    reason = _dtype_refusal(name, residual) or _dtype_refusal(name, x)
    if reason:
        return reason
    if residual.device != x.device:
        return f"{name}: residual on {residual.device}, x on {x.device}"
    return _rms_refusal(name, x, weight)


def rms_norm_residual(residual: torch.Tensor, x: torch.Tensor,
                      weight: torch.Tensor | None, eps: float):
    """``h = residual + x``; returns ``(h, rms_norm(h, weight))``. A residual
    and x of two dtypes are promoted to one first, as the reference's add
    promotes them."""
    name = "rms_norm_residual"
    _refuse(_rms_residual_refusal(residual, x, weight))
    _require_cuda(name, x)
    residual, x = (_dense(t) for t in promote(residual, x))
    weight = _dense(weight)
    D = x.shape[-1]
    h = torch.empty_like(x)
    out = torch.empty(x.shape, dtype=_norm_out_dtype(x, weight), device=x.device)
    design = rms_norm_residual_design(x.dtype, D)
    _launch(name, residual.data_ptr(), x.data_ptr(),
            None if weight is None else weight.data_ptr(), h.data_ptr(),
            out.data_ptr(), x.numel() // max(D, 1), D, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[(weight if weight is not None else x).dtype],
            RMS_NORM_DESIGNS.index(design), x.device.index, _stream(x), design=design)
    return h, out


def _linear_act_refusal(a, w, bias, act) -> str | None:
    name = "linear_act"
    if act not in ACTIVATIONS:
        return f"linear_act: unknown activation {act!r}; known: {sorted(ACTIVATIONS)}"
    reason = (_dtype_refusal(name, a) or _dtype_refusal(name, w)
              or (bias is not None and _dtype_refusal(name, bias)) or None)
    if reason:
        return reason
    if any(t is not None and t.device != a.device for t in (w, bias)):
        return f"{name}: tensors on {a.device} and {w.device}"
    if a.ndim == 0 or w.ndim != 2 or a.shape[-1] != w.shape[1]:
        return f"linear_act: a {tuple(a.shape)} and w {tuple(w.shape)} do not share K"
    N, K = w.shape
    if bias is not None and tuple(bias.shape) != (N,):
        return f"linear_act: bias {tuple(bias.shape)} for {N} outputs"
    return None


def linear_act(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               act: str = "relu") -> torch.Tensor:
    """``act(a @ w.T + bias)`` with f32 accumulation; ``a`` is ``(..., K)``,
    ``w`` is ``(N, K)``; the result is ``(..., N)`` in the operands' dtype,
    the promoted one where they differ (the reference's linear promotes).
    Any K: the tile path runs at :func:`tile_k`, A and W zero-padded along K
    where it differs (a copy paid only at such K); the stream path reads
    the rows as they are."""
    name = "linear_act"
    _refuse(_linear_act_refusal(a, w, bias, act))
    _require_cuda(name, a)
    a, w, bias = (_dense(t) for t in promote(a, w, bias))
    N, K = w.shape
    M = a.numel() // max(K, 1)
    path = linear_act_path(a.dtype, M)
    out = torch.empty(a.shape[:-1] + (N,), dtype=a.dtype, device=a.device)
    if path == "tile" and tile_k(a.dtype, K) != K:
        K = tile_k(a.dtype, K)
        a, w = pad_last(a, K), pad_last(w, K)
    _launch(name, a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), M, N, K, ACTIVATIONS[act], _DTYPE_CODES[a.dtype],
            LINEAR_ACT_PATHS.index(path), a.device.index, _stream(a),
            design=linear_act_design(a.dtype, M))
    return out


# a block's shared-memory ceiling on an H100 (227 KB), in bytes
_SMEM_MAX = 232448


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


# geometry of csrc/paged_decode_attention.cu's split-context design: 256
# threads a block, the PV sums split over at most 8 key parts, and the chunk
# sized so that a block's shared memory stays within 72 KB (three blocks an
# SM) where it can
PAGED_THREADS = 256
PAGED_CHUNK_SMEM = 72 * 1024
PAGED_MAX_KEYS = 256


def _paged_smem(G: int, hd: int, keys: int, esize: int, threads: int = PAGED_THREADS) -> int:
    """Shared memory of one chunk block, in bytes (``chunk::smem_bytes`` in
    csrc/attn_chunk.cuh): the K chunk (rows padded) or the PV partial sums,
    whichever is larger, the V chunk, the float32 query rows and scores, the
    chunk's block-table entries."""
    pairs = (hd + 1) // 2
    parts = max(1, min(8, threads // pairs))
    per16 = 16 // esize
    k_ld = hd + per16 if hd % per16 == 0 else hd + 1   # K rows padded (k_ld in the source)
    k = _align16(keys * k_ld * esize)
    return (max(k, _align16(parts * pairs * 32)) + _align16(keys * hd * esize)
            + _align16(G * hd * 4) + _align16(G * keys * 4) + _align16((keys + 1) * 4))


@functools.lru_cache(maxsize=None)
def paged_chunk_keys(G: int, hd: int, esize: int) -> int:
    """Keys per chunk of the split-context paged attention: the largest power
    of two from 4 to 256 whose block fits in :data:`PAGED_CHUNK_SMEM`, else 4
    (0 where even 4 keys exceed a block's shared memory)."""
    keys = PAGED_MAX_KEYS
    while keys > 4 and _paged_smem(G, hd, keys, esize) > PAGED_CHUNK_SMEM:
        keys //= 2
    return keys if _paged_smem(G, hd, keys, esize) <= _SMEM_MAX else 0


def paged_geometry(B: int, H: int, KV: int, hd: int, ps: int, npg: int,
                   dtype: torch.dtype) -> tuple[int, int, tuple]:
    """``(keys, n_chunks, workspace_shape)`` of one split-context paged
    attention call: keys per chunk (:func:`paged_chunk_keys`), the chunks
    that cover the block table's ``npg * ps`` keys (the grid is sized from
    them: ``lengths`` stay on the card), and the float32 workspace of every
    chunk's (m, l, acc) rows, ``(B, KV, n_chunks, H // KV, 2 + hd)``."""
    G = H // KV
    keys = paged_chunk_keys(G, hd, torch.finfo(dtype).bits // 8)
    n = -(-(npg * ps) // keys) if keys else 0
    return keys, n, (B, KV, n, G, 2 + hd)


def _paged_refusal(q, k_pages, v_pages, block_tables, lengths) -> str | None:
    name = "paged_decode_attention"
    reason = (_floats_refusal(name, q) or _floats_refusal(name, k_pages, v_pages, in_place=True)
              or (q.dtype != k_pages.dtype and f"{name}: q {q.dtype}, pools {k_pages.dtype}")
              or _tensors_refusal(name, block_tables, lengths, dtype=torch.int32))
    if reason:
        return reason
    if block_tables.device != q.device:
        return f"{name}: block tables on {block_tables.device}, q on {q.device}"
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        return (f"paged_decode_attention: q {tuple(q.shape)} must be (B, H, 1, hd) and pools "
                f"(KV, P, ps, hd), got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    B, H, T, hd = q.shape
    KV, P, ps, hd2 = k_pages.shape
    if T != 1:
        return f"paged_decode_attention kernel is decode-only (T == 1); got T={T}"
    if hd2 != hd or H % KV:
        return (f"paged_decode_attention: head_dim {hd} vs pools {hd2}, {H} heads over {KV} "
                f"kv heads")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or tuple(lengths.shape) != (B,):
        return (f"paged_decode_attention: block_tables {tuple(block_tables.shape)} / lengths "
                f"{tuple(lengths.shape)} do not match batch {B}")
    # the split design holds no per-thread accumulators, so the parent's cap
    # of G * hd <= 2048 is gone: only a 4-key chunk that outgrows a block's
    # shared memory is refused
    if not paged_chunk_keys(H // KV, hd, q.element_size()):
        return (f"paged_decode_attention: {H // KV} grouped rows of {hd} do not fit a block's "
                f"shared memory even at 4 keys a chunk")
    return None


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """T == 1 ragged attention: ``q`` (B, H, 1, hd) against the pools
    (KV, P, ps, hd) through ``block_tables`` (B, npg) int32 up to
    ``lengths`` (B,) int32. Returns (B, H, 1, hd) in ``q.dtype``. The block
    tables are trusted: every entry must be a valid page index (the
    allocator keeps unused entries at the reserved page 0). Two launches:
    the chunks of every (request, kv head) context (:func:`paged_geometry`)
    into a float32 workspace, then their merge in chunk order."""
    name = "paged_decode_attention"
    _refuse(_paged_refusal(q, k_pages, v_pages, block_tables, lengths))
    _require_cuda(name, q)
    q, block_tables, lengths = _dense(q), _dense(block_tables), _dense(lengths)
    B, H, _, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    npg = block_tables.shape[1]
    keys, nch, ws_shape = paged_geometry(B, H, KV, hd, ps, npg, q.dtype)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    part = torch.empty(ws_shape, dtype=torch.float32, device=q.device)
    _launch(name, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
            B, H, KV, P, ps, hd, npg, keys, nch, scale,
            _DTYPE_CODES[q.dtype], q.device.index, _stream(q), design="split")
    return out


# the largest head dim of the attention kernels (after the 16-bit padding)
ATTN_MAX_HEAD_DIM = 256


def _attn_refusal(name: str, q, k, v, *others) -> str | None:
    """Why q (..., T, hd) and k, v (..., S, hd) (and ``others`` of q's
    dtype) are not what the attention kernels take."""
    reason = _floats_refusal(name, q, k, v, *others)
    if reason:
        return reason
    if q.ndim < 3 or k.shape != v.shape or q.shape[:-2] != k.shape[:-2] \
            or q.shape[-1] != k.shape[-1]:
        return (f"{name}: q {tuple(q.shape)} and k/v {tuple(k.shape)} / {tuple(v.shape)} must be "
                f"(..., T, hd) and (..., S, hd) with the same leading dims")
    hd = q.shape[-1]
    if not 0 < sdpa_head_dim(q.dtype, hd) <= ATTN_MAX_HEAD_DIM:
        return f"{name}: head dim {hd} above the kernels' {ATTN_MAX_HEAD_DIM}"
    if k.shape[-2] == 0:
        return f"{name}: no keys (S = 0)"
    return None


def _attn_dims(q: torch.Tensor, k: torch.Tensor):
    """(batch*heads, T, S, hd) of q (..., T, hd) against k (..., S, hd)."""
    T, hd = q.shape[-2], q.shape[-1]
    return q.numel() // max(T * hd, 1), T, k.shape[-2], hd


def _unpad(t: torch.Tensor, hd: int) -> torch.Tensor:
    return t if t.shape[-1] == hd else t[..., :hd].contiguous()


def sdpa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, is_causal: bool = False,
             scale: float | None = None):
    """Flash-attention forward: ``(out, lse)``; ``out`` in ``q.dtype``, ``lse``
    (..., T) float32. Causal masking is top-left aligned (row >= col). A
    16-bit head dim off the multiples of 16 runs zero-padded
    (:func:`sdpa_head_dim`) at the true head dim's scale."""
    name = "sdpa_fwd"
    _refuse(_attn_refusal(name, q, k, v))
    _require_cuda(name, q)
    BH, T, S, hd = _attn_dims(q, k)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    hdp = sdpa_head_dim(q.dtype, hd)
    q, k, v = (_dense(pad_last(t, hdp)) for t in (q, k, v))
    design = sdpa_fwd_design(q.dtype, hdp)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            BH, T, S, hdp, scale, int(bool(is_causal)), _DTYPE_CODES[q.dtype],
            SDPA_FWD_DESIGNS.index(design), q.device.index, _stream(q), design=design)
    return _unpad(out, hd), lse


def _sdpa_bwd_refusal(g, q, k, v, out, lse) -> str | None:
    name = "sdpa_bwd"
    reason = (_attn_refusal(name, q, k, v, g, out)
              or _tensors_refusal(name, lse, dtype=torch.float32))
    if reason:
        return reason
    if g.shape != q.shape or out.shape != q.shape or lse.shape != q.shape[:-1]:
        return (f"{name}: g {tuple(g.shape)}, out {tuple(out.shape)} and lse "
                f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if lse.device != q.device:
        return f"{name}: lse on {lse.device}, q on {q.device}"
    return None


def sdpa_bwd(g: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             out: torch.Tensor, lse: torch.Tensor, is_causal: bool = False,
             scale: float | None = None):
    """Flash-attention backward: ``(dq, dk, dv)`` from the output gradient
    ``g`` and the forward's ``(out, lse)``. One call launches three CUDA
    kernels (delta, dK/dV, dQ) and counts as one launch, under its design
    (:func:`sdpa_bwd_design`). A 16-bit head dim off the multiples of 16
    runs zero-padded, as :func:`sdpa_fwd` does."""
    name = "sdpa_bwd"
    _refuse(_sdpa_bwd_refusal(g, q, k, v, out, lse))
    _require_cuda(name, q)
    BH, T, S, hd = _attn_dims(q, k)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    hdp = sdpa_head_dim(q.dtype, hd)
    g, q, k, v, out = (_dense(pad_last(t, hdp)) for t in (g, q, k, v, out))
    lse = _dense(lse)
    design = sdpa_bwd_design(q.dtype, hdp)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # delta (and the wgmma design's lse * log2 e) per row, rows padded to 128
    delta = torch.empty(2 * BH * -(-T // SDPA_BWD_ROW_PAD) * SDPA_BWD_ROW_PAD,
                        dtype=torch.float32, device=q.device)
    _launch(name, g.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            BH, T, S, hdp, scale, int(bool(is_causal)), _DTYPE_CODES[q.dtype],
            SDPA_BWD_DESIGNS.index(design), q.device.index, _stream(q), design=design)
    return _unpad(dq, hd), _unpad(dk, hd), _unpad(dv, hd)


def _ce_refusal(logits, target) -> str | None:
    name = "ce_fwd"
    reason = (_floats_refusal(name, logits)
              or _tensors_refusal(name, target, dtype=torch.int64))
    if reason:
        return reason
    if logits.ndim != 2 or tuple(target.shape) != (logits.shape[0],):
        return (f"{name}: logits {tuple(logits.shape)} must be (N, V) and target "
                f"{tuple(target.shape)} (N,)")
    if target.device != logits.device:
        return f"{name}: target on {target.device}, logits on {logits.device}"
    return None


def ce_fwd(logits: torch.Tensor, target: torch.Tensor, ignore_index: int = -100):
    """Per-row ``(nll, lse)`` float32 of ``logits`` (N, V) against ``target``
    (N,) int64; rows whose target is ``ignore_index`` get nll 0."""
    name = "ce_fwd"
    _refuse(_ce_refusal(logits, target))
    _require_cuda(name, logits)
    logits, target = _dense(logits), _dense(target)
    N, V = logits.shape
    nll = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty(N, dtype=torch.float32, device=logits.device)
    _launch(name, logits.data_ptr(), target.data_ptr(), nll.data_ptr(), lse.data_ptr(), N, V,
            int(ignore_index), _DTYPE_CODES[logits.dtype], logits.device.index,
            _stream(logits))
    return nll, lse


ADAMW_CHUNK = 4096   # elements per block: CHUNK in csrc/fused_adamw.cu

# the slab layout of the reference (thunder_tpu/ops/optim.py:32-33): the
# last dim of every slab and its rows' padding block
SLAB_LANE = 128
SLAB_ROW_BLOCK = 512


def slab_geometry(total_elems: int) -> tuple[int, int]:
    """``(rows_padded, row_block)`` of the ``(rows, 128)`` slab holding
    ``total_elems`` flattened elements (zero-padded tail)."""
    rows = max(-(-total_elems // SLAB_LANE), 1)
    bn = min(SLAB_ROW_BLOCK, -(-rows // 8) * 8)
    rows_pad = -(-rows // bn) * bn
    return rows_pad, bn


def _adamw_group_refusal(name, params, grads, bc, *groups) -> str | None:
    """Why params (one float dtype, updated in place), grads (one float
    dtype of their own, only read), each further group (moments: one float
    dtype each, updated in place) and ``bc`` (float32, shape (2,)) are not
    tensors on one device that the kernel takes."""
    reason = (_floats_refusal(name, params[0], *params, in_place=True)
              or _floats_refusal(name, grads[0], *grads))
    for group in groups:
        reason = reason or _floats_refusal(name, group[0], *group, in_place=True)
    reason = reason or _tensors_refusal(name, bc, dtype=torch.float32)
    if reason:
        return reason
    dev = params[0].device
    if (any(g[0].device != dev for g in (grads, *groups)) or bc.device != dev
            or tuple(bc.shape) != (2,)):
        return f"{name}: every tensor on {dev}, bc of shape (2,)"
    return None


def _adamw_refusal(params, grads, ms, vs, bc) -> str | None:
    name = "fused_adamw"
    if not params or not len(params) == len(grads) == len(ms) == len(vs):
        return (f"{name}: bucket lengths {len(params)}, {len(grads)}, {len(ms)}, {len(vs)} must "
                f"be equal and non-zero")
    reason = _adamw_group_refusal(name, params, grads, bc, ms, vs)
    if reason:
        return reason
    for quad in zip(params, grads, ms, vs):
        if any(t.shape != quad[0].shape for t in quad):
            return f"{name}: p/g/m/v shapes {[tuple(t.shape) for t in quad]} differ"
    return None


def _adamw_launch(name, rows, n_chunks, dev, bc, extra, p_dtype, g_dtype, m_dtype, v_dtype,
                  hyper) -> None:
    """Copy the table of ``rows`` (p, g, m, v pointers, length, first
    chunk) to the card (non-blocking, from pinned memory) and launch.
    ``extra``: the health word's pointer or 0 (the updates), or the
    workspace's and the accumulator's (the health passes)."""
    host = torch.tensor(rows or [(0,) * 6], dtype=torch.int64).pin_memory()
    table = host.to(dev, non_blocking=True)
    if _capture_keep is not None:
        _capture_keep.append(host)   # a replay copies from it again
    lr, beta1, beta2 = hyper["lr"], hyper["beta1"], hyper["beta2"]
    _launch(name, table.data_ptr(), len(rows), n_chunks, bc.data_ptr(), *extra, float(lr),
            float(beta1), float(beta2), float(1.0 - beta1), float(1.0 - beta2),
            float(hyper["eps"]), float(hyper["weight_decay"]), _DTYPE_CODES[p_dtype],
            _DTYPE_CODES[g_dtype], _DTYPE_CODES[m_dtype], _DTYPE_CODES[v_dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)


def _adamw_rows(params, grads, ms, vs):
    """The per-step table: each tensor's own moments."""
    rows, n_chunks = [], 0
    for p, g, m, v in zip(params, grads, ms, vs):
        if p.numel():
            rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                         n_chunks))
            n_chunks += -(-p.numel() // ADAMW_CHUNK)
    return rows, n_chunks


def _adamw_slab_rows(params, grads, m_slab, v_slab, sizes):
    """The slab table: m and v point into the slabs at each parameter's
    element offset (64-bit)."""
    m0, v0 = m_slab.data_ptr(), v_slab.data_ptr()
    me, ve = m_slab.element_size(), v_slab.element_size()
    rows, n_chunks, off = [], 0, 0
    for p, g, n in zip(params, grads, sizes):
        if n:
            rows.append((p.data_ptr(), g.data_ptr(), m0 + off * me, v0 + off * ve, n, n_chunks))
            n_chunks += -(-n // ADAMW_CHUNK)
        off += n
    return rows, n_chunks


HEALTH_SIZE = 5   # the health word (runtime/sentinel.py HEALTH_SIZE)


def _health_refusal(name: str, health, like: torch.Tensor) -> str | None:
    if health is None:
        return None
    if (health.dtype != torch.float32 or tuple(health.shape) != (HEALTH_SIZE,)
            or health.device != like.device):
        return (f"{name}: the health word must be float32 of shape ({HEALTH_SIZE},) on "
                f"{like.device}, got {health.dtype} {tuple(health.shape)} on {health.device}")
    return None


def _acc_refusal(name: str, acc, like: torch.Tensor) -> str | None:
    if acc.dtype != torch.float64 or tuple(acc.shape) != (3,) or acc.device != like.device:
        return (f"{name}: the accumulator must be float64 of shape (3,) on {like.device}, got "
                f"{acc.dtype} {tuple(acc.shape)} on {acc.device}")
    return None


def _health_args(n_chunks, acc):
    """The health pass's workspace (3 float32 per chunk) and accumulator
    pointers."""
    ws = torch.empty(max(3 * n_chunks, 1), dtype=torch.float32, device=acc.device)
    return ws, (ws.data_ptr(), acc.data_ptr())


def fused_adamw(params, grads, ms, vs, bc: torch.Tensor, *, lr: float, beta1: float,
                beta2: float, eps: float, weight_decay: float,
                health: torch.Tensor | None = None) -> None:
    """AdamW over one bucket in ONE launch, updating ``params``, ``ms`` and
    ``vs`` in place. ``bc`` is the float32 device tensor ``[1 - beta1**step,
    1 - beta2**step]``. Params and grads share one dtype; m and v may each be
    float32, bfloat16 or float16, and so may the grads, apart from the
    params' dtype. ``health``, the numerics guard's float32 health word,
    gates the update: the kernel stores nothing unless its non-finite total
    is 0.

    The kernel reads a device table of the tensors' pointers, sizes and
    first chunks, built on the host and copied to the card on every call."""
    name = "fused_adamw"
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    _refuse(_adamw_refusal(params, grads, ms, vs, bc)
            or _health_refusal(name, health, params[0]))
    _require_cuda(name, params[0])
    grads = [_dense(g) for g in grads]
    rows, n_chunks = _adamw_rows(params, grads, ms, vs)
    _adamw_launch(name, rows, n_chunks, params[0].device, bc,
                  (0 if health is None else health.data_ptr(),), params[0].dtype,
                  grads[0].dtype, ms[0].dtype, vs[0].dtype, dict(
                      lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay))


def fused_adamw_health(params, grads, ms, vs, bc: torch.Tensor, acc: torch.Tensor, *,
                       lr: float, beta1: float, beta2: float, eps: float,
                       weight_decay: float) -> None:
    """The health pass of :func:`fused_adamw` over the same bucket: the
    update's arithmetic without a store, adding the bucket's count of
    non-finite grads, its float32 sum of g*g, and its count of non-finite
    p', m', v' (as the update would store them) into ``acc``, a float64
    device tensor of shape (3,). One launch and a one-block fold; no float
    atomics, so two calls give the same bits."""
    name = "fused_adamw_health"
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    _refuse(_adamw_refusal(params, grads, ms, vs, bc) or _acc_refusal(name, acc, params[0]))
    _require_cuda(name, params[0])
    grads = [_dense(g) for g in grads]
    rows, n_chunks = _adamw_rows(params, grads, ms, vs)
    ws, extra = _health_args(n_chunks, acc)
    _adamw_launch(name, rows, n_chunks, params[0].device, bc, extra, params[0].dtype,
                  grads[0].dtype, ms[0].dtype, vs[0].dtype, dict(
                      lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay))


def _adamw_slab_refusal(params, grads, m_slab, v_slab, bc, sizes) -> str | None:
    """The port of ``_fused_adamw_slab_checker`` (pallasex.py:2009)."""
    name = "fused_adamw_slab"
    if not params or not len(params) == len(grads) == len(sizes):
        return (f"{name}: bucket lengths {len(params)}, {len(grads)}, {len(sizes)} sizes must "
                f"be equal and non-zero")
    reason = _adamw_group_refusal(name, params, grads, bc, [m_slab], [v_slab])
    if reason:
        return reason
    for p, g, n in zip(params, grads, sizes):
        if g.shape != p.shape or p.numel() != n:
            return (f"{name}: p {tuple(p.shape)}, g {tuple(g.shape)} and size {n} do not "
                    f"describe one tensor")
    rows_pad, _ = slab_geometry(sum(sizes))
    if tuple(m_slab.shape) != (rows_pad, SLAB_LANE) or v_slab.shape != m_slab.shape:
        return (f"{name}: slabs {tuple(m_slab.shape)} / {tuple(v_slab.shape)} do not match the "
                f"bucket geometry ({rows_pad}, {SLAB_LANE}) for {sum(sizes)} elements")
    return None


def fused_adamw_slab(params, grads, m_slab: torch.Tensor, v_slab: torch.Tensor,
                     bc: torch.Tensor, *, sizes, lr: float, beta1: float, beta2: float,
                     eps: float, weight_decay: float,
                     health: torch.Tensor | None = None) -> None:
    """AdamW over one bucket whose moments live in persistent ``(rows, 128)``
    slabs, in ONE launch, in place on ``params`` and the slabs. Parameter
    ``i`` owns elements ``[sum(sizes[:i]), sum(sizes[:i+1]))`` of each
    flattened slab; the zero pad tail past ``sum(sizes)`` is never touched.
    ``health`` gates the update as in :func:`fused_adamw`.

    The same kernel body as :func:`fused_adamw`, whose table rows point into
    the slabs at each parameter's element offset (64-bit), so p and g are
    never packed and m and v never unpacked. A row whose m/v run is not
    aligned for vector loads takes scalar loads."""
    name = "fused_adamw_slab"
    params, grads, sizes = list(params), list(grads), [int(s) for s in sizes]
    _refuse(_adamw_slab_refusal(params, grads, m_slab, v_slab, bc, sizes)
            or _health_refusal(name, health, params[0]))
    _require_cuda(name, params[0])
    grads = [_dense(g) for g in grads]
    rows, n_chunks = _adamw_slab_rows(params, grads, m_slab, v_slab, sizes)
    _adamw_launch(name, rows, n_chunks, params[0].device, bc,
                  (0 if health is None else health.data_ptr(),), params[0].dtype,
                  grads[0].dtype, m_slab.dtype, v_slab.dtype, dict(
                      lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay))


def fused_adamw_slab_health(params, grads, m_slab: torch.Tensor, v_slab: torch.Tensor,
                            bc: torch.Tensor, acc: torch.Tensor, *, sizes, lr: float,
                            beta1: float, beta2: float, eps: float,
                            weight_decay: float) -> None:
    """The health pass of :func:`fused_adamw_slab` over the same bucket, as
    :func:`fused_adamw_health` is of :func:`fused_adamw`."""
    name = "fused_adamw_slab_health"
    params, grads, sizes = list(params), list(grads), [int(s) for s in sizes]
    _refuse(_adamw_slab_refusal(params, grads, m_slab, v_slab, bc, sizes)
            or _acc_refusal(name, acc, params[0]))
    _require_cuda(name, params[0])
    grads = [_dense(g) for g in grads]
    rows, n_chunks = _adamw_slab_rows(params, grads, m_slab, v_slab, sizes)
    ws, extra = _health_args(n_chunks, acc)
    _adamw_launch(name, rows, n_chunks, params[0].device, bc, extra, params[0].dtype,
                  grads[0].dtype, m_slab.dtype, v_slab.dtype, dict(
                      lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay))


MLP_DH_ROWS = 64   # rows per block of the backward's dh pass: DH_ROWS in csrc/mlp_subblock_bwd.cu


def _subblock_refusal(name: str, residual, x, w_norm, w_gate, w_up, w_down, act: str,
                      *others) -> str | None:
    """Why the MLP sub-block's operands (and ``others`` of x's shape and
    dtype) are not what the kernels take."""
    if act not in ACTIVATIONS:
        return f"{name}: unknown activation {act!r}; known: {sorted(ACTIVATIONS)}"
    if x.ndim == 0:
        return f"{name}: a scalar has no rows"
    reason = _floats_refusal(name, x, residual, w_norm, w_gate, w_up, w_down, *others)
    if reason:
        return reason
    D = x.shape[-1]
    F = w_gate.shape[0] if w_gate.ndim == 2 else -1
    if (residual.shape != x.shape or tuple(w_norm.shape) != (D,)
            or tuple(w_gate.shape) != (F, D) or tuple(w_up.shape) != (F, D)
            or tuple(w_down.shape) != (D, F) or any(t.shape != x.shape for t in others)):
        return (f"{name}: residual {tuple(residual.shape)}, x {tuple(x.shape)}, w_norm "
                f"{tuple(w_norm.shape)}, w_gate {tuple(w_gate.shape)}, w_up "
                f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}: want (..., D), "
                f"(..., D), (D,), (F, D), (F, D), (D, F)")
    N = x.numel() // max(D, 1)
    # the tile loads (TMA, cp.async) need rows of whole 16-byte chunks along D and F
    if N == 0 or D % 8 or F % 8:
        return (f"{name}: {N} rows, D={D}, F={F}: rows must be non-zero and D, F multiples "
                f"of 8")
    return None


def _subblock_dims(x, w_gate):
    D = x.shape[-1]
    return x.numel() // max(D, 1), D, w_gate.shape[0]


def mlp_subblock(residual: torch.Tensor, x: torch.Tensor, w_norm: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 act: str = "silu", eps: float = 1e-5) -> torch.Tensor:
    """The MLP sub-block ``h + (act(n @ w_gate.T) * (n @ w_up.T)) @ w_down.T``
    with ``h = residual + x`` and ``n = rms_norm(h, w_norm)``; ``residual``
    and ``x`` are ``(..., D)``, the weights in the torch ``(out, in)``
    layout. One call launches three CUDA kernels (rows, gate/up, down) and
    counts as one launch; h, n and the SwiGLU product are scratch."""
    name = "mlp_subblock"
    _refuse(_subblock_refusal(name, residual, x, w_norm, w_gate, w_up, w_down, act))
    _require_cuda(name, x)
    residual, x, w_norm, w_gate, w_up, w_down = (
        _dense(t) for t in (residual, x, w_norm, w_gate, w_up, w_down))
    N, D, F = _subblock_dims(x, w_gate)
    h, n = torch.empty_like(x), torch.empty_like(x)
    y = torch.empty((N, F), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _launch(name, residual.data_ptr(), x.data_ptr(), w_norm.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), n.data_ptr(), y.data_ptr(),
            out.data_ptr(), N, D, F, ACTIVATIONS[act], float(eps), _DTYPE_CODES[x.dtype],
            x.device.index, _stream(x), design=gemm_design(x.dtype))
    return out


def mlp_subblock_bwd(g: torch.Tensor, residual: torch.Tensor, x: torch.Tensor,
                     w_norm: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, act: str = "silu", eps: float = 1e-5):
    """``(dh, dw_norm, dw_gate, dw_up, dw_down)`` of :func:`mlp_subblock` for
    the output gradient ``g``, from the saved inputs; ``dh`` is the gradient
    of both ``residual`` and ``x``. One call launches six CUDA kernels
    (seven for 16-bit types) and counts as one launch; the recomputed
    interiors are scratch."""
    name = "mlp_subblock_bwd"
    _refuse(_subblock_refusal(name, residual, x, w_norm, w_gate, w_up, w_down, act, g))
    _require_cuda(name, x)
    g, residual, x, w_norm, w_gate, w_up, w_down = (
        _dense(t) for t in (g, residual, x, w_norm, w_gate, w_up, w_down))
    N, D, F = _subblock_dims(x, w_gate)
    dev, dt = x.device, x.dtype
    dh = torch.empty_like(x)
    dwn, dwg, dwu, dwd = (torch.empty_like(w) for w in (w_norm, w_gate, w_up, w_down))
    n = torch.empty((N, D), dtype=dt, device=dev)
    rr = torch.empty(N, dtype=torch.float32, device=dev)
    dgpre, dup, y = (torch.empty((N, F), dtype=dt, device=dev) for _ in range(3))
    # the wgmma design's dy = g w_down, f32 between its two recompute launches
    dy = (torch.empty((N, F), dtype=torch.float32, device=dev)
          if gemm_design(dt) == "wgmma" else None)
    dn = torch.empty((N, D), dtype=torch.float32, device=dev)
    parts = torch.empty((-(-N // MLP_DH_ROWS), D), dtype=torch.float32, device=dev)
    _launch(name, g.data_ptr(), residual.data_ptr(), x.data_ptr(), w_norm.data_ptr(),
            w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), dh.data_ptr(),
            dwn.data_ptr(), dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(), n.data_ptr(),
            rr.data_ptr(), dgpre.data_ptr(), dup.data_ptr(), y.data_ptr(),
            None if dy is None else dy.data_ptr(), dn.data_ptr(),
            parts.data_ptr(), N, D, F, ACTIVATIONS[act], float(eps), _DTYPE_CODES[dt],
            dev.index, _stream(x), design=gemm_design(dt))
    return dh, dwn, dwg, dwu, dwd


# geometry of csrc/decode_layer.cuh: ACT_BYTES (the fma design's staged
# activation rows) and the stream design's shared memory (8 staged rows of
# ST_COLS 16-bit values plus 16 bytes each, 8 warps' 12 KB rings, their 8 KB
# of partial sums); its attention phase splits the context as
# paged_decode_attention does (paged_geometry)
DECODE_ACT_BYTES = 64 * 1024
DECODE_DESIGNS = ("fma", "stream")   # by the code the C entries take
DECODE_STREAM_MAX_ROWS = 8
DECODE_STREAM_MAX_K = 4096           # ST_COLS
DECODE_STREAM_BYTES = 8 * (DECODE_STREAM_MAX_K + 8) * 2 + 8 * 12 * 1024 + 8 * 32 * 8 * 4
DECODE_STREAM_GROUPS = 2   # chunks the stream design's attention phase runs at once


def _decode_smem(stream: bool, S: int, G: int, hd: int, esize: int) -> int | None:
    """Shared memory of one decode-layer block, in bytes (``smem_bytes`` in
    the source): the design's product buffers or the attention phase's
    chunks (two at once in the stream design), whichever is larger, then S
    row statistics; None where not even a 4-key chunk fits."""
    keys = paged_chunk_keys(G, hd, esize)
    if not keys:
        return None
    groups = DECODE_STREAM_GROUPS if stream else 1
    main = DECODE_STREAM_BYTES if stream else DECODE_ACT_BYTES
    attn = groups * _align16(_paged_smem(G, hd, keys, esize, PAGED_THREADS // groups))
    return max(main, attn) + _align16(S * 4)


def decode_design(dtype: torch.dtype, S: int, D: int, H: int, KV: int, hd: int) -> str:
    """The design of ``decode_layer``'s and ``attn_subblock``'s products
    for S slots of ``dtype``: ``"stream"`` (wstream.cuh's swap-AB
    ``mma.sync`` weight stream) for bf16 or fp16 at S <= 8 with D and H * hd
    within the 4096 staged columns and the block's shared memory within the
    card's; ``"fma"`` (f32 FMAs against staged rows) otherwise."""
    smem = _decode_smem(True, S, H // KV, hd, torch.finfo(dtype).bits // 8)
    fits = smem is not None and smem <= _SMEM_MAX
    return ("stream" if dtype in _SIXTEEN_BIT and S <= DECODE_STREAM_MAX_ROWS
            and D <= DECODE_STREAM_MAX_K and H * hd <= DECODE_STREAM_MAX_K and fits else "fma")


def _decode_refusal(name, h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                    lengths, write_pos) -> str | None:
    """Why the decode kernel does not take these operands: where
    ``_attn_subblock_checker`` (pallasex.py:1761) refuses, and where the
    kernel does not take the shapes."""
    reason = _dtype_refusal(name, h)
    if reason:
        return reason
    dt = h.dtype
    if h.ndim != 3 or h.shape[1] != 1:
        return f"{name}: h {tuple(h.shape)} must be (S, 1, D): one row per slot, decode only"
    if k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        return (f"{name}: pools {tuple(k_pages.shape)} / {tuple(v_pages.shape)} must be one "
                f"(KV, P, ps, hd) shape")
    S, D = h.shape[0], h.shape[2]
    KV, P, ps, hd = k_pages.shape
    # the pools are read in place, so the head dim is taken as it is: any
    # even one (the rope pairs columns j and j + hd/2)
    if hd % 2 or not 2 <= hd <= ATTN_MAX_HEAD_DIM:
        return f"{name}: head dim {hd} must be even, up to {ATTN_MAX_HEAD_DIM}"
    if wq.ndim != 2 or wq.shape[1] != D or wq.shape[0] % hd:
        return f"{name}: wq {tuple(wq.shape)} must be (H * {hd}, {D})"
    H = wq.shape[0] // hd
    if H % KV:
        return f"{name}: {H} heads over {KV} kv heads"
    if (H * hd) % 8:
        return (f"{name}: {H} heads of {hd}: the out-projection's rows (H * hd) must be a "
                f"multiple of 8 for its 16-byte loads")
    want = {"w_norm": (D,), "wk": (KV * hd, D), "wv": (KV * hd, D), "wo": (D, H * hd),
            "cos": (S, 1, 1, hd // 2), "sin": (S, 1, 1, hd // 2)}
    for arg, t in zip(want, (w_norm, wk, wv, wo, cos, sin)):
        if tuple(t.shape) != want[arg]:
            return f"{name}: {arg} {tuple(t.shape)} where {want[arg]} is required"
    if D % 8:
        return f"{name}: D={D} must be a multiple of 8"
    floats = (h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages)
    if any(t.dtype != dt for t in floats):
        return f"{name}: dtypes {[str(t.dtype) for t in floats]} must all be {dt}"
    if (block_tables.ndim != 2 or block_tables.shape[0] != S or tuple(lengths.shape) != (S,)
            or tuple(write_pos.shape) != (S,)):
        return (f"{name}: block_tables {tuple(block_tables.shape)}, lengths "
                f"{tuple(lengths.shape)}, write_pos {tuple(write_pos.shape)} for {S} slots")
    reason = (_tensors_refusal(name, *floats[:-2], dtype=dt)
              or _tensors_refusal(name, k_pages, v_pages, dtype=dt, in_place=True)
              or _tensors_refusal(name, block_tables, lengths, dtype=torch.int32))
    if reason:
        return reason
    if k_pages.device != h.device:
        return f"{name}: pools on {k_pages.device}, h on {h.device}"
    if write_pos.dtype not in (torch.int32, torch.int64):
        return f"{name}: write_pos dtype {write_pos.dtype} is not an integer type"
    if any(t.device != h.device for t in (block_tables, lengths, write_pos)):
        return f"{name}: block tables, lengths and write_pos must be on {h.device}"
    smem = _decode_smem(False, S, H // KV, hd, h.element_size())
    if smem is None or smem > _SMEM_MAX:
        return (f"{name}: {H // KV} grouped heads of {hd} need more shared memory than a block "
                f"has, even at 4 keys a chunk")
    return None


def _decode_call(name, h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                 lengths, write_pos, mlp, act, eps, scale):
    _require_cuda(name, h)
    h, w_norm, wq, wk, wv, wo, cos, sin, block_tables, lengths = (
        _dense(t) for t in (h, w_norm, wq, wk, wv, wo, cos, sin, block_tables, lengths))
    if mlp is not None:
        mlp = tuple(_dense(t) for t in mlp)
    S, D = h.shape[0], h.shape[2]
    KV, P, ps, hd = k_pages.shape
    H, npg = wq.shape[0] // hd, block_tables.shape[1]
    dev, dt = h.device, h.dtype
    keys, nch, ws_shape = paged_geometry(S, H, KV, hd, ps, npg, dt)
    out = torch.empty_like(h)
    k_rows, v_rows = (torch.empty((KV, S, hd), dtype=dt, device=dev) for _ in range(2))
    q_ws = torch.empty((S, H, hd), dtype=dt, device=dev)
    part = torch.empty(ws_shape, dtype=torch.float32, device=dev)
    attn_ws = torch.empty((S, H * hd), dtype=dt, device=dev)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    design = decode_design(dt, S, D, H, KV, hd)
    ins = [t.data_ptr() for t in (h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                                  block_tables, lengths)]
    tail = (float(eps), scale, DECODE_DESIGNS.index(design), _DTYPE_CODES[dt], dev.index,
            _stream(h))
    if mlp is None:
        _launch(name, *ins, out.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
                q_ws.data_ptr(), part.data_ptr(), attn_ws.data_ptr(), S, D, H, KV, hd, P, ps,
                npg, keys, nch, *tail, design=design)
        return out, k_rows, v_rows
    F = mlp[1].shape[0]
    hacc = torch.empty((S, D), dtype=torch.float32, device=dev)
    y_ws = torch.empty((S, F), dtype=dt, device=dev)
    _launch(name, *ins, *(t.data_ptr() for t in mlp), out.data_ptr(), k_rows.data_ptr(),
            v_rows.data_ptr(), q_ws.data_ptr(), part.data_ptr(), attn_ws.data_ptr(),
            hacc.data_ptr(), y_ws.data_ptr(), S, D, H, KV, hd, P, ps, npg, F, keys, nch,
            ACTIVATIONS[act], *tail, design=design)
    return out, k_rows, v_rows


def attn_subblock(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
                  write_pos, eps: float = 1e-5, scale: float | None = None):
    """The decode attention sub-block in ONE cooperative launch: ``(out,
    k_rows, v_rows)`` with ``out`` (S, 1, D) the out-projection before the
    residual add and this step's k/v rows (KV, S, hd). The pools are only
    read, position ``lengths - 1`` taken from the fresh rows; ``write_pos``
    is checked, and the caller stores the rows there. q, the attention
    chunks' partials and the merged heads are scratch."""
    args = (h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
            write_pos)
    _refuse(_decode_refusal("attn_subblock", *args))
    return _decode_call("attn_subblock", *args, None, "silu", eps, scale)


def _decode_layer_refusal(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                          block_tables, lengths, write_pos, mlp_norm, w_gate, w_up, w_down,
                          act) -> str | None:
    name = "decode_layer"
    if act not in ACTIVATIONS:
        return f"{name}: unknown activation {act!r}; known: {sorted(ACTIVATIONS)}"
    D = h.shape[-1]
    F = w_gate.shape[0] if w_gate.ndim == 2 else -1
    if (tuple(mlp_norm.shape) != (D,) or tuple(w_gate.shape) != (F, D)
            or tuple(w_up.shape) != (F, D) or tuple(w_down.shape) != (D, F)):
        return (f"{name}: mlp_norm {tuple(mlp_norm.shape)}, w_gate {tuple(w_gate.shape)}, w_up "
                f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}: want (D,), (F, D), (F, D), "
                f"(D, F)")
    if F % 8:
        return f"{name}: F={F} must be a multiple of 8"
    if any(t.dtype != h.dtype for t in (mlp_norm, w_gate, w_up, w_down)):
        return f"{name}: the MLP weights' dtype must be h's, {h.dtype}"
    reason = _floats_refusal(name, h, mlp_norm, w_gate, w_up, w_down)
    if reason:
        return reason
    return _decode_refusal(name, h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                           block_tables, lengths, write_pos)


def decode_layer(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                 lengths, write_pos, mlp_norm, w_gate, w_up, w_down, act: str = "silu",
                 eps: float = 1e-5, scale: float | None = None):
    """The whole T == 1 decode layer in ONE cooperative launch: ``(out,
    k_rows, v_rows)``, as :func:`attn_subblock` plus the residual add and the
    MLP sub-block on the float32 residual; ``w_gate``, ``w_up`` (F, D),
    ``w_down`` (D, F). Raises where ``_decode_layer_checker``
    (pallasex.py:1817) refuses, where the kernel does not take the shapes,
    and where the card refuses the launch."""
    _refuse(_decode_layer_refusal(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                                  block_tables, lengths, write_pos, mlp_norm, w_gate, w_up,
                                  w_down, act))
    return _decode_call("decode_layer", h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages,
                        v_pages, block_tables, lengths, write_pos,
                        (mlp_norm, w_gate, w_up, w_down), act, eps, scale)


# each kernel's refusal, called with its wrapper's arguments
_REFUSALS = {
    "rms_norm": lambda x, weight=None, eps=1e-5: _rms_refusal("rms_norm", x, weight),
    "rms_norm_residual": lambda residual, x, weight=None, eps=1e-5:
        _rms_residual_refusal(residual, x, weight),
    "linear_act": lambda a, w, bias=None, act="relu": _linear_act_refusal(a, w, bias, act),
    "paged_decode_attention": lambda q, k_pages, v_pages, block_tables, lengths, scale=None:
        _paged_refusal(q, k_pages, v_pages, block_tables, lengths),
    "sdpa_fwd": lambda q, k, v, is_causal=False, scale=None: _attn_refusal("sdpa_fwd", q, k, v),
    "sdpa_bwd": lambda g, q, k, v, out, lse, is_causal=False, scale=None:
        _sdpa_bwd_refusal(g, q, k, v, out, lse),
    "ce_fwd": lambda logits, target, ignore_index=-100: _ce_refusal(logits, target),
    "fused_adamw": lambda params, grads, ms, vs, bc, health=None, **hyper:
        _adamw_refusal(list(params), list(grads), list(ms), list(vs), bc)
        or _health_refusal("fused_adamw", health, list(params)[0]),
    "fused_adamw_slab": lambda params, grads, m_slab, v_slab, bc, *, sizes, health=None,
        **hyper: _adamw_slab_refusal(list(params), list(grads), m_slab, v_slab, bc,
                                     [int(n) for n in sizes])
        or _health_refusal("fused_adamw_slab", health, list(params)[0]),
    "fused_adamw_health": lambda params, grads, ms, vs, bc, acc, **hyper:
        _adamw_refusal(list(params), list(grads), list(ms), list(vs), bc)
        or _acc_refusal("fused_adamw_health", acc, list(params)[0]),
    "fused_adamw_slab_health": lambda params, grads, m_slab, v_slab, bc, acc, *, sizes,
        **hyper: _adamw_slab_refusal(list(params), list(grads), m_slab, v_slab, bc,
                                     [int(n) for n in sizes])
        or _acc_refusal("fused_adamw_slab_health", acc, list(params)[0]),
    "mlp_subblock": lambda residual, x, w_norm, w_gate, w_up, w_down, act="silu", eps=1e-5:
        _subblock_refusal("mlp_subblock", residual, x, w_norm, w_gate, w_up, w_down, act),
    "mlp_subblock_bwd": lambda g, residual, x, w_norm, w_gate, w_up, w_down, act="silu",
        eps=1e-5: _subblock_refusal("mlp_subblock_bwd", residual, x, w_norm, w_gate, w_up,
                                    w_down, act, g),
    "attn_subblock": lambda h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
        lengths, write_pos, eps=1e-5, scale=None: _decode_refusal(
            "attn_subblock", h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
            lengths, write_pos),
    "decode_layer": lambda h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
        block_tables, lengths, write_pos, mlp_norm, w_gate, w_up, w_down, act="silu", eps=1e-5,
        scale=None: _decode_layer_refusal(
            h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
            write_pos, mlp_norm, w_gate, w_up, w_down, act),
}


def refusal(name: str, *args, **kwargs) -> str | None:
    """Why kernel ``name`` does not take its wrapper's arguments ``args``
    and ``kwargs`` (None where it does): the reason the wrapper raises. The
    device is not judged: a wrapper also raises on CPU tensors."""
    return _REFUSALS[name](*args, **kwargs)
