"""Hand-written Hopper kernels of the port: build, binding, wrappers.

The counterpart of ``thunder_tpu/executors/pallasex.py``: one hand-written
kernel for every Pallas kernel there, the ones the serving steps and the
single-device train step run at both their per-op and planned rungs. The
serving planned rung's ``decode_layer`` and ``attn_subblock`` are one
cooperative kernel (``csrc/decode_layer.cuh``) built as two libraries, with
and without the MLP phases. Each kernel is CUDA C++ for ``sm_90a`` in
``thunder_tpu_torch/csrc/``; its source note names the Pallas function it
replaces, its bound on an H100, and what its design does about that bound.

Build: at first use, :func:`build` runs one ``nvcc`` per ``csrc/*.cu``
source, all started together, into ``thunder_tpu_torch/_build/``. Each
shared library is named by a hash of every ``csrc`` file and the flags, so a
changed source rebuilds and an unchanged one loads from disk. Each library
exports a plain C entry point, bound here with ``ctypes``: pointers and the
stream travel as ``c_void_p``, and the entry returns ``cudaGetLastError()``,
which the wrapper turns into an exception.

Wrappers: each checks device, dtype, shape and contiguity and raises on
what its kernel does not take (the counterpart of pallasex's ``_*_checker``
functions, except that a refusal here is an error, never a fallback).
Outputs are allocated with ``torch.empty``; the kernel runs on
``torch.cuda.current_stream()`` and does not synchronise. Every wrapper
adds one to its kernel's ``launches`` count where it launches, and nowhere
else. A wrapper takes CUDA tensors only: the routing of CPU tensors to the
plain versions lives in :mod:`thunder_tpu_torch.ops.nn`.

Designs: ``sdpa_fwd`` and ``linear_act`` each hold more than one kernel
design, and the wrapper picks one by a fixed rule of shape and dtype
(:func:`sdpa_fwd_design`, :func:`linear_act_path`), passes it to the C
entry, which refuses a design the inputs do not fit, and counts the launch
under it as well (:func:`design_counts`). A launch never falls back to
another design.
"""

from __future__ import annotations

import ctypes
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
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


KERNELS = {k.name: k for k in (
    Kernel("rms_norm", "thunder_tpu_torch/csrc/rms_norm.cu",
           "thunder_tpu/executors/pallasex.py:738", "tt_rms_norm",
           (_P, _P, _P, _L, _I, _F, _I, _I, _P)),
    Kernel("rms_norm_residual", "thunder_tpu_torch/csrc/rms_norm_residual.cu",
           "thunder_tpu/executors/pallasex.py:811", "tt_rms_norm_residual",
           (_P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _P)),
    Kernel("linear_act", "thunder_tpu_torch/csrc/linear_act.cu",
           "thunder_tpu/executors/pallasex.py:896", "tt_linear_act",
           (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    Kernel("paged_decode_attention",
           "thunder_tpu_torch/csrc/paged_decode_attention.cu",
           "thunder_tpu/executors/pallasex.py:1316", "tt_paged_decode_attention",
           (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P)),
    Kernel("sdpa_fwd", "thunder_tpu_torch/csrc/sdpa_fwd.cu",
           "thunder_tpu/executors/pallasex.py:214", "tt_sdpa_fwd",
           (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P)),
    Kernel("sdpa_bwd", "thunder_tpu_torch/csrc/sdpa_bwd.cu",
           "thunder_tpu/executors/pallasex.py:537", "tt_sdpa_bwd",
           (_P,) * 10 + (_I, _I, _I, _I, _F, _I, _I, _I, _P)),
    Kernel("ce_fwd", "thunder_tpu_torch/csrc/ce_fwd.cu",
           "thunder_tpu/executors/pallasex.py:686", "tt_ce_fwd",
           (_P, _P, _P, _P, _L, _I, _L, _I, _I, _P)),
    Kernel("fused_adamw", "thunder_tpu_torch/csrc/fused_adamw.cu",
           "thunder_tpu/executors/pallasex.py:1944", "tt_fused_adamw",
           (_P, _I, _L, _P) + (_F,) * 7 + (_I, _I, _I, _I, _P)),
    Kernel("mlp_subblock", "thunder_tpu_torch/csrc/mlp_subblock.cu",
           "thunder_tpu/executors/pallasex.py:1039", "tt_mlp_subblock",
           (_P,) * 10 + (_I, _I, _I, _I, _F, _I, _I, _P)),
    Kernel("mlp_subblock_bwd", "thunder_tpu_torch/csrc/mlp_subblock_bwd.cu",
           "thunder_tpu/executors/pallasex.py:1161", "tt_mlp_subblock_bwd",
           (_P,) * 19 + (_I, _I, _I, _I, _F, _I, _I, _P)),
    Kernel("decode_layer", "thunder_tpu_torch/csrc/decode_layer.cu",
           "thunder_tpu/executors/pallasex.py:1751", "tt_decode_layer",
           (_P,) * 24 + (_I,) * 12 + (_F, _F, _I, _I, _P)),
    Kernel("attn_subblock", "thunder_tpu_torch/csrc/attn_subblock.cu",
           "thunder_tpu/executors/pallasex.py:1743", "tt_attn_subblock",
           (_P,) * 18 + (_I,) * 10 + (_F, _F, _I, _I, _P)),
)}

_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.designs.clear()


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def design_counts() -> dict[str, dict[str, int]]:
    """Launches by design of the kernels that have several:
    ``{"sdpa_fwd": {"wgmma": 4}, ...}``."""
    return {name: dict(k.designs) for name, k in KERNELS.items() if k.designs}


# sdpa_fwd's designs, by the code the C entry takes (csrc/sdpa_fwd.cu)
SDPA_FWD_DESIGNS = ("fma", "mma", "wgmma")
# head dims of the TMA + wgmma design: llama3-8b's 128, and 64
SDPA_WGMMA_HEAD_DIMS = (64, 128)


def sdpa_fwd_design(dtype: torch.dtype, hd: int) -> str:
    """The ``sdpa_fwd`` design that inputs of ``dtype`` and head dim ``hd``
    take: ``"wgmma"`` for bf16 at hd 64 or 128, ``"mma"`` (mma.sync) for
    bf16 at other head dims, ``"fma"`` for float32."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if hd in SDPA_WGMMA_HEAD_DIMS else "mma"


# linear_act's paths, by the code the C entry takes (csrc/linear_act.cu)
LINEAR_ACT_PATHS = ("tile", "stream")
LINEAR_ACT_STREAM_MAX_ROWS = 16   # two n-tiles of 8 activation rows


def linear_act_path(dtype: torch.dtype, M: int) -> str:
    """The ``linear_act`` path that ``M`` rows of ``dtype`` take:
    ``"stream"`` (the weight-streaming decode kernel) for bf16 at
    M <= 16, ``"tile"`` (gemm.cuh's mainloop) otherwise."""
    return "stream" if dtype == torch.bfloat16 and M <= LINEAR_ACT_STREAM_MAX_ROWS else "tile"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
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
    ``nvcc`` is missing, or when a source does not compile."""
    if not torch.cuda.is_available():
        raise RuntimeError("thunder_tpu_torch kernels need a CUDA device; "
                           "none is available")
    with _build_lock:
        if all(k.fn is not None for k in KERNELS.values()):
            return {k.name: 0.0 for k in KERNELS.values()}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        key = _source_key()
        libs = {k.name: BUILD_DIR / f"{Path(k.source).stem}-{key}.so"
                for k in KERNELS.values()}
        todo = [k for k in KERNELS.values() if not libs[k.name].exists()]
        procs, t0 = {}, time.perf_counter()
        nvcc = _nvcc() if todo else ""
        for k in todo:
            tmp = libs[k.name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / Path(k.source).name)]
            procs[k.name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        seconds = {k.name: 0.0 for k in KERNELS.values()}
        errors = []
        for name, (tmp, p) in procs.items():
            log, _ = p.communicate()
            seconds[name] = time.perf_counter() - t0
            if p.returncode != 0:
                errors.append(f"{name}: nvcc exited {p.returncode}\n{log}")
            else:
                os.replace(tmp, libs[name])
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for k in KERNELS.values():
            lib = ctypes.CDLL(str(libs[k.name]))
            fn = getattr(lib, k.symbol)
            fn.argtypes = list(k.argtypes)
            fn.restype = ctypes.c_int
            k.fn = fn
        return seconds


def _launch(name: str, *args, design: str | None = None) -> None:
    k = KERNELS[name]
    if k.fn is None:
        build()
    rc = k.fn(*args)
    if rc != 0:
        raise RuntimeError(f"{k.name}: kernel launch failed with CUDA error {rc}")
    k.launches += 1
    if design is not None:
        k.designs[design] = k.designs.get(design, 0) + 1


def _check(name: str, *tensors, dtype: torch.dtype) -> None:
    """Every tensor given (None entries skipped) on one CUDA device,
    contiguous, of ``dtype``."""
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype} where {dtype} is required")


def _float_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return t.dtype


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, eps: float) -> torch.Tensor:
    """``rms_norm`` over the last dim of a contiguous ``(..., D)`` tensor."""
    name = "rms_norm"
    _check(name, x, weight, dtype=_float_dtype(name, x))
    D = x.shape[-1]
    if weight is not None and tuple(weight.shape) != (D,):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} for rows of {D}")
    out = torch.empty_like(x)
    _launch(name, x.data_ptr(), None if weight is None else weight.data_ptr(),
            out.data_ptr(), x.numel() // max(D, 1), D, float(eps),
            _DTYPE_CODES[x.dtype], x.device.index, _stream(x))
    return out


def rms_norm_residual(residual: torch.Tensor, x: torch.Tensor,
                      weight: torch.Tensor | None, eps: float):
    """``h = residual + x``; returns ``(h, rms_norm(h, weight))``."""
    name = "rms_norm_residual"
    _check(name, residual, x, weight, dtype=_float_dtype(name, residual))
    if residual.shape != x.shape:
        raise ValueError(f"rms_norm_residual: residual {tuple(residual.shape)} "
                         f"!= input {tuple(x.shape)}")
    D = x.shape[-1]
    if weight is not None and tuple(weight.shape) != (D,):
        raise ValueError(f"rms_norm_residual: weight {tuple(weight.shape)} for rows of {D}")
    h = torch.empty_like(x)
    out = torch.empty_like(x)
    _launch(name, residual.data_ptr(), x.data_ptr(),
            None if weight is None else weight.data_ptr(), h.data_ptr(),
            out.data_ptr(), x.numel() // max(D, 1), D, float(eps),
            _DTYPE_CODES[x.dtype], x.device.index, _stream(x))
    return h, out


def linear_act(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               act: str = "relu") -> torch.Tensor:
    """``act(a @ w.T + bias)`` with f32 accumulation; ``a`` is ``(..., K)``,
    ``w`` is ``(N, K)``; the result is ``(..., N)`` in ``a.dtype``."""
    name = "linear_act"
    if act not in ACTIVATIONS:
        raise ValueError(f"linear_act: unknown activation {act!r}; known: "
                         f"{sorted(ACTIVATIONS)}")
    _check(name, a, w, bias, dtype=_float_dtype(name, a))
    if w.ndim != 2 or a.shape[-1] != w.shape[1]:
        raise ValueError(f"linear_act: a {tuple(a.shape)} and w {tuple(w.shape)} "
                         f"do not share K")
    N, K = w.shape
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"linear_act: bias {tuple(bias.shape)} for {N} outputs")
    # both paths copy rows in 16-byte chunks along K
    if K % (16 // a.element_size()):
        raise ValueError(f"linear_act: K={K} must be a multiple of {16 // a.element_size()} "
                         f"for {a.dtype}")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("linear_act: operands must be 16-byte aligned")
    M = a.numel() // max(K, 1)
    path = linear_act_path(a.dtype, M)
    out = torch.empty(a.shape[:-1] + (N,), dtype=a.dtype, device=a.device)
    _launch(name, a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), M, N, K, ACTIVATIONS[act], _DTYPE_CODES[a.dtype],
            LINEAR_ACT_PATHS.index(path), a.device.index, _stream(a), design=path)
    return out


# accumulators each thread of the paged kernel holds (MAXR * THREADS in the
# source): G * hd may not exceed it
_PAGED_MAX_ROW_VALUES = 8 * 256


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """T == 1 ragged attention: ``q`` (B, H, 1, hd) against the pools
    (KV, P, ps, hd) through ``block_tables`` (B, npg) int32 up to
    ``lengths`` (B,) int32. Returns (B, H, 1, hd) in ``q.dtype``. The block
    tables are trusted: every entry must be a valid page index (the
    allocator keeps unused entries at the reserved page 0)."""
    name = "paged_decode_attention"
    _check(name, q, k_pages, v_pages, dtype=_float_dtype(name, q))
    _check(name, block_tables, lengths, dtype=torch.int32)
    if block_tables.device != q.device:
        raise ValueError(f"{name}: block tables on {block_tables.device}, q on {q.device}")
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} must be "
                         f"(B, H, 1, hd) and pools (KV, P, ps, hd), got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    B, H, T, hd = q.shape
    KV, P, ps, hd2 = k_pages.shape
    if T != 1:
        raise ValueError(f"paged_decode_attention kernel is decode-only (T == 1); "
                         f"got T={T}")
    if hd2 != hd or H % KV:
        raise ValueError(f"paged_decode_attention: head_dim {hd} vs pools {hd2}, "
                         f"{H} heads over {KV} kv heads")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_decode_attention: block_tables "
                         f"{tuple(block_tables.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not match batch {B}")
    if (H // KV) * hd > _PAGED_MAX_ROW_VALUES:
        raise ValueError(f"paged_decode_attention: {H // KV} grouped rows of {hd} "
                         f"exceed the kernel's {_PAGED_MAX_ROW_VALUES} accumulators")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    _launch(name, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KV, P, ps, hd, block_tables.shape[1], scale,
            _DTYPE_CODES[q.dtype], q.device.index, _stream(q))
    return out


def _attn_dims(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(batch*heads, T, S, hd) of q (..., T, hd) against k, v (..., S, hd)."""
    if q.ndim < 3 or k.shape != v.shape or q.shape[:-2] != k.shape[:-2] \
            or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} must be (..., T, hd) and (..., S, hd) with the "
                         f"same leading dims")
    T, hd = q.shape[-2], q.shape[-1]
    if hd % 16 or not 16 <= hd <= 128:
        raise ValueError(f"{name}: head dim {hd} must be a multiple of 16 up to 128")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    return q.numel() // (T * hd), T, k.shape[-2], hd


def sdpa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, is_causal: bool = False,
             scale: float | None = None):
    """Flash-attention forward: ``(out, lse)``; ``out`` in ``q.dtype``, ``lse``
    (..., T) float32. Causal masking is top-left aligned (row >= col)."""
    name = "sdpa_fwd"
    _check(name, q, k, v, dtype=_float_dtype(name, q))
    BH, T, S, hd = _attn_dims(name, q, k, v)
    if S == 0:
        raise ValueError(f"{name}: no keys (S = 0)")
    design = sdpa_fwd_design(q.dtype, hd)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            BH, T, S, hd, scale, int(bool(is_causal)), _DTYPE_CODES[q.dtype],
            SDPA_FWD_DESIGNS.index(design), q.device.index, _stream(q), design=design)
    return out, lse


def sdpa_bwd(g: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             out: torch.Tensor, lse: torch.Tensor, is_causal: bool = False,
             scale: float | None = None):
    """Flash-attention backward: ``(dq, dk, dv)`` from the output gradient
    ``g`` and the forward's ``(out, lse)``. One call launches three CUDA
    kernels (delta, dK/dV, dQ) and counts as one launch."""
    name = "sdpa_bwd"
    _check(name, g, q, k, v, out, dtype=_float_dtype(name, q))
    _check(name, lse, dtype=torch.float32)
    BH, T, S, hd = _attn_dims(name, q, k, v)
    if g.shape != q.shape or out.shape != q.shape or lse.shape != q.shape[:-1]:
        raise ValueError(f"{name}: g {tuple(g.shape)}, out {tuple(out.shape)} and lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if lse.device != q.device or g.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name}: lse on {lse.device}, q on {q.device}; g and out must be "
                         f"16-byte aligned")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    _launch(name, g.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            BH, T, S, hd, scale, int(bool(is_causal)), _DTYPE_CODES[q.dtype], q.device.index,
            _stream(q))
    return dq, dk, dv


def ce_fwd(logits: torch.Tensor, target: torch.Tensor, ignore_index: int = -100):
    """Per-row ``(nll, lse)`` float32 of ``logits`` (N, V) against ``target``
    (N,) int64; rows whose target is ``ignore_index`` get nll 0."""
    name = "ce_fwd"
    _check(name, logits, dtype=_float_dtype(name, logits))
    _check(name, target, dtype=torch.int64)
    if logits.ndim != 2 or tuple(target.shape) != (logits.shape[0],):
        raise ValueError(f"{name}: logits {tuple(logits.shape)} must be (N, V) and target "
                         f"{tuple(target.shape)} (N,)")
    if target.device != logits.device:
        raise ValueError(f"{name}: target on {target.device}, logits on {logits.device}")
    N, V = logits.shape
    nll = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty(N, dtype=torch.float32, device=logits.device)
    _launch(name, logits.data_ptr(), target.data_ptr(), nll.data_ptr(), lse.data_ptr(), N, V,
            int(ignore_index), _DTYPE_CODES[logits.dtype], logits.device.index,
            _stream(logits))
    return nll, lse


ADAMW_CHUNK = 4096   # elements per block: CHUNK in csrc/fused_adamw.cu


def fused_adamw(params, grads, ms, vs, bc: torch.Tensor, *, lr: float, beta1: float,
                beta2: float, eps: float, weight_decay: float) -> None:
    """AdamW over one bucket in ONE launch, updating ``params``, ``ms`` and
    ``vs`` in place. ``bc`` is the float32 device tensor ``[1 - beta1**step,
    1 - beta2**step]``. Params and grads share one dtype; m and v may each be
    float32 or bfloat16.

    The kernel reads a device table of the tensors' pointers, sizes and
    first chunks, built on the host and copied to the card (non-blocking,
    from pinned memory) on every call."""
    name = "fused_adamw"
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    if not params or not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"{name}: bucket lengths {len(params)}, {len(grads)}, {len(ms)}, "
                         f"{len(vs)} must be equal and non-zero")
    _check(name, *params, *grads, dtype=_float_dtype(name, params[0]))
    _check(name, *ms, dtype=_float_dtype(name, ms[0]))
    _check(name, *vs, dtype=_float_dtype(name, vs[0]))
    _check(name, bc, dtype=torch.float32)
    dev = params[0].device
    if any(t.device != dev for t in (ms[0], vs[0], bc)) or tuple(bc.shape) != (2,):
        raise ValueError(f"{name}: every tensor on {dev}, bc of shape (2,)")
    for quad in zip(params, grads, ms, vs):
        if any(t.shape != quad[0].shape for t in quad):
            raise ValueError(f"{name}: p/g/m/v shapes {[tuple(t.shape) for t in quad]} differ")
        if any(t.data_ptr() % 16 for t in quad):
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    rows, n_chunks = [], 0
    for p, g, m, v in zip(params, grads, ms, vs):
        if p.numel():
            rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                         n_chunks))
            n_chunks += -(-p.numel() // ADAMW_CHUNK)
    host = torch.tensor(rows or [(0,) * 6], dtype=torch.int64).pin_memory()
    table = host.to(dev, non_blocking=True)
    _launch(name, table.data_ptr(), len(rows), n_chunks, bc.data_ptr(), float(lr),
            float(beta1), float(beta2), float(1.0 - beta1), float(1.0 - beta2), float(eps),
            float(weight_decay), _DTYPE_CODES[params[0].dtype], _DTYPE_CODES[ms[0].dtype],
            _DTYPE_CODES[vs[0].dtype], dev.index, _stream(params[0]))


MLP_DH_ROWS = 64   # rows per block of the backward's dh pass: DH_ROWS in csrc/mlp_subblock_bwd.cu


def _subblock_dims(name: str, residual, x, w_norm, w_gate, w_up, w_down, act: str):
    """(N, D, F) of the MLP sub-block's operands; raises on what the kernels
    do not take."""
    if act not in ACTIVATIONS:
        raise ValueError(f"{name}: unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")
    _check(name, residual, x, w_norm, w_gate, w_up, w_down, dtype=_float_dtype(name, x))
    D = x.shape[-1]
    F = w_gate.shape[0] if w_gate.ndim == 2 else -1
    if (residual.shape != x.shape or tuple(w_norm.shape) != (D,)
            or tuple(w_gate.shape) != (F, D) or tuple(w_up.shape) != (F, D)
            or tuple(w_down.shape) != (D, F)):
        raise ValueError(f"{name}: residual {tuple(residual.shape)}, x {tuple(x.shape)}, w_norm "
                         f"{tuple(w_norm.shape)}, w_gate {tuple(w_gate.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}: want (..., D), "
                         f"(..., D), (D,), (F, D), (F, D), (D, F)")
    N = x.numel() // max(D, 1)
    # the tile loads move 16-byte chunks along D and F
    if N == 0 or D % 8 or F % 8:
        raise ValueError(f"{name}: {N} rows, D={D}, F={F}: rows must be non-zero and D, F "
                         f"multiples of 8")
    if any(t.data_ptr() % 16 for t in (residual, x, w_norm, w_gate, w_up, w_down)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return N, D, F


def mlp_subblock(residual: torch.Tensor, x: torch.Tensor, w_norm: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 act: str = "silu", eps: float = 1e-5) -> torch.Tensor:
    """The MLP sub-block ``h + (act(n @ w_gate.T) * (n @ w_up.T)) @ w_down.T``
    with ``h = residual + x`` and ``n = rms_norm(h, w_norm)``; ``residual``
    and ``x`` are ``(..., D)``, the weights in the torch ``(out, in)``
    layout. One call launches three CUDA kernels (rows, gate/up, down) and
    counts as one launch; h, n and the SwiGLU product are scratch."""
    name = "mlp_subblock"
    N, D, F = _subblock_dims(name, residual, x, w_norm, w_gate, w_up, w_down, act)
    h, n = torch.empty_like(x), torch.empty_like(x)
    y = torch.empty((N, F), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _launch(name, residual.data_ptr(), x.data_ptr(), w_norm.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), n.data_ptr(), y.data_ptr(),
            out.data_ptr(), N, D, F, ACTIVATIONS[act], float(eps), _DTYPE_CODES[x.dtype],
            x.device.index, _stream(x))
    return out


def mlp_subblock_bwd(g: torch.Tensor, residual: torch.Tensor, x: torch.Tensor,
                     w_norm: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, act: str = "silu", eps: float = 1e-5):
    """``(dh, dw_norm, dw_gate, dw_up, dw_down)`` of :func:`mlp_subblock` for
    the output gradient ``g``, from the saved inputs; ``dh`` is the gradient
    of both ``residual`` and ``x``. One call launches six CUDA kernels and
    counts as one launch; the recomputed interiors are scratch."""
    name = "mlp_subblock_bwd"
    N, D, F = _subblock_dims(name, residual, x, w_norm, w_gate, w_up, w_down, act)
    _check(name, g, x, dtype=x.dtype)
    if g.shape != x.shape or g.data_ptr() % 16:
        raise ValueError(f"{name}: g {tuple(g.shape)} must match x {tuple(x.shape)} and be "
                         f"16-byte aligned")
    dev, dt = x.device, x.dtype
    dh = torch.empty_like(x)
    dwn, dwg, dwu, dwd = (torch.empty_like(w) for w in (w_norm, w_gate, w_up, w_down))
    n = torch.empty((N, D), dtype=dt, device=dev)
    rr = torch.empty(N, dtype=torch.float32, device=dev)
    dgpre, dup, y = (torch.empty((N, F), dtype=dt, device=dev) for _ in range(3))
    dn = torch.empty((N, D), dtype=torch.float32, device=dev)
    parts = torch.empty((-(-N // MLP_DH_ROWS), D), dtype=torch.float32, device=dev)
    _launch(name, g.data_ptr(), residual.data_ptr(), x.data_ptr(), w_norm.data_ptr(),
            w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), dh.data_ptr(),
            dwn.data_ptr(), dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(), n.data_ptr(),
            rr.data_ptr(), dgpre.data_ptr(), dup.data_ptr(), y.data_ptr(), dn.data_ptr(),
            parts.data_ptr(), N, D, F, ACTIVATIONS[act], float(eps), _DTYPE_CODES[dt],
            dev.index, _stream(x))
    return dh, dwn, dwg, dwu, dwd


# geometry of csrc/decode_layer.cuh: KEYS (attention keys per chunk, about),
# ACT_BYTES (staged activation rows) and the block's shared-memory ceiling
DECODE_KEYS = 128
DECODE_ACT_BYTES = 64 * 1024
_SMEM_MAX = 232448


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _decode_dims(name, h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                 lengths, write_pos):
    """(S, D, H, KV, hd, P, ps, npg) of the decode kernel's operands; raises
    where ``_attn_subblock_checker`` (pallasex.py:1761) refuses and where the
    kernel does not take the shapes."""
    dt = _float_dtype(name, h)
    if h.ndim != 3 or h.shape[1] != 1:
        raise ValueError(f"{name}: h {tuple(h.shape)} must be (S, 1, D): one row per slot, "
                         f"decode only")
    if k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pools {tuple(k_pages.shape)} / {tuple(v_pages.shape)} must "
                         f"be one (KV, P, ps, hd) shape")
    S, D = h.shape[0], h.shape[2]
    KV, P, ps, hd = k_pages.shape
    if hd % 16 or not 16 <= hd <= 128:
        raise ValueError(f"{name}: head dim {hd} must be a multiple of 16 up to 128")
    if wq.ndim != 2 or wq.shape[1] != D or wq.shape[0] % hd:
        raise ValueError(f"{name}: wq {tuple(wq.shape)} must be (H * {hd}, {D})")
    H = wq.shape[0] // hd
    if H % KV:
        raise ValueError(f"{name}: {H} heads over {KV} kv heads")
    want = {"w_norm": (D,), "wk": (KV * hd, D), "wv": (KV * hd, D), "wo": (D, H * hd),
            "cos": (S, 1, 1, hd // 2), "sin": (S, 1, 1, hd // 2)}
    for arg, t in zip(want, (w_norm, wk, wv, wo, cos, sin)):
        if tuple(t.shape) != want[arg]:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} where {want[arg]} is required")
    if D % 8:
        raise ValueError(f"{name}: D={D} must be a multiple of 8")
    floats = (h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages)
    if any(t.dtype != dt for t in floats):
        raise ValueError(f"{name}: dtypes {[str(t.dtype) for t in floats]} must all be {dt}")
    if (block_tables.ndim != 2 or block_tables.shape[0] != S or tuple(lengths.shape) != (S,)
            or tuple(write_pos.shape) != (S,)):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}, write_pos {tuple(write_pos.shape)} for {S} "
                         f"slots")
    _check(name, *floats, dtype=dt)
    _check(name, block_tables, lengths, dtype=torch.int32)
    if write_pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: write_pos dtype {write_pos.dtype} is not an integer type")
    if any(t.device != h.device for t in (block_tables, lengths, write_pos)):
        raise ValueError(f"{name}: block tables, lengths and write_pos must be on {h.device}")
    if any(t.data_ptr() % 16 for t in (h, w_norm, wq, wk, wv, wo, k_pages, v_pages)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    G, keys = H // KV, max(1, DECODE_KEYS // ps) * ps
    attn = _align16(G * hd * 4) + _align16(G * keys * 4) + 2 * _align16(keys * 8)
    if max(DECODE_ACT_BYTES, attn) + _align16(S * 4) > _SMEM_MAX:
        raise ValueError(f"{name}: {G} grouped heads of {hd} over {keys}-key chunks need more "
                         f"shared memory than a block has")
    return S, D, H, KV, hd, P, ps, block_tables.shape[1]


def _decode_call(name, h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                 lengths, write_pos, mlp, act, eps, scale):
    S, D, H, KV, hd, P, ps, npg = _decode_dims(name, h, w_norm, wq, wk, wv, wo, cos, sin,
                                               k_pages, v_pages, block_tables, lengths,
                                               write_pos)
    dev, dt = h.device, h.dtype
    chunk_pages = max(1, DECODE_KEYS // ps)
    nch = -(-npg // chunk_pages)
    out = torch.empty_like(h)
    k_rows, v_rows = (torch.empty((KV, S, hd), dtype=dt, device=dev) for _ in range(2))
    q_ws = torch.empty((S, H, hd), dtype=dt, device=dev)
    part = torch.empty((S, KV, nch, H // KV, 2 + hd), dtype=torch.float32, device=dev)
    attn_ws = torch.empty((S, H * hd), dtype=dt, device=dev)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(hd)
    ins = [t.data_ptr() for t in (h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                                  block_tables, lengths)]
    tail = (float(eps), scale, _DTYPE_CODES[dt], dev.index, _stream(h))
    if mlp is None:
        _launch(name, *ins, out.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
                q_ws.data_ptr(), part.data_ptr(), attn_ws.data_ptr(), S, D, H, KV, hd, P, ps,
                npg, chunk_pages, nch, *tail)
        return out, k_rows, v_rows
    F = mlp[1].shape[0]
    hacc = torch.empty((S, D), dtype=torch.float32, device=dev)
    y_ws = torch.empty((S, F), dtype=dt, device=dev)
    _launch(name, *ins, *(t.data_ptr() for t in mlp), out.data_ptr(), k_rows.data_ptr(),
            v_rows.data_ptr(), q_ws.data_ptr(), part.data_ptr(), attn_ws.data_ptr(),
            hacc.data_ptr(), y_ws.data_ptr(), S, D, H, KV, hd, P, ps, npg, F, chunk_pages, nch,
            ACTIVATIONS[act], *tail)
    return out, k_rows, v_rows


def attn_subblock(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
                  write_pos, eps: float = 1e-5, scale: float | None = None):
    """The decode attention sub-block in ONE cooperative launch: ``(out,
    k_rows, v_rows)`` with ``out`` (S, 1, D) the out-projection before the
    residual add and this step's k/v rows (KV, S, hd). The pools are only
    read, position ``lengths - 1`` taken from the fresh rows; ``write_pos``
    is checked, and the caller stores the rows there. q, the attention
    chunks' partials and the merged heads are scratch."""
    return _decode_call("attn_subblock", h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                        block_tables, lengths, write_pos, None, "silu", eps, scale)


def decode_layer(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                 lengths, write_pos, mlp_norm, w_gate, w_up, w_down, act: str = "silu",
                 eps: float = 1e-5, scale: float | None = None):
    """The whole T == 1 decode layer in ONE cooperative launch: ``(out,
    k_rows, v_rows)``, as :func:`attn_subblock` plus the residual add and the
    MLP sub-block on the float32 residual; ``w_gate``, ``w_up`` (F, D),
    ``w_down`` (D, F). Raises where ``_decode_layer_checker``
    (pallasex.py:1817) refuses, where the kernel does not take the shapes,
    and where the card refuses the launch."""
    name = "decode_layer"
    if act not in ACTIVATIONS:
        raise ValueError(f"{name}: unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")
    D = h.shape[-1]
    F = w_gate.shape[0] if w_gate.ndim == 2 else -1
    if (tuple(mlp_norm.shape) != (D,) or tuple(w_gate.shape) != (F, D)
            or tuple(w_up.shape) != (F, D) or tuple(w_down.shape) != (D, F)):
        raise ValueError(f"{name}: mlp_norm {tuple(mlp_norm.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)}: want (D,), (F, D), (F, D), (D, F)")
    if F % 8:
        raise ValueError(f"{name}: F={F} must be a multiple of 8")
    if any(t.dtype != h.dtype for t in (mlp_norm, w_gate, w_up, w_down)):
        raise ValueError(f"{name}: the MLP weights' dtype must be h's, {h.dtype}")
    _check(name, h, mlp_norm, w_gate, w_up, w_down, dtype=_float_dtype(name, h))
    if any(t.data_ptr() % 16 for t in (mlp_norm, w_gate, w_up, w_down)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return _decode_call(name, h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                        block_tables, lengths, write_pos, (mlp_norm, w_gate, w_up, w_down), act,
                        eps, scale)
