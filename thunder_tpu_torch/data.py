"""Training input pipeline and sequence-length bucketing, the counterpart of
``thunder_tpu/data.py``: ``TokenDataset`` (:103), ``ShardedTokenStream``
(:159), ``write_token_file`` (:256), ``LengthBucketer`` (:265) and
``default_buckets`` (:323).

The token file is a raw little-endian array of uint16 (or, with
``dtype_bytes=4``, uint32) tokens. The port keeps its own copy of the
reference's C++ loader (``native/dataloader.cpp``: mmap, counter-based
sampling, the epoch-exact Feistel shuffle, a prefetch thread), built with
``g++`` at first use into ``thunder_tpu_torch/_build/`` and bound with
``ctypes``. Its plain version is Python: the same splitmix and Feistel
arithmetic over a ``numpy.memmap``, bit-exact with the native path (and,
unlike the reference's numpy fallback of ``TokenDataset.sample``, drawing
the same windows).

``native`` picks the path: ``None`` takes the native loader where it
builds and the Python one otherwise (the reference's rule); ``True``
requires the native loader and raises when it does not build; ``False``
takes the Python path. ``stream_path()`` says which path a reader takes.

The serving scheduler pads each prefill chunk to a rung of a small ladder of
lengths (:class:`LengthBucketer`). Under PyTorch's eager execution nothing is
compiled per shape; the ladder still sets the chunk sizes, and with them the
pages a chunk claims, so the port schedules exactly as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
NATIVE_SRC = _PKG / "native" / "dataloader.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lib_lock = threading.Lock()
_lib = None
_lib_error: Exception | None = None


def build_native() -> Path:
    """Compile the loader (or find it already built) into ``_build/``, named
    by a hash of its source and flags. Raises ``RuntimeError`` when there is
    no ``g++`` or the source does not compile."""
    key = hashlib.sha256(" ".join(GXX_FLAGS).encode() + NATIVE_SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libttdata-{key}.so"
    if lib.exists():
        return lib
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found: the native token loader is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"building the native token loader failed:\n{p.stderr[-2000:]}")
    os.replace(tmp, lib)
    return lib


def native_lib():
    """The bound native loader, built at first use. Raises ``RuntimeError``
    when it cannot be built or loaded (the same error on every later call)."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is None and _lib_error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build_native())))
            except (RuntimeError, OSError) as e:
                _lib_error = e
        if _lib_error is not None:
            raise RuntimeError(f"native token loader unavailable: {_lib_error}") from _lib_error
        return _lib


def _bind(lib):
    u64, i, ll, vp = ctypes.c_uint64, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    out = ctypes.POINTER(ctypes.c_uint32)
    for name, res, args in (
            ("ttdata_open", vp, [ctypes.c_char_p, i]),
            ("ttdata_close", None, [vp]),
            ("ttdata_num_tokens", ll, [vp]),
            ("ttdata_sample_batch", i, [vp, u64, u64, i, i, out]),
            ("ttdata_num_windows", ll, [vp, i]),
            ("ttdata_epoch_batch", ll, [vp, u64, u64, i, i, i, i, out]),
            ("ttdata_prefetch_submit", i, [vp, u64, u64, i, i, i, i, i]),
            ("ttdata_prefetch_wait", i, [vp, u64, i, out])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _open_lib(native: bool | None):
    if native is False:
        return None
    try:
        return native_lib()
    except RuntimeError:
        if native:
            raise
        return None


# -- the plain version: Python mirrors of the loader's splitmix and Feistel
#    permutation (bit-exact; keep in sync with native/dataloader.cpp) --------

_M64 = (1 << 64) - 1


def _mix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _feistel_perm(idx: int, n: int, key: int) -> int:
    bits = 1
    while (1 << bits) < n:
        bits += 1
    hb = (bits + 1) // 2
    hmask = (1 << hb) - 1
    x = idx
    while True:
        left, right = x >> hb, x & hmask
        for rnd in range(4):
            f = _mix(right ^ key ^ ((rnd * 0xA5A5A5A5) & _M64)) & hmask
            left, right = right, (left ^ f) & hmask
        x = (left << hb) | right
        if x < n:
            return x


class TokenDataset:
    """Random-window sampler over a token file.

    ``sample(step)`` returns (tokens, targets) int32 arrays of shape
    (batch, seq): ``batch`` windows of ``seq + 1`` tokens whose starts are a
    counter-based function of (seed, step, row), deterministic and the same
    on both paths."""

    def __init__(self, path: str, batch: int, seq: int, *, seed: int = 0, dtype_bytes: int = 2,
                 native: bool | None = None):
        self.path = str(path)
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.dtype_bytes = dtype_bytes
        self._lib = _open_lib(native)
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.ttdata_open(self.path.encode(), dtype_bytes)
            if not self._handle:
                raise OSError(f"ttdata_open could not map {self.path}")
        else:
            self._mm = np.memmap(self.path, dtype=np.uint16 if dtype_bytes == 2 else np.uint32,
                                 mode="r")
        self._buf = np.empty((batch, seq + 1), np.uint32)

    def stream_path(self) -> str:
        """``"native"`` (the C++ loader) or ``"python"`` (its plain version)."""
        return "native" if self._lib is not None else "python"

    @property
    def num_tokens(self) -> int:
        if self._lib is not None:
            return int(self._lib.ttdata_num_tokens(self._handle))
        return int(self._mm.shape[0])

    def _ptr(self, buf):
        return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))

    def sample(self, step: int):
        window = self.seq + 1
        n = self.num_tokens
        if self._lib is not None:
            rc = self._lib.ttdata_sample_batch(self._handle, self.seed, step, self.batch,
                                               self.seq, self._ptr(self._buf))
            if rc != 0:
                raise RuntimeError("ttdata_sample_batch failed (shard shorter than seq+1?)")
        else:
            if n < window:
                raise RuntimeError("sample failed: shard shorter than seq+1")
            base = _mix((self.seed ^ ((step * 0x51ED2701) & _M64)) & _M64)
            for i in range(self.batch):
                start = _mix(base ^ i) % (n - window + 1)
                self._buf[i] = self._mm[start:start + window]
        return self._buf[:, :-1].astype(np.int32), self._buf[:, 1:].astype(np.int32)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.ttdata_close(self._handle)
            self._handle = None


class ShardedTokenStream:
    """Epoch-exact, restart-deterministic input pipeline over a token file.

    - **Epochs + shuffle**: the file is cut into non-overlapping
      ``seq+1``-token windows visited in a keyed Feistel permutation (a full
      shuffle with O(1) state); each epoch re-keys the permutation.
      ``batch_at(step)`` is a pure function of ``step``, so a run resumed at
      step k replays exactly.
    - **Multi-host sharding**: host ``host`` of ``n_hosts`` draws global
      sample ``step * batch * n_hosts + host * batch + i``: the hosts'
      windows are disjoint and together cover each epoch exactly once.
    - **Prefetch**: on the native path a C++ thread fills batch ``step + 1``
      while the card runs step ``step``.
    """

    def __init__(self, path: str, batch: int, seq: int, *, seed: int = 0, host: int = 0,
                 n_hosts: int = 1, dtype_bytes: int = 2, prefetch: bool = True,
                 native: bool | None = None):
        self._ds = TokenDataset(path, batch, seq, seed=seed, dtype_bytes=dtype_bytes,
                                native=native)
        if self._ds.num_tokens < seq + 1:
            raise ValueError(f"shard has {self._ds.num_tokens} tokens; "
                             f"need at least seq+1={seq + 1}")
        if not (0 <= host < n_hosts):
            raise ValueError(f"host {host} out of range for n_hosts {n_hosts}")
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.host = host
        self.n_hosts = n_hosts
        self.prefetch = prefetch and self._ds._lib is not None
        self._buf = np.empty((batch, seq + 1), np.uint32)
        self._submitted: int | None = None

    def stream_path(self) -> str:
        """``"native"`` (the C++ loader) or ``"python"`` (its plain version)."""
        return self._ds.stream_path()

    @property
    def n_windows(self) -> int:
        return self._ds.num_tokens // (self.seq + 1)

    def steps_per_epoch(self) -> int:
        """Global steps to cover one epoch (across all hosts); the final
        step of an epoch may spill its tail samples into the next epoch."""
        per_step = self.batch * self.n_hosts
        return max(1, (self.n_windows + per_step - 1) // per_step)

    def epoch_of(self, step: int) -> int:
        return (step * self.batch * self.n_hosts + self.host * self.batch) // self.n_windows

    def _fill_native(self, step: int) -> None:
        lib, ds = self._ds._lib, self._ds
        ptr = ds._ptr(self._buf)
        got = -2
        if self._submitted is not None:
            # -2 (after joining the worker) when the buffered batch is for
            # another step than the one asked for
            got = lib.ttdata_prefetch_wait(ds._handle, step, 1, ptr)
            self._submitted = None
        if got == -2:
            if lib.ttdata_epoch_batch(ds._handle, self.seed, step, self.batch, self.seq,
                                      self.host, self.n_hosts, ptr) < 0:
                raise RuntimeError("ttdata_epoch_batch failed")
        elif got != 0:
            raise RuntimeError("prefetched batch fill failed")
        if self.prefetch:
            lib.ttdata_prefetch_submit(ds._handle, self.seed, step + 1, self.batch, self.seq,
                                       self.host, self.n_hosts, 1)
            self._submitted = step + 1

    def _fill_python(self, step: int) -> None:
        nw = self.n_windows
        window = self.seq + 1
        for i in range(self.batch):
            g = step * self.batch * self.n_hosts + self.host * self.batch + i
            epoch, pos = divmod(g, nw)
            w = _feistel_perm(pos, nw, _mix((self.seed & _M64) ^ _mix(epoch)))
            self._buf[i] = self._ds._mm[w * window:(w + 1) * window]

    def batch_at(self, step: int):
        """(tokens, targets) int32 (batch, seq), a pure function of ``step``."""
        if self._ds._lib is not None:
            self._fill_native(step)
        else:
            self._fill_python(step)
        return self._buf[:, :-1].astype(np.int32), self._buf[:, 1:].astype(np.int32)

    __call__ = batch_at   # a data_fn(step)


def write_token_file(path: str, tokens: np.ndarray, dtype_bytes: int = 2) -> None:
    np.asarray(tokens, dtype=np.uint16 if dtype_bytes == 2 else np.uint32).tofile(path)


class LengthBucketer:
    """Maps a length to the smallest bucket that holds it.

    >>> b = LengthBucketer([128, 512, 2048])
    >>> b.bucket_for(300)
    512
    """

    def __init__(self, buckets):
        bs = sorted(int(b) for b in buckets)
        if not bs:
            raise ValueError("need at least one bucket length")
        self.buckets = bs

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(
            f"sequence length {length} exceeds the largest bucket "
            f"{self.buckets[-1]}; add a bucket or truncate upstream")


def default_buckets(max_len: int, *, factor: int = 2, align: int = 128):
    """Power-of-``factor`` ladder of ``align``-aligned bucket lengths up to
    ``max_len``, the reference's ladder."""
    out = []
    b = align
    while b < max_len:
        out.append(b)
        b *= factor
    out.append(((max_len + align - 1) // align) * align)
    return out
