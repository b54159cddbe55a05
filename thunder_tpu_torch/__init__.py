"""thunder_tpu_torch — the PyTorch/CUDA port of thunder_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout and names, so each module's counterpart
is found at the same path under ``thunder_tpu/``. It imports neither JAX nor
anything of ``thunder_tpu``. Ported: serving at the reference's per-op
and planned rungs, the single-device train step at its per-op and planned
rungs with its input pipeline, checkpoints and gradient clipping, the
reference's headline train bench, the runtime-safety layer, the
single-card serving fleet and the model zoo:

- :mod:`thunder_tpu_torch.serving` — ``ServingEngine`` (continuous batching
  over a paged KV cache; its decode and prefill steps are :func:`jit`
  programs), on ``cuda`` unless ``device="cpu"`` is passed;
- :mod:`thunder_tpu_torch.benchmarks.pretrain` — the single-device train
  step (``loss_fn``, its gradients, :class:`thunder_tpu_torch.optim.AdamW`),
  compiled by ``jit(train_step, donate_argnums=(0, 1))`` as the
  reference's, per-op or, with ``block_fusion=True``, planned (the eager
  ``train_step`` stays, the bench's baseline arm);
- :mod:`thunder_tpu_torch.benchmarks.bench` — the headline bench's compiled
  step (``fused_loss_fn``, ``remat``, ``AdamW(slab_persistent=True)``) at
  ``llama2-7b-bench`` width, its guarded arm and its eager baseline arm;
- :mod:`thunder_tpu_torch.data` — the token file's ``ShardedTokenStream``
  and ``TokenDataset`` (a C++ loader built at first use, with a bit-exact
  Python twin), ``write_token_file``, ``LengthBucketer`` and
  ``default_buckets``; ``pretrain.run(data=...)`` trains from it;
- :mod:`thunder_tpu_torch.checkpoint` — ``save_checkpoint`` (sync or
  asynchronous), ``wait_for_checkpoints`` and ``load_checkpoint``;
- :mod:`thunder_tpu_torch.optim` — ``AdamW``, ``SGD`` and ``clip_grad_norm``;
- :mod:`thunder_tpu_torch.core.rematerialization` — ``checkpoint``;
- :mod:`thunder_tpu_torch.models.llama` — configs, ``init_params``,
  ``params_from_jax``, the training forward and loss;
- the model zoo — :mod:`thunder_tpu_torch.models.mixtral` (top-k routed
  experts), :mod:`~thunder_tpu_torch.models.gpt` (the multi-family GPT),
  :mod:`~thunder_tpu_torch.models.nanogpt`,
  :mod:`~thunder_tpu_torch.models.seq2seq` and
  :mod:`~thunder_tpu_torch.models.resnet`, trained by
  :mod:`thunder_tpu_torch.benchmarks.zoo`;
- :mod:`thunder_tpu_torch.ops.nn` and :mod:`thunder_tpu_torch.ops.optim` —
  the slices' functions, each with its plain version, and their gradients;
- :mod:`thunder_tpu_torch.executors.cudaex` — the hand-written ``sm_90a``
  kernels (``rms_norm``, ``rms_norm_residual``, ``linear_act``,
  ``paged_decode_attention``, ``sdpa_fwd``, ``sdpa_bwd``, ``ce_fwd``,
  ``fused_adamw``, ``fused_adamw_slab`` and their health passes,
  ``mlp_subblock``, ``mlp_subblock_bwd``, ``decode_layer``,
  ``attn_subblock``), built from ``csrc/`` at first use;
  ``refusal(name, ...)`` says why one does not take its arguments;
- :mod:`thunder_tpu_torch.observe` — the metric registry and the flight
  ring;
- :mod:`thunder_tpu_torch.runtime` — fault injection (``FaultPlan``), retry
  policies and ``RestartBudget``, the kernel quarantine the routers of
  ``ops/`` read, and the numerics sentinel;
- :mod:`thunder_tpu_torch.transforms.numerics_guard` —
  ``NumericsGuardTransform``, the guard of a compiled train step
  (``jit(step, transforms=[...])``, ``pretrain.run(guard=...)``), and
  ``NumericsGuard``, the eager step's;
- the trace compiler: :func:`jit` traces a PyTorch function or an
  ``nn.Module`` into printable, executable traces (:func:`last_traces`),
  runs DCE, CSE and the block, horizontal, epilogue and optimizer passes
  under an H100 cost model (:mod:`thunder_tpu_torch.core.cost_model`;
  ``jit(f, block_fusion=..., ...)``, :func:`last_compile_options`, the
  decision log), and hands ``rms_norm``, ``rms_norm_residual``,
  ``linear_act``, the MLP sub-block forward and backward, attention forward
  and backward, cross-entropy and the multi-tensor AdamW of CUDA tensors to
  the kernels (and, in a guarded step, each optimizer bucket's health pass
  and gated update; :mod:`thunder_tpu_torch.executors.cudaex_claims`);
  every other prim runs as one torch call. ``jit(transforms=)`` applies the
  reference's :class:`Transform` hooks. :func:`value_and_grad` and
  :func:`grad` differentiate inside a traced function (trace-level autograd,
  :mod:`thunder_tpu_torch.core.transforms`), :func:`activation_checkpoint`
  (``core.rematerialization.checkpoint``; the reference's
  ``thunder_tpu.checkpoint``, renamed because :mod:`thunder_tpu_torch.checkpoint`
  is the save/load module) makes a trace-level rematerialized region,
  and ``jit(..., donate_argnums=)`` lets the optimizer write its donated
  inputs in place, so a whole train step
  (``benchmarks.pretrain.jit_train_step``) compiles into one trace;
  ``jit(module)`` (``ThunderModule``) and a ``jit`` function called on
  tensors that require grad train through the torch-autograd bridge
  (:func:`forward_and_backward_from_trace` splits the trace into a forward
  and a backward program; ``loss.backward()`` runs the second), and
  :func:`rematerialize_forward_and_backward` is the reference's min-cut
  over such a pair. On the card each cached entry replays one CUDA graph
  (``whole_program_jit``, :mod:`thunder_tpu_torch.executors.cudagraphex`),
  the reference's whole-program compile.
"""

from thunder_tpu_torch.devices import resolve_device  # noqa: F401


# ---------------------------------------------------------------------------
# the trace compiler's entry point, jit (the counterpart of thunder_tpu/__init__.py)
# ---------------------------------------------------------------------------

import time as _time  # noqa: E402
from contextlib import contextmanager as _contextmanager  # noqa: E402
from numbers import Number as _Number  # noqa: E402
from typing import Callable as _Callable, Sequence as _Sequence  # noqa: E402

import torch as _torch  # noqa: E402

from thunder_tpu_torch.core import devices as _devices  # noqa: E402
from thunder_tpu_torch.core import prims as _prims  # noqa: E402
from thunder_tpu_torch.core.baseutils import check as _check  # noqa: E402
from thunder_tpu_torch.core.proxies import (  # noqa: E402
    NumberProxy as _NumberProxy,
    StringProxy as _StringProxy,
    TensorProxy as _TensorProxy,
)
from thunder_tpu_torch.core.pytree import leaf_positions as _leaf_positions  # noqa: E402
from thunder_tpu_torch.core.pytree import tree_flatten as _tree_flatten  # noqa: E402
from thunder_tpu_torch.core.pytree import tree_unflatten as _tree_unflatten  # noqa: E402
from thunder_tpu_torch.core.rematerialization import (  # noqa: E402, F401
    checkpoint as activation_checkpoint, rematerialize_forward_and_backward)
from thunder_tpu_torch.core.trace import TraceCtx, tracectx as _tracectx  # noqa: E402
from thunder_tpu_torch.core.trace import copy_trace as _copy_trace  # noqa: E402
from thunder_tpu_torch.core.transform_common import Transform, cse, dce  # noqa: E402, F401
from thunder_tpu_torch.core.transforms import forward_and_backward_from_trace  # noqa: E402, F401
from thunder_tpu_torch.observe import registry as _observe  # noqa: E402
from thunder_tpu_torch.runtime import faults as _faults  # noqa: E402
from thunder_tpu_torch.runtime import quarantine as _quarantine  # noqa: E402
from thunder_tpu_torch.runtime import retry as _retry  # noqa: E402
from thunder_tpu_torch.runtime import sentinel as _sentinel  # noqa: E402
from thunder_tpu_torch.runtime.faults import KernelExecutionError  # noqa: E402


class CompileStats:
    """Cache counters, the last compile's traces, its stage times, and its
    decision log (``last_decisions``: every claim, rejection and fusion
    verdict with its cost numbers, :mod:`thunder_tpu_torch.observe.decisions`).
    The whole-program replay's counters: ``last_whole_program`` (how the
    last compiled entry runs: ``"graph"``, or ``"per-call (<why>)"``), its
    graphs' captures, recaptures and replays, and the bytes copied into
    their input buffers (:mod:`thunder_tpu_torch.executors.cudagraphex`)."""

    def __init__(self):
        self.cache_hits = 0
        self.cache_misses = 0
        self.last_traces: list[TraceCtx] = []
        self.last_prologue_traces: list[TraceCtx] = []
        self.last_pass_times: dict[str, float] = {}
        self.last_decisions: list[dict] = []
        self.last_entry: CacheEntry | None = None
        self.last_whole_program: str | None = None
        self.whole_program_captures = 0
        self.whole_program_recaptures = 0
        self.whole_program_replays = 0
        self.whole_program_copied_bytes = 0

    def summary(self) -> str:
        lines = [f"cache: {self.cache_misses} miss(es), {self.cache_hits} hit(s)"]
        if self.last_whole_program is not None:
            lines.append(f"whole program: {self.last_whole_program}; "
                         f"{self.whole_program_captures} capture(s) "
                         f"({self.whole_program_recaptures} again), "
                         f"{self.whole_program_replays} replay(s), "
                         f"{self.whole_program_copied_bytes} bytes copied in")
        for name, ms in self.last_pass_times.items():
            lines.append(f"  {name}: {ms:.2f} ms")
        if self.last_decisions:
            lines.append(f"decisions recorded: {len(self.last_decisions)} "
                         f"(CompileStats.last_decisions)")
        return "\n".join(lines)

    def __repr__(self):
        return f"<CompileStats\n{self.summary()}\n>"


class CacheEntry:
    # writes_donated: the program writes donated inputs in place (written:
    # their positions among the tensor inputs); graph: the entry's CUDA
    # graph (cudagraphex.WholeProgram), or None for the generated program per
    # call; whole_program: "graph" or "per-call (<why>)"; run_fn: what a call
    # runs, the graph or the program inside the transforms' wrappers
    __slots__ = ("computation_fn", "tensor_indices", "traces", "prologue_trace", "prologue_fn",
                 "writes_donated", "written", "graph", "whole_program", "run_fn")

    def __init__(self, computation_fn, tensor_indices, traces, prologue_trace, prologue_fn,
                 writes_donated: bool = False):
        self.computation_fn = computation_fn
        self.tensor_indices = tensor_indices
        self.traces = traces
        self.prologue_trace = prologue_trace
        self.prologue_fn = prologue_fn
        self.writes_donated = writes_donated
        self.written: frozenset[int] = frozenset()
        self.graph = None
        self.whole_program = "per-call"
        self.run_fn = _program_of(self)


def _program_of(entry: CacheEntry) -> _Callable:
    """A call of the entry's graph, or of its program where it has none (read
    at each call)."""
    def program(*inps):
        return (entry.graph or entry.computation_fn)(*inps)

    return program


def _is_tensorlike(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype") and not isinstance(x, _TensorProxy)


def _leaf_key(leaf):
    if isinstance(leaf, _torch.Tensor):
        return ("T", tuple(leaf.shape), leaf.dtype, leaf.device)
    if isinstance(leaf, bool):
        return ("B", leaf)
    if isinstance(leaf, _Number):
        return ("N", type(leaf).__name__, leaf)
    if isinstance(leaf, str):
        return ("S", leaf)
    return ("O", type(leaf).__name__)


@_contextmanager
def _stage(pass_times: dict, name: str):
    """Time one compile stage into ``pass_times`` (ms), under its span."""
    t0 = _time.perf_counter_ns()
    with _observe.span(name):
        yield
    pass_times[name] = pass_times.get(name, 0.0) + (_time.perf_counter_ns() - t0) / 1e6


def execution_pipeline(trc: TraceCtx, executors, device, pass_times: dict,
                       donated_names=frozenset(), transforms: _Sequence = ()
                       ) -> tuple[list[TraceCtx], _Callable, bool]:
    """The pipeline every generated program goes through: DCE, CSE, the
    epilogue and claim passes (``transform_for_execution``), the
    ``transforms``' post-optimization hooks, the in-place writes of donated
    inputs, ``del`` insertion, and codegen. Each stage's ms add into
    ``pass_times``. Returns the traces stage by stage (the traced program,
    DCE, CSE, the execution trace, with ``del``s), the generated callable,
    and the names of the donated inputs it writes in place."""
    from thunder_tpu_torch.executors.passes import (
        del_last_used, donate_in_place, transform_for_execution)

    traces = [trc]
    with _stage(pass_times, "dce+cse"):
        trc = dce(trc)
        traces.append(trc)
        trc = dce(cse(trc))
        trc.set_provenance("Common subexpression elimination")
        traces.append(trc)
    with _stage(pass_times, "transform_for_execution"), _devices.using_device(device):
        exec_trc = transform_for_execution(trc, executors)
        for tr in transforms:
            exec_trc = tr.transform_trace_post_optimization(exec_trc)
        exec_trc, written = donate_in_place(exec_trc, set(donated_names))
    traces.append(exec_trc)
    with _stage(pass_times, "del_last_used"):
        exec_trc = del_last_used(exec_trc)
    traces.append(exec_trc)
    with _stage(pass_times, "codegen"):
        fn = exec_trc.python_callable()
    return traces, fn, written


def run_contained(fn: _Callable, inps, note: str | None = None, contained: bool = True):
    """Run a generated program under ``torch.no_grad()`` (a trace carries
    its own backward, so torch's autograd records nothing). A claimed kernel
    that fails with a degradable error is quarantined, and the call raises
    the fatal ``KernelExecutionError`` a rerun would end in: on the card a
    quarantined claim's router raises it, as the port runs no decomposition
    there. A fatal error (a sticky CUDA error leaves the context unusable; a
    claim already quarantined) quarantines nothing and propagates. ``note``
    is added to any error that escapes. ``contained=False`` leaves the
    degradable error to the caller, which quarantines and runs again on the
    rung below (the serving engine: its programs have one)."""
    try:
        try:
            with _torch.no_grad():
                return fn(*inps)
        except KernelExecutionError as err:
            if not contained or _retry.classify(err) != _retry.DEGRADABLE:
                raise
            _quarantine.get_quarantine().add(err.claim_id, reason=repr(err.__cause__ or err),
                                             phase=err.phase)
            raise KernelExecutionError(err.claim_id, _faults.QUARANTINED) from err
    except Exception as err:
        if note:
            err.add_note(note)
        raise


class ThunderTPUFunction:
    """The compiled-function wrapper :func:`jit` builds on (the torch front
    end's function wrapper and ``ThunderModule`` extend it).

    A call flattens its arguments, looks the entry up by the guard key
    (the tree structure, each leaf's shape, dtype and device or its constant
    value, the default device, the quarantine epoch and the suppressed
    claims, the active fault plan where it ``affects_compile()``, and the
    transforms), compiles on a miss and runs the entry's generated program
    under ``torch.no_grad()``: a trace carries its own backward
    (:func:`value_and_grad`), so torch's autograd records nothing (a call
    that torch's autograd must record goes through the torch-autograd
    bridge instead, :mod:`thunder_tpu_torch.torch.autograd_bridge`). numpy
    arrays are taken to the default device first; torch tensors run where
    they are. The tensor leaves of the positional arguments in
    ``donate_argnums`` are donated: the program may write them in place
    (the claimed ``fused_adamw`` updates donated parameters and moments
    where nothing later reads their old values), and after a call their
    old values are gone.

    ``transforms`` (each a
    :class:`~thunder_tpu_torch.core.transform_common.Transform`)
    rewrite each compile's traces at the reference's points and may wrap
    each entry's calls (``wrap_run_fn``; the first transform's wrapper
    outermost) and append runtime inputs to its signature, which their
    wrappers feed. A ``SilentNumericsFault`` raised through a guard's
    wrapper is bisected to the claimed kernels that cause it
    (:meth:`_bisect_and_rerun`)."""

    def __init__(self, fn: _Callable, *, executors=None, transforms: _Sequence = (),
                 device=None, fn_name: str | None = None,
                 donate_argnums: int | _Sequence[int] = (), **compile_options):
        from thunder_tpu_torch.executors import resolve_executors

        self.transforms = list(transforms)
        self.fn = fn
        self._graph_pool = None   # the GraphPool every CUDA graph of this function shares
        self.executors = resolve_executors(executors)
        self.compile_options = dict(compile_options)
        self._compile_ctx = None   # the last compile's CompileContext (the options report)
        self.device = _devices.to_device(device) if device is not None else None
        self.donate_argnums = ((donate_argnums,) if isinstance(donate_argnums, int)
                               else tuple(donate_argnums))
        self.fn_name = fn_name or getattr(fn, "__name__", "fn")
        self._cache: dict = {}
        self._stats = CompileStats()
        self.__name__ = f"thunder_tpu_torch.jit({self.fn_name})"

    # -- call ---------------------------------------------------------------
    def _default_device(self):
        return self.device if self.device is not None else _devices.default_device()

    def _flatten(self, args, kwargs):
        flat, treedef = _tree_flatten((args, kwargs))
        if any(not isinstance(x, _torch.Tensor) and _is_tensorlike(x) for x in flat):
            dev = self._default_device()
            flat = [_torch.as_tensor(x, device=dev)
                    if not isinstance(x, _torch.Tensor) and _is_tensorlike(x) else x
                    for x in flat]
        return flat, treedef

    def _entry_for(self, args, kwargs, extra: tuple = ()):
        """The cache entry of a call, compiled on a miss; ``extra`` joins the
        guard key (the alias pattern of a call through the torch front end)."""
        flat, treedef = self._flatten(args, kwargs)
        plan = _faults.active_plan()
        key = (treedef, _quarantine.epoch(), _quarantine.suppression_key(),
               id(plan) if plan is not None and plan.affects_compile() else None,
               self._default_device(),
               tuple(_leaf_key(x) for x in flat), tuple(id(t) for t in self.transforms), extra)
        entry = self._cache.get(key)
        if entry is None:
            self._stats.cache_misses += 1
            _observe.inc("cache.misses")
            _observe.event("cache_miss", fn=self.fn_name)
            entry = self._compile(flat, treedef, set(_leaf_positions(args, self.donate_argnums)))
            self._cache[key] = entry
        else:
            self._stats.cache_hits += 1
            _observe.inc("cache.hits")
        return entry, flat

    def compile(self, *args, **kwargs) -> CacheEntry:
        """Compile for these inputs without running; a later call with the
        same guard key hits the entry."""
        entry, _ = self._entry_for(args, kwargs)
        return entry

    def __call__(self, *args, **kwargs):
        entry, flat = self._entry_for(args, kwargs)
        return self._run_contained(entry, [flat[i] for i in entry.tensor_indices],
                                   call=(args, kwargs))

    def _run_contained(self, entry, inps, contained: bool = True, call=None):
        """Run an entry's program, or its CUDA graph, inside the transforms'
        wrappers (:func:`run_contained`). Where the program writes donated
        inputs in place, an error says that their values are undefined. A
        ``SilentNumericsFault`` from a guard's wrapper is bisected with the
        call's own ``(args, kwargs)``, ``call``."""
        note = None
        if entry.writes_donated:
            note = (f"{self.fn_name} writes its donated inputs (donate_argnums="
                    f"{self.donate_argnums}) in place: after a failure their values are "
                    f"undefined; restore them from a checkpoint, or jit without donation "
                    f"to keep them")
        if not self.transforms:
            return run_contained(entry.run_fn, inps, note=note, contained=contained)
        _sentinel.note_consumed([inps[i] for i in entry.written])
        try:
            return run_contained(entry.run_fn, inps, note=note, contained=contained)
        except _sentinel.SilentNumericsFault as err:
            if call is None:
                raise
            return self._bisect_and_rerun(err, *call)

    def _bisect_and_rerun(self, err, args, kwargs):
        """Silent-fault containment (the reference's ``_bisect_and_rerun``,
        ``thunder_tpu/__init__.py:481``): the numerics guard saw repeated
        non-finite steps. Each probe recompiles with a candidate group of
        the entry's claimed kernels suppressed (``quarantine.suppress``) and
        re-runs the same inputs under ``sentinel.probing()``; the offenders
        join the persisted quarantine and the step runs again. A call whose
        donated inputs were written in place cannot be re-run: that, a
        corruption no suppression removes, and a probe on the card (whose
        suppressed claim has no plain version to run) raise
        ``PersistentNonFinite``."""
        guard = getattr(err, "transform", None)
        if guard is None:   # raised outside a guard's wrapper: nothing to bisect
            raise err
        if not _sentinel.inputs_alive((args, kwargs)):
            raise _sentinel.PersistentNonFinite(
                f"persistent non-finite output of {self.fn_name}: the step's inputs were "
                f"donated (donate_argnums) and written in place, so in-process bisection "
                f"cannot replay them; recover from a checkpoint, or jit without donation "
                f"to enable bisection") from err
        sent = guard.sentinel
        seen: set[str] = set()
        while True:
            entry = getattr(err, "entry", None) or self._stats.last_entry
            exec_trc = entry.traces[-1] if entry is not None and entry.traces else None
            candidates = [] if exec_trc is None else \
                [c for c in _sentinel.claimed_kernel_ids(exec_trc) if c not in seen]
            if candidates:
                _observe.inc("runtime.bisections")
                _observe.event("bisection_started", fn=self.fn_name, candidates=len(candidates))

            def probe(disabled):
                with _quarantine.suppress(disabled):
                    self._cache.clear()
                    with sent.probing():
                        self(*args, **kwargs)
                return sent.last_verdict is not None and sent.last_verdict.healthy

            try:
                offenders = _sentinel.attribute_offenders(candidates, probe)
            except KernelExecutionError as e:
                if e.phase != _faults.QUARANTINED:
                    raise
                _observe.event("bisection_unattributed", fn=self.fn_name)
                raise _sentinel.PersistentNonFinite(
                    f"persistent non-finite output of {self.fn_name} cannot be bisected on "
                    f"the card ({e.claim_id} has no plain version to run there); "
                    f"candidates: {candidates}") from err
            finally:
                self._cache.clear()
            if not offenders:
                _observe.event("bisection_unattributed", fn=self.fn_name)
                raise _sentinel.PersistentNonFinite(
                    f"persistent non-finite output of {self.fn_name} could not be attributed "
                    f"to a claimed kernel ({len(candidates)} candidates probed)") from err
            for offender in offenders:
                seen.add(offender)
                _quarantine.get_quarantine().add(
                    offender, phase="numerics",
                    reason=f"silent numerics fault attributed by bisection ({err})")
                _observe.inc("runtime.fallbacks")
                _observe.event("bisection_attributed", fn=self.fn_name, claim=offender)
            sent.reset_episode()   # containment done: the re-run starts clean
            try:
                return self(*args, **kwargs)
            except _sentinel.SilentNumericsFault as e2:
                err = e2   # a second corrupt kernel: bisect the rest

    def bind(self, *args, contained: bool = True, **kwargs):
        """Compile for these inputs and return a callable bound to that one
        cache entry, which skips the guard key: the serving fast path. The
        caller owns revalidation: calling it with another tree structure,
        shapes, dtypes or devices than the binding inputs is undefined.
        ``contained=False``: see :func:`run_contained`."""
        entry, _ = self._entry_for(args, kwargs)
        tensor_indices = entry.tensor_indices

        def bound(*a, **k):
            fl, _ = self._flatten(a, k)
            return self._run_contained(entry, [fl[i] for i in tensor_indices], contained,
                                       call=(a, k))

        bound.entry = entry
        return bound

    # -- compilation --------------------------------------------------------
    def _trace(self, flat, treedef) -> tuple[TraceCtx, list[int]]:
        trc = TraceCtx("computation")
        tensor_indices: list[int] = []
        with _tracectx(trc), _devices.using_device(self._default_device()):
            proxies = []
            for i, leaf in enumerate(flat):
                if isinstance(leaf, _torch.Tensor):
                    proxies.append(_TensorProxy(shape=leaf.shape, dtype=leaf.dtype,
                                                device=leaf.device))
                    tensor_indices.append(i)
                else:
                    proxies.append(leaf)   # constant values: baked and guarded
            pargs, pkwargs = _tree_unflatten(treedef, proxies)
            result = self.fn(*pargs, **pkwargs)
            _prims.python_return(result)
        trc.args = [proxies[i] for i in tensor_indices]
        trc.output = result
        # the input structure with a proxy for every tensor leaf, for the
        # transforms (the numerics guard pairs state inputs with outputs)
        trc.input_proxies = list(proxies)
        trc.input_treedef = treedef
        trc.set_provenance("Tracing (torch function dispatch)")
        return trc, tensor_indices

    def _build_prologue(self, flat) -> TraceCtx:
        pro = TraceCtx("prologue")
        with _tracectx(pro):
            pro_proxies, returns = [], []
            for i, leaf in enumerate(flat):
                if isinstance(leaf, _torch.Tensor):
                    p = _TensorProxy(f"arg{i}", shape=leaf.shape, dtype=leaf.dtype,
                                     device=leaf.device)
                    _prims.check_tensor_shape_and_metadata(
                        p, tuple(p.shape), p.dtype, _devices.device_string(p.device))
                    returns.append(p)
                elif isinstance(leaf, _Number):
                    p = _NumberProxy(leaf, f"arg{i}")
                    _prims.check_number_type_and_value(p, leaf)
                elif isinstance(leaf, str):
                    p = _StringProxy(leaf, f"arg{i}")
                    _prims.check_string_value(p, leaf)
                else:
                    p = _NumberProxy(0, f"arg{i}", python_type=type(leaf))
                    _prims.check_literal_like(p, leaf)
                pro_proxies.append(p)
            _prims.python_return(tuple(returns))
        pro.args = pro_proxies
        pro.output = tuple(returns)
        pro.set_provenance("Prologue (input guards)")
        return pro

    @_contextmanager
    def compiling(self):
        """The context every compile of this function runs in: its compile
        options and executor stack (read by the passes, and by the block
        planner before autodiff), and a fresh decision log. Yields the log,
        which becomes ``CompileStats.last_decisions`` when the compile
        succeeds (a failed compile leaves the last one's)."""
        from thunder_tpu_torch.core.compile_data import CompileContext, compile_context
        from thunder_tpu_torch.observe import decisions as _decisions

        self._compile_ctx = CompileContext(self.compile_options, executors=self.executors)
        with compile_context(self._compile_ctx), _decisions.collect() as log:
            yield log
        self._stats.last_decisions = log

    def _compile(self, flat, treedef, donated: set[int] = frozenset()) -> CacheEntry:
        _faults.maybe_fail("compile", site=self.fn_name)
        pass_times: dict[str, float] = {}
        with self.compiling(), _observe.span("compile", args={"fn": self.fn_name}):
            entry = self._compile_instrumented(flat, treedef, pass_times, donated)
        self._stats.last_pass_times = pass_times
        _observe.inc("compile.count")
        return entry

    def _compile_instrumented(self, flat, treedef, pass_times, donated) -> CacheEntry:
        with _stage(pass_times, "trace"):
            trc, tensor_indices = self._trace(flat, treedef)
        traced = trc
        with _stage(pass_times, "prologue"):
            prologue = self._build_prologue(flat)
            if self.transforms:
                trc = _copy_trace(traced)   # the transforms rewrite a copy
            for tr in self.transforms:
                _, trc, _ = tr.transform_traces_pre_prologue(prologue, trc, None)
        donated_names = {p.name for i, p in zip(tensor_indices, trc.args) if i in donated}
        traces, computation_fn, written = execution_pipeline(
            trc, self.executors, self._default_device(), pass_times, donated_names,
            self.transforms)
        traces[0] = traced   # the program as traced, before the transforms (the reference's)
        with _stage(pass_times, "codegen"):
            prologue_fn = prologue.python_callable()
        prologue_fn(*flat)   # the guards hold on the inputs they were built from
        entry = CacheEntry(computation_fn, tensor_indices, traces, prologue, prologue_fn,
                           bool(written))
        entry.written = frozenset(j for j, p in enumerate(trc.args) if p.name in written)
        self._finalize_entry(entry, flat, traces[-1], entry.written)
        # the transforms' runtime wrappers, reversed so the first transform's
        # is outermost: wrappers append their extra inputs outermost first,
        # the order the transforms appended them to the trace's signature
        for tr in reversed(self.transforms):
            hook = getattr(tr, "wrap_run_fn", None)
            if hook is not None:
                entry.run_fn = hook(self, entry, entry.run_fn)
        self._stats.last_traces = traces
        self._stats.last_prologue_traces = [prologue]
        self._stats.last_entry = entry
        return entry

    def _finalize_entry(self, entry: CacheEntry, flat, exec_trc: TraceCtx,
                        written: frozenset[int]) -> None:
        """Whole-program replay, the counterpart of the reference's
        ``_finalize_entry`` (``thunder_tpu/__init__.py:813``), which compiles
        the execution trace as one XLA program: here the entry's calls
        replay one CUDA graph
        (:class:`~thunder_tpu_torch.executors.cudagraphex.WholeProgram`).
        Per call instead, as the reference keeps its per-region path: with
        ``whole_program_jit=False``, for inputs off the card (the option does
        nothing there), and for a trace holding a host-sync op (``item``),
        which needs a concrete value between launches. The verdict goes to
        the decision log and ``CompileStats.last_whole_program``."""
        from thunder_tpu_torch.core.compile_data import get_compile_option
        from thunder_tpu_torch.core.prims import OpTags
        from thunder_tpu_torch.observe import decisions as _decisions

        on = get_compile_option(
            "whole_program_jit",
            "run each cached entry on the card as one CUDA graph, captured at its second "
            "call and replayed after (the reference's whole-program compile); False runs "
            "the generated program per call", True)
        tensors = [flat[i] for i in entry.tensor_indices]
        why = None
        if not on:
            why = "whole_program_jit=False"
        elif not tensors or any(t.device.type != "cuda" for t in tensors):
            why = "inputs off the card"
        else:
            sync = next((b.sym.name for b in exec_trc.bound_symbols
                         if OpTags.DEVICE_SYNC_OP in b.sym.tags), None)
            if sync is not None:
                why = sync
        if why is None:
            from thunder_tpu_torch.executors.cudagraphex import GraphPool, WholeProgram

            if self._graph_pool is None:
                self._graph_pool = GraphPool()
            entry.graph = WholeProgram(entry, written, self._stats, self._graph_pool)
            entry.whole_program = "graph"
        else:
            entry.whole_program = f"per-call ({why})"
        self._stats.last_whole_program = entry.whole_program
        _decisions.record("whole_program", self.fn_name, None,
                          "graph" if why is None else "per-call", why or "")

    # -- introspection ------------------------------------------------------
    @property
    def cache_hits(self):
        return self._stats.cache_hits

    @property
    def cache_misses(self):
        return self._stats.cache_misses


def jit(fn=None, *, executors=None, **compile_options):
    """Compile a PyTorch function or ``nn.Module``: trace -> DCE/CSE -> the
    fusion passes (block, horizontal, epilogue, optimizer) -> the claim
    pass -> ``del`` insertion -> a generated Python program, cached by the
    guard key. ``device=`` sets the default device (``cuda`` unless given)
    for what has none of its own. ``donate_argnums=`` (the reference's
    option) donates the tensor leaves of those positional arguments: the
    program may update them in place. The executor stack is ``executors``
    (names or executors; default ``cuda``) closed by the always-on
    ``torch`` executor; a stack without ``cuda`` is refused for tensors on
    the card. Any other keyword is a free-form compile option the passes
    read by name (``block_fusion``, ``horizontal_fusion``,
    ``fused_optimizer``, ``epilogue_fusion``: True forces, False disables,
    unset asks the cost model,
    :mod:`thunder_tpu_torch.core.cost_model`); :func:`last_compile_options`
    reports which were read, and ``compile_stats(f).last_decisions`` every
    verdict with its cost numbers. Inside a differentiated function the
    block planner runs before autodiff, so a planned MLP sub-block trains
    through ``mlp_subblock`` and ``mlp_subblock_bwd``.
    The function is traced through the torch front end
    (:mod:`thunder_tpu_torch.torch`): torch, ``torch.nn.functional`` and
    tensor-method calls, the routers of ``ops/``, a user's
    ``torch.autograd.Function`` and ``torch.utils.checkpoint`` record ops.

    A call with grad enabled and an input that requires grad runs through
    the torch-autograd bridge: its outputs are tracked by torch's autograd,
    and ``loss.backward()`` runs the compiled backward
    (``torch_autograd=False`` opts out). An ``nn.Module`` gives a
    ``ThunderModule``: called, it traces the module with its parameters
    and buffers as inputs, read from the live module at every call, so an
    unmodified training loop (``loss = tm(x); loss.backward();
    opt.step()``) trains it through the claimed kernels."""
    if fn is None:
        return lambda f: jit(f, executors=executors, **compile_options)
    from thunder_tpu_torch.torch import jit as _torch_jit

    return _torch_jit(fn, executors=executors, **compile_options)


def value_and_grad(fn: _Callable, argnums=0, has_aux: bool = False) -> _Callable:
    """Trace-level VJP of the torch function ``fn``: called inside a
    function that :func:`jit` traces, it returns ``(value, grads)`` (grads
    shaped like ``args[argnums]``; ``((value, aux), grads)`` with
    ``has_aux``) and records the forward and the backward into that trace.
    Outside a trace it raises. The torch front end's adapters hand the
    proxy-level transform (``core.transforms.inline_value_and_grad``) the
    traced tensors and ``fn`` back its own."""
    from thunder_tpu_torch.core.transforms import inline_value_and_grad
    from thunder_tpu_torch.torch import on_proxies, on_torch

    return on_torch(inline_value_and_grad(on_proxies(fn), argnums=argnums, has_aux=has_aux))


def grad(fn: _Callable, argnums=0) -> _Callable:
    """The gradients of :func:`value_and_grad` alone."""
    vag = value_and_grad(fn, argnums=argnums)

    def grad_fn(*args, **kwargs):
        return vag(*args, **kwargs)[1]

    return grad_fn


def _as_tfn(x) -> ThunderTPUFunction:
    x = getattr(x, "_jfn", x)   # a ThunderModule: its grad-free program's function
    _check(isinstance(x, ThunderTPUFunction), "expected a thunder_tpu_torch.jit-compiled function")
    return x


def last_traces(jfn) -> list[TraceCtx]:
    """The last compile's computation traces, stage by stage: the traced
    program, DCE, CSE, the execution trace (claims), and with ``del``s."""
    return _as_tfn(jfn)._stats.last_traces


def last_execution_trace(jfn) -> TraceCtx:
    return _as_tfn(jfn)._stats.last_traces[-1]


def last_prologue_traces(jfn) -> list[TraceCtx]:
    return _as_tfn(jfn)._stats.last_prologue_traces


def cache_hits(jfn) -> int:
    return _as_tfn(jfn)._stats.cache_hits


def cache_misses(jfn) -> int:
    return _as_tfn(jfn)._stats.cache_misses


def compile_stats(jfn) -> CompileStats:
    return _as_tfn(jfn)._stats


def last_compile_options(jfn) -> str:
    """Which compile options the last compile read (with their
    descriptions) and which passed options nothing read."""
    from thunder_tpu_torch.core.compile_data import used_and_unused_options

    ctx = _as_tfn(jfn)._compile_ctx
    if ctx is None:
        return "no compilation has run yet"
    queried, unused = used_and_unused_options(ctx)
    lines = ["queried compile options:"]
    for name, desc in sorted(queried.items()):
        mark = "set" if name in ctx.options else "default"
        lines.append(f"  {name} [{mark}]: {desc}")
    if unused:
        lines.append("passed but never queried (possibly misspelled):")
        for name in sorted(unused):
            lines.append(f"  {name}")
    return "\n".join(lines)

