"""The torch-autograd bridge: ``loss.backward()`` through compiled traces.

The counterpart of ``thunder_tpu/torch/autograd_bridge.py``. The reference's
defining user experience is ``jit(model)`` followed by a stock PyTorch
training loop: a ``torch.autograd.Function`` holds the compiled backward,
and torch's autograd engine drives it.

A call is traced once per signature, with the module's parameters and
buffers and the call's tensors as inputs, and split by the trace-level VJP
(``core.transforms.forward_and_backward_from_trace``) into an augmented
forward that returns ``(outputs, saved_for_backward)`` and a backward that
takes ``(saved..., cotangents...)``. Each half goes through the pipeline of
every generated program (``thunder_tpu_torch.execution_pipeline``: DCE,
CSE, the epilogue and claim passes, ``del`` insertion), so both reach the
hand-written kernels: the forward's attention is ``sdpa_fwd`` (it keeps the
lse), the backward's ``sdpa_bwd``. Each runs under ``torch.no_grad()`` and
the quarantine handling of :func:`thunder_tpu_torch.run_contained`; tensors
pass straight through, with no copy. :class:`ThunderFunction` runs the
forward and returns its outputs to torch's autograd; its backward runs the
compiled backward and hands torch the gradients of the parameters and
inputs, which torch accumulates into ``.grad``, so ``torch.optim`` works
unchanged. The bridge never falls back to eager autograd: a compile or a
kernel that fails raises.
"""

from __future__ import annotations

import time

import torch

from thunder_tpu_torch import _leaf_key, execution_pipeline, run_contained
from thunder_tpu_torch.core import devices as _devices
from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
from thunder_tpu_torch.core.trace import TraceCtx, tracectx
from thunder_tpu_torch.core.transforms import forward_and_backward_from_trace
from thunder_tpu_torch.runtime import faults as _faults
from thunder_tpu_torch.runtime import quarantine as _quarantine


class CompiledAutogradStep:
    """One compiled (augmented forward, backward) pair for one signature.
    Trace inputs: the parameters (``named_parameters()`` order), the
    buffers, then the tensor leaves of ``(args, kwargs)``; the backward
    returns one gradient (or None) per trace input, in that order."""

    __slots__ = (
        "name", "fwd_fn", "bwd_fn", "fwd_traces", "bwd_traces", "computation_trace", "split",
        "n_params", "n_buffers", "tensor_arg_positions", "out_treedef", "out_tensor_slots",
        "out_float_slots", "ct_specs", "mutated_names", "compile_s", "pass_times",
    )

    @property
    def fwd_trace(self) -> TraceCtx:
        """The forward's execution trace (claims, ``del``s)."""
        return self.fwd_traces[-1]

    @property
    def bwd_trace(self) -> TraceCtx:
        return self.bwd_traces[-1]


def _finalize_step(step: CompiledAutogradStep, trc: TraceCtx, full_out, needs_grad: list,
                   executors, device, provenance: str, t0: float) -> CompiledAutogradStep:
    """The shared tail of both compilers: the output slots, the split (the
    backward computes the gradients of the inputs in ``needs_grad`` only),
    and each half through the execution pipeline."""
    trc.output = full_out
    trc.set_provenance(provenance)
    step.computation_trace = trc
    out_flat, step.out_treedef = tree_flatten(full_out)
    step.out_tensor_slots = [i for i, o in enumerate(out_flat) if isinstance(o, TensorProxy)]
    step.out_float_slots = [i for i in step.out_tensor_slots if out_flat[i].dtype.is_inexact]
    step.ct_specs = [(tuple(out_flat[i].shape), out_flat[i].dtype.torch,
                      torch.device(_devices.device_string(out_flat[i].device)))
                     for i in step.out_float_slots]
    fwd, bwd, _ = forward_and_backward_from_trace(trc, needs_grad)
    step.split = (fwd, bwd)
    step.pass_times = {"trace+split": (time.perf_counter() - t0) * 1e3}
    step.fwd_traces, step.fwd_fn, _ = execution_pipeline(fwd, executors, device,
                                                         step.pass_times)
    step.bwd_traces, step.bwd_fn, _ = execution_pipeline(bwd, executors, device,
                                                         step.pass_times)
    step.compile_s = time.perf_counter() - t0
    return step


def _tensor_proxy(t: torch.Tensor) -> TensorProxy:
    return TensorProxy(shape=t.shape, dtype=t.dtype, device=t.device)


def _grad_names(pairs) -> set[str]:
    """The names of the float proxies (of ``(proxy, tensor)`` pairs) whose
    tensors require grad: inside the trace, their ``requires_grad`` and that
    of what is computed from them reads True, as torch reports it under
    autograd, and the backward computes their gradients only."""
    return {p.name for p, t in pairs if t.requires_grad and p.dtype.is_inexact}


def _key(flat, treedef, device, extra=()) -> tuple:
    """The signature a compiled step is cached by: the tree, each tensor's
    shape, dtype, device and ``requires_grad``, each constant's value, the
    default device, the quarantine epoch and the active fault plan."""
    plan = _faults.active_plan()
    leaves = tuple(_leaf_key(x) + (x.requires_grad,) if isinstance(x, torch.Tensor)
                   else _leaf_key(x) for x in flat)
    return (treedef, leaves, device, _quarantine.epoch(),
            id(plan) if plan is not None else None, *extra)


def compile_autograd_step(tm, args: tuple, kwargs: dict,
                          arg_overlap=frozenset()) -> CompiledAutogradStep:
    """Trace ``tm``'s module over its state and the call's tensors, split
    the trace, and compile both halves."""
    from thunder_tpu_torch.torch import _route_tied, trace_torch_module

    t0 = time.perf_counter()
    module = tm._torch_module
    step = CompiledAutogradStep()
    step.name = tm._jfn.fn_name
    param_items, buffer_items = tm._state()
    step.n_params, step.n_buffers = len(param_items), len(buffer_items)
    flat, treedef = tree_flatten((args, kwargs))
    step.tensor_arg_positions = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]
    device = tm._jfn._default_device()

    trc = TraceCtx("computation")
    with tracectx(trc), _devices.using_device(device):
        pparams = {k: _tensor_proxy(t) for k, t in param_items}
        pbuffers = {k: _tensor_proxy(t) for k, t in buffer_items}
        pflat = list(flat)
        for i in step.tensor_arg_positions:
            pflat[i] = _tensor_proxy(flat[i])
        proxies = (list(pparams.values()) + list(pbuffers.values())
                   + [pflat[i] for i in step.tensor_arg_positions])
        tensors = ([t for _, t in param_items] + [t for _, t in buffer_items]
                   + [flat[i] for i in step.tensor_arg_positions])
        trc.grad_names = _grad_names(zip(proxies, tensors))
        _route_tied(tm._tied, pparams, pbuffers)
        pargs, pkwargs = tree_unflatten(treedef, pflat)
        prev = module.training
        module.train(tm._training)
        try:
            out, mutated = trace_torch_module(module, pparams, pbuffers, pargs, pkwargs,
                                              arg_overlap=arg_overlap)
        finally:
            module.train(prev)
        mutated_items = sorted(mutated.items())
        step.mutated_names = [k for k, _ in mutated_items]
        full_out = (out, tuple(v for _, v in mutated_items))
        prims.python_return(full_out)
    needs_grad = [p.name in trc.grad_names for p in proxies]
    trc.grad_names = None
    trc.args = proxies
    # the module's compile options and executors: the planner before the
    # split reads them, and the decision log lands in its stats
    with tm._jfn.compiling():
        return _finalize_step(step, trc, full_out, needs_grad, tm._jfn.executors, device,
                              "Tracing (torch-autograd bridge)", t0)


class ThunderFunction(torch.autograd.Function):
    """The reference's ``ThunderFunction``: ``forward`` runs the compiled
    augmented forward and saves what its backward reads; ``backward`` runs
    the compiled backward. The buffers ride along outside autograd."""

    @staticmethod
    def forward(ctx, step: CompiledAutogradStep, holder: dict, buffers: tuple, *tensors):
        n_p = step.n_params
        full_out, saved = run_contained(step.fwd_fn, [*tensors[:n_p], *buffers, *tensors[n_p:]])
        ctx.step = step
        ctx.save_for_backward(*saved)
        out_flat, _ = tree_flatten(full_out)
        holder["out_flat"] = out_flat
        # every tensor leaf of (output, mutated buffers) goes back, so
        # autograd tracks the float ones; integer leaves come back
        # non-differentiable
        outs = tuple(out_flat[i] for i in step.out_tensor_slots)
        check(len(outs) > 0, "the bridge's forward returned no tensor")
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        step: CompiledAutogradStep = ctx.step
        if step is None:
            raise RuntimeError(
                "thunder_tpu_torch bridge: backward through the same graph twice: the saved "
                "tensors were released after the first backward")
        ctx.step = None
        saved = ctx.saved_tensors
        # one cotangent per returned tensor; the backward takes one per float
        # output: an unused one (or a buffer nobody differentiated) is zeros
        by_slot = dict(zip(step.out_tensor_slots, cotangents))
        cts = []
        for slot, (shape, dtype, device) in zip(step.out_float_slots, step.ct_specs):
            ct = by_slot.get(slot)
            cts.append(ct if ct is not None else torch.zeros(shape, dtype=dtype, device=device))
        grads = run_contained(step.bwd_fn, [*saved, *cts])
        n_p, n_b = step.n_params, step.n_buffers
        # the parameters' and the inputs' gradients; none for the buffers
        return (None, None, None, *grads[:n_p], *grads[n_p + n_b:])


def _apply(step: CompiledAutogradStep, buffers: tuple, tensors: list):
    """Run ``step`` through :class:`ThunderFunction`; returns the output
    tree's two parts ``(user output, mutated buffer values)`` with the
    autograd-tracked tensors in place."""
    holder: dict = {}
    outs = ThunderFunction.apply(step, holder, buffers, *tensors)
    out_flat = list(holder.pop("out_flat"))
    for slot, t in zip(step.out_tensor_slots, outs):
        out_flat[slot] = t
    return tree_unflatten(step.out_treedef, out_flat)


def call_with_torch_autograd(tm, args: tuple, kwargs: dict):
    """``ThunderModule.__call__`` through the bridge: compile (cached), run
    through :class:`ThunderFunction`, write the mutated buffers back into
    the live module, and return the output with its tensors tracked by
    torch's autograd."""
    from thunder_tpu_torch.torch import _alias_key, _alias_pattern

    flat, treedef = tree_flatten((args, kwargs))
    overlap = _alias_pattern(flat)[1]
    params, buffers = tm._state()
    state = [t for _, t in params + buffers]
    key = _key([*state, *flat], treedef, tm._jfn._default_device(),
               (tm._training, tuple(k for k, _ in params + buffers), _alias_key(overlap)))
    step = tm._autograd_cache.get(key)
    if step is None:
        step = compile_autograd_step(tm, args, kwargs, arg_overlap=overlap)
        tm._autograd_cache[key] = step
    user_out, mutated = _apply(step, tuple(t for _, t in buffers),
                               [t for _, t in params]
                               + [flat[i] for i in step.tensor_arg_positions])
    tm._write_back(dict(zip(step.mutated_names, mutated)))
    return user_out


# ---------------------------------------------------------------------------
# the function path: loss.backward() through a jit-compiled torch function
# ---------------------------------------------------------------------------

def compile_function_autograd_step(fn, args: tuple, kwargs: dict, executors, device,
                                   overlap_indices=frozenset(),
                                   name: str = "fn") -> CompiledAutogradStep:
    """Trace a torch-calling function over the call's tensors, split the
    trace, and compile both halves. ``overlap_indices``: the flat indices of
    ``(args, kwargs)`` whose storage overlaps another input's; an in-place
    write through one of them raises (the alias audit)."""
    from thunder_tpu_torch.torch import (
        _TraceMode, _audit_aliased_mutation, _unwrap_out, _wrap)

    t0 = time.perf_counter()
    step = CompiledAutogradStep()
    step.name = name
    step.n_params = step.n_buffers = 0
    step.mutated_names = []
    flat, treedef = tree_flatten((args, kwargs))
    step.tensor_arg_positions = [i for i, x in enumerate(flat) if isinstance(x, torch.Tensor)]

    trc = TraceCtx("computation")
    with tracectx(trc), _devices.using_device(device):
        pflat = list(flat)
        for i in step.tensor_arg_positions:
            pflat[i] = _tensor_proxy(flat[i])
        trc.grad_names = _grad_names([(pflat[i], flat[i]) for i in step.tensor_arg_positions])
        pargs, pkwargs = tree_unflatten(treedef, pflat)
        with _TraceMode():
            wa, wk = _wrap(pargs), _wrap(pkwargs)
            out = fn(*wa, **wk)
            _audit_aliased_mutation(wa, wk, overlap_indices)
        full_out = (_unwrap_out(out), ())
        prims.python_return(full_out)
    trc.args = [pflat[i] for i in step.tensor_arg_positions]
    needs_grad = [p.name in trc.grad_names for p in trc.args]
    trc.grad_names = None
    return _finalize_step(step, trc, full_out, needs_grad, executors, device,
                          "Tracing (torch-autograd bridge, function)", t0)


def call_function_with_torch_autograd(jf, args: tuple, kwargs: dict):
    """``ThunderTorchFunction.__call__`` through the bridge: its outputs are
    tracked by torch's autograd; ``backward()`` runs the compiled
    backward."""
    from thunder_tpu_torch.torch import _alias_key, _alias_pattern

    flat, treedef = tree_flatten((args, kwargs))
    overlap = _alias_pattern(flat)[1]
    device = jf._default_device()
    key = _key(flat, treedef, device, (_alias_key(overlap),))
    step = jf._autograd_cache.get(key)
    if step is None:
        with jf.compiling():
            step = compile_function_autograd_step(jf._torch_fn, args, kwargs, jf.executors,
                                                  device, overlap_indices=overlap,
                                                  name=jf.fn_name)
        jf._autograd_cache[key] = step
    user_out, _ = _apply(step, (), [flat[i] for i in step.tensor_arg_positions])
    return user_out
