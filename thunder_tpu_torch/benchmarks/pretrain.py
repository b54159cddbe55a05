"""Single-device pretraining throughput of the port: a Llama train step
(forward, backward, AdamW) on one card.

The counterpart of ``thunder_tpu/benchmarks/pretrain.py --mode single``:
the same model configs, ``AdamW(lr)`` with the reference's defaults, and
synthetic tokens from a seed (``targets = roll(tokens, -1)``, as
``bench.py:146-148``), one batch reused by every step. Weights are random,
from ``--seed``.

    python3 -m thunder_tpu_torch.benchmarks.pretrain --model llama3-8b-bench \\
        --layers 4 --batch 8 --seq 2048 --steps 5 [--profile 3] [--block-fusion] \\
        [--data tokens.bin [--data-seed S] [--start-step K] [--audit]]

``--data`` streams the batches from a token file through
:class:`thunder_tpu_torch.data.ShardedTokenStream` (epoch-exact shuffle,
C++ prefetch; on the card its native loader is required), with the
reference's step numbering: the warm-up step takes batch ``start_step``
and timed step k batch ``start_step + 1 + k``, so a run resumed at
``--start-step`` replays the batches a straight run took. Tokens are
clipped to ``vocab_size - 1``, as the reference clips them, and reach the
card from pinned host memory by an asynchronous copy. ``--audit`` prints
each timed step's loss to stderr, as the reference's does.

The step is the reference's compiled one (``pretrain.py:84-92``):
``jit(train_step, donate_argnums=(0, 1))``, built by :func:`jit_train_step`,
so the update writes the donated parameters and moments in place and, on
the card, each step replays one CUDA graph (the first call runs per call,
the second captures). Two rungs: the per-op rung
(``tt.jit(train_step, block_fusion=False)``) and the planned rung
(``--block-fusion``): one ``mlp_subblock`` kernel per layer, forward and
backward. The reference's ``tt.jit(train_step)`` leaves ``block_fusion``
unset and its cost model decides; so does the default here
(``core.fusion_passes.mlp_block_verdict``, the compiled planner's own
verdict: the port's cost model with the card's constants, forward and
backward counted), passed to ``jit`` as its ``block_fusion`` option. At
llama3-8b-bench's train shape (B=8, T=2048) it picks the per-op rung,
which the card measured faster (PERF.md §5); ``--no-block-fusion`` forces
the per-op rung. ``run(eager=True)`` runs the eager :func:`train_step`
instead (torch's autograd and the in-place ``AdamW.update``), the bench's
baseline arm.

Prints one JSON line: step time (the mean of the timed steps that replay
the graph: the one that captures it, the first on the card, is marked
``capture`` in ``per_step`` and left out), tokens/s, peak device memory, the share
of the H100's 989 TFLOP/s dense bf16 peak reached (NVIDIA data sheet, SXM
part), the kernels' launches per step, the compile's seconds and how the
entry runs, and the card's name and power limit as nvidia-smi reports
them. ``--profile N`` traces N more steps with torch.profiler and adds the
device time per kernel family (the optimizer's, ``optimizer_ms``, is its
update and health families), the device's idle share and the longest
kernels. Needs a CUDA card; ``--device cpu`` runs the plain versions, for
a small config.

``--guard`` compiles the step with the reference's numerics guard
(``transforms.numerics_guard.NumericsGuardTransform``): each optimizer
bucket's health pass builds the step's health word on the device, the
update is gated on it, and the word is fetched once per step for the
sentinel; the report adds the sentinel's counts and the last health word.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from thunder_tpu_torch.core import fusion_passes
from thunder_tpu_torch.data import ShardedTokenStream
from thunder_tpu_torch.devices import resolve_device
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama
from thunder_tpu_torch.optim import AdamW, tree_leaves, tree_map
from thunder_tpu_torch.testing import claimed_kernels
from thunder_tpu_torch.transforms.numerics_guard import NumericsGuard, NumericsGuardTransform

H100_BF16_FLOPS = 989e12
PROFILE_TOP = 25   # the longest kernels a profile lists

# kernel-name substrings of each family, first match wins: the port's own
# kernels come ahead of the cuBLAS rows (float32 products, cuBLAS's SIMT
# sgemm without TF32, ahead of the rest), then cuDNN's convolutions, the
# gathers and scatters (the MoE's routing among them) and the reductions
FAMILIES = (
    ("region", ("tt_region_kernel",)),   # the region executor's generated kernels
    ("fused_adamw health pass", ("fused_adamw_health_kernel", "adamw_health_fold")),
    ("mlp_subblock_bwd", ("mlp_bwd_",)),
    ("fused_adamw_slab", ("fused_adamw_slab_kernel",)),
    ("mlp_subblock", ("mlp_fwd_",)),
    ("sdpa_bwd", ("sdpa_dkv_", "sdpa_dq_", "delta_kernel")),
    ("sdpa_fwd", ("sdpa_fwd_",)),
    ("ce_fwd", ("ce_fwd_kernel",)),
    ("fused_adamw", ("fused_adamw_kernel",)),
    ("rms_norm_residual", ("rms_norm_residual_kernel",)),
    ("rms_norm", ("rms_norm_kernel",)),
    ("float32 products (sgemm)", ("sgemm", "f32f32_f32f32", "simt")),
    ("gemm (F.linear and its gradients)", ("gemm", "nvjet", "xmma", "cutlass", "splitk")),
    ("convolutions (cuDNN)", ("conv", "wgrad", "dgrad", "implicit", "winograd", "fft")),
    ("gathers, scatters and routing", ("index", "gather", "scatter", "topk", "sort",
                                       "cumsum", "scan", "embedding")),
    ("softmax, layer norm and reductions", ("softmax", "reduce", "norm")),
)


# the kernel families of the optimizer's device time
OPTIMIZER_FAMILIES = ("fused_adamw", "fused_adamw_slab", "fused_adamw health pass")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def synthetic_batch(vocab_size: int, batch: int, seq: int, seed: int):
    """(tokens, targets) int64 numpy arrays: uniform random tokens and the
    next-token targets ``roll(tokens, -1, 1)``."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab_size, size=(batch, seq)).astype(np.int64)
    return tokens, np.roll(tokens, -1, 1)


LOSSES = {"naive": llama.loss_fn, "fused": llama.fused_loss_fn}


def loss_and_grads(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                   cfg: llama.LlamaConfig, block_fusion: bool = False, loss: str = "naive",
                   remat: bool = False):
    """``(loss, grads)``: the loss and its gradient tree, the counterpart of
    ``tt.value_and_grad(llama.loss_fn)``; ``block_fusion`` picks the rung,
    ``loss`` the loss function (``LOSSES``: ``naive`` is ``loss_fn``,
    ``fused`` the chunked-vocab ``fused_loss_fn``), ``remat`` checkpoints
    every layer. The parameters require grad only for the call: a compiled
    step given them afterwards takes them as plain inputs, not through the
    torch-autograd bridge."""
    leaves = tree_leaves(params)
    was = [p.requires_grad for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
    try:
        value = LOSSES[loss](params, tokens, targets, cfg, block_fusion=block_fusion,
                             remat=remat)
        grads = iter(torch.autograd.grad(value, leaves))
    finally:
        for p, w in zip(leaves, was):
            p.requires_grad_(w)
    return value.detach(), tree_map(lambda _: next(grads), params)


def train_step(params: dict, opt: AdamW, opt_state: dict, tokens: torch.Tensor,
               targets: torch.Tensor, cfg: llama.LlamaConfig, *, block_fusion: bool = False,
               loss: str = "naive", remat: bool = False,
               guard: NumericsGuard | None = None) -> torch.Tensor:
    """One eager step: the loss and its gradients by torch's autograd, then
    AdamW in place. Returns the loss (a device tensor: reading it is the
    caller's sync). ``block_fusion``, ``loss`` and ``remat`` are
    :func:`loss_and_grads`'s. With ``guard`` the step runs under the eager
    numerics guard: the update is gated on the step's health word, which
    the guard fetches (one host sync) and hands to its sentinel."""
    if guard is not None:
        return guard.step(params, opt, opt_state,
                          lambda: loss_and_grads(params, tokens, targets, cfg, block_fusion,
                                                 loss, remat),
                          inputs=(tokens, targets))
    value, grads = loss_and_grads(params, tokens, targets, cfg, block_fusion, loss, remat)
    opt.update(params, grads, opt_state)
    return value


def jit_train_step(cfg: llama.LlamaConfig, opt: AdamW, *, remat: bool = False,
                   loss: str = "naive", transforms=(), **compile_options):
    """The reference's compiled train step (``thunder_tpu/benchmarks/
    pretrain.py:84-90``, ``bench.py:220``): ``train_step(params, opt_state,
    tokens, targets) -> (loss, params, opt_state)`` is
    ``value_and_grad(loss_fn)`` followed by ``opt.update``, compiled by
    ``jit`` with the parameters and the optimizer state donated, so the
    claimed update (``fused_adamw``, or ``fused_adamw_slab`` for a
    slab-persistent ``opt``) writes them in place. ``loss`` picks the loss
    (``LOSSES``: ``naive`` or the chunked ``fused``), ``remat`` checkpoints
    every layer (trace-level regions), ``transforms`` go to ``jit`` (the
    bench's guarded arm passes a ``NumericsGuardTransform``), and so do
    ``compile_options``; ``block_fusion`` left unset lets the planner's cost
    model decide, as the reference does (True plans every MLP
    sub-block)."""
    import thunder_tpu_torch as ptt

    loss_fn = LOSSES[loss]

    def train_step(params, opt_state, tokens, targets):
        value, grads = ptt.value_and_grad(
            lambda p: loss_fn(p, tokens, targets, cfg, remat=remat))(params)
        return value, *opt.update(params, grads, opt_state)

    return ptt.jit(train_step, donate_argnums=(0, 1), transforms=transforms, **compile_options)


def _assign(tree, new) -> None:
    """Rebind ``tree``'s leaves (dicts and lists, in place) to ``new``'s: a
    leaf the compiled step wrote in place is already the same tensor."""
    for k in (sorted(tree) if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            _assign(tree[k], new[k])
        else:
            tree[k] = new[k]


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other elementwise/copy"


def run(model: str = "tiny", layers: int | None = None, batch: int = 4, seq: int = 256,
        steps: int = 10, lr: float = 1e-4, seed: int = 0, device=None, profile: int = 0,
        params: dict | None = None, block_fusion: bool | None = None, loss: str = "naive",
        remat: bool = False, opt: AdamW | None = None, state: dict | None = None,
        data: str | None = None, data_seed: int = 0, start_step: int = 0,
        audit: bool = False, guard: NumericsGuardTransform | bool | None = None,
        eager: bool = False) -> dict:
    """Build the model (or take ``params``), take one warm-up step and
    ``steps`` timed steps of the compiled step (:func:`jit_train_step`), and
    report. The batches are one synthetic batch or, with ``data`` (a token
    file), the stream's batches ``start_step``, ``start_step + 1``, ...
    (seeded by ``data_seed``); ``audit`` prints each timed step's loss.
    Each step's batch index, loss, host-clock time (the batch's fetch and
    copy included: ``batch_ms``) and kernel launches are in ``per_step``.
    ``launches`` counts the kernels of the whole run, warm-up included, and
    ``region_designs`` its region launches by design.
    ``opt`` defaults to ``AdamW(lr=lr)`` and ``state``, the optimizer state,
    to ``opt.init(params)``; the steps leave ``params`` and ``state`` (their
    dicts and lists) holding the new values. ``loss`` and ``remat`` are
    :func:`loss_and_grads`'s. ``block_fusion`` None asks the cost model
    (``fusion_passes.mlp_block_verdict`` at this step's shapes, the verdict
    the compiled step's planner takes; reported as ``block_fusion_verdict``)
    and the rung goes to ``jit`` as its ``block_fusion`` option. ``guard``
    (a :class:`NumericsGuardTransform`, or True for one with the default
    policy) compiles the step with the numerics guard. ``eager`` runs the
    eager :func:`train_step` instead (no guard). A compiled run reports the
    regions its step launches (``regions``)."""
    dev = resolve_device(device)
    cfg = llama.CONFIGS[model]
    verdict = None
    if block_fusion is None:
        verdict = fusion_passes.mlp_block_verdict(batch * seq, cfg.dim, cfg.intermediate_size,
                                                  cfg.dtype.itemsize, backward=True,
                                                  checkpointed=remat)
        block_fusion = verdict["planned"]
    n_layers = layers if layers is not None else cfg.n_layers
    on_card = dev.type == "cuda"
    if on_card:
        cudaex.build()
    if params is None:
        params = llama.init_params(cfg, seed=seed, device=dev, n_layers=n_layers)
    n_layers = len(params["layers"])
    opt = opt if opt is not None else AdamW(lr=lr)
    state = state if state is not None else opt.init(params)
    guard = NumericsGuardTransform() if guard is True else (guard or None)
    if guard is not None and not isinstance(guard, NumericsGuardTransform):
        raise TypeError(f"run(guard=) takes a NumericsGuardTransform or True, not "
                        f"{type(guard).__name__} (the eager NumericsGuard guards train_step)")
    if eager and guard is not None:
        raise ValueError("run(eager=True) takes no guard")
    batch_for, stream = _batches(cfg, batch, seq, seed, dev, data, data_seed)
    next_batch = [start_step]
    batch_ms: list[float] = []
    jstep = None if eager else jit_train_step(
        cfg, opt, remat=remat, loss=loss, transforms=[guard] if guard is not None else (),
        device=dev, block_fusion=block_fusion)

    def step():
        t = time.perf_counter()
        tokens, targets = batch_for(next_batch[0])
        next_batch[0] += 1
        batch_ms.append((time.perf_counter() - t) * 1e3)
        if jstep is None:
            return train_step(params, opt, state, tokens, targets, cfg,
                              block_fusion=block_fusion, loss=loss, remat=remat)
        value, new_params, new_state = jstep(params, state, tokens, targets)
        _assign(params, new_params)
        _assign(state, new_state)
        return value

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def captures() -> int:
        if jstep is None:
            return 0
        import thunder_tpu_torch as ptt

        return ptt.compile_stats(jstep).whole_program_captures

    first, snap = cudaex.launch_counts(), cudaex.count_snapshot()
    t0 = time.perf_counter()
    losses = [float(step())]   # warm-up (the compile, and the first call per call)
    warmup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    per_step = []
    for _ in range(steps):
        before, captured = cudaex.launch_counts(), captures()
        t = time.perf_counter()
        value = step()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        after = cudaex.launch_counts()
        captured = captures() != captured
        losses.append(float(value))
        if audit:
            print(f"step {next_batch[0] - 1} loss {losses[-1]:.6f}", file=sys.stderr)
        per_step.append({"batch": next_batch[0] - 1, "loss": losses[-1], "ms": ms,
                         "batch_ms": batch_ms[-1], "capture": captured,
                         "launches": {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]}})
    last, region_designs = cudaex.launch_counts(), cudaex.count_delta(snap).get("region",
                                                                                (0, {}))[1]
    # a step that captured the CUDA graph is left out of the mean
    timed = [s for s in per_step if not s["capture"]] or per_step
    step_ms = sum(s["ms"] for s in timed) / max(len(timed), 1)
    tokens_per_step = batch * seq
    fpt = llama.flops_per_token(cfg, seq, n_layers)
    result = {
        "model": cfg.name, "layers": n_layers, "batch": batch, "seq": seq, "steps": steps,
        "lr": lr, "seed": seed, "block_fusion": block_fusion,
        "block_fusion_verdict": verdict, "loss": loss, "remat": remat,
        "slab_persistent": opt.slab_persistent,
        "opt_state": [str(d).replace("torch.", "") for d in (opt.state_dtype, opt.v_dtype)],
        "device": str(dev), "dtype": str(cfg.dtype).replace("torch.", ""),
        "params": llama.num_params(cfg, n_layers), "warmup_s": warmup_s,
        "step_ms": step_ms, "tokens_per_s": tokens_per_step / (step_ms / 1e3),
        "losses": losses, "per_step": per_step,
        "data": data, "data_seed": data_seed if data else None, "start_step": start_step,
        "stream_path": stream.stream_path() if stream else None,
        "guard": guard is not None, "compiled": jstep is not None,
        "launches": {k: last[k] - first[k] for k in last if last[k] != first[k]},
        "region_designs": region_designs,
    }
    if jstep is not None:
        import thunder_tpu_torch as ptt

        stats = ptt.compile_stats(jstep)
        result.update(regions=claimed_kernels(ptt.last_execution_trace(jstep)).get("region", 0),
                      compile_s=sum(stats.last_pass_times.values()) / 1e3,
                      whole_program=stats.last_whole_program,
                      whole_program_captures=stats.whole_program_captures,
                      whole_program_copied_bytes=stats.whole_program_copied_bytes)
    if guard is not None:
        sent = guard.sentinel
        v = sent.last_verdict
        result["sentinel"] = {"steps": sent.steps, "healthy_steps": sent.healthy_steps,
                              "nonfinite_steps": sent.nonfinite_steps,
                              "skipped_steps": sent.skipped_steps,
                              "gated_buckets": guard.gated_buckets,
                              "last_health_word": None if v is None else [
                                  v.nonfinite_grads, v.nonfinite_loss, v.nonfinite_state,
                                  v.grad_norm, v.loss]}
    if on_card:
        result.update({
            "card": card_line(),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "model_tflops_per_s": tokens_per_step * fpt / (step_ms / 1e3) / 1e12,
            "share_of_989_tflops": tokens_per_step * fpt / (step_ms / 1e3) / H100_BF16_FLOPS,
        })
    if profile and on_card:
        result.update(profile_steps(step, profile))
        fam = result["ms_per_step_by_family"]
        result["optimizer_ms"] = sum(fam.get(k, 0.0) for k in OPTIMIZER_FAMILIES)
    return result


def _batches(cfg, batch: int, seq: int, seed: int, dev: torch.device, data: str | None,
             data_seed: int):
    """``(batch_for, stream)``: ``batch_for(step)`` gives the step's
    (tokens, targets) int64 tensors on ``dev``. Without ``data`` it is one
    synthetic batch for every step (``stream`` None); with it, the stream's
    batch ``step``, clipped to the vocabulary, copied to the card from
    pinned memory without a sync (on the card the native loader is
    required)."""
    if data is None:
        tok, tgt = synthetic_batch(cfg.vocab_size, batch, seq, seed)
        fixed = torch.from_numpy(tok).to(dev), torch.from_numpy(tgt).to(dev)
        return (lambda step: fixed), None
    on_card = dev.type == "cuda"
    stream = ShardedTokenStream(data, batch=batch, seq=seq, seed=data_seed,
                                native=True if on_card else None)

    def batch_for(step):
        pair = [torch.from_numpy(np.clip(a, 0, cfg.vocab_size - 1).astype(np.int64))
                for a in stream.batch_at(step)]
        if on_card:
            pair = [t.pin_memory().to(dev, non_blocking=True) for t in pair]
        return pair

    return batch_for, stream


def profile_steps(step, steps: int) -> dict:
    """Device time per kernel family, the device's idle share and the
    ``PROFILE_TOP`` longest kernels over ``steps`` traced calls of
    ``step``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_family: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = _family(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + ev.self_device_time_total
        kernels.append((ev.self_device_time_total / 1e3 / steps, ev.count // steps, ev.key[:120]))
    busy_ms = sum(by_family.values()) / 1e3
    return {
        "profile_steps": steps, "profile_step_ms": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "ms_per_step_by_family": {k: v / 1e3 / steps for k, v in
                                  sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"ms_per_step": ms, "calls_per_step": n, "name": name}
                        for ms, n, name in sorted(kernels, reverse=True)[:PROFILE_TOP]],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny", help="llama config name")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps with torch.profiler")
    ap.add_argument("--block-fusion", action=argparse.BooleanOptionalAction, default=None,
                    help="the planned rung (one mlp_subblock kernel pair per layer) or, with "
                         "--no-block-fusion, the per-op rung; unset, the cost model picks")
    ap.add_argument("--data", default=None,
                    help="token file (uint16) to stream the batches from (epoch-exact "
                         "shuffle, prefetch, restart-deterministic); default: one synthetic "
                         "batch")
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--start-step", type=int, default=0,
                    help="resume the data position (the stream is a pure function of the "
                         "step: a run resumed at step k replays exactly)")
    ap.add_argument("--audit", action="store_true",
                    help="print each step's loss to stderr")
    ap.add_argument("--guard", action="store_true",
                    help="compile the step with the numerics guard (health word, gated update)")
    args = ap.parse_args()
    print(json.dumps(run(args.model, args.layers, args.batch, args.seq, args.steps, args.lr,
                         args.seed, args.device, args.profile,
                         block_fusion=args.block_fusion, data=args.data,
                         data_seed=args.data_seed, start_step=args.start_step,
                         audit=args.audit, guard=args.guard)))


if __name__ == "__main__":
    main()
