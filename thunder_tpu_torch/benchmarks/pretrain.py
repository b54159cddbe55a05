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

Two rungs of the reference's step. The default is its per-op rung
(``tt.jit(train_step, block_fusion=False)``). ``--block-fusion`` is its
planned rung: one ``mlp_subblock`` kernel per layer, forward and backward.
The reference's ``tt.jit(train_step)`` leaves ``block_fusion`` unset and its
cost model decides; at llama3-8b-bench's train shape (B=8, T=2048:
``cost_model.subblock_cost(16384, 4096, 14336, 2)``) the sub-block is
VMEM-feasible (15.7 of 16 MB) and saves an estimated 2672.6 us per layer,
so the planner plans it, and ``--block-fusion`` reproduces the reference's
default step there. The port has no cost model, so the choice is explicit.

Prints one JSON line: step time, tokens/s, peak device memory, the share of
the H100's 989 TFLOP/s dense bf16 peak reached (NVIDIA data sheet, SXM
part), the optimizer's device time per step, the kernels' launches per
step, and the card's name and power limit as nvidia-smi reports them.
``--profile N`` traces N more steps with torch.profiler and adds the device
time per kernel family, the device's idle share and the longest kernels.
Needs a CUDA card; ``--device cpu`` runs the plain versions, for a small
config.

``--guard`` runs every step under the numerics guard
(``transforms.numerics_guard.NumericsGuard``, the counterpart of the
reference's ``NumericsGuardTransform``): the optimizer's health pass builds
the step's health word on the device, the update is gated on it, and the
word is fetched once per step for the sentinel; the report adds the
sentinel's counts and the last grad norm.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from thunder_tpu_torch.data import ShardedTokenStream
from thunder_tpu_torch.devices import resolve_device
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama
from thunder_tpu_torch.optim import AdamW, tree_leaves, tree_map
from thunder_tpu_torch.transforms.numerics_guard import NumericsGuard

H100_BF16_FLOPS = 989e12
PROFILE_TOP = 25   # the longest kernels a profile lists

# kernel-name substrings of each family, first match wins: the port's own
# kernels come ahead of the cuBLAS rows (float32 products, cuBLAS's SIMT
# sgemm without TF32, ahead of the rest), then cuDNN's convolutions, the
# gathers and scatters (the MoE's routing among them) and the reductions
FAMILIES = (
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
    every layer."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    value = LOSSES[loss](params, tokens, targets, cfg, block_fusion=block_fusion, remat=remat)
    grads = iter(torch.autograd.grad(value, leaves))
    return value.detach(), tree_map(lambda _: next(grads), params)


def train_step(params: dict, opt: AdamW, opt_state: dict, tokens: torch.Tensor,
               targets: torch.Tensor, cfg: llama.LlamaConfig,
               opt_events: tuple | None = None, block_fusion: bool = False,
               loss: str = "naive", remat: bool = False,
               guard: NumericsGuard | None = None) -> torch.Tensor:
    """One step: the loss and its gradients, then AdamW in place. Returns
    the loss (a device tensor: reading it is the caller's sync).
    ``opt_events``, a pair of CUDA events, are recorded around the
    optimizer's update; ``block_fusion``, ``loss`` and ``remat`` are
    :func:`loss_and_grads`'s. With ``guard`` the step runs under the
    numerics guard: the update is gated on the step's health word, which
    the guard fetches (one host sync) and hands to its sentinel."""
    if guard is not None:
        return guard.step(params, opt, opt_state,
                          lambda: loss_and_grads(params, tokens, targets, cfg, block_fusion,
                                                 loss, remat),
                          opt_events=opt_events, inputs=(tokens, targets))
    value, grads = loss_and_grads(params, tokens, targets, cfg, block_fusion, loss, remat)
    if opt_events:
        opt_events[0].record()
    opt.update(params, grads, opt_state)
    if opt_events:
        opt_events[1].record()
    return value


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other elementwise/copy"


def run(model: str = "tiny", layers: int | None = None, batch: int = 4, seq: int = 256,
        steps: int = 10, lr: float = 1e-4, seed: int = 0, device=None, profile: int = 0,
        params: dict | None = None, block_fusion: bool = False, loss: str = "naive",
        remat: bool = False, opt: AdamW | None = None, state: dict | None = None,
        data: str | None = None, data_seed: int = 0, start_step: int = 0,
        audit: bool = False, guard: NumericsGuard | bool | None = None) -> dict:
    """Build the model (or take ``params``), take one warm-up step and
    ``steps`` timed steps, and report. The batches are one synthetic batch
    or, with ``data`` (a token file), the stream's batches ``start_step``,
    ``start_step + 1``, ... (seeded by ``data_seed``); ``audit`` prints each
    timed step's loss. Each step's batch index, loss, host-clock time
    (the batch's fetch and copy included: ``batch_ms``) and kernel launches
    are in ``per_step``. ``opt`` defaults to ``AdamW(lr=lr)`` and
    ``state``, the optimizer state the steps update in place, to
    ``opt.init(params)``; ``loss`` and ``remat`` are
    :func:`loss_and_grads`'s. ``guard`` (a :class:`NumericsGuard`, or True
    for one with the default policy) runs every step under the numerics
    guard."""
    dev = resolve_device(device)
    cfg = llama.CONFIGS[model]
    n_layers = layers if layers is not None else cfg.n_layers
    on_card = dev.type == "cuda"
    if on_card:
        cudaex.build()
    if params is None:
        params = llama.init_params(cfg, seed=seed, device=dev, n_layers=n_layers)
    n_layers = len(params["layers"])
    opt = opt if opt is not None else AdamW(lr=lr)
    state = state if state is not None else opt.init(params)
    guard = NumericsGuard() if guard is True else (guard or None)
    batch_for, stream = _batches(cfg, batch, seq, seed, dev, data, data_seed)
    next_batch = [start_step]
    batch_ms: list[float] = []

    def step(opt_events=None):
        t = time.perf_counter()
        tokens, targets = batch_for(next_batch[0])
        next_batch[0] += 1
        batch_ms.append((time.perf_counter() - t) * 1e3)
        return train_step(params, opt, state, tokens, targets, cfg, opt_events, block_fusion,
                          loss, remat, guard)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    losses = [float(step())]   # warm-up
    warmup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    per_step, opt_ms = [], []
    for _ in range(steps):
        before = cudaex.launch_counts()
        # the optimizer's device time, from events around it
        ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2)) if on_card else None
        t = time.perf_counter()
        value = step(opt_events=ev)
        sync()
        ms = (time.perf_counter() - t) * 1e3
        after = cudaex.launch_counts()
        if on_card:
            opt_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(value))
        if audit:
            print(f"step {next_batch[0] - 1} loss {losses[-1]:.6f}", file=sys.stderr)
        per_step.append({"batch": next_batch[0] - 1, "loss": losses[-1], "ms": ms,
                         "batch_ms": batch_ms[-1],
                         "launches": {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]}})
    step_ms = sum(s["ms"] for s in per_step) / max(len(per_step), 1)
    tokens_per_step = batch * seq
    fpt = llama.flops_per_token(cfg, seq, n_layers)
    result = {
        "model": cfg.name, "layers": n_layers, "batch": batch, "seq": seq, "steps": steps,
        "lr": lr, "seed": seed, "block_fusion": block_fusion, "loss": loss, "remat": remat,
        "slab_persistent": opt.slab_persistent,
        "opt_state": [str(d).replace("torch.", "") for d in (opt.state_dtype, opt.v_dtype)],
        "device": str(dev), "dtype": str(cfg.dtype).replace("torch.", ""),
        "params": llama.num_params(cfg, n_layers), "warmup_s": warmup_s,
        "step_ms": step_ms, "tokens_per_s": tokens_per_step / (step_ms / 1e3),
        "losses": losses, "per_step": per_step,
        "data": data, "data_seed": data_seed if data else None, "start_step": start_step,
        "stream_path": stream.stream_path() if stream else None,
        "guard": guard is not None,
    }
    if guard is not None:
        sent = guard.sentinel
        result["sentinel"] = {"steps": sent.steps, "healthy_steps": sent.healthy_steps,
                              "nonfinite_steps": sent.nonfinite_steps,
                              "skipped_steps": sent.skipped_steps,
                              "last_health_word": guard.last_health}
    if on_card:
        result.update({
            "card": card_line(),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "model_tflops_per_s": tokens_per_step * fpt / (step_ms / 1e3) / 1e12,
            "share_of_989_tflops": tokens_per_step * fpt / (step_ms / 1e3) / H100_BF16_FLOPS,
            "optimizer_ms": sum(opt_ms) / len(opt_ms),
        })
    if profile and on_card:
        result.update(profile_steps(step, profile))
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
    ap.add_argument("--block-fusion", action="store_true",
                    help="the planned rung: one mlp_subblock kernel pair per layer")
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
                    help="run every step under the numerics guard (health word, gated update)")
    args = ap.parse_args()
    print(json.dumps(run(args.model, args.layers, args.batch, args.seq, args.steps, args.lr,
                         args.seed, args.device, args.profile,
                         block_fusion=args.block_fusion, data=args.data,
                         data_seed=args.data_seed, start_step=args.start_step,
                         audit=args.audit, guard=args.guard)))


if __name__ == "__main__":
    main()
