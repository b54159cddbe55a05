"""Single-device pretraining throughput of the port: a Llama train step
(forward, backward, AdamW) on one card.

The counterpart of ``thunder_tpu/benchmarks/pretrain.py --mode single``:
the same model configs, ``AdamW(lr)`` with the reference's defaults, and
synthetic tokens from a seed (``targets = roll(tokens, -1)``, as
``bench.py:146-148``). Weights are random, from ``--seed``.

    python3 -m thunder_tpu_torch.benchmarks.pretrain --model llama3-8b-bench \\
        --layers 4 --batch 8 --seq 2048 --steps 5 [--profile 3] [--block-fusion]

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
time per kernel family and the device's idle share. Needs a CUDA card;
``--device cpu`` runs the plain versions, for a small config.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import numpy as np
import torch

from thunder_tpu_torch.devices import resolve_device
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama
from thunder_tpu_torch.optim import AdamW, tree_leaves, tree_map

H100_BF16_FLOPS = 989e12

# kernel-name substrings of each family, first match wins: the port's own
# kernels come ahead of the cuBLAS row
FAMILIES = (
    ("mlp_subblock_bwd", ("mlp_bwd_",)),
    ("fused_adamw_slab", ("fused_adamw_slab_kernel",)),
    ("mlp_subblock", ("mlp_fwd_",)),
    ("sdpa_bwd", ("sdpa_dkv_", "sdpa_dq_", "delta_kernel")),
    ("sdpa_fwd", ("sdpa_fwd_",)),
    ("ce_fwd", ("ce_fwd_kernel",)),
    ("fused_adamw", ("fused_adamw_kernel",)),
    ("rms_norm_residual", ("rms_norm_residual_kernel",)),
    ("rms_norm", ("rms_norm_kernel",)),
    ("gemm (F.linear and its gradients)", ("gemm", "nvjet", "xmma", "cutlass", "splitk")),
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
               loss: str = "naive", remat: bool = False) -> torch.Tensor:
    """One step: the loss and its gradients, then AdamW in place. Returns
    the loss (a device tensor: reading it is the caller's sync).
    ``opt_events``, a pair of CUDA events, are recorded around the
    optimizer's update; ``block_fusion``, ``loss`` and ``remat`` are
    :func:`loss_and_grads`'s."""
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
        remat: bool = False, opt: AdamW | None = None, state: dict | None = None) -> dict:
    """Build the model (or take ``params``), take one warm-up step and
    ``steps`` timed steps on one synthetic batch, and report. Each step's
    loss, host-clock time and kernel launches are in ``per_step``.
    ``opt`` defaults to ``AdamW(lr=lr)`` and ``state``, the optimizer state
    the steps update in place, to ``opt.init(params)``; ``loss`` and
    ``remat`` are :func:`loss_and_grads`'s."""
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
    tok_np, tgt_np = synthetic_batch(cfg.vocab_size, batch, seq, seed)
    tokens, targets = torch.from_numpy(tok_np).to(dev), torch.from_numpy(tgt_np).to(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    step = functools.partial(train_step, params, opt, state, tokens, targets, cfg,
                             block_fusion=block_fusion, loss=loss, remat=remat)
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
        per_step.append({"loss": losses[-1], "ms": ms,
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
    }
    if on_card:
        result.update({
            "card": card_line(),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "model_tflops_per_s": tokens_per_step * fpt / (step_ms / 1e3) / 1e12,
            "share_of_989_tflops": tokens_per_step * fpt / (step_ms / 1e3) / H100_BF16_FLOPS,
            "optimizer_ms": sum(opt_ms) / len(opt_ms),
        })
    if profile and on_card:
        result.update(_profile(step, profile))
    return result


def _profile(step, steps: int) -> dict:
    """Device time per kernel family and the device's idle share over
    ``steps`` traced calls of ``step``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_family: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = _family(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + ev.self_device_time_total
    busy_ms = sum(by_family.values()) / 1e3
    return {
        "profile_steps": steps, "profile_step_ms": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "ms_per_step_by_family": {k: v / 1e3 / steps for k, v in
                                  sorted(by_family.items(), key=lambda kv: -kv[1])},
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
    args = ap.parse_args()
    print(json.dumps(run(args.model, args.layers, args.batch, args.seq, args.steps, args.lr,
                         args.seed, args.device, args.profile,
                         block_fusion=args.block_fusion)))


if __name__ == "__main__":
    main()
