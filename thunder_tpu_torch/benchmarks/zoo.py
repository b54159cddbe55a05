"""Train step of any model of the port's zoo on one card: ``init_params``,
then ``loss_fn``, its gradients by autograd, and the optimizer step.

The models are named ``family/config``: ``mixtral/mixtral-8x7b``,
``gpt/falcon-7b``, ``nanogpt/gpt2-xl``, ``seq2seq/bart-base``,
``resnet/resnet18`` and the tiny configs the tests drive (``ZOO``).
Weights are random, from ``--seed``; tokens (and images) are synthetic
from the same seed, one batch reused by every step, so the loss falls on
it. The optimizer is ``AdamW(lr)`` with float32 moments, or for a resnet
``SGD(lr, momentum=0.9)``. The language models' targets are the tokens
rolled by one (``pretrain.synthetic_batch``); seq2seq's source has
``--src-seq`` tokens and its labels are the target tokens rolled by one.

    python3 -m thunder_tpu_torch.benchmarks.zoo --model mixtral/mixtral-8x7b \\
        --layers 2 --batch 1 --seq 2048 --steps 3 [--loss fused] [--remat] [--profile 2]

Prints one JSON line: each step's loss, host-clock time and kernel
launches (``per_step``), the step time, tokens/s (images/s for a resnet),
peak device memory, the card's name and power limit, and with
``--profile N`` the device time by kernel family over N more traced steps,
the device's idle share and the longest kernels. ``--device cpu`` runs the
plain versions, for a tiny config.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from thunder_tpu_torch.benchmarks.pretrain import card_line, profile_steps, synthetic_batch
from thunder_tpu_torch.devices import resolve_device
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import gpt, mixtral, nanogpt, resnet, seq2seq
from thunder_tpu_torch.optim import SGD, AdamW, tree_leaves, tree_map

FAMILIES = {"mixtral": mixtral, "gpt": gpt, "nanogpt": nanogpt, "seq2seq": seq2seq,
            "resnet": resnet}
ZOO = tuple(f"{fam}/{name}" for fam, mod in FAMILIES.items() for name in mod.CONFIGS)

def split_name(model: str):
    """``(family module, config)`` of ``family/config``."""
    fam, _, name = model.partition("/")
    if fam not in FAMILIES or name not in FAMILIES[fam].CONFIGS:
        raise ValueError(f"unknown model {model!r}; known: {', '.join(ZOO)}")
    return FAMILIES[fam], FAMILIES[fam].CONFIGS[name]


def expected_launches(model: str, layers: int | None = None, loss: str = "naive",
                      remat: bool = False) -> dict:
    """The kernel launches of one train step by design: the Pallas claims
    of the reference's training trace of the same step (one
    ``fused_adamw`` for the one dtype bucket every model's parameters
    form; a resnet's SGD launches none)."""
    mod, cfg = split_name(model)
    adamw = {"fused_adamw": 1}
    if mod is resnet:
        return {"ce_fwd": 1}
    if mod is seq2seq:
        n_attn = cfg.enc_layers + 2 * cfg.dec_layers
        return {"sdpa_fwd": n_attn, "sdpa_bwd": n_attn, "ce_fwd": 1,
                "rms_norm_residual": 2 * cfg.enc_layers + 3 * cfg.dec_layers + 1, **adamw}
    if mod is nanogpt:
        L = layers if layers is not None else cfg.n_layer
        return {"sdpa_fwd": L, "sdpa_bwd": L, "ce_fwd": 1, **adamw}
    L = layers if layers is not None else cfg.n_layers
    if mod is mixtral:
        if remat:
            out = {"sdpa_fwd": 2 * L, "sdpa_bwd": L, "rms_norm": 3 * L + 1,
                   "rms_norm_residual": L, **adamw}
        else:
            out = {"sdpa_fwd": L, "sdpa_bwd": L, "rms_norm": 1, "rms_norm_residual": 2 * L,
                   **adamw}
        if loss == "naive":
            out["ce_fwd"] = 1
        return out
    out = {"sdpa_fwd": L, "sdpa_bwd": L, "ce_fwd": 1, **adamw}
    if cfg.norm == "rmsnorm":
        norms = (L if cfg.parallel_residual else 2 * L) + 1
        first_plain = int(cfg.pos == "rope")
        out.update({"rms_norm": first_plain, "rms_norm_residual": norms - first_plain})
        out = {k: n for k, n in out.items() if n}
    return out


def make_batch(model: str, batch: int, seq: int, seed: int, device, src_seq: int | None = None,
               image: int = 224) -> tuple:
    """The step's inputs after the parameters, as tensors on ``device``,
    made from ``seed`` with numpy (so the CPU and the card see the same
    batch): ``(tokens, targets)``; seq2seq ``(src, tgt, labels)``; resnet
    ``(images (B, C, image, image), labels)``."""
    mod, cfg = split_name(model)
    dev = torch.device(device)
    if mod is resnet:
        rng = np.random.RandomState(seed)
        x = rng.randn(batch, cfg.in_channels, image, image).astype(np.float32)
        y = rng.randint(0, cfg.num_classes, size=batch).astype(np.int64)
        return torch.from_numpy(x).to(dev, cfg.dtype), torch.from_numpy(y).to(dev)
    if mod is seq2seq:
        rng = np.random.RandomState(seed)
        src = rng.randint(0, cfg.vocab_size, size=(batch, src_seq or seq)).astype(np.int64)
        tgt = rng.randint(0, cfg.vocab_size, size=(batch, seq)).astype(np.int64)
        return tuple(torch.from_numpy(a).to(dev) for a in (src, tgt, np.roll(tgt, -1, 1)))
    return tuple(torch.from_numpy(a).to(dev)
                 for a in synthetic_batch(cfg.vocab_size, batch, seq, seed))


def init_model(model: str, seed: int = 0, device="cuda", layers: int | None = None):
    """``(params, state)``: the model's parameters and, for a resnet, its
    batch-norm state (None otherwise)."""
    mod, cfg = split_name(model)
    if mod is resnet:
        return mod.init_params(cfg, seed=seed, device=device)
    if mod is seq2seq:
        return mod.init_params(cfg, seed=seed, device=device), None
    return mod.init_params(cfg, seed=seed, device=device, n_layers=layers), None


def loss_of(model: str, params, batch: tuple, bn_state=None, loss: str = "naive",
            remat: bool = False):
    """``(loss, new_bn_state)`` of the model's loss function on ``batch``."""
    mod, cfg = split_name(model)
    if mod is resnet:
        return mod.loss_fn(params, *batch, cfg, state=bn_state, training=True)
    if mod is mixtral:
        fn = mod.fused_loss_fn if loss == "fused" else mod.loss_fn
        return fn(params, *batch, cfg, remat=remat), None
    if loss != "naive" or remat:
        raise ValueError(f"{model}: loss={loss!r}, remat={remat} exist for mixtral only")
    return mod.loss_fn(params, *batch, cfg), None


def value_and_grad(fn, params):
    """``(value, grads, aux)`` of ``fn(params) -> (value, aux)``: the value,
    its gradient tree by autograd over every parameter leaf (the
    counterpart of ``tt.value_and_grad(..., has_aux=True)``), and ``aux``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    value, aux = fn(params)
    grads = iter(torch.autograd.grad(value, leaves))
    return value.detach(), tree_map(lambda _: next(grads), params), aux


def optimizer_for(model: str, lr: float):
    return SGD(lr=lr, momentum=0.9) if split_name(model)[0] is resnet else AdamW(lr=lr)


def train_step(model: str, params, opt, opt_state, batch: tuple, bn_state=None,
               loss: str = "naive", remat: bool = False):
    """One step in place: the loss, its gradients, the optimizer update.
    Returns ``(loss, new_bn_state)``."""
    value, grads, new_state = value_and_grad(
        lambda p: loss_of(model, p, batch, bn_state, loss, remat), params)
    opt.update(params, grads, opt_state)
    return value, new_state


def run(model: str = "gpt/tiny", layers: int | None = None, batch: int = 2, seq: int = 64,
        steps: int = 2, lr: float = 1e-4, seed: int = 0, device=None, profile: int = 0,
        loss: str = "naive", remat: bool = False, src_seq: int | None = None,
        image: int = 224, params=None, bn_state=None, opt=None) -> dict:
    """Build the model (or take ``params`` and ``bn_state``), take one
    warm-up step and ``steps`` timed steps on one synthetic batch, and
    report. The parameters, the optimizer state and the batch-norm state
    are ``result["params"]``, ``["opt_state"]`` and ``["bn_state"]``
    afterwards (the caller drops them to free the card)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        cudaex.build()
    if params is None:
        params, bn_state = init_model(model, seed, dev, layers)
    opt = opt if opt is not None else optimizer_for(model, lr)
    opt_state = opt.init(params)
    inputs = make_batch(model, batch, seq, seed, dev, src_seq, image)
    bn = [bn_state]

    def step():
        value, bn[0] = train_step(model, params, opt, opt_state, inputs, bn[0], loss, remat)
        return value

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    before = cudaex.launch_counts()
    losses = [float(step())]   # warm-up
    warm = {k: n - before[k] for k, n in cudaex.launch_counts().items() if n != before[k]}
    warmup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    per_step = [{"loss": losses[0], "ms": warmup_s * 1e3, "launches": warm, "warmup": True}]
    for _ in range(steps):
        before = cudaex.launch_counts()
        t = time.perf_counter()
        value = step()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        after = cudaex.launch_counts()
        losses.append(float(value))
        per_step.append({"loss": losses[-1], "ms": ms,
                         "launches": {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]}})
    timed = [s["ms"] for s in per_step[1:]]
    step_ms = sum(timed) / max(len(timed), 1)
    mod, cfg = split_name(model)
    n_layers = (len(params["layers"]) if "layers" in params
                else len(params["blocks"]) if "blocks" in params else None)
    result = {
        "model": model, "layers": n_layers, "batch": batch, "seq": seq, "steps": steps,
        "src_seq": src_seq if mod is seq2seq else None,
        "image": image if mod is resnet else None, "lr": lr, "seed": seed, "loss": loss,
        "remat": remat, "optimizer": type(opt).__name__, "device": str(dev),
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "params_count": sum(p.numel() for p in tree_leaves(params)),
        "warmup_s": warmup_s, "step_ms": step_ms,
        ("images_per_s" if mod is resnet else "tokens_per_s"):
            (batch if mod is resnet else batch * seq) / (step_ms / 1e3) if step_ms else None,
        "losses": losses, "per_step": per_step,
        "params": params, "opt_state": opt_state, "bn_state": bn[0], "inputs": inputs,
    }
    if on_card:
        result.update({"card": card_line(),
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    if profile and on_card:
        result.update(profile_steps(step, profile))
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt/tiny", help=f"one of: {', '.join(ZOO)}")
    ap.add_argument("--layers", type=int, default=None,
                    help="build fewer layers than the config (not for seq2seq or resnet)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64, help="tokens (seq2seq: target tokens)")
    ap.add_argument("--src-seq", type=int, default=None, help="seq2seq's source tokens")
    ap.add_argument("--image", type=int, default=224, help="a resnet's image side")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loss", default="naive", choices=("naive", "fused"),
                    help="mixtral: loss_fn (naive) or the chunked-vocab fused_loss_fn")
    ap.add_argument("--remat", action="store_true", help="mixtral: checkpoint every block")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps with torch.profiler")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run(args.model, args.layers, args.batch, args.seq, args.steps, args.lr, args.seed,
              args.device, args.profile, args.loss, args.remat, args.src_seq, args.image)
    for k in ("params", "opt_state", "bn_state", "inputs"):
        out.pop(k)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
