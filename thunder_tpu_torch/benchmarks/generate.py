"""Inference benchmark of the contiguous-cache path: prefill latency and
decode tokens/s of ``models.llama.generate`` (one eager step per token) and
``generate_fused`` (the decode loop captured as one CUDA graph and replayed
per token); the counterpart of the root ``bench_generate.py`` without its
``jax.jit`` baseline arm.

    python3 -m thunder_tpu_torch.benchmarks.generate [--model llama3-8b]
        [--layers 32] [--batch 8] [--prompt 1000] [--decode 32]
        [--max-len 2048] [--repeats 3] [--device cuda] [--profile]

Random weights from ``--seed`` (bf16 for the llama configs), random prompt
tokens. Prefill is one ``forward_step`` over the ``(batch, prompt)`` tokens
into a fresh cache, timed to a device sync; a generation's decode time is
its whole time less the prefill's, over ``decode - 1`` steps (the first
token comes from the prefill): for ``generate_fused`` that time includes
its eager step, the capture and the graph's instantiation. The replayed
step alone is ``generate_fused_replay_ms``: CUDA events around the replay
loop, over its ``decode - 2`` replays. Each number is the best of
``--repeats`` calls after one warm-up call of each function. Also reports
the host time to issue one eager decode step and one graph replay, and
whether the two functions gave the same tokens. ``--profile`` then traces one prefill, one
``generate`` and one ``generate_fused`` call with ``torch.profiler`` and
reports each one's device ms by kernel family and its idle share (against
its own host clock, which the tracing lengthens). Prints the card's name and
power limit, then the result as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from thunder_tpu_torch.devices import resolve_device
from thunder_tpu_torch.models import llama


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


# kernel families of the contiguous-cache path, matched on the CUDA
# kernel's name in order
FAMILIES = (
    ("linear_act", ("linear_act_",)),
    ("rms_norm_residual", ("rms_norm_residual_kernel",)),
    ("rms_norm", ("rms_norm_kernel",)),
    ("gemm (F.linear, bmm)", ("gemm", "nvjet", "xmma", "cutlass", "splitk", "gemv", "sm90")),
    ("softmax", ("softmax",)),
    ("cache write (index_copy_)", ("index_copy", "indexcopy", "index_put")),
    ("argmax", ("argmax", "reduce")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other elementwise/copy"


def profile(fn, dev) -> dict:
    """One traced call of ``fn``: its host-clock ms, the device's busy ms by
    kernel family and its idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        _sync(dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    by_family: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            fam = family(ev.key)
            by_family[fam] = by_family.get(fam, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(by_family.values())
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "ms_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1]))}


def run(model: str = "llama3-8b", layers: int | None = None, batch: int = 8,
        prompt_len: int = 1000, decode: int = 32, max_len: int = 2048, repeats: int = 3,
        seed: int = 0, device=None, params: dict | None = None,
        with_profile: bool = False) -> dict:
    """The measurements as a dict; ``params`` (on ``device``) stands in for
    the seeded random weights; ``with_profile`` adds the traced calls."""
    dev = resolve_device(device)
    cfg = llama.CONFIGS[model]
    if params is None:
        params = llama.init_params(cfg, seed=seed, device=dev, n_layers=layers)
    prompt = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(batch, prompt_len))).to(dev)

    def prefill():
        cache = llama.init_kv_cache(cfg, batch, max_len, n_layers=len(params["layers"]),
                                    device=dev)
        _sync(dev)
        t = time.perf_counter()
        last, _ = llama.forward_step(params, prompt, cache, 0, cfg, last_idx=prompt_len - 1)
        torch.argmax(last[:, 0], -1)
        _sync(dev)
        return time.perf_counter() - t

    def timed(fn, **kw):
        _sync(dev)
        t = time.perf_counter()
        out = fn(params, cfg, prompt, decode, max_len=max_len, device=dev, **kw)
        _sync(dev)
        return time.perf_counter() - t, out

    prefill()
    warm_gen = timed(llama.generate)[1]
    warm_fused = timed(llama.generate_fused)[1]
    pre = min(prefill() for _ in range(repeats))
    gen, fused, stats = [], [], []
    for _ in range(repeats):
        gen.append(timed(llama.generate)[0])
        stats.append({})
        fused.append(timed(llama.generate_fused, stats=stats[-1])[0])
    best = min(stats, key=lambda st: st.get("replay_ms") or float("inf"))
    steps = max(decode - 1, 1)
    gen_s, fused_s = min(gen) - pre, min(fused) - pre
    traced = None
    if with_profile and dev.type == "cuda":
        traced = {"prefill": profile(prefill, dev),
                  "generate": profile(lambda: timed(llama.generate), dev),
                  "generate_fused": profile(lambda: timed(llama.generate_fused), dev)}
    return {
        "model": cfg.name, "layers": len(params["layers"]), "dtype": str(cfg.dtype),
        "batch": batch, "prompt": prompt_len, "decode": decode, "max_len": max_len,
        "kv_cache_gb": 2 * len(params["layers"]) * batch * cfg.kv_heads * max_len
        * cfg.head_dim * torch.empty((), dtype=cfg.dtype).element_size() / 1e9,
        "prefill_ms": pre * 1e3,
        "generate_ms": min(gen) * 1e3, "generate_fused_ms": min(fused) * 1e3,
        "generate_decode_tok_per_s": batch * steps / gen_s,
        "generate_fused_decode_tok_per_s": batch * steps / fused_s,
        "generate_decode_step_ms": gen_s * 1e3 / steps,
        "generate_fused_decode_step_ms": fused_s * 1e3 / steps,
        "generate_fused_replay_ms": best.get("replay_ms") or None,
        "generate_fused_replay_tok_per_s": batch * 1e3 / best["replay_ms"]
        if best.get("replay_ms") else None,
        "eager_step_host_ms": best.get("eager_step_host_ms"),
        "replay_host_ms": best.get("replay_host_ms"),
        "tokens_identical": bool(torch.equal(warm_gen, warm_fused)),
        "repeats": repeats, "device": str(dev), "profile": traced,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama3-8b", choices=sorted(llama.CONFIGS))
    ap.add_argument("--layers", type=int, default=None, help="depth (default: the config's)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1000)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill and one call of each function")
    a = ap.parse_args(argv)
    out = run(a.model, a.layers, a.batch, a.prompt, a.decode, a.max_len, a.repeats, a.seed,
              a.device, with_profile=a.profile)
    card = _card()
    if card is not None:
        print(card)
    print(json.dumps(dict(out, card=card)))


if __name__ == "__main__":
    main()
