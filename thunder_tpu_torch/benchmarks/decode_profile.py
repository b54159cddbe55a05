"""Where a decode step's time goes: llama3-8b served by the port on one card.

Builds the full-width, full-depth llama3-8b engine (random bf16 weights from
a seed), fills all 8 slots with the smoke mix of prompts (17..1000 tokens),
runs until every request decodes, times ``--steps`` engine steps on the host
clock, then traces as many more with ``torch.profiler`` and prints device
time by kernel family, the device's busy and idle share of the traced
window (against its own host-clock time, which the tracing lengthens), and
the untraced step time and tokens/s.
``--block-fusion`` serves at the planned rung (one ``decode_layer`` launch
per layer per step) instead of the per-op rung. A kernel family counts every
CUDA kernel of its launches: ``paged_decode_attention`` its chunk and combine
kernels.

    python3 -m thunder_tpu_torch.benchmarks.decode_profile [--steps 10] [--block-fusion]
        [--guard-ab]

``--guard-ab`` also times the untraced steps with every kernel router of
``ops/`` taken out from behind its guard and the quarantine check
(``ops.nn.routed``), in GUARD_AB_PAIRS pairs of turns (guarded first, then
unguarded first): what the runtime-safety layer costs the host-bound decode
step. It runs the engine's steps per call (``whole_program_jit=False``): a
replayed CUDA graph runs no router. Beside the step times it reports the routed calls a step makes and
the host time one routed call adds (a no-op router behind ``routed``
against the bare no-op, over GUARD_AB_CALLS calls).

Run by its path with another checkout's root first on ``PYTHONPATH``, it
profiles that checkout's kernels (two versions compared in one call).

Needs a CUDA card; prints the result as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from contextlib import contextmanager

import numpy as np
import torch

FAMILIES = (
    ("decode_layer", ("decode_layer_kernel",)),
    ("mlp_subblock", ("mlp_fwd_",)),
    # the split design's two kernels, and the first design's one, so that the
    # script also reads a checkout from before the split
    ("paged_decode_attention", ("paged_chunk_kernel", "paged_combine_kernel",
                                "paged_decode_kernel")),
    ("linear_act", ("linear_act_",)),
    ("rms_norm_residual", ("rms_norm_residual_kernel",)),
    ("rms_norm", ("rms_norm_kernel",)),
    ("gemm (F.linear)", ("gemm", "nvjet", "xmma", "cutlass", "splitk", "gemv")),
    ("kv write (index_copy_)", ("index_copy", "indexcopy", "index_put")),
    ("sampling reductions", ("reduce", "argmax", "softmax", "max_", "min_")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other elementwise/copy"


@contextmanager
def unguarded():
    """Every routed function of ``ops.nn`` and ``ops.optim`` replaced by the
    router it wraps (no fault hook, call count or quarantine check), for
    the scope."""
    from thunder_tpu_torch.ops import nn, optim

    saved = [(mod, name, fn) for mod in (nn, optim) for name, fn in vars(mod).items()
             if callable(fn) and hasattr(fn, "claim_id") and hasattr(fn, "__wrapped__")]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, fn.__wrapped__)
        yield len(saved)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


GUARD_AB_PAIRS, GUARD_AB_CALLS = 5, 200_000


def guard_cost_us() -> float:
    """Host microseconds one call through ``ops.nn.routed`` adds, with no
    fault plan installed and an empty quarantine: a no-op router behind it
    against the bare no-op."""
    from thunder_tpu_torch.ops import nn

    def bare(*args, **kwargs):
        return None

    wrapped = nn.routed("rms_norm")(bare)
    out = {}
    for name, fn in (("bare", bare), ("routed", wrapped), ("bare", bare), ("routed", wrapped)):
        t0 = time.perf_counter()
        for _ in range(GUARD_AB_CALLS):
            fn(1, 2, 3)
        out.setdefault(name, []).append((time.perf_counter() - t0) / GUARD_AB_CALLS * 1e6)
    return min(out["routed"]) - min(out["bare"])


def timed_steps(eng, steps: int) -> float:
    """Host-clock ms a step over ``steps`` engine steps, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--block-fusion", action="store_true",
                    help="the planned rung: one decode_layer launch per layer per step")
    ap.add_argument("--guard-ab", action="store_true",
                    help="also time the steps with the routers out from behind their guard")
    args = ap.parse_args()
    from thunder_tpu_torch.executors import cudaex
    from thunder_tpu_torch.models import llama
    from thunder_tpu_torch.serving import ServingEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cudaex.build()
    cfg = llama.CONFIGS["llama3-8b"]
    params = llama.init_params(cfg, seed=0, device="cuda")
    # a replayed step runs no router: the guard A/B times steps run per call
    eng = ServingEngine(params, cfg, max_slots=8, page_size=16, max_context=2048,
                        block_fusion=args.block_fusion, whole_program_jit=not args.guard_ab)
    rng = np.random.RandomState(1)
    for n in (17, 64, 150, 301, 480, 640, 800, 1000):
        eng.submit(rng.randint(0, cfg.vocab_size, size=n).astype(np.int32),
                   (2 + (4 * GUARD_AB_PAIRS if args.guard_ab else 0)) * args.steps + 40)
    while any(r is None or r.state != "decode" for r in eng.slots):
        eng.step()
    for _ in range(3):                                  # warm decode steps
        eng.step()
    plain_ms = timed_steps(eng, args.steps)             # the same steps, not traced
    guard_ab = None
    if args.guard_ab:
        from thunder_tpu_torch.runtime import faults

        guard_ab = {"guarded": [], "unguarded": []}
        faults.reset_claim_calls()
        for i in range(GUARD_AB_PAIRS):
            for kind in (("guarded", "unguarded") if i % 2 == 0 else ("unguarded", "guarded")):
                if kind == "guarded":
                    guard_ab[kind].append(timed_steps(eng, args.steps))
                else:
                    with unguarded() as n:
                        guard_ab[kind].append(timed_steps(eng, args.steps))
                    guard_ab["routers"] = n
        guard_ab["median_ms"] = {k: float(np.median(guard_ab[k])) for k in ("guarded", "unguarded")}
        guard_ab["routed_calls_per_step"] = sum(faults.claim_calls().values()) / (
            GUARD_AB_PAIRS * args.steps)
        guard_ab["routed_call_us"] = guard_cost_us()
    cudaex.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_family: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        kernels[ev.key] = kernels.get(ev.key, 0.0) + us
        fam = family(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + us
    busy_ms = sum(by_family.values()) / 1e3
    result = {
        "card": card, "model": cfg.name, "block_fusion": args.block_fusion, "slots": 8,
        "steps": args.steps,
        "step_ms": plain_ms, "decode_tok_per_s": 8 / (plain_ms / 1e3),
        "step_ms_traced": wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "ms_per_step_by_family": {k: v / 1e3 / args.steps for k, v in
                                  sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {k[:80]: v / 1e3 / args.steps for k, v in
                                    sorted(kernels.items(), key=lambda kv: -kv[1])[:12]},
        "launches": cudaex.launch_counts(), "designs": cudaex.design_counts(),
    }
    if guard_ab is not None:
        result["step_ms_guard_ab"] = guard_ab
    print(json.dumps(result))


if __name__ == "__main__":
    main()
