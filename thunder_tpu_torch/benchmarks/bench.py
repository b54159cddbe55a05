"""The port's headline train bench: a Llama-2-7B-width train step (forward,
backward, AdamW) on one card.

The counterpart of the thunder side of the repo-root ``bench.py``, with
flags in place of its environment variables: ``--model`` (BENCH_MODEL,
default ``llama2-7b-bench``), ``--layers`` (BENCH_LAYERS, 2), ``--batch``
(BENCH_BATCH, 8), ``--seq`` (BENCH_SEQ, 2048), ``--steps`` (BENCH_STEPS, 10),
``--loss fused|naive`` (BENCH_LOSS, fused: the chunked-vocab loss),
``--opt-state f32|bf16|bf16_all`` (BENCH_OPT_STATE, bf16: bf16 first moments,
f32 second; ``bf16_all`` both bf16), ``--slab-state`` (BENCH_SLAB_STATE=1:
m and v live in persistent per-dtype slabs, one ``fused_adamw_slab`` launch
per step), ``--remat`` (BENCH_REMAT=1: every layer a checkpointed region).
``--block-fusion`` takes the reference's planned rung, which the
reference's TPU cost model picks at this shape without remat, so
``--slab-state --block-fusion`` is the reference's default step there;
under ``--remat`` it has no effect, as in the reference. Unset, the port's
own cost model picks (``fusion_passes.mlp_block_verdict``: the per-op rung
at this shape, where the card measured the kernel pair slower, PERF.md
§6 rows 7-8); ``--no-block-fusion`` forces the per-op rung. ``AdamW(lr=1e-4)`` with
those state dtypes, tokens from ``--seed`` as ``bench.py:146-148`` makes
them, random weights from ``--seed``.

    python3 -m thunder_tpu_torch.benchmarks.bench --layers 8 --remat --slab-state

The timed step is the reference's (``bench.py:220``): ``jit(train_step,
donate_argnums=(0, 1))`` (``pretrain.jit_train_step``), each step one CUDA
graph replay on the card. Timing, launch counts and the profile are
``pretrain.run``'s: it prints one JSON line with the step time, tokens/s,
the share of the H100's 989 TFLOP/s dense bf16 peak by model FLOPs
(``flops_per_token``, not counting the recompute), peak device memory,
launches per step, the compile's seconds and the card line; this entry
adds the fused loss's logits route (``ops.nn.flce_logits_route``).
``--profile N`` traces N more steps (and adds the optimizer's device ms).

Two more arms, each built from fresh weights of the same seed after the
last arm's function, weights and graph pool are dropped, so the peak
memory is one arm's:

- ``sentinel_overhead_pct`` (``bench.py:268-287``): the same step compiled
  with ``transforms=[NumericsGuardTransform(policy=disarmed)]`` (each
  bucket's health pass, the gated update and one health-word fetch per
  step; the escalation disarmed as the reference disarms it), timed
  against the unguarded step: ``(guarded_ms - step_ms) / step_ms * 100``.
- ``vs_baseline`` (``bench.py:289-385, :476``): an independent
  implementation of the same step timed beside the compiled one,
  ``baseline_ms / step_ms``. The reference's is a hand-written
  ``jax.jit`` step; the port's is its eager ``pretrain.train_step`` (torch's
  autograd, the same kernels through their routers, ``AdamW.update`` in
  place), so the bench's JSON shows the compiler's cost on every run.

Not ported: ``--breakdown``, ``--smoke`` and ``BENCH_FP8`` (FP8 waits for the
port's FP8 layer).
"""

from __future__ import annotations

import argparse
import gc
import json

import torch

from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.devices import resolve_device
from thunder_tpu_torch.models import llama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.optim import AdamW
from thunder_tpu_torch.transforms.numerics_guard import NumericsGuardTransform, disarmed_policy

LR = 1e-4
# (state_dtype, v_dtype) of each BENCH_OPT_STATE choice (bench.py:127-135)
OPT_STATES = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.float32),
              "bf16_all": (torch.bfloat16, torch.bfloat16)}


def make_opt(opt_state: str = "bf16", slab_state: bool = False) -> AdamW:
    """The bench's optimizer: ``AdamW(lr=1e-4)`` with the state dtypes of
    ``opt_state`` and, with ``slab_state``, slab-persistent moments."""
    state_dtype, v_dtype = OPT_STATES[opt_state]
    return AdamW(lr=LR, state_dtype=state_dtype, v_dtype=v_dtype, slab_persistent=slab_state)


def run(model: str = "llama2-7b-bench", layers: int = 2, batch: int = 8, seq: int = 2048,
        steps: int = 10, loss: str = "fused", opt_state: str = "bf16",
        slab_state: bool = False, remat: bool = False, block_fusion: bool | None = None,
        device=None, seed: int = 0, profile: int = 0, params: dict | None = None,
        state: dict | None = None, sentinel: bool = True, baseline: bool = True) -> dict:
    """One warm-up step and ``steps`` timed steps of the bench's compiled
    train step through :func:`pretrain.run`; its report plus the bench's own
    choices. ``params`` and ``state`` (from ``make_opt(opt_state,
    slab_state).init``) are built from ``seed`` unless given; the steps
    leave them holding the new values. ``sentinel`` then times the same
    steps compiled with the numerics guard, and adds ``sentinel_step_ms``,
    ``sentinel_overhead_pct``, ``sentinel_peak_memory_gb`` and the
    sentinel's counts; ``baseline`` times the eager step, and adds
    ``baseline_step_ms``, ``baseline_losses``, ``baseline_peak_memory_gb``
    and ``vs_baseline``. Each arm starts from weights built anew from
    ``seed``."""
    kw = dict(lr=LR, seed=seed, device=device, block_fusion=block_fusion, loss=loss,
              remat=remat)

    def arm(**extra):
        r = pretrain.run(model, layers, batch, seq, steps, opt=make_opt(opt_state, slab_state),
                         **kw, **extra)
        gc.collect()   # the arm's jit function, its graph pool and its weights
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return r

    out = arm(profile=profile, params=params, state=state)
    out["opt_state_kind"] = opt_state
    if sentinel:
        guarded = arm(guard=NumericsGuardTransform(policy=disarmed_policy()))
        out["sentinel_step_ms"] = guarded["step_ms"]
        out["sentinel_overhead_pct"] = (guarded["step_ms"] - out["step_ms"]) / out["step_ms"] * 100
        out["sentinel_counts"] = guarded["sentinel"]
        out["sentinel_losses"] = guarded["losses"]
        out["sentinel_whole_program"] = guarded.get("whole_program")
        out["sentinel_whole_program_captures"] = guarded.get("whole_program_captures")
        out["sentinel_per_step"] = guarded["per_step"]
        out["sentinel_launches"] = guarded["launches"]
        out["sentinel_region_designs"] = guarded["region_designs"]
        out["sentinel_regions"] = guarded.get("regions")
        if "peak_memory_gb" in guarded:
            out["sentinel_peak_memory_gb"] = guarded["peak_memory_gb"]
    if baseline:
        base = arm(eager=True)
        out["baseline_step_ms"] = base["step_ms"]
        out["baseline_losses"] = base["losses"]
        out["baseline_launches"] = base["launches"]
        out["vs_baseline"] = base["step_ms"] / out["step_ms"]
        if "peak_memory_gb" in base:
            out["baseline_peak_memory_gb"] = base["peak_memory_gb"]
    if loss == "fused":
        probe = torch.empty(0, dtype=llama.CONFIGS[model].dtype, device=resolve_device(device))
        out["logits_route"] = tnn.flce_logits_route(probe)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama2-7b-bench", help="llama config name")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--loss", choices=("fused", "naive"), default="fused")
    ap.add_argument("--opt-state", choices=tuple(OPT_STATES), default="bf16")
    ap.add_argument("--slab-state", action="store_true",
                    help="m and v in persistent per-dtype slabs (AdamW(slab_persistent=True))")
    ap.add_argument("--remat", action="store_true", help="checkpoint every layer")
    ap.add_argument("--block-fusion", action=argparse.BooleanOptionalAction, default=None,
                    help="the planned rung (one mlp_subblock kernel pair per layer) or, with "
                         "--no-block-fusion, the per-op rung; unset, the cost model picks")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0,
                    help="trace this many more steps with torch.profiler")
    args = ap.parse_args()
    print(json.dumps(run(args.model, args.layers, args.batch, args.seq, args.steps, args.loss,
                         args.opt_state, args.slab_state, args.remat, args.block_fusion,
                         args.device, args.seed, args.profile)))


if __name__ == "__main__":
    main()
