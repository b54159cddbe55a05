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

Timing, launch counts and the profile are ``pretrain.run``'s: it prints one
JSON line with the step time, tokens/s, the share of the H100's 989 TFLOP/s
dense bf16 peak by model FLOPs (``flops_per_token``, not counting the
recompute), peak device memory, the optimizer's device time, launches
per step and the card line; this entry adds the fused loss's
logits route (``ops.nn.flce_logits_route``). ``--profile N`` traces N more
steps.

``sentinel_overhead_pct`` is the counterpart of ``bench.py:268-287``: the
same step under the numerics guard (``transforms.numerics_guard``: the
optimizer's health pass, the gated update and one health-word fetch per
step), its escalation disarmed as the reference disarms it, from fresh
weights of the same seed, timed against the unguarded step:
``(guarded_ms - step_ms) / step_ms * 100``.

Not ported: the pure ``jax.jit`` baseline arm and ``vs_baseline``,
``--breakdown``, ``--smoke`` and ``BENCH_FP8`` (FP8 waits for the port's FP8
layer).
"""

from __future__ import annotations

import argparse
import json

import torch

from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.devices import resolve_device
from thunder_tpu_torch.models import llama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.optim import AdamW
from thunder_tpu_torch.transforms.numerics_guard import NumericsGuard, disarmed_policy

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
        state: dict | None = None, sentinel: bool = True) -> dict:
    """One warm-up step and ``steps`` timed steps of the bench's train step
    through :func:`pretrain.run`; its report plus the bench's own choices.
    ``params`` and ``state`` (from ``make_opt(opt_state, slab_state).init``)
    are built from ``seed`` unless given; the steps update them in place.
    ``sentinel`` then times the same steps under the numerics guard, from
    weights built anew from ``seed``, and adds ``sentinel_step_ms`` and
    ``sentinel_overhead_pct``."""
    kw = dict(lr=LR, seed=seed, device=device, block_fusion=block_fusion, loss=loss,
              remat=remat)
    out = pretrain.run(model, layers, batch, seq, steps, profile=profile, params=params,
                       opt=make_opt(opt_state, slab_state), state=state, **kw)
    out["opt_state_kind"] = opt_state
    if sentinel:
        guarded = pretrain.run(model, layers, batch, seq, steps,
                               opt=make_opt(opt_state, slab_state),
                               guard=NumericsGuard(policy=disarmed_policy()), **kw)
        out["sentinel_step_ms"] = guarded["step_ms"]
        out["sentinel_overhead_pct"] = (guarded["step_ms"] - out["step_ms"]) / out["step_ms"] * 100
        out["sentinel_counts"] = guarded["sentinel"]
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
