#!/usr/bin/env python3
"""On-card smoke test of thunder_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero without the
final line):

1. card — the card's name and power limit, as nvidia-smi reports them;
2. build — nvcc builds every kernel from thunder_tpu_torch/csrc/;
3. kernels — each hand-written kernel against its plain PyTorch version at
   the serving path's full-width shapes in bf16 (8 decode rows and a
   512-row prefill chunk, D=4096, F=14336; paged attention with 8 kv heads,
   G=4, hd=128, 16-token pages, ragged lengths 1..2048), then timed beside
   its plain version, its bound and, where one PyTorch call computes the
   same function, that call;
4. card vs CPU — a float32 tiny-gqa engine on the card and on the CPU, same
   weights, mixed prompt lengths, a pool small enough to preempt: identical
   greedy tokens;
5. full width — llama3-8b at full width and depth (32 layers, bf16, random
   weights from a seed) serves 8 requests (prompts 17..1000 tokens, 32 new
   tokens each, 2 of them sampled); the launch counts show every decode step
   went through all four kernels, linear_act's 32 launches each on its
   weight-streaming design, paged_decode_attention's 32 on its split design
   and rms_norm's on its vector design.

``sdpa_fwd``, ``sdpa_bwd``, ``rms_norm``, ``linear_act``, ``decode_layer``
and ``attn_subblock`` have more than one design, chosen by the wrapper from
shape and dtype (``cudaex.sdpa_fwd_design``, ``cudaex.sdpa_bwd_design``,
``cudaex.rms_norm_design``, ``cudaex.linear_act_path``,
``cudaex.decode_design``), and ``paged_decode_attention`` counts its one
(``split``): every row of theirs names the design that ran (``sdpa_bwd``'s
also its design's 7-product floor beside the 5-product bound),
and phase 3 shows that the linear_act check fails two planted faults at the
decode and the prefill shape (the kernel on a weight with its last 16 rows,
or its last 64 K columns, zeroed, against the plain version of the intact
weight). The paged attention row is held element by element and row by row,
checked against the split design's plain model (``testing.paged_split_model``)
and bit-identical over two calls, and phase 3 shows that its check fails a
planted fault: the model with the longest request's last chunk left out of
the merge. Phases 5 and 11 require every decode step's bf16 launches of
``paged_decode_attention`` to take ``split`` and of ``decode_layer`` to take
``stream`` (the swap-AB ``mma.sync`` weight stream).

Phase 3 also runs ROADMAP C.1's inputs on the card (float16, a strided
input, a mixed weight dtype, head dims 8 and 192 through the attention
autograd function, ``linear_act`` at K = 518 on both paths,
``attn_subblock`` at tiny-tp's head dim 8): each launches its kernel and
matches the plain version. ``mlp_subblock``, ``mlp_subblock_bwd`` and
``linear_act``'s prefill tile run on ``gemm.cuh``'s TMA + ``wgmma``
mainloop in bf16: their rows name the design, and phases 5, 9, 11 and 13
require every bf16 launch of the three to have taken it (``stream`` for
``linear_act``'s decode rows).

Phase 3 also holds the train path's kernels against their plain versions at
its full-width shapes (the norms on (8, 2048, 4096) bf16 activations,
attention (8, 32, 2048, 128) bf16 causal and not, cross-entropy
16384 x 32000 f32, AdamW over llama3-8b-bench's 4-layer bucket of 1.1347 G
bf16 parameters with f32 moments), before any model is built: the plain
attention backward materialises several 4.3 GB f32 score tensors. It also
shows that the attention checks fail a fault planted in the last 64 causal
rows or keys, and that two ``sdpa_bwd`` calls at the causal train shape give
bit-identical gradients. Then:

6. train, card vs CPU — three float32 tiny-gqa train steps (4 layers,
   B=2, T=64) on the card and on the CPU from the same weights: the same
   losses and parameters;
7. train, full width — llama3-8b-bench (D=4096, 32/8 heads, F=14336, vocab
   32000, bf16) with depth cut to 4 layers, B=8, T=2048, AdamW(lr=1e-4):
   a warm-up step and 5 timed steps on one batch through the port's
   ``pretrain`` entry point; every step launches sdpa_fwd 4, sdpa_bwd 4,
   ce_fwd 1, fused_adamw 1, rms_norm 1 and rms_norm_residual 8 times, every
   sdpa_fwd and sdpa_bwd launch takes the TMA + wgmma design, and the losses
   are finite and falling.

The planned rung (``pretrain --block-fusion``, the reference's default step
at that shape): phase 3 also holds the MLP sub-block pair, ``mlp_subblock``
and ``mlp_subblock_bwd``, against their plain versions at the train shape
(N=16384, D=4096, F=14336 bf16, silu), row by row, shows that a dropped last
ff tile of ``out`` and zeroed last 64 rows of ``dw_gate`` fail that check,
and times each beside the per-op chain it replaces. Then:

8. planned train, card vs CPU — phase 6 at the planned rung;
9. planned train, full width — phase 7 at the planned rung: every step
   launches mlp_subblock 4, mlp_subblock_bwd 4, rms_norm 5, sdpa_fwd 4,
   sdpa_bwd 4, ce_fwd 1 and fused_adamw 1 times, rms_norm_residual never.

The serving planned rung (``ServingEngine(block_fusion=True)``, the
reference engine's default binding): phase 3 also holds ``decode_layer`` and
``attn_subblock`` (one cooperative launch each) against their plain versions
at the serving shape (8 slots, D=4096, 32/8 heads, hd=128, 16-token pages,
lengths 1..2048, F=14336, bf16 silu, one replay slot), each launch on the
``stream`` design, out and the fresh k/v rows row by row; shows that three
planted faults fail that check (the
longest request's last page left out, the last 128 rows of w_gate zeroed,
the replay row read from the pool instead of its fresh row); times each
beside its plain version, its bound and the per-op chain it replaces; and
holds ``mlp_subblock`` at the 512-row prefill chunk and at 8 rows. Then:

10. planned serving, card vs CPU — phase 4 at the planned rung (every decode
    step launches decode_layer 4 and rms_norm 1), and one tiny-gqa decode
    step at the sub-block rung (``attn_subblock`` then ``mlp_subblock`` per
    layer, the reference's ``nn.decode_layer`` decomposition) whose logits
    and pools equal the CPU's, the same composition and ``decode_layer_plain``;
11. planned serving, full width — phase 5 at the planned rung: every decode
    step launches decode_layer 32 (each on its stream design) and rms_norm 1,
    every prefill chunk
    rms_norm 32 and mlp_subblock 31; decode tok/s, TTFT and peak memory
    beside phase 5's.

The headline train bench (``benchmarks/bench.py``, the port of the
repo-root ``bench.py``'s step: fused chunked-vocab loss, bf16 first moments,
slab-persistent AdamW): phase 3 also holds the slab-persistent AdamW kernel,
``fused_adamw_slab``, at the bench bucket (llama2-7b-bench at 8 layers: one
bf16 bucket of 1,881,214,976 parameters, bf16 m slab, f32 v slab) and on a
bucket of odd sizes whose slab runs are misaligned (the kernel's scalar
path): bit-identical to the per-step ``fused_adamw`` kernel on copies of the
same values, within 4 ULP of its plain version, the pad tail still zero;
times it beside its plain version and its bound; and holds the MLP sub-block
pair at llama2-7b-bench's F = 11008 as at llama3-8b-bench's. Then:

12. bench, card vs CPU — three float32 tiny-gqa steps of the bench's step
    (4 layers, B=2, T=64, remat, slab state with bf16 m) on the card and on
    the CPU from the same weights: the same losses, parameters and slabs;
13. bench, full width — llama2-7b-bench (D=4096, 32 heads, F=11008, vocab
    32000, bf16) at 8 layers, B=8, T=2048, a warm-up step and 3 timed steps
    through the bench entry point, (a) ``--remat --slab-state``: every step
    launches rms_norm 25, rms_norm_residual 8, sdpa_fwd 16, sdpa_bwd 8 (the
    attention all wgmma) and fused_adamw_slab 1 times; (b) ``--slab-state
    --block-fusion``, the reference's default step at this shape: rms_norm 9,
    mlp_subblock 8, mlp_subblock_bwd 8, sdpa_fwd 8, sdpa_bwd 8,
    fused_adamw_slab 1; losses finite and falling; step time, tokens/s, the
    share of the bf16 peak, peak memory and the fused loss's logits route.

Training from a token file, checkpoints and gradient clipping
(``pretrain --data``, ``checkpoint``, ``optim.clip_grad_norm``):

14. train from a token file, checkpoint and resume — llama3-8b-bench at 2
    layers, B=8, T=2048, per-op rung, through ``pretrain.run`` from a file
    of 4 M random uint16 tokens the phase writes (seeded) into a temporary
    directory it removes at the end, after checking the disk's free space:
    (a) 4 steps straight through with ``audit``; (b) 2 steps, an
    asynchronous ``save_checkpoint`` of the parameters and AdamW state,
    ``wait_for_checkpoints``, every tensor dropped, ``load_checkpoint``, and
    2 more steps with ``start_step=2``. (b)'s losses, parameters and moments
    equal (a)'s bit for bit; the stream took its native (C++) path; every
    step launched the per-op rung's kernels, rms_norm_residual on its
    vector design. Prints the save's blocking and total seconds, the load's
    seconds, the checkpoint's bytes and the host ms per batch (its fetch,
    clip, pinned copy). Then ``clip_grad_norm`` on one step's full-width
    grads: its norm against a float64 sum of squares, its clipped grads
    against ``torch.nn.utils.clip_grad_norm_`` on copies, and grads below
    the threshold unchanged.

``rms_norm_residual``, like ``rms_norm``, has two designs
(``cudaex.rms_norm_residual_design``): phase 3 holds it at the decode and
train shapes, names its design (``vector``: one read of r and x into
registers, 16-byte accesses), times the per-op chain beside it (``torch.add``
then ``F.rms_norm``; no one PyTorch call computes both outputs), and shows
that its check fails a planted fault (the last row's sum of squares
without its last 256 values, through ``testing.rms_residual_fault``);
phases 5, 7, 13(a) and 14 require every bf16 launch of it to take
``vector``.

No phase can fall back to a plain version on the card: a CUDA call whose
inputs a kernel does not take raises in the kernel's wrapper, with the
reason ``cudaex.refusal`` gives, and fails its phase.

The last line of standard output is the JSON result the checker reads; the
line before it holds the kernels table (one row per kernel and main path,
with that path's shape and launch count), and the line before that the
card.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# spin-kernel cycles per millisecond: the H100's 1.98 GHz top clock, so the
# spin lasts at least as long as asked at any lower clock
SPIN_CYCLES_PER_MS = 1.98e6

# tolerances, kernel vs plain version on the same bf16 inputs:
# norms — about one bf16 ulp of the result (2**-7 relative), doubled because
#   the weight multiply rounds a second time after a possible one-ulp move;
# linear_act (K=4096) and paged attention — 2e-2 absolute + relative: f32
#   sums in another order, one bf16 rounding of the result; paged attention
#   also row by row, 2e-2 of each (request, head) row's largest value (the
#   longest requests' rows are small, and one dropped chunk of theirs must
#   fail the check).
NORM_RTOL = 2.0 ** -6
# rms_norm_residual's planted fault: the last row's sum of squares without
#   the squares of its last 256 values, what a block reduction that drops
#   one warp's partial computes at D = 4096 bf16 (32 threads x 8 values)
RESIDUAL_FAULT_VALUES = 256
GEMM_TOL = 2e-2
ATTN_TOL = 2e-2
# train kernels: attention output and gradients row by row, 2e-2 of each
#   row's own largest reference value or of a hundredth of the tensor's,
#   whichever is larger (row_rel_err: P and dS round to bf16
#   before their products; late causal rows and keys hold values tens of
#   times smaller than the tensor's largest, so a bound relative to the
#   whole tensor would pass a fault there, and the check must fail the
#   planted ones); lse 1e-3 absolute (f32 sums over hd=128 products and
#   2048 exponentials in another order, values ~10); cross-entropy 1e-5 relative
#   (f32 sums of 32000 exponentials in another order); AdamW 4 ULP of each
#   stored dtype, the bound the JAX suite pins (the kernel repeats the plain
#   op order, each operation rounded on its own, so 0 is expected).
LSE_TOL = 1e-3
GRAD_REL_TOL = 2e-2
CE_RTOL = 1e-5
ADAMW_ULP = 4
# phase 6, card vs CPU in float32: losses 1e-5 relative (sums in another
#   order); parameters after 3 AdamW steps at lr 1e-3 within 0.2 lr: an
#   element whose gradient is within f32 noise of zero takes a noise-decided
#   Adam step of up to lr (tests/test_torch_port_training.py)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_LR = 1e-3
TRAIN_PARAM_ATOL = 0.2 * TRAIN_LR

# the MLP sub-block pair, row by row: out and dh per token, each weight
#   gradient per output row, 2e-2 of the row's largest reference value (or a
#   hundredth of the tensor's): act(gate), up, their product, dgpre and dup
#   round to bf16 before the next product, where a one-step difference in an
#   f32 sum moves them. The activations r and x are drawn at scale 0.25 so
#   that the MLP's term, not the residual, sets a row's largest value: a
#   dropped 128-wide ff tile must fail the check.
SUBBLOCK_TOL = 2e-2
FAULT_FF_TILE = 128
# the decode layer and its attention half, row by row: out and the fresh k/v
#   rows, 2e-2 of each row's largest reference value (or a hundredth of the
#   tensor's): the normed rows, the probabilities, act(gate) and up round to
#   bf16 before the next product, where a one-step difference in an f32 sum
#   (the attention split across blocks, the products' order) moves them
DECODE_TOL = 2e-2
# phase 10's sub-block decode step, float32 card vs CPU: logits and pools
#   1e-5 absolute (sums in another order; logits of order 1)
SUBBLOCK_STEP_TOL = 1e-5

ATTN_SHAPE = (8, 32, 2048, 128)
CE_SHAPE = (16384, 32000)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 2048, 5
# the headline train bench (phase 13): llama2-7b-bench at 8 layers, B=8,
# T=2048, a warm-up step and 3 timed steps; its MLP width
BENCH_LAYERS, BENCH_STEPS, BENCH_F = 8, 3, 11008
# phase 12's slabs, card vs CPU: the training test's m 1e-6 and v 1e-9
#   absolute, and for the bf16 m slab two bf16 rounding steps of the larger
#   of the two values besides (2**-6 of it). The gradients differ by f32
#   summation order and, after the first step, by the parameters' own
#   noise-decided differences (phase 6's 0.2 lr), so a stored m can land one
#   rounding step off in one step and carry it, decayed by beta1 = 0.9, into
#   the next, where its own rounding can add a step
SLAB_M_RTOL, SLAB_M_ATOL, SLAB_V_ATOL = 2.0 ** -6, 1e-6, 1e-9
# phase 14: llama3-8b-bench at 2 layers, B=8, T=2048, per-op rung, from a
# token file of 4 M random uint16 tokens (2047 windows of 2049): (a) 4 steps
# straight through, (b) 2 steps, a checkpoint and a resume for 2 more
RESUME_LAYERS, RESUME_TOKENS, RESUME_DATA_SEED = 2, 1 << 22, 3
# clip_grad_norm on one step's grads: its float32 norm against a float64 sum
#   of squares, 1e-5 relative (float32 sums over 0.7 G squares in another
#   order); its clipped grads against torch.nn.utils.clip_grad_norm_ on
#   copies within 2**-6 relative: torch takes the norm of bf16 grads in bf16
#   (one rounding, 2**-9), so its scale differs from ours by that and the
#   bf16 product can land one rounding step (2**-8) apart
CLIP_NORM_RTOL = 1e-5
CLIP_RTOL = 2.0 ** -6

D, F_DIM, S_DECODE, M_PREFILL = 4096, 14336, 8, 512
KV, G, HD, PS = 8, 4, 128, 16
LENGTHS = [1, 17, 300, 512, 1000, 1500, 2047, 2048]
REPLAY = 1   # the decode slot that replays its last prompt token
EPS = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 30, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls.

    A call of a small kernel takes the host longer to issue than the card
    to run, so the calls are queued behind a spin kernel that outlasts the
    host's issuing them: the events then time the card's work back to back,
    not the host's gaps between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * issue_ms + 5.0) * SPIN_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def timed_row(torch, cudaex, name, shape_tag, err, kernel_fn, plain_fn, lib_fn, bytes_moved,
              ops, peak, iters=30, plain_iters=30):
    """A kernel's row of the table, once it has been held against its plain
    version (``err``: the largest absolute difference): its time, its plain
    version's, its bound from this run's inputs and, where one PyTorch call
    computes the same function, that call's time."""
    b_ms, b_by = bound(bytes_moved, ops, peak)
    lib_ms, lib_note = None, None
    if lib_fn is not None:
        try:
            lib_ms = time_ms(torch, lib_fn, iters)
        except (RuntimeError, TypeError) as e:   # a library call that refuses these inputs
            lib_note = f"{type(e).__name__}: {str(e)[:160]}"
    row = {"name": name, "route": "cuda", "source": cudaex.KERNELS[name].source,
           "replaces": cudaex.KERNELS[name].replaces, "shape": shape_tag,
           "max_abs_err": err, "ms": time_ms(torch, kernel_fn, iters),
           "plain_ms": time_ms(torch, plain_fn, plain_iters, warmup=1), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}
    if lib_note:
        row["library_note"] = lib_note
    log(f"  {name:24s} {shape_tag:14s} err {err:.3e}  kernel {row['ms']:.4f} ms  "
        f"plain {row['plain_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by})  library "
        f"{lib_ms if lib_ms is None else round(lib_ms, 4)}{' ' + lib_note if lib_note else ''}")
    return row


def design_delta(before: dict, after: dict) -> dict:
    """Launches by design between two ``cudaex.design_counts()`` readings."""
    out = {}
    for name, ds in after.items():
        d = {k: n - before.get(name, {}).get(k, 0) for k, n in ds.items()}
        d = {k: n for k, n in d.items() if n}
        if d:
            out[name] = d
    return out


def ran(cudaex, name, fn):
    """``fn()`` and the design of ``name`` that its one launch took."""
    before = cudaex.design_counts()
    out = fn()
    used = design_delta(before, cudaex.design_counts()).get(name, {})
    require(list(used.values()) == [1], f"{name}: one call launched {used} by design")
    return out, next(iter(used))


def gemm_close(torch, got, want) -> bool:
    return bool(torch.allclose(got.float(), want.float(), atol=GEMM_TOL, rtol=GEMM_TOL))


def linear_act_faults(torch, cudaex, x, w, want) -> dict:
    """The linear_act check's power: the kernel on inputs with the last 16
    weight rows zeroed (a dropped 16-row weight tile) and with the last 64 K
    columns of the weight zeroed (a dropped K slab), each held against the
    plain version of the intact inputs, must fail the check. Returns each
    fault's largest absolute error."""
    found = {}
    for fault, cut in (("last 16 weight rows zeroed", (slice(-16, None), slice(None))),
                       ("last 64 K columns zeroed", (slice(None), slice(-64, None)))):
        bad_w = w.clone()
        bad_w[cut] = 0
        got = cudaex.linear_act(x, bad_w, None, "silu")
        found[fault] = float((got.float() - want.float()).abs().max())
        require(not gemm_close(torch, got, want),
                f"linear_act {tuple(x.shape)}: the check passes a planted fault ({fault}: "
                f"{found[fault]})")
        del bad_w, got
    return found


def norm_rows(torch, cudaex, tnn, gen, shape):
    """rms_norm and rms_norm_residual on bf16 ``shape`` (rows of its last
    dim) against their plain versions, each on its vector design, and a
    fault planted in rms_norm_residual's output that the check must fail;
    their rows of the table."""
    import torch.nn.functional as F

    from thunder_tpu_torch.testing import rms_residual_fault

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    x, r = (torch.randn(*shape, generator=gen, device=dev).to(bf16) for _ in range(2))
    d = shape[-1]
    w = (torch.rand(d, generator=gen, device=dev) + 0.5).to(bf16)
    n, tag = x.numel(), "x".join(map(str, shape))
    iters = 30 if n <= M_PREFILL * D else 10
    got, design = ran(cudaex, "rms_norm", lambda: cudaex.rms_norm(x, w, EPS))
    require(design == "vector", f"rms_norm {tag}: bf16 rows of {d} took {design}")
    want = tnn.rms_norm_plain(x, w, EPS)
    diff = (got.float() - want.float()).abs()
    require(bool((diff <= want.float().abs() * NORM_RTOL + 1e-6).all()),
            f"rms_norm {tag}: kernel disagrees with its plain version ({float(diff.max())})")
    rows = [timed_row(torch, cudaex, "rms_norm", tag, float(diff.max()),
                      lambda: cudaex.rms_norm(x, w, EPS), lambda: tnn.rms_norm_plain(x, w, EPS),
                      lambda: F.rms_norm(x, (d,), w, EPS), 2 * n * 2 + d * 2, 4 * n,
                      F32_FLOPS, iters, iters)]
    rows[0]["design"] = design
    log(f"    design {design}")
    (gh, gy), design = ran(cudaex, "rms_norm_residual",
                           lambda: cudaex.rms_norm_residual(r, x, w, EPS))
    require(design == "vector", f"rms_norm_residual {tag}: bf16 rows of {d} took {design}")
    wh, wy = tnn.rms_norm_residual_plain(r, x, w, EPS)
    dh, dy = (gh.float() - wh.float()).abs(), (gy.float() - wy.float()).abs()
    err = float(max(dh.max(), dy.max()))
    require(residual_close(torch, gh, gy, wh, wy),
            f"rms_norm_residual {tag}: kernel disagrees with its plain version ({err})")
    bad_y = rms_residual_fault(gh, w, EPS, RESIDUAL_FAULT_VALUES)
    fault = float((bad_y.float() - wy.float()).abs().max())
    require(not residual_close(torch, gh, bad_y, wh, wy),
            f"rms_norm_residual {tag}: the check passes a planted fault (the last row's sum "
            f"of squares without its last {RESIDUAL_FAULT_VALUES} values: {fault})")
    del bad_y
    row = timed_row(torch, cudaex, "rms_norm_residual", tag, err,
                    lambda: cudaex.rms_norm_residual(r, x, w, EPS),
                    lambda: tnn.rms_norm_residual_plain(r, x, w, EPS), None,
                    4 * n * 2 + d * 2, 5 * n, F32_FLOPS, iters, iters)
    # no one PyTorch call computes (h, rms_norm(h)): the per-op chain beside it
    row["per_op_chain_ms"] = time_ms(torch, lambda: F.rms_norm(torch.add(r, x), (d,), w, EPS),
                                     iters)
    row["design"], row["planted_faults"] = design, {
        f"last row's sum of squares without its last {RESIDUAL_FAULT_VALUES} values": fault}
    log(f"    design {design}; per-op chain (torch.add, F.rms_norm) "
        f"{row['per_op_chain_ms']:.4f} ms; planted fault (the check must fail): "
        f"{json.dumps(row['planted_faults'])}")
    rows.append(row)
    return rows


def residual_close(torch, gh, gy, wh, wy) -> bool:
    """rms_norm_residual's check: h bit for bit, y within NORM_RTOL."""
    dy = (gy.float() - wy.float()).abs()
    return bool(torch.equal(gh, wh)) and bool((dy <= wy.float().abs() * NORM_RTOL + 1e-6).all())


def require_residual_vector(what: str, designs: dict, counts: dict) -> None:
    """Every rms_norm_residual launch of a bf16 path took the vector design."""
    n = counts.get("rms_norm_residual", 0)
    require(designs.get("rms_norm_residual", {}) == ({"vector": n} if n else {}),
            f"{what}: rms_norm_residual launched {n} times by design "
            f"{designs.get('rms_norm_residual')}, expected every one vector")


# the kernels on gemm.cuh's mainloops: every bf16 launch takes the TMA + wgmma
# design (linear_act's decode rows take its weight stream)
GEMM_KERNELS = ("mlp_subblock", "mlp_subblock_bwd", "linear_act")


def require_wgmma(what: str, designs: dict) -> None:
    for name in GEMM_KERNELS:
        off = {d: n for d, n in designs.get(name, {}).items() if d not in ("wgmma", "stream")}
        require(not off, f"{what}: {name} launched {off} off the wgmma mainloop")


def require_attention_wgmma(what: str, designs: dict, counts: dict) -> None:
    """Every sdpa_fwd and sdpa_bwd launch of a train path (bf16, hd 128)
    took the TMA + wgmma design."""
    for name in ("sdpa_fwd", "sdpa_bwd"):
        require(designs.get(name) == {"wgmma": counts[name]},
                f"{name} launches by design {designs.get(name)}: every one of {what}'s "
                f"{counts[name]} must take wgmma")


def check_c1_inputs(torch, cudaex, tnn) -> dict:
    """ROADMAP C.1's inputs, which the reference computes through its
    decomposition, on the card: each routed call launches its kernel and
    matches the plain version on the same inputs (float16 and the mixed
    weight dtype within the norms' NORM_RTOL, the strided float32 input
    1e-5, attention forward and gradients and the decode sub-block row by
    row at GRAD_REL_TOL, linear_act GEMM_TOL). {case: {kernel, launches,
    err}}."""
    from thunder_tpu_torch.testing import row_rel_err

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x16, w16 = rnd(8, D, dtype=torch.float16), rnd(D, dtype=torch.float16)
    xs, wf, xb = rnd(D, 8).t(), rnd(D), rnd(8, D, dtype=torch.bfloat16)
    a518, w518 = rnd(8, 518, dtype=torch.bfloat16), rnd(64, 518, dtype=torch.bfloat16)
    a518t = rnd(M_PREFILL, 518, dtype=torch.bfloat16)
    # tiny-tp's decode shape: D 64, 8 heads of 8 over 8 kv heads, F 192
    dec, _ = decode_inputs(torch, tnn, dev, (len(LENGTHS), 64, 8, 8, 8, PS, 192))

    def attn(hd):   # forward and backward through the autograd function, and plain
        q, k, v, g = (rnd(2, 8, 256, hd, dtype=torch.bfloat16) for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tnn.scaled_dot_product_attention(*leaves, is_causal=True)
        out.backward(g)
        # the plain backward from the (out, lse) the forward kernel saved
        o, lse = tnn.sdpa_fwd(q, k, v, True)
        return ([out.detach()] + [t.grad for t in leaves],
                [tnn.sdpa_fwd_plain(q, k, v, True)[0], *tnn.sdpa_bwd_plain(g, q, k, v, o, lse,
                                                                         True)])

    def pair(fn, plain, *args):
        return lambda: ([fn(*args)], [plain(*args)])

    cases = {
        "float16": ("rms_norm", pair(tnn.rms_norm, tnn.rms_norm_plain, x16, w16), "norm"),
        "strided": ("rms_norm", pair(tnn.rms_norm, tnn.rms_norm_plain, xs, wf), 1e-5),
        "mixed weight dtype": ("rms_norm", pair(tnn.rms_norm, tnn.rms_norm_plain, xb, wf),
                               "norm"),
        "hd 8": ("sdpa_bwd", lambda: attn(8), "rows"),
        "hd 192": ("sdpa_bwd", lambda: attn(192), "rows"),
        "K 518 bf16": ("linear_act", pair(tnn.linear_act, tnn.linear_act_plain, a518, w518,
                                          None, "silu"), GEMM_TOL),
        "K 518 bf16, tile path": ("linear_act", pair(tnn.linear_act, tnn.linear_act_plain,
                                                     a518t, w518, None, "silu"), GEMM_TOL),
        "attn_subblock hd 8": ("attn_subblock", lambda: (list(cudaex.attn_subblock(*dec)),
                                                         list(tnn.attn_subblock_plain(*dec))),
                               "rows"),
    }
    found = {}
    for case, (kernel, run, tol) in cases.items():
        cudaex.reset_launch_counts()
        got, want = run()
        torch.cuda.synchronize()
        launches = cudaex.launch_counts()[kernel]
        require(launches > 0, f"C.1 {case}: {kernel} never launched ({cudaex.launch_counts()})")
        err = 0.0
        for a, b in zip(got, want):
            require(a.dtype == b.dtype and a.shape == b.shape,
                    f"C.1 {case}: {a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
            if tol == "rows":
                e = row_rel_err(a, b)
                ok = e <= GRAD_REL_TOL
            else:
                e = float((a.float() - b.float()).abs().max())
                bound = NORM_RTOL if tol == "norm" else tol
                ok = bool(torch.allclose(a.float(), b.float(), atol=bound, rtol=bound))
            require(ok, f"C.1 {case}: {kernel} disagrees with its plain version ({e})")
            err = max(err, e)
        found[case] = {"kernel": kernel, "launches": launches, "err": err}
    # the tile path's K pad: the same call at K = 518 (A and W padded to 520
    # in the wrapper) and at K = 520 (no copy)
    a520, w520 = rnd(M_PREFILL, 520, dtype=torch.bfloat16), rnd(64, 520, dtype=torch.bfloat16)
    found["K 518 bf16, tile path"]["ms"] = time_ms(
        torch, lambda: tnn.linear_act(a518t, w518, None, "silu"), 20)
    found["K 518 bf16, tile path"]["ms_at_K_520"] = time_ms(
        torch, lambda: tnn.linear_act(a520, w520, None, "silu"), 20)
    log("  C.1 inputs on the card (kernel, launches, largest error): " + json.dumps(found))
    return found


def paged_close(torch, got, want) -> bool:
    """The paged attention check: every element within ATTN_TOL absolute +
    relative, and every (request, head) row within ATTN_TOL of its own
    largest value (a long request's rows are small: an element-wise bound
    alone is loose there)."""
    from thunder_tpu_torch.testing import row_rel_err

    return (bool(torch.allclose(got.float(), want.float(), atol=ATTN_TOL, rtol=ATTN_TOL))
            and row_rel_err(got, want) <= ATTN_TOL)


def paged_fault(torch, cudaex, tnn, got, q, kp, vp, bt, ln) -> dict:
    """The paged check's power: the split design's plain model
    (``testing.paged_split_model``) with the longest request's last chunk
    left out of the merge must fail the check against the kernel's output,
    while the intact model passes it. Returns the fault's row error."""
    from thunder_tpu_torch.testing import paged_split_model, row_rel_err

    B, H, _, hd = q.shape
    keys, _, _ = cudaex.paged_geometry(B, H, kp.shape[0], hd, kp.shape[2], bt.shape[1], q.dtype)
    longest = max(range(B), key=lambda b: LENGTHS[b])
    last = (LENGTHS[longest] - 1) // keys
    require(paged_close(torch, got, paged_split_model(q, kp, vp, bt, ln, keys)),
            "paged_decode_attention: the kernel disagrees with the split design's model")
    bad = paged_split_model(q, kp, vp, bt, ln, keys, drop={(longest, last)})
    err = row_rel_err(got, bad)
    require(not paged_close(torch, got, bad),
            f"paged_decode_attention: the check passes a planted fault (the longest request's "
            f"last chunk left out of the merge: {err})")
    return {"last chunk of the longest request left out": err}


def check_kernels(torch, cudaex, tnn):
    """The serving path's four kernels at its shapes: {name: [rows]}, the
    decode shape's row first."""
    import torch.nn.functional as F

    from thunder_tpu_torch.testing import row_rel_err

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    rows = {}

    def add(row):
        rows.setdefault(row["name"], []).append(row)

    for n in (S_DECODE, M_PREFILL):
        for row in norm_rows(torch, cudaex, tnn, gen, (n, D)):
            add(row)
        # linear_act (the gate projection: silu), then the planted faults
        x, wg = randn(n, D), randn(F_DIM, D, scale=D ** -0.5)
        got, design = ran(cudaex, "linear_act", lambda: cudaex.linear_act(x, wg, None, "silu"))
        require(design == ("stream" if n <= 16 else "wgmma"),
                f"linear_act {n} rows: bf16 launch took {design}")
        want = tnn.linear_act_plain(x, wg, None, "silu")
        err = float((got.float() - want.float()).abs().max())
        require(gemm_close(torch, got, want),
                f"linear_act {n}x{D}x{F_DIM}: kernel disagrees with its plain version ({err})")
        faults = linear_act_faults(torch, cudaex, x, wg, want)
        row = timed_row(torch, cudaex, "linear_act", f"{n}x{D}x{F_DIM}", err,
                        lambda: cudaex.linear_act(x, wg, None, "silu"),
                        lambda: tnn.linear_act_plain(x, wg, None, "silu"),
                        lambda: F.linear(x, wg), (n * D + F_DIM * D + n * F_DIM) * 2,
                        2.0 * n * F_DIM * D, BF16_FLOPS)
        row["design"], row["planted_faults"] = design, faults
        log(f"    design {design}; planted faults (max abs err, the check must fail): "
            + json.dumps(faults))
        add(row)
        del wg, got, want

    # paged decode attention: 8 requests, ragged lengths 1..2048, over pools
    # holding every request's pages; timing rotates over 4 pool copies so
    # each launch finds its pages out of the 50 MB L2, as a decode step's
    # layers do
    B, H = len(LENGTHS), KV * G
    npg = 2048 // PS
    P = B * npg + 1
    q = randn(B, H, 1, HD)
    pools = [(randn(KV, P, PS, HD), randn(KV, P, PS, HD)) for _ in range(4)]
    perm = torch.randperm(P - 1, generator=gen, device=dev).add_(1).to(torch.int32)
    bt = torch.zeros(B, npg, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(LENGTHS):
        k = -(-n // PS)
        bt[b, :k] = perm[used:used + k]
        used += k
    ln = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    kp, vp = pools[0]
    got, design = ran(cudaex, "paged_decode_attention",
                      lambda: cudaex.paged_decode_attention(q, kp, vp, bt, ln))
    require(design == "split", f"paged_decode_attention: bf16 launch took {design}")
    want = tnn.paged_decode_attention_plain(q, kp, vp, bt, ln)
    err = float((got.float() - want.float()).abs().max())
    require(paged_close(torch, got, want),
            f"paged_decode_attention: kernel disagrees with its plain version ({err}, rows "
            f"{row_rel_err(got, want)})")
    require(bool(torch.equal(got, cudaex.paged_decode_attention(q, kp, vp, bt, ln))),
            "paged_decode_attention: two calls differ")
    fault = paged_fault(torch, cudaex, tnn, got, q, kp, vp, bt, ln)
    turn = [0]

    def paged_rotating():
        kp_, vp_ = pools[turn[0] % 4]
        turn[0] += 1
        return cudaex.paged_decode_attention(q, kp_, vp_, bt, ln)

    ctx = sum(LENGTHS)
    pages_read = sum(-(-n // PS) for n in LENGTHS)
    row = timed_row(torch, cudaex, "paged_decode_attention", f"B{B}:1..2048", err,
                    paged_rotating, lambda: tnn.paged_decode_attention_plain(q, kp, vp, bt, ln),
                    None, 2 * B * H * HD * 2 + ctx * KV * HD * 2 * 2 + pages_read * KV * 4 + B * 4,
                    4.0 * ctx * H * HD, BF16_FLOPS)
    row["design"], row["row_rel_err"], row["planted_faults"] = design, row_rel_err(got, want), fault
    log(f"    design {design}; row check {row['row_rel_err']:.3e}; bit-identical over two "
        f"calls; planted fault (the check must fail): {json.dumps(fault)}")
    add(row)
    del pools
    torch.cuda.empty_cache()
    return rows


def planted_faults(torch, out, want_out, grads, want_grads) -> dict:
    """The attention checks' power, on the causal case: the kernel's own
    results with a fault planted in the last 64 rows or keys (an output 10%
    off, a dK or dV tile zeroed, as a causal loop that starts or stops one
    tile wrong would leave them) must fail the row check. For each, whether
    a check relative to the whole tensor's largest value would have passed
    it."""
    from thunder_tpu_torch.testing import row_rel_err

    def whole(tol, bad, ref):
        return float((bad.float() - ref.float()).abs().max()) <= tol * float(ref.float().abs().max())

    found = {}
    for name, got, ref, factor, tol in (("out x0.9", out, want_out, 0.9, ATTN_TOL),
                                        ("dk x0", grads[1], want_grads[1], 0.0, GRAD_REL_TOL),
                                        ("dv x0", grads[2], want_grads[2], 0.0, GRAD_REL_TOL)):
        bad = got.clone()
        bad[..., -64:, :] *= factor
        err = row_rel_err(bad, ref)
        require(err > tol, f"the row check passes a planted fault ({name}: {err})")
        found[name] = {"row_rel_err": err, "whole_tensor_check_passes": whole(tol, bad, ref)}
        del bad
    return found


def check_train_kernels(torch, cudaex, tnn, toptim_ops, tllama):
    """The train path's kernels against their plain versions at its
    full-width shapes, each timed beside its plain version, its bound and
    one library call that computes the same function: {name: [rows]}, the
    train path's own shape first."""
    import torch.nn.functional as F

    from thunder_tpu_torch.optim import tree_leaves
    from thunder_tpu_torch.testing import row_rel_err, ulp_distance

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    rows = {}

    # the norms at the train path's (B, T, D) activations
    for row in norm_rows(torch, cudaex, tnn, gen, (TRAIN_BATCH, TRAIN_SEQ, D)):
        rows[row["name"]] = [row]
    torch.cuda.empty_cache()

    # attention forward and backward, causal (the train path) and not, each
    # output and gradient held row by row (row_rel_err)
    B, H, T, hd = ATTN_SHAPE
    q, k, v, g = (torch.randn(ATTN_SHAPE, generator=gen, device=dev).to(bf16)
                  for _ in range(4))
    bh_t = B * H * T
    for causal in (True, False):
        tag = f"{B}x{H}x{T}x{hd}{' causal' if causal else ''}"
        frac = 0.5 if causal else 1.0
        (out, lse), design = ran(cudaex, "sdpa_fwd", lambda: cudaex.sdpa_fwd(q, k, v, causal))
        want_out, want_lse = tnn.sdpa_fwd_plain(q, k, v, causal)
        err = float((out.float() - want_out.float()).abs().max())
        out_rel = row_rel_err(out, want_out)
        lse_err = float((lse - want_lse).abs().max())
        require(out_rel <= ATTN_TOL and lse_err <= LSE_TOL,
                f"sdpa_fwd {tag}: out err {out_rel} of its rows' largest values (abs {err}), "
                f"lse err {lse_err}")
        row = timed_row(
            torch, cudaex, "sdpa_fwd", tag, err, lambda: cudaex.sdpa_fwd(q, k, v, causal),
            lambda: tnn.sdpa_fwd_plain(q, k, v, causal),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
            4 * bh_t * hd * 2 + bh_t * 4, 4.0 * bh_t * T * hd * frac, BF16_FLOPS, 10, 3)
        row["design"] = design
        log(f"    design {design}")
        rows.setdefault("sdpa_fwd", []).append(row)
        # the backward from the plain forward's (out, lse), so it is held alone
        got, bwd_design = ran(cudaex, "sdpa_bwd",
                              lambda: cudaex.sdpa_bwd(g, q, k, v, want_out, want_lse, causal))
        require(bwd_design == "wgmma", f"sdpa_bwd {tag}: bf16 hd {hd} took {bwd_design}")
        want = tnn.sdpa_bwd_plain(g, q, k, v, want_out, want_lse, causal)
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
        rels = [row_rel_err(a, b) for a, b in zip(got, want)]
        require(max(rels) <= GRAD_REL_TOL,
                f"sdpa_bwd {tag}: dq/dk/dv err {rels} of their rows' largest values")
        log(f"  attention {tag}: out {out_rel:.3e}, dq/dk/dv "
            f"{', '.join(f'{r:.3e}' for r in rels)} of their rows' largest values")
        if causal:
            log("  planted faults: " + json.dumps(planted_faults(torch, out, want_out, got,
                                                                 want)))
            again = cudaex.sdpa_bwd(g, q, k, v, want_out, want_lse, causal)
            require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                    f"sdpa_bwd {tag}: two calls on the same inputs differ")
            log("  sdpa_bwd deterministic: two calls give bit-identical dq, dk, dv")
            del again
        del got, want
        lib = None
        try:
            fa = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal)

            def lib():
                return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    g, q, k, v, fa[0], fa[1], fa[2], fa[3], fa[4], fa[5], 0.0, causal,
                    fa[6], fa[7])
        except (RuntimeError, TypeError) as e:
            log(f"  aten flash attention unavailable: {str(e).splitlines()[0][:200]}")
        row = timed_row(
            torch, cudaex, "sdpa_bwd", tag, max(errs),
            lambda: cudaex.sdpa_bwd(g, q, k, v, want_out, want_lse, causal),
            lambda: tnn.sdpa_bwd_plain(g, q, k, v, want_out, want_lse, causal), lib,
            8 * bh_t * hd * 2 + bh_t * 4, 10.0 * bh_t * T * hd * frac, BF16_FLOPS, 10, 3)
        # the design recomputes S and dP in its dQ pass: 7 products, not 5
        row["design"] = bwd_design
        log(f"    design {bwd_design}, its 7-product floor "
            f"{14.0 * bh_t * T * hd * frac / BF16_FLOPS * 1e3:.4f} ms")
        rows.setdefault("sdpa_bwd", []).append(row)
        del out, lse, want_out, want_lse, lib
        gc.collect()
        torch.cuda.empty_cache()
    del q, k, v, g

    # cross-entropy over the loss's f32 logits, with some ignored rows
    N, V = CE_SHAPE
    logits = torch.randn(CE_SHAPE, generator=gen, device=dev) * 2.0
    target = torch.randint(0, V, (N,), generator=gen, device=dev)
    target[::97] = -100
    nll, lse = cudaex.ce_fwd(logits, target)
    want_nll, want_lse = tnn.ce_fwd_plain(logits, target)
    err = float(max((nll - want_nll).abs().max(), (lse - want_lse).abs().max()))
    for a, b in ((nll, want_nll), (lse, want_lse)):
        require(torch.allclose(a, b, rtol=CE_RTOL, atol=CE_RTOL * float(b.abs().max())),
                f"ce_fwd: err {err}")
    require(float(nll[::97].abs().max()) == 0.0, "ce_fwd: an ignored row has a non-zero nll")
    rows["ce_fwd"] = [timed_row(
        torch, cudaex, "ce_fwd", f"{N}x{V} f32", err, lambda: cudaex.ce_fwd(logits, target),
        lambda: tnn.ce_fwd_plain(logits, target),
        lambda: F.cross_entropy(logits, target, reduction="none"),
        N * V * 4 + N * 8 + 2 * N * 4, 4.0 * N * V, F32_FLOPS, 10, 3)]
    log("    (library: F.cross_entropy(reduction='none') gives nll without lse)")
    del logits, target, nll, lse, want_nll, want_lse

    # AdamW over the 4-layer llama3-8b-bench bucket: one launch, in place
    cfg = tllama.CONFIGS["llama3-8b-bench"]
    ps = tree_leaves(tllama.init_params(cfg, seed=2, device=dev, n_layers=TRAIN_LAYERS))
    n = sum(p.numel() for p in ps)
    gs = [torch.randn(p.shape, generator=gen, device=dev).mul_(1e-3).to(bf16) for p in ps]
    ms = [torch.randn(p.shape, generator=gen, device=dev).mul_(1e-3) for p in ps]
    vs = [torch.rand(p.shape, generator=gen, device=dev).mul_(1e-6) for p in ps]
    step = 10
    bc = torch.tensor([1 - 0.9 ** step, 1 - 0.999 ** step], dtype=torch.float32, device=dev)
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    want = [toptim_ops.adamw_step_plain(p, g_, m, v_, bc[0], bc[1], **hyper)
            for p, g_, m, v_ in zip(ps, gs, ms, vs)]
    cudaex.fused_adamw(ps, gs, ms, vs, bc, **hyper)
    torch.cuda.synchronize()
    ulp = max(ulp_distance(a, b) for got, w in zip(zip(ps, ms, vs), want)
              for a, b in zip(got, w))
    err = max(float((a.float() - b.float()).abs().max()) for got, w in zip(zip(ps, ms, vs), want)
              for a, b in zip(got, w))
    del want
    require(ulp <= ADAMW_ULP, f"fused_adamw: {ulp} ULP from adamw_step_plain")
    log(f"  fused_adamw: {len(ps)} tensors, {n} parameters, max {ulp} ULP from the plain version")

    def plain_adamw():
        for p, g_, m, v_ in zip(ps, gs, ms, vs):
            toptim_ops.adamw_step_plain(p, g_, m, v_, bc[0], bc[1], **hyper)

    lib = None
    if hasattr(torch, "_fused_adamw_"):
        lp, lm, lv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
        steps_t = [torch.full((), float(step), device=dev) for _ in ps]

        def lib():
            torch._fused_adamw_(lp, gs, lm, lv, [], steps_t, lr=hyper["lr"], beta1=0.9,
                                beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
                                maximize=False)
    rows["fused_adamw"] = [timed_row(
        torch, cudaex, "fused_adamw", f"{n} bf16", err,
        lambda: cudaex.fused_adamw(ps, gs, ms, vs, bc, **hyper), plain_adamw,
        lib, n * 22, 12.0 * n, F32_FLOPS, 10, 2)]
    del ps, gs, ms, vs, lib
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def slab_bucket(torch, tllama, toptim, gen, cfg_name, layers):
    """The bench bucket of ``cfg_name`` at ``layers`` layers in the
    optimizer's slab layout: its bf16 parameters (random, from the model's
    init), bf16 gradients, a bf16 m slab and an f32 v slab whose runs hold
    random moments (as after a few steps) and whose pad tail is zero, and
    the members' sizes in layout order."""
    from thunder_tpu_torch.optim import tree_leaves

    dev = torch.device("cuda")
    params = tllama.init_params(tllama.CONFIGS[cfg_name], seed=2, device=dev, n_layers=layers)
    (key, members), = toptim.AdamW._slab_layout(params)
    leaves = tree_leaves(params)
    ps = [leaves[i] for i, _, _ in members]
    sizes = [sz for _, _, sz in members]
    return ps, *slab_state(torch, gen, ps, sizes), sizes


def slab_state(torch, gen, ps, sizes):
    """Gradients for ``ps`` and (m, v) slabs of their sizes, pad tail zero."""
    from thunder_tpu_torch.ops.optim import SLAB_LANE, slab_geometry

    dev, total = ps[0].device, sum(sizes)
    gs = [torch.randn(p.shape, generator=gen, device=dev).mul_(1e-3).to(p.dtype) for p in ps]
    rows, _ = slab_geometry(total)
    m = torch.zeros(rows, SLAB_LANE, dtype=torch.bfloat16, device=dev)
    v = torch.zeros(rows, SLAB_LANE, dtype=torch.float32, device=dev)
    m.view(-1)[:total] = torch.randn(total, generator=gen, device=dev).mul_(1e-3).to(m.dtype)
    v.view(-1)[:total] = torch.rand(total, generator=gen, device=dev).mul_(1e-6)
    return gs, m, v


def hold_slab_kernel(torch, cudaex, toptim_ops, ps, gs, m, v, sizes, bc, hyper) -> dict:
    """One launch of the slab kernel against the per-step kernel and the
    plain version, each on copies of the same values: the per-step kernel
    must agree bit for bit (0 ULP), the plain version within ADAMW_ULP, and
    the pad tail must stay zero. Returns the ULP and largest absolute
    differences."""
    from thunder_tpu_torch.testing import ulp_distance

    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + n)
    runs = list(zip(offs, offs[1:]))
    step_p = [p.clone() for p in ps]
    step_m = [m.view(-1)[a:b].view(p.shape).clone() for (a, b), p in zip(runs, ps)]
    step_v = [v.view(-1)[a:b].view(p.shape).clone() for (a, b), p in zip(runs, ps)]
    plain_p, plain_m, plain_v = [p.clone() for p in ps], m.clone(), v.clone()
    cudaex.fused_adamw_slab(ps, gs, m, v, bc, sizes=sizes, **hyper)
    cudaex.fused_adamw(step_p, gs, step_m, step_v, bc, **hyper)
    toptim_ops.fused_adamw_slab_plain(plain_p, gs, plain_m, plain_v, bc, sizes=sizes, **hyper)
    torch.cuda.synchronize()
    per_step_ulp, plain_ulp, err = 0, 0, 0.0
    for i, (a, b) in enumerate(runs):
        for got, per, plain in ((ps[i], step_p[i], plain_p[i]),
                                (m.view(-1)[a:b], step_m[i].view(-1), plain_m.view(-1)[a:b]),
                                (v.view(-1)[a:b], step_v[i].view(-1), plain_v.view(-1)[a:b])):
            got = got.reshape(-1)
            per_step_ulp = max(per_step_ulp, ulp_distance(got, per.reshape(-1)))
            plain_ulp = max(plain_ulp, ulp_distance(got, plain.reshape(-1)))
            err = max(err, float((got.float() - plain.reshape(-1).float()).abs().max()))
    tail = max(float(s.view(-1)[offs[-1]:].float().abs().max()) if s.numel() > offs[-1] else 0.0
               for s in (m, v))
    del step_p, step_m, step_v, plain_p, plain_m, plain_v
    require(per_step_ulp == 0, f"fused_adamw_slab: {per_step_ulp} ULP from the per-step kernel")
    require(plain_ulp <= ADAMW_ULP, f"fused_adamw_slab: {plain_ulp} ULP from its plain version")
    require(tail == 0.0, f"fused_adamw_slab: the pad tail holds {tail}")
    return {"per_step_ulp": per_step_ulp, "plain_ulp": plain_ulp, "max_abs_err": err}


def check_slab_kernel(torch, cudaex, toptim_ops, toptim, tllama):
    """The slab-persistent AdamW kernel at the bench bucket (llama2-7b-bench
    at BENCH_LAYERS layers: one bf16 bucket, bf16 m slab, f32 v slab) and on
    a bucket of odd sizes whose slab runs are misaligned (the kernel's
    scalar path), each held by :func:`hold_slab_kernel`; the bench bucket
    then timed beside its plain version and its bound. {name: [row]}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    step = 10
    bc = torch.tensor([1 - 0.9 ** step, 1 - 0.999 ** step], dtype=torch.float32, device=dev)
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)

    odd = [7, 13, 4099, 65537, 1 << 20]
    ops = [torch.randn(n, generator=gen, device=dev).to(torch.bfloat16) for n in odd]
    held = hold_slab_kernel(torch, cudaex, toptim_ops, ops, *slab_state(torch, gen, ops, odd),
                            odd, bc, hyper)
    log(f"  fused_adamw_slab, odd sizes {odd} (misaligned slab runs): " + json.dumps(held))
    del ops

    ps, gs, m, v, sizes = slab_bucket(torch, tllama, toptim, gen, "llama2-7b-bench",
                                      BENCH_LAYERS)
    n = sum(sizes)
    held = hold_slab_kernel(torch, cudaex, toptim_ops, ps, gs, m, v, sizes, bc, hyper)
    log(f"  fused_adamw_slab: {len(ps)} tensors, {n} parameters: " + json.dumps(held))
    gc.collect()
    torch.cuda.empty_cache()
    row = timed_row(torch, cudaex, "fused_adamw_slab", f"{n} bf16", held["max_abs_err"],
                    lambda: cudaex.fused_adamw_slab(ps, gs, m, v, bc, sizes=sizes, **hyper),
                    lambda: toptim_ops.fused_adamw_slab_plain(ps, gs, m, v, bc, sizes=sizes,
                                                              **hyper),
                    None, n * 18, 12.0 * n, F32_FLOPS, 10, 2)
    row["library_note"] = ("no PyTorch call updates moments held in persistent slabs; "
                           "torch._fused_adamw_ also refuses bf16 params with f32 moments")
    row.update(per_step_ulp=held["per_step_ulp"], plain_ulp=held["plain_ulp"])
    del ps, gs, m, v
    gc.collect()
    torch.cuda.empty_cache()
    return {"fused_adamw_slab": [row]}


def check_planned_kernels(torch, cudaex, tnn, tllama, Fm=F_DIM):
    """The MLP sub-block pair at a planned train path's shape (F = ``Fm``:
    llama3-8b-bench's 14336, llama2-7b-bench's 11008), each output and
    gradient held row by row, with two planted faults that must fail; each
    timed beside its plain version, its bound and the per-op chain it
    replaces (``rms_norm_residual`` + ``F.linear`` + plain SwiGLU, forward
    and its autograd backward). {name: [row]}."""
    from thunder_tpu_torch.testing import row_rel_err

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    N, Dm = TRAIN_BATCH * TRAIN_SEQ, D
    tag = f"{N}x{Dm}x{Fm} silu"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    g, r, x = rnd(N, Dm), rnd(N, Dm, scale=0.25), rnd(N, Dm, scale=0.25)
    wn = (1.0 + 0.1 * torch.randn(Dm, generator=gen, device=dev)).to(bf16)
    wg, wu, wd = rnd(Fm, Dm, scale=Dm ** -0.5), rnd(Fm, Dm, scale=Dm ** -0.5), \
        rnd(Dm, Fm, scale=Fm ** -0.5)
    w = (r, x, wn, wg, wu, wd)

    out, fwd_design = ran(cudaex, "mlp_subblock", lambda: cudaex.mlp_subblock(*w))
    require(fwd_design == "wgmma", f"mlp_subblock {tag}: bf16 launch took {fwd_design}")
    want = tnn.mlp_subblock_plain(*w)
    out_rel = row_rel_err(out, want)
    fwd_err = float((out.float() - want.float()).abs().max())
    require(out_rel <= SUBBLOCK_TOL,
            f"mlp_subblock {tag}: out err {out_rel} of its rows' largest values")
    wd_cut = wd.clone()
    wd_cut[:, -FAULT_FF_TILE:] = 0
    cut_rel = row_rel_err(cudaex.mlp_subblock(r, x, wn, wg, wu, wd_cut), want)
    require(cut_rel > SUBBLOCK_TOL, f"the row check passes a dropped ff tile ({cut_rel})")
    del out, want, wd_cut

    got, bwd_design = ran(cudaex, "mlp_subblock_bwd", lambda: cudaex.mlp_subblock_bwd(g, *w))
    require(bwd_design == "wgmma", f"mlp_subblock_bwd {tag}: bf16 launch took {bwd_design}")
    want = tnn.mlp_subblock_bwd_plain(g, *w)
    names = ("dh", "dw_norm", "dw_gate", "dw_up", "dw_down")
    rels = {n: row_rel_err(a, b) for n, a, b in zip(names, got, want)}
    bwd_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    require(max(rels.values()) <= SUBBLOCK_TOL,
            f"mlp_subblock_bwd {tag}: errors {rels} of their rows' largest values")
    bad = got[2].clone()
    bad[-64:] = 0
    zero_rel = row_rel_err(bad, want[2])
    require(zero_rel > SUBBLOCK_TOL, f"the row check passes zeroed dw_gate rows ({zero_rel})")
    log(f"  mlp sub-block {tag} (design {fwd_design} / {bwd_design}): out {out_rel:.3e}, "
        + ", ".join(f"{n} {v:.3e}" for n, v in rels.items())
        + f" of their rows' largest values; planted faults: last {FAULT_FF_TILE} ff columns "
        f"dropped from out {cut_rel:.3e}, last 64 dw_gate rows zeroed {zero_rel:.3e}")
    del got, want, bad
    gc.collect()
    torch.cuda.empty_cache()

    # the per-op chain: the same function at the per-op rung, on cuBLAS products
    layer = {"w_gate": wg, "w_up": wu, "w_down": wd}

    def chain_fwd():
        with torch.no_grad():
            h, n = tnn.rms_norm_residual(r, x, wn, EPS)
            return h + tllama._mlp_train(n, layer)

    leaves = [t.detach().requires_grad_(True) for t in w]
    h, n = tnn.rms_norm_residual(*leaves[:3], EPS)
    chain_out = h + tllama._mlp_train(n, dict(zip(("w_gate", "w_up", "w_down"), leaves[3:])))

    def chain_bwd():
        return torch.autograd.grad(chain_out, leaves, g, retain_graph=True)

    act_bytes, w_bytes = N * Dm * 2, Fm * Dm * 2
    nd_f = float(N) * Dm * Fm
    fwd = timed_row(torch, cudaex, "mlp_subblock", tag, fwd_err,
                    lambda: cudaex.mlp_subblock(*w), lambda: tnn.mlp_subblock_plain(*w), None,
                    3 * act_bytes + 3 * w_bytes + Dm * 2, 6.0 * nd_f, BF16_FLOPS, 5, 2)
    fwd["design"], fwd["per_op_chain_ms"] = fwd_design, time_ms(torch, chain_fwd, 5)
    bwd = timed_row(torch, cudaex, "mlp_subblock_bwd", tag, bwd_err,
                    lambda: cudaex.mlp_subblock_bwd(g, *w),
                    lambda: tnn.mlp_subblock_bwd_plain(g, *w), None,
                    4 * act_bytes + 6 * w_bytes + 2 * Dm * 2, 16.0 * nd_f, BF16_FLOPS, 3, 1)
    bwd["design"], bwd["per_op_chain_ms"] = bwd_design, time_ms(torch, chain_bwd, 3)
    log(f"    per-op chain: forward {fwd['per_op_chain_ms']:.3f} ms, backward "
        f"{bwd['per_op_chain_ms']:.3f} ms")
    del chain_out, leaves, h, n
    gc.collect()
    torch.cuda.empty_cache()
    return {"mlp_subblock": [fwd], "mlp_subblock_bwd": [bwd]}


# ---------------------------------------------------------------------------
# phase 3, the serving planned rung: the whole decode layer, its attention
# half, and the MLP sub-block at serving shapes
# ---------------------------------------------------------------------------

def decode_inputs(torch, tnn, dev, dims, seed=4):
    """One planned decode step's layer operands at ``dims`` = (S, D, H, KV,
    hd, ps, F) in bf16, over pools that hold every request's pages (LENGTHS,
    pages drawn at random). Slot REPLAY is a replay row: its write goes to
    the scratch position 0, and its pool row at len - 1 is a random row, not
    its fresh row. h is drawn at scale 0.25 so the attention and MLP terms,
    not the residual, set a row's largest value. The longest request's last
    page holds keys aligned with its query heads (scores about 4 above the
    rest, as recent tokens often are), so that page carries a visible share
    of the attention. Returns (args, mlp)."""
    S, Dm, H, KVh, hd, ps, Fm = dims
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    npg = 2048 // ps
    P = S * npg + 1
    perm = torch.randperm(P - 1, generator=gen, device=dev).add_(1).to(torch.int32)
    bt = torch.zeros(S, npg, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(LENGTHS):
        k = -(-n // ps)
        bt[b, :k] = perm[used:used + k]
        used += k
    ln = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    last = ln.long() - 1
    wp = bt.long().gather(1, (last // ps)[:, None])[:, 0] * ps + last % ps
    wp[REPLAY] = 0
    ang = torch.rand(S, 1, 1, hd // 2, generator=gen, device=dev) * 6.3
    h = rnd(S, 1, Dm, scale=0.25)
    wn = (1 + 0.1 * torch.randn(Dm, generator=gen, device=dev)).to(bf16)
    wq, wk, wv = (rnd(n * hd, Dm, scale=Dm ** -0.5) for n in (H, KVh, KVh))
    wo = rnd(Dm, H * hd, scale=(H * hd) ** -0.5)
    cos, sin = torch.cos(ang).to(bf16), torch.sin(ang).to(bf16)
    kp, vp = rnd(KVh, P, ps, hd), rnd(KVh, P, ps, hd)
    q, _, _ = tnn.decode_qkv_plain(h, wn, wq, wk, wv, cos, sin, EPS)
    b, G = len(LENGTHS) - 1, H // KVh
    for kvh in range(KVh):
        qm = q[b, kvh * G:(kvh + 1) * G].float().mean(0)
        key = qm * (4.0 * math.sqrt(hd) / float(qm.norm()) ** 2)
        pos = torch.arange(LENGTHS[b] - ps, LENGTHS[b], device=dev)
        kp[kvh, bt[b, pos // ps].long(), pos % ps] = key.to(bf16)
    args = (h, wn, wq, wk, wv, wo, cos, sin, kp, vp, bt, ln, wp)
    mlp = ((1 + 0.1 * torch.randn(Dm, generator=gen, device=dev)).to(bf16),
           rnd(Fm, Dm, scale=Dm ** -0.5), rnd(Fm, Dm, scale=Dm ** -0.5),
           rnd(Dm, Fm, scale=Fm ** -0.5))
    return args, mlp


def decode_faults(torch, tnn, args, mlp):
    """The plain versions with a fault planted, each as (name, applies to
    the layer only, plain (out, k_rows, v_rows)): the longest request's last
    page left out (its length cut back to a page boundary); the last 128
    rows of w_gate zeroed; the replay row's attention reading its pool row at
    len - 1 and not its fresh row."""
    import torch.nn.functional as F

    h, wn, wq, wk, wv, wo, cos, sin, kp, vp, bt, ln, wp = args
    ps = kp.shape[2]
    cut = ln.clone()
    cut[-1] = (int(cut[-1]) - 1) // ps * ps
    wg_cut = mlp[1].clone()
    wg_cut[-FAULT_FF_TILE:] = 0

    def stale_replay(layer):
        q, k, v = tnn.decode_qkv_plain(h, wn, wq, wk, wv, cos, sin, EPS)
        k_rows, v_rows = k.transpose(0, 1).contiguous(), v.transpose(0, 1).contiguous()
        pos = int(ln[REPLAY]) - 1
        page = int(bt[REPLAY, pos // ps])
        k_att, v_att = k_rows.clone(), v_rows.clone()
        k_att[:, REPLAY], v_att[:, REPLAY] = kp[:, page, pos % ps], vp[:, page, pos % ps]
        attn = tnn.decode_attention_plain(q, k_att, v_att, kp, vp, bt, ln)
        proj = F.linear(attn.float(), wo.float())
        S, Dm = h.shape[0], h.shape[-1]
        out = (proj.to(h.dtype) if not layer else
               tnn.decode_mlp_plain(h.reshape(S, Dm).float() + proj, h.dtype, *mlp, "silu", EPS))
        return out.reshape(h.shape), k_rows, v_rows

    return (
        ("last page left out", False,
         lambda layer: (tnn.decode_layer_plain(*args[:11], cut, wp, *mlp) if layer
                        else tnn.attn_subblock_plain(*args[:11], cut, wp))),
        (f"last {FAULT_FF_TILE} w_gate rows zeroed", True,
         lambda layer: tnn.decode_layer_plain(*args, mlp[0], wg_cut, *mlp[2:])),
        ("replay row read from the pool", False, stale_replay),
    )


def hold_decode_kernels(torch, tnn, layer_fn, sub_fn, args, mlp):
    """``layer_fn`` and ``sub_fn`` (the kernels, or any stand-ins of their
    signature) against the plain versions, row by row: out and the fresh
    k/v rows; then each planted fault must fail the same check. Returns
    {name: {"err": row_rel_err, "max_abs_err": ..., "faults": {...}}}."""
    from thunder_tpu_torch.testing import row_rel_err

    found = {}
    for name, layer in (("decode_layer", True), ("attn_subblock", False)):
        got = layer_fn(*args, *mlp) if layer else sub_fn(*args)
        want = (tnn.decode_layer_plain(*args, *mlp) if layer else tnn.attn_subblock_plain(*args))
        errs = {part: row_rel_err(a, b) for part, a, b in zip(("out", "k_rows", "v_rows"), got,
                                                              want)}
        require(max(errs.values()) <= DECODE_TOL,
                f"{name}: errors {errs} of their rows' largest values")
        faults = {}
        for fault, layer_only, plain in decode_faults(torch, tnn, args, mlp):
            if layer_only and not layer:
                continue
            err = row_rel_err(got[0], plain(layer)[0])
            require(err > DECODE_TOL, f"{name}: the row check passes a planted fault ({fault}: "
                                      f"{err})")
            faults[fault] = err
        found[name] = {"errs": errs, "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                                        for a, b in zip(got, want)),
                       "faults": faults}
        del got, want
    return found


def check_serving_planned_kernels(torch, cudaex, tnn, tllama):
    """The serving planned rung's kernels at the serving shapes: the decode
    layer and its attention half held row by row with planted faults, then
    each timed beside its plain version, its bound and the per-op chain it
    replaces; the MLP sub-block at the prefill chunk and at 8 rows, row by
    row, timed beside its plain version and the per-op chain. {name: [rows]},
    ``mlp_subblock`` at the prefill chunk first."""
    import torch.nn.functional as F

    from thunder_tpu_torch.testing import row_rel_err

    dev = torch.device("cuda")
    cfg = tllama.CONFIGS["llama3-8b"]
    dims = (S_DECODE, D, KV * G, KV, HD, PS, F_DIM)
    args, mlp = decode_inputs(torch, tnn, dev, dims)
    designs = {}
    for name, fn in (("decode_layer", lambda: cudaex.decode_layer(*args, *mlp)),
                     ("attn_subblock", lambda: cudaex.attn_subblock(*args))):
        _, designs[name] = ran(cudaex, name, fn)
        require(designs[name] == "stream", f"{name}: a bf16 launch at 8 slots took "
                                           f"{designs[name]}")
    found = hold_decode_kernels(torch, tnn, cudaex.decode_layer, cudaex.attn_subblock, args, mlp)
    for name, f in found.items():
        log(f"  {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in f["errs"].items())
            + " of their rows' largest values; planted faults "
            + ", ".join(f"{k} {v:.3e}" for k, v in f["faults"].items()))

    h, wn, wq, wk, wv, wo, cos, sin, kp, vp, bt, ln, wp = args
    layer = {"attn_norm": wn, "wq": wq, "wk": wk, "wv": wv, "wo": wo, "mlp_norm": mlp[0],
             "w_gate": mlp[1], "w_up": mlp[2], "w_down": mlp[3]}
    S, H = S_DECODE, KV * G
    prev = torch.zeros_like(h)

    def attn_chain():   # the per-op rung's attention half of one layer
        x = tnn.rms_norm(h, wn, EPS)
        q, k, v = tllama._project_qkv(x, layer, cfg, cos, sin)
        tnn.decode_row_write(kp, k, wp)
        tnn.decode_row_write(vp, v, wp)
        attn = tnn.paged_decode_attention(q.contiguous(), kp, vp, bt, ln)
        return F.linear(attn.transpose(1, 2).reshape(S, 1, H * HD), wo)

    def layer_chain():  # one layer of the per-op rung's decode step
        hh, x = tnn.rms_norm_residual(prev, h, wn, EPS)
        q, k, v = tllama._project_qkv(x, layer, cfg, cos, sin)
        tnn.decode_row_write(kp, k, wp)
        tnn.decode_row_write(vp, v, wp)
        attn = tnn.paged_decode_attention(q.contiguous(), kp, vp, bt, ln)
        hh, x = tnn.rms_norm_residual(hh, F.linear(attn.transpose(1, 2).reshape(S, 1, H * HD), wo),
                                      mlp[0], EPS)
        return tnn.rms_norm_residual(hh, tllama._mlp(x, layer), wn, EPS)

    ctx = sum(LENGTHS)
    kv_bytes = ctx * KV * HD * 2 * 2 + sum(-(-n // PS) for n in LENGTHS) * 4 + 2 * S * 4
    attn_w = (2 * H * HD * D + 2 * KV * HD * D) * 2
    mlp_w = 3 * F_DIM * D * 2
    act_bytes = 2 * S * D * 2 + 2 * KV * S * HD * 2 + S * HD * 2 * 2 + D * 2
    attn_ops = 2.0 * S * attn_w / 2 + 4.0 * ctx * H * HD
    rows = {}
    for name, fn, plain, chain, w_bytes, ops in (
            ("attn_subblock", lambda: cudaex.attn_subblock(*args),
             lambda: tnn.attn_subblock_plain(*args), attn_chain, attn_w, attn_ops),
            ("decode_layer", lambda: cudaex.decode_layer(*args, *mlp),
             lambda: tnn.decode_layer_plain(*args, *mlp), layer_chain, attn_w + mlp_w + D * 2,
             attn_ops + 2.0 * S * mlp_w / 2)):
        row = timed_row(torch, cudaex, name, f"S{S}:1..2048", found[name]["max_abs_err"], fn,
                        plain, None, w_bytes + kv_bytes + act_bytes, ops, BF16_FLOPS, 20, 3)
        row["row_rel_err"] = found[name]["errs"]
        row["planted_faults"] = found[name]["faults"]
        row["design"] = designs[name]
        row["per_op_chain_ms"] = time_ms(torch, chain, 20)
        log(f"    design {designs[name]}; per-op chain {row['per_op_chain_ms']:.4f} ms")
        rows[name] = [row]
    del args, mlp, layer, kp, vp
    gc.collect()
    torch.cuda.empty_cache()

    # the MLP sub-block at the planned prefill chunk (512 rows) and at 8 rows
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    wn = (1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
    wg, wu, wd = rnd(F_DIM, D, scale=D ** -0.5), rnd(F_DIM, D, scale=D ** -0.5), \
        rnd(D, F_DIM, scale=F_DIM ** -0.5)
    layer = {"w_gate": wg, "w_up": wu, "w_down": wd}
    for n in (M_PREFILL, S_DECODE):
        r, x = rnd(1, n, D, scale=0.25), rnd(1, n, D, scale=0.25)
        w = (r, x, wn, wg, wu, wd)
        got, design = ran(cudaex, "mlp_subblock", lambda: cudaex.mlp_subblock(*w))
        require(design == "wgmma", f"mlp_subblock {n} rows: bf16 launch took {design}")
        want = tnn.mlp_subblock_plain(*w)
        err = row_rel_err(got, want)
        require(err <= SUBBLOCK_TOL, f"mlp_subblock {n} rows: out err {err} of its rows' largest "
                                     f"values")

        def chain():    # the per-op rung: residual add + mlp_norm, linear_act, up, down, add
            hh, xx = tnn.rms_norm_residual(r, x, wn, EPS)
            return hh + tllama._mlp(xx, layer)

        row = timed_row(torch, cudaex, "mlp_subblock", f"{n}x{D}x{F_DIM} silu",
                        float((got.float() - want.float()).abs().max()),
                        lambda: cudaex.mlp_subblock(*w), lambda: tnn.mlp_subblock_plain(*w), None,
                        3 * n * D * 2 + 3 * F_DIM * D * 2 + D * 2, 6.0 * n * D * F_DIM,
                        BF16_FLOPS, 20, 3)
        row["row_rel_err"], row["design"] = err, design
        row["per_op_chain_ms"] = time_ms(torch, chain, 20)
        log(f"    design {design}; row check {err:.3e}; per-op chain "
            f"{row['per_op_chain_ms']:.4f} ms")
        rows.setdefault("mlp_subblock", []).append(row)
        del got, want
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: tiny-gqa float32 on the card vs the CPU
# ---------------------------------------------------------------------------

def counting(eng, cudaex, attr: str, counts: list) -> None:
    """Wrap ``eng.runner.<attr>`` so each call appends the kernel launches it
    made to ``counts``."""
    fn = getattr(eng.runner, attr)

    def counted(*args, **kwargs):
        before = cudaex.launch_counts()
        out = fn(*args, **kwargs)
        after = cudaex.launch_counts()
        counts.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        return out

    setattr(eng.runner, attr, counted)


def card_vs_cpu(np, torch, tllama, ServingEngine, cudaex=None, block_fusion: bool = False):
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (1, 7, 16, 33, 24)]
    kw = dict(max_slots=3, page_size=8, num_pages=9, max_context=64, prefill_chunk=16,
              block_fusion=block_fusion)
    outs, steps = {}, []
    for device in ("cuda", "cpu"):
        eng = ServingEngine(params, cfg, device=device, **kw)
        if device == "cuda" and cudaex is not None:
            counting(eng, cudaex, "decode", steps)
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.drain()
        eng.assert_quiescent()
        outs[device] = ([r.output().tolist() for r in reqs],
                        sum(r.preemptions for r in reqs))
    if outs["cuda"][0] != outs["cpu"][0]:
        raise AssertionError(f"card tokens {outs['cuda'][0]} != CPU tokens {outs['cpu'][0]}")
    if outs["cuda"][1] == 0:
        raise AssertionError("the small pool did not preempt: the phase lost its case")
    out = {"requests": len(prompts), "tokens": outs["cuda"][0], "preemptions": outs["cuda"][1]}
    if block_fusion:
        expect = {"decode_layer": cfg.n_layers, "rms_norm": 1}
        bad = [c for c in steps if c != expect]
        if bad or not steps:
            raise AssertionError(f"planned decode steps launched {bad[:3]}, expected {expect}")
        out["launches_per_decode_step"] = expect
    return out


def subblock_step(np, torch, tllama, tnn, cudaex):
    """One float32 tiny-gqa decode step at the sub-block rung (the
    reference's ``nn.decode_layer`` decomposition: ``attn_subblock``, then
    ``mlp_subblock``, per layer) on the card, against the same composition
    on the CPU and against the CPU's ``decode_layer_plain``: logits and
    pools (but the scratch page) within SUBBLOCK_STEP_TOL. Ragged lengths, a
    page-boundary crossing, a replay slot and an idle slot."""
    from thunder_tpu_torch.optim import tree_map
    from thunder_tpu_torch.serving import PageGeometry
    from thunder_tpu_torch.serving.runner import PagedLlamaRunner

    cfg = tllama.CONFIGS["tiny-gqa"]
    L, S, npg, ps, P = cfg.n_layers, 4, 3, 8, 13
    params = tllama.init_params(cfg, seed=1, device="cpu")
    rng = np.random.RandomState(2)
    pools = [{k: torch.from_numpy((rng.rand(cfg.kv_heads, P, ps, cfg.head_dim) - 0.5)
                                  .astype(np.float32)) for k in ("k", "v")} for _ in range(L)]
    t = torch.from_numpy
    inputs = (t(rng.randint(1, cfg.vocab_size, size=(S, 1))),
              t(np.asarray([[1, 2, 0], [3, 0, 0], [4, 5, 6], [0, 0, 0]], np.int32)),
              t(np.asarray([9, 6, 20, 1], np.int32)), t(np.asarray([16, 29, 0, 0])))
    sampling = (torch.zeros(S), torch.zeros(S, dtype=torch.int64), torch.ones(S),
                torch.zeros(S, 2, dtype=torch.int64))
    geom = PageGeometry(n_layers=L, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, page_size=ps,
                        num_pages=P, pages_per_request=npg)

    def step(device, layer_fn):
        run = PagedLlamaRunner(cfg, geom, block_fusion=True)
        run.decode_layer = layer_fn
        ps_ = tree_map(lambda x: x.to(device), params)
        pl_ = [{k: v.clone().to(device) for k, v in kv.items()} for kv in pools]
        _, logits = run.decode(ps_, *(x.to(device) for x in inputs), pl_,
                               *(x.to(device) for x in sampling))
        return logits.cpu(), [{k: v.cpu() for k, v in kv.items()} for kv in pl_]

    cudaex.reset_launch_counts()
    card = step("cuda", tnn.decode_layer_subblocks)
    counts = {k: v for k, v in cudaex.launch_counts().items() if v}
    expect = {"attn_subblock": L, "mlp_subblock": L, "rms_norm": 1}
    require(counts == expect, f"sub-block decode step launched {counts}, expected {expect}")
    errs = {}
    for name, ref in (("cpu subblocks", step("cpu", tnn.decode_layer_subblocks)),
                      ("cpu decode_layer_plain", step("cpu", tnn.decode_layer))):
        # the pools on every page but the scratch page 0, where the replay and
        # idle slots' duplicate writes land in either order on the card
        err = max([float((card[0] - ref[0]).abs().max())] +
                  [float((a[k][:, 1:] - b[k][:, 1:]).abs().max())
                   for a, b in zip(card[1], ref[1]) for k in ("k", "v")])
        require(err <= SUBBLOCK_STEP_TOL, f"sub-block step on the card vs {name}: {err}")
        errs[name] = err
    return {"layers": L, "max_abs_err": errs, "launches": counts}


# ---------------------------------------------------------------------------
# phase 5: llama3-8b at full width and depth
# ---------------------------------------------------------------------------

def full_width(np, torch, tllama, ServingEngine, SamplingParams, cudaex, params,
               block_fusion: bool = False):
    cfg = tllama.CONFIGS["llama3-8b"]
    eng = ServingEngine(params, cfg, max_slots=8, page_size=16, max_context=2048,
                        block_fusion=block_fusion)
    L = cfg.n_layers

    # warm-up request (cuBLAS handles, allocator), not part of the measured run
    eng.submit(np.arange(1, 40, dtype=np.int32), 2)
    eng.drain()
    eng.completed.clear()

    step_counts, step_designs, step_ms, step_rows, chunk_counts = [], [], [], [], []
    decode = eng.runner.decode

    def counted_decode(*args, **kwargs):
        before, designs = cudaex.launch_counts(), cudaex.design_counts()
        t = time.perf_counter()
        out = decode(*args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        after = cudaex.launch_counts()
        step_counts.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        step_designs.append(design_delta(designs, cudaex.design_counts()))
        step_rows.append(sum(r is not None and r.state == "decode" for r in eng.slots))
        return out

    eng.runner.decode = counted_decode
    if block_fusion:
        counting(eng, cudaex, "prefill", chunk_counts)
    rng = np.random.RandomState(1)
    lengths = [17, 64, 150, 301, 480, 640, 800, 1000]
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=1234)
    torch.cuda.reset_peak_memory_stats()

    cudaex.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(rng.randint(0, cfg.vocab_size, size=n).astype(np.int32), 32,
                       sampling=sampled if i in (2, 5) else None)
            for i, n in enumerate(lengths)]
    eng.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = cudaex.launch_counts()

    for r in reqs:
        out = r.output()
        if not r.done or len(out) != 32:
            raise AssertionError(f"request {r.request_id} state {r.state}, {len(out)} tokens")
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.request_id} produced out-of-vocab tokens")
    eng.assert_quiescent()
    expect = ({"decode_layer": L, "rms_norm": 1} if block_fusion else
              {"paged_decode_attention": L, "linear_act": L, "rms_norm_residual": 2 * L,
               "rms_norm": 1})
    # rms_norm(norm_f) and the per-op rung's rms_norm_residual on bf16 rows
    # of 4096 read each row once (vector); every bf16 launch of the decode
    # kernels takes its Hopper design
    expect_designs = {"rms_norm": {"vector": 1}}
    if block_fusion:
        expect_designs["decode_layer"] = {"stream": L}
    else:
        expect_designs["linear_act"] = {"stream": L}
        expect_designs["paged_decode_attention"] = {"split": L}
        expect_designs["rms_norm_residual"] = {"vector": 2 * L}
    for i, (c, d) in enumerate(zip(step_counts, step_designs)):
        if c != expect or d != expect_designs:
            raise AssertionError(f"decode step {i} launched {c} by design {d}, expected "
                                 f"{expect} by design {expect_designs}")
    if any(counts[k] == 0 for k in expect):
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    decode_tokens = sum(step_rows)
    out = {
        "model": cfg.name, "layers": L, "dtype": "bfloat16", "max_slots": 8,
        "page_size": 16, "max_context": 2048, "block_fusion": block_fusion, "kv_pool_gb": sum(
            t.numel() * t.element_size() for kv in eng.cache.pools for t in kv.values()) / 1e9,
        "prompt_lengths": lengths, "new_tokens": 32, "sampled_requests": 2,
        "wall_s": wall_s,
        "decode_steps": len(step_counts), "decode_tokens": decode_tokens,
        "decode_tok_per_s": decode_tokens / (sum(step_ms) / 1e3),
        "decode_step_ms_mean": sum(step_ms) / len(step_ms),
        "ttft_ms_mean": 1e3 * sum(r.ttft_s for r in reqs) / len(reqs),
        "prefill_chunks": sum(r.prefill_chunks for r in reqs),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_decode_step": expect, "launches": counts,
        "designs_per_decode_step": expect_designs, "designs": cudaex.design_counts(),
    }
    if block_fusion:
        chunk = {"rms_norm": L, "mlp_subblock": L - 1}
        bad = [c for c in chunk_counts if c != chunk]
        if bad or not chunk_counts:
            raise AssertionError(f"prefill chunks launched {bad[:3]}, expected {chunk}")
        out["launches_per_prefill_chunk"] = chunk
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: the train step, tiny-gqa float32 on the card vs the CPU
# ---------------------------------------------------------------------------

def train_launches(L: int, block_fusion: bool) -> dict:
    """Kernel launches of one train step at L layers, by rung."""
    if block_fusion:
        return {"sdpa_fwd": L, "sdpa_bwd": L, "ce_fwd": 1, "fused_adamw": 1, "rms_norm": L + 1,
                "mlp_subblock": L, "mlp_subblock_bwd": L}
    return {"sdpa_fwd": L, "sdpa_bwd": L, "ce_fwd": 1, "fused_adamw": 1, "rms_norm": 1,
            "rms_norm_residual": 2 * L}


def train_card_vs_cpu(np, torch, tllama, pretrain, block_fusion: bool = False):
    from thunder_tpu_torch.optim import tree_leaves, tree_map

    cfg = tllama.CONFIGS["tiny-gqa"]
    cpu = tllama.init_params(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    kw = dict(batch=2, seq=64, steps=3, lr=TRAIN_LR, seed=0, block_fusion=block_fusion)
    a = pretrain.run("tiny-gqa", device="cuda", params=card, **kw)
    b = pretrain.run("tiny-gqa", device="cpu", params=cpu, **kw)
    if not np.allclose(a["losses"], b["losses"], rtol=TRAIN_LOSS_RTOL, atol=0):
        raise AssertionError(f"card losses {a['losses']} != CPU losses {b['losses']}")
    perr = max(float((x.detach().cpu() - y.detach()).abs().max())
               for x, y in zip(tree_leaves(card), tree_leaves(cpu)))
    if perr > TRAIN_PARAM_ATOL:
        raise AssertionError(f"card and CPU parameters differ by {perr} after 3 steps")
    L = cfg.n_layers
    expect = train_launches(L, block_fusion)
    for i, st in enumerate(a["per_step"]):
        if st["launches"] != expect:
            raise AssertionError(f"tiny-gqa train step {i} launched {st['launches']}")
    return {"layers": L, "losses_card": a["losses"], "losses_cpu": b["losses"],
            "max_param_diff": perr, "launches_per_step": expect}


# ---------------------------------------------------------------------------
# phase 7: the train step at full width, depth cut to 4 layers
# ---------------------------------------------------------------------------

def train_full_width(torch, cudaex, pretrain, block_fusion: bool = False):
    cudaex.reset_launch_counts()
    out = pretrain.run("llama3-8b-bench", layers=TRAIN_LAYERS, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=1e-4, seed=0, device="cuda",
                       block_fusion=block_fusion)
    counts = cudaex.launch_counts()
    expect = train_launches(TRAIN_LAYERS, block_fusion)
    for i, st in enumerate(out["per_step"]):
        if st["launches"] != expect:
            raise AssertionError(f"train step {i} launched {st['launches']}, expected {expect}")
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    if any(counts[k] == 0 for k in expect):
        raise AssertionError(f"a kernel of the train path never launched: {counts}")
    designs = cudaex.design_counts()
    require_attention_wgmma("the train path", designs, counts)
    require_residual_vector("the train path", designs, counts)
    out["launches"] = counts
    out["launches_per_step"] = expect
    out["designs"] = designs
    return out


# ---------------------------------------------------------------------------
# phases 12 and 13: the headline train bench (benchmarks/bench.py)
# ---------------------------------------------------------------------------

def bench_launches(L: int, remat: bool, block_fusion: bool) -> dict:
    """Kernel launches of one bench step (fused loss, slab state) at L
    layers: the reference's claims (tests/test_torch_port_bench.py)."""
    if remat:   # forward: 2 rms_norm + sdpa_fwd per layer; recompute: rms_norm,
        #         sdpa_fwd, rms_norm_residual per layer; rms_norm(norm_f)
        return {"rms_norm": 3 * L + 1, "rms_norm_residual": L, "sdpa_fwd": 2 * L,
                "sdpa_bwd": L, "fused_adamw_slab": 1}
    if block_fusion:
        return {"rms_norm": L + 1, "mlp_subblock": L, "mlp_subblock_bwd": L, "sdpa_fwd": L,
                "sdpa_bwd": L, "fused_adamw_slab": 1}
    return {"rms_norm": 1, "rms_norm_residual": 2 * L, "sdpa_fwd": L, "sdpa_bwd": L,
            "fused_adamw_slab": 1}


def bench_card_vs_cpu(np, torch, tllama, bench):
    """Three float32 tiny-gqa steps of the bench's step (4 layers, B=2,
    T=64, fused loss, remat, slab state with bf16 m) on the card and on the
    CPU from the same weights: losses and parameters to phase 6's
    tolerances, the slabs to the training test's (the bf16 m slab within two
    bf16 rounding steps besides), every step's launches the reference's
    claims."""
    from thunder_tpu_torch.optim import tree_leaves, tree_map
    from thunder_tpu_torch.testing import ulp_distance

    cfg = tllama.CONFIGS["tiny-gqa"]
    cpu = tllama.init_params(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    kw = dict(layers=cfg.n_layers, batch=2, seq=64, steps=3, remat=True, slab_state=True)
    opt = bench.make_opt("bf16", slab_state=True)
    st_card, st_cpu = opt.init(card), opt.init(cpu)
    a = bench.run("tiny-gqa", device="cuda", params=card, state=st_card, **kw)
    b = bench.run("tiny-gqa", device="cpu", params=cpu, state=st_cpu, **kw)
    require(bool(np.allclose(a["losses"], b["losses"], rtol=TRAIN_LOSS_RTOL, atol=0)),
            f"bench card losses {a['losses']} != CPU losses {b['losses']}")
    perr = max(float((x.detach().cpu() - y.detach()).abs().max())
               for x, y in zip(tree_leaves(card), tree_leaves(cpu)))
    require(perr <= 0.2 * bench.LR, f"bench card and CPU parameters differ by {perr}")
    slab_err = {}
    for which, rtol, atol in (("m", SLAB_M_RTOL, SLAB_M_ATOL), ("v", 0.0, SLAB_V_ATOL)):
        for key, got in st_card[which].items():
            got, want = got.cpu().float(), st_cpu[which][key].float()
            diff = (got - want).abs()
            slab_err[f"{which}:{key}"] = float(diff.max())
            slab_err[f"{which}:{key} ulp"] = ulp_distance(st_card[which][key].cpu(),
                                                          st_cpu[which][key])
            require(bool((diff <= rtol * torch.maximum(got.abs(), want.abs()) + atol).all()),
                    f"bench {which} slab {key}: card and CPU differ by {float(diff.max())}")
    require(float(st_card["step"]) == float(st_cpu["step"]) == 4.0, "bench step counts differ")
    expect = bench_launches(cfg.n_layers, remat=True, block_fusion=False)
    for i, st in enumerate(a["per_step"]):
        require(st["launches"] == expect,
                f"tiny-gqa bench step {i} launched {st['launches']}, expected {expect}")
    return {"layers": cfg.n_layers, "losses_card": a["losses"], "losses_cpu": b["losses"],
            "max_param_diff": perr, "max_slab_diff": slab_err, "launches_per_step": expect,
            "logits_route": a["logits_route"]}


def bench_full_width(torch, cudaex, bench, remat: bool, block_fusion: bool):
    """llama2-7b-bench at BENCH_LAYERS layers, B=8, T=2048 through the
    bench entry point with slab state: a warm-up step and BENCH_STEPS timed
    steps, every one launching the reference's claims, every sdpa_fwd on
    the wgmma design, the losses finite and falling."""
    cudaex.reset_launch_counts()
    out = bench.run("llama2-7b-bench", layers=BENCH_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    steps=BENCH_STEPS, slab_state=True, remat=remat, block_fusion=block_fusion,
                    device="cuda")
    counts = cudaex.launch_counts()
    expect = bench_launches(BENCH_LAYERS, remat, block_fusion)
    for i, st in enumerate(out["per_step"]):
        require(st["launches"] == expect, f"bench step {i} launched {st['launches']}, expected "
                                          f"{expect}")
    losses = out["losses"]
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"bench losses not finite and falling: {losses}")
    require(all(counts[k] for k in expect), f"a kernel of the bench path never launched: {counts}")
    designs = cudaex.design_counts()
    require_attention_wgmma("the bench path", designs, counts)
    require_residual_vector("the bench path", designs, counts)
    out.update(launches=counts, launches_per_step=expect, designs=designs)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def log_train(what: str, t: dict) -> None:
    log(f"{what}: step {t['step_ms']:.1f} ms, {t['tokens_per_s']:.0f} tokens/s, "
        f"{100 * t['share_of_989_tflops']:.1f}% of 989 TFLOP/s, peak "
        f"{t['peak_memory_gb']:.2f} GB, AdamW {t['optimizer_ms']:.3f} ms, losses "
        f"{[round(x, 4) for x in t['losses']]}, launches per step "
        f"{json.dumps(t['launches_per_step'])}, launches by design over the run "
        f"{json.dumps(t['designs'])} ({t['card']})")


# ---------------------------------------------------------------------------
# phase 14: train from a token file, checkpoint and resume
# ---------------------------------------------------------------------------

def train_resume(np, torch, cudaex, pretrain, tllama) -> dict:
    """llama3-8b-bench at RESUME_LAYERS layers through ``pretrain.run`` from
    a token file the phase writes: (a) 4 steps straight through; (b) 2
    steps, an asynchronous checkpoint of the parameters and AdamW state, a
    drop of every tensor, a load, and 2 more steps from ``start_step=2``.
    (b)'s losses, parameters and moments must equal (a)'s bit for bit; the
    stream must take its native path and every step launch the per-op
    rung's kernels, rms_norm_residual on its vector design. Then
    ``clip_grad_norm`` on one step's full-width grads."""
    import os
    import shutil
    import tempfile

    from thunder_tpu_torch import checkpoint, data
    from thunder_tpu_torch.optim import AdamW, clip_grad_norm, tree_leaves

    cfg = tllama.CONFIGS["llama3-8b-bench"]
    dev = torch.device("cuda")
    out = {"model": cfg.name, "layers": RESUME_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "tokens_in_file": RESUME_TOKENS}
    # the temporary directory or the checkout's build directory, whichever
    # disk has more room for the ~7 GB checkpoint
    roots = [tempfile.gettempdir(), str(data.BUILD_DIR)]
    os.makedirs(roots[1], exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_",
                           dir=max(roots, key=lambda d: shutil.disk_usage(d).free))
    try:
        n_params = tllama.num_params(cfg, RESUME_LAYERS)
        state_bytes = n_params * (2 + 4 + 4)   # bf16 params, f32 m and v
        free = shutil.disk_usage(tmp).free
        out.update(params=n_params, disk_free_gb=free / 1e9, tmpdir=tmp)
        require(free > 1.5 * state_bytes, f"phase 14 needs {1.5 * state_bytes / 1e9:.1f} GB "
                                          f"free under {tmp}, has {free / 1e9:.1f} GB")
        tokens = os.path.join(tmp, "tokens.bin")
        data.write_token_file(tokens, np.random.RandomState(RESUME_DATA_SEED).randint(
            0, cfg.vocab_size, RESUME_TOKENS).astype(np.uint16))
        kw = dict(layers=RESUME_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=1e-4, seed=0,
                  device="cuda", data=tokens, data_seed=RESUME_DATA_SEED, audit=True)

        def fresh():
            params = tllama.init_params(cfg, seed=0, device=dev, n_layers=RESUME_LAYERS)
            opt = AdamW(lr=1e-4)
            return params, opt, opt.init(params)

        def checked(run, what):
            require(run["stream_path"] == "native", f"{what}: the stream took {run['stream_path']}")
            expect = train_launches(RESUME_LAYERS, False)
            for i, st in enumerate(run["per_step"]):
                require(st["launches"] == expect, f"{what} step {i} launched {st['launches']}")
            return run

        # (a) straight through: the warm-up step takes batch 0, timed steps 1..3
        params, opt, state = fresh()
        cudaex.reset_launch_counts()
        a = checked(pretrain.run("llama3-8b-bench", steps=3, params=params, opt=opt,
                                 state=state, **kw), "(a)")
        counts, designs = cudaex.launch_counts(), cudaex.design_counts()
        require(all(counts[k] for k in train_launches(RESUME_LAYERS, False)),
                f"a kernel of the path never launched: {counts}")
        require_residual_vector("phase 14", designs, counts)
        want = [t.detach().cpu() for t in tree_leaves({"params": params, "opt": state})]
        del params, opt, state
        gc.collect()
        torch.cuda.empty_cache()

        # (b) two steps, checkpoint, drop, load, two more from start_step=2
        params, opt, state = fresh()
        b1 = checked(pretrain.run("llama3-8b-bench", steps=1, params=params, opt=opt,
                                  state=state, start_step=0, **kw), "(b) before the save")
        ck = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        background = checkpoint.save_checkpoint(ck, {"params": params, "opt": state},
                                                asynchronous=True)
        save_blocking_s = time.perf_counter() - t0
        checkpoint.wait_for_checkpoints()
        save_total_s = time.perf_counter() - t0
        require(background, "an asynchronous save committed before returning")
        ck_bytes = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        del params, opt, state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded = checkpoint.load_checkpoint(ck, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        params, state = loaded["params"], loaded["opt"]
        b2 = checked(pretrain.run("llama3-8b-bench", steps=1, params=params,
                                  opt=AdamW(lr=1e-4), state=state, start_step=2, **kw),
                     "(b) after the load")
        got = tree_leaves({"params": params, "opt": state})
        losses_b = b1["losses"] + b2["losses"]
        require(losses_b == a["losses"], f"resumed losses {losses_b} != straight {a['losses']}")
        require(len(got) == len(want) and all(bool(torch.equal(g.cpu(), w))
                                              for g, w in zip(got, want)),
                "resumed parameters or moments differ from the straight run's")
        del want
        batch_ms = [st["batch_ms"] for r in (a, b1, b2) for st in r["per_step"]]
        out.update(launches=counts, losses=a["losses"], losses_resumed=losses_b,
                   bit_identical=True,
                   stream_path=a["stream_path"], step_ms=a["step_ms"],
                   launches_per_step=train_launches(RESUME_LAYERS, False), designs=designs,
                   save_blocking_s=save_blocking_s, save_total_s=save_total_s,
                   load_s=load_s, checkpoint_bytes=ck_bytes,
                   batch_ms_mean=sum(batch_ms) / len(batch_ms), batch_ms=batch_ms)

        # clip_grad_norm on one step's full-width grads (batch 4 of the stream)
        stream = data.ShardedTokenStream(tokens, TRAIN_BATCH, TRAIN_SEQ, seed=RESUME_DATA_SEED,
                                         native=True)
        tok, tgt = (torch.from_numpy(t.astype(np.int64)).to(dev) for t in stream.batch_at(4))
        _, grads = pretrain.loss_and_grads(params, tok, tgt, cfg)
        for p in tree_leaves(params):
            p.requires_grad_(False)
        del loaded, state
        gleaves = tree_leaves(grads)
        norm64 = math.sqrt(sum(float(g.double().square().sum()) for g in gleaves))
        clipped, norm = clip_grad_norm(grads, 0.5 * norm64)
        norm_err = abs(float(norm) - norm64) / norm64
        require(norm_err <= CLIP_NORM_RTOL, f"clip_grad_norm: norm {float(norm)} against the "
                                            f"float64 {norm64} ({norm_err:.2e} relative)")
        copies = []
        for g in gleaves:
            p = torch.nn.Parameter(torch.empty_like(g))
            p.grad = g.clone()
            copies.append(p)
        torch_norm = float(torch.nn.utils.clip_grad_norm_(copies, 0.5 * norm64))
        clip_err = 0.0
        for mine, ref in zip(tree_leaves(clipped), copies):
            diff = (mine.float() - ref.grad.float()).abs()
            clip_err = max(clip_err, float((diff / ref.grad.float().abs().clamp_min(1e-30)).max()))
            require(bool((diff <= CLIP_RTOL * ref.grad.float().abs() + 1e-30).all()),
                    f"clip_grad_norm: clipped grads differ from clip_grad_norm_'s ({clip_err})")
        same, _ = clip_grad_norm(grads, 2.0 * norm64)   # below the threshold: unchanged
        require(all(bool(torch.equal(x, y)) for x, y in zip(tree_leaves(same), gleaves)),
                "clip_grad_norm below the threshold changed the grads")
        out["clip_grad_norm"] = {"norm": float(norm), "norm_float64": norm64,
                                 "norm_rel_err": norm_err, "torch_norm": torch_norm,
                                 "max_rel_diff_vs_clip_grad_norm_": clip_err,
                                 "max_norm": 0.5 * norm64}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from thunder_tpu_torch import optim as toptim
        from thunder_tpu_torch.benchmarks import bench, pretrain
        from thunder_tpu_torch.executors import cudaex
        from thunder_tpu_torch.models import llama as tllama
        from thunder_tpu_torch.ops import nn as tnn
        from thunder_tpu_torch.ops import optim as toptim_ops
        from thunder_tpu_torch.serving import SamplingParams, ServingEngine
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    log(card)
    t0 = time.perf_counter()
    compile_s = cudaex.build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in compile_s.items())})")

    log("kernels vs plain versions (bf16, full width):")
    rows = check_kernels(torch, cudaex, tnn)
    c1 = check_c1_inputs(torch, cudaex, tnn)
    train_rows = check_train_kernels(torch, cudaex, tnn, toptim_ops, tllama)
    log("the headline train bench's kernels vs plain versions (full width):")
    slab_rows = check_slab_kernel(torch, cudaex, toptim_ops, toptim, tllama)
    bench_planned_rows = check_planned_kernels(torch, cudaex, tnn, tllama, Fm=BENCH_F)
    planned_rows = check_planned_kernels(torch, cudaex, tnn, tllama)
    log("serving planned rung kernels vs plain versions (bf16, full width):")
    sp_rows = check_serving_planned_kernels(torch, cudaex, tnn, tllama)
    log(f"card vs CPU (tiny-gqa, float32): {json.dumps(card_vs_cpu(np, torch, tllama, ServingEngine))}")

    def serve(block_fusion):
        t0 = time.perf_counter()
        params = tllama.init_params(tllama.CONFIGS["llama3-8b"], seed=0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        out = full_width(np, torch, tllama, ServingEngine, SamplingParams, cudaex, params,
                         block_fusion)
        del params
        gc.collect()                  # the 16 GB of weights
        torch.cuda.empty_cache()
        return dict(out, param_init_s=init_s, card=card)

    fw = serve(False)
    log("full width: " + json.dumps(fw))
    require_wgmma("phase 5", fw["designs"])

    tc = train_card_vs_cpu(np, torch, tllama, pretrain)
    log(f"train card vs CPU (tiny-gqa, float32): {json.dumps(tc)}")
    tw = train_full_width(torch, cudaex, pretrain)
    log_train("train full width", tw)
    gc.collect()
    torch.cuda.empty_cache()

    tcp = train_card_vs_cpu(np, torch, tllama, pretrain, block_fusion=True)
    log(f"planned train card vs CPU (tiny-gqa, float32): {json.dumps(tcp)}")
    tp = train_full_width(torch, cudaex, pretrain, block_fusion=True)
    log_train("planned train full width", tp)
    require_wgmma("phase 9", tp["designs"])
    gc.collect()
    torch.cuda.empty_cache()

    pc = card_vs_cpu(np, torch, tllama, ServingEngine, cudaex, block_fusion=True)
    log(f"planned serving card vs CPU (tiny-gqa, float32): {json.dumps(pc)}")
    sb = subblock_step(np, torch, tllama, tnn, cudaex)
    log(f"sub-block decode step card vs CPU (tiny-gqa, float32): {json.dumps(sb)}")
    fp = serve(True)
    log("planned full width: " + json.dumps(fp))
    require_wgmma("phase 11", fp["designs"])
    log("serving, per-op vs planned rung: " + json.dumps({
        k: [fw[k], fp[k]] for k in ("decode_tok_per_s", "decode_step_ms_mean", "ttft_ms_mean",
                                    "peak_memory_gb", "wall_s")}))

    bc = bench_card_vs_cpu(np, torch, tllama, bench)
    log(f"bench card vs CPU (tiny-gqa, float32): {json.dumps(bc)}")
    ba = bench_full_width(torch, cudaex, bench, remat=True, block_fusion=False)
    log_train("bench full width (remat, slab state)", ba)
    bb = bench_full_width(torch, cudaex, bench, remat=False, block_fusion=True)
    log_train("bench full width (slab state, planned)", bb)
    for run in (ba, bb):
        require_wgmma("phase 13", run["designs"])
    log("bench, remat vs planned: " + json.dumps({
        k: [ba[k], bb[k]] for k in ("step_ms", "tokens_per_s", "share_of_989_tflops",
                                    "peak_memory_gb", "optimizer_ms", "logits_route")}))

    rs = train_resume(np, torch, cudaex, pretrain, tllama)
    log(f"train from a token file, checkpoint and resume: {json.dumps(rs)}")

    # one row per kernel and main path: the path's own shape and its own
    # launch count (rms_norm and rms_norm_residual run on several paths;
    # the planned path's rows for kernels it shares with the per-op train
    # path carry the train path's timings)
    keys = ("name", "path", "shape", "design", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    planned = {name: train_rows.get(name) or planned_rows[name]
               for name in tp["launches_per_step"]}
    # the serving planned path: rms_norm at the decode shape (the same kernel
    # at both rungs: no chain), mlp_subblock at the prefill chunk
    serve_planned = {"decode_layer": sp_rows["decode_layer"],
                     "rms_norm": [dict(rows["rms_norm"][0], per_op_chain_ms=None)],
                     "mlp_subblock": sp_rows["mlp_subblock"]}
    bench_rows = {name: slab_rows.get(name) or train_rows[name]
                  for name in ba["launches_per_step"]}
    bench_planned = {name: slab_rows.get(name) or train_rows.get(name)
                     or bench_planned_rows[name] for name in bb["launches_per_step"]}
    for path, path_rows, run in (("serve", rows, fw), ("train", train_rows, tw),
                                 ("train-planned", planned, tp),
                                 ("train-bench", bench_rows, ba),
                                 ("train-bench-planned", bench_planned, bb),
                                 ("serve-planned", serve_planned, fp),
                                 ("serve-subblock", {"attn_subblock": sp_rows["attn_subblock"]},
                                  sb),
                                 ("train-resume", {name: train_rows[name]
                                                   for name in rs["launches_per_step"]}, rs)):
        for name, rs in path_rows.items():
            r = dict(rs[0], path=path, launches=run["launches"][name])
            kernels.append({k: r[k] for k in keys + ("per_op_chain_ms",) if k in r})
    other_rows = [dict(r, card=card) for rs in (*rows.values(), *train_rows.values(),
                                                sp_rows["mlp_subblock"]) for r in rs[1:]]
    log("other-shape kernels: " + json.dumps(other_rows))
    log("C.1 inputs: " + json.dumps(c1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
