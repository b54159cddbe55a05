#!/usr/bin/env python3
"""On-card smoke test of thunder_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero without the
final line):

1. card — the card's name and power limit, as nvidia-smi reports them;
2. build — nvcc builds every kernel from thunder_tpu_torch/csrc/ (a
   source that fails stops only its own kernels, ``cudaex.build_failures``;
   here every one must build);
3. kernels — each hand-written kernel against its plain PyTorch version at
   the serving path's full-width shapes in bf16 (8 decode rows and a
   512-row prefill chunk, D=4096, F=14336; paged attention with 8 kv heads,
   G=4, hd=128, 16-token pages, ragged lengths 1..2048), then timed beside
   its plain version, its bound and, where one PyTorch call computes the
   same function, that call;
4. card vs CPU — a float32 tiny-gqa engine on the card and on the CPU, same
   weights, mixed prompt lengths, a pool small enough to preempt: identical
   greedy tokens;
5. full width — llama3-8b at full width, SERVE_LAYERS of its 32 layers
   (the script's time; phase 22 serves the same cell at all 32), bf16,
   random weights from a seed, serves 8 requests (prompts 17..1000 tokens,
   32 new tokens each, 2 of them sampled); the launch counts show every
   decode step went through all four kernels, linear_act's one launch a
   layer each on its weight-streaming design, paged_decode_attention's on
   its split design and rms_norm's on its vector design.

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
    step launches decode_layer one a layer (each on its stream design) and
    rms_norm 1, every prefill chunk rms_norm one a layer and mlp_subblock
    one a layer but the last; decode tok/s, TTFT and peak memory beside
    phase 5's.

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

The bench's, the resume's and the guard's steps are the compiled step,
``jit(train_step, donate_argnums=(0, 1))``: one CUDA graph an entry (the
first call per call, the second captured), ``fused_adamw_slab`` and the
health passes through their ``jit`` claims, the chunked loss and its VJP
as the torch executor's composites:

12. bench, card vs CPU — three float32 tiny-gqa steps of the bench's
    compiled step (4 layers, B=2, T=64, remat, slab state with bf16 m) on
    the card (one graph) and on the CPU from the same weights: the same
    losses, parameters and slabs;
13. bench, full width — llama2-7b-bench (D=4096, 32 heads, F=11008, vocab
    32000, bf16) at 8 layers, B=8, T=2048, a warm-up step and 4 timed steps
    through the bench entry point, (a) ``--remat --slab-state``: every step
    launches rms_norm 25, rms_norm_residual 8, sdpa_fwd 16, sdpa_bwd 8 (the
    attention all wgmma) and fused_adamw_slab 1 times; (b) ``--slab-state
    --block-fusion``, the reference's default step at this shape: rms_norm 9,
    mlp_subblock 8, mlp_subblock_bwd 8, sdpa_fwd 8, sdpa_bwd 8,
    fused_adamw_slab 1; each entry one graph; losses finite and falling,
    each within JIT_TRAIN_LOSS_RTOL of the bench's eager baseline arm from
    the same weights; (a)'s guarded arm (``NumericsGuardTransform``) adds
    fused_adamw_slab_health 1 a step, losses within the same bound; step
    time, tokens/s, the share of the bf16 peak, peak memory of each arm,
    ``baseline_step_ms``, ``vs_baseline``, ``sentinel_overhead_pct`` and the
    fused loss's logits route.

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

The numerics guard and the kernel quarantine (``runtime/``,
``transforms/numerics_guard.py``): phase 3 also holds the AdamW health
passes (``fused_adamw_health`` at the per-step train bucket,
``fused_adamw_slab_health`` at the bench bucket) against their plain twins
(the non-finite counts exactly, the sum of g*g 1e-6 relative, two calls
bit-identical, nothing stored; then with a NaN grad and a grad whose
square overflows v' planted, non-zero counts equal to the twin's) and
times each beside its bound. Then:

15. guard and quarantine — (a) llama3-8b-bench at 4 layers, per-op rung,
    B=8, T=2048: five steps compiled with ``NumericsGuardTransform``
    (``pretrain.run(guard=...)``, one graph) give params, moments and
    ``step`` bit-identical to five unguarded compiled steps from the same
    weights, each launching the health pass and the gated update once; a
    sixth step through the guarded compiled step with ``numerics:grads``
    poison leaves all of it bit-identical, with nonfinite_steps ==
    skipped_steps == 1; the eager guard (``pretrain.train_step(...,
    guard=NumericsGuard())``: ``AdamW.health`` and ``update(health=)``
    outside a trace) takes a step bit-identical to an unguarded eager step
    from the same state, launching the health pass once, and a poisoned
    eager step leaves the state bit-identical; the traced health word's grad norm within 1e-6 of
    the float64 norm of the same program's grads; NaNs planted in the last
    grad element (through the compiled gated update) and, on a bucket of
    odd sizes, in a scalar tail and the last chunk, each counted once and
    each stopping the gated update; the health pass timed against its bound
    and the guarded step against the unguarded one, both peak memories.
    (b) the same on the slab path (the bench's
    ``AdamW(slab_persistent=True)``) at 2 layers. (d) llama3-8b at full
    width, 8 layers, planned rung, bf16: ``kernel:cuda.decode_layer``
    injected on decode step 2 (the traced step's capture: a replay runs no
    router) is contained by one rebind (the claim
    quarantined, decode_layer launches frozen, ``attn_subblock`` and
    ``mlp_subblock`` launching), the replayed step's logits equal a fresh
    sub-block step's on its inputs and match the plain sub-block chain row
    by row; then ``attn_subblock`` and ``mlp_subblock`` quarantined (the
    runner rebinds to the per-op rung's kernels); every request of those
    stages done. Then ``rms_norm_residual`` quarantined too: a leaf kernel
    has no kernel rung below it, so the next request's prefill raises a
    fatal ``KernelExecutionError`` naming it, with no plain version run.
    (e) float32 tiny-gqa under the same faults, card against CPU: identical
    tokens, the replayed step's logits within phase 10's bound; the
    quarantined leaf raises on the card, while the CPU runs its plain
    version, as it always does there. Phase 13 (a) also reports
    ``sentinel_overhead_pct``.

The serving fleet (``serving/prefix_cache.py``, best-of-N forks,
``serving/supervisor.py``, ``models/llama.generate``/``generate_fused``):

16. fleet — llama3-8b at full width, FLEET_LAYERS of its 32 layers (the
    script's time), bf16, the seed of phase 5's weights, 8
    slots, 16-token pages. (a) At each rung, 8
    requests of one 1024-token system prompt and their own 17..200-token
    tails, 16 greedy tokens, cold then warm (fresh tails) on one
    ``prefix_cache=True`` engine, beside a ``prefix_cache=False`` engine
    serving the same 16 prompts: identical tokens; cold requests hit nothing
    and prefill every chunk, warm ones hit exactly the 64 system pages and
    prefill one chunk; ``prefix_hit_rate`` and ``cached_pages`` at the
    values the lengths give; the cached system pages equal, bit for bit, the
    pages the other engine's first request wrote; every decode step and
    prefill chunk launched its rung's kernels on the designs the rules name
    (``split``, ``stream``, ``vector``, ``wgmma``); cold, warm and solo
    TTFT. (b) ``submit(best_of=4)`` at temperature 0.8, seed pinned: each
    branch equals an independent request on ``sampling.fork(i)``, each
    copied tail page equals the primary's at the fork; peak pages against
    the independent requests'. (c) planned rung under ``EngineSupervisor``,
    a ``serving:engine`` fault on the 5th decode step: one restart, every
    request done at full length, the tokens before the fault equal to a
    fault-free run's, the pool quiescent. (d) first its prefill's kernels
    at the prefill's own shapes (8 x 1000 rows: rms_norm, rms_norm_residual
    and linear_act, whose wgmma tile path ends in a ragged 64-row M tile)
    against their plain versions, timed; then ``generate`` and
    ``generate_fused`` (the decode step captured once in a CUDA graph) on 8
    prompts of 1000 tokens, 32 greedy tokens: identical tokens, the capture
    launching what one eager step launches (the counters run on the host,
    so a replay adds none: the path's launches in the kernels table add the
    captured step once a replay, beside the host counters' ``host_launches``),
    the first-step logits within GENERATE_LOGITS_TOL of the engine's
    replay-step logits row by row, one bucketed 700-token call; prefill ms,
    decode tok/s of both, and the device ms of one graph replay from CUDA
    events (``benchmarks/generate.py``). (e) (a)-(d) on tiny-gqa float32 on the
    card and on the CPU: every token identical, across the forks and the
    restart.

The model zoo (``models/{mixtral,gpt,nanogpt,seq2seq,resnet}.py``,
``optim.SGD``, ``benchmarks/zoo.py``): phase 3 also holds the kernels at the
shapes phase 17 gives them (attention at Mixtral's hd 128, hd 64 at 16, 25,
32 and Falcon's 71 heads, Gemma's hd 256, BART's non-causal float32
cross-attention T 512 against S 1024 and its other two; ``ce_fwd`` on each
model's float32 logits, 50257 and 50265 on its scalar loads, 256000, and
1000 classes; the norms at (1, 2048, 4096) and Gemma's D = 2048 in bf16,
BART's D = 768 in float32; ``fused_adamw`` over each path's own whole
bucket, Mixtral's 3.16 G parameters at 2 layers among them, checked leaf by
leaf), each on the design its rule names.

17. zoo — (a) each tiny config (tiny-moe, the five tiny gpt configs,
    gpt2-tiny, seq2seq tiny, resnet-tiny) in float32 on the card and on the
    CPU from the same weights and batch: the loss, every gradient and the
    parameters after one optimizer step (ZOO_GRAD_RTOL, phase 6's bounds),
    tiny-moe's top-k experts identical in every layer, the card's step
    launching the reference's claims. (b) Mixtral-8x7B at full width, 2 of
    its 32 layers, B=1, T=2048, bf16, AdamW with float32 moments: 3 steps of
    ``loss_fn``, then ``loss_fn`` without a gradient and one step of
    ``fused_loss_fn(remat=True)`` on the same weights and batch (the two
    losses within MIXTRAL_FUSED_LOSS_ATOL, which the router aux term must
    exceed), then ``expert_utilization``.
    (c) each other family at full width, a warm-up and ZOO_STEPS timed steps
    on one batch: pythia-410m, phi-1.5 and gemma-2b at full depth (B=1,
    T=2048), gpt2-medium at full depth (B=2, T=1024: its 1024 learned
    positions), falcon-7b at 4 of 32 layers, nanogpt gpt2-xl (B=4, T=1024),
    bart-base (source 1024, target 512, float32), resnet18 (B=64, 224 x 224,
    float32, ``SGD(momentum=0.9)``). In (b) and (c) the losses are finite and
    fall on the repeated batch, every step launches each kernel as often as
    the reference's training trace claims it (``zoo.expected_launches``),
    and the step ms, tokens/s (images/s) and peak memory are printed.

18. jit — the trace compiler's grad-free slice (``thunder_tpu_torch.jit``)
    at llama3-8b full width, SERVE_LAYERS of its 32 layers (the script's
    time), bf16, the phase-5 weights' seed, B=1, T=2048: (a) ``jit(llama.forward)``, (b)
    ``jit(llama.loss_fn)`` as an evaluation loss, (c) ``jit`` of one Llama
    layer written in plain PyTorch (``F.rms_norm``, ``F.linear``,
    ``F.silu``, ``F.scaled_dot_product_attention(is_causal=True)``, the
    residual adds) at llama3-8b width, where the epilogue pass builds
    ``rms_norm_residual`` and ``linear_act`` and the claim pass takes
    ``rms_norm`` and attention. Each cached call launches exactly the
    kernels its execution trace claims. (a)'s logits against the eager
    ``forward`` (the same kernels and torch calls in the same order: bit
    for bit), (b)'s loss against the eager ``loss_fn`` (bit for bit), (c)
    against the same function run eagerly on PyTorch's library calls
    (JIT_LAYER_TOL of each row's largest value); (a), (b) and (c) compile
    with ``block_fusion=False`` (the per-op rung, the eager calls). (a,
    default) and (b, default) compile (a) and (b) at the defaults, where
    the cost model's grad-free verdict plans every MLP sub-block: each
    launches rms_norm 33, sdpa_fwd 32 and mlp_subblock 32 (and ce_fwd 1),
    exactly its claims and the eager planned call's (``block_fusion=True``),
    bit for bit with it, and is timed against its per-op compile in turn
    (``default_rung``): where the two differ by more than PLANNED_JIT_GAP
    the default must be the faster. Printed: compile ms by
    stage (trace, passes, codegen), the host time of a cached call, of a
    ``bind()`` call and of the guard lookup alone, the forward's device ms
    through ``jit`` and eagerly with the torch calls each makes, and the
    phase's seconds. Phase 3's rows at the slice's shapes: the norms on
    (1, 2048, 4096), attention (1, 32, 2048, 128) causal, ``linear_act``
    (2048 x 4096) x (14336 x 4096), ``ce_fwd`` 2048 x 128256 float32, and
    phase 3's ``mlp_subblock`` row at 2048 rows for the defaults.

19. jit-train — trace-level autograd (``value_and_grad``, the VJP rules,
    trace-level ``checkpoint``): ``pretrain.jit_train_step`` (the
    reference's ``tt.jit(train_step, donate_argnums=(0, 1))``) at phase 7's
    cell (llama3-8b-bench, 4 of 32 layers, B=8, T=2048, seed 0,
    AdamW(lr=1e-4), one batch reused), 5 steps: (a) plain, (b) with every
    layer a checkpointed region. Every step launches exactly its trace's
    claims (``jit_train_launches``: (a) phase 7's, ``sdpa_bwd`` and
    ``fused_adamw`` through the jit's claims; (b) the reference's remat
    trace's, each region's forward ``rms_norm`` twice and the lse-free
    attention, its recompute ``rms_norm``, ``rms_norm_residual`` and
    ``sdpa_fwd``), the losses are finite and fall, each within
    JIT_TRAIN_LOSS_RTOL of phase 7's eager step from the same weights and
    batch, the donated parameters and moments come back as the same
    storage, and (b)'s peak memory is below (a)'s. Printed: the step ms
    (median of steps 2-5) against phase 7's, the peak memory against
    phase 7's, the host ms of a cached step and its torch calls, compile
    seconds by stage, and the device ms by kernel family of (a) and of the
    eager step (``pretrain.profile_steps``, 2 steps each). Its kernel rows
    are phase 3's train rows (the cell's shapes).

20. module — ``jit(nn.Module)`` and the torch-autograd bridge at phase 7's
    cell: ``testing.PlainLlama`` (a plain-PyTorch Llama module:
    ``nn.Embedding``, bias-free ``nn.Linear``, ``F.rms_norm``,
    ``F.scaled_dot_product_attention``, ``F.cross_entropy``) from phase 7's
    weights, ``tm = thunder_tpu_torch.jit(module, block_fusion=False)``. (a) 5 steps of ``loss =
    tm(tokens, targets); loss.backward()``, then ``optim.AdamW(lr=1e-4)``
    over the module's parameters and their ``.grad``, written in place:
    each step's forward launches exactly MODULE_FWD (rms_norm 1, sdpa_fwd 4,
    rms_norm_residual 8, ce_fwd 1) and its backward MODULE_BWD (sdpa_bwd 4),
    both its traces' claims, the update ``fused_adamw`` 1; the first
    backward's ``.grad`` of every leaf within MODULE_GRAD_TOL of each row's
    largest value of the same module run eagerly by torch autograd; the
    losses finite, falling, each within JIT_TRAIN_LOSS_RTOL of phase 7's;
    one compiled pair. (b) the grad-free call launches MODULE_EVAL (with
    ``linear_act`` 4 and the lse-free attention) and its loss is within
    JIT_TRAIN_LOSS_RTOL of the bridge's on the same weights; (b, default)
    the grad-free call of ``jit(module)`` at the defaults launches
    MODULE_EVAL_PLANNED (every MLP sub-block planned), exactly its claims,
    its loss within PLANNED_JIT_LOSS_RTOL of (b)'s, timed against (b) as
    phase 18's defaults are. (c) the
    function path's bridge on phase 18 (c)'s layer with x and the weights
    requiring grad: the forward launches rms_norm, sdpa_fwd and
    rms_norm_residual once, the backward sdpa_bwd once, and the gradients
    are within MODULE_GRAD_TOL of eager bf16 autograd's and of float32
    autograd's on the same inputs. Printed: the step ms
    against phase 7's and phase 19's, the peak memory of steps 2-5, the
    host ms of a cached call of each half, compile seconds, device ms by
    kernel family, and the count and bytes of the saved tensors beside what
    ``rematerialize_forward_and_backward`` would save from the same traces.
    Its kernel rows: phase 3's train rows, ``linear_act`` at (8 x 2048) x
    (14336 x 4096) for (b), phase 18's rows for (c).

21. planner — block, horizontal and optimizer fusion under the card's cost
    model (``core/fusion_passes.py``, ``core/cost_model.py``) at phase 7's
    cell. (a) ``pretrain.jit_train_step(cfg, opt, block_fusion=True)``, 5
    steps: each launches phase 9's eager planned step's kernels
    (``mlp_subblock`` 4, ``mlp_subblock_bwd`` 4, ``sdpa_fwd`` 4, ``sdpa_bwd``
    4, ``rms_norm`` 5, ``ce_fwd`` 1, ``fused_adamw`` 1), exactly its trace's
    claims, and the losses are within PLANNED_JIT_LOSS_RTOL of phase 9's.
    (b) phase 19 is the unset compile: its block, horizontal and optimizer
    verdicts are printed with their cost numbers, and its block verdict
    must pick the rung measured faster in this run ((a) or phase 19)
    wherever the two differ by more than PLANNED_JIT_GAP. (c) with
    ``cuda.mlp_subblock`` quarantined, (a)'s function recompiles once to
    phase 19's claims and launches them for 2 steps. (d)
    ``jit(testing.PlainLlama, block_fusion=True)`` trained 2 steps by
    ``loss.backward()``: (a)'s launches, the first loss within
    PLANNED_JIT_LOSS_RTOL of phase 20's. Printed: step ms (median of steps
    2-5), elementwise ms, idle share and peak memory beside phase 9's and
    19's, compile seconds and stages. (e) phase 19's compile, whose
    horizontal pass merges the q/k/v products, against the same step with
    ``horizontal_fusion=False``, taking steps in turn on one state
    (HORIZONTAL_ROUNDS rounds of unset, off, off, unset), each launching
    phase 19's kernels: both step ms printed. Its kernel rows are phase 9's.

Phases 18, 19 and 21 (a) run each program twice: with the whole-program
replay (``whole_program_jit``, the default: each cached entry's first call
runs per call, its second is captured in a CUDA graph, later calls replay
it; ``executors/cudagraphex.py``) and with ``whole_program_jit=False``.
The replay's output (logits, losses) must equal the per-call program's bit
for bit, every replayed step launches exactly its trace's claims (a
capture's launches are counted once per replay), and both are timed
(device ms, host ms a call, torch calls; the step's device profile).

The serving engine runs traced steps (``serving/runner.py``: ``jit`` of the
decode and prefill programs, the page pools donated and written in place),
so phases 4, 5, 10, 11, 15 and 16 drive it too; phase 15's
``decode_layer`` fault is aimed at the decode step's capture (its second
call: a replay runs no router).

22. serving on jit — the traced engine at phase 5's cell (llama3-8b, 32
    layers, bf16, 8 slots, the seed of phase 5's weights, 8 requests of
    17..1000 prompt tokens, 32 new, 2 sampled, a 2048-token context of
    16-token pages) at each rung (``block_fusion=False``, ``True`` and
    unset), each with the replay and with ``whole_program_jit=False``:
    every chunk shape and the decode step compiled and captured first
    (``warm_engine``), then the requests: every decode
    step launches its rung's kernels on their designs (per-op
    ``linear_act`` 32, ``paged_decode_attention`` 32, ``rms_norm_residual``
    64, ``rms_norm`` 1; planned ``decode_layer`` 32, ``rms_norm`` 1), with
    and without the replay the same tokens and launches, each request's
    first-token logits (its replay step) within GENERATE_LOGITS_TOL of
    ``llama.generate``'s first step row by row. Then ROADMAP C.6's
    readings (``serve_jit_readings``): on the three replaying engines
    (per-op, planned, unset), SERVE_JIT_ROUNDS rounds of (per-op, planned,
    unset, unset, planned, per-op) runs of the cell, each run's median
    decode step ms; the unset rung's median may exceed the faster rung's
    by more than PLANNED_JIT_GAP only within the readings' spread
    (``serve_jit_verdict``; the unset verdict may plan one sub-block of a
    layer alone, whose launches are held to its trace's claims). Printed: decode
    tok/s, the median step's host ms (until its launches are issued) and
    ms to a device sync, mean TTFT, SERVE_JIT_PROFILE traced decode steps'
    device busy ms, idle share and ms by kernel family, the graphs'
    captures, replays and copied bytes, every reading. Its kernel rows:
    phase 3's decode and prefill rows.

23. the region executor (``executors/regionex.py``) — every compiled
    program of phases 12-22 runs its elementwise regions as generated
    kernels, each step launching one ``region`` a region of its trace.
    First the card's memory (``memory_report``: allocated, live tensors,
    graph pools). (a) every distinct region (source and input shapes) of
    phase 19 (a)'s program and of phase 22's per-op decode and prefill
    programs, on
    random inputs at its program's shapes, against its plain chain (the
    members' torch calls): bit for bit where it holds no transcendental
    op, within REGION_ULP of the output dtype where it does; the largest
    timed against its chain and its bound by bytes (the ``region`` row).
    (b) phase 19 (a)'s step and phase 15 (a)'s guarded step, regions on
    and off, on one state, REGION_AB_ROUNDS rounds of (on, off, off, on)
    turns of REGION_AB_STEPS replayed steps: step ms, the guard's
    overhead each way, elementwise device ms, and the torch calls, claims
    and regions a step runs (``trace_calls``). (c),
    (d) phase 13 (a) and (b)'s compiled bench step the same way, with
    ``vs_baseline`` against phase 13's eager arm. Printed beside them: the
    regions' nvcc seconds in the script.

No phase can fall back to a plain version on the card: a CUDA call whose
inputs a kernel does not take raises in the kernel's wrapper, with the
reason ``cudaex.refusal`` gives, and fails its phase; a quarantined kernel
with no kernel rung below it raises in its router.

The last line of standard output is the JSON result the checker reads; the
line before it holds the kernels table (one row per kernel and main path,
with that path's shape and launch count), and the line before that the
card.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import warnings

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
# T=2048, a warm-up step and 4 timed steps (the compiled arms' first timed
# step captures the graph: their step time is the mean of the 3 replays); its
# MLP width
BENCH_LAYERS, BENCH_STEPS, BENCH_F = 8, 4, 11008
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
# phase 15: the numerics guard and the kernel quarantine. (a) llama3-8b-bench
# per-op at 4 layers (phase 7's cell), (b) the slab path at 2 layers: five
# guarded compiled steps (a warm-up and four timed: the first captures the
# graph, the step time is the mean of the 3 replays) against five unguarded
# ones, bit for bit; the health pass against its plain twin: the non-finite counts
# exactly, the sum of g*g 1e-6 relative (float32 chunk sums folded in
# float64, against float32 sums per tensor in another order: 3.4e-8 on the
# card; one chunk of the ~277 k dropped from the sum moves it ~3.6e-6); the
# word's grad norm against a float64 norm of the grads, 1e-6 relative (PR
# 10's clip_grad_norm check stood at 4.1e-8 on such grads)
GUARD_LAYERS, GUARD_SLAB_LAYERS, GUARD_STEPS = 4, 2, 5
HEALTH_SUMSQ_RTOL = 1e-6
HEALTH_NORM_RTOL = 1e-6
HEALTH_LIBRARY_NOTE = "no one PyTorch call counts the non-finite values of the update's outputs"
# (d) llama3-8b serving at the planned rung, depth cut to 8 layers, the
# injected decode_layer fault on the engine's 2nd decode step: the traced
# step's capture, the last call whose routers run on the card (its first
# ran per call; later ones replay the graph); the replayed step's logits
# against the plain sub-block chain on the same inputs, row by row,
# DECODE_TOL of each row's largest value (bf16 rounds at other points in
# every layer's two sub-blocks)
QUARANTINE_LAYERS, FAULT_DECODE_STEP = 8, 2
# phase 16: the serving fleet on llama3-8b at full width, FLEET_LAYERS deep. (a) 8
# requests share a 1024-token system prompt (a multiple of the 512-token
# chunk, so a warm request's tail chunk has the shape of a cold one's), each
# with its own tail of 17..200 tokens and 16 greedy tokens, cold then warm
# (fresh tails); (b) best-of-4 over a 700-token prompt (not page-aligned:
# each clone copies the tail page) at temperature 0.8, seed pinned; (c) a
# serving:engine fault on the 5th decode step, planned rung; (d) generate
# and generate_fused on 8 prompts of 1000 tokens, 32 greedy tokens, a
# 2048-long contiguous cache (2.15 GB), and one call of 700 tokens with
# prefill_buckets=(512, 1024).
# (d)'s first-step logits of generate against the engine's replay-step
#   logits for the same prompts, row by row (row_rel_err), at most 0.05 of
#   each row's largest value: the two bf16 paths round at other points in
#   all 32 layers (the engine's chunked paged prefill and its T = 1 replay
#   against one contiguous prefill; phase 15 measured 0.0132 between two
#   bf16 paths over 8 layers)
FLEET_SLOTS, FLEET_CONTEXT = 8, 2048
FLEET_LAYERS = 4   # phase 16 (a)-(d)'s depth (of 32: cut for the script's time)
SERVE_LAYERS = 16  # phases 5, 11 and 18's depth (of 32; phase 22 serves all 32)


def serve_config(tllama):
    """Phases 5, 11 and 18's model: llama3-8b at full width, SERVE_LAYERS
    deep."""
    return dataclasses.replace(tllama.CONFIGS["llama3-8b"], n_layers=SERVE_LAYERS)
FLEET_SIZES = {"seed": 16, "system": 1024, "tails": (17, 40, 64, 90, 120, 150, 180, 200),
               "new": 16, "best_of": 4, "best_of_prompt": 700,
               "restart_prompts": (64, 300, 700, 1000), "gen_batch": 8, "gen_prompt": 1000,
               "gen_new": 32, "gen_max_len": 2048, "bucket_prompt": 700,
               "buckets": (512, 1024), "page_size": 16}
# (e) the same on tiny-gqa float32, card against CPU
TINY_FLEET_SIZES = {"seed": 17, "system": 32, "tails": (5, 9, 17, 30), "new": 6,
                    "best_of": 4, "best_of_prompt": 37, "restart_prompts": (7, 20, 41),
                    "gen_batch": 3, "gen_prompt": 20, "gen_new": 8, "gen_max_len": 64,
                    "bucket_prompt": 13, "buckets": (16, 32), "page_size": 8}
BEST_OF_TEMPERATURE, BEST_OF_SEED = 0.8, 1234
RESTART_FAULT_STEP = 5
GENERATE_LOGITS_TOL = 0.05
GEN_REPEATS = 2
FLEET_PATHS = ("serve-prefix", "serve-prefix-planned", "serve-best-of", "serve-restart-planned",
               "generate")

# phase 18: the trace compiler's slice at llama3-8b full width, B=1, T=2048
# (c) against eager library calls, row by row (row_rel_err), at most 2e-2 of
#   each row's largest value: the kernels round linear_act's silu, the norms
#   and attention at other points than cuBLAS, cuDNN and aten (GEMM_TOL)
JIT_B, JIT_T, JIT_TIMED = 1, 2048, 3
JIT_LAYER_TOL = 2e-2
JIT_PATHS = ("jit-forward", "jit-loss", "jit-layer")

# phase 19: the compiled train step at phase 7's cell (llama3-8b-bench, 4
# layers, B=8, T=2048, seed 0, AdamW(lr=1e-4)); each step's loss within 1%
# of phase 7's eager step from the same weights and batch: the trace's
# backward sums in other orders than autograd's, and index_add on bf16
# (the embedding gradient) accumulates with atomics, so the bf16 steps
# drift apart; bit equality is not expected
JIT_TRAIN_LOSS_RTOL = 1e-2
JIT_TRAIN_PROFILE = 2
JIT_TRAIN_PATHS = ("jit-train", "jit-train-remat")
# phases 12-15 on the compiled step (the bench's three arms, the resume, the
# guard on jit, and phase 15's eager guarded step beside it): each row's
# kernel must have launched in its path's run
BENCH_JIT_PATHS = ("bench-jit-remat", "bench-jit-remat-guarded", "bench-eager-remat",
                   "bench-jit-planned", "bench-eager-planned", "resume-jit", "guard-jit",
                   "guard-jit-slab", "guard-eager", "guard-eager-slab")

# phase 20: jit(nn.Module) through the torch-autograd bridge at phase 7's
# cell (testing.PlainLlama from the same weights and batch, 5 steps of
# loss.backward() and AdamW(lr=1e-4)); each loss within JIT_TRAIN_LOSS_RTOL
# of phase 7's. The first backward's .grad of every leaf against the same
# module run eagerly by torch autograd (flash attention, cuBLAS), row by
# row, at most 5e-2 of each row's largest value: two bf16 computations of
# one gradient round at different points (eager rounds a fused op's result
# once; the trace's pullbacks are the reference's prims, each rounded to
# bf16), and bf16 eager autograd is itself about 2e-2 of a row off float32
# autograd of one layer, as the bridge and the reference are
# (tests/test_torch_port_module.py::test_bf16_layer_gradients_against_float32,
# on the CPU with no kernel); (c) prints all three distances.
# (c) the function path's bridge: phase 18's layer with x and the weights
# requiring grad; its gradients within the same bound of eager bf16
# autograd's and of float32 autograd's on the same inputs
MODULE_GRAD_TOL = 5e-2
MODULE_HOST_ITERS = 5
MODULE_PATHS = ("module-train", "module-eval", "fn-bridge")
# phases 18 (a, default), (b, default) and 20 (b, default): the default
# compiles of the grad-free programs, planned by the cost model
DEFAULT_PATHS = ("jit-forward-default", "jit-loss-default", "module-eval-default")
# timed against the per-op rung in 3 rounds of (default, per-op, per-op,
# default): one block of JIT_TIMED calls can read 9% off its neighbours
DEFAULT_RUNG_ROUNDS = 3

# phase 21: the planner at phase 7's cell. (a) the planned compiled step's
# losses within 0.1% of phase 9's eager planned step (the same kernels at
# the sub-blocks, attention and the norms; the trace's prim pullbacks of the
# rope and the loss sum in other orders); (b) the unset compile's verdict
# must pick the rung measured faster wherever the two differ by more than
# 3% (step-to-step noise of a compiled step is under 1%, PERF.md §5);
# (c) 2 quarantined steps; (d) 2 bridge steps, the first loss within 0.1%
# of phase 20's (the same module, weights and batch)
PLANNED_JIT_LOSS_RTOL = 1e-3
PLANNED_JIT_GAP = 0.03
PLANNED_QUARANTINE_STEPS = 2
PLANNED_MODULE_STEPS = 2
PLANNED_PATHS = ("jit-train-planned", "module-train-planned")
# (e) phase 19's compile (horizontal_fusion unset) against the same step with
# horizontal_fusion=False, steps in turn on one state: HORIZONTAL_ROUNDS
# rounds of (unset, off, off, unset)
HORIZONTAL_ROUNDS = 3

# phase 22: the traced engine at phase 5's cell, each rung with and without
# the whole-program replay; SERVE_JIT_PROFILE decode steps traced for the
# device's busy and idle share; the unset verdict held to the rung measured
# faster (decode step ms, median) where the two differ by more than
# PLANNED_JIT_GAP; the replay step's logits against generate's first step
# within GENERATE_LOGITS_TOL (phase 16 (d)'s bound on the same two bf16
# paths)
SERVE_JIT_RUNGS = (("per-op", False), ("planned", True), ("unset", None))
SERVE_JIT_PATHS = ("serve-jit", "serve-jit-planned", "serve-jit-unset")
SERVE_JIT_LENGTHS = [17, 64, 150, 301, 480, 640, 800, 1000]
SERVE_JIT_NEW, SERVE_JIT_PROFILE = 32, 2
# the unset verdict's readings (ROADMAP C.6): rounds of (per-op, planned,
# unset, unset, planned, per-op) replayed cell runs (2 * SERVE_JIT_ROUNDS
# readings a rung); the unset rung's median may exceed the faster rung's by
# more than PLANNED_JIT_GAP only within the readings' own spread
SERVE_JIT_ROUNDS = 3

# phase 23: the region executor. Every distinct region of phase 19 (a)'s
# and phase 22's per-op programs against its plain chain (bit for bit, or
# within REGION_ULP of the output dtype where it holds a transcendental op);
# phases 19 (a) (with phase 15 (a)'s guarded step beside it) and 13 (a),
# (b) timed with the regions on and off in REGION_AB_ROUNDS rounds of (on,
# off, off, on), REGION_AB_STEPS replayed steps a turn
REGION_ULP = 1
REGION_AB_ROUNDS, REGION_AB_STEPS = 1, 3
HELD_REGIONS: dict = {}   # path -> the region callables of its programs, for phase 23

D, F_DIM, S_DECODE, M_PREFILL = 4096, 14336, 8, 512
KV, G, HD, PS = 8, 4, 128, 16
LENGTHS = [1, 17, 300, 512, 1000, 1500, 2047, 2048]
REPLAY = 1   # the decode slot that replays its last prompt token
EPS = 1e-5


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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
    k = {**cudaex.KERNELS, **cudaex.GENERATED}[name]
    row = {"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
           "shape": shape_tag,
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


def with_region(expect: dict, n: int) -> dict:
    """``expect`` (a step's hand-written kernels) with ``n`` region
    launches: the launches of a compiled program with ``n`` regions."""
    return dict(expect, region=n) if n else dict(expect)


def without_regions(counts: dict) -> dict:
    """Launches (or launches by design) of the hand-written kernels alone:
    the regions' are held to their programs' regions apart, and a region's
    design (``contiguous`` or ``strided``) follows from its inputs'
    strides."""
    return {k: v for k, v in counts.items() if k != "region"}


def program_regions(entry) -> int:
    """The regions one call of a cached ``jit`` entry launches (0 without
    an entry)."""
    from thunder_tpu_torch.testing import claimed_kernels

    return 0 if entry is None else claimed_kernels(entry.traces[-1]).get("region", 0)


def decode_regions(eng) -> int:
    """The regions one decode step of ``eng``'s bound program launches."""
    return program_regions(getattr(eng.runner._decode_bound, "entry", None))


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
    columns of the weight zeroed (a dropped K slab) and, where the rows end
    in a ragged 128-row M tile of the tile path, with that tile's rows of x
    zeroed (a dropped last tile), each held against the plain version of the
    intact inputs, must fail the check. Returns each fault's largest
    absolute error."""
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
    rows = x.numel() // x.shape[-1]
    tail = rows % 128
    if rows > 128 and tail:
        # a ragged last 128-row M tile: its rows of x zeroed (a dropped tile)
        fault = f"last M tile's {tail} rows of x zeroed"
        bad_x = x.clone()
        bad_x.view(-1, x.shape[-1])[-tail:] = 0
        got = cudaex.linear_act(bad_x, w, None, "silu")
        found[fault] = float((got.float() - want.float()).abs().max())
        require(not gemm_close(torch, got, want),
                f"linear_act {tuple(x.shape)}: the check passes a planted fault ({fault}: "
                f"{found[fault]})")
        del bad_x, got
    return found


def linear_act_row(torch, cudaex, tnn, gen, lead, iters=30):
    """linear_act as the MLP's gate projection with its silu: bf16 x of
    shape ``(*lead, D)`` against an (F_DIM, D) weight, held against its
    plain version, with the planted faults that must fail the check, timed;
    its row of the table."""
    import torch.nn.functional as F

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    n = math.prod(lead)
    x = torch.randn(*lead, D, generator=gen, device=dev).to(bf16)
    wg = (torch.randn(F_DIM, D, generator=gen, device=dev) * D ** -0.5).to(bf16)
    tag = "x".join(map(str, (*lead, D, F_DIM)))
    got, design = ran(cudaex, "linear_act", lambda: cudaex.linear_act(x, wg, None, "silu"))
    require(design == ("stream" if n <= 16 else "wgmma"),
            f"linear_act {n} rows: bf16 launch took {design}")
    want = tnn.linear_act_plain(x, wg, None, "silu")
    err = float((got.float() - want.float()).abs().max())
    require(gemm_close(torch, got, want),
            f"linear_act {tag}: kernel disagrees with its plain version ({err})")
    faults = linear_act_faults(torch, cudaex, x, wg, want)
    row = timed_row(torch, cudaex, "linear_act", tag, err,
                    lambda: cudaex.linear_act(x, wg, None, "silu"),
                    lambda: tnn.linear_act_plain(x, wg, None, "silu"),
                    lambda: F.linear(x, wg), (n * D + F_DIM * D + n * F_DIM) * 2,
                    2.0 * n * F_DIM * D, BF16_FLOPS, iters, iters)
    row["design"], row["planted_faults"] = design, faults
    log(f"    design {design}; planted faults (max abs err, the check must fail): "
        + json.dumps(faults))
    return row


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
        add(linear_act_row(torch, cudaex, tnn, gen, (n,)))

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
    from thunder_tpu_torch.optim import tree_leaves

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
    for fwd, bwd in attention_rows(torch, cudaex, tnn, gen, bf16, B, H, T, T, hd,
                                   (True, False), faults=True):
        rows.setdefault("sdpa_fwd", []).append(fwd)
        rows.setdefault("sdpa_bwd", []).append(bwd)

    # cross-entropy over the loss's f32 logits, with some ignored rows
    rows["ce_fwd"] = [ce_row(torch, cudaex, tnn, gen, *CE_SHAPE)]
    log("    (library: F.cross_entropy(reduction='none') gives nll without lse)")

    # AdamW over the 4-layer llama3-8b-bench bucket: one launch, in place;
    # then the health pass on it, which reads bf16 p and g, f32 m and v: 12
    # bytes an element
    def health(ps, gs, ms, vs, bc, hyper):
        return health_row(torch, cudaex, toptim_ops, "fused_adamw_health", (ps, gs, ms, vs), {},
                          bc, hyper, sum(p.numel() for p in ps), 12)

    cfg = tllama.CONFIGS["llama3-8b-bench"]
    adamw, health_r = adamw_bucket_row(
        torch, cudaex, toptim_ops, gen,
        tree_leaves(tllama.init_params(cfg, seed=2, device=dev, n_layers=TRAIN_LAYERS)), None,
        then=health)
    rows["fused_adamw"], rows["fused_adamw_health"] = [adamw], [health_r]
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def health_row(torch, cudaex, toptim_ops, name, args, kw, bc, hyper, n, bytes_per):
    """The health pass ``name`` at a main path's bucket (``args``: the
    update's tensors, ``kw`` its sizes) against its plain twin: the counts
    exactly, the sum of g*g within HEALTH_SUMSQ_RTOL, two calls
    bit-identical, nothing stored; then with a NaN planted in the last
    grad and a grad of 1e30 (its square overflows v') in the first, the
    counts again, non-zero and equal to the twin's, and both sums NaN;
    then timed beside the plain twin and its bound (read-only: each input
    read once, ``bytes_per`` an element)."""
    kernel, plain = getattr(cudaex, name), getattr(toptim_ops, name + "_plain")
    dev = bc.device
    accs = [torch.zeros(3, dtype=torch.float64, device=dev) for _ in range(3)]
    sample = args[0][-1].clone()
    kernel(*args, bc, accs[0], **kw, **hyper)
    kernel(*args, bc, accs[1], **kw, **hyper)
    plain(*args, bc, accs[2], **kw, **hyper)
    torch.cuda.synchronize()
    got, want = accs[0].tolist(), accs[2].tolist()
    require(torch.equal(accs[0], accs[1]), f"{name}: two calls differ: {got}, {accs[1].tolist()}")
    require(got[0] == want[0] and got[2] == want[2]
            and abs(got[1] - want[1]) <= HEALTH_SUMSQ_RTOL * want[1],
            f"{name}: {got} against the plain twin's {want}")
    require(torch.equal(args[0][-1], sample), f"{name}: the health pass stored a parameter")
    err = max(abs(a - b) for a, b in zip(got, want))
    first, last = args[1][0].view(-1), args[1][-1].view(-1)
    kept = (first[0].clone(), last[-1].clone())
    first[0], last[-1] = 1e30, float("nan")
    planted = [torch.zeros(3, dtype=torch.float64, device=dev) for _ in range(2)]
    kernel(*args, bc, planted[0], **kw, **hyper)
    plain(*args, bc, planted[1], **kw, **hyper)
    first[0], last[-1] = kept
    pg, pw = planted[0].tolist(), planted[1].tolist()
    require(pg[0] == pw[0] == 1 and pg[2] == pw[2] >= 2 and math.isnan(pg[1])
            and math.isnan(pw[1]), f"{name}, planted NaN and 1e30 grads: {pg} against the "
                                   f"plain twin's {pw}")
    log(f"  {name}: {n} parameters, (non-finite g, sum g*g, non-finite state) {got}, plain "
        f"{want}; planted {pg}, plain {pw}")
    acc = accs[0]
    row = timed_row(torch, cudaex, name, f"{n} bf16", err,
                    lambda: kernel(*args, bc, acc, **kw, **hyper),
                    lambda: plain(*args, bc, accs[2], **kw, **hyper),
                    None, n * bytes_per, 20.0 * n, F32_FLOPS, 10, 2)
    row["library_note"] = HEALTH_LIBRARY_NOTE
    return row


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
    # the health pass reads bf16 p, g and m, f32 v: 10 bytes an element
    health = health_row(torch, cudaex, toptim_ops, "fused_adamw_slab_health", (ps, gs, m, v),
                        {"sizes": sizes}, bc, hyper, n, 10)
    del ps, gs, m, v
    gc.collect()
    torch.cuda.empty_cache()
    return {"fused_adamw_slab": [row], "fused_adamw_slab_health": [health]}


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
    for n in (M_PREFILL, S_DECODE, JIT_B * JIT_T):
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

def whole_program_stats(jf) -> dict:
    """A jit function's CUDA-graph counters (``CompileStats``)."""
    import thunder_tpu_torch as ptt

    st = ptt.compile_stats(jf)
    return {"entry": st.last_whole_program, "captures": st.whole_program_captures,
            "recaptures": st.whole_program_recaptures, "replays": st.whole_program_replays,
            "copied_bytes": st.whole_program_copied_bytes}


def warm_engine(torch, eng) -> float:
    """Compile and capture an engine's traced steps before a measured run:
    each prefill chunk shape of its ladder and the decode step, each called
    twice (a cached entry's first call runs per call, its second is
    captured), reading and writing only the scratch page 0, which no
    request reads. Returns the seconds it took."""
    t0 = time.perf_counter()
    g, S, dev = eng.geom, eng.max_slots, eng.device
    npg = g.pages_per_request

    def zeros(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    # each call's step inputs made anew, as the engine makes them
    for C in eng.chunker.buckets:
        for _ in range(2):
            eng.runner.prefill(eng.params, zeros(1, C), zeros(1, npg, dtype=torch.int32),
                               torch.full((1,), C, dtype=torch.int32, device=dev),
                               zeros(C // g.page_size), eng.cache.pools)
    for _ in range(2):
        eng.runner.decode(eng.params, zeros(S, 1), zeros(S, npg, dtype=torch.int32),
                          torch.ones(S, dtype=torch.int32, device=dev), zeros(S),
                          eng.cache.pools, zeros(S, dtype=torch.float32), zeros(S),
                          torch.ones(S, device=dev), zeros(S, 2))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def counting(eng, cudaex, attr: str, counts: list) -> None:
    """Wrap ``eng.runner.<attr>`` (``decode`` or ``prefill``) so each call
    appends the hand-written kernels' launches it made to ``counts``, its
    region launches held to the regions of the program it ran."""
    fn = getattr(eng.runner, attr)

    def counted(*args, **kwargs):
        before = cudaex.launch_counts()
        out = fn(*args, **kwargs)
        after = cudaex.launch_counts()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        regions = (decode_regions(eng) if attr == "decode" else program_regions(
            eng.runner.prefill_jit.bind(*args, contained=False).entry))
        require(launches.get("region", 0) == regions,
                f"{attr}: launched {launches}, its program holds {regions} regions")
        counts.append(without_regions(launches))
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
    ``mlp_subblock``, per layer; the traced runner's planner takes it while
    ``cuda.decode_layer`` is routed off) on the card, against the same
    rung on the CPU and against the CPU's planned rung (``decode_layer_plain``):
    logits and pools (but the scratch page) within SUBBLOCK_STEP_TOL.
    Ragged lengths, a page-boundary crossing, a replay slot and an idle
    slot."""
    import contextlib

    from thunder_tpu_torch.optim import tree_map
    from thunder_tpu_torch.runtime import quarantine
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

    def step(device, subblocks: bool):
        run = PagedLlamaRunner(cfg, geom, block_fusion=True, device=torch.device(device))
        ps_ = tree_map(lambda x: x.to(device), params)
        pl_ = [{k: v.clone().to(device) for k, v in kv.items()} for kv in pools]
        rung = (quarantine.suppress(["cuda.decode_layer"]) if subblocks
                else contextlib.nullcontext())
        with rung:
            _, logits = run.decode(ps_, *(x.to(device) for x in inputs), pl_,
                                   *(x.to(device) for x in sampling))
        return (logits.cpu(), [{k: v.cpu() for k, v in kv.items()} for kv in pl_],
                program_regions(run._decode_bound.entry))

    cudaex.reset_launch_counts()
    card = step("cuda", True)
    counts = {k: v for k, v in cudaex.launch_counts().items() if v}
    expect = with_region({"attn_subblock": L, "mlp_subblock": L, "rms_norm": 1}, card[2])
    require(counts == expect, f"sub-block decode step launched {counts}, expected {expect}")
    errs = {}
    for name, ref in (("cpu subblocks", step("cpu", True)),
                      ("cpu decode_layer_plain", step("cpu", False))):
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
    # depth cut to SERVE_LAYERS (the script's time; phase 22 serves this
    # cell at all 32 layers): widths as published
    cfg = serve_config(tllama)
    eng = ServingEngine(params, cfg, max_slots=8, page_size=16, max_context=2048,
                        block_fusion=block_fusion)
    L = cfg.n_layers

    # warm-up (cuBLAS handles, allocator; the traced steps compiled and
    # captured), not part of the measured run
    warm_s = warm_engine(torch, eng)
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
    expect = with_region({"decode_layer": L, "rms_norm": 1} if block_fusion else
                         {"paged_decode_attention": L, "linear_act": L,
                          "rms_norm_residual": 2 * L, "rms_norm": 1}, decode_regions(eng))
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
        if c != expect or without_regions(d) != expect_designs:
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
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "warmup_s": warm_s,
        "decode_step_ms_median": float(np.median(step_ms)),
        "decode_graph": whole_program_stats(eng.runner.decode_jit),
        "prefill_graph": whole_program_stats(eng.runner.prefill_jit),
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
# phase 22: the traced engine (serving on jit) at phase 5's cell
# ---------------------------------------------------------------------------

def serve_jit_expect(cudaex, cfg, L: int, planned: bool):
    """The launches and designs of one decode step of the traced engine at
    a rung (8 slots)."""
    dt, Dm = cfg.dtype, cfg.dim
    rn = cudaex.rms_norm_design(dt, Dm)
    if planned:
        dd = cudaex.decode_design(dt, FLEET_SLOTS, Dm, cfg.n_heads, cfg.kv_heads, cfg.head_dim)
        return {"decode_layer": L, "rms_norm": 1}, {"decode_layer": {dd: L}, "rms_norm": {rn: 1}}
    return ({"linear_act": L, "paged_decode_attention": L, "rms_norm_residual": 2 * L,
             "rms_norm": 1},
            {"linear_act": {cudaex.linear_act_design(dt, FLEET_SLOTS): L},
             "paged_decode_attention": {"split": L},
             "rms_norm_residual": {cudaex.rms_norm_residual_design(dt, Dm): 2 * L},
             "rms_norm": {rn: 1}})


def serve_jit_run(np, torch, tllama, ServingEngine, SamplingParams, cudaex, pretrain, params,
                  block_fusion, replay: bool, keep: bool = False) -> dict:
    """One engine at ``block_fusion`` with ``whole_program_jit=replay``: its
    steps warmed (``warm_engine``: every prefill chunk shape and the decode
    step compiled, and with the replay captured), then the cell's 8
    requests (32 new tokens, 2 sampled), every
    decode step's launches and designs held to its rung's, its host ms
    (until the step's launches are issued), its wall ms (to a device sync)
    and the first-token logits of each request's replay step; then
    SERVE_JIT_PROFILE decode steps traced (busy ms, idle share)."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import claimed_kernels

    cfg = tllama.CONFIGS["llama3-8b"]
    L = cfg.n_layers
    eng = ServingEngine(params, cfg, max_slots=FLEET_SLOTS, page_size=PS,
                        max_context=FLEET_CONTEXT, block_fusion=block_fusion,
                        whole_program_jit=replay)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_JIT_LENGTHS]
    warm_s = warm_engine(torch, eng)
    steps, first = [], {}
    decode = eng.runner.decode

    def recorded(*args):
        rows = [(i, r.request_id) for i, r in enumerate(eng.slots)
                if r is not None and r.state == "decode" and r._replay]
        before, designs = cudaex.launch_counts(), cudaex.design_counts()
        t = time.perf_counter()
        toks, logits = decode(*args)
        host = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        after = cudaex.launch_counts()
        steps.append({"launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
                      "designs": design_delta(designs, cudaex.design_counts()),
                      "host_ms": host, "ms": wall,
                      "rows": sum(r is not None and r.state == "decode" for r in eng.slots)})
        for i, rid in rows:
            first[rid] = logits[i].float().cpu()
        return toks, logits

    eng.runner.decode = recorded
    sampled = SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=1234)
    torch.cuda.synchronize()
    cudaex.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, SERVE_JIT_NEW, sampling=sampled if i in (2, 5) else None)
            for i, p in enumerate(prompts)]
    while any(r.state != "decode" or r._replay for r in reqs):
        eng.step()                       # every prompt resident, every first token sampled
    eng.runner.decode = decode           # the profile window runs unrecorded
    prof = pretrain.profile_steps(eng.step, SERVE_JIT_PROFILE)
    eng.runner.decode = recorded
    eng.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = {k: n for k, n in cudaex.launch_counts().items() if n}
    eng.assert_quiescent()
    for r in reqs:
        out = r.output()
        require(r.done and len(out) == SERVE_JIT_NEW and 0 <= out.min()
                and out.max() < cfg.vocab_size, f"request {r.request_id}: {r.state}, {len(out)}")
    trc = eng.runner._decode_bound.entry.traces[-1]
    claims = claimed_kernels(trc)
    planned = "decode_layer" in claims
    # the unset verdict may plan one half of a layer alone (the sub-block
    # rung's attn_subblock or mlp_subblock beside the other half per op):
    # its launches are held to its trace's claims, its designs unheld
    rung = ("planned" if planned else "sub-block"
            if {"attn_subblock", "mlp_subblock"} & set(claims) else "per-op")
    want, want_d = serve_jit_expect(cudaex, cfg, L, planned)
    if rung == "sub-block":
        want, want_d = without_regions(claims), None
    want = with_region(want, claims.get("region", 0))
    for i, st in enumerate(steps):
        require(st["launches"] == want
                and (want_d is None or without_regions(st["designs"]) == want_d),
                f"serve-jit {block_fusion} replay={replay}: decode step {i} launched "
                f"{st['launches']} by design {st['designs']}, expected {want} by {want_d}")
    if replay and not planned and block_fusion is False:
        from thunder_tpu_torch.testing import regions_of

        HELD_REGIONS["serve-jit"] = [r for jf in (eng.runner.decode_jit, eng.runner.prefill_jit)
                                     for entry in jf._cache.values()
                                     for r in regions_of(entry.traces[-1])]
    stats = ptt.compile_stats(eng.runner.decode_jit)
    require(stats.last_whole_program == ("graph" if replay else
                                         "per-call (whole_program_jit=False)"),
            f"serve-jit: the decode step ran {stats.last_whole_program}")
    require(not replay or stats.whole_program_replays >= len(steps),
            f"serve-jit: {stats.whole_program_replays} replays for {len(steps)} steps")
    decode_only = [st for st in steps if st["rows"] == FLEET_SLOTS]
    decode_tokens = sum(st["rows"] for st in steps)
    out = {"block_fusion": block_fusion, "replay": replay, "rung": rung,
           "tokens": [r.output().tolist() for r in reqs],
           "first_logits": [first[r.request_id] for r in reqs],
           "decode_steps": len(steps), "decode_tokens": decode_tokens,
           "decode_tok_per_s": decode_tokens / (sum(st["ms"] for st in steps) / 1e3),
           "decode_step_ms_median": float(np.median([st["ms"] for st in decode_only])),
           "decode_step_host_ms_median": float(np.median([st["host_ms"]
                                                          for st in decode_only])),
           "ttft_ms_mean": 1e3 * sum(r.ttft_s for r in reqs) / len(reqs),
           "wall_s": wall_s, "warmup_s": warm_s, "launches": counts,
           "launches_per_decode_step": want, "designs_per_decode_step": want_d,
           "decode_profile_step_ms": prof["profile_step_ms"],
           "decode_device_busy_ms": prof["device_busy_ms_per_step"],
           "decode_device_idle_share": prof["device_idle_share"],
           "decode_ms_by_family": prof["ms_per_step_by_family"],
           "captures": stats.whole_program_captures,
           "recaptures": stats.whole_program_recaptures,
           "replays": stats.whole_program_replays,
           "copied_bytes": stats.whole_program_copied_bytes,
           "decode_compile_stages_ms": dict(stats.last_pass_times),
           "decisions": decision_summary(ptt, eng.runner.decode_jit)}
    if keep:   # the replaying engines take C.6's readings after, unrecorded
        eng.runner.decode = decode
        out["engine"] = eng
        return out
    eng.cache.consume_pools()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_jit_full_width(np, torch, tllama, ServingEngine, SamplingParams, cudaex,
                         pretrain) -> dict:
    """Phase 22: the traced engine at phase 5's cell, each rung (per-op,
    planned, unset) with the whole-program replay and without: identical
    tokens with and without it, every replay step's first-token logits
    within GENERATE_LOGITS_TOL of ``llama.generate``'s first step for the
    same prompt, and the unset verdict held to the rung measured faster."""
    from thunder_tpu_torch.testing import row_rel_err

    t_phase = time.perf_counter()
    cfg = tllama.CONFIGS["llama3-8b"]
    params = tllama.init_params(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n) for n in SERVE_JIT_LENGTHS]
    ref = []
    with torch.no_grad():
        for p in prompts:
            cache = tllama.init_kv_cache(cfg, 1, len(p), device="cuda")
            logits, _ = tllama.forward_step(params, torch.from_numpy(p)[None].cuda(), cache, 0,
                                            cfg, last_idx=len(p) - 1)
            ref.append(logits[0, 0].float().cpu())
            del cache, logits
    ref = torch.stack(ref)
    out = {"model": cfg.name, "layers": cfg.n_layers, "dtype": "bfloat16",
           "max_slots": FLEET_SLOTS, "page_size": PS, "max_context": FLEET_CONTEXT,
           "prompt_lengths": SERVE_JIT_LENGTHS, "new_tokens": SERVE_JIT_NEW,
           "sampled_requests": 2}
    engines = {}
    for name, bf in SERVE_JIT_RUNGS:
        runs = {}
        for replay in (True, False):
            r = serve_jit_run(np, torch, tllama, ServingEngine, SamplingParams, cudaex, pretrain,
                              params, bf, replay, keep=replay)
            if replay:
                engines[name] = r.pop("engine")
            err = row_rel_err(torch.stack(r.pop("first_logits")), ref)
            require(err <= GENERATE_LOGITS_TOL,
                    f"serve-jit {name} replay={replay}: first-step logits vs generate's: {err}")
            r["first_logits_row_rel_err_vs_generate"] = err
            runs["replay" if replay else "per_call"] = r
            log(f"phase 22 {name}, whole_program_jit={replay}: "
                f"{json.dumps({k: v for k, v in r.items() if k != 'tokens'})}")
        require(runs["replay"]["tokens"] == runs["per_call"]["tokens"],
                f"serve-jit {name}: tokens differ with and without the replay")
        require(runs["replay"]["launches"] == runs["per_call"]["launches"],
                f"serve-jit {name}: launches differ with and without the replay: "
                f"{runs['replay']['launches']} against {runs['per_call']['launches']}")
        for r in runs.values():
            r.pop("tokens")
        out[name] = runs
    out["readings"] = serve_jit_readings(np, torch, tllama, engines)
    out["verdict"] = serve_jit_verdict(out["readings"], out["unset"]["replay"]["rung"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def decode_reading(np, torch, eng, cfg) -> float:
    """One replayed run of phase 22's cell on a warmed engine (greedy): the
    median ms, to a device sync, of its decode steps with every slot
    decoding."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_JIT_LENGTHS]
    decode, ms = eng.runner.decode, []

    def timed(*args):
        rows = sum(r is not None and r.state == "decode" for r in eng.slots)
        t = time.perf_counter()
        out = decode(*args)
        torch.cuda.synchronize()
        if rows == FLEET_SLOTS:
            ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng.runner.decode = timed
    for p in prompts:
        eng.submit(p, SERVE_JIT_NEW)
    eng.drain()
    eng.runner.decode = decode
    eng.completed.clear()
    return float(np.median(ms))


def serve_jit_readings(np, torch, tllama, engines: dict) -> dict:
    """ROADMAP C.6's readings at phase 22's cell on ``engines``, phase 22's
    replaying engines (per-op, planned, unset), each warmed:
    SERVE_JIT_ROUNDS rounds of (per-op, planned, unset, unset, planned,
    per-op) runs of the cell, each run's median decode step ms
    (``decode_reading``). Returns every reading by rung, and each engine's
    regions a decode step; the engines are freed."""
    cfg = tllama.CONFIGS["llama3-8b"]
    readings = {r: [] for r in engines}
    for _ in range(SERVE_JIT_ROUNDS):
        for rung in ("per-op", "planned", "unset", "unset", "planned", "per-op"):
            readings[rung].append(decode_reading(np, torch, engines[rung], cfg))
    readings["regions a step"] = {r: decode_regions(e) for r, e in engines.items()}
    for eng in engines.values():
        eng.cache.consume_pools()
    engines.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return readings


def serve_jit_verdict(readings: dict, unset: str) -> dict:
    """The unset verdict's rung (``unset``: per-op, planned, or the sub-block
    rung's halves) held to the readings: its median replayed decode step ms
    may exceed the faster of the per-op and planned rungs' medians by more
    than PLANNED_JIT_GAP only where that difference is within the
    readings' own spread (the largest rung's max - min)."""
    rungs = ("per-op", "planned", "unset")
    med = {r: float(statistics.median(readings[r])) for r in rungs}
    spread = max(max(readings[r]) - min(readings[r]) for r in rungs)
    faster = min(("per-op", "planned"), key=med.get)
    diff = med["unset"] - med[faster]
    gap = diff / med[faster]
    held = gap > PLANNED_JIT_GAP and diff > spread
    require(not held,
            f"serve-jit: the unset verdict's {unset} rung took {med['unset']:.3f} ms a decode "
            f"step, {gap:.1%} over the {faster} rung's (medians {med}, spread {spread:.3f} ms)")
    return {"unset_rung": unset, "decode_step_ms_median": med, "gap_over_faster": gap,
            "spread_ms": spread, "faster": faster, "held": held}


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
    kw = dict(batch=2, seq=64, steps=3, lr=TRAIN_LR, seed=0, block_fusion=block_fusion,
              eager=True)
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
                       block_fusion=block_fusion, eager=True)
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
    """Three float32 tiny-gqa steps of the bench's compiled step (4 layers,
    B=2, T=64, fused loss, remat, slab state with bf16 m) on the card (one
    CUDA graph) and on the CPU from the same weights: losses and parameters
    to phase 6's tolerances, the slabs to the training test's (the bf16 m
    slab within two bf16 rounding steps besides), every step's launches the
    trace's claims."""
    from thunder_tpu_torch.optim import tree_leaves, tree_map
    from thunder_tpu_torch.testing import ulp_distance

    cfg = tllama.CONFIGS["tiny-gqa"]
    cpu = tllama.init_params(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    kw = dict(layers=cfg.n_layers, batch=2, seq=64, steps=3, remat=True, slab_state=True)
    opt = bench.make_opt("bf16", slab_state=True)
    st_card, st_cpu = opt.init(card), opt.init(cpu)
    a = bench.run("tiny-gqa", device="cuda", params=card, state=st_card, sentinel=False,
                  baseline=False, **kw)
    b = bench.run("tiny-gqa", device="cpu", params=cpu, state=st_cpu, sentinel=False,
                  baseline=False, **kw)
    require(a["compiled"] and a["whole_program"] == "graph" and a["whole_program_captures"] == 1,
            f"bench card run: compiled {a['compiled']}, entry {a['whole_program']}, "
            f"{a['whole_program_captures']} capture(s)")
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
    expect = with_region(bench_launches(cfg.n_layers, remat=True, block_fusion=False),
                         a["regions"])
    for i, st in enumerate(a["per_step"]):
        require(st["launches"] == expect,
                f"tiny-gqa bench step {i} launched {st['launches']}, expected {expect}")
    return {"layers": cfg.n_layers, "losses_card": a["losses"], "losses_cpu": b["losses"],
            "max_param_diff": perr, "max_slab_diff": slab_err, "launches_per_step": expect,
            "logits_route": a["logits_route"], "whole_program": a["whole_program"]}


def bench_full_width(torch, cudaex, bench, remat: bool, block_fusion: bool):
    """llama2-7b-bench at BENCH_LAYERS layers, B=8, T=2048 through the
    bench entry point with slab state: the compiled step (one CUDA graph),
    a warm-up step and BENCH_STEPS timed steps, every one launching the
    trace's claims (``fused_adamw_slab`` through its jit claim once), every
    sdpa_fwd on the wgmma design, the losses finite and falling and each
    within JIT_TRAIN_LOSS_RTOL of the eager baseline arm's from the same
    weights; with ``remat`` also the guarded arm (``NumericsGuardTransform``:
    the slab health pass once a step, one graph). ``launches`` are the
    compiled arm's, ``sentinel_launches`` and ``baseline_launches`` the
    other arms'."""
    cudaex.reset_launch_counts()
    out = bench.run("llama2-7b-bench", layers=BENCH_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    steps=BENCH_STEPS, slab_state=True, remat=remat, block_fusion=block_fusion,
                    device="cuda", sentinel=remat)
    all_arms = cudaex.launch_counts()
    kernels = bench_launches(BENCH_LAYERS, remat, block_fusion)
    expect = with_region(kernels, out["regions"])
    for i, st in enumerate(out["per_step"]):
        require(st["launches"] == expect, f"bench step {i} launched {st['launches']}, expected "
                                          f"{expect}")
    require(out["whole_program"] == "graph" and out["whole_program_captures"] == 1,
            f"bench step entry: {out['whole_program']}, "
            f"{out['whole_program_captures']} capture(s)")
    losses = out["losses"]
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"bench losses not finite and falling: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, out["baseline_losses"])]
    require(max(rel) <= JIT_TRAIN_LOSS_RTOL,
            f"bench losses {losses} against the eager baseline's {out['baseline_losses']}")
    counts = out["launches"]
    require(all(counts.get(k) for k in expect),
            f"a kernel of the bench path never launched: {counts}")
    if remat:
        guarded = with_region(dict(kernels, fused_adamw_slab_health=1),
                              out["sentinel_regions"])
        for i, st in enumerate(out["sentinel_per_step"]):
            require(st["launches"] == guarded, f"guarded bench step {i} launched "
                                               f"{st['launches']}, expected {guarded}")
        require(out["sentinel_whole_program"] == "graph"
                and out["sentinel_whole_program_captures"] == 1,
                f"guarded bench step entry: {out['sentinel_whole_program']}, "
                f"{out['sentinel_whole_program_captures']} capture(s)")
        rel_g = [abs(a - b) / abs(b) for a, b in zip(out["sentinel_losses"], losses)]
        require(max(rel_g) <= JIT_TRAIN_LOSS_RTOL and out["sentinel_counts"]["skipped_steps"] == 0,
                f"guarded bench losses {out['sentinel_losses']} against {losses}")
    designs = cudaex.design_counts()   # over the three arms
    require_attention_wgmma("the bench path", designs, all_arms)
    require_residual_vector("the bench path", designs, all_arms)
    out.update(launches_per_step=expect, designs=designs, baseline_loss_rel_diff_max=max(rel))
    gc.collect()
    torch.cuda.empty_cache()
    return out


def log_train(what: str, t: dict) -> None:
    extra = ""
    if t.get("compiled"):
        extra = f"compiled ({t['whole_program']}, {t['compile_s']:.2f} s), "
    if "baseline_step_ms" in t:
        extra += (f"eager baseline {t['baseline_step_ms']:.1f} ms (vs_baseline "
                  f"{t['vs_baseline']:.4f}, peak {t['baseline_peak_memory_gb']:.2f} GB), ")
    log(f"{what}: step {t['step_ms']:.1f} ms, {t['tokens_per_s']:.0f} tokens/s, "
        f"{100 * t['share_of_989_tflops']:.1f}% of 989 TFLOP/s, peak "
        f"{t['peak_memory_gb']:.2f} GB, {extra}losses "
        f"{[round(x, 4) for x in t['losses']]}, launches per step "
        f"{json.dumps(t['launches_per_step'])}, launches by design over the run "
        f"{json.dumps(t['designs'])} ({t['card']})")


# ---------------------------------------------------------------------------
# phase 14: train from a token file, checkpoint and resume
# ---------------------------------------------------------------------------

def train_resume(np, torch, cudaex, pretrain, tllama) -> dict:
    """llama3-8b-bench at RESUME_LAYERS layers through ``pretrain.run`` (the
    compiled step, one CUDA graph a run) from a token file the phase
    writes: (a) 4 steps straight through; (b) 2
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
            require(run["whole_program"] == "graph" and run["whole_program_captures"] == 1,
                    f"{what}: entry {run['whole_program']}, "
                    f"{run['whole_program_captures']} capture(s)")
            expect = with_region(train_launches(RESUME_LAYERS, False), run["regions"])
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


# ---------------------------------------------------------------------------
# phase 15: the numerics guard and the kernel quarantine
# ---------------------------------------------------------------------------

def same_tensors(torch, a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def planted_health(torch, gated, params, grads, state, loss, where, what):
    """Plant a NaN in ``grads`` at ``where`` (a tensor and a flat index) and
    run ``gated`` (the compiled health pass and gated update,
    ``gated_update_step``) on the donated state: the word must count
    exactly one non-finite grad, and params, moments and step must not
    move. The grad is restored."""
    from thunder_tpu_torch.benchmarks.pretrain import _assign
    from thunder_tpu_torch.optim import tree_leaves

    t, i = where
    before = [x.clone() for x in tree_leaves(params) + tree_leaves(state)]
    keep = t.view(-1)[i].clone()
    t.view(-1)[i] = float("nan")
    new_p, new_s, word = gated(params, state, grads, loss)
    _assign(params, new_p)
    _assign(state, new_s)
    torch.cuda.synchronize()
    t.view(-1)[i] = keep
    h = word.tolist()
    require(h[0] == 1.0 and h[1] == 0.0, f"{what}: health word {h}, one NaN planted")
    require(same_tensors(torch, before, tree_leaves(params) + tree_leaves(state)),
            f"{what}: the gated update moved the state")
    return h


def gated_update_step(ptt, opt):
    """``AdamW.health`` then ``AdamW.update(health=)`` compiled, the params
    and state donated: each bucket's health pass and gated update through
    their jit claims. Returns ``(params, state, word)``."""
    def gated(params, state, grads, loss):
        word = opt.health(params, grads, state, loss)
        return (*opt.update(params, grads, state, health=word), word)

    return ptt.jit(gated, donate_argnums=(0, 1))


def grads_and_word_step(ptt, opt, cfg, loss_fn):
    """The compiled loss, its gradients and the health word of the update
    they would take, from one program (the guard's health composites)."""
    def fn(params, state, tokens, targets):
        value, grads = ptt.value_and_grad(lambda p: loss_fn(p, tokens, targets, cfg))(params)
        return grads, opt.health(params, grads, state, value)

    return ptt.jit(fn)


def eager_guard_steps(torch, cudaex, pretrain, NumericsGuard, opt, cfg, plain, guarded,
                      tokens, targets, expect, update, state_of) -> dict:
    """The eager guard on two bit-identical copies of the state: an
    unguarded eager step (``pretrain.train_step``) on ``plain``, a guarded
    one (``train_step(guard=NumericsGuard())``: ``AdamW.health``, then the
    gated ``AdamW.update(health=)``) on ``guarded``. The guarded step must
    launch ``expect`` (the eager per-op step's kernels) with ``update`` and
    its health pass once each, and leave the two copies bit-identical; a
    second guarded step with ``numerics:grads`` poison must be skipped and
    leave them so. Returns the launches and the sentinel's counts."""
    from thunder_tpu_torch.runtime import FaultPlan, FaultSpec, faults

    (pa, sa), (pb, sb) = plain, guarded
    guard = NumericsGuard()
    pretrain.train_step(pa, opt, sa, tokens, targets, cfg)
    cudaex.reset_launch_counts()
    loss = float(pretrain.train_step(pb, opt, sb, tokens, targets, cfg, guard=guard))
    launches = {k: n for k, n in cudaex.launch_counts().items() if n}
    expect = dict(expect)
    expect[update] = expect.pop("fused_adamw")
    expect[f"{update}_health"] = 1
    require(launches == expect, f"eager guarded step launched {launches}, expected {expect}")
    require(same_tensors(torch, state_of(pa, sa), state_of(pb, sb)),
            "the eager guarded step is not bit-identical to the unguarded eager step")
    with faults.active(FaultPlan([FaultSpec("numerics:grads",
                                            at_steps={guard.sentinel.steps + 1})])):
        poisoned = float(pretrain.train_step(pb, opt, sb, tokens, targets, cfg, guard=guard))
    sent = guard.sentinel
    require(sent.steps == 2 and sent.nonfinite_steps == sent.skipped_steps == 1,
            f"eager poisoned step: steps {sent.steps}, nonfinite {sent.nonfinite_steps}, "
            f"skipped {sent.skipped_steps}")
    require(same_tensors(torch, state_of(pa, sa), state_of(pb, sb)),
            "the eager poisoned step moved the state")
    return {"loss": loss, "poisoned_step_loss": poisoned, "launches": launches,
            "launches_per_step": expect, "poisoned_health_word": list(guard.last_health),
            "sentinel": {"steps": sent.steps, "nonfinite": sent.nonfinite_steps,
                         "skipped": sent.skipped_steps}}


def planted_tails(torch, cudaex, toptim_ops, slab: bool) -> dict:
    """A bucket of odd sizes (7, 13, 4099, 2^16 + 1 bf16 elements, f32
    moments): a NaN in the scalar tail of the 7-element member and one in
    the last element of the bucket (its last chunk) are each counted once by
    the health pass, and each stops the gated update."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    sizes = [7, 13, 4099, 65537]
    ps = [torch.randn(n, generator=gen, device=dev).to(torch.bfloat16) for n in sizes]
    gs = [torch.randn(n, generator=gen, device=dev).to(torch.bfloat16) for n in sizes]
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    bc = torch.tensor([0.5, 0.02], dtype=torch.float32, device=dev)
    if slab:
        rows, _ = toptim_ops.slab_geometry(sum(sizes))
        moments = [torch.zeros(rows, 128, dtype=torch.float32, device=dev) for _ in range(2)]
        kw, health, update = {"sizes": sizes}, cudaex.fused_adamw_slab_health, cudaex.fused_adamw_slab
    else:
        moments = [[torch.zeros(n, dtype=torch.float32, device=dev) for n in sizes]
                   for _ in range(2)]
        kw, health, update = {}, cudaex.fused_adamw_health, cudaex.fused_adamw
    out = {}
    for where, (t, i) in (("scalar tail", (gs[0], 6)), ("last chunk", (gs[-1], 65536))):
        t[i] = float("nan")
        acc = torch.zeros(3, dtype=torch.float64, device=dev)
        health(ps, gs, *moments, bc, acc, **kw, **hyper)
        word = torch.stack([acc[0].float(), torch.zeros((), device=dev), acc[2].float(),
                            torch.sqrt(acc[1]).float(), torch.ones((), device=dev)])
        before = [x.clone() for x in ps] + [x.clone() for m in moments
                                            for x in (m if isinstance(m, list) else [m])]
        update(ps, gs, *moments, bc, **kw, **hyper, health=word)
        torch.cuda.synchronize()
        after = list(ps) + [x for m in moments for x in (m if isinstance(m, list) else [m])]
        h = word.tolist()
        require(h[0] == 1.0, f"{'slab' if slab else 'per-step'} {where}: health word {h}")
        require(same_tensors(torch, before, after),
                f"{'slab' if slab else 'per-step'} {where}: the gated update moved the state")
        t[i] = 0.0
        out[where] = h[:3]
    return out


def guarded_train(np, torch, cudaex, pretrain, bench, tllama, toptim_ops, slab: bool) -> dict:
    """(a) llama3-8b-bench at GUARD_LAYERS layers, per-op rung, AdamW(lr=1e-4)
    with f32 moments, or (b), with ``slab``, at GUARD_SLAB_LAYERS layers
    with the bench's slab-persistent AdamW (bf16 m, f32 v), through the
    compiled step (``pretrain.run``, one CUDA graph): GUARD_STEPS steps
    compiled with ``NumericsGuardTransform`` bit-identical to as many
    unguarded compiled steps from the same weights (params, moments, step),
    every guarded step launching the trace's claims, the health pass and
    the gated update once each; a ``numerics:grads``-poisoned step through
    the guarded compiled step leaves the state bit-identical with
    nonfinite_steps == skipped_steps == 1; the eager guard
    (``train_step(guard=NumericsGuard())``) on that state: a step
    bit-identical to an unguarded eager step from the same state, its
    health pass launched once, then a poisoned eager step that leaves the
    state as it was; the health word's grad norm
    (the traced health pass of one program that returns the grads too)
    against a float64 norm of those grads; NaNs planted in the last grad
    element (through the compiled gated update) and, on an odd bucket, in a
    scalar tail and the last chunk, each caught and each stopping the
    update; the health pass timed beside its bound, the guarded step beside
    the unguarded one, both peak memories."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.benchmarks.pretrain import _assign
    from thunder_tpu_torch.optim import AdamW, tree_leaves, tree_map
    from thunder_tpu_torch.runtime import FaultPlan, FaultSpec, faults
    from thunder_tpu_torch.transforms import NumericsGuard, NumericsGuardTransform

    cfg = tllama.CONFIGS["llama3-8b-bench"]
    layers = GUARD_SLAB_LAYERS if slab else GUARD_LAYERS
    opt = bench.make_opt("bf16", slab_state=True) if slab else AdamW(lr=1e-4)
    pa = tllama.init_params(cfg, seed=0, device="cuda", n_layers=layers)
    pb = tree_map(lambda t: t.clone(), pa)
    sa, sb = opt.init(pa), opt.init(pb)
    kw = dict(layers=layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=GUARD_STEPS - 1,
              lr=opt.lr, seed=0, device="cuda", opt=opt, block_fusion=False)
    plain = pretrain.run("llama3-8b-bench", params=pa, state=sa, **kw)
    guard = NumericsGuardTransform()
    cudaex.reset_launch_counts()
    guarded = pretrain.run("llama3-8b-bench", params=pb, state=sb, guard=guard, **kw)
    counts = {k: n for k, n in cudaex.launch_counts().items() if n}
    expect = jit_train_launches(layers, False)
    update = "fused_adamw_slab" if slab else "fused_adamw"
    if slab:
        expect[update] = expect.pop("fused_adamw")
    expect[f"{update}_health"] = 1
    expect = with_region(expect, guarded["regions"])
    for i, st in enumerate(guarded["per_step"]):
        require(st["launches"] == expect, f"guarded step {i} launched {st['launches']}, "
                                          f"expected {expect}")
    for run in (plain, guarded):
        require(run["whole_program"] == "graph" and run["whole_program_captures"] == 1,
                f"guarded train entry: {run['whole_program']}, "
                f"{run['whole_program_captures']} capture(s)")
    require(guarded["losses"] == plain["losses"],
            f"guarded losses {guarded['losses']} != unguarded {plain['losses']}")
    require(guard.gated_buckets == 1, f"{guard.gated_buckets} gated buckets")

    def state_of(p, st):
        return tree_leaves(p) + tree_leaves(st)

    require(same_tensors(torch, state_of(pa, sa), state_of(pb, sb)),
            "guarded steps are not bit-identical to unguarded ones")
    require(float(sb["step"]) == GUARD_STEPS, f"step counter {float(sb['step'])}")

    tok, tgt = (torch.from_numpy(a).cuda() for a in
                pretrain.synthetic_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 0))
    step = pretrain.jit_train_step(cfg, opt, transforms=[guard], block_fusion=False)
    with faults.active(FaultPlan([FaultSpec("numerics:grads",
                                            at_steps={guard.sentinel.steps + 1})])):
        poisoned, new_p, new_s = step(pb, sb, tok, tgt)
    poisoned = float(poisoned)
    _assign(pb, new_p)
    _assign(sb, new_s)
    sent = guard.sentinel
    require(sent.nonfinite_steps == sent.skipped_steps == 1,
            f"poisoned step: nonfinite {sent.nonfinite_steps}, skipped {sent.skipped_steps}")
    require(same_tensors(torch, state_of(pa, sa), state_of(pb, sb)),
            "the poisoned step moved the state")
    v = sent.last_verdict
    poisoned_word = [v.nonfinite_grads, v.nonfinite_loss, v.nonfinite_state, v.grad_norm, v.loss]
    del step, new_p, new_s
    gc.collect()
    torch.cuda.empty_cache()
    eager = eager_guard_steps(torch, cudaex, pretrain, NumericsGuard, opt, cfg, (pa, sa),
                              (pb, sb), tok, tgt, train_launches(layers, False), update,
                              state_of)

    grads, word = grads_and_word_step(ptt, opt, cfg, tllama.loss_fn)(pb, sb, tok, tgt)
    word = word.tolist()
    norm64 = math.sqrt(sum(float(g.double().square().sum()) for g in tree_leaves(grads)))
    norm_rel = abs(word[3] - norm64) / norm64
    require(word[:3] == [0.0, 0.0, 0.0] and norm_rel <= HEALTH_NORM_RTOL,
            f"health word {word} against the float64 grad norm {norm64}")
    last = tree_leaves(grads)[-1]
    loss = torch.tensor(word[4], device="cuda")
    gated = gated_update_step(ptt, opt)
    planted = {"last grad element": planted_health(
        torch, gated, pb, grads, sb, loss, (last, last.numel() - 1),
        "planted NaN, last grad element")}
    planted.update(planted_tails(torch, cudaex, toptim_ops, slab))

    # the health pass alone at this bucket, on these grads
    kind, args, bkw = opt._buckets(pb, grads, sb)[0]
    bc = opt._bias_corrections(sb, commit=False)
    acc = torch.zeros(3, dtype=torch.float64, device="cuda")
    name = "fused_adamw_slab_health" if slab else "fused_adamw_health"
    fn = getattr(cudaex, name)
    n = sum(p.numel() for p in args[0])
    health_ms = time_ms(torch, lambda: fn(*args, bc, acc, **bkw, **opt._hyper), iters=10)
    health_bound, _ = bound(n * (10 if slab else 12), 20.0 * n, F32_FLOPS)
    out = {"model": cfg.name, "layers": layers, "slab_state": slab, "parameters": n,
           "steps": GUARD_STEPS, "losses": guarded["losses"], "bit_identical": True,
           "poisoned_step_loss": poisoned, "poisoned_health_word": poisoned_word,
           "sentinel": {"steps": sent.steps, "nonfinite": sent.nonfinite_steps,
                        "skipped": sent.skipped_steps},
           "health_word": word, "grad_norm_float64": norm64, "grad_norm_rel_err": norm_rel,
           "planted": planted, "eager_guard": eager,
           "health_pass_ms": health_ms, "health_bound_ms": health_bound,
           "step_ms_unguarded": plain["step_ms"], "step_ms_guarded": guarded["step_ms"],
           "guard_overhead_pct": (guarded["step_ms"] - plain["step_ms"]) / plain["step_ms"] * 100,
           "peak_memory_gb_unguarded": plain["peak_memory_gb"],
           "peak_memory_gb_guarded": guarded["peak_memory_gb"],
           "whole_program_copied_bytes_guarded": guarded["whole_program_copied_bytes"],
           "compile_s": [plain["compile_s"], guarded["compile_s"]],
           "launches": counts, "launches_per_step": expect, "card": guarded["card"]}
    del pa, pb, sa, sb, grads, args, gated
    gc.collect()
    torch.cuda.empty_cache()
    return out


def record_decode(eng, cudaex, torch, log_steps: list) -> None:
    """Wrap ``eng.runner.decode``: each call appends its launches, its
    logits and whether it raised; the call after a raising one (the
    replay) also keeps its arguments and a copy of the pools it started
    from."""
    decode = eng.runner.decode

    def recorded(params, tokens, bt, lengths, write_pos, pools, *sampling):
        replay = bool(log_steps) and log_steps[-1]["raised"]
        entry = {"raised": True, "replay": replay}
        if replay:
            entry["inputs"] = (tokens.clone(), bt.clone(), lengths.clone(), write_pos.clone(),
                               tuple(x.clone() for x in sampling))
            entry["pools"] = [{k: v.clone() for k, v in kv.items()} for kv in pools]
        log_steps.append(entry)
        before = cudaex.launch_counts()
        out = decode(params, tokens, bt, lengths, write_pos, pools, *sampling)
        after = cudaex.launch_counts()
        entry.update(raised=False, logits=out[1].detach().clone(), tokens=out[0].clone(),
                     launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
                     regions=decode_regions(eng))
        return out

    eng.runner.decode = recorded


def quarantine_stages(np, eng, prompts, plan, faults, quarantine):
    """Serve ``prompts`` in stages, each drained: (1) under ``plan`` (the
    decode_layer fault), (2) with attn_subblock and mlp_subblock
    quarantined (the per-op kernel rung). Then (3) quarantine
    rms_norm_residual too and submit the third set: a leaf kernel has no
    kernel rung below it, so on the card the drain must raise the fatal
    KernelExecutionError naming it; the CPU runs its plain version, as it
    always does there, and the stage drains. Returns the requests of the
    stages that drained and the rebinds before stage 3."""
    from thunder_tpu_torch.runtime import retry

    stages = []
    with faults.active(plan):
        stages.append([eng.submit(p, 12) for p in prompts[0]])
        eng.drain()
    for c in ("cuda.attn_subblock", "cuda.mlp_subblock"):
        quarantine.get_quarantine().add(c, reason="phase 15", phase="runtime")
    stages.append([eng.submit(p, 12) for p in prompts[1]])
    eng.drain()
    eng.assert_quiescent()
    rebinds = eng.decode_rebinds
    quarantine.get_quarantine().add("cuda.rms_norm_residual", reason="phase 15", phase="runtime")
    reqs = [eng.submit(p, 12) for p in prompts[2]]
    if eng.device.type == "cpu":
        eng.drain()
        return stages + [reqs], rebinds
    try:
        eng.drain()
    except faults.KernelExecutionError as err:
        require(err.claim_id == "cuda.rms_norm_residual" and err.phase == faults.QUARANTINED
                and retry.classify(err) == retry.FATAL, f"stage 3 raised {err!r}")
    else:
        require(False, "a quarantined rms_norm_residual was routed on the card without raising")
    return stages, rebinds


def fault_plan(FaultPlan, FaultSpec, L: int):
    """``kernel:cuda.decode_layer`` on the first layer of decode step
    FAULT_DECODE_STEP (the guard counts its calls: L a decode step)."""
    return FaultPlan([FaultSpec("kernel:cuda.decode_layer",
                                every_n=(FAULT_DECODE_STEP - 1) * L + 1, max_fires=1)])


def serve_quarantine(np, torch, tllama, ServingEngine, cudaex, tnn) -> dict:
    """(d) llama3-8b at full width, QUARANTINE_LAYERS layers, planned rung,
    bf16: the decode_layer fault on decode step FAULT_DECODE_STEP is
    contained by one rebind onto attn_subblock + mlp_subblock (decode_layer
    launches frozen), the replayed step's logits equal a fresh sub-block
    step's on the same inputs and pools and match the plain sub-block chain
    row by row; then the per-op kernel rung with the sub-blocks
    quarantined, every request of both stages done; then rms_norm_residual
    quarantined, whose router raises on the card (quarantine_stages)."""
    from thunder_tpu_torch.runtime import FaultPlan, FaultSpec, faults, quarantine
    from thunder_tpu_torch.serving.runner import PagedLlamaRunner
    from thunder_tpu_torch.testing import decode_step, row_rel_err

    cfg = tllama.CONFIGS["llama3-8b"]
    L = QUARANTINE_LAYERS
    quarantine.reset()
    params = tllama.init_params(cfg, seed=0, device="cuda", n_layers=L)
    eng = ServingEngine(params, cfg, max_slots=8, page_size=16, max_context=2048,
                        block_fusion=True)
    steps: list = []
    record_decode(eng, cudaex, torch, steps)
    rng = np.random.RandomState(5)
    prompts = [[rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
               for lens in ((17, 150, 480, 1000), (64, 301), (33, 640))]
    cudaex.reset_launch_counts()
    t0 = time.perf_counter()
    stages, rebinds = quarantine_stages(np, eng, prompts, fault_plan(FaultPlan, FaultSpec, L),
                                        faults, quarantine)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = cudaex.launch_counts()
    for reqs in stages:
        for r in reqs:
            require(r.done and len(r.output()) == 12, f"request {r.request_id} state {r.state}")
    raised = [i for i, st in enumerate(steps) if st["raised"]]
    require(len(raised) == 1, f"decode calls that raised: {raised}")
    i = raised[0]
    require(rebinds == 2, f"{rebinds} rebinds, expected 2 (one a stage)")
    require(quarantine.is_quarantined("cuda.decode_layer"), "decode_layer not quarantined")
    sub = {"attn_subblock": L, "mlp_subblock": L, "rms_norm": 1}
    chain = {"rms_norm": 1, "paged_decode_attention": L, "rms_norm_residual": 2 * L,
             "linear_act": L}
    first = {"decode_layer": L, "rms_norm": 1}
    ran = [st for st in steps if not st["raised"]]
    require(all(st["launches"].get("region", 0) == st["regions"] for st in ran),
            "a decode step's region launches differ from its program's regions")
    kern = [without_regions(st["launches"]) if not st["raised"] else None for st in steps]
    require(all(k == first for k in kern[:i]),
            f"decode steps before the fault launched {kern[:i]}")
    require(i == FAULT_DECODE_STEP - 1, f"the fault hit decode call {i + 1}")
    replay = steps[i + 1]
    require(replay["replay"] and kern[i + 1] == sub,
            f"the replayed step launched {replay['launches']}, expected {sub}")
    kinds = kern[i + 2:]
    require(all(k in (sub, chain) for k in kinds), f"later steps launched {kinds[:4]}")
    require(sub in kinds and chain in kinds and kinds.index(sub) < kinds.index(chain),
            "the rungs did not follow the quarantine")
    require(counts["decode_layer"] == i * L, f"decode_layer launches {counts['decode_layer']} "
                                             f"after the fault, expected {i * L}")

    # the replayed step against a fresh sub-block step and the plain chain,
    # on its own inputs and the pools it started from
    tokens, bt, lengths, write_pos, sampling = replay["inputs"]

    def pools():
        return [{k: v.clone() for k, v in kv.items()} for kv in replay["pools"]]

    def rerun():   # a fresh traced step at the sub-block rung
        run = PagedLlamaRunner(cfg, eng.geom, block_fusion=True, device=eng.device)
        with quarantine.suppress(["cuda.decode_layer"]):
            return run.decode(eng.params, tokens, bt, lengths, write_pos, pools(), *sampling)

    def plain_subblocks(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, bt_,
                        lengths_, write_pos_, mlp_norm, w_gate, w_up, w_down, act="silu",
                        eps=1e-5, scale=None):
        out, k_rows, v_rows = tnn.attn_subblock_plain(
            h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, bt_, lengths_,
            write_pos_, eps=eps, scale=scale)
        tnn._store_fresh_rows(k_pages, v_pages, k_rows, v_rows, write_pos_)
        return tnn.mlp_subblock_plain(h, out, mlp_norm, w_gate, w_up, w_down, act, eps)

    quarantine.reset()   # the fresh sub-block step routes its own kernels
    fresh = rerun()
    with torch.no_grad():
        plain = decode_step(cfg, eng.params, tokens, bt, lengths, write_pos, pools(), *sampling,
                            plain_subblocks)
    torch.cuda.synchronize()
    require(torch.equal(fresh[1], replay["logits"]) and torch.equal(fresh[0], replay["tokens"]),
            "the replayed step differs from a fresh sub-block step on its inputs")
    plain_err = row_rel_err(replay["logits"].float(), plain[1].float())
    require(plain_err <= DECODE_TOL, f"replayed logits vs the plain sub-block chain: {plain_err}")
    out = {"model": cfg.name, "layers": L, "dtype": "bfloat16", "block_fusion": True,
           "fault": f"kernel:cuda.decode_layer on decode step {FAULT_DECODE_STEP}",
           "requests": [len(r) for r in stages], "decode_calls": len(steps),
           "rebinds": rebinds, "launches_per_decode_step": {
               "before the fault": {"decode_layer": L, "rms_norm": 1}, "sub-block rung": sub,
               "per-op kernel rung": chain},
           "leaf_quarantined": "rms_norm_residual: fatal KernelExecutionError on the card",
           "replay_vs_plain_row_rel_err": plain_err, "launches": counts, "wall_s": wall_s}
    del eng, params, steps, replay, fresh, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


def quarantine_card_vs_cpu(np, torch, tllama, ServingEngine, cudaex) -> dict:
    """(e) float32 tiny-gqa at the planned rung on the card and on the CPU,
    under the same fault and quarantine stages as (d): identical tokens in
    the stages both drain, and the replayed step's logits on the card
    against the CPU's (its plain sub-block chain) within SUBBLOCK_STEP_TOL;
    the quarantined leaf raises on the card and drains on the CPU."""
    from thunder_tpu_torch.runtime import FaultPlan, FaultSpec, faults, quarantine

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(6)
    prompts = [[rng.randint(1, cfg.vocab_size, size=n).astype(np.int32) for n in lens]
               for lens in ((1, 7, 16, 33), (24, 9), (40, 3))]
    kw = dict(max_slots=3, page_size=8, num_pages=24, max_context=64, prefill_chunk=16,
              block_fusion=True)
    tokens, replays, drained = {}, {}, {}
    for device in ("cuda", "cpu"):
        quarantine.reset()
        cudaex.reset_launch_counts()
        eng = ServingEngine(params, cfg, device=device, **kw)
        steps: list = []
        record_decode(eng, cudaex, torch, steps)
        stages, rebinds = quarantine_stages(np, eng, prompts,
                                            fault_plan(FaultPlan, FaultSpec, cfg.n_layers),
                                            faults, quarantine)
        tokens[device] = [r.output().tolist() for reqs in stages[:2] for r in reqs]
        replays[device] = next(st["logits"].cpu() for st in steps if st["replay"])
        drained[device] = len(stages)
        require(rebinds == 2, f"{device}: {rebinds} rebinds")
    quarantine.reset()
    require(tokens["cuda"] == tokens["cpu"], "card and CPU tokens differ under the faults")
    err = float((replays["cuda"] - replays["cpu"]).abs().max())
    require(err <= SUBBLOCK_STEP_TOL, f"replayed step logits, card vs CPU: {err}")
    require(drained == {"cuda": 2, "cpu": 3}, f"stages drained {drained}")
    return {"requests": sum(len(p) for p in prompts[:2]), "tokens_identical": True,
            "replay_logits_max_abs_err": err,
            "leaf_quarantined": "raised on the card, plain version on the CPU"}


# ---------------------------------------------------------------------------
# phase 16: the serving fleet — prefix cache, best-of-N forks, supervised
# restart, generate and generate_fused
# ---------------------------------------------------------------------------

def fleet_calls(eng, cudaex, calls: list) -> None:
    """Wrap ``eng.runner.decode`` and ``.prefill``: each call appends its
    kind, its prefill chunk's rows, and the launches and designs it made."""
    for attr in ("decode", "prefill"):
        fn = getattr(eng.runner, attr)

        def wrapped(*args, _fn=fn, _kind=attr):
            before, designs = cudaex.launch_counts(), cudaex.design_counts()
            out = _fn(*args)
            after = cudaex.launch_counts()
            # the regions of the program the call ran
            regions = (decode_regions(eng) if _kind == "decode" else program_regions(
                eng.runner.prefill_jit.bind(*args, contained=False).entry))
            calls.append((_kind, args[1].shape[1] if _kind == "prefill" else None,
                          {k: after[k] - before[k] for k in after if after[k] != before[k]},
                          design_delta(designs, cudaex.design_counts()), regions))
            return out

        setattr(eng.runner, attr, wrapped)


def fleet_expect(cudaex, cfg, L: int, block_fusion: bool, kind: str, C: int | None = None):
    """The launches and designs one decode step (``kind == "decode"``, 8
    slots) or one prefill chunk of C rows makes at a rung."""
    dt, D = cfg.dtype, cfg.dim
    rn, rr = cudaex.rms_norm_design(dt, D), cudaex.rms_norm_residual_design(dt, D)
    if kind == "decode" and block_fusion:
        dd = cudaex.decode_design(dt, FLEET_SLOTS, D, cfg.n_heads, cfg.kv_heads, cfg.head_dim)
        return ({"decode_layer": L, "rms_norm": 1}, {"decode_layer": {dd: L}, "rms_norm": {rn: 1}})
    if kind == "decode":
        return ({"paged_decode_attention": L, "linear_act": L, "rms_norm_residual": 2 * L,
                 "rms_norm": 1},
                {"paged_decode_attention": {"split": L},
                 "linear_act": {cudaex.linear_act_design(dt, FLEET_SLOTS): L},
                 "rms_norm_residual": {rr: 2 * L}, "rms_norm": {rn: 1}})
    if block_fusion:
        return ({"rms_norm": L, "mlp_subblock": L - 1},
                {"rms_norm": {rn: L}, "mlp_subblock": {cudaex.gemm_design(dt): L - 1}})
    return ({"rms_norm": 1, "rms_norm_residual": 2 * (L - 1), "linear_act": L - 1},
            {"rms_norm": {rn: 1}, "rms_norm_residual": {rr: 2 * (L - 1)},
             "linear_act": {cudaex.linear_act_design(dt, C): L - 1}})


def require_fleet_calls(what, cudaex, cfg, L, block_fusion, calls) -> dict:
    """Every decode step and prefill chunk of ``calls`` launched every kernel
    of its rung, on the designs the rules name. Returns the expected
    launches per decode step."""
    require(any(c[0] == "decode" for c in calls) and any(c[0] == "prefill" for c in calls),
            f"{what}: no decode step or no prefill chunk ran")
    for i, (kind, C, counts, designs, regions) in enumerate(calls):
        want, want_d = fleet_expect(cudaex, cfg, L, block_fusion, kind, C)
        want = with_region(want, regions)
        require(counts == want and without_regions(designs) == want_d,
                f"{what}: {kind} call {i} (rows {C}) launched {counts} by design {designs}, "
                f"expected {want} by design {want_d}")
    return fleet_expect(cudaex, cfg, L, block_fusion, "decode")[0]


def chunks_for(n: int, max_chunk: int) -> int:
    return -(-n // max_chunk)


def fleet_prefix(np, torch, ServingEngine, cudaex, params, cfg, kw, sizes, block_fusion,
                 check_launches: bool) -> dict:
    """(a) ``sizes["requests"]`` prompts of one shared system prompt and
    distinct tails, cold then warm (fresh tails) on one prefix-cached
    engine, beside a ``prefix_cache=False`` engine serving the same 16
    prompts: identical tokens; cold requests hit nothing and prefill every
    chunk, warm ones hit exactly the system prompt and prefill one chunk;
    ``prefix_hit_rate`` and ``cached_pages`` at their expected values; the
    system prompt's cached pages hold the bytes the other engine's first
    request wrote, bit for bit. Then one request alone on each engine (a
    fresh tail): the solo cold and warm TTFT."""
    rng = np.random.RandomState(sizes["seed"])
    V, S, new = cfg.vocab_size, sizes["system"], sizes["new"]
    sysp = rng.randint(1, V, size=S).astype(np.int32)
    cold_p, warm_p = ([np.concatenate([sysp, rng.randint(1, V, size=t).astype(np.int32)])
                       for t in sizes["tails"]] for _ in range(2))
    solo = np.concatenate([sysp, rng.randint(1, V, size=sizes["tails"][-1]).astype(np.int32)])
    ps = kw["page_size"]
    ref = ServingEngine(params, cfg, block_fusion=block_fusion, **kw)
    warm_engine(torch, ref)
    snap = {}
    finish = ref._finish

    def first_finish(req):
        if not snap:   # the system prompt's pages of the first request done
            snap["pages"] = [{k: v[:, req.pages[:S // ps]].clone() for k, v in kv.items()}
                             for kv in ref.cache.pools]
        finish(req)

    ref._finish = first_finish
    ref_reqs = [ref.submit(p, new) for p in cold_p + warm_p]
    ref.drain()
    ref.assert_quiescent()
    eng = ServingEngine(params, cfg, block_fusion=block_fusion, prefix_cache=True, **kw)
    warm_engine(torch, eng)
    calls: list = []
    if check_launches:
        fleet_calls(eng, cudaex, calls)
    cudaex.reset_launch_counts()
    t0 = time.perf_counter()
    cold = [eng.submit(p, new) for p in cold_p]
    eng.drain()
    warm = [eng.submit(p, new) for p in warm_p]
    eng.drain()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = cudaex.launch_counts()
    eng.assert_quiescent()
    for r in cold + warm:
        require(r.done and len(r.output()) == new, f"request {r.request_id} state {r.state}")
    mc = eng.max_chunk
    require([r.output().tolist() for r in cold + warm] ==
            [r.output().tolist() for r in ref_reqs],
            "prefix-cached tokens differ from the prefix_cache=False engine's")
    require([r.prefix_hit_tokens for r in cold] == [0] * len(cold)
            and [r.prefix_hit_tokens for r in warm] == [S] * len(warm),
            f"prefix hits cold {[r.prefix_hit_tokens for r in cold]}, warm "
            f"{[r.prefix_hit_tokens for r in warm]}")
    require([r.prefill_chunks for r in cold] == [chunks_for(len(p), mc) for p in cold_p]
            and [r.prefill_chunks for r in warm] == [chunks_for(len(p) - S, mc) for p in warm_p],
            f"prefill chunks cold {[r.prefill_chunks for r in cold]}, warm "
            f"{[r.prefill_chunks for r in warm]}")
    hit_rate = len(warm) * S / sum(len(p) for p in cold_p + warm_p)
    require(eng.prefix.hit_rate() == hit_rate,
            f"prefix_hit_rate {eng.prefix.hit_rate()}, expected {hit_rate}")
    # the first cold donor registers all its full pages; later cold donors
    # meet the system prompt under other pages and register none; each warm
    # donor registers the full pages past the system prompt it shares
    first = next(r for r in eng.completed if r in cold)
    donated = (len(first.prompt) + new - 1) // ps
    donated += sum((len(r.prompt) + new - 1) // ps - S // ps for r in warm)
    require(eng.cache.cached_pages == donated,
            f"cached_pages {eng.cache.cached_pages}, expected {donated}")
    # the system prompt's chain (a warm donor's own pages may follow it)
    chain = eng.prefix.lookup(warm_p[0])[:S // ps]
    require(len(chain) == S // ps, f"the trie holds {len(chain)} system pages")
    same = all(torch.equal(kv[k][:, chain], want[k]) for kv, want in
               zip(eng.cache.pools, snap["pages"]) for k in ("k", "v"))
    require(same, "cached system-prompt pages differ from the bytes a cold engine wrote")
    out = {"requests": len(cold) + len(warm), "system_tokens": S,
           "tails": list(sizes["tails"]), "new_tokens": new,
           "cold_chunks": sum(r.prefill_chunks for r in cold),
           "warm_chunks": sum(r.prefill_chunks for r in warm),
           "prefix_hit_rate": hit_rate, "cached_pages": donated,
           "ttft_ms_cold_mean": 1e3 * sum(r.ttft_s for r in cold) / len(cold),
           "ttft_ms_warm_mean": 1e3 * sum(r.ttft_s for r in warm) / len(warm),
           "tokens": [r.output().tolist() for r in cold + warm], "wall_s": wall_s,
           "launches": counts}
    if check_launches:
        out["launches_per_decode_step"] = require_fleet_calls(
            "phase 16 (a)", cudaex, cfg, len(params["layers"]), block_fusion, calls)
        out["decode_steps"] = sum(c[0] == "decode" for c in calls)
        out["prefill_calls"] = sum(c[0] == "prefill" for c in calls)
    # one request alone on each engine: cold (no cache) and warm (a hit)
    solo_ttft = {}
    for name, e in (("cold", ref), ("warm", eng)):
        r = e.submit(solo, new)
        e.drain()
        solo_ttft[name] = r.ttft_s * 1e3
        out.setdefault("solo_tokens", []).append(r.output().tolist())
    require(out["solo_tokens"][0] == out["solo_tokens"][1], "solo tokens differ")
    out["ttft_ms_solo_cold"], out["ttft_ms_solo_warm"] = solo_ttft["cold"], solo_ttft["warm"]
    for e in (ref, eng):
        e.cache.consume_pools()        # free the pools before the next run
    return out


def fleet_best_of(np, torch, ServingEngine, SamplingParams, cudaex, params, cfg, kw, sizes,
                  check_launches: bool) -> dict:
    """(b) ``submit(best_of=N)`` with temperature 0.8 and a pinned seed,
    beside N independent requests with ``sampling.fork(i)``: every branch's
    tokens identical, each copy-on-write tail page equal to the primary's
    tail at the fork, bit for bit; peak pages of both engines."""
    rng = np.random.RandomState(sizes["seed"] + 1)
    p = rng.randint(1, cfg.vocab_size, size=sizes["best_of_prompt"]).astype(np.int32)
    N, new = sizes["best_of"], sizes["new"]
    sp = SamplingParams(temperature=BEST_OF_TEMPERATURE, seed=BEST_OF_SEED)
    eng = ServingEngine(params, cfg, block_fusion=False, **kw)
    copies = []
    copy_page = eng.cache.copy_page

    def checked_copy(src, dst):
        copy_page(src, dst)
        copies.append(all(torch.equal(kv[k][:, dst], kv[k][:, src])
                          for kv in eng.cache.pools for k in ("k", "v")))

    eng.cache.copy_page = checked_copy
    calls: list = []
    if check_launches:
        fleet_calls(eng, cudaex, calls)
    cudaex.reset_launch_counts()
    prim = eng.submit(p, new, sampling=sp, best_of=N)
    eng.drain()
    counts = cudaex.launch_counts()
    eng.assert_quiescent()
    indep = ServingEngine(params, cfg, block_fusion=False, **kw)
    reqs = [indep.submit(p, new, sampling=sp.fork(i) if i else sp) for i in range(N)]
    indep.drain()
    indep.assert_quiescent()
    got = [r.output().tolist() for r in prim.fork_group]
    require(all(r.done for r in prim.fork_group) and got == [r.output().tolist() for r in reqs],
            "best-of branches differ from independent requests on the forked seeds")
    tail_copy = len(p) % kw["page_size"] != 0
    require(copies == [True] * ((N - 1) if tail_copy else 0) and
            eng.cache.cow_copies == len(copies), f"tail copies {copies}")
    require(len({tuple(t) for t in got}) > 1, "the branches did not diverge")
    out = {"prompt": len(p), "best_of": N, "new_tokens": new,
           "temperature": BEST_OF_TEMPERATURE, "cow_copies": eng.cache.cow_copies,
           "peak_pages_best_of": eng.cache.peak_pages_used,
           "peak_pages_independent": indep.cache.peak_pages_used,
           "pages_allocated_best_of": eng.cache.pages_allocated,
           "pages_allocated_independent": indep.cache.pages_allocated,
           "tokens": got, "launches": counts}
    if check_launches:
        out["launches_per_decode_step"] = require_fleet_calls(
            "phase 16 (b)", cudaex, cfg, len(params["layers"]), False, calls)
    for e in (eng, indep):
        e.cache.consume_pools()
    return out


def fleet_restart(np, torch, ServingEngine, cudaex, params, cfg, kw, sizes, block_fusion,
                  check_launches: bool) -> dict:
    """(c) a ``serving:engine`` fault on decode step RESTART_FAULT_STEP under
    the supervisor: one restart, every request done at full length, the
    tokens generated before the fault identical to a fault-free run's, the
    rebuilt pool quiescent."""
    from thunder_tpu_torch.runtime import FaultPlan, FaultSpec, faults
    from thunder_tpu_torch.serving import EngineSupervisor

    rng = np.random.RandomState(sizes["seed"] + 2)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in sizes["restart_prompts"]]
    new = sizes["new"]
    clean = ServingEngine(params, cfg, block_fusion=block_fusion, **kw)
    want = [clean.submit(p, new) for p in prompts]
    clean.drain()
    clean.cache.consume_pools()
    eng = ServingEngine(params, cfg, block_fusion=block_fusion, **kw)
    calls: list = []
    if check_launches:
        fleet_calls(eng, cudaex, calls)
    at_fault = {}
    rebuild = eng.rebuild_after_fault

    def recorded(*args):
        at_fault.update({r.request_id: len(r.generated) for r in eng.slots if r is not None})
        return rebuild(*args)

    eng.rebuild_after_fault = recorded
    sup = EngineSupervisor(eng)
    cudaex.reset_launch_counts()
    reqs = [sup.submit(p, new) for p in prompts]
    with faults.active(FaultPlan([FaultSpec("serving:engine", every_n=RESTART_FAULT_STEP,
                                            max_fires=1)])):
        sup.drain()
    counts = cudaex.launch_counts()
    eng.assert_quiescent()
    require(sup.restarts == 1, f"{sup.restarts} restarts")
    require(all(r.done and len(r.output()) == new for r in reqs), "a request did not complete")
    require(all(r.restarts == 1 for r in reqs) and at_fault, f"restarts {[r.restarts for r in reqs]}")
    prefix_ok = [r.output()[:at_fault.get(r.request_id, 0)].tolist()
                 == w.output()[:at_fault.get(r.request_id, 0)].tolist()
                 for r, w in zip(reqs, want)]
    require(all(prefix_ok), f"tokens before the fault differ: {prefix_ok}")
    out = {"requests": len(reqs), "new_tokens": new, "block_fusion": block_fusion,
           "fault": f"serving:engine on decode step {RESTART_FAULT_STEP}", "restarts": 1,
           "generated_at_fault": [at_fault.get(r.request_id, 0) for r in reqs],
           "tokens": [r.output().tolist() for r in reqs],
           "tokens_equal_fault_free": [r.output().tolist() == w.output().tolist()
                                       for r, w in zip(reqs, want)],
           "launches": counts}
    if check_launches:
        out["launches_per_decode_step"] = require_fleet_calls(
            "phase 16 (c)", cudaex, cfg, len(params["layers"]), block_fusion, calls)
    eng.cache.consume_pools()
    return out


def check_generate_kernels(torch, cudaex, tnn) -> dict:
    """(d)'s kernels at the shapes ``generate``'s prefill gives them: its
    B x Tp rows (FLEET_SIZES: 8 x 1000 = 8000, which ends linear_act's
    wgmma tile path in a ragged 64-row M tile) — rms_norm and
    rms_norm_residual on (B, Tp, D), linear_act (the gate with its silu) on
    (B, Tp, D) — each held against its plain version with its planted
    faults, and timed. Its decode steps run the 8-row shapes of phase 3's
    rows. {name: [row]}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    lead = (FLEET_SIZES["gen_batch"], FLEET_SIZES["gen_prompt"])
    rows = {row["name"]: [row] for row in norm_rows(torch, cudaex, tnn, gen, (*lead, D))}
    rows["linear_act"] = [linear_act_row(torch, cudaex, tnn, gen, lead, iters=10)]
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def fleet_generate(np, torch, ServingEngine, cudaex, tllama, params, cfg, sizes,
                   measure: bool) -> dict:
    """(d) ``generate`` and ``generate_fused`` on B prompts of one length:
    identical tokens; the captured step launched what one eager step
    launched; the first-step logits against the engine's replay-step logits
    for the same prompts, row by row, within GENERATE_LOGITS_TOL; one
    bucketed call (``prefill_buckets``). ``measure``: the prefill ms and
    both functions' decode tokens/s (``benchmarks/generate.py``)."""
    from thunder_tpu_torch.benchmarks import generate as bench_generate
    from thunder_tpu_torch.testing import row_rel_err

    dev = params["tok_embedding"].device
    B, T, new, max_len = sizes["gen_batch"], sizes["gen_prompt"], sizes["gen_new"], sizes["gen_max_len"]
    rng = np.random.RandomState(sizes["seed"] + 3)
    prompt = rng.randint(1, cfg.vocab_size, size=(B, T))
    cudaex.reset_launch_counts()
    eager = tllama.generate(params, cfg, prompt, new, max_len=max_len, device=dev)
    stats: dict = {}
    fused = tllama.generate_fused(params, cfg, prompt, new, max_len=max_len, device=dev,
                                  stats=stats)
    counts = cudaex.launch_counts()
    require(torch.equal(eager, fused), "generate_fused tokens differ from generate's")
    require(0 <= int(eager.min()) and int(eager.max()) < cfg.vocab_size, "out-of-vocab tokens")
    out = {"batch": B, "prompt": T, "new_tokens": new, "max_len": max_len,
           "tokens": eager.cpu().tolist(), "launches": counts}
    if dev.type == "cuda":
        require(stats["graph"] and stats["replays"] == new - 2, f"graph stats {stats}")
        require(stats["captured_launches"] == stats["eager_launches"],
                f"captured step launched {stats['captured_launches']}, one eager step "
                f"{stats['eager_launches']}")
        out["launches_per_decode_step"] = stats["eager_launches"]
        out["eager_step_host_ms"] = stats["eager_step_host_ms"]
        out["replay_host_ms"] = stats["replay_host_ms"]
        out["replay_ms"] = stats["replay_ms"]
        # the counters run on the host: they counted the captured step
        # once, at capture, where the card ran it once a replay
        captured = stats["captured_launches"]
        out["host_launches"] = counts
        out["launches"] = {k: n + (stats["replays"] - 1) * captured.get(k, 0)
                           for k, n in counts.items()}
    # the first-step logits of generate against the engine's replay step
    cache = tllama.init_kv_cache(cfg, B, max_len, n_layers=len(params["layers"]), device=dev)
    first, _ = tllama.forward_step(params, torch.from_numpy(prompt).to(dev), cache, 0, cfg,
                                   last_idx=T - 1)
    del cache
    eng = ServingEngine(params, cfg, device=dev, max_slots=B, page_size=sizes["page_size"],
                        max_context=max_len, block_fusion=False)
    replay = {}
    decode = eng.runner.decode

    def recorded(*args):
        rows = [(i, r.request_id) for i, r in enumerate(eng.slots)
                if r is not None and r.state == "decode" and r._replay]
        toks, logits = decode(*args)
        for i, rid in rows:
            replay[rid] = logits[i].clone()
        return toks, logits

    eng.runner.decode = recorded
    reqs = [eng.submit(p, 1) for p in prompt]
    eng.drain()
    eng.cache.consume_pools()
    engine_logits = torch.stack([replay[r.request_id] for r in reqs])
    err = row_rel_err(engine_logits.float(), first[:, 0].float())
    require(err <= GENERATE_LOGITS_TOL, f"generate's first-step logits vs the engine's replay "
                                        f"step: {err} > {GENERATE_LOGITS_TOL}")
    out["first_step_logits_row_rel_err"] = err
    out["first_token_equal_engine"] = [int(a) == int(r.output()[0])
                                       for a, r in zip(eager[:, 0], reqs)]
    # one bucketed call
    bp = rng.randint(1, cfg.vocab_size, size=(B, sizes["bucket_prompt"]))
    bucketed = tllama.generate(params, cfg, bp, new, prefill_buckets=sizes["buckets"],
                               device=dev)
    plain = tllama.generate(params, cfg, bp, new, device=dev)
    require(tuple(bucketed.shape) == (B, new) and 0 <= int(bucketed.min())
            and int(bucketed.max()) < cfg.vocab_size, "bucketed generate's tokens")
    out["bucketed"] = {"prompt": sizes["bucket_prompt"], "buckets": list(sizes["buckets"]),
                       "tokens": bucketed.cpu().tolist(),
                       "rows_equal_unbucketed": [bool(torch.equal(a, b))
                                                 for a, b in zip(bucketed, plain)]}
    if measure:
        out["timing"] = bench_generate.run(cfg.name, batch=B, prompt_len=T, decode=new,
                                           max_len=max_len, repeats=GEN_REPEATS,
                                           device=dev, params=params)
        require(out["timing"]["tokens_identical"], "benchmark tokens differ")
    return out


def fleet_full_width(np, torch, tllama, ServingEngine, SamplingParams, cudaex) -> dict:
    """Phase 16 (a)-(d) at llama3-8b full width, FLEET_LAYERS of its 32
    layers, bf16."""
    from thunder_tpu_torch.runtime import quarantine

    quarantine.reset()
    # depth cut to FLEET_LAYERS (the script's time limit): widths as published
    cfg = dataclasses.replace(tllama.CONFIGS["llama3-8b"], n_layers=FLEET_LAYERS)
    params = tllama.init_params(cfg, seed=0, device="cuda")
    kw = dict(max_slots=FLEET_SLOTS, page_size=PS, max_context=FLEET_CONTEXT)
    sizes = FLEET_SIZES
    out = {"model": cfg.name, "layers": cfg.n_layers, "dtype": "bfloat16"}
    # warm-up request (cuBLAS handles, allocator), not part of the measured runs
    warm = ServingEngine(params, cfg, block_fusion=False, **kw)
    warm.submit(np.arange(1, 40, dtype=np.int32), 2)
    warm.drain()
    warm.cache.consume_pools()
    for bf in (False, True):
        t0 = time.perf_counter()
        out["prefix_planned" if bf else "prefix"] = dict(
            fleet_prefix(np, torch, ServingEngine, cudaex, params, cfg, kw, sizes, bf, True),
            phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    out["best_of"] = dict(fleet_best_of(np, torch, ServingEngine, SamplingParams, cudaex,
                                        params, cfg, kw, sizes, True),
                          phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    out["restart"] = dict(fleet_restart(np, torch, ServingEngine, cudaex, params, cfg, kw,
                                        sizes, True, True), phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    out["generate"] = dict(fleet_generate(np, torch, ServingEngine, cudaex, tllama, params,
                                          cfg, sizes, True), phase_s=time.perf_counter() - t0)
    for k in ("prefix", "prefix_planned", "best_of", "restart"):
        out[k].pop("tokens", None)
        out[k].pop("solo_tokens", None)
    out["generate"].pop("tokens")
    out["generate"]["bucketed"].pop("tokens")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fleet_card_vs_cpu(np, torch, tllama, ServingEngine, SamplingParams, cudaex) -> dict:
    """(e) (a)-(d) on tiny-gqa float32 on the card and on the CPU from the
    same weights: every token identical, across the restart and the forks
    too."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu")
    kw = dict(max_slots=4, page_size=8, max_context=128, prefill_chunk=16)
    sizes = TINY_FLEET_SIZES
    tokens = {}
    for device in ("cuda", "cpu"):
        ps = tllama.to_device(params, device)
        kwd = dict(kw, device=device)
        runs = {"prefix": fleet_prefix(np, torch, ServingEngine, cudaex, ps, cfg, kwd, sizes,
                                       False, False),
                "prefix_planned": fleet_prefix(np, torch, ServingEngine, cudaex, ps, cfg, kwd,
                                               sizes, True, False),
                "best_of": fleet_best_of(np, torch, ServingEngine, SamplingParams, cudaex, ps,
                                         cfg, kwd, sizes, False),
                "restart": fleet_restart(np, torch, ServingEngine, cudaex, ps, cfg, kwd, sizes,
                                         True, False),
                "generate": fleet_generate(np, torch, ServingEngine, cudaex, tllama, ps, cfg,
                                           sizes, False)}
        tokens[device] = {k: (v["tokens"], v.get("solo_tokens"),
                              v.get("bucketed", {}).get("tokens")) for k, v in runs.items()}
    bad = [k for k in tokens["cuda"] if tokens["cuda"][k] != tokens["cpu"][k]]
    require(not bad, f"card and CPU tokens differ in {bad}")
    return {"model": cfg.name, "dtype": "float32", "tokens_identical": sorted(tokens["cuda"])}


# ---------------------------------------------------------------------------
# phase 3, the model zoo's shapes; phase 17: the zoo trained at full width
# ---------------------------------------------------------------------------

# phase 17 (b) and (c): each family at the full width of its published
# config; depth cut where the card's memory forces it (Mixtral to 2 of 32
# layers, Falcon to 4 of 32), gpt2-medium at its 1024 learned positions
ZOO_PATHS = {
    "zoo-mixtral-8x7b": dict(model="mixtral/mixtral-8x7b", layers=2, batch=1, seq=2048),
    "zoo-pythia-410m": dict(model="gpt/pythia-410m", batch=1, seq=2048),
    "zoo-phi-1.5": dict(model="gpt/phi-1.5", batch=1, seq=2048),
    "zoo-gemma-2b": dict(model="gpt/gemma-2b", batch=1, seq=2048),
    "zoo-gpt2-medium": dict(model="gpt/gpt2-medium", batch=2, seq=1024),
    "zoo-falcon-7b": dict(model="gpt/falcon-7b", layers=4, batch=1, seq=2048),
    "zoo-gpt2-xl": dict(model="nanogpt/gpt2-xl", batch=4, seq=1024),
    "zoo-bart-base": dict(model="seq2seq/bart-base", batch=1, seq=512, src_seq=1024),
    "zoo-resnet18": dict(model="resnet/resnet18", batch=64, seq=0, image=224, lr=1e-2),
}
ZOO_LR = 1e-4
ZOO_STEPS = 2          # timed steps after the warm-up step
MIXTRAL_STEPS = 2      # (b): 3 steps of loss_fn in all, then one fused remat step
# (b): the fused loss (lm_head in float32 chunks) against loss_fn (bf16
#   logits taken to float32) on the same weights and batch: only the
#   logits' bf16 rounding differs (2**-9 relative, ~0.004 on a logit of 2),
#   which moves the mean loss by ~1e-4 (1.47e-4 on the H100). The bound
#   stands ~10x under the router aux term both losses add (~0.01 a layer at
#   a balanced router), so a fused loss that dropped or doubled it fails;
#   the run requires that aux term to exceed the bound
MIXTRAL_FUSED_LOSS_ATOL = 2e-3
# (a): the tiny configs in float32, card against CPU: losses 1e-5 relative
#   (phase 6's), gradients 1e-5 of each leaf's largest value (at least 1e-5
#   absolute: float32 sums in another order on each side, cuBLAS and the
#   FMA attention against the CPU's), parameters after one step phase 6's
#   0.2 lr where the gradient stands above that tolerance (a noise-level
#   gradient gives a noise-decided first Adam step of up to lr, so 2 lr
#   there); tiny-moe's top-k experts identical in every layer
ZOO_GRAD_RTOL = 1e-5
ZOO_TINY = ("mixtral/tiny-moe", "gpt/tiny", "gpt/tiny-neox", "gpt/tiny-falcon", "gpt/tiny-gemma",
            "gpt/tiny-phi", "nanogpt/gpt2-tiny", "seq2seq/tiny", "resnet/resnet-tiny")
# float32 attention rows (bart-base): the card tests' bounds, output 1e-5 and
#   gradients 1e-4 of each row's largest value, lse 1e-4
F32_ATTN_TOL, F32_GRAD_TOL, F32_LSE_TOL = 1e-5, 1e-4, 1e-4


def zoo_attention_shapes(cfg_of, path: str) -> list:
    """``[(dtype, B, H, T, S, hd, causal)]`` of a zoo path's attention calls,
    the row the table keeps first."""
    spec = ZOO_PATHS[path]
    fam, cfg = cfg_of(spec["model"])
    B, T = spec["batch"], spec["seq"]
    if fam == "resnet":
        return []
    if fam == "seq2seq":
        S = spec["src_seq"]
        H, hd = cfg.n_heads, cfg.head_dim
        return [(cfg.dtype, B, H, T, S, hd, False), (cfg.dtype, B, H, S, S, hd, False),
                (cfg.dtype, B, H, T, T, hd, True)]
    if fam == "nanogpt":
        return [(cfg.dtype, B, cfg.n_head, T, T, cfg.n_embd // cfg.n_head, True)]
    return [(cfg.dtype, B, cfg.n_heads, T, T, cfg.head_dim, True)]


def attention_rows(torch, cudaex, tnn, gen, dtype, B, H, T, S, hd, causals, faults=False):
    """sdpa_fwd and sdpa_bwd at one shape against their plain versions, row
    by row (row_rel_err), each on the design its rule names, for each flag
    in ``causals`` on the same q, k, v and dO (drawn in that order);
    ``[(fwd row, bwd row)]``. ``faults``: on the causal case, the planted
    faults must fail the row check and two backward calls must agree bit
    for bit."""
    import torch.nn.functional as F

    from thunder_tpu_torch.testing import row_rel_err

    dev = torch.device("cuda")
    f32 = dtype == torch.float32
    q = torch.randn(B, H, T, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, H, S, hd, generator=gen, device=dev).to(dtype) for _ in range(2))
    g = torch.randn(B, H, T, hd, generator=gen, device=dev).to(dtype)
    esize, peak = (4, F32_FLOPS) if f32 else (2, BF16_FLOPS)
    out_tol, grad_tol, lse_tol = ((F32_ATTN_TOL, F32_GRAD_TOL, F32_LSE_TOL) if f32
                                  else (ATTN_TOL, GRAD_REL_TOL, LSE_TOL))
    bh = B * H
    rows = []
    for causal in causals:
        tag = (f"{B}x{H}x{T}{f'x{S}' if S != T else ''}x{hd}{' causal' if causal else ''}"
               f"{' f32' if f32 else ''}")
        frac = 0.5 if causal and T == S else 1.0
        (out, lse), design = ran(cudaex, "sdpa_fwd", lambda: cudaex.sdpa_fwd(q, k, v, causal))
        require(design == cudaex.sdpa_fwd_design(dtype, hd), f"sdpa_fwd {tag}: took {design}")
        want_out, want_lse = tnn.sdpa_fwd_plain(q, k, v, causal)
        out_rel = row_rel_err(out, want_out)
        lse_err = float((lse - want_lse).abs().max())
        require(out_rel <= out_tol and lse_err <= lse_tol,
                f"sdpa_fwd {tag}: out err {out_rel} of its rows' largest values, lse err {lse_err}")
        fwd = timed_row(torch, cudaex, "sdpa_fwd", tag,
                        float((out.float() - want_out.float()).abs().max()),
                        lambda: cudaex.sdpa_fwd(q, k, v, causal),
                        lambda: tnn.sdpa_fwd_plain(q, k, v, causal),
                        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                        2 * bh * (T + S) * hd * esize + bh * T * 4,
                        4.0 * bh * T * S * hd * frac, peak, 10, 3)
        fwd["design"] = design
        # the backward from the plain forward's (out, lse), so it is held alone
        got, bwd_design = ran(cudaex, "sdpa_bwd",
                              lambda: cudaex.sdpa_bwd(g, q, k, v, want_out, want_lse, causal))
        require(bwd_design == cudaex.sdpa_bwd_design(dtype, hd),
                f"sdpa_bwd {tag}: took {bwd_design}")
        want = tnn.sdpa_bwd_plain(g, q, k, v, want_out, want_lse, causal)
        rels = [row_rel_err(a, b) for a, b in zip(got, want)]
        require(max(rels) <= grad_tol, f"sdpa_bwd {tag}: dq/dk/dv err {rels} of their rows' "
                                       f"largest values")
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        log(f"  attention {tag}: design {design}/{bwd_design}, out {out_rel:.3e}, "
            f"lse {lse_err:.3e}, dq/dk/dv {', '.join(f'{r:.3e}' for r in rels)} of their rows' "
            f"largest values")
        if faults and causal:
            log("  planted faults: " + json.dumps(planted_faults(torch, out, want_out, got,
                                                                 want)))
            again = cudaex.sdpa_bwd(g, q, k, v, want_out, want_lse, causal)
            require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                    f"sdpa_bwd {tag}: two calls on the same inputs differ")
            log("  sdpa_bwd deterministic: two calls give bit-identical dq, dk, dv")
            del again
        del got, want
        lib, lib_note = None, None
        if f32:
            # aten's flash backward takes 16-bit inputs only: PyTorch's
            # float32 library backward is the memory-efficient attention's,
            # run by .backward() of F.scaled_dot_product_attention under
            # EFFICIENT_ATTENTION (the graph kept, so each call is the
            # backward alone): the same (dq, dk, dv) from q, k, v and dO
            try:
                from torch.nn.attention import SDPBackend, sdpa_kernel

                qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    o_ea = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)

                def lib():
                    return torch.autograd.grad(o_ea, (qr, kr, vr), g, retain_graph=True)
            except (RuntimeError, TypeError, ImportError) as e:
                lib_note = ("memory-efficient attention unavailable: "
                            f"{str(e).splitlines()[0][:160]}")
        else:
            try:
                fa = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal)

                def lib():
                    return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                        g, q, k, v, fa[0], fa[1], fa[2], fa[3], fa[4], fa[5], 0.0, causal,
                        fa[6], fa[7])
            except (RuntimeError, TypeError) as e:
                lib_note = f"aten flash attention unavailable: {str(e).splitlines()[0][:160]}"
        bwd = timed_row(torch, cudaex, "sdpa_bwd", tag, err,
                        lambda: cudaex.sdpa_bwd(g, q, k, v, want_out, want_lse, causal),
                        lambda: tnn.sdpa_bwd_plain(g, q, k, v, want_out, want_lse, causal), lib,
                        4 * bh * (T + S) * hd * esize + bh * T * 4,
                        10.0 * bh * T * S * hd * frac, peak, 10, 3)
        bwd["design"] = bwd_design
        if lib_note:
            bwd["library_note"] = lib_note
        if bwd_design == "wgmma":   # it recomputes S and dP in its dQ pass: 7 products, not 5
            log(f"    its 7-product floor {14.0 * bh * T * S * hd * frac / peak * 1e3:.4f} ms")
        rows.append((fwd, bwd))
        del out, lse, want_out, want_lse, lib
        gc.collect()
        torch.cuda.empty_cache()
    del q, k, v, g
    return rows


def ce_row(torch, cudaex, tnn, gen, N, V):
    """ce_fwd on (N, V) float32 logits (the zoo's losses take the logits to
    float32) against its plain version, some rows ignored; its row. Odd V
    takes the kernel's scalar loads."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    logits = torch.randn(N, V, generator=gen, device=dev) * 2.0
    target = torch.randint(0, V, (N,), generator=gen, device=dev)
    target[::97] = -100
    nll, lse = cudaex.ce_fwd(logits, target)
    want_nll, want_lse = tnn.ce_fwd_plain(logits, target)
    err = float(max((nll - want_nll).abs().max(), (lse - want_lse).abs().max()))
    for a, b in ((nll, want_nll), (lse, want_lse)):
        require(torch.allclose(a, b, rtol=CE_RTOL, atol=CE_RTOL * float(b.abs().max())),
                f"ce_fwd {N}x{V}: err {err}")
    require(float(nll[::97].abs().max()) == 0.0, f"ce_fwd {N}x{V}: an ignored row's nll")
    row = timed_row(torch, cudaex, "ce_fwd", f"{N}x{V} f32{' scalar' if V % 4 else ''}", err,
                    lambda: cudaex.ce_fwd(logits, target),
                    lambda: tnn.ce_fwd_plain(logits, target),
                    lambda: F.cross_entropy(logits, target, reduction="none"),
                    N * V * 4 + N * 8 + 2 * N * 4, 4.0 * N * V, F32_FLOPS, 10, 3)
    del logits, target, nll, lse, want_nll, want_lse
    torch.cuda.empty_cache()
    return row


def f32_residual_row(torch, cudaex, tnn, gen, shape):
    """rms_norm_residual on float32 rows (bart-base's) against its plain
    version: h bit for bit, the normed rows 1e-5 relative; its row."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    r, x = (torch.randn(*shape, generator=gen, device=dev) for _ in range(2))
    d = shape[-1]
    w = torch.rand(d, generator=gen, device=dev) + 0.5
    (gh, gy), design = ran(cudaex, "rms_norm_residual",
                           lambda: cudaex.rms_norm_residual(r, x, w, EPS))
    wh, wy = tnn.rms_norm_residual_plain(r, x, w, EPS)
    err = float((gy - wy).abs().max())
    require(bool(torch.equal(gh, wh)) and torch.allclose(gy, wy, rtol=1e-5, atol=1e-5),
            f"rms_norm_residual {shape} f32: err {err}")
    n = x.numel()
    row = timed_row(torch, cudaex, "rms_norm_residual", "x".join(map(str, shape)) + " f32", err,
                    lambda: cudaex.rms_norm_residual(r, x, w, EPS),
                    lambda: tnn.rms_norm_residual_plain(r, x, w, EPS), None,
                    4 * n * 4 + d * 4, 5 * n, F32_FLOPS, 30, 30)
    row["per_op_chain_ms"] = time_ms(torch, lambda: F.rms_norm(torch.add(r, x), (d,), w, EPS), 30)
    row["design"] = design
    return row


def adamw_bucket_row(torch, cudaex, toptim_ops, gen, leaves, tag, then=None):
    """fused_adamw over one model's whole bucket in one launch (its
    parameters, random gradients and moments, drawn in that order) against
    adamw_step_plain leaf by leaf, within ADAMW_ULP; ``(its row, then(ps,
    gs, ms, vs, bc, hyper) on the bucket after the step, or None)``. The
    check replays the moments' draws from the generator's saved state, a
    leaf at a time, rather than keep copies of the starting m and v
    (Mixtral-8x7B's at 2 layers: 25 GB). Bytes: p read and written, g read
    (the parameters' dtype), m and v read and written (float32)."""
    from thunder_tpu_torch.testing import ulp_distance

    dev = torch.device("cuda")
    ps = [p.detach() for p in leaves]
    dtype = ps[0].dtype
    require(all(p.dtype == dtype for p in ps), f"fused_adamw {tag}: a bucket of one dtype")
    n = sum(p.numel() for p in ps)
    p0 = [p.clone() for p in ps]
    gs = [torch.randn(p.shape, generator=gen, device=dev).mul_(1e-3).to(dtype) for p in ps]
    m_state = gen.get_state()
    ms = [torch.randn(p.shape, generator=gen, device=dev).mul_(1e-3) for p in ps]
    v_state = gen.get_state()
    vs = [torch.rand(p.shape, generator=gen, device=dev).mul_(1e-6) for p in ps]
    step = 10
    bc = torch.tensor([1 - 0.9 ** step, 1 - 0.999 ** step], dtype=torch.float32, device=dev)
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    cudaex.fused_adamw(ps, gs, ms, vs, bc, **hyper)
    torch.cuda.synchronize()
    gm, gv = torch.Generator(device=dev), torch.Generator(device=dev)
    gm.set_state(m_state)
    gv.set_state(v_state)
    ulp, err = 0, 0.0
    for i, p in enumerate(ps):
        m0 = torch.randn(p.shape, generator=gm, device=dev).mul_(1e-3)
        v0 = torch.rand(p.shape, generator=gv, device=dev).mul_(1e-6)
        want = toptim_ops.adamw_step_plain(p0[i], gs[i], m0, v0, bc[0], bc[1], **hyper)
        p0[i] = None
        for a, b in zip((p, ms[i], vs[i]), want):
            for ca, cb in zip(a.view(-1).split(1 << 26), b.view(-1).split(1 << 26)):
                ulp = max(ulp, ulp_distance(ca, cb))
                err = max(err, float((ca.float() - cb.float()).abs().max()))
        del m0, v0, want
    del p0
    require(ulp <= ADAMW_ULP, f"fused_adamw {tag}: {ulp} ULP from adamw_step_plain")
    log(f"  fused_adamw {tag or 'bucket'}: {len(ps)} tensors, {n} parameters, max {ulp} ULP from the "
        f"plain version")
    esize = ps[0].element_size()

    def plain():
        for p, g_, m, v_ in zip(ps, gs, ms, vs):
            toptim_ops.adamw_step_plain(p, g_, m, v_, bc[0], bc[1], **hyper)

    lib = None
    if dtype == torch.float32:   # torch._fused_adamw_ takes one dtype for p, g, m and v
        lp, lm, lv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
        steps_t = [torch.full((), float(step), device=dev) for _ in ps]

        def lib():
            torch._fused_adamw_(lp, gs, lm, lv, [], steps_t, lr=hyper["lr"], beta1=0.9,
                                beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
                                maximize=False)
    short = {torch.bfloat16: "bf16", torch.float32: "f32"}.get(dtype, str(dtype)[6:])
    row = timed_row(torch, cudaex, "fused_adamw", f"{tag + ' bucket: ' if tag else ''}{n} {short}",
                    err, lambda: cudaex.fused_adamw(ps, gs, ms, vs, bc, **hyper), plain, lib,
                    n * (3 * esize + 16), 12.0 * n, F32_FLOPS, 10, 2)
    if dtype != torch.float32:
        row["library_note"] = "torch._fused_adamw_ takes one dtype for params, grads and moments"
    extra = then(ps, gs, ms, vs, bc, hyper) if then is not None else None
    del ps, gs, ms, vs, lib
    gc.collect()
    torch.cuda.empty_cache()
    return row, extra


def check_zoo_kernels(torch, cudaex, tnn, toptim_ops, zoo) -> dict:
    """Phase 3 at the model zoo's shapes (phase 17's paths): for each path,
    each kernel it launches held against its plain version at that path's
    own shape and timed; ``{path: {kernel: row}}``. ``fused_adamw`` is
    held over each path's own bucket: its parameters at the path's depth."""
    from thunder_tpu_torch.optim import tree_leaves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)

    def cfg_of(model):
        mod, cfg = zoo.split_name(model)
        return model.partition("/")[0], cfg

    rows: dict = {path: {} for path in ZOO_PATHS}
    attn_done: dict = {}
    for path in ZOO_PATHS:
        for i, shape in enumerate(zoo_attention_shapes(cfg_of, path)):
            if shape not in attn_done:
                attn_done[shape] = attention_rows(torch, cudaex, tnn, gen, *shape[:-1],
                                                  (shape[-1],))[0]
            if i == 0:
                rows[path]["sdpa_fwd"], rows[path]["sdpa_bwd"] = attn_done[shape]
    ce_done: dict = {}
    for path, spec in ZOO_PATHS.items():
        fam, cfg = cfg_of(spec["model"])
        N = spec["batch"] * (spec["seq"] if fam != "resnet" else 1)
        V = cfg.num_classes if fam == "resnet" else cfg.vocab_size
        if path == "zoo-mixtral-8x7b" or (N, V) not in ce_done:
            ce_done[(N, V)] = ce_row(torch, cudaex, tnn, gen, N, V)
        rows[path]["ce_fwd"] = ce_done[(N, V)]
    for path, shape in (("zoo-mixtral-8x7b", (1, 2048, 4096)), ("zoo-gemma-2b", (1, 2048, 2048))):
        norm, residual = norm_rows(torch, cudaex, tnn, gen, shape)
        rows[path].update(rms_norm=norm, rms_norm_residual=residual)
    rows["zoo-bart-base"]["rms_norm_residual"] = f32_residual_row(torch, cudaex, tnn, gen,
                                                                  (1, 1024, 768))
    for path, spec in ZOO_PATHS.items():
        if path != "zoo-resnet18":
            leaves = tree_leaves(zoo.init_model(spec["model"], seed=3, device=dev,
                                                layers=spec.get("layers"))[0])
            rows[path]["fused_adamw"] = adamw_bucket_row(torch, cudaex, toptim_ops, gen, leaves,
                                                         path[4:])[0]
            del leaves
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def zoo_step_launches(zoo, model, per_step, layers=None, loss="naive", remat=False, what=""):
    """Every step of a zoo run launched its kernels as designed (the
    reference's claims)."""
    expect = zoo.expected_launches(model, layers, loss, remat)
    for i, st in enumerate(per_step):
        require(st["launches"] == expect,
                f"{what} step {i} launched {st['launches']}, expected {expect}")
    return expect


def zoo_card_vs_cpu(np, torch, cudaex, zoo, tmix) -> dict:
    """Phase 17 (a): each tiny config in float32 on the card and on the
    CPU from the same weights and batch: loss, gradients and one
    optimizer step; tiny-moe's top-k experts in every layer identical."""
    from thunder_tpu_torch.optim import tree_leaves, tree_map

    out = {}
    topi: list = []
    route = tmix.route

    def recording(*a, **k):
        res = route(*a, **k)
        topi.append(res[2].cpu())
        return res

    for model in ZOO_TINY:
        runs = {}
        for dev in ("cpu", "cuda"):
            params, bn = zoo.init_model(model, seed=0, device="cpu")
            params, bn = (tree_map(lambda t: t.to(dev), x) if x is not None else None
                          for x in (params, bn))
            batch = tuple(t.to(dev) for t in zoo.make_batch(model, 2, 32, seed=1, device="cpu",
                                                            src_seq=48, image=16))
            opt = zoo.optimizer_for(model, TRAIN_LR)
            state = opt.init(params)
            topi.clear()
            tmix.route = recording
            try:
                cudaex.reset_launch_counts()
                value, grads, _ = zoo.value_and_grad(
                    lambda p: zoo.loss_of(model, p, batch, bn), params)
                launches = {k: n for k, n in cudaex.launch_counts().items() if n}
            finally:
                tmix.route = route
            opt.update(params, grads, state)
            runs[dev] = dict(loss=float(value), grads=[g.detach().cpu() for g in
                                                       tree_leaves(grads)],
                             params=[p.detach().cpu() for p in tree_leaves(params)],
                             topi=list(topi), launches=launches)
        a, b = runs["cuda"], runs["cpu"]
        require(abs(a["loss"] - b["loss"]) <= TRAIN_LOSS_RTOL * abs(b["loss"]),
                f"{model}: card loss {a['loss']} != CPU loss {b['loss']}")
        gerr = 0.0
        for ga, gb, pa, pb in zip(a["grads"], b["grads"], a["params"], b["params"]):
            tol = ZOO_GRAD_RTOL * max(1.0, float(gb.abs().max()))
            diff = float((ga - gb).abs().max())
            gerr = max(gerr, diff / tol)
            require(diff <= tol, f"{model}: card and CPU gradients differ by {diff} (tol {tol})")
            settled = gb.abs() > tol
            pdiff = (pa - pb).abs()
            settled_diff = float(pdiff[settled].max()) if bool(settled.any()) else 0.0
            require(settled_diff <= TRAIN_PARAM_ATOL
                    and float(pdiff.max()) <= 2.0 * TRAIN_LR * (1 + 1e-3),
                    f"{model}: card and CPU parameters differ by {float(pdiff.max())} after "
                    f"one step")
        require(len(a["topi"]) == len(b["topi"]) and all(
            bool(torch.equal(x, y)) for x, y in zip(a["topi"], b["topi"])),
            f"{model}: the card's top-k experts differ from the CPU's")
        expect = {k: n for k, n in zoo.expected_launches(model).items() if k != "fused_adamw"}
        require(a["launches"] == expect, f"{model}: the card's step launched {a['launches']}, "
                                         f"expected {expect}")
        require(b["launches"] == {}, f"{model}: the CPU step launched kernels {b['launches']}")
        out[model] = {"loss_card": a["loss"], "loss_cpu": b["loss"],
                      "grad_err_of_tol": gerr, "top_k_layers": len(a["topi"]),
                      "launches": a["launches"]}
    return out


def zoo_mixtral_full_width(torch, cudaex, zoo, tmix) -> dict:
    """Phase 17 (b): Mixtral-8x7B at full width, 2 of its 32 layers, B=1,
    T=2048, bf16, AdamW with float32 moments: expert_utilization on the
    batch at the initial weights, 3 steps of loss_fn (a warm-up and 2
    timed), then loss_fn's value without a gradient and a step of
    fused_loss_fn(remat=True) on the same weights and batch (a second one
    gives its steady time: the first carries first-call costs), then
    expert_utilization again."""
    spec = ZOO_PATHS["zoo-mixtral-8x7b"]
    model, L = spec["model"], spec["layers"]
    cfg = tmix.CONFIGS["mixtral-8x7b"]
    opt = zoo.optimizer_for(model, ZOO_LR)
    t0 = time.perf_counter()
    params, _ = zoo.init_model(model, seed=0, device="cuda", layers=L)
    tokens = zoo.make_batch(model, spec["batch"], spec["seq"], seed=0, device="cuda")[0]
    util_init = tmix.expert_utilization(params, tokens, cfg)
    cudaex.reset_launch_counts()
    res = zoo.run(model, batch=spec["batch"], seq=spec["seq"], steps=MIXTRAL_STEPS,
                  lr=ZOO_LR, seed=0, device="cuda", opt=opt, params=params)
    del params, tokens
    zoo_step_launches(zoo, model, res["per_step"], L, what="mixtral loss_fn")
    params, state, batch = res.pop("params"), res.pop("opt_state"), res.pop("inputs")
    res.pop("bn_state")
    before = cudaex.launch_counts()
    with torch.no_grad():
        naive = float(tmix.loss_fn(params, *batch, cfg))
    eval_launches = {k: n - before[k] for k, n in cudaex.launch_counts().items()
                     if n != before[k]}
    require(eval_launches == {"rms_norm": 1, "rms_norm_residual": 2 * L, "sdpa_fwd": L,
                              "ce_fwd": 1}, f"mixtral loss_fn without a gradient launched "
                                            f"{eval_launches}")
    with torch.no_grad():
        aux = float(tmix.forward(params, batch[0], cfg, skip_head=True)[1])
    require(aux > MIXTRAL_FUSED_LOSS_ATOL,
            f"mixtral's router aux term {aux} is within the fused-loss bound "
            f"{MIXTRAL_FUSED_LOSS_ATOL}: the bound cannot tell a loss without it")
    fused_steps = []
    for _ in range(2):   # the second step's time is the steady one
        before = cudaex.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        value, _ = zoo.train_step(model, params, opt, state, batch, loss="fused", remat=True)
        loss = float(value)
        fused_steps.append({"loss": loss, "ms": (time.perf_counter() - t) * 1e3,
                            "launches": {k: n - before[k] for k, n in
                                         cudaex.launch_counts().items() if n != before[k]}})
    fused, fused_ms = fused_steps[0]["loss"], fused_steps[1]["ms"]
    fused_launches = fused_steps[0]["launches"]
    zoo_step_launches(zoo, model, fused_steps, L, "fused", True,
                      "mixtral fused_loss_fn(remat=True)")
    launches = {k: n for k, n in cudaex.launch_counts().items() if n}
    losses = res["losses"]
    require(all(math.isfinite(x) for x in losses + [naive, fused]) and losses[-1] < losses[0],
            f"mixtral losses not finite and falling: {losses}")
    require(abs(fused - naive) <= MIXTRAL_FUSED_LOSS_ATOL,
            f"mixtral fused_loss_fn(remat=True) {fused} against loss_fn {naive}: "
            f"{abs(fused - naive)} > {MIXTRAL_FUSED_LOSS_ATOL}")
    util = tmix.expert_utilization(params, batch[0], cfg)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    res.update(launches=launches, eval_launches=eval_launches, fused_launches=fused_launches,
               loss_fn_no_grad=naive, router_aux_term=aux, fused_remat_loss=fused,
               fused_minus_naive=fused - naive, fused_remat_step_ms=fused_ms,
               fused_remat_first_step_ms=fused_steps[0]["ms"],
               fused_remat_losses=[st["loss"] for st in fused_steps],
               fused_remat_peak_memory_gb=peak, expert_utilization=util,
               expert_utilization_at_init=util_init,
               phase_s=time.perf_counter() - t0)
    return res


def zoo_full_width(torch, cudaex, zoo, path: str) -> dict:
    """Phase 17 (c): one family at full width: a warm-up and ZOO_STEPS
    timed steps on one batch; finite, falling losses; every step's
    launches as designed."""
    spec = ZOO_PATHS[path]
    model = spec["model"]
    cudaex.reset_launch_counts()
    t0 = time.perf_counter()
    res = zoo.run(model, layers=spec.get("layers"), batch=spec["batch"], seq=spec["seq"],
                  steps=ZOO_STEPS, lr=spec.get("lr", ZOO_LR), seed=0, device="cuda",
                  src_seq=spec.get("src_seq"), image=spec.get("image", 224))
    for k in ("params", "opt_state", "bn_state", "inputs"):
        res.pop(k)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_step_launches(zoo, model, res["per_step"], spec.get("layers"), what=path)
    losses = res["losses"]
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"{path}: losses not finite and falling: {losses}")
    res["launches"] = {k: n for k, n in cudaex.launch_counts().items() if n}
    res["phase_s"] = time.perf_counter() - t0
    return res


def log_zoo(path: str, r: dict, card: str) -> None:
    rate = ("images_per_s", r["images_per_s"]) if "images_per_s" in r else \
        ("tokens_per_s", r["tokens_per_s"])
    log(f"phase 17 {path}: {r['model']} layers {r['layers']} batch {r['batch']} seq {r['seq']} "
        f"{r['dtype']}, {r['params_count']} parameters: step {r['step_ms']:.2f} ms, "
        f"{rate[0]} {rate[1]:.1f}, peak {r['peak_memory_gb']:.2f} GB, losses "
        f"{[round(x, 5) for x in r['losses']]}, launches {r['launches']} ({card})")

# ---------------------------------------------------------------------------
# phase 18: the trace compiler's grad-free slice at llama3-8b full width
# ---------------------------------------------------------------------------

def torch_calls(torch, fn):
    """``fn()`` and the torch calls it makes at the Python level (a router
    of ``ops/`` counts once: its kernel launch; attribute reads such as
    ``.shape`` are not counted)."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") != "__get__":
                self.n += 1
            return func(*args, **(kwargs or {}))

    counter = Count()
    with counter:
        out = fn()
    return out, counter.n


def device_ms(torch, fn, iters: int = JIT_TIMED) -> float:
    """Mean device ms of ``fn()`` (a whole forward: no spin needed) from CUDA
    events around ``iters`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters: int = JIT_TIMED) -> float:
    """Mean host ms until ``fn()`` returns (before the card has finished its work)."""
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3 / iters


def jit_run(torch, cudaex, ptt, jf, args, eager_fn, what: str, jf_off=None) -> dict:
    """Compile ``jf`` for ``args``, then one cached call with the launch counts
    reset just before it and read just after: they must equal the execution
    trace's claims. Returns the compile stages, the cached call's output and
    launches, the eager call's, and their times. The timed calls capture
    the entry's graph (``whole_program_jit``, the default): one more call,
    a replay, must give the first call's output bit for bit. ``jf_off``, the
    same function with ``whole_program_jit=False``, must too, and is timed
    against it in turn (DEFAULT_RUNG_ROUNDS rounds of replay, per call, per
    call, replay; device ms medians), with its host ms and torch calls."""
    from thunder_tpu_torch.testing import jit_launches

    t0 = time.perf_counter()
    jf.compile(*args)
    compile_ms = (time.perf_counter() - t0) * 1e3
    stages = dict(ptt.compile_stats(jf).last_pass_times)
    out, launches, claims = jit_launches(jf, *args)
    require(launches == claims, f"{what}: the jit launched {launches}, its trace claims {claims}")
    require(ptt.cache_hits(jf) == 1 and ptt.cache_misses(jf) == 1,
            f"{what}: hits {ptt.cache_hits(jf)}, misses {ptt.cache_misses(jf)}")
    cudaex.reset_launch_counts()
    with torch.no_grad():
        eager = eager_fn()
    torch.cuda.synchronize()
    eager_launches = {k: n for k, n in cudaex.launch_counts().items() if n}
    bound = jf.bind(*args)
    with torch.no_grad():
        jf(*args)           # the entry's second call: its graph's capture
    t0 = time.perf_counter()
    for _ in range(10):
        jf.compile(*args)   # the guard key alone: a hit
    guard_us = (time.perf_counter() - t0) * 1e5
    with torch.no_grad():
        _, jit_ops = torch_calls(torch, lambda: jf(*args))
        _, eager_ops = torch_calls(torch, eager_fn)
        timing = {
            "jit_ms": device_ms(torch, lambda: jf(*args)),
            "eager_ms": device_ms(torch, eager_fn),
            "host_ms_cached_call": host_ms(torch, lambda: jf(*args)),
            "host_ms_bind_call": host_ms(torch, lambda: bound(*args)),
            "host_ms_eager_call": host_ms(torch, eager_fn),
            "guard_us": guard_us,
            "torch_calls_jit": jit_ops, "torch_calls_eager": eager_ops,
        }
        rep = jf(*args)
    stats = ptt.compile_stats(jf)
    require(stats.last_whole_program == "graph" and stats.whole_program_replays > 0,
            f"{what}: the entry ran {stats.last_whole_program}, "
            f"{stats.whole_program_replays} replays")
    require(torch.equal(rep, out), f"{what}: a replay's output differs from the first call's")
    timing["replays"] = stats.whole_program_replays
    if jf_off is not None:
        with torch.no_grad():
            off = jf_off(*args)
            require(torch.equal(off, out), f"{what}: the per-call program's output differs "
                                           f"from the replay's")
            # in turn, as default_rung times the rungs: one window of
            # JIT_TIMED calls can catch a stall of its own
            on_ms, off_ms = [], []
            for _ in range(DEFAULT_RUNG_ROUNDS):
                on_ms.append(device_ms(torch, lambda: jf(*args)))
                off_ms.extend([device_ms(torch, lambda: jf_off(*args)),
                               device_ms(torch, lambda: jf_off(*args))])
                on_ms.append(device_ms(torch, lambda: jf(*args)))
            timing["jit_ms_replay_rounds"] = statistics.median(on_ms)
            timing["jit_ms_per_call"] = statistics.median(off_ms)
            timing["host_ms_per_call"] = host_ms(torch, lambda: jf_off(*args))
            _, timing["torch_calls_per_call"] = torch_calls(torch, lambda: jf_off(*args))
        timing["replay_vs_per_call_pct"] = (
            (timing["jit_ms_replay_rounds"] - timing["jit_ms_per_call"])
            / timing["jit_ms_per_call"] * 100)
    return {"out": out, "eager": eager, "launches": launches, "eager_launches": eager_launches,
            "compile_ms": compile_ms, "compile_stages_ms": stages, "timing": timing,
            "trace_bsyms": len(ptt.last_execution_trace(jf).bound_symbols)}


def default_rung(torch, what: str, default_fn, per_op_fn) -> dict:
    """The default compile (the cost model's grad-free verdict plans the MLP
    sub-blocks) timed against the per-op rung in turn (DEFAULT_RUNG_ROUNDS
    rounds of default, per-op, per-op, default; device ms of JIT_TIMED calls
    each), compared by their medians: where the two differ by more than
    PLANNED_JIT_GAP the default must be the faster."""
    d, o = [], []
    for _ in range(DEFAULT_RUNG_ROUNDS):
        d.append(device_ms(torch, default_fn))
        o.extend([device_ms(torch, per_op_fn), device_ms(torch, per_op_fn)])
        d.append(device_ms(torch, default_fn))
    dm, om = statistics.median(d), statistics.median(o)
    gap = (dm - om) / om
    require(gap <= PLANNED_JIT_GAP,
            f"{what}: the default compile (planned) took {dm:.3f} ms against the per-op "
            f"rung's {om:.3f} ms: the grad-free verdict picked the slower rung")
    return {"default_ms": dm, "per_op_ms": om, "default_slower_by": gap,
            "default_ms_each": d, "per_op_ms_each": o}


def check_jit_kernels(torch, cudaex, tnn) -> dict:
    """Phase 3 at the slice's shapes: the norms, attention forward and
    backward (phase 20's function bridge), linear_act and ce_fwd against
    their plain versions, timed; their rows."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    rms, res = norm_rows(torch, cudaex, tnn, gen, (JIT_B, JIT_T, D))
    la = linear_act_row(torch, cudaex, tnn, gen, (JIT_B, JIT_T))
    (fwd, bwd), = attention_rows(torch, cudaex, tnn, gen, torch.bfloat16, JIT_B, 32, JIT_T,
                                 JIT_T, HD, [True])
    ce = ce_row(torch, cudaex, tnn, gen, JIT_B * JIT_T, 128256)
    return {"rms_norm": [rms], "rms_norm_residual": [res], "linear_act": [la],
            "sdpa_fwd": [fwd], "sdpa_bwd": [bwd], "ce_fwd": [ce]}


def jit_full_width(np, torch, tllama, cudaex) -> dict:
    """Phase 18 (a), (b) and (c); every check held or the phase fails."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import plain_llama_layer, row_rel_err

    t0 = time.perf_counter()
    cfg = serve_config(tllama)   # SERVE_LAYERS of 32 (the script's time)
    params = tllama.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(18)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (JIT_B, JIT_T))).cuda()
    targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (JIT_B, JIT_T))).cuda()
    L = cfg.n_layers

    # (a) the prefill's forward at the per-op rung, held to the eager per-op
    # calls; (a, default) below runs the default compile
    def forward(p, t):
        return tllama.forward(p, t, cfg)

    fwd = ptt.jit(forward, block_fusion=False)
    a = jit_run(torch, cudaex, ptt, fwd, (params, tokens),
                lambda: tllama.forward(params, tokens, cfg), "jit(forward)",
                ptt.jit(forward, block_fusion=False, whole_program_jit=False))
    want = {"rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L, "linear_act": L}
    # the regions' launches are held to the trace's regions by jit_run
    require(without_regions(a["launches"]) == want and a["eager_launches"] == want,
            f"jit(forward) launched {a['launches']}, eager {a['eager_launches']}, want {want}")
    logits, eager = a.pop("out"), a.pop("eager")
    require(tuple(logits.shape) == (JIT_B, JIT_T, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "jit(forward): logits not finite")
    a["logits_max_abs_diff"] = float((logits.float() - eager.float()).abs().max())
    a["logits_bitwise_equal"] = bool(torch.equal(logits, eager))
    require(a["logits_bitwise_equal"], f"jit(forward): logits differ from the eager forward's "
                                       f"(max {a['logits_max_abs_diff']}) where both run the "
                                       f"same calls in the same order")
    del logits, eager
    torch.cuda.empty_cache()

    # (a, default) the default compile: at these shapes the cost model's
    # grad-free verdict plans every MLP sub-block; held bit for bit to the
    # eager planned forward (the same kernels in the same order), and timed
    # against (a) in turn
    planned = {"rms_norm": L + 1, "sdpa_fwd": L, "mlp_subblock": L}
    fwd_d = ptt.jit(forward)
    ad = jit_run(torch, cudaex, ptt, fwd_d, (params, tokens),
                 lambda: tllama.forward(params, tokens, cfg, block_fusion=True),
                 "jit(forward) default", ptt.jit(forward, whole_program_jit=False))
    require(without_regions(ad["launches"]) == planned and ad["eager_launches"] == planned,
            f"jit(forward) default launched {ad['launches']}, eager planned "
            f"{ad['eager_launches']}, want {planned}")
    ad["decisions"] = decision_summary(ptt, fwd_d)
    logits, eager = ad.pop("out"), ad.pop("eager")
    ad["logits_bitwise_equal"] = bool(torch.equal(logits, eager))
    require(ad["logits_bitwise_equal"],
            f"jit(forward) default: logits differ from the eager planned forward's (max "
            f"{float((logits.float() - eager.float()).abs().max())})")
    del logits, eager
    with torch.no_grad():
        ad["rungs"] = default_rung(torch, "jit(forward)", lambda: fwd_d(params, tokens),
                                   lambda: fwd(params, tokens))
    del fwd, fwd_d
    torch.cuda.empty_cache()

    # (b) the evaluation loss
    def loss_of(p, t, y):
        return tllama.loss_fn(p, t, y, cfg)

    lossf = ptt.jit(loss_of, block_fusion=False)
    b = jit_run(torch, cudaex, ptt, lossf, (params, tokens, targets),
                lambda: tllama.loss_fn(params, tokens, targets, cfg), "jit(loss_fn)",
                ptt.jit(loss_of, block_fusion=False, whole_program_jit=False))
    want_b = dict(want, ce_fwd=1)
    require(without_regions(b["launches"]) == want_b and b["eager_launches"] == want_b,
            f"jit(loss_fn) launched {b['launches']}, eager {b['eager_launches']}, want {want_b}")
    loss, eager_loss = float(b.pop("out")), float(b.pop("eager"))
    require(math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 2.0,
            f"jit(loss_fn): loss {loss} (random weights: about ln V = "
            f"{math.log(cfg.vocab_size):.3f})")
    b["loss"], b["eager_loss"] = loss, eager_loss
    require(loss == eager_loss, f"jit(loss_fn): {loss} against the eager {eager_loss}")

    # (b, default) the default compile of the loss, as (a, default)
    lossf_d = ptt.jit(loss_of)
    bd = jit_run(torch, cudaex, ptt, lossf_d, (params, tokens, targets),
                 lambda: tllama.loss_fn(params, tokens, targets, cfg, block_fusion=True),
                 "jit(loss_fn) default", ptt.jit(loss_of, whole_program_jit=False))
    want_bd = dict(planned, ce_fwd=1)
    require(without_regions(bd["launches"]) == want_bd and bd["eager_launches"] == want_bd,
            f"jit(loss_fn) default launched {bd['launches']}, eager planned "
            f"{bd['eager_launches']}, want {want_bd}")
    bd["loss"], bd["eager_loss"] = float(bd.pop("out")), float(bd.pop("eager"))
    require(bd["loss"] == bd["eager_loss"],
            f"jit(loss_fn) default: {bd['loss']} against the eager planned {bd['eager_loss']}")
    with torch.no_grad():
        bd["rungs"] = default_rung(torch, "jit(loss_fn)",
                                   lambda: lossf_d(params, tokens, targets),
                                   lambda: lossf(params, tokens, targets))
    del lossf, lossf_d, params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a plain-PyTorch layer at llama3-8b width
    gen = torch.Generator(device="cuda").manual_seed(181)
    Dm, Fd, H, KVh = cfg.dim, cfg.intermediate_size, cfg.n_heads, cfg.kv_heads
    kv_dim = KVh * cfg.head_dim

    def dense(n_out, n_in):
        return (torch.randn(n_out, n_in, generator=gen, device="cuda") * n_in ** -0.5).to(cfg.dtype)

    def norm_w():
        return (torch.rand(Dm, generator=gen, device="cuda") + 0.5).to(cfg.dtype)

    x = torch.randn(JIT_B, JIT_T, Dm, generator=gen, device="cuda").to(cfg.dtype)
    layer = (norm_w(), dense(Dm, Dm), dense(kv_dim, Dm), dense(kv_dim, Dm), dense(Dm, Dm),
             norm_w(), dense(Fd, Dm), dense(Fd, Dm), dense(Dm, Fd))

    def plain(x, *w):
        return plain_llama_layer(x, *w, n_heads=H, n_kv=KVh)

    lay = ptt.jit(plain, block_fusion=False)
    c = jit_run(torch, cudaex, ptt, lay, (x, *layer), lambda: plain(x, *layer), "jit(layer)",
                ptt.jit(plain, block_fusion=False, whole_program_jit=False))
    want_c = {"rms_norm": 1, "sdpa_fwd": 1, "rms_norm_residual": 1, "linear_act": 1}
    require(without_regions(c["launches"]) == want_c and not c["eager_launches"],
            f"jit(layer) launched {c['launches']} (want {want_c}); eager {c['eager_launches']}")
    src = ptt.last_execution_trace(lay).python()
    require("epilogue fusion: residual add absorbed into rms_norm" in src
            and "epilogue fusion: silu epilogue fused into linear" in src,
            "jit(layer): the epilogue pass built no rms_norm_residual or linear_act")
    out, eager_out = c.pop("out"), c.pop("eager")
    require(bool(torch.isfinite(out).all()), "jit(layer): output not finite")
    c["row_rel_err"] = row_rel_err(out, eager_out)
    c["max_abs_diff"] = float((out.float() - eager_out.float()).abs().max())
    require(c["row_rel_err"] <= JIT_LAYER_TOL,
            f"jit(layer): {c['row_rel_err']} of each row's largest value against eager "
            f"PyTorch (bound {JIT_LAYER_TOL})")
    del x, layer, out, eager_out
    gc.collect()
    torch.cuda.empty_cache()
    return {"forward": a, "forward_default": ad, "loss": b, "loss_default": bd, "layer": c,
            "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 19: the compiled train step (trace-level autograd) at phase 7's cell
# ---------------------------------------------------------------------------

def jit_train_launches(L: int, remat: bool) -> dict:
    """Kernel launches of one compiled train step at L layers: phase 7's
    per-op rows, or with remat the reference's checkpointed trace's (each
    region's forward runs rms_norm twice and the lse-free attention, its
    recompute rms_norm, rms_norm_residual and sdpa_fwd)."""
    if remat:
        return {"rms_norm": 3 * L + 1, "sdpa_fwd": 2 * L, "rms_norm_residual": L,
                "sdpa_bwd": L, "ce_fwd": 1, "fused_adamw": 1}
    return train_launches(L, False)


def decision_summary(ptt, jf) -> list:
    """The last compile's block, horizontal and optimizer verdicts, grouped
    by kind, op, decision and cost numbers (proxy names left out): a count
    and the reason of each group."""
    groups: dict = {}
    for d in ptt.compile_stats(jf).last_decisions:
        if d["kind"] == "claim":
            continue
        cost = {k: v for k, v in (d["cost"] or {}).items() if k not in ("shared", "chain")}
        key = (d["kind"], d["op"], d["decision"], json.dumps(cost, sort_keys=True, default=str))
        g = groups.setdefault(key, {"kind": d["kind"], "op": d["op"], "decision": d["decision"],
                                    "count": 0, "reason": d["reason"], "cost": cost})
        g["count"] += 1
    return list(groups.values())


def replay_pairs(pairs) -> dict:
    """Each compiled step with the whole-program replay against the same
    step per call: step ms (median of steps 2-5), device busy ms a step and
    the idle share, and the replay's device ms against the per-call's."""
    out = {}
    for name, on, off in pairs:
        out[name] = {
            "step_ms_median_replay_per_call": [on["step_ms_median"], off["step_ms_median"]],
            "device_busy_ms_replay_per_call": [on["device_busy_ms_per_step"],
                                               off["device_busy_ms_per_step"]],
            "idle_share_replay_per_call": [on["device_idle_share"], off["device_idle_share"]],
            "host_ms_cached_step_replay_per_call": [on["host_ms_cached_step"],
                                                    off["host_ms_cached_step"]],
            "device_busy_replay_vs_per_call_pct": (on["device_busy_ms_per_step"]
                                                   / off["device_busy_ms_per_step"] - 1) * 100,
            "losses_equal": on["losses"] == off["losses"]}
    return out


def jit_train_run(np, torch, tllama, cudaex, pretrain, remat: bool, eager: dict,
                  block_fusion: bool | None = None, loss_rtol: float = JIT_TRAIN_LOSS_RTOL,
                  then=None, whole_program_jit: bool = True, keep_regions: str | None = None
                  ) -> dict:
    """Phase 19 (a) or, with ``remat``, (b), and with ``block_fusion=True``
    phase 21 (a): ``pretrain.jit_train_step`` from phase 7's weights, batch
    and AdamW(lr=1e-4), TRAIN_STEPS steps. Every step launches exactly the
    trace's claims (``jit_train_launches``; the planned rung's
    ``train_launches(L, True)``), the losses are finite and fall, each
    within ``loss_rtol`` of the eager step's (``eager``'s losses, same
    weights and batch), and the donated parameters and moments come back
    as the same storage. The compile's planner verdicts are reported
    (``decision_summary``). ``then(jf, holder, tok, tgt)``, where given,
    runs on the trained state before it is freed; its dict is ``then``.
    ``whole_program_jit`` is the compile's replay option (the default, on:
    step 1 runs per call, step 2 is captured, the rest replay). Every step
    launches one ``region`` a region of its trace; ``keep_regions`` keeps
    them in HELD_REGIONS under that name for phase 23."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.optim import AdamW, tree_leaves
    from thunder_tpu_torch.testing import claimed_kernels, regions_of

    what = (f"jit train step{' (remat)' if remat else ''}"
            f"{' (planned)' if block_fusion else ''}"
            f"{'' if whole_program_jit else ' (per call)'}")
    t_phase = time.perf_counter()
    cfg = tllama.CONFIGS["llama3-8b-bench"]
    params = tllama.init_params(cfg, seed=0, device="cuda", n_layers=TRAIN_LAYERS)
    opt = AdamW(lr=1e-4)
    state = opt.init(params)
    tok, tgt = (torch.from_numpy(a).cuda()
                for a in pretrain.synthetic_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 0))
    options = {} if block_fusion is None else {"block_fusion": block_fusion}
    jf = pretrain.jit_train_step(cfg, opt, remat=remat, whole_program_jit=whole_program_jit,
                                 **options)
    t0 = time.perf_counter()
    jf.compile(params, state, tok, tgt)
    compile_s = time.perf_counter() - t0
    stages = dict(ptt.compile_stats(jf).last_pass_times)
    trc = ptt.last_execution_trace(jf)
    expect = (train_launches(TRAIN_LAYERS, True) if block_fusion
              else jit_train_launches(TRAIN_LAYERS, remat))
    decisions = decision_summary(ptt, jf)
    claims = claimed_kernels(trc)
    require(without_regions(claims) == expect, f"{what}: the trace claims {claims}, "
                                               f"want {expect}")
    expect = with_region(expect, claims.get("region", 0))
    if keep_regions:
        HELD_REGIONS[keep_regions] = regions_of(trc)
    ptrs = [t.data_ptr() for t in tree_leaves((params, state["m"], state["v"]))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cudaex.reset_launch_counts()
    losses, per_step = [], []
    cur = (params, state)
    for i in range(TRAIN_STEPS):
        before = cudaex.launch_counts()
        t = time.perf_counter()
        loss, p, s = jf(*cur, tok, tgt)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = cudaex.launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        require(delta == expect, f"{what}: step {i} launched {delta}, want {expect}")
        require([t.data_ptr() for t in tree_leaves((p, s["m"], s["v"]))] == ptrs,
                f"{what}: step {i}'s parameters and moments are not the donated inputs")
        losses.append(float(loss))
        per_step.append({"loss": losses[-1], "ms": ms, "launches": delta})
        cur = (p, s)
    counts = {k: n for k, n in cudaex.launch_counts().items() if n}
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"{what}: losses not finite and falling: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, eager["losses"])]
    require(max(rel) <= loss_rtol,
            f"{what}: losses {losses} against the eager step's {eager['losses']}")
    out = {"layers": TRAIN_LAYERS, "remat": remat, "block_fusion": block_fusion,
           "losses": losses, "per_step": per_step,
           "step_ms_median": float(np.median([st["ms"] for st in per_step[1:]])),
           "compile_s": compile_s, "compile_stages_ms": stages, "launches": counts,
           "launches_per_step": expect, "trace_bsyms": len(trc.bound_symbols),
           "eager_losses": eager["losses"], "loss_rel_diff_max": max(rel),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decisions": decisions}
    holder = [cur]

    def step():
        loss, p, s = jf(*holder[0], tok, tgt)
        holder[0] = (p, s)
        return loss

    out["host_ms_cached_step"] = host_ms(torch, step)
    out["torch_calls_per_step"] = torch_calls(torch, step)[1]
    out.update(pretrain.profile_steps(step, JIT_TRAIN_PROFILE))
    out["designs"] = cudaex.design_counts()
    stats = ptt.compile_stats(jf)
    out["whole_program"] = {"entry": stats.last_whole_program,
                            "captures": stats.whole_program_captures,
                            "replays": stats.whole_program_replays,
                            "copied_bytes": stats.whole_program_copied_bytes}
    if then is not None:
        out["then"] = then(jf, holder, tok, tgt)
    del params, state, cur, p, s, holder
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def jit_train_eager_profile(torch, pretrain, block_fusion: bool = False) -> dict:
    """Phase 7's (phase 9's, with ``block_fusion``) eager step again,
    profiled beside phase 19's (21's): device ms by kernel family in the
    same run."""
    r = pretrain.run("llama3-8b-bench", layers=TRAIN_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     steps=1, lr=1e-4, seed=0, device="cuda", profile=JIT_TRAIN_PROFILE,
                     block_fusion=block_fusion, eager=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {k: r[k] for k in ("profile_step_ms", "device_busy_ms_per_step", "device_idle_share",
                              "ms_per_step_by_family", "peak_memory_gb")}


# ---------------------------------------------------------------------------
# phase 20: jit(nn.Module) and the torch-autograd bridge at phase 7's cell
# ---------------------------------------------------------------------------

MODULE_FWD = {"rms_norm": 1, "sdpa_fwd": TRAIN_LAYERS, "rms_norm_residual": 2 * TRAIN_LAYERS,
              "ce_fwd": 1}
MODULE_BWD = {"sdpa_bwd": TRAIN_LAYERS}
MODULE_EVAL = dict(MODULE_FWD, linear_act=TRAIN_LAYERS)
# the default compile's grad-free call: every MLP sub-block planned
MODULE_EVAL_PLANNED = {"rms_norm": TRAIN_LAYERS + 1, "sdpa_fwd": TRAIN_LAYERS,
                       "mlp_subblock": TRAIN_LAYERS, "ce_fwd": 1}


def counted(torch, cudaex, fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after: its output and its launches."""
    torch.cuda.synchronize()
    cudaex.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in cudaex.launch_counts().items() if n}


def check_module_kernels(torch, cudaex, tnn) -> dict:
    """linear_act at the eval path's shape (the MLP gate of 8 x 2048 rows);
    the path's other kernels are phase 3's train rows."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    return {"linear_act": [linear_act_row(torch, cudaex, tnn, gen, (TRAIN_BATCH, TRAIN_SEQ))]}


def saved_report(ptt, step) -> dict:
    """The count and bytes of what the bridge's forward saves for its
    backward, and what the min-cut would save from the same split traces
    (a trace-level figure: the bridge does not apply it)."""
    def count(fwd):
        saved = fwd.output[1]
        return len(saved), sum(math.prod(p.shape) * p.dtype.bytes for p in saved)

    fwd, bwd = step.split
    t0 = time.perf_counter()
    nf, _ = ptt.rematerialize_forward_and_backward(fwd, bwd)
    remat_s = time.perf_counter() - t0
    (n, b), (rn, rb) = count(fwd), count(nf)
    return {"saved_tensors": n, "saved_gb": b / 1e9, "mincut_saved_tensors": rn,
            "mincut_saved_gb": rb / 1e9, "mincut_s": remat_s}


def module_train_run(np, torch, tllama, cudaex, pretrain, eager: dict) -> dict:
    """Phase 20 (a) and (b): ``jit(PlainLlama)`` from phase 7's weights and
    batch, trained TRAIN_STEPS steps by ``loss.backward()`` and
    ``optim.AdamW(lr=1e-4)`` over the module's parameters and their
    ``.grad`` (the update writes the parameters in place); then the
    grad-free call. Every check held or the phase fails."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.optim import AdamW
    from thunder_tpu_torch.testing import PlainLlama, claimed_kernels, row_rel_err

    t_phase = time.perf_counter()
    cfg = tllama.CONFIGS["llama3-8b-bench"]
    module = PlainLlama.from_llama_params(
        cfg, tllama.init_params(cfg, seed=0, device="cuda", n_layers=TRAIN_LAYERS))
    gc.collect()
    tok, tgt = (torch.from_numpy(a).cuda()
                for a in pretrain.synthetic_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 0))
    # the same module run eagerly by torch autograd: the first loss and grads
    eager_loss = module(tok, tgt)
    eager_loss.backward()
    eager_loss = float(eager_loss.detach())
    eager_grads = {k: p.grad for k, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    tm = ptt.jit(module, block_fusion=False)   # the per-op rung; (b) runs the default too
    params = dict(module.named_parameters())
    opt = AdamW(lr=1e-4)
    state = opt.init(params)
    losses, per_step, grad_err = [], [], {}
    counts: dict[str, int] = {}
    step = None
    for i in range(TRAIN_STEPS):
        if i == 1:   # the eager gradients are gone: the peak is the bridge's own
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, fwd = counted(torch, cudaex, lambda: tm(tok, tgt))
        fwd_ms = (time.perf_counter() - t) * 1e3
        step = step or next(iter(tm._autograd_cache.values()))
        _, bwd = counted(torch, cudaex, loss.backward)
        if i == 0:
            for k, p in module.named_parameters():
                grad_err[k] = row_rel_err(p.grad, eager_grads[k])
            del eager_grads
            worst = max(grad_err, key=grad_err.get)
            require(grad_err[worst] <= MODULE_GRAD_TOL,
                    f"module-train: {worst}'s first .grad is {grad_err[worst]} of a row's largest "
                    f"value off eager autograd's (bound {MODULE_GRAD_TOL})")
        _, upd = counted(torch, cudaex, lambda: opt.update(
            params, {k: p.grad for k, p in params.items()}, state))
        module.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        require(fwd == claimed_kernels(step.fwd_trace) and without_regions(fwd) == MODULE_FWD,
                f"module-train: step {i}'s forward launched {fwd}, its trace claims "
                f"{claimed_kernels(step.fwd_trace)}, want {MODULE_FWD}")
        require(bwd == claimed_kernels(step.bwd_trace) and without_regions(bwd) == MODULE_BWD,
                f"module-train: step {i}'s backward launched {bwd}, its trace claims "
                f"{claimed_kernels(step.bwd_trace)}, want {MODULE_BWD}")
        require(upd == {"fused_adamw": 1}, f"module-train: step {i}'s update launched {upd}")
        for part in (fwd, bwd, upd):
            for k, n in part.items():
                counts[k] = counts.get(k, 0) + n
        losses.append(float(loss.detach()))
        per_step.append({"loss": losses[-1], "ms": ms, "forward_call_ms": fwd_ms})
        del loss
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(len(tm._autograd_cache) == 1,
            f"module-train: {len(tm._autograd_cache)} compiled pairs, want 1")
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"module-train: losses not finite and falling: {losses}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, eager["losses"])]
    require(max(rel) <= JIT_TRAIN_LOSS_RTOL,
            f"module-train: losses {losses} against phase 7's eager {eager['losses']}")
    first_rel = abs(losses[0] - eager["losses"][0]) / abs(eager["losses"][0])
    out = {"layers": TRAIN_LAYERS, "losses": losses, "per_step": per_step,
           "step_ms_median": float(np.median([st["ms"] for st in per_step[1:]])),
           "eager_losses": eager["losses"], "loss_rel_diff_max": max(rel),
           "first_loss_rel_diff": first_rel, "module_eager_first_loss": eager_loss,
           "grad_row_rel_err": grad_err, "grad_row_rel_err_max": max(grad_err.values()),
           "launches": counts, "launches_per_step": dict(MODULE_FWD, **MODULE_BWD,
                                                         fused_adamw=1),
           "peak_memory_gb_steps_2_to_5": peak, "compile_s": step.compile_s,
           "compile_stages_ms": step.pass_times,
           "trace_bsyms": [len(step.fwd_trace.bound_symbols), len(step.bwd_trace.bound_symbols)]}

    def train_step():
        loss = tm(tok, tgt)
        loss.backward()
        opt.update(params, {k: p.grad for k, p in params.items()}, state)
        module.zero_grad(set_to_none=True)
        return loss

    fwd_host = bwd_host = 0.0
    for _ in range(MODULE_HOST_ITERS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = tm(tok, tgt)
        fwd_host += time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss.backward()
        bwd_host += time.perf_counter() - t
        torch.cuda.synchronize()
        module.zero_grad(set_to_none=True)
    out["host_ms_cached_forward"] = fwd_host * 1e3 / MODULE_HOST_ITERS
    out["host_ms_cached_backward"] = bwd_host * 1e3 / MODULE_HOST_ITERS
    out["torch_calls_per_step"] = torch_calls(torch, train_step)[1]
    out.update(pretrain.profile_steps(train_step, JIT_TRAIN_PROFILE))
    out.update(saved_report(ptt, step))
    out["designs"] = cudaex.design_counts()

    # (b) the grad-free call on the same weights: its loss against the
    # bridge's forward on them
    with torch.no_grad():
        tm(tok, tgt)   # compile
        ev, launches = counted(torch, cudaex, lambda: tm(tok, tgt))
        ev = float(ev)
        eval_ms = device_ms(torch, lambda: tm(tok, tgt))
    grad_loss = float(tm(tok, tgt).detach())
    require(launches == claimed_kernels(ptt.last_execution_trace(tm))
            and without_regions(launches) == MODULE_EVAL,
            f"module-eval: launched {launches}, its trace claims "
            f"{claimed_kernels(ptt.last_execution_trace(tm))}, want {MODULE_EVAL}")
    eval_rel = abs(ev - grad_loss) / abs(grad_loss)
    require(math.isfinite(ev) and eval_rel <= JIT_TRAIN_LOSS_RTOL,
            f"module-eval: loss {ev} against the bridge's {grad_loss} on the same weights")
    evr = {"loss": ev, "bridge_loss": grad_loss, "loss_rel_diff": eval_rel, "launches": launches,
           "device_ms": eval_ms, "compile_ms": ptt.compile_stats(tm).last_pass_times}

    # (b, default) the default compile's grad-free call: the cost model's
    # forward-only verdict plans every MLP sub-block at these shapes; its
    # loss against the per-op call's on the same weights, and the two rungs
    # timed in turn
    tmd = ptt.jit(module)
    with torch.no_grad():
        tmd(tok, tgt)   # compile
        evd, launches_d = counted(torch, cudaex, lambda: tmd(tok, tgt))
        evd = float(evd)
        rungs = default_rung(torch, "module-eval", lambda: tmd(tok, tgt), lambda: tm(tok, tgt))
    require(launches_d == claimed_kernels(ptt.last_execution_trace(tmd))
            and without_regions(launches_d) == MODULE_EVAL_PLANNED,
            f"module-eval default: launched {launches_d}, its trace claims "
            f"{claimed_kernels(ptt.last_execution_trace(tmd))}, want {MODULE_EVAL_PLANNED}")
    rel_d = abs(evd - ev) / abs(ev)
    require(math.isfinite(evd) and rel_d <= PLANNED_JIT_LOSS_RTOL,
            f"module-eval default: loss {evd} against the per-op call's {ev}")
    evr["default"] = {"loss": evd, "loss_rel_diff_per_op": rel_d, "launches": launches_d,
                      "rungs": rungs, "decisions": decision_summary(ptt, tmd)}
    del module, params, state, tm, tmd, step
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return {"train": out, "eval": evr}


def fn_bridge_run(torch, cudaex, tllama) -> dict:
    """Phase 20 (c): phase 18's plain-PyTorch layer at llama3-8b width with
    x and the weights requiring grad: ``jit(layer)(...)`` then
    ``.float().square().mean().backward()`` through the function path's
    bridge, against eager torch autograd of the same function."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import claimed_kernels, plain_llama_layer, row_rel_err

    t0 = time.perf_counter()
    cfg = tllama.CONFIGS["llama3-8b"]
    gen = torch.Generator(device="cuda").manual_seed(181)
    Dm, Fd, H, KVh = cfg.dim, cfg.intermediate_size, cfg.n_heads, cfg.kv_heads
    kv_dim = KVh * cfg.head_dim

    def dense(n_out, n_in):
        return (torch.randn(n_out, n_in, generator=gen, device="cuda") * n_in ** -0.5).to(cfg.dtype)

    def norm_w():
        return (torch.rand(Dm, generator=gen, device="cuda") + 0.5).to(cfg.dtype)

    x = torch.randn(JIT_B, JIT_T, Dm, generator=gen, device="cuda").to(cfg.dtype)
    layer = (norm_w(), dense(Dm, Dm), dense(kv_dim, Dm), dense(kv_dim, Dm), dense(Dm, Dm),
             norm_w(), dense(Fd, Dm), dense(Fd, Dm), dense(Dm, Fd))
    leaves = [t.requires_grad_(True) for t in (x, *layer)]

    def plain(x, *w):
        return plain_llama_layer(x, *w, n_heads=H, n_kv=KVh)

    jf = ptt.jit(plain)
    jf(*leaves).float().square().mean().backward()   # compile and warm
    for t in leaves:
        t.grad = None
    out, fwd = counted(torch, cudaex, lambda: jf(*leaves))
    _, bwd = counted(torch, cudaex, out.float().square().mean().backward)
    step = next(iter(jf._autograd_cache.values()))
    want_f = {"rms_norm": 1, "sdpa_fwd": 1, "rms_norm_residual": 1}
    require(fwd == claimed_kernels(step.fwd_trace) and without_regions(fwd) == want_f,
            f"fn-bridge: forward launched {fwd}, want {want_f}")
    require(bwd == claimed_kernels(step.bwd_trace) and without_regions(bwd) == {"sdpa_bwd": 1},
            f"fn-bridge: backward launched {bwd}")
    got = [t.grad for t in leaves]
    for t in leaves:
        t.grad = None
    plain(*leaves).float().square().mean().backward()
    eager = [t.grad for t in leaves]
    f32 = [t.detach().float().requires_grad_(True) for t in leaves]
    plain(*f32).square().mean().backward()
    errs = {"bridge_vs_eager": [row_rel_err(a, b) for a, b in zip(got, eager)],
            "bridge_vs_f32": [row_rel_err(a, b.grad) for a, b in zip(got, f32)],
            "eager_vs_f32": [row_rel_err(a, b.grad) for a, b in zip(eager, f32)]}
    worst = max(max(errs["bridge_vs_eager"]), max(errs["bridge_vs_f32"]))
    require(worst <= MODULE_GRAD_TOL,
            f"fn-bridge: gradients {errs} of a row's largest value off eager bf16 and float32 "
            f"autograd's (bound {MODULE_GRAD_TOL})")
    launches = dict(fwd, **bwd)
    del x, layer, leaves, got, eager, f32, out, jf
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "grad_row_rel_err": errs, "compile_s": step.compile_s,
            "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 21: the planner (block, horizontal and optimizer fusion under the
# card's cost model) at phase 7's cell
# ---------------------------------------------------------------------------

def planned_quarantine(torch, cudaex):
    """Phase 21 (c), run on (a)'s trained state: with ``cuda.mlp_subblock``
    quarantined, (a)'s function recompiles (one more cache miss) to phase
    19's claims, and PLANNED_QUARANTINE_STEPS steps launch exactly them;
    the planner records each chain ``unclaimed`` (quarantined). The
    quarantine is reset after."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.runtime import quarantine
    from thunder_tpu_torch.testing import claimed_kernels

    def then(jf, holder, tok, tgt):
        misses = ptt.cache_misses(jf)
        expect = jit_train_launches(TRAIN_LAYERS, False)
        quarantine.get_quarantine().add("cuda.mlp_subblock", reason="phase 21 (c)",
                                        phase="runtime")
        try:
            losses = []
            for i in range(PLANNED_QUARANTINE_STEPS):
                torch.cuda.synchronize()
                before = cudaex.launch_counts()
                loss, p, s = jf(*holder[0], tok, tgt)
                torch.cuda.synchronize()
                now = cudaex.launch_counts()
                delta = {k: now[k] - before[k] for k in now if now[k] != before[k]}
                regions = claimed_kernels(ptt.last_execution_trace(jf)).get("region", 0)
                require(delta == with_region(expect, regions),
                        f"quarantined planned step {i} launched {delta}, want phase 19's "
                        f"{expect} and {regions} regions")
                holder[0] = (p, s)
                losses.append(float(loss))
            require(ptt.cache_misses(jf) == misses + 1,
                    f"quarantined planned step: {ptt.cache_misses(jf)} misses, want {misses + 1}")
            claims = claimed_kernels(ptt.last_execution_trace(jf))
            require(without_regions(claims) == expect,
                    f"quarantined planned step claims {claims}")
            unclaimed = [d for d in ptt.compile_stats(jf).last_decisions
                         if d["kind"] == "block" and d["decision"] == "unclaimed"]
            require(len(unclaimed) == TRAIN_LAYERS and "quarantined" in unclaimed[0]["reason"],
                    f"quarantined planned step: block verdicts {unclaimed}")
        finally:
            quarantine.reset()
        require(all(math.isfinite(x) for x in losses), f"quarantined steps' losses {losses}")
        return {"cache_misses": ptt.cache_misses(jf), "losses": losses,
                "launches_per_step": expect, "reason": unclaimed[0]["reason"]}

    return then


def module_planned_run(np, torch, tllama, cudaex, pretrain, phase20: dict) -> dict:
    """Phase 21 (d): ``jit(testing.PlainLlama, block_fusion=True)`` from
    phase 7's weights and batch, PLANNED_MODULE_STEPS steps of
    ``loss.backward()`` and AdamW(lr=1e-4): its forward, backward and
    update launch (a)'s kernels (``train_launches(L, True)``), each
    program exactly its trace's claims, and the first loss is within
    PLANNED_JIT_LOSS_RTOL of phase 20's."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.optim import AdamW
    from thunder_tpu_torch.testing import PlainLlama, claimed_kernels

    t_phase = time.perf_counter()
    L = TRAIN_LAYERS
    cfg = tllama.CONFIGS["llama3-8b-bench"]
    module = PlainLlama.from_llama_params(
        cfg, tllama.init_params(cfg, seed=0, device="cuda", n_layers=L))
    gc.collect()
    tok, tgt = (torch.from_numpy(a).cuda()
                for a in pretrain.synthetic_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 0))
    tm = ptt.jit(module, block_fusion=True)
    params = dict(module.named_parameters())
    opt = AdamW(lr=1e-4)
    state = opt.init(params)
    want_fwd = {"rms_norm": L + 1, "sdpa_fwd": L, "mlp_subblock": L, "ce_fwd": 1}
    want_bwd = {"sdpa_bwd": L, "mlp_subblock_bwd": L}
    losses, per_step, counts, step = [], [], {}, None
    for i in range(PLANNED_MODULE_STEPS):
        t = time.perf_counter()
        loss, fwd = counted(torch, cudaex, lambda: tm(tok, tgt))
        step = step or next(iter(tm._autograd_cache.values()))
        _, bwd = counted(torch, cudaex, loss.backward)
        _, upd = counted(torch, cudaex, lambda: opt.update(
            params, {k: p.grad for k, p in params.items()}, state))
        module.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        require(fwd == claimed_kernels(step.fwd_trace) and without_regions(fwd) == want_fwd,
                f"module-train-planned: step {i}'s forward launched {fwd}, its trace claims "
                f"{claimed_kernels(step.fwd_trace)}, want {want_fwd}")
        require(bwd == claimed_kernels(step.bwd_trace) and without_regions(bwd) == want_bwd,
                f"module-train-planned: step {i}'s backward launched {bwd}, its trace claims "
                f"{claimed_kernels(step.bwd_trace)}, want {want_bwd}")
        require(upd == {"fused_adamw": 1}, f"module-train-planned: step {i}'s update "
                                           f"launched {upd}")
        require(dict(without_regions(fwd), **without_regions(bwd), **upd)
                == train_launches(L, True),
                f"module-train-planned: step {i} launched {dict(fwd, **bwd, **upd)}, want (a)'s")
        for part in (fwd, bwd, upd):
            for k, n in part.items():
                counts[k] = counts.get(k, 0) + n
        losses.append(float(loss.detach()))
        per_step.append({"loss": losses[-1], "ms": ms})
        del loss
    first_rel = abs(losses[0] - phase20["losses"][0]) / abs(phase20["losses"][0])
    require(all(math.isfinite(x) for x in losses) and first_rel <= PLANNED_JIT_LOSS_RTOL,
            f"module-train-planned: losses {losses}, the first against phase 20's "
            f"{phase20['losses'][0]}")
    out = {"losses": losses, "per_step": per_step, "first_loss_rel_diff": first_rel,
           "phase20_first_loss": phase20["losses"][0], "launches": counts,
           "launches_per_step": train_launches(L, True), "compile_s": step.compile_s,
           "decisions": decision_summary(ptt, tm)}
    del module, params, state, tm, step
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def planner_verdict(jta: dict, jpa: dict) -> dict:
    """Phase 21 (b): the unset compile's (phase 19's) block verdict against
    the two rungs' measured step ms in this run; wherever they differ by
    more than PLANNED_JIT_GAP the verdict must pick the faster."""
    kinds = sorted({d["decision"] for d in jta["decisions"] if d["kind"] == "block"})
    planned = kinds == ["planned"]
    require(kinds in (["planned"], ["cost-rejected"]),
            f"phase 19's block verdicts {kinds}: want one verdict for every layer")
    per_op_ms, planned_ms = jta["step_ms_median"], jpa["step_ms_median"]
    gap = abs(per_op_ms - planned_ms) / min(per_op_ms, planned_ms)
    faster = "planned" if planned_ms < per_op_ms else "per-op"
    if gap > PLANNED_JIT_GAP:
        require(planned == (faster == "planned"),
                f"phase 21 (b): the unset compile picked the {'planned' if planned else 'per-op'} "
                f"rung, the card measured {faster} faster ({planned_ms:.2f} against "
                f"{per_op_ms:.2f} ms)")
    return {"verdict": "planned" if planned else "per-op", "faster": faster,
            "gap": gap, "held": gap > PLANNED_JIT_GAP,
            "step_ms_median_planned_per_op": [planned_ms, per_op_ms]}


def horizontal_ab(np, torch, tllama, cudaex, pretrain) -> dict:
    """Phase 21 (e): phase 19's compile, whose horizontal pass merges each
    layer's q/k/v products at 16384 rows, against the same step compiled
    with ``horizontal_fusion=False``, from phase 7's weights and batch, on
    one state: the two take steps in turn (HORIZONTAL_ROUNDS rounds of
    unset, off, off, unset), each launching phase 19's kernels. Step ms of
    each, host clock around a synchronized step."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.optim import AdamW
    from thunder_tpu_torch.testing import claimed_kernels

    cfg = tllama.CONFIGS["llama3-8b-bench"]
    params = tllama.init_params(cfg, seed=0, device="cuda", n_layers=TRAIN_LAYERS)
    opt = AdamW(lr=1e-4)
    state = opt.init(params)
    tok, tgt = (torch.from_numpy(a).cuda()
                for a in pretrain.synthetic_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 0))
    expect = jit_train_launches(TRAIN_LAYERS, False)
    jfs = {"unset": pretrain.jit_train_step(cfg, opt),
           "off": pretrain.jit_train_step(cfg, opt, horizontal_fusion=False)}
    merged, want = {}, {}
    for k, jf in jfs.items():
        jf.compile(params, state, tok, tgt)
        claims = claimed_kernels(ptt.last_execution_trace(jf))
        require(without_regions(claims) == expect,
                f"phase 21 (e) {k}: the trace claims {claims}, want {expect}")
        want[k] = with_region(expect, claims.get("region", 0))
        merged[k] = sum(1 for d in ptt.compile_stats(jf).last_decisions
                        if d["kind"] == "fusion" and d["op"] == "horizontal_merge"
                        and d["decision"] == "merged")
    require(merged["off"] == 0, f"phase 21 (e): horizontal_fusion=False merged {merged['off']}")
    cur = (params, state)
    times = {"unset": [], "off": []}
    losses = []
    for i, k in enumerate(["unset", "off"] + ["unset", "off", "off", "unset"] * HORIZONTAL_ROUNDS):
        torch.cuda.synchronize()
        before = cudaex.launch_counts()
        t = time.perf_counter()
        loss, p, st = jfs[k](*cur, tok, tgt)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        now = cudaex.launch_counts()
        delta = {n: now[n] - before[n] for n in now if now[n] != before[n]}
        require(delta == want[k], f"phase 21 (e) {k}: step {i} launched {delta}, "
                                  f"want {want[k]}")
        cur = (p, st)
        losses.append(float(loss))
        if i >= 2:   # the first step of each compiled program is a warm-up
            times[k].append(ms)
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"phase 21 (e): losses not finite and falling: {losses}")
    del params, state, cur, p, st
    gc.collect()
    torch.cuda.empty_cache()
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {"merged_groups": merged, "step_ms_median_unset_off": [med["unset"], med["off"]],
            "unset_slower_by": (med["unset"] - med["off"]) / med["off"],
            "step_ms": times, "losses": losses}


# ---------------------------------------------------------------------------
# phase 23: the region executor's generated kernels
# ---------------------------------------------------------------------------

def memory_report(torch) -> dict:
    """Where the card's memory is, after a collection: the allocator's
    allocated and reserved GB, the GB of the live CUDA tensors Python
    reaches (each storage once), the allocated GB of its private pools (the
    CUDA graphs') apart from its default pool, and the CUDA graphs alive."""
    gc.collect()
    torch.cuda.synchronize()
    storages, live, graphs = set(), 0, 0
    with warnings.catch_warnings():   # isinstance reads deprecated module attributes
        warnings.simplefilter("ignore")
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.is_cuda:
                st = o.untyped_storage()
                if st.data_ptr() not in storages:
                    storages.add(st.data_ptr())
                    live += st.nbytes()
            elif isinstance(o, torch.cuda.CUDAGraph):
                graphs += 1
    private = sum(seg["allocated_size"] for seg in torch.cuda.memory._snapshot()["segments"]
                  if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9,
            "live_tensors_gb": live / 1e9, "private_pools_allocated_gb": private / 1e9,
            "graphs_alive": graphs}


def hold_regions(torch, held: dict) -> dict:
    """Every distinct region (its source and its inputs' shapes) of the
    programs in ``held`` (path -> region callables) launched once on random
    inputs at its program's shapes and held against its plain chain on the
    same inputs: bit for bit where it holds no transcendental op, within
    REGION_ULP of the output dtype where it does. Returns the counts by
    path and the largest region (by the bytes it moves), with its path."""
    from thunder_tpu_torch.testing import hold_region, region_inputs

    gen = torch.Generator(device="cuda").manual_seed(23)
    seen, counts, largest = set(), {}, (0, None, None)
    for path, regions in held.items():
        c = counts.setdefault(path, {"regions": len(regions), "distinct": 0, "bit_identical": 0,
                                     "transcendental": 0, "max_ulp": 0})
        for r in regions:
            key = (r.spec.entry, tuple(tuple(p.shape) for p in r.inputs))
            if key in seen:
                continue
            seen.add(key)
            vals = region_inputs(r, gen, "cuda")
            h = hold_region(r, vals)
            torch.cuda.synchronize()
            require(h["ok"] and h["ulp"] <= REGION_ULP,
                    f"{path} {r.name}: {h} against its plain chain\n{r.spec.source}")
            c["distinct"] += 1
            c["bit_identical"] += h["bit_identical"]
            c["transcendental"] += h["transcendental"]
            c["max_ulp"] = max(c["max_ulp"], h["ulp"])
            nbytes = (sum(t.numel() * t.element_size() for t in vals)
                      + sum(math.prod(o.shape) * o.dtype.bytes for o in r.outputs))
            if nbytes > largest[0]:
                largest = (nbytes, path, r)
            del vals
    log(f"  regions held against their plain chains: {json.dumps(counts)}")
    return {"counts": counts, "largest": largest}


def time_region(torch, cudaex, largest: tuple) -> dict:
    """The region row of the kernels line: the largest region of phase 23
    (a) (``largest``: its bytes moved, path and callable) on random inputs,
    its kernel timed against its plain chain (the per-op chain) and its
    bound by bytes."""
    from thunder_tpu_torch.testing import region_inputs

    nbytes, path, r = largest
    gen = torch.Generator(device="cuda").manual_seed(23)
    vals = region_inputs(r, gen, "cuda")
    got, want = r(*vals), r.plain(*vals)
    err = max(float((g.to(t) - w.to(t)).abs().max())
              for g, w in zip(got, want) for t in [torch.promote_types(g.dtype, torch.float32)])
    del got, want
    row = timed_row(torch, cudaex, "region", f"{path} {list(r.shape)}", err,
                    lambda: r(*vals), lambda: r.plain(*vals), None, nbytes,
                    len(r.members) * math.prod(r.shape), F32_FLOPS)
    row["per_op_chain_ms"] = row["plain_ms"]
    row["ops"] = [b.sym.name for b in r.members]
    row["gb_moved"] = nbytes / 1e9
    del vals
    torch.cuda.empty_cache()
    return row


def trace_calls(trc) -> dict:
    """What one call of an execution trace runs, counted from its bound
    symbols: the torch executor's calls (``torch``; views among them,
    ``torch_views``, launch nothing), the ``cuda`` claims' and the regions'
    launches (a replayed graph runs the same kernels without the host
    calls)."""
    from thunder_tpu_torch.executors.eagertorch import MAY_ALIAS

    out = {"torch": 0, "torch_views": 0, "cuda": 0, "region": 0}
    for b in trc.bound_symbols:
        ex = b.sym.executor
        if b.sym.name in ("python_del", "python_return", "comment"):
            continue
        if ex is None or ex.name == "torch":
            out["torch"] += 1
            out["torch_views"] += ex is None and b.sym.id in MAY_ALIAS
        else:
            out[ex.name] = out.get(ex.name, 0) + 1
    return out


def region_ab_train(np, torch, tllama, pretrain) -> dict:
    """Phase 19 (a)'s step (llama3-8b-bench, TRAIN_LAYERS layers, B=8,
    T=2048, per-op, AdamW) compiled with the regions on and off, then phase
    15 (a)'s guarded step each way, one pair at a time (four graphs' pools
    would not fit the card beside the state), on one set of donated
    weights and state: each warmed (the capture), then REGION_AB_ROUNDS
    rounds of (on, off, off, on) turns of REGION_AB_STEPS replayed steps
    (host clock to a sync, medians); one profile of each unguarded program
    (device ms by kernel family) and what it runs a step
    (``trace_calls``). The guard's overhead each way: the guarded pair's
    median over the unguarded pair's."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.optim import AdamW
    from thunder_tpu_torch.transforms.numerics_guard import (NumericsGuardTransform,
                                                             disarmed_policy)

    cfg = tllama.CONFIGS["llama3-8b-bench"]
    params = tllama.init_params(cfg, seed=0, device="cuda", n_layers=TRAIN_LAYERS)
    opt = AdamW(lr=1e-4)
    holder = [(params, opt.init(params))]
    tok, tgt = (torch.from_numpy(a).cuda()
                for a in pretrain.synthetic_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 0))

    def stepper(jf):
        def step():
            loss, p, st = jf(*holder[0], tok, tgt)
            holder[0] = (p, st)
            return loss
        return step

    def turn(jf) -> list:
        ms, step = [], stepper(jf)
        for _ in range(REGION_AB_STEPS):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return ms

    out = {}
    for kind in ("plain", "guarded"):
        transforms = ([NumericsGuardTransform(policy=disarmed_policy())]
                      if kind == "guarded" else [])
        arms = {on: pretrain.jit_train_step(cfg, opt, block_fusion=False, transforms=transforms,
                                            region_disable_fusion=not on)
                for on in (True, False)}
        for jf in arms.values():
            for _ in range(2):
                stepper(jf)()            # per call, then the capture
        torch.cuda.synchronize()
        times = {True: [], False: []}
        for _ in range(REGION_AB_ROUNDS):
            for on in (True, False, False, True):
                times[on].extend(turn(arms[on]))
        for on, ms in times.items():
            out[f"{kind} regions {'on' if on else 'off'} step_ms"] = ms
            out[f"{kind} regions {'on' if on else 'off'} step_ms_median"] = float(np.median(ms))
        if kind == "plain":
            for on in (True, False):
                prof = pretrain.profile_steps(stepper(arms[on]), JIT_TRAIN_PROFILE)
                tag = "on" if on else "off"
                out[f"regions {tag} ms_by_family"] = prof["ms_per_step_by_family"]
                out[f"regions {tag} elementwise_ms"] = (
                    prof["ms_per_step_by_family"].get("other elementwise/copy", 0.0)
                    + prof["ms_per_step_by_family"].get("region", 0.0))
                out[f"regions {tag} device_busy_ms"] = prof["device_busy_ms_per_step"]
                out[f"regions {tag} calls_per_step"] = trace_calls(
                    ptt.last_execution_trace(arms[on]))
        arms.clear()
        gc.collect()
        torch.cuda.empty_cache()
    for tag in ("on", "off"):
        g = out[f"guarded regions {tag} step_ms_median"]
        p = out[f"plain regions {tag} step_ms_median"]
        out[f"guard_overhead_pct regions {tag}"] = (g - p) / p * 100
    del holder, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def region_ab_bench(np, torch, tllama, pretrain, bench, remat: bool, block_fusion: bool,
                    eager_ms: float) -> dict:
    """Phase 13's compiled bench step ((a) ``remat``, (b) ``block_fusion``;
    llama2-7b-bench, BENCH_LAYERS layers, fused loss, slab state) with the
    regions on and off on one set of weights and state, REGION_AB_ROUNDS
    rounds of (on, off, off, on) turns of REGION_AB_STEPS replayed steps;
    ``vs_baseline`` of each against ``eager_ms``, phase 13's eager arm."""
    cfg = tllama.CONFIGS["llama2-7b-bench"]
    opt = bench.make_opt("bf16", slab_state=True)
    params = tllama.init_params(cfg, seed=0, device="cuda", n_layers=BENCH_LAYERS)
    holder = [(params, opt.init(params))]
    tok, tgt = (torch.from_numpy(a).cuda()
                for a in pretrain.synthetic_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 0))
    arms = {on: pretrain.jit_train_step(cfg, opt, remat=remat, loss="fused",
                                        block_fusion=block_fusion, region_disable_fusion=not on)
            for on in (True, False)}

    def step(jf):
        loss, p, st = jf(*holder[0], tok, tgt)
        holder[0] = (p, st)

    for jf in arms.values():
        for _ in range(2):
            step(jf)
    torch.cuda.synchronize()
    times = {True: [], False: []}
    for _ in range(REGION_AB_ROUNDS):
        for on in (True, False, False, True):
            for _ in range(REGION_AB_STEPS):
                t = time.perf_counter()
                step(arms[on])
                torch.cuda.synchronize()
                times[on].append((time.perf_counter() - t) * 1e3)
    out = {"remat": remat, "block_fusion": block_fusion, "eager_ms": eager_ms}
    for on in (True, False):
        tag = "on" if on else "off"
        med = float(np.median(times[on]))
        out[f"regions {tag} step_ms"] = times[on]
        out[f"regions {tag} step_ms_median"] = med
        out[f"regions {tag} vs_baseline"] = eager_ms / med
    del arms, holder, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
        from thunder_tpu_torch.benchmarks import bench, pretrain, zoo
        from thunder_tpu_torch.executors import cudaex, regionex
        from thunder_tpu_torch.models import llama as tllama
        from thunder_tpu_torch.models import mixtral as tmix
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
    print(card, flush=True)
    t0 = time.perf_counter()
    compile_s = cudaex.build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in compile_s.items())})")
    failed = cudaex.build_failures()
    require(not failed, "kernels that did not build: " + "\n".join(failed.values()))

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
    log("the model zoo's kernels vs plain versions (phase 17's shapes):")
    zoo_rows = check_zoo_kernels(torch, cudaex, tnn, toptim_ops, zoo)
    log(f"card vs CPU (tiny-gqa, float32): {json.dumps(card_vs_cpu(np, torch, tllama, ServingEngine))}")

    def serve(block_fusion):
        t0 = time.perf_counter()
        params = tllama.init_params(serve_config(tllama), seed=0, device="cuda")
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
    log(f"bench sentinel_overhead_pct (remat, slab state): {ba['sentinel_overhead_pct']:.3f}% "
        f"({ba['sentinel_step_ms']:.2f} ms guarded against {ba['step_ms']:.2f} ms; "
        f"{ba['sentinel_counts']}) ({card})")
    bb = bench_full_width(torch, cudaex, bench, remat=False, block_fusion=True)
    log_train("bench full width (slab state, planned)", bb)
    for run in (ba, bb):
        require_wgmma("phase 13", run["designs"])
    log(f"bench sentinel peak memory (remat, slab state): {ba['sentinel_peak_memory_gb']:.2f} "
        f"GB guarded against {ba['peak_memory_gb']:.2f} GB ({card})")
    log("bench, remat vs planned: " + json.dumps({
        k: [ba[k], bb[k]] for k in ("step_ms", "tokens_per_s", "share_of_989_tflops",
                                    "peak_memory_gb", "baseline_step_ms", "vs_baseline",
                                    "baseline_peak_memory_gb", "compile_s", "logits_route")})
        + f" ({card})")

    rs = train_resume(np, torch, cudaex, pretrain, tllama)
    log(f"train from a token file, checkpoint and resume: {json.dumps(rs)}")

    # phase 15: the numerics guard and the kernel quarantine
    ga = guarded_train(np, torch, cudaex, pretrain, bench, tllama, toptim_ops, slab=False)
    log(f"guarded train (a), per-op: {json.dumps(ga)}")
    gb = guarded_train(np, torch, cudaex, pretrain, bench, tllama, toptim_ops, slab=True)
    log(f"guarded train (b), slab state: {json.dumps(gb)}")
    sq = serve_quarantine(np, torch, tllama, ServingEngine, cudaex, tnn)
    log(f"serving under the quarantine (d): {json.dumps(sq)} ({card})")
    qc = quarantine_card_vs_cpu(np, torch, tllama, ServingEngine, cudaex)
    log(f"quarantine card vs CPU (e, tiny-gqa, float32): {json.dumps(qc)} ({card})")
    for what, g in (("(a) per-op", ga), ("(b) slab", gb)):
        log(f"phase 15 {what}: health pass {g['health_pass_ms']:.4f} ms against its "
            f"{g['health_bound_ms']:.4f} ms bound; guarded compiled step "
            f"{g['step_ms_guarded']:.2f} ms against {g['step_ms_unguarded']:.2f} ms unguarded "
            f"({g['guard_overhead_pct']:+.3f}%), peak {g['peak_memory_gb_guarded']:.2f} GB "
            f"against {g['peak_memory_gb_unguarded']:.2f} GB ({card})")

    # phase 16: the serving fleet
    log("generate's prefill kernels vs plain versions (bf16, full width):")
    gen_rows = check_generate_kernels(torch, cudaex, tnn)
    t16 = time.perf_counter()
    fl = fleet_full_width(np, torch, tllama, ServingEngine, SamplingParams, cudaex)
    fl["phase_s"] = time.perf_counter() - t16
    log(f"serving fleet, llama3-8b full width, {FLEET_LAYERS} layers (a)-(d): "
        f"{json.dumps(fl)} ({card})")
    t16 = time.perf_counter()
    fc = fleet_card_vs_cpu(np, torch, tllama, ServingEngine, SamplingParams, cudaex)
    fc["phase_s"] = time.perf_counter() - t16
    log(f"serving fleet card vs CPU (e, tiny-gqa, float32): {json.dumps(fc)} ({card})")
    gt = fl["generate"]["timing"]
    log("phase 16: " + json.dumps({
        "ttft_ms_cold_mean": [fl[k]["ttft_ms_cold_mean"] for k in ("prefix", "prefix_planned")],
        "ttft_ms_warm_mean": [fl[k]["ttft_ms_warm_mean"] for k in ("prefix", "prefix_planned")],
        "ttft_ms_solo_cold": [fl[k]["ttft_ms_solo_cold"] for k in ("prefix", "prefix_planned")],
        "ttft_ms_solo_warm": [fl[k]["ttft_ms_solo_warm"] for k in ("prefix", "prefix_planned")],
        "best_of_peak_pages": [fl["best_of"]["peak_pages_best_of"],
                               fl["best_of"]["peak_pages_independent"]],
        "generate_prefill_ms": gt["prefill_ms"],
        "decode_tok_per_s": [gt["generate_decode_tok_per_s"],
                             gt["generate_fused_decode_tok_per_s"]],
        "generate_fused_replay_ms": gt["generate_fused_replay_ms"],
        "generate_fused_replay_tok_per_s": gt["generate_fused_replay_tok_per_s"],
        "host_ms_eager_step_vs_replay": [gt["eager_step_host_ms"], gt["replay_host_ms"]],
        "first_step_logits_row_rel_err": fl["generate"]["first_step_logits_row_rel_err"],
    }) + f" ({card})")

    # phase 17: the model zoo
    t17 = time.perf_counter()
    zc = zoo_card_vs_cpu(np, torch, cudaex, zoo, tmix)
    log(f"zoo card vs CPU (a, float32): {json.dumps(zc)} ({card})")
    zoo_runs = {"zoo-mixtral-8x7b": zoo_mixtral_full_width(torch, cudaex, zoo, tmix)}
    zm = zoo_runs["zoo-mixtral-8x7b"]
    log_zoo("zoo-mixtral-8x7b", zm, card)
    log("phase 17 (b) mixtral: " + json.dumps({
        k: zm[k] for k in ("loss_fn_no_grad", "router_aux_term", "fused_remat_loss",
                           "fused_minus_naive",
                           "fused_remat_step_ms", "fused_remat_first_step_ms",
                           "fused_remat_losses", "fused_remat_peak_memory_gb",
                           "eval_launches", "fused_launches", "expert_utilization_at_init",
                           "expert_utilization")})
        + f" ({card})")
    for path in ZOO_PATHS:
        if path != "zoo-mixtral-8x7b":
            zoo_runs[path] = zoo_full_width(torch, cudaex, zoo, path)
            log_zoo(path, zoo_runs[path], card)
    log(f"phase 17: {time.perf_counter() - t17:.1f} s")

    # phase 18: the trace compiler's grad-free slice
    log("the trace compiler's kernels vs plain versions (phase 18's shapes):")
    jit_rows = check_jit_kernels(torch, cudaex, tnn)
    jt = jit_full_width(np, torch, tllama, cudaex)
    log(f"phase 18 (jit, llama3-8b full width): {json.dumps(jt)} ({card})")

    # phase 19: the compiled train step, plain and checkpointed, each with
    # the whole-program replay (the default) and per call
    jta = jit_train_run(np, torch, tllama, cudaex, pretrain, False, tw, keep_regions="jit-train")
    log(f"phase 19 (a) jit train step: {json.dumps(jta)} ({card})")
    jta_off = jit_train_run(np, torch, tllama, cudaex, pretrain, False, tw,
                            whole_program_jit=False)
    log(f"phase 19 (a) per call: {json.dumps(jta_off)} ({card})")
    jtb = jit_train_run(np, torch, tllama, cudaex, pretrain, True, tw)
    log(f"phase 19 (b) jit train step, remat: {json.dumps(jtb)} ({card})")
    jtb_off = jit_train_run(np, torch, tllama, cudaex, pretrain, True, tw,
                            whole_program_jit=False)
    log(f"phase 19 (b) per call: {json.dumps(jtb_off)} ({card})")
    for what, on, off in (("19 (a)", jta, jta_off), ("19 (b)", jtb, jtb_off)):
        require(on["losses"] == off["losses"],
                f"phase {what}: the replayed steps' losses {on['losses']} differ from the "
                f"per-call steps' {off['losses']}")
    require(jtb["peak_memory_gb"] < jta["peak_memory_gb"],
            f"phase 19: remat's peak {jtb['peak_memory_gb']:.2f} GB is not below "
            f"{jta['peak_memory_gb']:.2f} GB")
    je = jit_train_eager_profile(torch, pretrain)
    log("phase 19: " + json.dumps({
        "step_ms_median_jit_eager_remat": [jta["step_ms_median"],
                                           float(np.median([st["ms"] for st in
                                                            tw["per_step"][1:]])),
                                           jtb["step_ms_median"]],
        "peak_gb_jit_eager_remat": [jta["peak_memory_gb"], tw["peak_memory_gb"],
                                    jtb["peak_memory_gb"]],
        "host_ms_cached_step": [jta["host_ms_cached_step"], jtb["host_ms_cached_step"]],
        "torch_calls_per_step": [jta["torch_calls_per_step"], jtb["torch_calls_per_step"]],
        "compile_s": [jta["compile_s"], jtb["compile_s"]],
        "device_ms_by_family_jit": jta["ms_per_step_by_family"],
        "device_ms_by_family_eager": je["ms_per_step_by_family"],
        "device_busy_ms_jit_eager": [jta["device_busy_ms_per_step"],
                                     je["device_busy_ms_per_step"]],
        "replay_vs_per_call": replay_pairs((("a", jta, jta_off), ("b", jtb, jtb_off))),
    }) + f" ({card})")

    # phase 20: jit(nn.Module) and the torch-autograd bridge
    log("phase 20's kernels vs plain versions (linear_act at the eval path's shape):")
    module_rows = check_module_kernels(torch, cudaex, tnn)
    mt = module_train_run(np, torch, tllama, cudaex, pretrain, tw)
    log(f"phase 20 (a) module train: {json.dumps(mt['train'])} ({card})")
    log(f"phase 20 (b) module eval: {json.dumps(mt['eval'])} ({card})")
    fb = fn_bridge_run(torch, cudaex, tllama)
    log(f"phase 20 (c) function bridge: {json.dumps(fb)} ({card})")
    mtr = mt["train"]
    log("phase 20: " + json.dumps({
        "step_ms_median_module_eager_jit": [mtr["step_ms_median"],
                                            float(np.median([st["ms"] for st in
                                                             tw["per_step"][1:]])),
                                            jta["step_ms_median"]],
        "peak_gb_module_eager_jit": [mtr["peak_memory_gb_steps_2_to_5"], tw["peak_memory_gb"],
                                     jta["peak_memory_gb"]],
        "host_ms_cached_forward_backward": [mtr["host_ms_cached_forward"],
                                            mtr["host_ms_cached_backward"]],
        "compile_s": mtr["compile_s"], "device_ms_by_family": mtr["ms_per_step_by_family"],
        "device_busy_ms": mtr["device_busy_ms_per_step"],
        "device_idle_share": mtr["device_idle_share"],
        "saved": [mtr["saved_tensors"], mtr["saved_gb"]],
        "mincut_saved": [mtr["mincut_saved_tensors"], mtr["mincut_saved_gb"]],
        "grad_row_rel_err_max": mtr["grad_row_rel_err_max"],
        "loss_rel_diff_max": mtr["loss_rel_diff_max"],
        "phase_s": mtr["phase_s"] + fb["phase_s"],
    }) + f" ({card})")

    # phase 21: the planner at phase 7's cell
    t21 = time.perf_counter()
    jpa = jit_train_run(np, torch, tllama, cudaex, pretrain, False, tp, block_fusion=True,
                        loss_rtol=PLANNED_JIT_LOSS_RTOL,
                        then=planned_quarantine(torch, cudaex))
    log(f"phase 21 (a) planned jit train step: {json.dumps(jpa)} ({card})")
    jpa_off = jit_train_run(np, torch, tllama, cudaex, pretrain, False, tp, block_fusion=True,
                            loss_rtol=PLANNED_JIT_LOSS_RTOL, whole_program_jit=False)
    log(f"phase 21 (a) per call: {json.dumps(jpa_off)} ({card})")
    require(jpa["losses"] == jpa_off["losses"],
            f"phase 21 (a): the replayed steps' losses {jpa['losses']} differ from the "
            f"per-call steps' {jpa_off['losses']}")
    jpe = jit_train_eager_profile(torch, pretrain, block_fusion=True)
    pv = planner_verdict(jta, jpa)
    log(f"phase 21 (b) the unset compile (phase 19): {json.dumps(jta['decisions'])}; "
        f"verdict {json.dumps(pv)} ({card})")
    log(f"phase 21 (c) quarantined cuda.mlp_subblock: {json.dumps(jpa['then'])} ({card})")
    mpl = module_planned_run(np, torch, tllama, cudaex, pretrain, mtr)
    log(f"phase 21 (d) jit(PlainLlama, block_fusion=True): {json.dumps(mpl)} ({card})")
    hab = horizontal_ab(np, torch, tllama, cudaex, pretrain)
    log(f"phase 21 (e) horizontal merge, unset against off: {json.dumps(hab)} ({card})")
    elementwise = "other elementwise/copy"
    log("phase 21: " + json.dumps({
        "step_ms_median_planned_jit_eager_planned_per_op_jit": [
            jpa["step_ms_median"], float(np.median([st["ms"] for st in tp["per_step"][1:]])),
            jta["step_ms_median"]],
        "elementwise_ms_planned_jit_eager_planned_per_op_jit": [
            jpa["ms_per_step_by_family"].get(elementwise),
            jpe["ms_per_step_by_family"].get(elementwise),
            jta["ms_per_step_by_family"].get(elementwise)],
        "idle_share_planned_jit_eager_planned_per_op_jit": [
            jpa["device_idle_share"], jpe["device_idle_share"], jta["device_idle_share"]],
        "peak_gb_planned_jit_eager_planned_per_op_jit": [
            jpa["peak_memory_gb"], tp["peak_memory_gb"], jta["peak_memory_gb"]],
        "compile_s_planned_per_op": [jpa["compile_s"], jta["compile_s"]],
        "compile_stages_ms_planned": jpa["compile_stages_ms"],
        "device_ms_by_family_planned_jit": jpa["ms_per_step_by_family"],
        "device_ms_by_family_eager_planned": jpe["ms_per_step_by_family"],
        "loss_rel_diff_max": jpa["loss_rel_diff_max"], "verdict": pv,
        "horizontal_step_ms_unset_off": hab["step_ms_median_unset_off"],
        "replay_vs_per_call": replay_pairs((("a", jpa, jpa_off),)),
        "phase_s": time.perf_counter() - t21,
    }) + f" ({card})")

    # phase 22: serving on jit, each rung with the whole-program replay and per call
    sj = serve_jit_full_width(np, torch, tllama, ServingEngine, SamplingParams, cudaex,
                              pretrain)
    log("phase 22: " + json.dumps({
        "verdict": sj["verdict"], "readings": sj["readings"], "phase_s": sj["phase_s"],
        **{f"{name} {mode}": {k: sj[name][mode][k] for k in (
            "rung", "decode_tok_per_s", "decode_step_ms_median", "decode_step_host_ms_median",
            "ttft_ms_mean", "decode_device_busy_ms", "decode_device_idle_share",
            "first_logits_row_rel_err_vs_generate", "launches_per_decode_step")}
           for name, _ in SERVE_JIT_RUNGS for mode in ("replay", "per_call")}}) + f" ({card})")

    # phase 23: the region executor's generated kernels
    t23 = time.perf_counter()
    log(f"phase 23: the card's memory after phase 22: {json.dumps(memory_report(torch))}")
    hr = hold_regions(torch, HELD_REGIONS)
    region_row = time_region(torch, cudaex, hr["largest"])
    log(f"phase 23 (a) every distinct region of phases 19 (a) and 22 (per-op) against its "
        f"plain chain: {json.dumps(hr['counts'])}; the largest timed: "
        f"{json.dumps(region_row)} ({card})")
    rab = region_ab_train(np, torch, tllama, pretrain)
    log(f"phase 23 (b) phase 19 (a) / 15 (a), regions on and off: {json.dumps(rab)} ({card})")
    rba = region_ab_bench(np, torch, tllama, pretrain, bench, True, False,
                          ba["baseline_step_ms"])
    log(f"phase 23 (c) phase 13 (a), regions on and off: {json.dumps(rba)} ({card})")
    rbb = region_ab_bench(np, torch, tllama, pretrain, bench, False, True,
                          bb["baseline_step_ms"])
    log(f"phase 23 (d) phase 13 (b), regions on and off: {json.dumps(rbb)} ({card})")
    log("phase 23: " + json.dumps({
        "regions_held": sum(c["distinct"] for c in hr["counts"].values()),
        "regions_bit_identical": sum(c["bit_identical"] for c in hr["counts"].values()),
        "region_max_ulp": max(c["max_ulp"] for c in hr["counts"].values()),
        "phase_19a_step_ms_on_off": [rab["plain regions on step_ms_median"],
                                     rab["plain regions off step_ms_median"]],
        "phase_19a_elementwise_ms_on_off": [rab["regions on elementwise_ms"],
                                            rab["regions off elementwise_ms"]],
        "phase_19a_calls_per_step_on_off": [rab["regions on calls_per_step"],
                                            rab["regions off calls_per_step"]],
        "phase_19a_regions_a_step": jta["launches_per_step"].get("region", 0),
        "phase_15a_guard_overhead_pct_on_off": [rab["guard_overhead_pct regions on"],
                                                rab["guard_overhead_pct regions off"]],
        "phase_13a_vs_baseline_on_off": [rba["regions on vs_baseline"],
                                         rba["regions off vs_baseline"]],
        "phase_13b_vs_baseline_on_off": [rbb["regions on vs_baseline"],
                                         rbb["regions off vs_baseline"]],
        "phase_22_decode_ms_median": sj["verdict"]["decode_step_ms_median"],
        "region_nvcc_s": regionex.nvcc_seconds(),
        "phase_s": time.perf_counter() - t23,
    }) + f" ({card})")

    # one row per kernel and main path: the path's own shape and its own
    # launch count (rms_norm and rms_norm_residual run on several paths;
    # the planned path's rows for kernels it shares with the per-op train
    # path carry the train path's timings; generate's rows are its
    # prefill's shapes, and its launches the card's)
    keys = ("name", "path", "shape", "design", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    # every compiled path launches regions: one row, phase 23's largest
    # region of phase 19 (a), under each path's own launches
    for table in (rows, train_rows, jit_rows, module_rows, sp_rows):
        table["region"] = [region_row]
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
    bench_guarded = dict(bench_rows, fused_adamw_slab_health=slab_rows["fused_adamw_slab_health"])
    # the bench's other arms, as runs of their own: their launches
    bench_arms = {"guarded": {"launches": ba["sentinel_launches"]},
                  "eager-remat": {"launches": ba["baseline_launches"]},
                  "eager-planned": {"launches": bb["baseline_launches"]}}
    for path, path_rows, run in (("serve", rows, fw), ("train", train_rows, tw),
                                 ("train-planned", planned, tp),
                                 ("bench-jit-remat", bench_rows, ba),
                                 ("bench-jit-remat-guarded", bench_guarded,
                                  bench_arms["guarded"]),
                                 ("bench-eager-remat", bench_rows, bench_arms["eager-remat"]),
                                 ("bench-jit-planned", bench_planned, bb),
                                 ("bench-eager-planned", bench_planned,
                                  bench_arms["eager-planned"]),
                                 ("serve-planned", serve_planned, fp),
                                 ("serve-subblock", {"attn_subblock": sp_rows["attn_subblock"]},
                                  sb),
                                 ("resume-jit", {name: train_rows[name]
                                                 for name in rs["launches_per_step"]}, rs),
                                 ("guard-jit", {name: train_rows[name]
                                                for name in ga["launches_per_step"]}, ga),
                                 ("guard-jit-slab", {
                                     name: slab_rows.get(name) or train_rows[name]
                                     for name in gb["launches_per_step"]}, gb),
                                 ("guard-eager", {
                                     name: train_rows[name]
                                     for name in ga["eager_guard"]["launches_per_step"]},
                                  ga["eager_guard"]),
                                 ("guard-eager-slab", {
                                     name: slab_rows.get(name) or train_rows[name]
                                     for name in gb["eager_guard"]["launches_per_step"]},
                                  gb["eager_guard"]),
                                 ("serve-quarantine", {
                                     name: sp_rows.get(name) or rows[name]
                                     for name, n in sq["launches"].items() if n}, sq),
                                 ("serve-prefix", rows, fl["prefix"]),
                                 ("serve-prefix-planned", serve_planned, fl["prefix_planned"]),
                                 ("serve-best-of", rows, fl["best_of"]),
                                 ("serve-restart-planned", serve_planned, fl["restart"]),
                                 ("generate", gen_rows, fl["generate"]),
                                 *((p, {k: [r] for k, r in zoo_rows[p].items()}, zoo_runs[p])
                                   for p in ZOO_PATHS),
                                 *((p, {k: jit_rows[k] for k in jt[run]["launches"]}, jt[run])
                                   for p, run in zip(JIT_PATHS, ("forward", "loss", "layer"))),
                                 *((p, {k: train_rows[k] for k in run["launches_per_step"]}, run)
                                   for p, run in zip(JIT_TRAIN_PATHS, (jta, jtb))),
                                 ("module-train", {k: train_rows[k]
                                                   for k in mtr["launches_per_step"]}, mtr),
                                 ("module-eval", {k: module_rows.get(k) or train_rows[k]
                                                  for k in MODULE_EVAL}, mt["eval"]),
                                 ("fn-bridge", {k: jit_rows[k] for k in fb["launches"]}, fb),
                                 *((p, planned, run) for p, run in zip(PLANNED_PATHS,
                                                                       (jpa, mpl))),
                                 *((p, {k: jit_rows.get(k) or [sp_rows["mlp_subblock"][2]]
                                        for k in run["launches"]}, run)
                                   for p, run in zip(DEFAULT_PATHS[:2], (jt["forward_default"],
                                                                         jt["loss_default"]))),
                                 (DEFAULT_PATHS[2], {k: module_rows.get(k) or planned[k]
                                                     for k in MODULE_EVAL_PLANNED},
                                  mt["eval"]["default"]),
                                 *((p, {k: serve_planned.get(k) or sp_rows.get(k) or rows[k]
                                        for k in sj[n]["replay"]["launches"]},
                                    sj[n]["replay"])
                                   for p, (n, _) in zip(SERVE_JIT_PATHS, SERVE_JIT_RUNGS))):
        path_rows = dict(path_rows)
        if run["launches"].get("region", 0):
            path_rows["region"] = [region_row]
        else:   # an eager path: no region
            path_rows.pop("region", None)
        for name, rs in path_rows.items():
            if path in (*FLEET_PATHS, *ZOO_PATHS, *JIT_PATHS, *JIT_TRAIN_PATHS, *MODULE_PATHS,
                        *PLANNED_PATHS, *DEFAULT_PATHS, *SERVE_JIT_PATHS, *BENCH_JIT_PATHS):
                require(run["launches"].get(name, 0) > 0,
                        f"{path}: {name} never launched on the main path")
            r = dict(rs[0], path=path, launches=run["launches"][name])
            if "host_launches" in run:   # generate: the graph's replays ran on the card
                r["host_launches"] = run["host_launches"][name]
            kernels.append({k: r[k] for k in keys + ("per_op_chain_ms", "host_launches")
                            if k in r})
    other_rows = [dict(r, card=card) for rs in (*rows.values(), *train_rows.values(),
                                                sp_rows["mlp_subblock"]) for r in rs[1:]]
    log("other-shape kernels: " + json.dumps(other_rows))
    zoo_paths = {p: sorted(r) for p, r in zoo_rows.items()}
    for p, names in zoo_paths.items():
        ran_names = sorted(k for k, n in zoo_runs[p]["launches"].items() if n)
        require(ran_names == names, f"{p}: launched {ran_names}, its rows {names}")
    log("C.1 inputs: " + json.dumps(c1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    # the card and the kernels line as the checker reads them: unprefixed
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
