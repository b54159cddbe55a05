"""The planner's cost model: time estimates of the fusions it weighs, with
the H100's constants.

The counterpart of the half of ``thunder_tpu/core/cost_model.py`` that the
block, horizontal and optimizer passes read:

- :func:`tensor_bytes`, the bytes of one tensor proxy;
- :func:`fused_adamw_cost` / :func:`fused_adamw_profitable`: one
  multi-tensor launch against the per-parameter ``adamw_step`` chains;
- :func:`subblock_cost` / :func:`subblock_profitable`: one MLP sub-block
  kernel against its per-op chain, forward only (an inference trace, the
  reference's formula) or, with ``backward=True`` (the verdict taken before
  autodiff, which commits the VJP rule's ``mlp_subblock_bwd`` too), forward
  and backward;
- :func:`horizontal_merge_profitable`: one wide GEMM against k siblings over
  a shared operand (no constant).

Every constant is the card's: NVIDIA H100 80GB HBM3 at a 700.00 W power
limit (``nvidia-smi --query-gpu=name,power.limit``), fitted from the
kernel and per-op chain times of PERF.md §6 (``chip_smoke.py`` phase 3 and
``benchmarks/gemm_rows.py``) with this module's own flop and byte counts,
so the model returns those times at the shapes they were taken at
(``tests/test_torch_port_cost_model.py`` holds it there). The reference's
VMEM budget has no counterpart: the planner asks the kernel itself
(``cudaex.refusal``). The decode half (the serving decode step's planner):

- :func:`attn_subblock_cost`: one ``attn_subblock`` kernel against the
  per-op rung's attention half of a layer (``DECODE_UNFUSED_LAUNCHES_ATTN``
  launches);
- :func:`subblock_cost` with ``decode=True``: the MLP sub-block inside a
  decode step (``DECODE_UNFUSED_LAUNCHES_MLP`` launches);
- :func:`decode_layer_cost`: chaining the two into one ``decode_layer``.

At one token a slot the decode step is bound by bytes (the weights and the
touched pages), so these price the bytes at a fitted rate, and each launch
as a launch inside a replayed CUDA graph (``DECODE_GRAPH_LAUNCH_US``: the
serving programs replay one graph a step, so no launch pays a host call).
The reference also charges its per-op rung a gathered contiguous cache
(its decomposition of ``nn.paged_decode_attention``); the port's per-op
rung reads the pages through the ``paged_decode_attention`` kernel, so no
gathered bytes are counted. The collective half (``bsym_us``, the ring
model, ``comm_bucket_cost``) comes with distributed (A.2), and the claim
gate's half (``bsym_cost``, ``region_cost``, ``claim_worthwhile``) with the
region executor (A.7.4).

The estimates rank alternatives; they do not predict a step's time.
"""

from __future__ import annotations

from thunder_tpu_torch.core.proxies import TensorProxy

# -- the card (NVIDIA H100 80GB HBM3, 700.00 W) -------------------------------
# dense bf16 tensor-core peak (NVIDIA's data sheet, SXM part), the rate of
# every operations bound in PERF.md (reference: TPU_PEAK_FLOPS)
PEAK_FLOPS = 989e12
# HBM3 bandwidth the port's byte bounds use (chip_smoke.HBM_BYTES_PER_S;
# reference: ADAMW_HBM_GBPS, which its sub-block model also reads)
HBM_GBPS = 3350.0

# a kernel launch that moves next to nothing: rms_norm and rms_norm_residual
# at 8 rows x 4096 take 0.0030 and 0.0031 ms against bounds of 0.00004 and
# 0.00008 ms (PERF.md §6 rows 4-5; H100 80GB HBM3, 700.00 W)
SUBBLOCK_LAUNCH_OVERHEAD_US = 3.0
ADAMW_LAUNCH_OVERHEAD_US = 3.0

# fused_adamw at llama3-8b-bench's 1.1347 G-parameter bucket (bf16 params
# and grads, float32 moments: 22 bytes an element, 7.452 ms of HBM time):
# the kernel 8.312 ms, its plain per-parameter chains 67.18 ms over 39
# tensors (PERF.md §6 row 11; H100 80GB HBM3, 700.00 W)
ADAMW_FUSED_EFFICIENCY = 0.8968
ADAMW_CHAIN_EFFICIENCY = 0.1111

# the MLP sub-block at llama3-8b-bench's train shape (16384 rows, D 4096,
# F 14336, bf16; PERF.md §6 rows 7 and 8; H100 80GB HBM3, 700.00 W):
# mlp_subblock 8.498 ms, its per-op chain (rms_norm_residual, cuBLAS
# products, torch elementwise) 9.042 ms; mlp_subblock_bwd 24.32 ms, the
# chain's autograd backward 20.19 ms. The chain's rate is the reference's
# "XLA" efficiency (SUBBLOCK_XLA_EFFICIENCY): here cuBLAS and torch's
# elementwise kernels, one launch an op
SUBBLOCK_FUSED_EFFICIENCY = 0.7058
SUBBLOCK_CHAIN_EFFICIENCY = 0.7546
SUBBLOCK_BWD_FUSED_EFFICIENCY = 0.6500
SUBBLOCK_BWD_CHAIN_EFFICIENCY = 0.6458

# the decode half, fitted to PERF.md §6 row 10 (8 slots, D 4096, 32/8 heads
# of 128, 16-token pages over a 2048-token window, F 14336, bf16; H100 80GB
# HBM3, 700.00 W): attn_subblock 0.0929 ms, decode_layer 0.2522, the model
# returns them at that shape; the chains refit with the region executor on
# (chip_smoke.py phase 22's interleaved replayed steps at
# llama3-8b's cell: per-op 9.1067 ms, planned 9.8188, medians): a per-op
# layer takes decode_layer's 0.2522 less their difference over 32 layers,
# 0.2299 ms, both chain rates scaled by one factor (1.3119) from row 10's
# eager-timed chains (0.1423 and 0.3142 at 22 + 5 launches)
# a launch inside a replayed CUDA graph costs the card what a kernel that
# moves next to nothing takes (rows 4-5 at 8 rows: 0.0030, 0.0031 ms)
DECODE_GRAPH_LAUNCH_US = 3.0
# the per-op rung's launches for one layer's attention half and MLP half as
# the traced decode program runs them, a region of the region executor
# counted as one launch (tests/test_torch_port_serving_jit.py counts them):
# the attention half's norm, q/k/v products, two ropes of two launches
# each (one region of the elementwise ops that were seven launches before
# the regions, and the rotation's cat), two row scatters, paged attention
# and the out-projection; the MLP's norm (its residual add folded),
# linear_act, up, product, down
DECODE_UNFUSED_LAUNCHES_ATTN = 12
DECODE_UNFUSED_LAUNCHES_MLP = 5
# the fitted rates of the byte traffic: the kernel and the per-op chain of
# each half (refit above, from 0.6043 and 0.6907: row 10's chains
# were timed as back-to-back eager calls, so their rates carried those
# calls' host gaps): attention 151.1 MB, the MLP 352.5 MB at row 10's shape
DECODE_ATTN_FUSED_EFFICIENCY = 0.5094
DECODE_ATTN_CHAIN_EFFICIENCY = 0.7928
DECODE_MLP_FUSED_EFFICIENCY = 0.6776
DECODE_MLP_CHAIN_EFFICIENCY = 0.9061


def tensor_bytes(p) -> int:
    """Bytes of one tensor proxy (0 for anything else)."""
    if not isinstance(p, TensorProxy):
        return 0
    n = 1
    for s in p.shape:
        n *= int(s)
    return n * p.dtype.bytes


# -- the multi-tensor optimizer -----------------------------------------------

def fused_adamw_cost(n_tensors: int, total_bytes: int, slab_persistent: bool = False) -> dict:
    """The bytes model of one optimizer dtype bucket: estimated us of the
    per-parameter chains against one multi-tensor launch. ``total_bytes`` is
    what the update moves (g, p, m, v read; p, m, v written, each in its
    stored dtype). The returned dict is the decision log's.

    ``pack_bytes_if_unabsorbed`` is the reference's staging risk of a
    per-step bucket, computed as it computes it; the port's kernel packs no
    slab around the launch (``fused_adamw_into`` updates the tensors where
    they lie), so on the card the risk does not arise, and the verdict does
    not read it. ``slab_persistent`` (a bucket of
    ``AdamW(slab_persistent=True)``, whose m and v live in slabs between
    steps) zeroes that risk, as the reference does, and surfaces the p/g
    part apart (``pg_pack_bytes_if_unabsorbed``, 5/12 of it)."""
    launch = ADAMW_LAUNCH_OVERHEAD_US
    stream_us = total_bytes / (HBM_GBPS * 1e3)
    unfused = stream_us / ADAMW_CHAIN_EFFICIENCY + n_tensors * launch
    fused = stream_us / ADAMW_FUSED_EFFICIENCY + launch
    cost = {"tensors": n_tensors, "total_bytes": total_bytes,
            "saved_launches": max(n_tensors - 1, 0), "slab_persistent": bool(slab_persistent),
            "pack_bytes_if_unabsorbed": 0 if slab_persistent else 2 * total_bytes,
            "stream_us": round(stream_us, 3),
            "est_unfused_us": round(unfused, 3), "est_fused_us": round(fused, 3),
            "est_saved_us": round(unfused - fused, 3)}
    if slab_persistent:
        cost["pg_pack_bytes_if_unabsorbed"] = (2 * total_bytes) * 5 // 12
    return cost


def fused_adamw_profitable(n_tensors: int, total_bytes: int) -> bool:
    """Bucket n per-parameter chains into one launch? A bucket of one never
    (nothing to share); otherwise the estimate decides."""
    if n_tensors < 2:
        return False
    c = fused_adamw_cost(n_tensors, total_bytes)
    return c["est_fused_us"] < c["est_unfused_us"]


# -- the MLP sub-block kernel -----------------------------------------------------

def subblock_cost(n_tokens: int, d_model: int, d_ff: int, dtype_bytes: int,
                  backward: bool = False, decode: bool = False) -> dict:
    """Score one MLP sub-block chain (residual add, RMS norm, gate and up
    GEMMs, activation, product, down GEMM, residual add) for the planner:
    the bytes its interior values would cost between per-op kernels, and
    the estimated us of the per-op chain and of the kernel.

    Forward (the reference's formula): the chain pays its products at the
    per-op rate and its boundary plus interior bytes; the kernel pays its
    products at its own rate, the boundary bytes and one launch.

    ``decode=True`` (the reference's term: the chain's residual add absorbs a
    planned attention sub-block's output, so it is one layer of a T == 1
    decode step): the bytes at the decode rates fitted to row 10 and every
    launch at ``DECODE_GRAPH_LAUNCH_US``, ``DECODE_UNFUSED_LAUNCHES_MLP`` of
    them on the chain's side.

    ``backward=True`` (the verdict taken before autodiff, where planning
    commits the VJP rule's ``mlp_subblock_bwd`` as well) adds both
    backwards: the kernel's 8 products (the gate and up products recomputed,
    then dy, dW_down, dn's two, dW_gate, dW_up) at its fitted rate over its
    boundary bytes (g, residual, x read, dh written; the weights read, their
    gradients written) and a launch, against the chain's 6 products at its
    rate over the same boundary plus its interior: the forward values it
    saved (n, gate, activation, up: ``N (D + 3F)``), read once, and the
    gradients it passes between kernels (dy, d act, d gate, d up; dn and the
    norm's input gradient: ``N (4F + 2D)``), each written and read once."""
    flops = 3 * 2 * n_tokens * d_model * d_ff   # gate + up + down GEMMs
    # the interiors the per-op chain writes and reads once each: normed (N
    # D), gate pre-activation, up, their product (N F each), the down
    # projection (N D), and the residual stream h between the add and the norm
    interior_bytes = 2 * n_tokens * (3 * d_model + 3 * d_ff) * dtype_bytes
    # what both pay: residual, x and the weights in, the block's output out
    boundary_bytes = (3 * n_tokens * d_model * dtype_bytes
                      + 3 * d_model * d_ff * dtype_bytes)
    flop_us = flops / PEAK_FLOPS * 1e6
    bw_us_per_byte = 1.0 / (HBM_GBPS * 1e3)
    launch = SUBBLOCK_LAUNCH_OVERHEAD_US
    if decode:
        launch = DECODE_GRAPH_LAUNCH_US
        unfused = (flop_us / SUBBLOCK_CHAIN_EFFICIENCY
                   + (boundary_bytes + interior_bytes) * bw_us_per_byte
                   / DECODE_MLP_CHAIN_EFFICIENCY + DECODE_UNFUSED_LAUNCHES_MLP * launch)
        fused = (flop_us / SUBBLOCK_FUSED_EFFICIENCY
                 + boundary_bytes * bw_us_per_byte / DECODE_MLP_FUSED_EFFICIENCY + launch)
    else:
        unfused = (flop_us / SUBBLOCK_CHAIN_EFFICIENCY
                   + (boundary_bytes + interior_bytes) * bw_us_per_byte)
        fused = (flop_us / SUBBLOCK_FUSED_EFFICIENCY
                 + boundary_bytes * bw_us_per_byte + launch)
    cost = {"n_tokens": n_tokens, "d_model": d_model, "d_ff": d_ff,
            "flops": flops, "backward": bool(backward), "decode": bool(decode),
            "saved_boundary_bytes": interior_bytes,
            "flop_us": round(flop_us, 3),
            "boundary_us": round(boundary_bytes * bw_us_per_byte, 3)}
    if backward:
        nd_f = n_tokens * d_model * d_ff
        bwd_boundary = (4 * n_tokens * d_model + 6 * d_model * d_ff + 2 * d_model) * dtype_bytes
        bwd_interior = (5 * d_model + 11 * d_ff) * n_tokens * dtype_bytes
        kernel_us = 16 * nd_f / PEAK_FLOPS * 1e6
        chain_us = 12 * nd_f / PEAK_FLOPS * 1e6
        unfused_bwd = (chain_us / SUBBLOCK_BWD_CHAIN_EFFICIENCY
                       + (bwd_boundary + bwd_interior) * bw_us_per_byte)
        fused_bwd = (kernel_us / SUBBLOCK_BWD_FUSED_EFFICIENCY
                     + bwd_boundary * bw_us_per_byte + launch)
        cost.update({"bwd_flops": 16 * nd_f, "bwd_saved_bytes": bwd_interior,
                     "est_unfused_fwd_us": round(unfused, 3),
                     "est_fused_fwd_us": round(fused, 3),
                     "est_unfused_bwd_us": round(unfused_bwd, 3),
                     "est_fused_bwd_us": round(fused_bwd, 3)})
        unfused += unfused_bwd
        fused += fused_bwd
    cost.update({"est_unfused_us": round(unfused, 3), "est_fused_us": round(fused, 3),
                 "est_saved_us": round(unfused - fused, 3)})
    return cost


def subblock_profitable(cost: dict) -> bool:
    """Plan the chain? The estimate must save time. (Whether the kernel
    takes the chain's shapes at all is the kernel's refusal, which the
    planner asks first.)"""
    return cost["est_saved_us"] > 0.0


# -- the serving decode step's sub-blocks --------------------------------------------

def attn_subblock_cost(n_slots: int, d_model: int, n_heads: int, kv_heads: int, head_dim: int,
                       page_size: int, pages_per_request: int, dtype_bytes: int) -> dict:
    """Score one serving attention sub-block chain (T == 1 decode), the
    reference's ``attn_subblock_cost`` (cost_model.py:531) on the card: the
    products as the reference counts them, the bytes both pay (the weights,
    the slot rows, and the K/V pages of the whole block-table window), and
    the interiors the per-op chain writes and reads once each (the normed
    rows, q/k/v before and after rope, the attention output, the
    out-projection's input), each side at its fitted rate, plus its launches
    (see the module docstring)."""
    L = pages_per_request * page_size
    qkv_w = (n_heads + 2 * kv_heads) * head_dim
    flops = (2 * n_slots * d_model * qkv_w
             + 2 * n_slots * n_heads * head_dim * L * 2
             + 2 * n_slots * n_heads * head_dim * d_model)
    interior_bytes = 2 * n_slots * (2 * d_model + 2 * qkv_w + n_heads * head_dim) * dtype_bytes
    boundary_bytes = ((qkv_w * d_model + d_model * n_heads * head_dim) * dtype_bytes
                      + 2 * n_slots * d_model * dtype_bytes
                      + 2 * n_slots * kv_heads * L * head_dim * dtype_bytes)
    flop_us = flops / PEAK_FLOPS * 1e6
    bw_us_per_byte = 1.0 / (HBM_GBPS * 1e3)
    launch = DECODE_GRAPH_LAUNCH_US
    unfused = (flop_us / SUBBLOCK_CHAIN_EFFICIENCY
               + (boundary_bytes + interior_bytes) * bw_us_per_byte
               / DECODE_ATTN_CHAIN_EFFICIENCY + DECODE_UNFUSED_LAUNCHES_ATTN * launch)
    fused = (flop_us / SUBBLOCK_FUSED_EFFICIENCY
             + boundary_bytes * bw_us_per_byte / DECODE_ATTN_FUSED_EFFICIENCY + launch)
    return {"n_slots": n_slots, "d_model": d_model, "n_heads": n_heads, "kv_heads": kv_heads,
            "head_dim": head_dim, "context_window": L, "flops": flops,
            "saved_boundary_bytes": interior_bytes, "flop_us": round(flop_us, 3),
            "boundary_us": round(boundary_bytes * bw_us_per_byte, 3),
            "est_unfused_us": round(unfused, 3), "est_fused_us": round(fused, 3),
            "est_saved_us": round(unfused - fused, 3)}


def decode_layer_cost(attn_cost: dict, mlp_cost: dict, n_slots: int, d_model: int,
                      page_size: int, dtype_bytes: int) -> dict:
    """Score chaining a planned attention sub-block with its MLP sub-block
    into one ``decode_layer`` launch (the reference's ``decode_layer_cost``,
    cost_model.py:581): on top of the parts' savings, one launch fewer and
    the residual rows between the two never round-trip the card's memory.
    ``est_unfused_us`` is the two per-op halves', ``est_fused_us`` the one
    launch's."""
    h2_roundtrip = 2 * n_slots * d_model * dtype_bytes
    saved = DECODE_GRAPH_LAUNCH_US + h2_roundtrip / (HBM_GBPS * 1e3)
    unfused = attn_cost["est_unfused_us"] + mlp_cost["est_unfused_us"]
    est_saved = attn_cost["est_saved_us"] + mlp_cost["est_saved_us"] + saved
    return {"n_slots": n_slots, "d_model": d_model, "d_ff": mlp_cost["d_ff"],
            "context_window": attn_cost["context_window"],
            "saved_boundary_bytes": h2_roundtrip, "saved_launches": 1,
            "est_unfused_us": round(unfused, 3), "est_fused_us": round(unfused - est_saved, 3),
            "est_saved_us": round(est_saved, 3)}


# -- horizontal GEMM merging -----------------------------------------------------

def horizontal_merge_profitable(m_tokens: int, out_features) -> bool:
    """Merge k sibling GEMMs (M x K)(K x N_i) into one (M x K)(K x sum N_i)?

    Split: k reads of the M x K activation and sum N_i K weights. Merged:
    one read of the activation, the weights, and a write of the
    concatenated weight (sum N_i K, made anew each step: weights are trace
    inputs). A win when (k - 1) M > sum N_i: K and the element size cancel,
    so the rule holds on any card."""
    outs = list(out_features)
    if len(outs) < 2:
        return False
    return m_tokens * (len(outs) - 1) > sum(outs)
