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
(``cudaex.refusal``). The decode half (``attn_subblock_cost``,
``decode_layer_cost``) comes with the serving planner (ROADMAP A.7.5), the
collective half (``bsym_us``, the ring model, ``comm_bucket_cost``) with
distributed (A.2), and the claim gate's half (``bsym_cost``,
``region_cost``, ``claim_worthwhile``) with the region executor (A.7.4).

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

def tensor_bytes(p) -> int:
    """Bytes of one tensor proxy (0 for anything else)."""
    if not isinstance(p, TensorProxy):
        return 0
    n = 1
    for s in p.shape:
        n *= int(s)
    return n * p.dtype.bytes


# -- the multi-tensor optimizer -----------------------------------------------

def fused_adamw_cost(n_tensors: int, total_bytes: int) -> dict:
    """The bytes model of one optimizer dtype bucket: estimated us of the
    per-parameter chains against one multi-tensor launch. ``total_bytes`` is
    what the update moves (g, p, m, v read; p, m, v written, each in its
    stored dtype). The returned dict is the decision log's.

    ``pack_bytes_if_unabsorbed`` is the reference's staging risk of a
    per-step bucket, computed as it computes it; the port's kernel packs no
    slab around the launch (``fused_adamw_into`` updates the tensors where
    they lie), so on the card the risk does not arise, and the verdict does
    not read it. (The slab-persistent layout, whose risk the reference
    counts apart, comes with the slab update on ``jit``, ROADMAP A.7.5.)"""
    launch = ADAMW_LAUNCH_OVERHEAD_US
    stream_us = total_bytes / (HBM_GBPS * 1e3)
    unfused = stream_us / ADAMW_CHAIN_EFFICIENCY + n_tensors * launch
    fused = stream_us / ADAMW_FUSED_EFFICIENCY + launch
    return {"tensors": n_tensors, "total_bytes": total_bytes,
            "saved_launches": max(n_tensors - 1, 0), "slab_persistent": False,
            "pack_bytes_if_unabsorbed": 2 * total_bytes, "stream_us": round(stream_us, 3),
            "est_unfused_us": round(unfused, 3), "est_fused_us": round(fused, 3),
            "est_saved_us": round(unfused - fused, 3)}


def fused_adamw_profitable(n_tensors: int, total_bytes: int) -> bool:
    """Bucket n per-parameter chains into one launch? A bucket of one never
    (nothing to share); otherwise the estimate decides."""
    if n_tensors < 2:
        return False
    c = fused_adamw_cost(n_tensors, total_bytes)
    return c["est_fused_us"] < c["est_unfused_us"]


# -- the MLP sub-block kernel -----------------------------------------------------

def subblock_cost(n_tokens: int, d_model: int, d_ff: int, dtype_bytes: int,
                  backward: bool = False) -> dict:
    """Score one MLP sub-block chain (residual add, RMS norm, gate and up
    GEMMs, activation, product, down GEMM, residual add) for the planner:
    the bytes its interior values would cost between per-op kernels, and
    the estimated us of the per-op chain and of the kernel.

    Forward (the reference's formula): the chain pays its products at the
    per-op rate and its boundary plus interior bytes; the kernel pays its
    products at its own rate, the boundary bytes and one launch. (The
    reference's ``decode=`` term, which charges a decode step's per-op
    launches, comes with the decode stages, ROADMAP A.7.5.)

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
    unfused = (flop_us / SUBBLOCK_CHAIN_EFFICIENCY
               + (boundary_bytes + interior_bytes) * bw_us_per_byte)
    fused = (flop_us / SUBBLOCK_FUSED_EFFICIENCY
             + boundary_bytes * bw_us_per_byte + launch)
    cost = {"n_tokens": n_tokens, "d_model": d_model, "d_ff": d_ff,
            "flops": flops, "backward": bool(backward),
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
