"""The ``cuda`` executor: the claims that hand composites to the Hopper kernels.

The counterpart of the registration block of
``thunder_tpu/executors/pallasex.py`` (:2052-2162). For tensors on the card
it claims ``nn.rms_norm``, ``nn.rms_norm_residual``, ``nn.linear_act``,
``nn.sdpa_fwd``, ``nn.scaled_dot_product_attention`` (``sdpa_fwd``'s output
alone), ``nn.ce_fwd`` and ``nn.cross_entropy`` (``ce_fwd``'s rows reduced as
the composite reduces them), each under the claim id ``cuda.<kernel>`` of
the kernel it launches, the id the routers of :mod:`thunder_tpu_torch.ops.nn`
already use. A training trace adds ``nn.sdpa_bwd`` (the attention VJP's
backward, ``sdpa_bwd``) and ``optim.fused_adamw`` (the traced AdamW's
dtype bucket, ``fused_adamw``; pallasex.py:2066-2084) or
``optim.fused_adamw_slab`` (a slab-persistent bucket, ``fused_adamw_slab``;
pallasex.py:2088-2093), and a guarded one (``transforms.numerics_guard``) the
health passes ``optim.fused_adamw_health`` and
``optim.fused_adamw_slab_health`` (the kernels of the same names) and the
gated updates ``optim.fused_adamw_gated`` and ``optim.fused_adamw_slab_gated``
(claim ids ``cuda.fused_adamw`` and ``cuda.fused_adamw_slab``: the update
kernels, given the health word), and a planned one
``nn.mlp_subblock`` and ``nn.mlp_subblock_bwd`` (the block planner's unit
and its VJP rule's backward, the ``mlp_subblock`` and ``mlp_subblock_bwd``
kernels; pallasex.py:2097-2105). The update kernels write
the parameters and moments (or slabs) in place: the claim writes the donated inputs
themselves where the claim pass marks them (``passes.donate_in_place``,
``jit(donate_argnums=)``) and dense copies of the others, and returns what it
wrote. Each claimed symbol calls its kernel's router, so a launch runs behind
its kernel guard and quarantine check and adds one to ``cudaex``'s launch
count. ``nn.cross_entropy`` is the port's own claim: the reference's
Pallas executor claims only ``nn.ce_fwd``, which its trace reaches through
the cross-entropy VJP rule, so a grad-free reference trace decomposes the
loss; the port's eager loss has always run ``ce_fwd``, and so does its
traced one.

Checkers: a claim needs its tensors on the card and the conditions the
reference's checkers test in interpret mode (an attention call with a mask
or dropout, a norm over another dim, a weight of another dtype decompose as
there). The reference's TPU tiling rules have no counterpart. What a
checker takes but the kernel does not (``cudaex.refusal``, evaluated on
meta tensors of the proxies' shapes and dtypes) raises at compile time:
nothing decomposes on the card in place of a kernel.

The reference's cost-model gate of the memory-bound claims
(``_pallas_claim_profitable``, pallasex.py:2031-2048, behind its
``fusion_cost_model`` option) weighs a claim against leaving the op inside
an XLA fusion region; it comes with the port's region executor (ROADMAP
A.7.4). Until then every claim here is taken wherever its checker passes.
The sub-block and optimizer claims have no gate, as in the reference:
their passes already asked the cost model.

The serving decode (PR 19) adds ``nn.paged_decode_attention`` at T == 1
(the ``paged_decode_attention`` kernel; a prefill chunk keeps the
decomposition, pallasex.py:2120), and the block planner's decode units
``nn.attn_subblock`` and ``nn.decode_layer`` (the ``attn_subblock`` and
``decode_layer`` kernels, pallasex.py:2130-2150), which write this step's
K/V rows into the page pools: the donated pools in place
(``passes.writes_in_place``), copies of any other. Under the ``interpret``
compile option (the serving runner sets it on the CPU) the checkers take
CPU tensors too, and the claims run their routers' plain versions there,
as the reference's Pallas claims run in interpret mode.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.compile_data import get_compile_option
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.executors import OperatorExecutor, cudaex, register_executor
from thunder_tpu_torch.executors.passes import writes_in_place
from thunder_tpu_torch.ops import get_op
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.ops import optim as optim_ops

ex = OperatorExecutor("cuda")
register_executor(ex, default=True)

_ACTS = ("relu", "silu", "gelu", "gelu_tanh")


def _on_card(*ts) -> bool:
    """Every tensor on the card, or, under the ``interpret`` compile option,
    on the card or the CPU."""
    devs = {"cuda", "cpu"} if get_compile_option(
        "interpret",
        "claim the kernel composites of CPU tensors as of CUDA ones and run each through its "
        "router, whose CPU path is the kernel's plain version (the reference's Pallas "
        "interpret mode): the kernel guard's fault hooks and claim counts and the "
        "quarantine's rungs then act on the CPU as on the card", False) else {"cuda"}
    return all(t.device.type in devs for t in ts if isinstance(t, TensorProxy))


def _meta(x, dtype=None):
    """A meta tensor of a proxy's shape and dtype (None stays None), for
    ``cudaex.refusal``, which reads shapes, dtypes and strides only."""
    if x is None:
        return None
    return torch.empty(x.shape, dtype=(dtype or x.dtype).torch, device="meta")


# -- checkers (the interpret-mode conditions of pallasex's) --------------------

def _rms_checker(a, weight=None, eps=1e-5, dim=-1):
    if not _on_card(a, weight) or dim not in (-1, a.ndim - 1):
        return False
    return weight is None or (weight.ndim == 1 and weight.dtype == a.dtype)


def _rms_res_checker(residual, a, weight=None, eps=1e-5):
    if tuple(residual.shape) != tuple(a.shape) or residual.dtype != a.dtype:
        return False
    return a.dtype.bytes <= 4 and _on_card(residual) and _rms_checker(a, weight, eps)


def _linear_act_checker(a, w, bias=None, act="relu"):
    if act not in _ACTS or not _on_card(a, w, bias):
        return False
    if a.ndim < 2 or w.ndim != 2 or a.shape[-1] != w.shape[1]:
        return False
    if a.dtype != w.dtype or not a.dtype.is_float or a.dtype.bytes > 4:
        return False
    return bias is None or (bias.ndim == 1 and bias.shape[0] == w.shape[0]
                            and bias.dtype == a.dtype)


def _sdpa_checker(q, k, v, is_causal=False, scale=None):
    return _on_card(q, k, v)


def _sdpa_full_checker(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None):
    return attn_mask is None and not dropout_p and _sdpa_checker(q, k, v, is_causal, scale)


def _sdpa_bwd_checker(g, q, k, v, out, lse, is_causal=False, scale=None):
    return _sdpa_checker(q, k, v, is_causal, scale) and _on_card(g, out, lse)


def _fused_adamw_checker(params, grads, ms, vs, bc1, bc2, **hyper):
    params, grads, ms, vs = tuple(params), tuple(grads), tuple(ms), tuple(vs)
    if not params or any(len(g) != len(params) for g in (grads, ms, vs)):
        return False
    for group in (params, grads, ms, vs):
        d0 = group[0].dtype
        # one dtype a group (the optimizer buckets by dtype); float32 at most
        if any(t.dtype != d0 for t in group) or not d0.is_float or d0.bytes > 4:
            return False
    return _on_card(*params, *grads, *ms, *vs, bc1, bc2)


def _gated_checker(params, grads, ms, vs, bc1, bc2, health, **hyper):
    return _fused_adamw_checker(params, grads, ms, vs, bc1, bc2, **hyper) and _on_card(health)


def _slab_checker(params, grads, m_slab, v_slab, bc1, bc2, **hyper):
    params, grads = tuple(params), tuple(grads)
    if not params or len(grads) != len(params):
        return False
    for group in (params, grads, (m_slab,), (v_slab,)):
        d0 = group[0].dtype
        if any(t.dtype != d0 for t in group) or not d0.is_float or d0.bytes > 4:
            return False
    return _on_card(*params, *grads, m_slab, v_slab, bc1, bc2)


def _slab_gated_checker(params, grads, m_slab, v_slab, bc1, bc2, health, **hyper):
    return _slab_checker(params, grads, m_slab, v_slab, bc1, bc2, **hyper) and _on_card(health)


def _mlp_subblock_checker(residual, x, w_norm, w_gate, w_up, w_down, act="silu", eps=1e-5):
    if act not in _ACTS or w_norm is None or getattr(w_norm, "ndim", 0) != 1:
        return False
    if tuple(residual.shape) != tuple(x.shape) or residual.dtype != x.dtype:
        return False
    D = x.shape[-1]
    if w_norm.shape[0] != D or not x.dtype.is_float or x.dtype.bytes > 4:
        return False
    if any(w.dtype != x.dtype for w in (w_norm, w_gate, w_up, w_down)):
        return False
    if w_gate.ndim != 2 or tuple(w_up.shape) != tuple(w_gate.shape):
        return False
    F = w_gate.shape[0]
    if w_gate.shape[1] != D or tuple(w_down.shape) != (D, F):
        return False
    return _on_card(residual, x, w_norm, w_gate, w_up, w_down)


def _mlp_subblock_bwd_checker(g, residual, x, w_norm, w_gate, w_up, w_down, act="silu",
                              eps=1e-5):
    if tuple(g.shape) != tuple(x.shape) or g.dtype != x.dtype or not _on_card(g):
        return False
    return _mlp_subblock_checker(residual, x, w_norm, w_gate, w_up, w_down, act, eps)


def _paged_checker(q, k_pages, v_pages, block_tables, lengths, scale=None):
    # the T == 1 decode step; a prefill chunk keeps the decomposition
    return q.ndim == 4 and q.shape[2] == 1 and _on_card(q, k_pages, v_pages, block_tables,
                                                         lengths)


def _attn_subblock_checker(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                           lengths, write_pos, eps=1e-5, scale=None):
    return (h.ndim == 3 and h.shape[1] == 1 and w_norm is not None
            and _on_card(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                         lengths, write_pos))


def _decode_layer_checker(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                          block_tables, lengths, write_pos, mlp_norm, w_gate, w_up, w_down,
                          act="silu", eps=1e-5, scale=None):
    return (act in _ACTS and _attn_subblock_checker(h, attn_norm, wq, wk, wv, wo, cos, sin,
                                                    k_pages, v_pages, block_tables, lengths,
                                                    write_pos)
            and _on_card(mlp_norm, w_gate, w_up, w_down))


def _ce_checker(logits, target, ignore_index=-100):
    return logits.ndim == 2 and _on_card(logits, target)


def _cross_entropy_checker(logits, target, weight=None, ignore_index=-100, reduction="mean",
                           label_smoothing=0.0):
    return (weight is None and not label_smoothing and reduction in ("mean", "sum", "none")
            and logits.dtype.is_float and target.ndim == 1
            and _ce_checker(logits, target, ignore_index))


# -- refusals of the kernels, on meta tensors ---------------------------------

def _rms_refusal(a, weight=None, eps=1e-5, dim=-1):
    return cudaex.refusal("rms_norm", _meta(a), _meta(weight), eps)


def _rms_res_refusal(residual, a, weight=None, eps=1e-5):
    return cudaex.refusal("rms_norm_residual", _meta(residual), _meta(a), _meta(weight), eps)


def _linear_act_refusal(a, w, bias=None, act="relu"):
    return cudaex.refusal("linear_act", _meta(a), _meta(w), _meta(bias), act)


def _sdpa_refusal(q, k, v, *args, **kwargs):
    return cudaex.refusal("sdpa_fwd", _meta(q), _meta(k), _meta(v))


def _ce_refusal(logits, target, *args, **kwargs):
    return cudaex.refusal("ce_fwd", _meta(logits), _meta(target, dtypes.int64))


def _sdpa_bwd_refusal(g, q, k, v, out, lse, *args, **kwargs):
    return cudaex.refusal("sdpa_bwd", *(_meta(t) for t in (g, q, k, v, out, lse)))


def _mlp_subblock_refusal(residual, x, w_norm, w_gate, w_up, w_down, act="silu", eps=1e-5):
    return cudaex.refusal("mlp_subblock", *(_meta(t) for t in (residual, x, w_norm, w_gate,
                                                               w_up, w_down)), act, eps)


def _mlp_subblock_bwd_refusal(g, residual, x, w_norm, w_gate, w_up, w_down, act="silu",
                              eps=1e-5):
    return cudaex.refusal("mlp_subblock_bwd", *(_meta(t) for t in (g, residual, x, w_norm,
                                                                   w_gate, w_up, w_down)),
                          act, eps)


def _paged_refusal(q, k_pages, v_pages, block_tables, lengths, scale=None):
    return cudaex.refusal("paged_decode_attention", *(_meta(t) for t in (q, k_pages, v_pages,
                                                                         block_tables, lengths)))


def _attn_subblock_refusal(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                           lengths, write_pos, eps=1e-5, scale=None):
    return cudaex.refusal("attn_subblock", *(_meta(t) for t in (
        h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
        write_pos)))


def _decode_layer_refusal(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                          block_tables, lengths, write_pos, mlp_norm, w_gate, w_up, w_down,
                          act="silu", eps=1e-5, scale=None):
    return cudaex.refusal("decode_layer", *(_meta(t) for t in (
        h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
        write_pos, mlp_norm, w_gate, w_up, w_down)), act=act)


def _fused_adamw_refusal(params, grads, ms, vs, bc1, bc2, *, state_dtype=None, v_dtype=None,
                         **hyper):
    return _moments_refusal(ms, vs, state_dtype, v_dtype) or cudaex.refusal(
        "fused_adamw", *([_meta(t) for t in group] for group in (params, grads, ms, vs)),
        _bc_meta())


def _bc_meta():
    return torch.empty((2,), dtype=torch.float32, device="meta")


def _acc_meta():
    return torch.empty((3,), dtype=torch.float64, device="meta")


def _moments_refusal(ms, vs, state_dtype, v_dtype):
    if not optim_ops.moments_stored(ms, vs, state_dtype, v_dtype):
        return (f"fused_adamw: the kernel updates the moments in place in their own dtypes "
                f"({ms[0].dtype}, {vs[0].dtype}), not the optimizer's ({state_dtype}, "
                f"{v_dtype})")
    return None


def _gated_refusal(params, grads, ms, vs, bc1, bc2, health, *, state_dtype=None, v_dtype=None,
                   **hyper):
    return _moments_refusal(ms, vs, state_dtype, v_dtype) or cudaex.refusal(
        "fused_adamw", *([_meta(t) for t in group] for group in (params, grads, ms, vs)),
        _bc_meta(), health=_meta(health))


def _health_refusal(params, grads, ms, vs, bc1, bc2, *, state_dtype=None, v_dtype=None,
                    **hyper):
    return _moments_refusal(ms, vs, state_dtype, v_dtype) or cudaex.refusal(
        "fused_adamw_health", *([_meta(t) for t in group] for group in (params, grads, ms, vs)),
        _bc_meta(), _acc_meta())


def _slab_refusal(params, grads, m_slab, v_slab, bc1, bc2, health=None, *, sizes, **hyper):
    return cudaex.refusal("fused_adamw_slab", [_meta(p) for p in params],
                          [_meta(g) for g in grads], _meta(m_slab), _meta(v_slab), _bc_meta(),
                          sizes=sizes, health=_meta(health))


def _slab_health_refusal(params, grads, m_slab, v_slab, bc1, bc2, *, sizes, **hyper):
    return cudaex.refusal("fused_adamw_slab_health", [_meta(p) for p in params],
                          [_meta(g) for g in grads], _meta(m_slab), _meta(v_slab), _bc_meta(),
                          _acc_meta(), sizes=sizes)


# -- the claimed callables: the routers of ops/nn.py --------------------------

def cuda_rms_norm(a, weight=None, eps=1e-5, dim=-1):
    return tnn._rms_norm(a, weight, eps)


def cuda_rms_norm_residual(residual, a, weight=None, eps=1e-5):
    return tnn._rms_norm_residual(residual, a, weight, eps)


def cuda_linear_act(a, w, bias=None, act="relu"):
    return tnn.linear_act(a, w, bias, act)


def cuda_sdpa_fwd(q, k, v, is_causal=False, scale=None):
    return tnn.sdpa_fwd(q, k, v, is_causal, scale)


def cuda_sdpa(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None):
    # the inference path needs no lse; the operands made dense as the eager
    # scaled_dot_product_attention makes them
    return tnn.sdpa_fwd(q.contiguous(), k.contiguous(), v.contiguous(), is_causal, scale)[0]


def cuda_sdpa_bwd(g, q, k, v, out, lse, is_causal=False, scale=None):
    # the cotangent made dense, as the eager attention's backward makes it
    return tnn.sdpa_bwd(g.contiguous(), q, k, v, out, lse, is_causal, scale)


def cuda_mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, act="silu", eps=1e-5):
    return tnn.mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, act=act, eps=eps)


def cuda_mlp_subblock_bwd(g, residual, x, w_norm, w_gate, w_up, w_down, act="silu", eps=1e-5):
    # the cotangent made dense, as the eager sub-block's backward makes it
    return tnn.mlp_subblock_bwd(g.contiguous(), residual, x, w_norm, w_gate, w_up, w_down,
                                act=act, eps=eps)


def cuda_paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, scale=None):
    return tnn.paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, scale)


def _pools(k_pages, v_pages, donated):
    """The pools a decode claim writes: the donated ones themselves, dense
    copies of the others (an input that was not donated is never written)."""
    marks = donated or ((False,), (False,))
    return tuple(t if flags[0] else t.clone(memory_format=torch.contiguous_format)
                 for t, flags in zip((k_pages, v_pages), marks))


def cuda_attn_subblock(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                       lengths, write_pos, eps=1e-5, scale=None, donated=None):
    """The ``attn_subblock`` router into the pools ``passes.donate_in_place``
    marks (the donated pools themselves, else copies); returns ``(out, kp,
    vp)``, the composite's outputs."""
    kp, vp = _pools(k_pages, v_pages, donated)
    out = tnn.attn_subblock(h, w_norm, wq, wk, wv, wo, cos, sin, kp, vp, block_tables, lengths,
                            write_pos, eps=eps, scale=scale)
    return out, kp, vp


def cuda_decode_layer(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                      lengths, write_pos, mlp_norm, w_gate, w_up, w_down, act="silu", eps=1e-5,
                      scale=None, donated=None):
    """The ``decode_layer`` router, into the pools as :func:`cuda_attn_subblock`'s."""
    kp, vp = _pools(k_pages, v_pages, donated)
    out = tnn.decode_layer(h, attn_norm, wq, wk, wv, wo, cos, sin, kp, vp, block_tables,
                           lengths, write_pos, mlp_norm, w_gate, w_up, w_down, act=act, eps=eps,
                           scale=scale)
    return out, kp, vp


def _pool_targets(*args, **kwargs):
    """The groups a decode claim may write in place: each pool, in its own
    dtype."""
    return [[(args[8], args[8].dtype)], [(args[9], args[9].dtype)]]


writes_in_place(cuda_attn_subblock, _pool_targets)
writes_in_place(cuda_decode_layer, _pool_targets)


def cuda_ce_fwd(logits, target, ignore_index=-100):
    return tnn.ce_fwd(logits, target, ignore_index)


def cuda_cross_entropy(logits, target, weight=None, ignore_index=-100, reduction="mean",
                       label_smoothing=0.0):
    """``ce_fwd``'s rows reduced as the composite reduces them: the mean over
    the rows whose target is not ignored, as the eager ``cross_entropy``
    computes it. The result takes the logits' dtype, the composite's."""
    nll, _ = tnn.ce_fwd(logits, target, ignore_index)
    if reduction == "none":
        return nll.to(logits.dtype)
    total = torch.sum(nll)
    if reduction == "mean":
        total = total / torch.clamp(torch.sum((target != ignore_index).float()), min=1.0)
    return total.to(logits.dtype)


def _register(name, op_id, fn, checker, refusal, claim=None):
    sym = ex.register_operator(name, meta=get_op(op_id).meta, fn=fn,
                               id=f"cuda.{claim}" if claim else None)
    ex.register_implementation(op_id, sym, checker=checker, refusal=refusal)
    return sym


rms_norm_op = _register("rms_norm", "nn.rms_norm", cuda_rms_norm, _rms_checker, _rms_refusal)
rms_norm_residual_op = _register("rms_norm_residual", "nn.rms_norm_residual",
                                 cuda_rms_norm_residual, _rms_res_checker, _rms_res_refusal)
linear_act_op = _register("linear_act", "nn.linear_act", cuda_linear_act, _linear_act_checker,
                          _linear_act_refusal)
sdpa_fwd_op = _register("sdpa_fwd", "nn.sdpa_fwd", cuda_sdpa_fwd, _sdpa_checker, _sdpa_refusal)
sdpa_op = _register("sdpa", "nn.scaled_dot_product_attention", cuda_sdpa, _sdpa_full_checker,
                    _sdpa_refusal, claim="sdpa_fwd")
ce_fwd_op = _register("ce_fwd", "nn.ce_fwd", cuda_ce_fwd, _ce_checker, _ce_refusal)
cross_entropy_op = _register("cross_entropy", "nn.cross_entropy", cuda_cross_entropy,
                             _cross_entropy_checker, _ce_refusal, claim="ce_fwd")
sdpa_bwd_op = _register("sdpa_bwd", "nn.sdpa_bwd", cuda_sdpa_bwd, _sdpa_bwd_checker,
                        _sdpa_bwd_refusal)
fused_adamw_op = _register("fused_adamw", "optim.fused_adamw", optim_ops.fused_adamw_into,
                           _fused_adamw_checker, _fused_adamw_refusal)
fused_adamw_gated_op = _register("fused_adamw_gated", "optim.fused_adamw_gated",
                                optim_ops.fused_adamw_gated_into, _gated_checker,
                                _gated_refusal, claim="fused_adamw")
fused_adamw_health_op = _register("fused_adamw_health", "optim.fused_adamw_health",
                                 optim_ops.fused_adamw_health_into, _fused_adamw_checker,
                                 _health_refusal)
fused_adamw_slab_op = _register("fused_adamw_slab", "optim.fused_adamw_slab",
                               optim_ops.fused_adamw_slab_into, _slab_checker, _slab_refusal)
fused_adamw_slab_gated_op = _register("fused_adamw_slab_gated", "optim.fused_adamw_slab_gated",
                                     optim_ops.fused_adamw_slab_gated_into,
                                     _slab_gated_checker, _slab_refusal,
                                     claim="fused_adamw_slab")
fused_adamw_slab_health_op = _register("fused_adamw_slab_health",
                                      "optim.fused_adamw_slab_health",
                                      optim_ops.fused_adamw_slab_health_into, _slab_checker,
                                      _slab_health_refusal)
mlp_subblock_op = _register("mlp_subblock", "nn.mlp_subblock", cuda_mlp_subblock,
                            _mlp_subblock_checker, _mlp_subblock_refusal)
mlp_subblock_bwd_op = _register("mlp_subblock_bwd", "nn.mlp_subblock_bwd",
                                cuda_mlp_subblock_bwd, _mlp_subblock_bwd_checker,
                                _mlp_subblock_bwd_refusal)
paged_decode_attention_op = _register("paged_decode_attention", "nn.paged_decode_attention",
                                      cuda_paged_decode_attention, _paged_checker,
                                      _paged_refusal)
attn_subblock_op = _register("attn_subblock", "nn.attn_subblock", cuda_attn_subblock,
                             _attn_subblock_checker, _attn_subblock_refusal)
decode_layer_op = _register("decode_layer", "nn.decode_layer", cuda_decode_layer,
                            _decode_layer_checker, _decode_layer_refusal)


def kernel_of(sym) -> str | None:
    """The ``cudaex`` kernel a claimed symbol launches: its claim's, or,
    for a symbol of another executor whose callable names the kernel it
    launches (``kernel``: a generated kernel registered with
    ``cudaex.register_generated``), that one; None for any other symbol."""
    if sym.executor is ex:
        return sym.id.removeprefix("cuda.")
    if sym.executor is None:
        return None
    return getattr(sym.python_impl, "kernel", None)
