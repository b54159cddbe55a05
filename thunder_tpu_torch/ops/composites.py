"""The nn composites of the port's traces.

The counterparts of the composites of ``thunder_tpu/ops/nn.py``, each a
Symbol with the reference's stable id and its decomposition into ops:
:func:`embedding` (``nn.embedding``, :23), :func:`one_hot` (:31),
:func:`layer_norm` (:41),
:func:`rms_norm` (:61), :func:`rms_norm_residual` (:73), :func:`linear_act`
(:101), :func:`mlp_subblock` (:115), :func:`mlp_subblock_bwd` (:148),
:func:`dropout` (:241), :func:`mse_loss` (:251),
:func:`cross_entropy` (:263), :func:`sdpa_fwd` (:297), :func:`ce_fwd`
(:321), :func:`sdpa_bwd` (:336), the serving decode's
:func:`paged_decode_attention` (:367), :func:`decode_row_write` (:447, a
helper emitting ``prims.scatter``), :func:`attn_subblock` (:469) and
:func:`decode_layer` (:530), and :func:`scaled_dot_product_attention`
(:590), with the reference's VJP rules of attention (``_sdpa_vjp``, :642),
the RMS norm (``_rms_norm_vjp``, :658), the MLP sub-block
(``_mlp_subblock_vjp``, :697) and cross-entropy (``_cross_entropy_vjp``,
:763): attention differentiates into ``nn.sdpa_fwd`` and ``nn.sdpa_bwd``,
the sub-block into ``nn.mlp_subblock`` and ``nn.mlp_subblock_bwd``,
cross-entropy into ``nn.ce_fwd`` and the one-hot pullback, and the norm
stays one ``nn.rms_norm`` with a plain pullback. Each rule declines
(``NotImplemented``) what the reference's declines, and that call is
differentiated through its decomposition. The reference's rules of the fp8
linear and the chunked loss wait for their items (ROADMAP A.5, A.7.5).

They live beside the eager routers of :mod:`thunder_tpu_torch.ops.nn`, which
carry the same names: under ``jit`` a router called on traced tensors
records the composite here, and :mod:`~thunder_tpu_torch.executors.cudaex_claims`
hands the claimed composites of CUDA tensors back to those routers' kernels.
Unclaimed (on the CPU, or refused by a checker such as an explicit
attention mask), each decomposes exactly as the reference's does.
"""

from __future__ import annotations

import math

from thunder_tpu_torch import ops
from thunder_tpu_torch.core import dtypes, prims
from thunder_tpu_torch.core.baseutils import canonicalize_dim, check
from thunder_tpu_torch.core.proxies import pyval
from thunder_tpu_torch.ops import _tensor_like, opsymbol

_HALF = (dtypes.float16, dtypes.bfloat16)


@opsymbol(id="nn.embedding")
def embedding(ids, weight, padding_idx=None):
    check(weight.ndim == 2, lambda: f"embedding: weight must be (num_embeddings, dim), got "
                                    f"{weight.ndim}-D {tuple(weight.shape)}")
    return prims.take(weight, ids, 0)


@opsymbol(id="nn.one_hot")
def one_hot(ids, num_classes: int):
    check(int(num_classes) > 0, lambda: f"one_hot: num_classes must be positive, got {num_classes}")
    classes = prims.iota(num_classes, dtype=dtypes.int32, device=ids.device)
    classes = ops.expand_to(classes, ids.shape + (num_classes,))
    expanded = ops.expand_to(ops.unsqueeze(ids, -1), ids.shape + (num_classes,))
    return ops.convert_element_type(ops.eq(expanded, classes), dtypes.int32)


@opsymbol(id="nn.layer_norm")
def layer_norm(a, normalized_shape, weight=None, bias=None, eps: float = 1e-5):
    _tensor_like(a, "layer_norm")
    nd = len(normalized_shape)
    check(tuple(a.shape[-nd:]) == tuple(normalized_shape),
          lambda: f"layer_norm: normalized_shape {normalized_shape} != trailing dims of {a.shape}")
    dims = tuple(range(a.ndim - nd, a.ndim))
    x = ops.convert_element_type(a, dtypes.float32) if a.dtype in _HALF else a
    m = ops.mean(x, dims, keepdim=True)
    centered = ops.sub(x, m)
    v = ops.mean(ops.mul(centered, centered), dims, keepdim=True)
    out = ops.mul(centered, ops.rsqrt(ops.add(v, eps)))
    if weight is not None:
        out = ops.mul(out, weight)
    if bias is not None:
        out = ops.add(out, bias)
    return ops.convert_element_type(out, a.dtype)


@opsymbol(id="nn.rms_norm")
def rms_norm(a, weight=None, eps: float = 1e-5, dim: int = -1):
    d = canonicalize_dim(a.ndim, dim)
    x = ops.convert_element_type(a, dtypes.float32) if a.dtype in _HALF else a
    ms = ops.mean(ops.mul(x, x), d, keepdim=True)
    out = ops.mul(x, ops.rsqrt(ops.add(ms, eps)))
    out = ops.convert_element_type(out, a.dtype)
    if weight is not None:
        out = ops.mul(out, weight)
    return out


@opsymbol(id="nn.rms_norm_residual")
def rms_norm_residual(residual, a, weight=None, eps: float = 1e-5):
    """Fused residual add and RMS norm: ``h = residual + a``, then
    ``rms_norm(h, weight)``; returns ``(h, normed)``."""
    _tensor_like(a, "rms_norm_residual")
    check(tuple(residual.shape) == tuple(a.shape),
          lambda: f"rms_norm_residual: residual shape {tuple(residual.shape)} "
                  f"!= input shape {tuple(a.shape)}")
    h = ops.add(residual, a)
    return h, rms_norm(h, weight, eps=eps)


_LINEAR_ACT_FNS = {
    "relu": lambda y: ops.relu(y),
    "silu": lambda y: ops.silu(y),
    "gelu": lambda y: ops.gelu(y),
    "gelu_tanh": lambda y: ops.gelu(y, approximate="tanh"),
}


@opsymbol(id="nn.linear_act")
def linear_act(a, w, bias=None, act: str = "relu"):
    """Fused ``act(a @ w.T + bias)``, the composite the epilogue pass builds
    from ``nn.linear`` followed by an activation."""
    check(act in _LINEAR_ACT_FNS,
          lambda: f"linear_act: unknown activation {act!r}; known: {sorted(_LINEAR_ACT_FNS)}")
    return _LINEAR_ACT_FNS[act](ops.linear(a, w, bias))


_SUBBLOCK_ACTS = ("silu", "relu", "gelu", "gelu_tanh")


@opsymbol(id="nn.mlp_subblock")
def mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, *, act: str = "silu",
                 eps: float = 1e-5):
    """The whole transformer MLP sub-block as one composite, the block
    planner's unit::

        h   = residual + x
        n   = rms_norm(h, w_norm)
        out = h + (act(n @ w_gate.T) * (n @ w_up.T)) @ w_down.T

    The decomposition is the unfused chain. The ``cuda`` executor claims it
    as the ``mlp_subblock`` kernel; the torch executor runs it whole
    through ``mlp_subblock_plain`` off the card. The VJP rule saves only
    the inputs, and the backward is ``nn.mlp_subblock_bwd``."""
    _tensor_like(x, "mlp_subblock")
    check(tuple(residual.shape) == tuple(x.shape) and residual.dtype == x.dtype,
          lambda: f"mlp_subblock: residual {tuple(residual.shape)}/{residual.dtype} "
                  f"does not match x {tuple(x.shape)}/{x.dtype}")
    check(act in _SUBBLOCK_ACTS,
          lambda: f"mlp_subblock: unknown activation {act!r}; known: {_SUBBLOCK_ACTS}")
    h = ops.add(residual, x)
    n = rms_norm(h, w_norm, eps=eps)
    gate = _LINEAR_ACT_FNS[act](ops.linear(n, w_gate))
    up = ops.linear(n, w_up)
    return ops.add(h, ops.linear(ops.mul(gate, up), w_down))


def _act_grad(act: str, a):
    """d act(a) / d a, in ``a``'s dtype."""
    if act == "relu":
        return ops.convert_element_type(ops.gt(a, 0.0), a.dtype)
    if act == "silu":
        sig = ops.sigmoid(a)
        return ops.mul(sig, ops.add(1.0, ops.mul(a, ops.sub(1.0, sig))))
    if act == "gelu":
        # Phi(a) + a phi(a)
        phi_cdf = ops.mul(ops.add(ops.erf(ops.mul(a, 1.0 / math.sqrt(2.0))), 1.0), 0.5)
        pdf = ops.mul(ops.exp(ops.mul(ops.mul(a, a), -0.5)), 1.0 / math.sqrt(2.0 * math.pi))
        return ops.add(phi_cdf, ops.mul(a, pdf))
    check(act == "gelu_tanh", lambda: f"_act_grad: unknown activation {act!r}")
    c = math.sqrt(2.0 / math.pi)
    a2 = ops.mul(a, a)
    u = ops.mul(ops.add(a, ops.mul(ops.mul(a2, a), 0.044715)), c)
    t = ops.tanh(u)
    sech2 = ops.sub(1.0, ops.mul(t, t))
    du = ops.mul(ops.add(1.0, ops.mul(a2, 3.0 * 0.044715)), c)
    return ops.add(ops.mul(ops.add(t, 1.0), 0.5),
                   ops.mul(ops.mul(ops.mul(a, sech2), du), 0.5))


@opsymbol(id="nn.mlp_subblock_bwd")
def mlp_subblock_bwd(g, residual, x, w_norm, w_gate, w_up, w_down, *, act: str = "silu",
                     eps: float = 1e-5):
    """The backward of :func:`mlp_subblock` from its inputs alone (the
    interiors recomputed): ``(dh, dw_norm, dw_gate, dw_up, dw_down)``, where
    ``dh`` is the gradient of both ``residual`` and ``x``. The ``cuda``
    executor claims it as the ``mlp_subblock_bwd`` kernel; the torch
    executor runs it whole through ``mlp_subblock_bwd_plain`` off the card;
    unclaimed, this decomposition is the chain rule over the unfused ops."""
    check(act in _SUBBLOCK_ACTS, lambda: f"mlp_subblock_bwd: unknown activation {act!r}")
    dt = x.dtype
    wide = dtypes.float32 if dt in _HALF else dt
    h = ops.add(residual, x)
    h32 = ops.convert_element_type(h, wide)
    ms = ops.mean(ops.mul(h32, h32), -1, keepdim=True)
    r = ops.rsqrt(ops.add(ms, eps))
    xhat = ops.mul(h32, r)   # the normalized rows, before the weight
    n = ops.mul(ops.convert_element_type(xhat, dt), w_norm)
    gpre = ops.linear(n, w_gate)
    ga = _LINEAR_ACT_FNS[act](gpre)
    up = ops.linear(n, w_up)
    y = ops.mul(ga, up)

    g32 = ops.convert_element_type(g, wide)
    # out = h + y @ w_down.T
    dy = ops.convert_element_type(
        prims.dot_general(g, w_down, contract_dims=((g.ndim - 1,), (0,))), dt)
    N = 1
    for d in g.shape[:-1]:
        N *= int(d)
    g2 = ops.reshape(g, (N, g.shape[-1]))
    y2 = ops.reshape(y, (N, y.shape[-1]))
    dw_down = ops.convert_element_type(
        prims.dot_general(g2, y2, contract_dims=((0,), (0,)), preferred_element_type=wide),
        w_down.dtype)
    dga = ops.mul(dy, up)
    dup = ops.mul(dy, ga)
    dgpre = ops.mul(dga, _act_grad(act, gpre))
    # dn = dgpre @ w_gate + dup @ w_up
    dn = ops.add(
        prims.dot_general(dgpre, w_gate, contract_dims=((dgpre.ndim - 1,), (0,))),
        prims.dot_general(dup, w_up, contract_dims=((dup.ndim - 1,), (0,))))
    dgpre2 = ops.reshape(dgpre, (N, dgpre.shape[-1]))
    dup2 = ops.reshape(dup, (N, dup.shape[-1]))
    n2 = ops.reshape(n, (N, n.shape[-1]))
    dw_gate = ops.convert_element_type(
        prims.dot_general(dgpre2, n2, contract_dims=((0,), (0,)), preferred_element_type=wide),
        w_gate.dtype)
    dw_up = ops.convert_element_type(
        prims.dot_general(dup2, n2, contract_dims=((0,), (0,)), preferred_element_type=wide),
        w_up.dtype)
    # the RMS norm's backward (the nn.rms_norm rule's formula)
    dn32 = ops.convert_element_type(dn, wide)
    lead = tuple(range(x.ndim - 1))
    dwn = ops.mul(dn32, xhat) if not lead else ops.sum(ops.mul(dn32, xhat), lead)
    dw_norm = ops.convert_element_type(dwn, w_norm.dtype)
    gxhat = ops.mul(dn32, ops.convert_element_type(w_norm, wide))
    proj = ops.mean(ops.mul(gxhat, xhat), -1, keepdim=True)
    dh_norm = ops.mul(r, ops.sub(gxhat, ops.mul(xhat, proj)))
    dh = ops.convert_element_type(ops.add(g32, dh_norm), dt)
    return dh, dw_norm, dw_gate, dw_up, dw_down


@opsymbol(id="nn.dropout")
def dropout(a, p: float = 0.5, training: bool = True):
    p = float(pyval(p))
    if not training or p == 0.0:
        return a
    raise NotImplementedError("dropout with p > 0 in training needs the traced RNG, which is "
                              "not ported yet (ROADMAP A.7)")


@opsymbol(id="nn.mse_loss")
def mse_loss(input, target, reduction: str = "mean"):
    d = ops.sub(input, target)
    sq = ops.mul(d, d)
    if reduction == "mean":
        return ops.mean(sq)
    if reduction == "sum":
        return ops.sum(sq)
    return sq


@opsymbol(id="nn.cross_entropy")
def cross_entropy(logits, target, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", label_smoothing: float = 0.0):
    """logits (N, C) or (N, C, ...); target (N, ...) integer class ids."""
    check(weight is None, "cross_entropy: class weights not yet supported")
    C = logits.shape[1] if logits.ndim > 1 else logits.shape[0]
    expect = (logits.shape[0],) + tuple(logits.shape[2:]) if logits.ndim > 1 else ()
    check(tuple(target.shape) == expect,
          lambda: f"cross_entropy: target shape {tuple(target.shape)} does not match "
                  f"logits {tuple(logits.shape)}: expected {expect}")
    if logits.ndim > 2:
        perm = (0,) + tuple(range(2, logits.ndim)) + (1,)
        logits = ops.reshape(ops.transpose(logits, perm), (-1, C))
        target = ops.reshape(target, (-1,))
    logp = ops.log_softmax(logits, -1)
    tgt = ops.convert_element_type(target, dtypes.int64)
    safe_tgt = ops.where(ops.eq(tgt, ignore_index), ops.zeros_like(tgt), tgt)
    picked = ops.squeeze(prims.take_along_axis(logp, ops.unsqueeze(safe_tgt, -1), 1), (1,))
    nll = ops.neg(picked)
    if label_smoothing > 0.0:
        smooth = ops.neg(ops.mean(logp, -1))
        nll = ops.add(ops.mul(nll, 1.0 - label_smoothing), ops.mul(smooth, label_smoothing))
    valid = ops.ne(tgt, ignore_index)
    nll = ops.where(valid, nll, ops.zeros_like(nll))
    if reduction == "none":
        return nll
    if reduction == "sum":
        return ops.sum(nll)
    count = ops.sum(ops.convert_element_type(valid, dtypes.float32))
    return ops.true_divide(ops.sum(nll), ops.maximum(count, 1.0))


def _causal_scores(scores, q, L, S):
    causal = ops.tril_mask(L, S, 0, device=q.device)
    return ops.where(ops.expand_to(causal, scores.shape), scores,
                     ops.full_like(scores, -float("inf")))


@opsymbol(id="nn.sdpa_fwd")
def sdpa_fwd(q, k, v, is_causal: bool = False, scale: float | None = None):
    """Attention forward that also returns the row logsumexp, the
    flash-attention forward contract."""
    E = q.shape[-1]
    L, S = q.shape[-2], k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(E)
    qf = ops.convert_element_type(q, dtypes.float32)
    kf = ops.convert_element_type(k, dtypes.float32)
    vf = ops.convert_element_type(v, dtypes.float32)
    scores = ops.mul(ops.matmul(qf, kf.mT), scale)
    if is_causal:
        scores = _causal_scores(scores, q, L, S)
    m = ops.amax(scores, -1, keepdim=True)
    e = ops.exp(ops.sub(scores, m))
    l = ops.sum(e, -1, keepdim=True)
    out = ops.matmul(ops.true_divide(e, l), vf)
    lse = ops.add(ops.squeeze(m, -1), ops.log(ops.squeeze(l, -1)))
    return ops.convert_element_type(out, q.dtype), lse


@opsymbol(id="nn.ce_fwd")
def ce_fwd(logits, target, ignore_index: int = -100):
    """Per-row negative log-likelihood and logsumexp (the fused
    cross-entropy forward contract). logits (N, C); target (N,) integer."""
    lf = ops.convert_element_type(logits, dtypes.float32)
    m = ops.amax(lf, -1, keepdim=True)
    lse = ops.add(ops.squeeze(m, -1), ops.log(ops.sum(ops.exp(ops.sub(lf, m)), -1)))
    tgt = ops.convert_element_type(target, dtypes.int64)
    safe_tgt = ops.where(ops.eq(tgt, ignore_index), ops.zeros_like(tgt), tgt)
    picked = ops.squeeze(prims.take_along_axis(lf, ops.unsqueeze(safe_tgt, -1), 1), (1,))
    nll = ops.sub(lse, picked)
    valid = ops.ne(tgt, ignore_index)
    nll = ops.where(valid, nll, ops.zeros_like(nll))
    return nll, lse


@opsymbol(id="nn.sdpa_bwd")
def sdpa_bwd(g, q, k, v, out, lse, is_causal: bool = False, scale: float | None = None):
    """Flash-attention backward contract: the probabilities recomputed from
    ``(q, k, lse)``, giving ``(dq, dk, dv)``."""
    E = q.shape[-1]
    L, S = q.shape[-2], k.shape[-2]
    scale_v = scale if scale is not None else 1.0 / math.sqrt(E)
    gf, qf, kf, vf, of = (ops.convert_element_type(t, dtypes.float32) for t in (g, q, k, v, out))
    scores = ops.mul(ops.matmul(qf, kf.mT), scale_v)
    if is_causal:
        scores = _causal_scores(scores, q, L, S)
    p = ops.exp(ops.sub(scores, ops.unsqueeze(lse, -1)))
    dv = ops.matmul(p.mT, gf)
    dp = ops.matmul(gf, vf.mT)
    delta = ops.sum(ops.mul(gf, of), -1, keepdim=True)   # rowsum(dO * O)
    ds = ops.mul(ops.mul(p, ops.sub(dp, delta)), scale_v)
    dq = ops.matmul(ds, kf)
    dk = ops.matmul(ds.mT, qf)
    return (ops.convert_element_type(dq, q.dtype), ops.convert_element_type(dk, k.dtype),
            ops.convert_element_type(dv, v.dtype))


@opsymbol(id="nn.paged_decode_attention")
def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           scale: float | None = None):
    """Ragged attention over the paged KV cache, the reference's
    decomposition (ops/nn.py:367): gather each request's pages through its
    block table, mask ragged causally (row ``r`` of ``T`` attends keys ``j
    <= lengths - T + r``), softmax in float32; grouped-query heads fold into
    q's rows. q (B, H, T, hd); pools (KV, P, ps, hd). The ``cuda`` executor
    claims the T == 1 decode case (the ``paged_decode_attention`` kernel);
    a prefill chunk keeps this decomposition, as the reference's does."""
    _tensor_like(q, "paged_decode_attention")
    check(q.ndim == 4 and k_pages.ndim == 4 and v_pages.ndim == 4,
          lambda: f"paged_decode_attention: q must be (B, H, T, hd) and pages (kv_heads, P, "
                  f"page, hd); got q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}")
    B, H, T, hd = q.shape
    KV, P, ps, hd2 = k_pages.shape
    check(hd2 == hd and tuple(v_pages.shape) == tuple(k_pages.shape),
          lambda: f"paged_decode_attention: page pools {tuple(k_pages.shape)} / "
                  f"{tuple(v_pages.shape)} do not match head_dim {hd}")
    check(H % KV == 0,
          lambda: f"paged_decode_attention: n_heads {H} not divisible by kv_heads {KV}")
    check(block_tables.ndim == 2 and block_tables.shape[0] == B
          and lengths.ndim == 1 and lengths.shape[0] == B,
          lambda: f"paged_decode_attention: block_tables {tuple(block_tables.shape)} / lengths "
                  f"{tuple(lengths.shape)} do not match batch {B}")
    n_rep = H // KV
    npg = block_tables.shape[1]
    L = npg * ps
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = ops.reshape(block_tables, (B * npg,))
    k = ops.transpose(ops.reshape(prims.take(k_pages, idx, 1), (KV, B, L, hd)), (1, 0, 2, 3))
    v = ops.transpose(ops.reshape(prims.take(v_pages, idx, 1), (KV, B, L, hd)), (1, 0, 2, 3))
    qg = ops.reshape(q, (B, KV, n_rep * T, hd))
    qf = ops.convert_element_type(qg, dtypes.float32)
    kf = ops.convert_element_type(k, dtypes.float32)
    vf = ops.convert_element_type(v, dtypes.float32)
    scores = ops.mul(ops.matmul(qf, kf.mT), scale)          # (B, KV, n_rep*T, L)
    scores = ops.reshape(scores, (B, H, T, L))
    col = ops.arange(L, device=q.device)
    row_pos = ops.add(ops.unsqueeze(ops.sub(lengths, T), 1),
                      ops.unsqueeze(ops.arange(T, device=q.device), 0))   # (B, T)
    valid = ops.le(ops.unsqueeze(ops.unsqueeze(col, 0), 0), ops.unsqueeze(row_pos, 2))
    neg = ops.full((), float("-inf"), dtype=dtypes.float32, device=q.device)
    scores = ops.where(ops.expand_to(ops.unsqueeze(valid, 1), scores.shape), scores, neg)
    probs = ops.softmax(scores, -1)
    attn = ops.matmul(ops.reshape(probs, (B, KV, n_rep * T, L)), vf)
    return ops.convert_element_type(ops.reshape(attn, (B, H, T, hd)), q.dtype)


def decode_row_write(pool_flat, rows, flat_positions):
    """Every decode slot's K/V row into a flattened page pool in ONE
    replace-semantics ``prims.scatter`` (the reference's helper,
    ops/nn.py:447): the serving runner's K/V append and the
    ``nn.attn_subblock`` decomposition emit the same ops, which the block
    planner's chain matcher reads. ``pool_flat`` (KV, P*ps, hd); ``rows``
    (S, KV, 1, hd); ``flat_positions`` (S,) of ``page*ps + offset``. Idle and
    replay slots all target position 0 (the reserved scratch page);
    duplicate indices there are benign (any write wins, nobody reads)."""
    S = rows.shape[0]
    src = ops.transpose(ops.squeeze(rows, 2), (1, 0, 2))       # (KV, S, hd)
    idx = ops.expand_to(ops.reshape(flat_positions, (1, S, 1)), src.shape)
    return prims.scatter(pool_flat, idx, src, 1)


def _apply_rope(x, cos, sin):
    """GPT-NeoX half rotation (``models.llama._apply_rope``) in ops."""
    hd = x.shape[-1]
    x1 = ops.getitem(x, (Ellipsis, slice(0, hd // 2)))
    x2 = ops.getitem(x, (Ellipsis, slice(hd // 2, hd)))
    return ops.cat([ops.sub(ops.mul(x1, cos), ops.mul(x2, sin)),
                    ops.add(ops.mul(x2, cos), ops.mul(x1, sin))], -1)


_DECODE_T1 = ("decode-only composite (T == 1): every slot contributes one new row; the "
              "chunked-prefill path keeps the unfused ops")


@opsymbol(id="nn.attn_subblock")
def attn_subblock(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                  lengths, write_pos, *, eps: float = 1e-5, scale: float | None = None):
    """The serving attention sub-block of one T == 1 decode step as one
    composite, the block planner's attention unit (reference ops/nn.py:469)::

        x     = rms_norm(h, w_norm)
        q,k,v = rope(split_heads(x @ wq/wk/wv.T))     # v un-roped
        kp,vp = the pools with this step's k/v rows scattered at write_pos
        attn  = paged_decode_attention(q, kp, vp, block_tables, lengths)
        out   = merge_heads(attn) @ wo.T              # residual add outside

    Returns ``(out, kp, vp)``. The decomposition is the op sequence the
    serving runner emits for one layer; the ``cuda`` executor claims it as
    the ``attn_subblock`` kernel, writing the donated pools in place."""
    _tensor_like(h, "attn_subblock")
    B, T = h.shape[0], h.shape[1]
    check(T == 1, lambda: f"attn_subblock: {_DECODE_T1}; got T={T}")
    KV, P, ps, hd = k_pages.shape
    check(tuple(v_pages.shape) == tuple(k_pages.shape),
          lambda: f"attn_subblock: page pools {tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                  f"differ")
    H = wq.shape[0] // hd
    check(wq.shape[0] == H * hd and wk.shape[0] == KV * hd
          and tuple(wv.shape) == tuple(wk.shape) and wo.shape[1] == H * hd,
          lambda: f"attn_subblock: projection shapes wq {tuple(wq.shape)} / wk "
                  f"{tuple(wk.shape)} / wo {tuple(wo.shape)} do not agree with head_dim {hd}")
    x = rms_norm(h, w_norm, eps=eps)

    def heads(w, n):
        return ops.transpose(ops.reshape(ops.linear(x, w), (B, T, n, hd)), (0, 2, 1, 3))

    q = _apply_rope(heads(wq, H), cos, sin)
    k = _apply_rope(heads(wk, KV), cos, sin)
    v = heads(wv, KV)
    flat, paged = (KV, P * ps, hd), (KV, P, ps, hd)
    kp = ops.reshape(decode_row_write(ops.reshape(k_pages, flat), k, write_pos), paged)
    vp = ops.reshape(decode_row_write(ops.reshape(v_pages, flat), v, write_pos), paged)
    attn = paged_decode_attention(q, kp, vp, block_tables, lengths, scale=scale)
    attn = ops.reshape(ops.transpose(attn, (0, 2, 1, 3)), (B, T, H * hd))
    return ops.linear(attn, wo), kp, vp


@opsymbol(id="nn.decode_layer")
def decode_layer(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                 lengths, write_pos, mlp_norm, w_gate, w_up, w_down, *, act: str = "silu",
                 eps: float = 1e-5, scale: float | None = None):
    """One whole transformer decode layer (T == 1) as one composite, the
    block planner's chaining unit (reference ops/nn.py:530): the attention
    sub-block, then the MLP sub-block on ``h + out``. Returns ``(out, kp,
    vp)``. The decomposition is the two sub-block composites, the rung
    below; the ``cuda`` executor claims it as the ``decode_layer`` kernel,
    one launch per layer per decoded token."""
    proj, kp, vp = attn_subblock(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                                 block_tables, lengths, write_pos, eps=eps, scale=scale)
    out = mlp_subblock(h, proj, mlp_norm, w_gate, w_up, w_down, act=act, eps=eps)
    return out, kp, vp


@opsymbol(id="nn.scaled_dot_product_attention")
def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p: float = 0.0,
                                 is_causal: bool = False, scale: float | None = None):
    """q, k, v (..., L, E) / (..., S, E): ``softmax(q k^T * scale) v``. (The
    reference's context-parallel ring branch is not ported yet.)"""
    _tensor_like(q, "scaled_dot_product_attention")
    E = q.shape[-1]
    L, S = q.shape[-2], k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(E)
    qf = ops.convert_element_type(q, dtypes.float32)
    kf = ops.convert_element_type(k, dtypes.float32)
    vf = ops.convert_element_type(v, dtypes.float32)
    scores = ops.mul(ops.matmul(qf, kf.mT), scale)
    if is_causal:
        check(attn_mask is None, "cannot pass both is_causal and attn_mask")
        scores = _causal_scores(scores, q, L, S)
    if attn_mask is not None:
        if attn_mask.dtype.is_bool:
            scores = ops.where(ops.expand_to(attn_mask, scores.shape), scores,
                               ops.full_like(scores, -float("inf")))
        else:
            scores = ops.add(scores, attn_mask)
    probs = ops.softmax(scores, -1)
    if dropout_p > 0.0:
        probs = dropout(probs, dropout_p)
    out = ops.matmul(probs, vf)
    return ops.convert_element_type(out, q.dtype)


# ---------------------------------------------------------------------------
# the flash-style VJP rules: attention saves (q, k, v, out, lse) and
# recomputes its probabilities in the backward; the norm saves (a, weight)
# and recomputes its row statistics
# ---------------------------------------------------------------------------

from thunder_tpu_torch.core.proxies import TensorProxy  # noqa: E402
from thunder_tpu_torch.core.transforms import register_vjp  # noqa: E402


@register_vjp("nn.scaled_dot_product_attention")
def _sdpa_vjp(q, k, v, attn_mask=None, dropout_p: float = 0.0, is_causal: bool = False,
              scale: float | None = None):
    if attn_mask is not None or dropout_p > 0.0:
        return NotImplemented   # differentiate the decomposition
    out, lse = sdpa_fwd(q, k, v, is_causal, scale)

    def pullback(g):
        dq, dk, dv = sdpa_bwd(g, q, k, v, out, lse, is_causal, scale)
        return [(q, dq), (k, dk), (v, dv)]

    return out, pullback


@register_vjp("nn.rms_norm")
def _rms_norm_vjp(a, weight=None, eps: float = 1e-5, dim: int = -1):
    """Keeps ``nn.rms_norm`` one composite in a training trace, where the
    claim and the epilogue pass find it."""
    if dim not in (-1, a.ndim - 1):
        return NotImplemented
    out = rms_norm(a, weight, eps=eps, dim=dim)

    def pullback(g):
        # widen half precision to float32; float32 and float64 keep theirs
        wide = dtypes.float32 if a.dtype in _HALF else a.dtype
        x = ops.convert_element_type(a, wide)
        g32 = ops.convert_element_type(g, wide)
        r = ops.rsqrt(ops.add(ops.mean(ops.mul(x, x), -1, keepdim=True), eps))
        xhat = ops.mul(x, r)
        gxhat = ops.mul(g32, ops.convert_element_type(weight, wide)) if weight is not None \
            else g32
        # d/dx of x * (mean(x^2) + eps)^(-1/2): r * (g^ - x^ * mean(g^ * x^))
        proj = ops.mean(ops.mul(gxhat, xhat), -1, keepdim=True)
        da = ops.mul(r, ops.sub(gxhat, ops.mul(xhat, proj)))
        pairs = [(a, ops.convert_element_type(da, a.dtype))]
        if isinstance(weight, TensorProxy):
            lead = tuple(range(a.ndim - 1))
            dw = ops.mul(g32, xhat) if not lead else ops.sum(ops.mul(g32, xhat), lead)
            pairs.append((weight, ops.convert_element_type(dw, weight.dtype)))
        return pairs

    return out, pullback


@register_vjp("nn.mlp_subblock")
def _mlp_subblock_vjp(residual, x, w_norm, w_gate, w_up, w_down, *, act: str = "silu",
                      eps: float = 1e-5):
    """The planned sub-block stays one ``nn.mlp_subblock`` in the forward,
    saving only its inputs, and its pullback is one ``nn.mlp_subblock_bwd``:
    each direction one claimable kernel, and neither keeps the chain's
    interior activations."""
    out = mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, act=act, eps=eps)

    def pullback(g):
        dh, dwn, dwg, dwu, dwd = mlp_subblock_bwd(g, residual, x, w_norm, w_gate, w_up,
                                                  w_down, act=act, eps=eps)
        pairs = [(residual, dh), (x, dh), (w_gate, dwg), (w_up, dwu), (w_down, dwd)]
        if isinstance(w_norm, TensorProxy):
            pairs.append((w_norm, dwn))
        return pairs

    return out, pullback


@register_vjp("nn.cross_entropy")
def _cross_entropy_vjp(logits, target, weight=None, ignore_index: int = -100,
                       reduction: str = "mean", label_smoothing: float = 0.0):
    if weight is not None or label_smoothing > 0.0 or logits.ndim != 2:
        return NotImplemented
    if reduction not in ("mean", "sum", "none"):
        return NotImplemented
    nll, lse = ce_fwd(logits, target, ignore_index)
    tgt = ops.convert_element_type(target, dtypes.int32)
    validf = ops.convert_element_type(ops.ne(tgt, ignore_index), dtypes.float32)
    count = ops.maximum(ops.sum(validf), 1.0)
    if reduction == "mean":
        loss = ops.true_divide(ops.sum(nll), count)
    elif reduction == "sum":
        loss = ops.sum(nll)
    else:
        loss = nll

    def pullback(g):
        C = logits.shape[-1]
        lf = ops.convert_element_type(logits, dtypes.float32)
        p = ops.exp(ops.sub(lf, ops.unsqueeze(lse, -1)))   # softmax rows
        safe_tgt = ops.where(ops.eq(tgt, ignore_index), ops.zeros_like(tgt), tgt)
        onehot = ops.convert_element_type(one_hot(safe_tgt, C), dtypes.float32)
        row_scale = ops.mul(ops.true_divide(validf, count), g) if reduction == "mean" \
            else ops.mul(validf, g)
        dlogits = ops.mul(ops.sub(p, onehot), ops.unsqueeze(row_scale, -1))
        return [(logits, ops.convert_element_type(dlogits, logits.dtype))]

    return loss, pullback
