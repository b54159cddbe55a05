"""Neural-network functions of the port, each with its plain PyTorch
version.

The counterparts of ``thunder_tpu/ops/nn.py`` ``rms_norm`` (:61),
``rms_norm_residual`` (:73), ``linear_act`` (:101), ``mlp_subblock``
(:116), ``mlp_subblock_bwd`` (:149), ``sdpa_fwd`` (:296), ``ce_fwd``
(:320), ``sdpa_bwd`` (:336), ``paged_decode_attention`` (:367) and
``decode_row_write`` (:447). Each public function sends a CUDA tensor to
its hand-written kernel (:mod:`thunder_tpu_torch.executors.cudaex`) and a
CPU tensor to its plain version; any other device raises.
``paged_decode_attention`` with T > 1 (chunked prefill) is outside the
decode kernel's contract and always takes the plain gather/mask/softmax
decomposition, as the JAX package's checker leaves it to XLA.

The ``*_plain`` functions repeat the reference's arithmetic op for op
(statistics in float32, the same roundings), so the CPU path matches the
JAX package and the card's kernels are held against them.

Gradients (the train step): ``scaled_dot_product_attention`` and
``cross_entropy`` are ``torch.autograd.Function``s, the counterparts of the
reference's flash VJP rules ``_sdpa_vjp`` (:642) and ``_cross_entropy_vjp``
(:763): attention saves ``(q, k, v, out, lse)`` and its backward is the
``sdpa_bwd`` kernel; cross-entropy's forward is ``ce_fwd`` and its backward
``(softmax - onehot) * row_scale`` in plain ops, as the reference computes
it. ``rms_norm`` and ``rms_norm_residual`` take their kernel forward and
``_rms_norm_vjp``'s (:658) plain backward when a gradient is needed; the
reference has no backward kernel for them either. ``mlp_subblock`` is the
counterpart of ``_mlp_subblock_vjp`` (:696): it saves its six inputs and its
backward is the ``mlp_subblock_bwd`` kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from thunder_tpu_torch.executors import cudaex

_HALF = (torch.float16, torch.bfloat16)


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name}: tensors on {t.device} are not supported "
                         f"(cuda runs the kernel, cpu the plain version)")
    return False


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rms_norm_plain(a: torch.Tensor, weight: torch.Tensor | None = None,
                   eps: float = 1e-5) -> torch.Tensor:
    x = a.float() if a.dtype in _HALF else a
    ms = torch.mean(x * x, -1, keepdim=True)
    out = (x * torch.rsqrt(ms + eps)).to(a.dtype)
    return out * weight if weight is not None else out


def rms_norm_residual_plain(residual: torch.Tensor, a: torch.Tensor,
                            weight: torch.Tensor | None = None, eps: float = 1e-5):
    h = residual + a
    return h, rms_norm_plain(h, weight, eps)


_ACTS = {
    "relu": torch.relu,
    "silu": lambda y: y * torch.sigmoid(y),
    "gelu": lambda y: F.gelu(y, approximate="none"),
    "gelu_tanh": lambda y: F.gelu(y, approximate="tanh"),
}


def _check_act(name: str, act: str) -> None:
    if act not in _ACTS:
        raise ValueError(f"{name}: unknown activation {act!r}; known: {sorted(_ACTS)}")


def linear_act_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                     act: str = "relu") -> torch.Tensor:
    """``act(a @ w.T + bias)``, the product and activation in float32 and one
    rounding to ``a.dtype`` (the kernel's contract; in float32 it is exactly
    the reference's ``act(linear(a, w, bias))``)."""
    _check_act("linear_act", act)
    y = F.linear(a.float(), w.float(), None if bias is None else bias.float())
    return _ACTS[act](y).to(a.dtype)


def _act_grad_plain(act: str, a: torch.Tensor) -> torch.Tensor:
    """d act(a) / da in float32, the closed forms of pallasex's
    ``_act_grad_f32`` (:981)."""
    if act == "relu":
        return (a > 0).to(a.dtype)
    if act == "silu":
        sig = torch.sigmoid(a)
        return sig * (1.0 + a * (1.0 - sig))
    if act == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(a / math.sqrt(2.0)))
        pdf = torch.exp(-0.5 * a * a) / math.sqrt(2.0 * math.pi)
        return cdf + a * pdf
    c = math.sqrt(2.0 / math.pi)   # gelu_tanh
    t = torch.tanh(c * (a + 0.044715 * a * a * a))
    du = c * (1.0 + 3.0 * 0.044715 * a * a)
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * du


def mlp_subblock_plain(residual, x, w_norm, w_gate, w_up, w_down, act: str = "silu",
                       eps: float = 1e-5) -> torch.Tensor:
    """``h + (act(n @ w_gate.T) * (n @ w_up.T)) @ w_down.T`` with ``h =
    residual + x`` and ``n = rms_norm(h, w_norm)``, rounded where
    ``_mlp_subblock_kernel`` (pallasex.py:999) rounds: h in the input dtype,
    ``act(gate)`` and ``up`` each rounded from float32 and multiplied in the
    input dtype, the down projection summed in float32 and rounded once
    before the residual add. In float32 it is the reference's
    ``nn.mlp_subblock`` decomposition."""
    _check_act("mlp_subblock", act)
    dt = x.dtype
    h = residual + x
    n = rms_norm_plain(h, w_norm, eps).float()
    ga = _ACTS[act](F.linear(n, w_gate.float())).to(dt)
    u = F.linear(n, w_up.float()).to(dt)
    return h + F.linear((ga * u).float(), w_down.float()).to(dt)


def mlp_subblock_bwd_plain(g, residual, x, w_norm, w_gate, w_up, w_down, act: str = "silu",
                           eps: float = 1e-5):
    """``(dh, dw_norm, dw_gate, dw_up, dw_down)`` of :func:`mlp_subblock_plain`
    for the output gradient ``g``, from the inputs alone, rounded where the
    backward pair rounds (pallasex.py:1080-1115, :1134-1151): ``gpre``, ``u``
    and ``dy = g @ w_down`` stay float32, ``dup``, ``dgpre`` and ``y`` round
    to the input dtype, ``dn`` and the weight gradients sum in float32, each
    result rounds once to its input's dtype. ``dh`` is the gradient of both
    ``residual`` and ``x``. In float32 it is the reference's
    ``nn.mlp_subblock_bwd`` decomposition."""
    _check_act("mlp_subblock_bwd", act)
    dt, shape = x.dtype, x.shape
    D = shape[-1]
    h32 = (residual + x).float().reshape(-1, D)
    rr = torch.rsqrt(torch.mean(h32 * h32, -1, keepdim=True) + eps)
    xhat = h32 * rr
    n = (xhat.to(dt) * w_norm).float()
    wg, wu, wd = w_gate.float(), w_up.float(), w_down.float()
    gpre, u = F.linear(n, wg), F.linear(n, wu)
    g32 = g.float().reshape(-1, D)
    dy = torch.matmul(g32, wd)
    ga = _ACTS[act](gpre)
    dup = (dy * ga).to(dt)
    dgpre = (dy * u * _act_grad_plain(act, gpre)).to(dt)
    y = ga.to(dt) * u.to(dt)
    del gpre, u, dy, ga
    dn = torch.matmul(dgpre.float(), wg) + torch.matmul(dup.float(), wu)
    dw_norm = torch.sum(dn * xhat, 0).to(w_norm.dtype)
    gxhat = dn * w_norm.float()
    proj = torch.mean(gxhat * xhat, -1, keepdim=True)
    dh = (g32 + rr * (gxhat - xhat * proj)).to(dt).reshape(shape)
    del dn, gxhat
    dw_gate = torch.matmul(dgpre.float().t(), n).to(w_gate.dtype)
    dw_up = torch.matmul(dup.float().t(), n).to(w_up.dtype)
    dw_down = torch.matmul(g32.t(), y.float()).to(w_down.dtype)
    return dh, dw_norm, dw_gate, dw_up, dw_down


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lengths,
                                 scale: float | None = None) -> torch.Tensor:
    """Gather each request's pages through its block table, mask ragged
    causally (row ``r`` of ``T`` attends keys ``j <= lengths - T + r``),
    softmax in float32. Grouped-query heads fold into q's rows, so the
    gathered cache is never expanded to ``n_heads``."""
    B, H, T, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    n_rep = H // KV
    npg = block_tables.shape[1]
    L = npg * ps
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = block_tables.reshape(B * npg).long()
    k = k_pages.index_select(1, idx).reshape(KV, B, L, hd).transpose(0, 1)
    v = v_pages.index_select(1, idx).reshape(KV, B, L, hd).transpose(0, 1)
    qf = q.reshape(B, KV, n_rep * T, hd).float()
    scores = torch.matmul(qf, k.float().transpose(-1, -2)) * scale   # (B, KV, G*T, L)
    scores = scores.reshape(B, H, T, L)
    col = torch.arange(L, device=q.device)
    row_pos = (lengths.long() - T)[:, None] + torch.arange(T, device=q.device)[None, :]
    valid = col[None, None, :] <= row_pos[:, :, None]                 # (B, T, L)
    scores = scores.masked_fill(~valid[:, None], float("-inf"))
    probs = torch.softmax(scores, -1)
    attn = torch.matmul(probs.reshape(B, KV, n_rep * T, L), v.float())
    return attn.reshape(B, H, T, hd).to(q.dtype)


def _causal(scores: torch.Tensor) -> torch.Tensor:
    """Scores with the top-left aligned causal mask (``tril_mask(L, S, 0)``:
    row >= col) applied as -inf."""
    L, S = scores.shape[-2], scores.shape[-1]
    keep = (torch.arange(L, device=scores.device)[:, None]
            >= torch.arange(S, device=scores.device)[None, :])
    return scores.masked_fill(~keep, float("-inf"))


def sdpa_fwd_plain(q, k, v, is_causal: bool = False, scale: float | None = None):
    """Attention forward with the row logsumexp: ``(out, lse)``, in float32
    and ``out`` rounded once to ``q.dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if is_causal:
        scores = _causal(scores)
    m = torch.amax(scores, -1, keepdim=True)
    e = torch.exp(scores - m)
    l = torch.sum(e, -1, keepdim=True)
    out = torch.matmul(e / l, v.float())
    lse = m.squeeze(-1) + torch.log(l.squeeze(-1))
    return out.to(q.dtype), lse


def sdpa_bwd_plain(g, q, k, v, out, lse, is_causal: bool = False,
                   scale: float | None = None):
    """``(dq, dk, dv)`` from the probabilities recomputed out of ``(q, k,
    lse)``, with ``delta = rowsum(g * out)``; float32, each gradient rounded
    once to its input's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    gf, qf, kf, vf, of = (t.float() for t in (g, q, k, v, out))
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if is_causal:
        scores = _causal(scores)
    p = torch.exp(scores - lse.unsqueeze(-1))
    del scores
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = torch.sum(gf * of, -1, keepdim=True)
    ds = p * (dp - delta) * scale
    del p, dp
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ce_fwd_plain(logits, target, ignore_index: int = -100):
    """Per-row ``(nll, lse)`` in float32; rows whose target is
    ``ignore_index`` get nll 0 and their lse all the same."""
    lf = logits.float()
    m = torch.amax(lf, -1, keepdim=True)
    lse = m.squeeze(-1) + torch.log(torch.sum(torch.exp(lf - m), -1))
    tgt = target.long()
    ignored = tgt == ignore_index
    safe = torch.where(ignored, torch.zeros_like(tgt), tgt)
    picked = torch.gather(lf, 1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(ignored, torch.zeros_like(lse), lse - picked)
    return nll, lse


def rms_norm_bwd_plain(g, a, weight=None, eps: float = 1e-5):
    """``(da, dweight)`` of ``rms_norm(a, weight, eps)`` for the output
    gradient ``g``: the row statistics recomputed in float32 (the input's
    own type when wider), ``da = r * (g*w - xhat * mean(g*w * xhat))``."""
    wide = torch.float32 if a.dtype in _HALF else a.dtype
    x, g32 = a.to(wide), g.to(wide)
    r = torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
    xhat = x * r
    gxhat = g32 * weight.to(wide) if weight is not None else g32
    proj = torch.mean(gxhat * xhat, -1, keepdim=True)
    da = (r * (gxhat - xhat * proj)).to(a.dtype)
    if weight is None:
        return da, None
    dw = (g32 * xhat).reshape(-1, a.shape[-1]).sum(0)
    return da, dw.to(weight.dtype)


# ---------------------------------------------------------------------------
# public functions: kernel on CUDA, plain version on the CPU
# ---------------------------------------------------------------------------

def _needs_grad(*tensors) -> bool:
    # the norms skip the autograd.Function when no gradient is wanted: the
    # serving decode step calls them 65 times per step under no autograd
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def _rms_norm(a, weight, eps):
    if _on_cuda(a, "rms_norm"):
        return cudaex.rms_norm(a, weight, eps)
    return rms_norm_plain(a, weight, eps)


def _rms_norm_residual(residual, a, weight, eps):
    if _on_cuda(a, "rms_norm_residual"):
        return cudaex.rms_norm_residual(residual, a, weight, eps)
    return rms_norm_residual_plain(residual, a, weight, eps)


class _RmsNorm(torch.autograd.Function):
    """Kernel forward; ``_rms_norm_vjp``'s plain backward from ``(a, weight)``."""

    @staticmethod
    def forward(ctx, a, weight, eps):
        ctx.save_for_backward(a, weight)
        ctx.eps = eps
        return _rms_norm(a, weight, eps)

    @staticmethod
    def backward(ctx, g):
        a, weight = ctx.saved_tensors
        da, dw = rms_norm_bwd_plain(g, a, weight, ctx.eps)
        return da, dw, None


class _RmsNormResidual(torch.autograd.Function):
    """Kernel forward of ``(h, rms_norm(h))`` with ``h = residual + a``; the
    backward sends ``g_h + d rms_norm(h)`` to both addends."""

    @staticmethod
    def forward(ctx, residual, a, weight, eps):
        h, out = _rms_norm_residual(residual, a, weight, eps)
        ctx.save_for_backward(h, weight)
        ctx.eps = eps
        return h, out

    @staticmethod
    def backward(ctx, g_h, g_out):
        h, weight = ctx.saved_tensors
        dh, dw = rms_norm_bwd_plain(g_out, h, weight, ctx.eps)
        dh = g_h + dh
        return dh, dh, dw, None


def rms_norm(a: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dim; statistics in float32, the normalised
    row rounded to ``a.dtype`` before the weight multiply. Differentiable
    in ``a`` and ``weight``."""
    if _needs_grad(a, weight):
        return _RmsNorm.apply(a, weight, eps)
    return _rms_norm(a, weight, eps)


def rms_norm_residual(residual: torch.Tensor, a: torch.Tensor,
                      weight: torch.Tensor | None = None, eps: float = 1e-5):
    """Fused ``h = residual + a``, ``rms_norm(h, weight)``; returns
    ``(h, normed)``. Differentiable in all three tensors."""
    if _needs_grad(residual, a, weight):
        return _RmsNormResidual.apply(residual, a, weight, eps)
    return _rms_norm_residual(residual, a, weight, eps)


def linear_act(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               act: str = "relu") -> torch.Tensor:
    """Fused ``act(a @ w.T + bias)``; ``act`` is one of relu | silu | gelu |
    gelu_tanh."""
    if _on_cuda(a, "linear_act"):
        return cudaex.linear_act(a, w, bias, act)
    return linear_act_plain(a, w, bias, act)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           scale: float | None = None) -> torch.Tensor:
    """Ragged attention over the paged KV cache.

    ``q`` (B, n_heads, T, hd); pools (kv_heads, num_pages, page_size, hd);
    ``block_tables`` (B, pages_per_request) int32, every entry a valid page
    (page 0 is the reserved scratch page); ``lengths`` (B,) int32 context
    length including the T new rows. Query head ``h`` reads kv head
    ``h // (n_heads // kv_heads)``. T == 1 on CUDA runs the kernel."""
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attention: q must be (B, H, T, hd) and pools "
                         f"(kv_heads, P, page, hd); got q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if q.shape[1] % k_pages.shape[0]:
        raise ValueError(f"paged_decode_attention: n_heads {q.shape[1]} not divisible "
                         f"by kv_heads {k_pages.shape[0]}")
    if _on_cuda(q, "paged_decode_attention") and q.shape[2] == 1:
        return cudaex.paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                                             scale)
    return paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lengths, scale)


def sdpa_fwd(q, k, v, is_causal: bool = False, scale: float | None = None):
    """Flash-attention forward: ``(out, lse)`` for q (..., T, hd) against
    k, v (..., S, hd) with the same leading dims; ``lse`` (..., T) float32.
    Causal masking is top-left aligned (row >= col)."""
    if _on_cuda(q, "sdpa_fwd"):
        return cudaex.sdpa_fwd(q, k, v, is_causal, scale)
    return sdpa_fwd_plain(q, k, v, is_causal, scale)


def sdpa_bwd(g, q, k, v, out, lse, is_causal: bool = False, scale: float | None = None):
    """Flash-attention backward: ``(dq, dk, dv)``."""
    if _on_cuda(q, "sdpa_bwd"):
        return cudaex.sdpa_bwd(g, q, k, v, out, lse, is_causal, scale)
    return sdpa_bwd_plain(g, q, k, v, out, lse, is_causal, scale)


def ce_fwd(logits, target, ignore_index: int = -100):
    """Per-row ``(nll, lse)`` float32 of ``logits`` (N, C) against integer
    ``target`` (N,)."""
    if _on_cuda(logits, "ce_fwd"):
        return cudaex.ce_fwd(logits, target.long(), ignore_index)
    return ce_fwd_plain(logits, target, ignore_index)


class _ScaledDotProductAttention(torch.autograd.Function):
    """The flash VJP: saves ``(q, k, v, out, lse)``; the backward recomputes
    the probabilities in ``sdpa_bwd`` instead of saving them."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal, scale):
        out, lse = sdpa_fwd(q, k, v, is_causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.is_causal, ctx.scale = is_causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = sdpa_bwd(g.contiguous(), q, k, v, out, lse, ctx.is_causal, ctx.scale)
        return dq, dk, dv, None, None


def scaled_dot_product_attention(q, k, v, is_causal: bool = False,
                                 scale: float | None = None) -> torch.Tensor:
    """``softmax(q k^T * scale [causal]) v`` for q (..., T, hd) and k, v
    (..., S, hd) with the same leading dims (grouped-query callers expand
    k/v to the query heads first), differentiable in q, k and v."""
    return _ScaledDotProductAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                            is_causal, scale)


class _CrossEntropy(torch.autograd.Function):
    """Mean cross-entropy over the rows whose target is not ignored."""

    @staticmethod
    def forward(ctx, logits, target, ignore_index):
        nll, lse = ce_fwd(logits, target, ignore_index)
        validf = (target != ignore_index).float()
        count = torch.clamp(torch.sum(validf), min=1.0)
        ctx.save_for_backward(logits, target, lse, validf, count)
        ctx.ignore_index = ignore_index
        return torch.sum(nll) / count

    @staticmethod
    def backward(ctx, g):
        logits, target, lse, validf, count = ctx.saved_tensors
        # softmax rows minus the one-hot target; subtracting 1 at the target
        # column is exactly (p - onehot) without the (N, C) one-hot tensor
        d = (logits.float() - lse.unsqueeze(-1)).exp_()
        tgt = target.long()
        safe = torch.where(tgt == ctx.ignore_index, torch.zeros_like(tgt), tgt)
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, safe] -= 1.0
        d.mul_((validf / count * g).unsqueeze(-1))
        return d.to(logits.dtype), None, None


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean negative log-likelihood of ``logits`` (N, C) at integer
    ``target`` (N,), over the rows whose target is not ``ignore_index``;
    differentiable in ``logits``."""
    if logits.ndim != 2 or target.shape != logits.shape[:1]:
        raise ValueError(f"cross_entropy: logits {tuple(logits.shape)} must be (N, C) and "
                         f"target {tuple(target.shape)} (N,)")
    return _CrossEntropy.apply(logits.contiguous(), target, ignore_index)


def mlp_subblock_bwd(g, residual, x, w_norm, w_gate, w_up, w_down, act: str = "silu",
                     eps: float = 1e-5):
    """``(dh, dw_norm, dw_gate, dw_up, dw_down)`` of :func:`mlp_subblock` for
    the output gradient ``g``, from the saved inputs (the interiors are
    recomputed); ``dh`` is the gradient of both ``residual`` and ``x``."""
    if _on_cuda(x, "mlp_subblock_bwd"):
        return cudaex.mlp_subblock_bwd(g, residual, x, w_norm, w_gate, w_up, w_down, act, eps)
    return mlp_subblock_bwd_plain(g, residual, x, w_norm, w_gate, w_up, w_down, act, eps)


def _mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, act, eps):
    if _on_cuda(x, "mlp_subblock"):
        return cudaex.mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, act, eps)
    return mlp_subblock_plain(residual, x, w_norm, w_gate, w_up, w_down, act, eps)


class _MlpSubblock(torch.autograd.Function):
    """The counterpart of ``_mlp_subblock_vjp`` (reference ``ops/nn.py:696``):
    saves only the inputs; the backward is ``mlp_subblock_bwd``, which
    recomputes the interiors, and sends ``dh`` to both ``residual`` and
    ``x``."""

    @staticmethod
    def forward(ctx, residual, x, w_norm, w_gate, w_up, w_down, act, eps):
        ctx.save_for_backward(residual, x, w_norm, w_gate, w_up, w_down)
        ctx.act, ctx.eps = act, eps
        return _mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, act, eps)

    @staticmethod
    def backward(ctx, g):
        dh, dwn, dwg, dwu, dwd = mlp_subblock_bwd(g.contiguous(), *ctx.saved_tensors,
                                                  act=ctx.act, eps=ctx.eps)
        return dh, dh, dwn, dwg, dwu, dwd, None, None


def mlp_subblock(residual: torch.Tensor, x: torch.Tensor, w_norm: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 act: str = "silu", eps: float = 1e-5) -> torch.Tensor:
    """The whole transformer MLP sub-block, the block planner's unit::

        h   = residual + x
        n   = rms_norm(h, w_norm)
        out = h + (act(n @ w_gate.T) * (n @ w_up.T)) @ w_down.T

    ``residual``, ``x`` (..., D); ``w_gate``, ``w_up`` (F, D); ``w_down``
    (D, F); ``act`` one of relu | silu | gelu | gelu_tanh. Differentiable in
    all six tensors; the gradient saves only the inputs."""
    residual, x = residual.contiguous(), x.contiguous()
    if _needs_grad(residual, x, w_norm, w_gate, w_up, w_down):
        return _MlpSubblock.apply(residual, x, w_norm, w_gate, w_up, w_down, act, eps)
    return _mlp_subblock(residual, x, w_norm, w_gate, w_up, w_down, act, eps)


def decode_row_write(pool: torch.Tensor, rows: torch.Tensor,
                     flat_positions: torch.Tensor) -> None:
    """Write every decode slot's K/V row into a page pool, in place.

    ``pool`` (KV, P, ps, hd); ``rows`` (S, KV, 1, hd); ``flat_positions``
    (S,) of ``page * ps + offset``. Replace semantics: freed pages hold
    stale values. Idle and replay slots all target position 0 of the
    reserved scratch page; which of those duplicate writes lands does not
    matter, since no live request reads it."""
    KV, P, ps, hd = pool.shape
    pool.view(KV, P * ps, hd).index_copy_(1, flat_positions.long(),
                                          rows.squeeze(2).transpose(0, 1))
