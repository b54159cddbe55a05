"""Neural-network functions of the port, each with its plain PyTorch
version.

The counterparts of ``thunder_tpu/ops/nn.py`` ``rms_norm`` (:61),
``rms_norm_residual`` (:73), ``linear_act`` (:101), ``mlp_subblock``
(:116), ``mlp_subblock_bwd`` (:149), ``sdpa_fwd`` (:296), ``ce_fwd``
(:320), ``sdpa_bwd`` (:336), ``paged_decode_attention`` (:367),
``decode_row_write`` (:447), ``attn_subblock`` (:469) and ``decode_layer``
(:530). Each public function sends a CUDA tensor to
its hand-written kernel (:mod:`thunder_tpu_torch.executors.cudaex`), which
raises on what the kernel does not take (``cudaex.refusal`` gives the
reason), and runs its plain version on the CPU; any other device raises.
The wrappers take what the reference computes through its decomposition
where a kernel can repeat its rounding points: float16, strided or
unaligned read-only operands (made dense), mixed dtypes (promoted as the
reference promotes, or a weight dtype of its own in the norms), attention
head dims off the multiples of 16 (zero-padded, ``cudaex.sdpa_head_dim``),
and any ``linear_act`` K (zero-padded on the tile path, ``cudaex.tile_k``).
``paged_decode_attention`` with T > 1 (chunked prefill) is outside the
decode kernel's contract and always takes the plain gather/mask/softmax
decomposition, as the JAX package's checker leaves it to XLA.

Every router carries :func:`traceable`'s ``__torch_function__`` entry, so
under ``jit`` it records its composite (:mod:`thunder_tpu_torch.ops.composites`)
instead of running. Every router that reaches a kernel runs behind
:func:`routed`: the kernel
guard of ``runtime.faults`` (the ``kernel:cuda.<name>`` fault hook, the
attribution of a failed launch to the claim, ``numerics:kernel:``
poisoning) and the quarantine (``runtime.quarantine``). The rungs go from
kernels to kernels: a quarantined ``decode_layer`` runs
:func:`decode_layer_subblocks` (the ``attn_subblock`` and ``mlp_subblock``
kernels), and the serving runner and the planned train step take their
per-op kernel rung while a sub-block is quarantined. Any other quarantined
kernel has no kernel rung below it: on the card its router raises a fatal
``KernelExecutionError`` (the port runs no plain version there); on the
CPU it runs its plain version, which is what its router runs there anyway.

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

``fused_linear_cross_entropy`` (:1049, with its VJP :1111) has no kernel in
the reference either: it is an autograd Function over vocab chunks whose
products keep the model dtype's operands and sum into float32 logits.

Serving decode (no autograd): ``decode_layer`` and ``attn_subblock`` run the
whole T == 1 layer, or its attention half, as one kernel launch and then
store the step's k/v rows into the pools in place; under ``jit`` they, and
``decode_row_write``, record their composites, whose outputs include the
updated pools, and the front end rebinds the pools' traced tensors to them. Their plain versions
follow the TPU kernel (pallasex ``_decode_call``), not the reference's
decomposition: the residual stream stays float32 inside the layer, and the
row at ``lengths - 1`` is attended from the freshly computed k/v rows, never
from the pools (a replay slot writes to the scratch page). In float32 that
is the decomposition; in bfloat16 the roundings differ.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.runtime import faults as _faults
from thunder_tpu_torch.runtime import quarantine as _quarantine

_HALF = (torch.float16, torch.bfloat16)


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name}: tensors on {t.device} are not supported "
                         f"(cuda runs the kernel, cpu the plain version)")
    return False


# ---------------------------------------------------------------------------
# routing: the kernel guard and the quarantine's rungs
# ---------------------------------------------------------------------------

def traceable(fn):
    """The ``__torch_function__`` entry of a router: a call whose arguments
    carry ``__torch_function__`` (the traced tensors of ``jit``) is handed
    to torch's override machinery, which records the router's composite
    (``thunder_tpu_torch.torch``'s function map); a call on plain tensors
    pays this one check."""

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if has_torch_function(args):
            return handle_torch_function(entry, args, *args, **kwargs)
        return fn(*args, **kwargs)

    return entry


def routed(name: str, fallback=None, tensor_of=lambda args: args[0]):
    """Decorator for the router of kernel ``name`` (``cudaex.KERNELS``): the
    router runs behind :func:`runtime.faults.kernel_guard` under the claim
    id ``cuda.<name>`` (the port's ``pallas.<name>``: the
    ``kernel:cuda.<name>`` fault hook, the attribution of a failed launch
    to the claim, the per-claim call count). While the quarantine routes
    the claim off (quarantined, or suppressed by a bisection probe),
    ``fallback``, which takes the router's arguments and launches the
    kernels of the rung below, runs instead; without one, a call whose
    tensor ``tensor_of(args)`` lies on the card raises a fatal
    ``KernelExecutionError``, and a CPU call runs the router unguarded (its
    plain version)."""
    claim = f"cuda.{name}"

    def deco(router):
        guarded = _faults.kernel_guard(claim, router)

        @functools.wraps(router)
        def route(*args, **kwargs):
            if _quarantine.is_routed_off(claim):
                if fallback is not None:
                    return fallback(*args, **kwargs)
                if tensor_of(args).device.type == "cuda":
                    raise _faults.KernelExecutionError(claim, phase=_faults.QUARANTINED)
                return router(*args, **kwargs)
            return guarded(*args, **kwargs)

        route.claim_id = claim
        entry = traceable(route)
        entry.__wrapped__ = router   # what benchmarks.decode_profile.unguarded swaps in
        return entry

    return deco


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
    rounding to the operands' dtype, the promoted one where they differ (the
    kernel's contract; in float32 it is exactly the reference's
    ``act(linear(a, w, bias))``, whose linear promotes mixed dtypes)."""
    _check_act("linear_act", act)
    out_dtype = cudaex.promoted_dtype(a, w, bias)
    y = F.linear(a.float(), w.float(), None if bias is None else bias.float())
    return _ACTS[act](y).to(out_dtype)


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


@routed("rms_norm")
def _rms_norm(a, weight, eps):
    if _on_cuda(a, "rms_norm"):
        return cudaex.rms_norm(a, weight, eps)
    return rms_norm_plain(a, weight, eps)


@routed("rms_norm_residual", tensor_of=lambda args: args[1])
def _rms_norm_residual(residual, a, weight, eps):
    if _on_cuda(a, "rms_norm_residual"):
        return cudaex.rms_norm_residual(residual, a, weight, eps)
    return rms_norm_residual_plain(residual, a, weight, eps)


class _RmsNorm(torch.autograd.Function):
    """Kernel forward; ``_rms_norm_vjp``'s plain backward from ``(a, weight)``."""

    @staticmethod
    def forward(ctx, a, weight, eps):
        # the same tuple, in the same order, as _RmsNormResidual saves: a
        # checkpointed layer (models/llama._remat_block) runs this in its
        # forward and _RmsNormResidual in its recompute, and the backward
        # of this node reads what the recompute saved, by position
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
        # (normed input, weight), as _RmsNorm saves: see there
        ctx.save_for_backward(h, weight)
        ctx.eps = eps
        return h, out

    @staticmethod
    def backward(ctx, g_h, g_out):
        h, weight = ctx.saved_tensors
        dh, dw = rms_norm_bwd_plain(g_out, h, weight, ctx.eps)
        dh = g_h + dh
        return dh, dh, dw, None


@traceable
def rms_norm(a: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dim; statistics in float32, the normalised
    row rounded to ``a.dtype`` before the weight multiply. Differentiable
    in ``a`` and ``weight``."""
    if _needs_grad(a, weight):
        return _RmsNorm.apply(a, weight, eps)
    return _rms_norm(a, weight, eps)


@traceable
def rms_norm_residual(residual: torch.Tensor, a: torch.Tensor,
                      weight: torch.Tensor | None = None, eps: float = 1e-5):
    """Fused ``h = residual + a``, ``rms_norm(h, weight)``; returns
    ``(h, normed)``. Differentiable in all three tensors."""
    if _needs_grad(residual, a, weight):
        return _RmsNormResidual.apply(residual, a, weight, eps)
    return _rms_norm_residual(residual, a, weight, eps)


@traceable
def silu(a: torch.Tensor) -> torch.Tensor:
    """``a * sigmoid(a)``, the reference's ``ops.silu`` decomposition, as
    the two ops that autograd differentiates (the train step's gate); under
    ``jit`` it records ``ops.silu``, the activation the block planner and
    the epilogue pass look for."""
    return a * torch.sigmoid(a)


@routed("linear_act")
def linear_act(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               act: str = "relu") -> torch.Tensor:
    """Fused ``act(a @ w.T + bias)``; ``act`` is one of relu | silu | gelu |
    gelu_tanh."""
    if _on_cuda(a, "linear_act"):
        return cudaex.linear_act(a, w, bias, act)
    return linear_act_plain(a, w, bias, act)


@traceable
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
    if q.shape[2] == 1:
        return _paged_decode(q, k_pages, v_pages, block_tables, lengths, scale)
    return paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lengths, scale)


@routed("paged_decode_attention")
def _paged_decode(q, k_pages, v_pages, block_tables, lengths, scale):
    if _on_cuda(q, "paged_decode_attention"):
        return cudaex.paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, scale)
    return paged_decode_attention_plain(q, k_pages, v_pages, block_tables, lengths, scale)


@routed("sdpa_fwd")
def sdpa_fwd(q, k, v, is_causal: bool = False, scale: float | None = None):
    """Flash-attention forward: ``(out, lse)`` for q (..., T, hd) against
    k, v (..., S, hd) with the same leading dims; ``lse`` (..., T) float32.
    Causal masking is top-left aligned (row >= col)."""
    if _on_cuda(q, "sdpa_fwd"):
        return cudaex.sdpa_fwd(q, k, v, is_causal, scale)
    return sdpa_fwd_plain(q, k, v, is_causal, scale)


@routed("sdpa_bwd", tensor_of=lambda args: args[1])
def sdpa_bwd(g, q, k, v, out, lse, is_causal: bool = False, scale: float | None = None):
    """Flash-attention backward: ``(dq, dk, dv)``."""
    if _on_cuda(q, "sdpa_bwd"):
        return cudaex.sdpa_bwd(g, q, k, v, out, lse, is_causal, scale)
    return sdpa_bwd_plain(g, q, k, v, out, lse, is_causal, scale)


@routed("ce_fwd")
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


@traceable
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


@traceable
def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean negative log-likelihood of ``logits`` (N, C) at integer
    ``target`` (N,), over the rows whose target is not ``ignore_index``;
    differentiable in ``logits``."""
    if logits.ndim != 2 or target.shape != logits.shape[:1]:
        raise ValueError(f"cross_entropy: logits {tuple(logits.shape)} must be (N, C) and "
                         f"target {tuple(target.shape)} (N,)")
    return _CrossEntropy.apply(logits.contiguous(), target, ignore_index)


# ---------------------------------------------------------------------------
# the chunked-vocab loss: lm_head fused into the cross-entropy
# ---------------------------------------------------------------------------

def _default_ce_chunk(V: int) -> int:
    """The reference's vocab chunk (ops/nn.py:1040): 16384 columns up to a
    65536 vocab, 8192 above. Forward and backward must agree, since the
    backward recomputes each chunk against the forward's lse."""
    return 16384 if V <= 65536 else 8192


def _mm_out_dtype_available(a: torch.Tensor, op=torch.ops.aten.mm) -> bool:
    """Whether ``op`` (``aten.mm`` or ``aten.bmm``) can take ``a``'s 16-bit
    operands to a float32 product on the card (its ``out_dtype`` overload)."""
    return (a.device.type == "cuda" and a.dtype in _HALF
            and "dtype" in op.overloads())


def flce_logits_route(h: torch.Tensor) -> str:
    """How :func:`fused_linear_cross_entropy` forms float32 products from
    ``h``'s dtype on ``h``'s device: ``"mm.out_dtype"`` (one bf16 GEMM with
    float32 accumulation and output, CUDA), ``"f32 upcast"`` (the operands
    taken to float32: a bf16 x bf16 product is exact in float32, so only the
    summation order differs), or ``"f32"`` for float32 operands."""
    if h.dtype == torch.float32:
        return "f32"
    return "mm.out_dtype" if _mm_out_dtype_available(h) else "f32 upcast"


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as float32 from operands in the model dtype, never rounded
    to it: the reference's ``dot_general(preferred_element_type=float32)``."""
    if a.dtype == b.dtype == torch.float32:
        return torch.mm(a, b)
    if a.dtype == b.dtype and _mm_out_dtype_available(a):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` as float32 from operands in the model dtype. On the
    card a 16-bit product is one ``bmm(out_dtype=float32)``, accumulating in
    float32 with no float32 copy of the operands (the contiguous cache is
    never copied), and raises where torch lacks that overload; off the card
    16-bit operands are taken to float32."""
    if a.dtype == b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        if a.dtype != b.dtype or not _mm_out_dtype_available(a, torch.ops.aten.bmm):
            raise RuntimeError(f"bmm_f32: no float32-output bmm for {a.dtype} x {b.dtype} on "
                               f"the card (torch {torch.__version__} lacks bmm(out_dtype=))")
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """``(mean nll, lse)`` of ``h @ w.T`` one vocab chunk at a time; the
    ``(N, V)`` logits never exist. The counterpart of the reference's op and
    its VJP (ops/nn.py:1049, :1111), op for op."""

    @staticmethod
    def forward(ctx, h, w, target, chunk, ignore_index):
        N, V = h.shape[0], w.shape[0]
        tgt = target.long()
        m = torch.full((N,), float("-inf"), dtype=torch.float32, device=h.device)
        s = torch.zeros(N, dtype=torch.float32, device=h.device)
        picked = torch.zeros(N, dtype=torch.float32, device=h.device)
        for c0 in range(0, V, chunk):
            cw = min(chunk, V - c0)
            lg = _mm_f32(h, w[c0:c0 + cw].t())
            m_new = torch.maximum(m, lg.amax(-1))
            alpha = torch.exp(m - m_new)
            s = s * alpha + torch.exp(lg - m_new.unsqueeze(1)).sum(-1)
            m = m_new
            idx = tgt - c0
            valid = (idx >= 0) & (idx < cw)
            pc = lg.gather(1, idx.clamp(0, cw - 1).unsqueeze(1)).squeeze(1)
            picked = picked + torch.where(valid, pc, torch.zeros_like(pc))
            del lg
        lse = m + torch.log(s)
        ok = tgt != ignore_index
        nll = torch.where(ok, lse - picked, torch.zeros_like(lse))
        count = torch.clamp(ok.float().sum(), min=1.0)
        ctx.save_for_backward(h, w, target, lse)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return nll.sum() / count, lse

    @staticmethod
    def backward(ctx, gl, glse):
        h, w, target, lse = ctx.saved_tensors
        N, D = h.shape
        V, chunk = w.shape[0], ctx.chunk
        tgt = target.long()
        okf = (tgt != ctx.ignore_index).float()
        count = torch.clamp(okf.sum(), min=1.0)
        # the nll term's row scale d(mean nll)/d(logit row); ignored rows 0.
        # The lse output's gradient adds to the softmax coefficient only: the
        # one-hot term belongs to the nll alone
        srow = okf * (gl.float() / count) if gl is not None else torch.zeros_like(okf)
        coef = srow if glse is None else srow + glse.float()
        hf = h.float()
        dh = torch.zeros((N, D), dtype=torch.float32, device=h.device)
        dw = torch.empty((V, D), dtype=torch.float32, device=h.device)
        for c0 in range(0, V, chunk):
            cw = min(chunk, V - c0)
            wc = w[c0:c0 + cw]
            p = torch.exp(_mm_f32(h, wc.t()) - lse.unsqueeze(1))
            # d(logits) rounded to the model dtype before both products
            psc = (p * coef.unsqueeze(1)).to(w.dtype)
            del p
            dh += _mm_f32(psc, wc)
            dw_c = _mm_f32(psc.t(), h)
            idx = tgt - c0
            valid = (idx >= 0) & (idx < cw)
            safe = idx.clamp(0, cw - 1)
            vrow = srow * valid.float()
            dh -= wc[safe].float() * vrow.unsqueeze(1)
            dw_c.index_add_(0, safe, hf * (-vrow).unsqueeze(1))
            dw[c0:c0 + cw] = dw_c
            del psc, dw_c
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor, target: torch.Tensor, *,
                               chunk: int | None = None, ignore_index: int = -100):
    """Mean softmax cross-entropy of ``h @ w.T`` over the rows whose target
    is not ``ignore_index``, and each row's lse, computed one vocab chunk at
    a time (the ``(N, V)`` logits are never materialised; the backward
    recomputes each chunk). ``h`` (N, D), ``w`` (V, D), ``target`` (N,)
    integer. Products take the operands in the model dtype and sum into
    float32 logits (:func:`flce_logits_route`). Differentiable in ``h`` and
    ``w``; returns ``(loss, lse)``."""
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[1] or target.shape != h.shape[:1]:
        raise ValueError(f"fused_linear_cross_entropy: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"target {tuple(target.shape)}: want (N, D), (V, D), (N,)")
    chunk = chunk if chunk is not None else _default_ce_chunk(w.shape[0])
    return _FusedLinearCrossEntropy.apply(h, w, target, chunk, ignore_index)


@routed("mlp_subblock_bwd", tensor_of=lambda args: args[2])
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


@routed("mlp_subblock")
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


@traceable
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


# ---------------------------------------------------------------------------
# the whole T == 1 decode layer and its attention half (pallasex._decode_call)
# ---------------------------------------------------------------------------

def decode_qkv_plain(h, w_norm, wq, wk, wv, cos, sin, eps: float = 1e-5):
    """Phase QKV of ``_decode_call`` (pallasex.py:1432): ``x = rms_norm(h)``,
    each head's projection rounded to h's dtype, then the half rotation with
    every multiply and add rounded (v is not roped). Returns q (S, H, hd) and
    k, v (S, KV, hd)."""
    S, D = h.shape[0], h.shape[-1]
    hd2 = cos.shape[-1]
    dt = h.dtype
    x = rms_norm_plain(h.reshape(S, D), w_norm, eps).float()
    c, s = cos.reshape(S, 1, hd2), sin.reshape(S, 1, hd2)

    def heads(w):
        return F.linear(x, w.float()).to(dt).reshape(S, -1, 2 * hd2)

    def rope(t):
        t1, t2 = t[..., :hd2], t[..., hd2:]
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], -1)

    return rope(heads(wq)), rope(heads(wk)), heads(wv)


def decode_attention_plain(q, k_rows, v_rows, k_pages, v_pages, block_tables, lengths,
                           scale: float | None = None) -> torch.Tensor:
    """Phase ATTN of ``_decode_call`` (pallasex.py:1480): slot ``b`` attends
    keys ``j < lengths[b]`` of its pages, with position ``lengths[b] - 1``
    taken from the fresh rows ``k_rows``/``v_rows`` (KV, S, hd), never from
    the pools; scores in float32, the probabilities rounded to q's dtype
    before the PV product, ``(acc / l)`` rounded once. q (S, H, hd); returns
    the merged heads (S, H * hd)."""
    S, H, hd = q.shape
    KV, P, ps, _ = k_pages.shape
    G = H // KV
    L = block_tables.shape[1] * ps
    dt = q.dtype
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    idx = block_tables.reshape(-1).long()
    k = k_pages.index_select(1, idx).reshape(KV, S, L, hd)
    v = v_pages.index_select(1, idx).reshape(KV, S, L, hd)
    slot, fresh = torch.arange(S, device=q.device), lengths.long() - 1
    k[:, slot, fresh] = k_rows
    v[:, slot, fresh] = v_rows
    qg = q.reshape(S, KV, G, hd).transpose(0, 1).float()             # (KV, S, G, hd)
    scores = torch.matmul(qg, k.float().transpose(-1, -2)) * scale    # (KV, S, G, L)
    valid = torch.arange(L, device=q.device)[None, :] < lengths.long()[:, None]
    scores = scores.masked_fill(~valid[None, :, None, :], float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    acc = torch.matmul(p.to(dt).float(), v.float())
    attn = (acc / p.sum(-1, keepdim=True)).to(dt)
    return attn.transpose(0, 1).reshape(S, H * hd)


def decode_mlp_plain(hacc, dt, mlp_norm, w_gate, w_up, w_down, act: str = "silu",
                     eps: float = 1e-5) -> torch.Tensor:
    """Phase MLP of ``_decode_call`` (pallasex.py:1543) on the float32
    residual accumulator ``hacc`` (S, D), which is never rounded: the second
    norm from it, ``act(gate)`` and ``up`` each rounded to ``dt`` before
    their product, the down product summed in float32 and ``hacc + down``
    rounded once."""
    x2 = (hacc * torch.rsqrt(torch.mean(hacc * hacc, -1, keepdim=True) + eps)).to(dt)
    x2 = (x2 * mlp_norm).float()
    ga = _ACTS[act](F.linear(x2, w_gate.float())).to(dt)
    u = F.linear(x2, w_up.float()).to(dt)
    return (hacc + F.linear((ga * u).float(), w_down.float())).to(dt)


def _decode_plain(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                  lengths, mlp, act, eps, scale):
    q, k, v = decode_qkv_plain(h, w_norm, wq, wk, wv, cos, sin, eps)
    k_rows, v_rows = k.transpose(0, 1).contiguous(), v.transpose(0, 1).contiguous()
    attn = decode_attention_plain(q, k_rows, v_rows, k_pages, v_pages, block_tables, lengths,
                                  scale)
    proj = F.linear(attn.float(), wo.float())
    if mlp is None:
        out = proj.to(h.dtype)
    else:
        S, D = h.shape[0], h.shape[-1]
        out = decode_mlp_plain(h.reshape(S, D).float() + proj, h.dtype, *mlp, act, eps)
    return out.reshape(h.shape), k_rows, v_rows


def attn_subblock_plain(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                        lengths, write_pos, eps: float = 1e-5, scale: float | None = None):
    """The attention sub-block of one decode step, rounded where
    ``_attn_subblock_kernel`` (pallasex.py:1600) rounds: ``(out, k_rows,
    v_rows)`` with ``out = merge_heads(attn) @ wo.T`` (S, 1, D) before the
    residual add, summed in float32 and rounded once, and this step's roped
    k and v rows (KV, S, hd). ``write_pos`` is where the caller stores the
    rows; the pools are only read. In float32 it is the reference's
    ``nn.attn_subblock`` decomposition (ops/nn.py:469); in bfloat16 it is
    not (rope, the probabilities and the projection round elsewhere)."""
    return _decode_plain(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                         lengths, None, "silu", eps, scale)


def decode_layer_plain(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                       lengths, write_pos, mlp_norm, w_gate, w_up, w_down, act: str = "silu",
                       eps: float = 1e-5, scale: float | None = None):
    """The whole decode layer, rounded where ``_decode_layer_kernel``
    (pallasex.py:1574) rounds: ``(out, k_rows, v_rows)``. The residual stream
    stays in a float32 accumulator ``hacc = h + attn @ wo.T`` that is never
    rounded; the second norm reads it and only ``out = hacc + mlp`` rounds.
    In float32 it is the reference's ``nn.decode_layer`` decomposition
    (ops/nn.py:530); in bfloat16 it is not (the decomposition rounds the
    projection and ``h + proj`` first)."""
    _check_act("decode_layer", act)
    return _decode_plain(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                         block_tables, lengths, (mlp_norm, w_gate, w_up, w_down), act, eps,
                         scale)


def _store_fresh_rows(k_pages, v_pages, k_rows, v_rows, write_pos) -> None:
    decode_row_write(k_pages, k_rows.transpose(0, 1).unsqueeze(2), write_pos)
    decode_row_write(v_pages, v_rows.transpose(0, 1).unsqueeze(2), write_pos)


@routed("attn_subblock")
def attn_subblock(h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
                  write_pos, eps: float = 1e-5, scale: float | None = None) -> torch.Tensor:
    """The serving attention sub-block of one T == 1 decode step::

        x     = rms_norm(h, w_norm)
        q,k,v = rope(split_heads(x @ wq/wk/wv.T))       # v un-roped
        attn  = paged attention of q over the pools and this step's k/v rows
        out   = merge_heads(attn) @ wo.T                # residual add outside

    h (S, 1, D); cos/sin (S, 1, 1, hd/2); pools (KV, P, ps, hd);
    block_tables (S, npg), lengths (S,) including this token, write_pos (S,)
    flat pool positions. Returns ``out`` (S, 1, D) and stores this step's
    k/v rows into the pools in place at ``write_pos`` (replace semantics:
    idle slots all hit position 0). Decode only; no autograd."""
    args = (h, w_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
            write_pos)
    if _on_cuda(h, "attn_subblock"):
        out, k_rows, v_rows = cudaex.attn_subblock(*args, eps=eps, scale=scale)
    else:
        out, k_rows, v_rows = attn_subblock_plain(*args, eps=eps, scale=scale)
    _store_fresh_rows(k_pages, v_pages, k_rows, v_rows, write_pos)
    return out


def decode_layer_subblocks(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                           block_tables, lengths, write_pos, mlp_norm, w_gate, w_up, w_down,
                           act: str = "silu", eps: float = 1e-5,
                           scale: float | None = None) -> torch.Tensor:
    """:func:`decode_layer` as the reference decomposes it (ops/nn.py:530):
    :func:`attn_subblock`, then :func:`mlp_subblock` on ``h + proj`` — two
    launches on CUDA, the rung below :func:`decode_layer` while the
    quarantine routes it off. The same function as :func:`decode_layer`,
    rounded elsewhere in bfloat16."""
    proj = attn_subblock(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages,
                         block_tables, lengths, write_pos, eps=eps, scale=scale)
    return mlp_subblock(h, proj, mlp_norm, w_gate, w_up, w_down, act=act, eps=eps)


@routed("decode_layer", decode_layer_subblocks)
def decode_layer(h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables,
                 lengths, write_pos, mlp_norm, w_gate, w_up, w_down, act: str = "silu",
                 eps: float = 1e-5, scale: float | None = None) -> torch.Tensor:
    """One whole transformer decode layer (T == 1): :func:`attn_subblock`,
    the residual add, and the SwiGLU MLP sub-block with its residual add.
    Returns ``out`` (S, 1, D) and stores this step's k/v rows into the pools
    in place, as :func:`attn_subblock` does. On CUDA it is one launch."""
    args = (h, attn_norm, wq, wk, wv, wo, cos, sin, k_pages, v_pages, block_tables, lengths,
            write_pos, mlp_norm, w_gate, w_up, w_down)
    if _on_cuda(h, "decode_layer"):
        out, k_rows, v_rows = cudaex.decode_layer(*args, act=act, eps=eps, scale=scale)
    else:
        out, k_rows, v_rows = decode_layer_plain(*args, act=act, eps=eps, scale=scale)
    _store_fresh_rows(k_pages, v_pages, k_rows, v_rows, write_pos)
    return out
