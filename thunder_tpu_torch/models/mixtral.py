"""Mixtral-style mixture-of-experts transformer in PyTorch.

The counterpart of ``thunder_tpu/models/mixtral.py``: the same configs
(``CONFIGS``, with torch dtypes) and expert-parallel patterns, the same
parameter tree and scale (:func:`init_params`, drawn from an explicit
``torch.Generator``; :func:`params_from_jax` carries the reference's numpy
tree across), Llama attention blocks and top-k routed SwiGLU experts with
the reference's GShard capacity dispatch by index (:func:`moe_ffn`): the
router's float32 softmax and top-k, each token's queue position from the
cumsum, one gather of the tokens into ``(E, C)`` expert slots, three
batched float32 expert products, and one weighted gather back.

The kernel calls are the reference's per-op training trace's: the flash
attention pair for every layer, ``rms_norm`` for the first layer's
``attn_norm`` and ``rms_norm_residual`` (the residual add folded in, as the
reference's epilogue pass rewrites ``add -> rms_norm``) for every later
norm, ``ce_fwd`` in :func:`loss_fn`. ``remat=True`` checkpoints each block
(:func:`thunder_tpu_torch.core.rematerialization.checkpoint`) with the
kernel calls of the reference's checkpointed trace, as
``models/llama._remat_block`` makes them.

Not ported here (ROADMAP A.2, with ``pretrain --mode ep``): the
expert-parallel all-reduce and all-to-all branches of ``moe_ffn``, and the
``MIXTRAL_FORCE_EINSUM=1`` one-hot dispatch, which raises
``NotImplementedError`` here rather than being ignored.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from thunder_tpu_torch.core.rematerialization import checkpoint, recomputing
from thunder_tpu_torch.models import llama as _llama
from thunder_tpu_torch.ops import nn as tnn


@dataclass(frozen=True)
class MixtralConfig:
    name: str = "tiny-moe"
    vocab_size: int = 512
    dim: int = 64
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int | None = None
    intermediate_size: int = 128
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    # dropless: per-expert capacity C = S, the static worst case (a token
    # reaches an expert at most once), so no token is ever dropped
    dropless: bool = False
    max_seq_len: int = 256
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    router_aux_coef: float = 0.01
    dtype: torch.dtype = torch.float32

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS = {
    "tiny-moe": MixtralConfig(),
    "mixtral-8x7b": MixtralConfig(
        name="mixtral-8x7b", vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, intermediate_size=14336, n_experts=8, top_k=2,
        max_seq_len=4096, rope_theta=1e6, dtype=torch.bfloat16),
}

# the parameter paths expert parallelism shards over its axis (ROADMAP A.2)
EP_PATTERNS = (r"\['we_gate'\]", r"\['we_up'\]", r"\['we_down'\]")

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", "we_gate", "we_up",
               "we_down")


def init_params(cfg: MixtralConfig, seed: int = 0, device: str | torch.device = "cuda",
                n_layers: int | None = None) -> dict:
    """Random parameters with the reference's shapes and scale: every dense
    weight ``N(0, 1/fan_in)`` drawn in float32 and cast to ``cfg.dtype``
    (linear weights ``(out, in)``, expert weights ``(E, out, in)``), every
    norm weight ones. ``n_layers`` builds fewer layers than the config (the
    reference's ``scale_layers``)."""
    device = torch.device(device)
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(cfg.dtype)

    def ones():
        return torch.ones(cfg.dim, dtype=cfg.dtype, device=device)

    E, I, D = cfg.n_experts, cfg.intermediate_size, cfg.dim
    kv_dim = cfg.kv_heads * cfg.head_dim
    params = {"tok_embedding": dense((cfg.vocab_size, D), D), "norm_f": ones(),
              "lm_head": dense((cfg.vocab_size, D), D), "layers": []}
    for _ in range(n_layers):
        params["layers"].append({
            "attn_norm": ones(),
            "wq": dense((D, D), D), "wk": dense((kv_dim, D), D), "wv": dense((kv_dim, D), D),
            "wo": dense((D, D), D),
            "mlp_norm": ones(),
            "router": dense((E, D), D),
            "we_gate": dense((E, I, D), D), "we_up": dense((E, I, D), D),
            "we_down": dense((E, D, I), I),
        })
    return params


def params_from_jax(tree, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_params`` tree, its leaves already numpy
    arrays, as this package's parameter dict on ``device``."""
    def conv(a):
        return _llama._tensor_from_numpy(a).to(device)

    return {"tok_embedding": conv(tree["tok_embedding"]), "norm_f": conv(tree["norm_f"]),
            "lm_head": conv(tree["lm_head"]),
            "layers": [{k: conv(layer[k]) for k in _LAYER_KEYS} for layer in tree["layers"]]}


def capacity(cfg: MixtralConfig, S: int) -> int:
    """Slots per expert for ``S`` tokens: ``S`` when dropless, else
    ``ceil(S * capacity_factor * top_k / E)`` clamped to [1, S]."""
    if cfg.dropless:
        return S
    return max(1, min(S, int(math.ceil(S * cfg.capacity_factor * cfg.top_k / cfg.n_experts))))


class _ExpertProduct(torch.autograd.Function):
    """``a @ w^T`` batched over experts in float32: ``a`` (E, C, K) float32,
    ``w`` (E, N, K) in the model dtype. The reference converts each expert
    weight to float32 before its product; here the float32 copy lives only
    inside the forward and the backward that needs it, so autograd saves
    the weight itself (at full width a layer's three float32 copies are
    5.6 GB that it would otherwise hold until the backward)."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return tnn.bmm_f32(a, w.float().transpose(1, 2))

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = tnn.bmm_f32(g, w.float())
        if ctx.needs_input_grad[1]:
            dw = tnn.bmm_f32(g.transpose(1, 2), a).to(w.dtype)
        return da, dw


_expert_product = _ExpertProduct.apply


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MixtralConfig):
    """The routing of ``x`` (S, D): ``(probs (S, E) float32, topv (S, k)
    renormalised gate weights, topi (S, k), flat_pos [k x (S,)] int64 slot
    of each assignment in the flattened ``(E * C)`` table, with the
    sentinel ``E * C`` for a dropped one, counts (E,) float32 tokens kept
    per expert, C)``. A token's queue position in an expert is the GShard
    cumsum over the tokens before it, choice by choice (all first choices
    queue ahead of any second choice)."""
    S = x.shape[0]
    E, k = router_w.shape[0], cfg.top_k
    C = capacity(cfg, S)
    probs = torch.softmax(F.linear(x.float(), router_w.float()), -1)
    topv, topi = torch.topk(probs, k, -1)
    topv = topv / torch.sum(topv, -1, keepdim=True)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    sentinel = torch.full((S,), E * C, dtype=torch.int64, device=x.device)
    flat_pos = []
    for j in range(k):
        m = F.one_hot(topi[:, j], E).float()                       # (S, E)
        pos = torch.cumsum(m, 0) - m + counts
        keep = m * (pos < float(C)).float()
        counts = counts + torch.sum(keep, 0)
        pos_j = torch.sum(pos * m, -1)                             # (S,) queue slot
        kept_j = torch.sum(keep, -1) > 0.0
        fp = topi[:, j] * C + pos_j.long()
        flat_pos.append(torch.where(kept_j, fp, sentinel))
    return probs, topv, topi, flat_pos, counts, C


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, we_gate: torch.Tensor,
            we_up: torch.Tensor, we_down: torch.Tensor, cfg: MixtralConfig,
            return_metrics: bool = False):
    """x: (S, D) flattened tokens. Returns ``(out (S, D), aux_loss)``, plus a
    metrics dict (tokens kept per expert, assignment drop rate, router load
    fractions, capacity) when ``return_metrics``.

    The slot table is written by ``index_put``: every (expert, position)
    slot is assigned once by construction, and only the sentinel bin sees
    duplicate writes, which nothing reads; dropped slots gather the zero
    pad row. The three expert products run in float32
    (:class:`_ExpertProduct` over ``ops.nn.bmm_f32``)."""
    if os.environ.get("MIXTRAL_FORCE_EINSUM") == "1":
        raise NotImplementedError("MIXTRAL_FORCE_EINSUM=1 (the one-hot einsum dispatch of the "
                                  "expert-parallel A/B) is not ported: ROADMAP A.2")
    S, D = x.shape
    E = router_w.shape[0]
    probs, topv, topi, flat_pos, counts, C = route(x, router_w, cfg)

    # load-balancing auxiliary loss (Switch/Mixtral style)
    frac_tokens = torch.mean(F.one_hot(topi[:, 0], E).float(), 0)
    frac_probs = torch.mean(probs, 0)
    aux = torch.sum(frac_tokens * frac_probs) * (float(E) * cfg.router_aux_coef)

    xf = x.float()
    slot_tokens = torch.full((E * C + 1,), S, dtype=torch.int64, device=x.device)
    token_ids = torch.arange(S, device=x.device)
    for fp in flat_pos:
        slot_tokens = slot_tokens.index_put((fp,), token_ids)
    x_padded = torch.cat([xf, xf.new_zeros(1, D)], 0)
    expert_in = x_padded.index_select(0, slot_tokens[:E * C]).reshape(E, C, D)

    gate = _expert_product(expert_in, we_gate)
    gate = gate * torch.sigmoid(gate)
    up = _expert_product(expert_in, we_up)
    expert_out = _expert_product(gate * up, we_down)                # (E, C, D)

    # combine: each token gathers its k slots back, weighted by its gate
    eo_flat = torch.cat([expert_out.reshape(E * C, D), expert_out.new_zeros(1, D)], 0)
    out = None
    for j, fp in enumerate(flat_pos):
        contrib = eo_flat.index_select(0, fp) * topv[:, j].unsqueeze(-1)
        out = contrib if out is None else out + contrib
    out = out.to(x.dtype)
    if return_metrics:
        metrics = {"tokens_per_expert": counts,
                   "drop_rate": 1.0 - torch.sum(counts) / float(S * cfg.top_k),
                   "router_load": frac_probs, "capacity": C}
        return out, aux, metrics
    return out, aux


def _moe(x: torch.Tensor, layer: dict, cfg: MixtralConfig, return_metrics: bool = False):
    B, T, D = x.shape
    res = moe_ffn(x.reshape(B * T, D), layer["router"], layer["we_gate"], layer["we_up"],
                  layer["we_down"], cfg, return_metrics=return_metrics)
    return (res[0].reshape(B, T, D),) + tuple(res[1:])


def _remat_block(h: torch.Tensor, layer: dict, cfg: MixtralConfig, cos, sin):
    """One block as a checkpointed region, with the kernel calls of the
    reference's checkpointed ``block``: ``rms_norm`` for both norms in the
    forward, the residual add folded into ``rms_norm_residual`` in the
    backward's recompute (``models/llama._remat_block``). Returns ``(h,
    aux)``."""
    x = tnn.rms_norm(h, layer["attn_norm"], eps=cfg.norm_eps)
    attn = _llama._attention_out(x, layer, cfg, cos, sin)
    if recomputing():
        h, x = tnn.rms_norm_residual(h, attn, layer["mlp_norm"], eps=cfg.norm_eps)
    else:
        h = h + attn
        x = tnn.rms_norm(h, layer["mlp_norm"], eps=cfg.norm_eps)
    moe_out, aux = _moe(x, layer, cfg)
    return h + moe_out, aux


def forward(params: dict, tokens: torch.Tensor, cfg: MixtralConfig, return_aux: bool = False,
            return_metrics: bool = False, remat: bool = False, skip_head: bool = False):
    """tokens (B, T) -> logits (B, T, vocab); with ``return_aux`` also the
    summed router aux loss, with ``return_metrics`` the aux loss and each
    layer's routing metrics. ``remat=True`` checkpoints each block (only
    the block inputs are saved; the expert intermediates are recomputed).
    ``skip_head=True`` returns ``(final normed hidden states, aux)``, the
    fused loss's input."""
    T = tokens.shape[1]
    h = F.embedding(tokens.long(), params["tok_embedding"])
    cos, sin = _llama._rope_cos_sin(cfg, T, h.dtype, device=h.device)
    layers = params["layers"]
    aux_total, layer_metrics = None, []

    def add_aux(aux):
        nonlocal aux_total
        aux_total = aux if aux_total is None else aux_total + aux

    if remat and not return_metrics:
        block = checkpoint(lambda x, layer: _remat_block(x, layer, cfg, cos, sin))
        for layer in layers:
            h, aux = block(h, layer)
            add_aux(aux)
        x = tnn.rms_norm(h, params["norm_f"], eps=cfg.norm_eps)
    else:
        # the per-op rung: each residual add folds into the norm after it
        x = tnn.rms_norm(h, layers[0]["attn_norm"], eps=cfg.norm_eps) if layers else \
            tnn.rms_norm(h, params["norm_f"], eps=cfg.norm_eps)
        for i, layer in enumerate(layers):
            nxt = layers[i + 1]["attn_norm"] if i + 1 < len(layers) else params["norm_f"]
            h, x = tnn.rms_norm_residual(h, _llama._attention_out(x, layer, cfg, cos, sin),
                                         layer["mlp_norm"], eps=cfg.norm_eps)
            res = _moe(x, layer, cfg, return_metrics)
            add_aux(res[1])
            if return_metrics:
                layer_metrics.append(res[2])
            h, x = tnn.rms_norm_residual(h, res[0], nxt, eps=cfg.norm_eps)
    if skip_head:
        return x, aux_total
    logits = F.linear(x, params["lm_head"])
    if return_metrics:
        return logits, aux_total, layer_metrics
    if return_aux:
        return logits, aux_total
    return logits


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor, cfg: MixtralConfig,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of the float32 logits plus the router
    aux loss."""
    logits, aux = forward(params, tokens, cfg, return_aux=True, remat=remat)
    B, T, V = logits.shape
    ce = tnn.cross_entropy(logits.reshape(B * T, V).float(), targets.reshape(B * T))
    return ce + aux


def fused_loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                  cfg: MixtralConfig, remat: bool = False) -> torch.Tensor:
    """The chunked-vocab loss (``lm_head`` fused into the cross-entropy,
    ``ops.nn.fused_linear_cross_entropy`` at the reference's default chunk:
    the ``(B*T, vocab)`` float32 logits never exist) plus the aux loss."""
    h, aux = forward(params, tokens, cfg, remat=remat, skip_head=True)
    B, T, D = h.shape
    ce, _ = tnn.fused_linear_cross_entropy(h.reshape(B * T, D), params["lm_head"],
                                           targets.reshape(B * T))
    return ce + aux


@torch.no_grad()
def expert_utilization(params: dict, tokens: torch.Tensor, cfg: MixtralConfig) -> list:
    """Per-layer expert routing report, run eagerly once on ``tokens``:
    tokens kept per expert, the assignment drop rate, the router load
    fractions (rounded to 4 places), the capacity, the fraction of experts
    used, and the max/mean load imbalance."""
    _logits, _aux, metrics = forward(params, tokens, cfg, return_metrics=True)
    report = []
    for m in metrics:
        tpe = m["tokens_per_expert"].cpu().numpy()
        report.append({
            "tokens_per_expert": tpe.astype(int).tolist(),
            "drop_rate": float(m["drop_rate"]),
            "router_load": np.round(m["router_load"].cpu().numpy(), 4).tolist(),
            "capacity": int(m["capacity"]),
            "expert_usage": float((tpe > 0).mean()),
            "load_imbalance": float(tpe.max() / max(tpe.mean(), 1e-9)),
        })
    return report


def capacity_sweep(params: dict, tokens: torch.Tensor, cfg: MixtralConfig,
                   factors=(1.0, 1.25, 1.5, 2.0, 4.0)) -> dict:
    """The largest per-layer assignment drop rate at each capacity factor,
    and in the dropless mode for reference."""
    out = {}
    for f in factors:
        rep = expert_utilization(params, tokens,
                                 dataclasses.replace(cfg, capacity_factor=f, dropless=False))
        out[f] = max(r["drop_rate"] for r in rep)
    rep = expert_utilization(params, tokens, dataclasses.replace(cfg, dropless=True))
    out["dropless"] = max(r["drop_rate"] for r in rep)
    return out
