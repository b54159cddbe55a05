"""nanoGPT-style GPT-2 in PyTorch: learned position embeddings, pre-LN
blocks with one fused qkv projection, a tanh-gelu MLP, the lm_head tied to
the token embedding.

The counterpart of ``thunder_tpu/models/nanogpt.py``: the same configs,
parameter tree and scale (:func:`init_params` from an explicit
``torch.Generator``; :func:`params_from_jax` carries the reference's numpy
tree across). Kernel calls: flash attention for every layer and ``ce_fwd``
in :func:`loss_fn`; the layer norms stay ``F.layer_norm`` (the reference
has no kernel for them); ``gelu(linear(x, w_fc))`` is one ``linear_act``
only where no gradient is taken, as in :mod:`.gpt`.

Dropout (``cfg.dropout > 0`` with ``training=True``) draws its masks from
an explicit ``torch.Generator`` (``generator=``), so the sampled masks
differ from the reference's by design; the attention's dropout runs, as in
the reference, through the plain attention decomposition (the flash
kernels take no dropout).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from thunder_tpu_torch.models import gpt as _gpt
from thunder_tpu_torch.models import llama as _llama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.optim import tree_map


@dataclass(frozen=True)
class GPTConfig:
    name: str = "gpt2-tiny"
    vocab_size: int = 512
    block_size: int = 128
    n_layer: int = 4
    n_head: int = 4
    n_embd: int = 64
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32


CONFIGS = {
    "gpt2-tiny": GPTConfig(),
    "gpt2": GPTConfig(name="gpt2", vocab_size=50257, block_size=1024, n_layer=12,
                      n_head=12, n_embd=768),
    "gpt2-xl": GPTConfig(name="gpt2-xl", vocab_size=50257, block_size=1024, n_layer=48,
                         n_head=25, n_embd=1600, dtype=torch.bfloat16),
}


def init_params(cfg: GPTConfig, seed: int = 0, device: str | torch.device = "cuda",
                n_layers: int | None = None) -> dict:
    """Random parameters with the reference's shapes and scale: dense
    weights ``N(0, 0.02^2)`` drawn in float32 and cast to ``cfg.dtype``,
    layer-norm weights ones, biases zeros."""
    device = torch.device(device)
    n = n_layers if n_layers is not None else cfg.n_layer
    gen = torch.Generator(device=device).manual_seed(seed)
    D = cfg.n_embd

    def dense(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(0.02).to(cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    def ln():
        return {"w": torch.ones(D, dtype=cfg.dtype, device=device), "b": zeros(D)}

    params = {"wte": dense(cfg.vocab_size, D), "wpe": dense(cfg.block_size, D), "ln_f": ln(),
              "blocks": []}
    for _ in range(n):
        params["blocks"].append({
            "ln1": ln(),
            "attn_qkv": {"w": dense(3 * D, D), "b": zeros(3 * D)},
            "attn_proj": {"w": dense(D, D), "b": zeros(D)},
            "ln2": ln(),
            "mlp_fc": {"w": dense(4 * D, D), "b": zeros(4 * D)},
            "mlp_proj": {"w": dense(D, 4 * D), "b": zeros(D)},
        })
    return params


def params_from_jax(tree, device: str | torch.device = "cuda") -> dict:
    return tree_map(lambda a: _llama._tensor_from_numpy(a).to(device), tree)


def dropout(a: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """The reference's dropout (``ops/nn.py:242``): keep each value with
    probability ``1 - p`` and scale the kept ones by ``1 / (1 - p)``, the
    mask drawn from ``generator``."""
    keep = (torch.rand(a.shape, generator=generator, device=a.device) < 1.0 - p).to(a.dtype)
    return a * keep * (1.0 / (1.0 - p))


def _attention_dropout(q, k, v, p: float, generator) -> torch.Tensor:
    """Causal attention with dropout on the probabilities: the reference's
    decomposition (``ops/nn.py:605-627``), which it differentiates in place
    of the flash pair when ``dropout_p > 0``."""
    T, S = q.shape[-2], k.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    keep = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), -1)
    return torch.matmul(dropout(probs, p, generator), v.float()).to(q.dtype)


def forward(params: dict, tokens: torch.Tensor, cfg: GPTConfig, training: bool = False,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, vocab). ``training`` with
    ``cfg.dropout > 0`` applies dropout after the embeddings, to the
    attention probabilities, and after each residual branch, with masks
    from ``generator``."""
    B, T = tokens.shape
    D, H = cfg.n_embd, cfg.n_head
    hd = D // H
    drop = training and cfg.dropout > 0

    h = F.embedding(tokens.long(), params["wte"]) + params["wpe"][:T]
    if drop:
        h = dropout(h, cfg.dropout, generator)
    for blk in params["blocks"]:
        x = F.layer_norm(h, (D,), blk["ln1"]["w"], blk["ln1"]["b"])
        qkv = F.linear(x, blk["attn_qkv"]["w"], blk["attn_qkv"]["b"])
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
        if drop:
            att = _attention_dropout(q, k, v, cfg.dropout, generator)
        else:
            att = tnn.scaled_dot_product_attention(q, k, v, is_causal=True)
        att = F.linear(att.transpose(1, 2).reshape(B, T, D), blk["attn_proj"]["w"],
                       blk["attn_proj"]["b"])
        if drop:
            att = dropout(att, cfg.dropout, generator)
        h = h + att
        x = F.layer_norm(h, (D,), blk["ln2"]["w"], blk["ln2"]["b"])
        m = _gpt.linear_gelu(x, blk["mlp_fc"]["w"], blk["mlp_fc"]["b"], approximate="tanh")
        m = F.linear(m, blk["mlp_proj"]["w"], blk["mlp_proj"]["b"])
        if drop:
            m = dropout(m, cfg.dropout, generator)
        h = h + m
    h = F.layer_norm(h, (D,), params["ln_f"]["w"], params["ln_f"]["b"])
    return F.linear(h, params["wte"])   # weight-tied head


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor, cfg: GPTConfig,
            training: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
    logits = forward(params, tokens, cfg, training=training, generator=generator)
    B, T, V = logits.shape
    return tnn.cross_entropy(logits.reshape(B * T, V).float(), targets.reshape(B * T))
