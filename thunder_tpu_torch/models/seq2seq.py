"""Encoder-decoder transformer (BART/T5-style) with cross-attention, in
PyTorch: a bidirectional encoder, a causal decoder that attends the
encoder's states (the one attention pattern with T != S), learned
positions, RMSNorm, a gelu FFN and a lm_head tied to the token embedding.

The counterpart of ``thunder_tpu/models/seq2seq.py``: the same configs,
parameter tree and scale (:func:`init_params` from an explicit
``torch.Generator``; :func:`params_from_jax` carries the reference's numpy
tree across). Kernel calls as in the reference's training trace: flash
attention (causal in the decoder's self-attention, non-causal elsewhere),
``rms_norm_residual`` for every norm, each with the residual or position
add before it folded in, and ``ce_fwd`` in :func:`loss_fn`. Where no
gradient is taken, the reference's trace keeps the two embedding adds
(their position rows broadcast over the batch) apart from their norms,
``rms_norm`` runs there, and each FFN's ``gelu(linear(x, w1))`` is one
``linear_act``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from thunder_tpu_torch.models import gpt as _gpt
from thunder_tpu_torch.models import llama as _llama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.optim import tree_map


@dataclass(frozen=True)
class Seq2SeqConfig:
    name: str = "tiny"
    vocab_size: int = 512
    dim: int = 64
    n_heads: int = 4
    enc_layers: int = 2
    dec_layers: int = 2
    ffn_dim: int = 256
    max_seq_len: int = 128
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS = {
    "tiny": Seq2SeqConfig(),
    "bart-base": Seq2SeqConfig(name="bart-base", vocab_size=50265, dim=768, n_heads=12,
                               enc_layers=6, dec_layers=6, ffn_dim=3072, max_seq_len=1024),
}


def init_params(cfg: Seq2SeqConfig, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's shapes and scale: dense
    weights ``N(0, 0.02^2)`` in ``cfg.dtype``, norm weights ones."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, F_ = cfg.dim, cfg.ffn_dim

    def dense(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(0.02).to(cfg.dtype)

    def ones():
        return torch.ones(D, dtype=cfg.dtype, device=device)

    def attn():
        return {"wq": dense(D, D), "wk": dense(D, D), "wv": dense(D, D), "wo": dense(D, D)}

    def ffn():
        return {"w1": dense(F_, D), "w2": dense(D, F_)}

    return {
        "tok_embedding": dense(cfg.vocab_size, D),
        "pos_embedding": dense(cfg.max_seq_len, D),
        "enc": [{"attn": attn(), "attn_norm": ones(), "ffn": ffn(), "ffn_norm": ones()}
                for _ in range(cfg.enc_layers)],
        "dec": [{"self_attn": attn(), "self_norm": ones(), "cross_attn": attn(),
                 "cross_norm": ones(), "ffn": ffn(), "ffn_norm": ones()}
                for _ in range(cfg.dec_layers)],
        "final_norm": ones(),
    }


def params_from_jax(tree, device: str | torch.device = "cuda") -> dict:
    return tree_map(lambda a: _llama._tensor_from_numpy(a).to(device), tree)


def _attend(x, kv, blk, cfg: Seq2SeqConfig, *, causal: bool):
    """Multi-head attention of ``x`` (B, T, D) over ``kv`` (B, S, D); ``kv``
    is ``x`` for self-attention and the encoder's states for
    cross-attention (T != S, not causal)."""
    B, T, S = x.shape[0], x.shape[1], kv.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim
    q = F.linear(x, blk["wq"]).reshape(B, T, H, hd).transpose(1, 2)
    k = F.linear(kv, blk["wk"]).reshape(B, S, H, hd).transpose(1, 2)
    v = F.linear(kv, blk["wv"]).reshape(B, S, H, hd).transpose(1, 2)
    o = tnn.scaled_dot_product_attention(q, k, v, is_causal=causal)
    return F.linear(o.transpose(1, 2).reshape(B, T, cfg.dim), blk["wo"])


def _ffn(x, blk):
    return F.linear(_gpt.linear_gelu(x, blk["w1"]), blk["w2"])


def _embed_norm(params, tokens, w, cfg: Seq2SeqConfig):
    """``(h, rms_norm(h, w))`` for ``h`` = token embedding + position rows.
    With a gradient taken the add folds into ``rms_norm_residual`` (the
    position rows expanded over the batch), as the reference's training
    trace claims it; without, the reference's trace keeps the broadcast
    add apart and runs ``rms_norm``."""
    T = tokens.shape[1]
    if T > cfg.max_seq_len:
        raise ValueError(f"sequence length {T} exceeds max_seq_len {cfg.max_seq_len}")
    tok = F.embedding(tokens.long(), params["tok_embedding"])
    pos = params["pos_embedding"][:T].unsqueeze(0)
    if tnn._needs_grad(tok, pos):
        return tnn.rms_norm_residual(tok, pos.expand_as(tok), w, eps=cfg.norm_eps)
    h = tok + pos
    return h, tnn.rms_norm(h, w, eps=cfg.norm_eps)


def encode(params: dict, src_tokens: torch.Tensor, cfg: Seq2SeqConfig) -> torch.Tensor:
    """Bidirectional encoder: (B, S) integer -> (B, S, D)."""
    layers = params["enc"]
    h, x = _embed_norm(params, src_tokens, layers[0]["attn_norm"], cfg)
    for i, layer in enumerate(layers):
        h, x = tnn.rms_norm_residual(h, _attend(x, x, layer["attn"], cfg, causal=False),
                                     layer["ffn_norm"], eps=cfg.norm_eps)
        out = _ffn(x, layer["ffn"])
        if i + 1 == len(layers):
            return h + out
        h, x = tnn.rms_norm_residual(h, out, layers[i + 1]["attn_norm"], eps=cfg.norm_eps)
    return h


def decode(params: dict, tgt_tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: Seq2SeqConfig) -> torch.Tensor:
    """Causal decoder with cross-attention: (B, T) + (B, S, D) -> logits
    (B, T, vocab)."""
    layers = params["dec"]
    norms = [layer["self_norm"] for layer in layers] + [params["final_norm"]]
    h, x = _embed_norm(params, tgt_tokens, norms[0], cfg)
    eps = cfg.norm_eps
    for i, layer in enumerate(layers):
        h, x = tnn.rms_norm_residual(h, _attend(x, x, layer["self_attn"], cfg, causal=True),
                                     layer["cross_norm"], eps=eps)
        h, x = tnn.rms_norm_residual(h, _attend(x, enc_out, layer["cross_attn"], cfg,
                                                causal=False), layer["ffn_norm"], eps=eps)
        h, x = tnn.rms_norm_residual(h, _ffn(x, layer["ffn"]), norms[i + 1], eps=eps)
    # tied lm_head: project onto the token embedding
    return F.linear(x, params["tok_embedding"])


def forward(params: dict, src_tokens: torch.Tensor, tgt_tokens: torch.Tensor,
            cfg: Seq2SeqConfig) -> torch.Tensor:
    return decode(params, tgt_tokens, encode(params, src_tokens, cfg), cfg)


def loss_fn(params: dict, src_tokens: torch.Tensor, tgt_tokens: torch.Tensor,
            labels: torch.Tensor, cfg: Seq2SeqConfig) -> torch.Tensor:
    logits = forward(params, src_tokens, tgt_tokens, cfg)
    B, T, V = logits.shape
    return tnn.cross_entropy(logits.reshape(B * T, V).float(), labels.reshape(B * T))
