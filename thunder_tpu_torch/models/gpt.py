"""Configurable multi-family transformer in PyTorch: the model zoo's GPT.

The counterpart of ``thunder_tpu/models/gpt.py``: one functional
``forward`` over the same ``Config`` switches and named configs (the
published geometries of GPT-2-medium, Pythia, Falcon, Gemma and Phi, and
the tiny variants the tests drive), the same parameter tree and scale
(:func:`init_params`, drawn from an explicit ``torch.Generator``;
:func:`params_from_jax` carries the reference's numpy tree across).

- ``norm``: "layernorm" (plain ``F.layer_norm``: the reference has no
  kernel for it) | "rmsnorm" (the ``rms_norm`` kernels);
- ``mlp``: "gelu" | "swiglu" | "geglu";
- ``pos``: "rope" (``rotary_pct`` for partial rotary) | "learned";
- ``parallel_residual``, ``n_kv_heads`` (MQA/GQA), ``tie_embedding`` (one
  tensor used twice: autograd sums its two gradients), ``emb_scale``,
  ``qkv_bias``, ``mlp_bias``.

The kernel calls are the reference's traces': flash attention for every
layer, ``ce_fwd`` in :func:`loss_fn`; with rmsnorm, ``rms_norm`` for a norm
that no residual add precedes and ``rms_norm_residual`` for every other
(the reference's epilogue pass rewrites ``add -> rms_norm``). The gelu MLP's
``act(linear(x, w))`` becomes one ``linear_act`` only where no gradient is
taken: the reference's epilogue pass fuses it only where the pre-activation
does not escape the trace, and a train step's gelu backward saves it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from thunder_tpu_torch.models import llama as _llama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.optim import tree_leaves, tree_map


@dataclass(frozen=True)
class Config:
    name: str = "tiny"
    vocab_size: int = 512
    dim: int = 64
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int | None = None
    intermediate_size: int | None = None  # default 4*dim
    max_seq_len: int = 256
    norm: str = "layernorm"          # "layernorm" | "rmsnorm"
    mlp: str = "gelu"                # "gelu" | "swiglu" | "geglu"
    pos: str = "rope"                # "rope" | "learned"
    rotary_pct: float = 1.0
    parallel_residual: bool = False
    tie_embedding: bool = False
    emb_scale: bool = False          # gemma: h *= sqrt(dim)
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_dim(self) -> int:
        return self.intermediate_size if self.intermediate_size is not None else 4 * self.dim


CONFIGS = {
    # tests
    "tiny": Config(),
    "tiny-neox": Config(name="tiny-neox", parallel_residual=True, rotary_pct=0.25),
    "tiny-falcon": Config(name="tiny-falcon", parallel_residual=True, n_kv_heads=1),
    "tiny-gemma": Config(name="tiny-gemma", norm="rmsnorm", mlp="geglu", tie_embedding=True,
                         emb_scale=True, intermediate_size=128),
    "tiny-phi": Config(name="tiny-phi", rotary_pct=0.5, qkv_bias=True, mlp_bias=True),
    # published geometries (the reference's litgpt configs)
    "pythia-410m": Config(name="pythia-410m", vocab_size=50304, dim=1024, n_layers=24,
                          n_heads=16, parallel_residual=True, rotary_pct=0.25,
                          max_seq_len=2048, dtype=torch.bfloat16),
    "falcon-7b": Config(name="falcon-7b", vocab_size=65024, dim=4544, n_layers=32,
                        n_heads=71, n_kv_heads=1, parallel_residual=True,
                        max_seq_len=2048, dtype=torch.bfloat16),
    "gemma-2b": Config(name="gemma-2b", vocab_size=256000, dim=2048, n_layers=18,
                       n_heads=8, n_kv_heads=1, norm="rmsnorm", mlp="geglu",
                       intermediate_size=16384, tie_embedding=True, emb_scale=True,
                       max_seq_len=8192, dtype=torch.bfloat16),
    "phi-1.5": Config(name="phi-1.5", vocab_size=50304, dim=2048, n_layers=24,
                      n_heads=32, rotary_pct=0.5, qkv_bias=True, mlp_bias=True,
                      max_seq_len=2048, dtype=torch.bfloat16),
    "gpt2-medium": Config(name="gpt2-medium", vocab_size=50257, dim=1024, n_layers=24,
                          n_heads=16, pos="learned", tie_embedding=True,
                          max_seq_len=1024, dtype=torch.bfloat16),
}


def _param_shapes(cfg: Config, n_layers: int) -> dict:
    """The parameter tree as ``(kind, shape, fan_in)`` leaves: kind
    ``dense`` (N(0, 1/fan_in)), ``ones`` or ``zeros``; the order of the
    reference's draws is not kept (its keys are split per tree)."""
    D, F_ = cfg.dim, cfg.ffn_dim
    kv_dim = cfg.kv_heads * cfg.head_dim

    def dense(*shape):
        return ("dense", shape, shape[-1])

    def norm():
        p = {"w": ("ones", (D,), None)}
        if cfg.norm == "layernorm":
            p["b"] = ("zeros", (D,), None)
        return p

    tree = {"wte": dense(cfg.vocab_size, D), "norm_f": norm(), "layers": []}
    if cfg.pos == "learned":
        tree["wpe"] = dense(cfg.max_seq_len, D)
    if not cfg.tie_embedding:
        tree["lm_head"] = dense(cfg.vocab_size, D)
    for _ in range(n_layers):
        layer = {"norm1": norm(), "wq": dense(D, D), "wk": dense(kv_dim, D),
                 "wv": dense(kv_dim, D), "wo": dense(D, D)}
        if cfg.qkv_bias:
            layer.update(bq=("zeros", (D,), None), bk=("zeros", (kv_dim,), None),
                         bv=("zeros", (kv_dim,), None))
        if not cfg.parallel_residual:
            layer["norm2"] = norm()
        if cfg.mlp == "gelu":
            layer.update(w_fc=dense(F_, D), w_proj=dense(D, F_))
            if cfg.mlp_bias:
                layer.update(b_fc=("zeros", (F_,), None), b_proj=("zeros", (D,), None))
        else:  # swiglu / geglu
            layer.update(w_gate=dense(F_, D), w_up=dense(F_, D), w_down=dense(D, F_))
        tree["layers"].append(layer)
    return tree


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], str)


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def init_params(cfg: Config, seed: int = 0, device: str | torch.device = "cuda",
                n_layers: int | None = None) -> dict:
    """Random parameters with the reference's shapes and scale: dense
    weights ``N(0, 1/fan_in)`` drawn in float32 and cast to ``cfg.dtype``
    (linear weights ``(out, in)``), norm weights ones, biases zeros.
    ``n_layers`` builds fewer layers than the config (the reference's
    ``scale_layers``)."""
    device = torch.device(device)
    n = n_layers if n_layers is not None else cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(spec):
        kind, shape, fan_in = spec
        if kind == "dense":
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            return w.mul_(1.0 / math.sqrt(fan_in)).to(cfg.dtype)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=cfg.dtype, device=device)

    return _map_specs(make, _param_shapes(cfg, n))


def params_from_jax(tree, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_params`` tree, its leaves already numpy
    arrays, as this package's parameter tree on ``device``."""
    return tree_map(lambda a: _llama._tensor_from_numpy(a).to(device), tree)


def num_params(cfg: Config, n_layers: int | None = None) -> int:
    """Parameter count at ``n_layers`` layers (the config's by default),
    counted from the parameter shapes."""
    n = n_layers if n_layers is not None else cfg.n_layers
    sizes = _map_specs(lambda spec: math.prod(spec[1]), _param_shapes(cfg, n))
    return sum(tree_leaves(sizes))


def _norm(x, p, cfg: Config):
    if cfg.norm == "rmsnorm":
        return tnn.rms_norm(x, p["w"], eps=cfg.norm_eps)
    return F.layer_norm(x, (cfg.dim,), p["w"], p["b"], eps=cfg.norm_eps)


def _add_norm(h, delta, p, cfg: Config):
    """``(h + delta, norm(h + delta))``: one ``rms_norm_residual`` with
    rmsnorm, the add and ``F.layer_norm`` with layernorm."""
    if cfg.norm == "rmsnorm":
        return tnn.rms_norm_residual(h, delta, p["w"], eps=cfg.norm_eps)
    h = h + delta
    return h, _norm(h, p, cfg)


def _rope_tables(cfg: Config, T: int, dtype, device):
    """cos/sin (T, rot/2) for the first ``rot`` dims of each head, computed
    in float32 and cast to ``dtype``; ``rot`` = head_dim * rotary_pct,
    rounded down to even."""
    rot = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
    pos = torch.arange(T, device=device).to(torch.float32)
    idx = torch.arange(rot // 2, device=device).to(torch.float32)
    inv_freq = torch.pow(cfg.rope_theta, (idx * -2.0) / float(rot))
    angles = pos.unsqueeze(1) * inv_freq.unsqueeze(0)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype), rot


def _apply_rope(x, cos, sin, rot: int):
    """Partial rotary: NeoX half rotation on the first ``rot`` dims."""
    if rot == 0:
        return x
    x1, x2 = x[..., : rot // 2], x[..., rot // 2: rot]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    if rot == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rot:]], -1)


def _attention(x, layer, cfg: Config, rope):
    B, T, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.kv_heads
    q = F.linear(x, layer["wq"], layer.get("bq")).reshape(B, T, H, hd).transpose(1, 2)
    k = F.linear(x, layer["wk"], layer.get("bk")).reshape(B, T, KV, hd).transpose(1, 2)
    v = F.linear(x, layer["wv"], layer.get("bv")).reshape(B, T, KV, hd).transpose(1, 2)
    if rope is not None:
        cos, sin, rot = rope
        q, k = _apply_rope(q, cos, sin, rot), _apply_rope(k, cos, sin, rot)
    if H != KV:   # MQA / GQA: kv heads expanded to the query heads
        rep = H // KV
        k = k.unsqueeze(2).expand(B, KV, rep, T, hd).reshape(B, H, T, hd)
        v = v.unsqueeze(2).expand(B, KV, rep, T, hd).reshape(B, H, T, hd)
    attn = tnn.scaled_dot_product_attention(q, k, v, is_causal=True)
    return F.linear(attn.transpose(1, 2).reshape(B, T, H * hd), layer["wo"])


def linear_gelu(x, w, b=None, approximate: str = "none"):
    """``gelu(linear(x, w, b))``: one ``linear_act`` kernel where no gradient
    is taken (the reference's epilogue fusion); where one is, the plain
    product and gelu, whose backward keeps the pre-activation."""
    if tnn._needs_grad(x, w, b):
        return F.gelu(F.linear(x, w, b), approximate=approximate)
    return tnn.linear_act(x, w, b, act="gelu" if approximate == "none" else "gelu_tanh")


def _mlp(x, layer, cfg: Config):
    if cfg.mlp == "gelu":
        h = linear_gelu(x, layer["w_fc"], layer.get("b_fc"))
        return F.linear(h, layer["w_proj"], layer.get("b_proj"))
    if cfg.mlp == "swiglu":
        y = F.linear(x, layer["w_gate"])
        gate = y * torch.sigmoid(y)
    else:
        gate = linear_gelu(x, layer["w_gate"])
    return F.linear(gate * F.linear(x, layer["w_up"]), layer["w_down"])


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: Config) -> torch.Tensor:
    """tokens (B, T) -> the final normed hidden states (B, T, D)."""
    T = tokens.shape[1]
    h = F.embedding(tokens.long(), params["wte"])
    if cfg.emb_scale:
        h = h * math.sqrt(cfg.dim)
    rope = _rope_tables(cfg, T, h.dtype, h.device) if cfg.pos == "rope" else None
    layers = params["layers"]
    norms = [layer["norm1"] for layer in layers] + [params["norm_f"]]
    if cfg.pos == "learned":
        h, x = _add_norm(h, params["wpe"][:T].expand_as(h), norms[0], cfg)
    else:
        x = _norm(h, norms[0], cfg)
    for i, layer in enumerate(layers):
        if cfg.parallel_residual:
            # NeoX/Falcon: one shared norm feeds both attn and MLP
            h, x = _add_norm(h, _attention(x, layer, cfg, rope) + _mlp(x, layer, cfg),
                             norms[i + 1], cfg)
        else:
            h, x = _add_norm(h, _attention(x, layer, cfg, rope), layer["norm2"], cfg)
            h, x = _add_norm(h, _mlp(x, layer, cfg), norms[i + 1], cfg)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: Config) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, vocab)."""
    head_w = params["wte"] if cfg.tie_embedding else params["lm_head"]
    return F.linear(forward_hidden(params, tokens, cfg), head_w)


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: Config) -> torch.Tensor:
    """Mean next-token cross-entropy of the float32 logits."""
    logits = forward(params, tokens, cfg)
    B, T, V = logits.shape
    return tnn.cross_entropy(logits.reshape(B * T, V).float(), targets.reshape(B * T))
