"""Llama-family transformer in PyTorch: the pieces the serving slice runs
and the training forward and loss.

The counterpart of ``thunder_tpu/models/llama.py``: the same configs
(``CONFIGS``, with torch dtypes), the same parameter tree and scale
(:func:`init_params`, drawn from an explicit ``torch.Generator``, so its
numbers differ from the JAX package's for the same seed), the rope tables,
the attention/MLP projections, and ``forward_hidden``/``forward``/``loss_fn``
for training at the reference's per-op rung or, with ``block_fusion=True``,
its planned rung, or with ``remat=True`` one checkpointed region per layer;
``fused_loss_fn`` is the chunked-vocab loss of the reference's headline
train bench. The contiguous-cache inference path: :func:`init_kv_cache`,
:func:`forward_step`, :func:`generate` and :func:`generate_fused` (the
decode loop captured as one CUDA graph). :func:`params_from_jax` carries a
JAX ``init_params`` tree across as numpy, so both packages can run the same
weights.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from thunder_tpu_torch.core.rematerialization import checkpoint, recomputing
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.runtime import quarantine as _quarantine


@dataclass(frozen=True)
class LlamaConfig:
    name: str = "tiny"
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int | None = None  # GQA when < n_heads
    intermediate_size: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CONFIGS = {
    "tiny": LlamaConfig(name="tiny", vocab_size=512, dim=64, n_layers=4, n_heads=4,
                        intermediate_size=176, max_seq_len=256),
    "tiny-gqa": LlamaConfig(name="tiny-gqa", vocab_size=512, dim=64, n_layers=4, n_heads=4,
                            n_kv_heads=2, intermediate_size=176, max_seq_len=256),
    "llama2-7b": LlamaConfig(name="llama2-7b", vocab_size=32000, dim=4096, n_layers=32,
                             n_heads=32, intermediate_size=11008, max_seq_len=4096,
                             dtype=torch.bfloat16),
    # the reference's headline train bench (bench.py): llama2-7b's layer
    # geometry with seq capped at 2048
    "llama2-7b-bench": LlamaConfig(name="llama2-7b-bench", vocab_size=32000, dim=4096,
                                   n_layers=32, n_heads=32, intermediate_size=11008,
                                   max_seq_len=2048, dtype=torch.bfloat16),
    "llama3-8b": LlamaConfig(name="llama3-8b", vocab_size=128256, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, intermediate_size=14336,
                             max_seq_len=8192, rope_theta=500000.0, dtype=torch.bfloat16),
    # the reference's training bench variant: llama3-8b's per-layer geometry
    # (GQA 32/8 heads, MLP 14336) with the vocab capped at 32k and seq at 2048
    "llama3-8b-bench": LlamaConfig(name="llama3-8b-bench", vocab_size=32000, dim=4096,
                                   n_layers=32, n_heads=32, n_kv_heads=8,
                                   intermediate_size=14336, max_seq_len=2048,
                                   rope_theta=500000.0, dtype=torch.bfloat16),
}

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


def init_params(cfg: LlamaConfig, seed: int = 0, device: str | torch.device = "cuda",
                n_layers: int | None = None) -> dict:
    """Random parameters with the reference's shapes and scale: every dense
    weight is ``N(0, 1/fan_in)`` drawn in float32 and cast to ``cfg.dtype``
    (linear weights in the ``(out, in)`` layout), every norm weight is ones.
    ``n_layers`` builds fewer layers than the config (the reference's
    ``scale_layers``)."""
    device = torch.device(device)
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(cfg.dtype)

    def ones():
        return torch.ones(cfg.dim, dtype=cfg.dtype, device=device)

    D, Fd = cfg.dim, cfg.intermediate_size
    kv_dim = cfg.kv_heads * cfg.head_dim
    params = {
        "tok_embedding": dense((cfg.vocab_size, D), D),
        "norm_f": ones(),
        "lm_head": dense((cfg.vocab_size, D), D),
        "layers": [],
    }
    for _ in range(n_layers):
        params["layers"].append({
            "attn_norm": ones(),
            "wq": dense((D, D), D),
            "wk": dense((kv_dim, D), D),
            "wv": dense((kv_dim, D), D),
            "wo": dense((D, D), D),
            "mlp_norm": ones(),
            "w_gate": dense((Fd, D), D),
            "w_up": dense((Fd, D), D),
            "w_down": dense((D, Fd), Fd),
        })
    return params


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_params`` tree, its leaves already numpy
    arrays, as this package's parameter dict on ``device``. Linear weights
    keep their ``(out, in)`` layout, which is torch's."""
    def conv(a):
        return _tensor_from_numpy(a).to(device)

    return {
        "tok_embedding": conv(tree["tok_embedding"]),
        "norm_f": conv(tree["norm_f"]),
        "lm_head": conv(tree["lm_head"]),
        "layers": [{k: conv(layer[k]) for k in _LAYER_KEYS} for layer in tree["layers"]],
    }


def _rope_tables(cfg: LlamaConfig, pos: torch.Tensor, dtype: torch.dtype):
    """cos/sin for a tensor of positions: ``pos.shape + (hd/2,)``, computed
    in float32 and cast to ``dtype``."""
    hd = cfg.head_dim
    posf = pos.to(torch.float32)
    idx = torch.arange(hd // 2, device=pos.device).to(torch.float32)
    inv_freq = torch.pow(cfg.rope_theta, (idx * -2.0) / float(hd))
    angles = posf.unsqueeze(-1) * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rope_cos_sin(cfg: LlamaConfig, T: int, dtype: torch.dtype, pos_offset=None,
                  device=None):
    """Tables for the contiguous positions ``pos_offset + arange(T)``;
    ``pos_offset`` an int or a 0-d tensor (a traced prefill's chunk start,
    which stays on the device)."""
    pos = torch.arange(T, device=device).to(torch.float32)
    if pos_offset is not None:
        pos = pos + (pos_offset.to(torch.float32) if hasattr(pos_offset, "shape")
                     else float(pos_offset))
    return _rope_tables(cfg, pos, dtype)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, T, hd); GPT-NeoX half rotation."""
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _project_qkv(x: torch.Tensor, layer: dict, cfg: LlamaConfig, cos, sin):
    """RoPE'd q (B, n_heads, T, hd) and k, and v (B, kv_heads, T, hd) from a
    normed hidden state (B, T, D). ``cos``/``sin`` broadcast over (B, H, T)."""
    B, T = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    q = F.linear(x, layer["wq"]).reshape(B, T, cfg.n_heads, hd).transpose(1, 2)
    k = F.linear(x, layer["wk"]).reshape(B, T, cfg.kv_heads, hd).transpose(1, 2)
    v = F.linear(x, layer["wv"]).reshape(B, T, cfg.kv_heads, hd).transpose(1, 2)
    return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v


def _mlp(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """SwiGLU MLP of a normed hidden state, without the residual add (which
    the caller fuses into the next norm): the gate projection and its silu
    run as one ``linear_act``, as the reference's epilogue fusion builds it."""
    gate = tnn.linear_act(x, layer["w_gate"], act="silu")
    return F.linear(gate * F.linear(x, layer["w_up"]), layer["w_down"])


def _mlp_train(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """The train step's SwiGLU MLP, without the residual add: the reference's
    training trace leaves ``silu(linear(x, w_gate))`` unfused (its epilogue
    pass claims no ``linear_act`` there), so the gate is a projection and
    ``y * sigmoid(y)`` (``tnn.silu``), differentiated by autograd."""
    y = F.linear(x, layer["w_gate"])
    return F.linear(tnn.silu(y) * F.linear(x, layer["w_up"]), layer["w_down"])


def _attention_out(x: torch.Tensor, layer: dict, cfg: LlamaConfig, cos, sin) -> torch.Tensor:
    """The attention sub-block's output projection ``linear(attn, wo)`` (B,
    T, D) of a normed hidden state ``x``, before its residual add."""
    B, T = x.shape[0], x.shape[1]
    n_rep = cfg.n_heads // cfg.kv_heads
    hd = cfg.head_dim
    q, k, v = _project_qkv(x, layer, cfg, cos, sin)
    if n_rep > 1:   # GQA: repeat kv heads, so attention sees (B, n_heads, T, hd)
        k = k.unsqueeze(2).expand(B, cfg.kv_heads, n_rep, T, hd).reshape(B, cfg.n_heads, T, hd)
        v = v.unsqueeze(2).expand(B, cfg.kv_heads, n_rep, T, hd).reshape(B, cfg.n_heads, T, hd)
    attn = tnn.scaled_dot_product_attention(q, k, v, is_causal=True)
    attn = attn.transpose(1, 2).reshape(B, T, cfg.n_heads * hd)
    return F.linear(attn, layer["wo"])


def _block(h: torch.Tensor, x: torch.Tensor, layer: dict, next_norm: torch.Tensor,
           cfg: LlamaConfig, cos, sin):
    """One decoder layer at the per-op rung: GQA attention, then the SwiGLU
    MLP, on the residual stream ``h`` and its normed ``x``. The residual
    adds fold into the norms that follow them (the layer's ``mlp_norm``,
    then ``next_norm``: the next layer's ``attn_norm`` or ``norm_f``), as the
    reference's per-op training trace claims them. The MLP's gate takes
    ``linear_act`` when no gradient is needed, as the reference's grad-free
    trace claims it (its epilogue pass fuses ``silu(linear)``), and the
    unfused :func:`_mlp_train` otherwise. Returns ``(h, next_norm(h))``."""
    h, x = tnn.rms_norm_residual(h, _attention_out(x, layer, cfg, cos, sin), layer["mlp_norm"],
                                 eps=cfg.norm_eps)
    grad = tnn._needs_grad(x, layer["w_gate"], layer["w_up"], layer["w_down"])
    mlp = _mlp_train if grad else _mlp
    return tnn.rms_norm_residual(h, mlp(x, layer), next_norm, eps=cfg.norm_eps)


def _planned_block(h: torch.Tensor, layer: dict, cfg: LlamaConfig, cos, sin) -> torch.Tensor:
    """One decoder layer at the planned rung, as the reference's planned
    training trace claims it: ``rms_norm`` for attention, then ONE
    ``mlp_subblock`` that takes the attention-out residual add, ``mlp_norm``,
    the SwiGLU MLP and the second residual add. Returns the new ``h``."""
    x = tnn.rms_norm(h, layer["attn_norm"], eps=cfg.norm_eps)
    return tnn.mlp_subblock(h, _attention_out(x, layer, cfg, cos, sin), layer["mlp_norm"],
                            layer["w_gate"], layer["w_up"], layer["w_down"], act="silu",
                            eps=cfg.norm_eps)


def _remat_block(h: torch.Tensor, layer: dict, cfg: LlamaConfig, cos, sin) -> torch.Tensor:
    """One decoder layer as a checkpointed region, with the kernel calls of
    the reference's checkpointed ``_block`` (llama.py:173): the forward runs
    ``rms_norm`` for attention, the residual add and ``rms_norm`` for the
    MLP; the backward's recompute of the same region takes the add into
    ``rms_norm_residual``, as the reference's epilogue pass fuses it in the
    recomputed trace only. The two compute the same values. The residual
    adds cannot fold into the next layer's norm across the region's edge.
    Returns the new ``h``."""
    x = tnn.rms_norm(h, layer["attn_norm"], eps=cfg.norm_eps)
    attn = _attention_out(x, layer, cfg, cos, sin)
    if recomputing():
        h, x = tnn.rms_norm_residual(h, attn, layer["mlp_norm"], eps=cfg.norm_eps)
    else:
        h = h + attn
        x = tnn.rms_norm(h, layer["mlp_norm"], eps=cfg.norm_eps)
    return h + _mlp_train(x, layer)


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
                   block_fusion: bool = False, remat: bool = False) -> torch.Tensor:
    """tokens (B, T) integer -> final normed hidden states (B, T, D).

    ``block_fusion=False`` is the reference's per-op rung (residual adds
    folded into ``rms_norm_residual``); ``True`` its planned rung, which the
    reference's cost model picks at llama3-8b-bench's train shape: one
    ``mlp_subblock`` per layer and a plain ``rms_norm`` for every other
    norm. ``remat=True`` makes every layer one checkpointed region
    (:func:`_remat_block`): the backward recomputes it from its input. The
    reference plans no sub-block inside a checkpointed region, so
    ``block_fusion`` has no effect there. While the quarantine routes
    ``mlp_subblock`` off, the planned rung runs as the per-op rung."""
    T = tokens.shape[1]
    h = F.embedding(tokens.long(), params["tok_embedding"])
    layers = params["layers"]
    if not layers:
        return tnn.rms_norm(h, params["norm_f"], eps=cfg.norm_eps)
    cos, sin = _rope_cos_sin(cfg, T, h.dtype, device=h.device)
    if remat:
        block = checkpoint(lambda x, layer: _remat_block(x, layer, cfg, cos, sin))
        for layer in layers:
            h = block(h, layer)
        return tnn.rms_norm(h, params["norm_f"], eps=cfg.norm_eps)
    if block_fusion and not _quarantine.is_routed_off("cuda.mlp_subblock"):
        for layer in layers:
            h = _planned_block(h, layer, cfg, cos, sin)
        return tnn.rms_norm(h, params["norm_f"], eps=cfg.norm_eps)
    x = tnn.rms_norm(h, layers[0]["attn_norm"], eps=cfg.norm_eps)
    for i, layer in enumerate(layers):
        nxt = layers[i + 1]["attn_norm"] if i + 1 < len(layers) else params["norm_f"]
        h, x = _block(h, x, layer, nxt, cfg, cos, sin)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
            block_fusion: bool = False, remat: bool = False) -> torch.Tensor:
    """tokens (B, T) -> logits (B, T, vocab)."""
    return F.linear(forward_hidden(params, tokens, cfg, block_fusion=block_fusion, remat=remat),
                    params["lm_head"])


def loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: LlamaConfig, *, block_fusion: bool = False, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy; the logits are materialised and taken
    to float32, as the reference's unfused loss does."""
    logits = forward(params, tokens, cfg, block_fusion=block_fusion, remat=remat)
    B, T, V = logits.shape
    return tnn.cross_entropy(logits.reshape(B * T, V).float(), targets.reshape(B * T))


def fused_loss_fn(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                  cfg: LlamaConfig, chunk: int | None = 8192, remat: bool = False,
                  block_fusion: bool = False) -> torch.Tensor:
    """Chunked-vocab loss (llama.py:240): the lm_head projection fused into
    the cross-entropy (``ops.nn.fused_linear_cross_entropy``), so the
    ``(B*T, vocab)`` logits are never materialised. ``chunk`` is the
    reference's default, 8192 vocab columns (None takes the op's own
    default)."""
    h = forward_hidden(params, tokens, cfg, block_fusion=block_fusion, remat=remat)
    B, T, D = h.shape
    loss, _ = tnn.fused_linear_cross_entropy(h.reshape(B * T, D), params["lm_head"],
                                             targets.reshape(B * T), chunk=chunk)
    return loss


# ---------------------------------------------------------------------------
# KV-cache inference over a contiguous cache (the reference's llama.py:340-575)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None,
                  n_layers: int | None = None, device: str | torch.device = "cuda"):
    """Per-layer K/V buffers ``(B, kv_heads, max_len, head_dim)`` on
    ``device``, zeroed."""
    max_len = max_len or cfg.max_seq_len
    n = n_layers if n_layers is not None else cfg.n_layers
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)} for _ in range(n)]


def _cache_attention(q, ck, cv, valid, out_dtype) -> torch.Tensor:
    """Grouped-query attention of ``q`` (B, H, T, hd) over the whole
    contiguous cache (B, KV, max_len, hd), masked by ``valid`` (T,
    max_len), without expanding the cache: the group folds into q's rows.
    Scores and softmax in float32, the weights rounded to ``out_dtype``
    before the product with V. Returns (B, T, H * hd)."""
    B, H, T, hd = q.shape
    KV, max_len = ck.shape[1], ck.shape[2]
    n_rep = H // KV
    qg = q.reshape(B * KV, n_rep * T, hd)
    scores = tnn.bmm_f32(qg, ck.reshape(B * KV, max_len, hd).transpose(1, 2))
    scores = (scores * (1.0 / math.sqrt(hd))).reshape(B, H, T, max_len)
    scores = torch.where(valid, scores, float("-inf"))
    w = torch.softmax(scores, -1).to(out_dtype).reshape(B * KV, n_rep * T, max_len)
    attn = torch.bmm(w, cv.reshape(B * KV, max_len, hd)).reshape(B, H, T, hd)
    return attn.transpose(1, 2).reshape(B, T, H * hd)


def forward_step(params: dict, tokens: torch.Tensor, cache: list, pos, cfg: LlamaConfig,
                 last_idx=None):
    """Incremental forward: ``tokens`` (B, T) occupy positions [pos, pos +
    T) of the contiguous ``cache`` (:func:`init_kv_cache`), which this
    writes in place. ``pos`` is an int or a 0-d integer tensor on the
    tokens' device (a captured decode step reads it there). Returns
    ``(logits (B, T, vocab), cache)``, or (B, 1, vocab) when ``last_idx``
    (an int or a 0-d tensor) picks one row before the lm_head.

    The kernel calls are the per-op serving runner's, where the reference's
    epilogue pass rewrites this function's trace: ``rms_norm`` for the first
    layer's ``attn_norm``, ``rms_norm_residual`` with the residual add for
    every later norm, and ``linear_act`` for the gate and its silu. The
    attention over the cache is PyTorch products, as the reference leaves
    it to XLA."""
    B, T = tokens.shape
    dev = tokens.device
    max_len = cache[0]["k"].shape[2]
    layers = params["layers"][:len(cache)]
    h = F.embedding(tokens.long(), params["tok_embedding"])
    positions = torch.arange(T, device=dev) + pos                     # (T,)
    cos, sin = _rope_tables(cfg, positions, h.dtype)
    # validity of cache column j for row i: j <= pos + i
    valid = torch.arange(max_len, device=dev)[None, :] <= positions[:, None]
    x = tnn.rms_norm(h, layers[0]["attn_norm"], eps=cfg.norm_eps)
    for i, (layer, c) in enumerate(zip(layers, cache)):
        q, k, v = _project_qkv(x, layer, cfg, cos, sin)
        c["k"].index_copy_(2, positions, k)
        c["v"].index_copy_(2, positions, v)
        attn = _cache_attention(q, c["k"], c["v"], valid, h.dtype)
        h, x = tnn.rms_norm_residual(h, F.linear(attn, layer["wo"]), layer["mlp_norm"],
                                     eps=cfg.norm_eps)
        nxt = layers[i + 1]["attn_norm"] if i + 1 < len(layers) else params["norm_f"]
        h, x = tnn.rms_norm_residual(h, _mlp(x, layer), nxt, eps=cfg.norm_eps)
    if last_idx is not None:
        # logits only at row ``last_idx``: the lm_head runs on (B, 1, D)
        idx = torch.as_tensor(last_idx, device=dev).reshape(1)
        x = x.index_select(1, idx)
    return F.linear(x, params["lm_head"]), cache


def _gumbel_pick(logits_last: torch.Tensor, temperature: float,
                 uniforms: torch.Tensor) -> torch.Tensor:
    """The reference's sampled pick (``llama.py:502-506``) on given (0, 1)
    float32 uniforms: ``argmax(logits / temperature + g)`` with Gumbel noise
    ``g = -log(-log(u + 1e-10) + 1e-10)``."""
    g = -torch.log(-torch.log(uniforms + 1e-10) + 1e-10)
    return torch.argmax(logits_last / temperature + g, -1)


def to_device(params, device):
    """The parameter tree (dicts and lists of tensors) on ``device``; a
    tensor already there is kept, not copied."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return params.to(device)


def _prompt_tensor(prompt, device) -> torch.Tensor:
    if isinstance(prompt, torch.Tensor):
        return prompt.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(prompt, np.int64)).to(device)


def generate(params: dict, cfg: LlamaConfig, prompt, max_new_tokens: int,
             temperature: float = 0.0, generator: torch.Generator | None = None,
             max_len: int | None = None, n_layers: int | None = None, prefill_buckets=None,
             device=None) -> torch.Tensor:
    """Autoregressive decoding over a contiguous KV cache: one prefill of
    the ``(B, Tp)`` prompt, then one decode step per token. Greedy when
    ``temperature == 0``; otherwise the reference's Gumbel pick on
    uniforms drawn from ``generator`` (a ``torch.Generator`` on the device;
    seed 0 when omitted) where the reference splits a threefry ``key``, so
    sampled tokens follow their own stream (ROADMAP, "Known differences").
    Runs on ``device`` ("cuda" when omitted; params are moved there).

    ``prefill_buckets=(128, 512, ...)`` pads the prompt to a bucket of the
    ladder (and, without ``max_len``, rounds the cache length to the
    smallest bucket): the pad rows write K/V past ``Tp`` that the causal
    mask hides and decode overwrites before any row attends it. Returns the
    ``(B, max_new_tokens)`` int64 tokens on the device."""
    from thunder_tpu_torch.data import LengthBucketer
    from thunder_tpu_torch.devices import resolve_device

    dev = resolve_device(device)
    prompt = _prompt_tensor(prompt, dev)
    B, Tp = prompt.shape
    if max_new_tokens <= 0:
        return torch.zeros((B, 0), dtype=torch.int64, device=dev)
    params = to_device(params, dev)
    prompt_in, Tpad = prompt, Tp
    if prefill_buckets is not None:
        bk = LengthBucketer(prefill_buckets)
        Tpad = bk.bucket_for(Tp)
        if Tpad != Tp:
            prompt_in = F.pad(prompt, (0, Tpad - Tp))
        if max_len is None:
            align = bk.buckets[0]
            max_len = min(cfg.max_seq_len, max(Tpad, -(-(Tp + max_new_tokens) // align) * align))
    max_len = max_len or max(Tp + max_new_tokens, Tpad)
    if Tpad > max_len:
        raise ValueError(f"prefill bucket {Tpad} (for prompt length {Tp}) exceeds the KV "
                         f"cache length (max_len={max_len}); use a tighter bucket ladder "
                         f"or a larger max_len")
    if Tp + max_new_tokens > max_len or max_len > cfg.max_seq_len:
        raise ValueError(f"prompt ({Tp}) + max_new_tokens ({max_new_tokens}) exceeds the "
                         f"context window (max_len={max_len}, cfg.max_seq_len="
                         f"{cfg.max_seq_len})")
    n = n_layers if n_layers is not None else len(params["layers"])
    cache = init_kv_cache(cfg, B, max_len, n_layers=n, device=dev)
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)

    def pick(last):
        if temperature == 0.0:
            return torch.argmax(last, -1)
        u = torch.rand(last.shape, generator=generator, device=dev, dtype=torch.float32)
        return _gumbel_pick(last, temperature, u)

    last, _ = forward_step(params, prompt_in, cache, 0, cfg, last_idx=Tp - 1)
    tok = pick(last[:, 0])
    out = [tok]
    for i in range(1, max_new_tokens):
        last, _ = forward_step(params, tok[:, None], cache, Tp + i - 1, cfg)
        tok = pick(last[:, 0])
        out.append(tok)
    return torch.stack(out, 1)


def generate_fused(params: dict, cfg: LlamaConfig, prompt, max_new_tokens: int,
                   max_len: int | None = None, n_layers: int | None = None,
                   device=None, stats: dict | None = None) -> torch.Tensor:
    """Greedy decoding with the decode loop as one device program, the
    counterpart of the reference's ``lax.scan`` over the compiled step: on
    the card, after the prefill and one eager decode step (which warms
    every kernel and library handle on the capture stream), the greedy
    step is captured once in a ``torch.cuda.CUDAGraph`` with the token, the
    position and the output column held on the device, and replayed once a
    token — no host round trip per token. On the CPU it is the same loop,
    uncaptured. The tokens equal :func:`generate`'s (greedy).

    ``stats``, when given, receives on the card: ``graph`` (whether the
    loop was captured), ``replays``, the kernel launches of the eager step
    and of the capture (``eager_launches``, ``captured_launches``: the
    counters run on the host, so they count the captured step once, at
    capture, where the card runs it once a replay), the host ms to issue
    the eager step and one replay (``eager_step_host_ms``,
    ``replay_host_ms``), and the device ms of one replay (``replay_ms``:
    CUDA events around the replay loop alone, which waits for them)."""
    from thunder_tpu_torch.devices import resolve_device

    dev = resolve_device(device)
    prompt = _prompt_tensor(prompt, dev)
    B, Tp = prompt.shape
    max_len = max_len or (Tp + max_new_tokens)
    if not Tp + max_new_tokens <= max_len <= cfg.max_seq_len:
        raise ValueError(f"prompt ({Tp}) + max_new_tokens ({max_new_tokens}) exceeds "
                         f"max_len={max_len} / cfg.max_seq_len={cfg.max_seq_len}")
    params = to_device(params, dev)
    n = n_layers if n_layers is not None else len(params["layers"])
    cache = init_kv_cache(cfg, B, max_len, n_layers=n, device=dev)
    last, _ = forward_step(params, prompt, cache, 0, cfg, last_idx=Tp - 1)
    first = torch.argmax(last[:, 0], -1)
    if max_new_tokens == 1:
        return first[:, None]

    # the decode state lives on the device: the last token, its position,
    # and the output column the step writes
    out = torch.empty((B, max_new_tokens), dtype=torch.int64, device=dev)
    out[:, 0] = first
    tok = first[:, None].clone()
    pos = torch.full((), Tp, dtype=torch.int64, device=dev)
    col = torch.ones(1, dtype=torch.int64, device=dev)

    def body():
        logits, _ = forward_step(params, tok, cache, pos, cfg)
        nxt = torch.argmax(logits[:, -1], -1)
        out.index_copy_(1, col, nxt[:, None])
        tok.copy_(nxt[:, None])
        pos.add_(1)
        col.add_(1)

    if dev.type != "cuda":
        for _ in range(max_new_tokens - 1):
            body()
        if stats is not None:
            stats.update(graph=False, replays=0)
        return out

    from thunder_tpu_torch.executors import cudaex

    def launches(fn):
        before = cudaex.launch_counts()
        t = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t) * 1e3
        after = cudaex.launch_counts()
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}, host_ms

    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        eager, eager_ms = launches(body)     # the eager step: token 2
    torch.cuda.current_stream(dev).wait_stream(stream)
    replays = max_new_tokens - 2
    captured, replay_host_ms, replay_ms = {}, 0.0, 0.0
    if replays:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured, _ = launches(body)     # counted once, at capture
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        for _ in range(replays):
            graph.replay()
        replay_host_ms = (time.perf_counter() - t) * 1e3 / replays
        end.record()
        if stats is not None:
            end.synchronize()
            replay_ms = start.elapsed_time(end) / replays
    if stats is not None:
        stats.update(graph=bool(replays), replays=replays, eager_launches=eager,
                     captured_launches=captured, eager_step_host_ms=eager_ms,
                     replay_host_ms=replay_host_ms, replay_ms=replay_ms)
    return out


def num_params(cfg: LlamaConfig, n_layers: int | None = None) -> int:
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    kv_dim = cfg.kv_heads * cfg.head_dim
    per_layer = (2 * cfg.dim + 2 * cfg.dim * cfg.dim + 2 * kv_dim * cfg.dim
                 + 3 * cfg.dim * cfg.intermediate_size)
    return 2 * cfg.vocab_size * cfg.dim + cfg.dim + n_layers * per_layer


def flops_per_token(cfg: LlamaConfig, seq_len: int, n_layers: int | None = None) -> float:
    """Model FLOPs per token for forward + backward (6N + attention), the
    reference's count."""
    n = num_params(cfg, n_layers) - 2 * cfg.vocab_size * cfg.dim
    attn = 2 * 2 * (n_layers or cfg.n_layers) * cfg.dim * seq_len
    return 6 * (n + cfg.vocab_size * cfg.dim) + 3 * attn
