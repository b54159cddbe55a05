"""Comparison helpers for holding a kernel against its plain version, the
plain-PyTorch Llama layer and module the trace compiler is held on
(:func:`plain_llama_layer`, :class:`PlainLlama`), and the count of a
``jit`` call's launches against its trace's claims, shared by the port's
tests and ``chip_smoke.py``."""

from __future__ import annotations

import torch


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest elementwise distance between two tensors of one float dtype
    (float32, bfloat16 or float16) in units in the last place of that dtype:
    sign-magnitude bits mapped to a line on which neighbouring floats differ
    by 1."""
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"ulp_distance: dtypes {a.dtype} and {b.dtype} (one of float32, "
                         f"bfloat16 or float16)")
    bits = torch.int32 if a.dtype == torch.float32 else torch.int16
    sign = 1 << (31 if a.dtype == torch.float32 else 15)

    def line(x):
        i = x.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & (sign - 1)), i)

    return int((line(a) - line(b)).abs().max())


def row_rel_err(got: torch.Tensor, want: torch.Tensor, floor: float = 1e-2) -> float:
    """Largest error of a row (along the last dim) relative to that row's
    own largest reference magnitude: ``max_rows max|got - want| / scale``,
    where a row's ``scale`` is its ``max|want|`` but at least ``floor``
    times the whole tensor's.

    Held to a bound, it keeps every row to the same relative accuracy, so a
    row of small values (the output or a key's gradient late in a causal
    sequence) cannot hide a fault behind the tensor's largest value. The
    floor keeps a row whose exact value is zero from judging rounding
    noise: the first causal row's dQ is ``P = 1`` times ``dP - delta``, two
    equal dot products summed in different orders."""
    w = want.float().abs()
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = w.amax(-1).clamp_min(max(floor * float(w.max()), torch.finfo(torch.float32).tiny))
    return float((diff / scale).max())


def paged_split_model(q, k_pages, v_pages, block_tables, lengths, keys: int,
                      scale: float | None = None, drop=()) -> torch.Tensor:
    """The algorithm of the split-context ``paged_decode_attention`` kernel
    in plain PyTorch: each (request, kv head) context cut into chunks of
    ``keys`` keys (``cudaex.paged_geometry``), each chunk's scores, max
    ``m``, sum ``l`` of ``exp(s - m)`` and unrounded ``p v`` sums in
    float32, then the chunks merged in chunk order and ``acc / l`` rounded
    once to q's dtype (a request of length 0 gives zeros). ``drop`` names
    ``(request, chunk)`` pairs the merge leaves out: a planted fault.

    It walks the chunks one by one, so it is for small inputs (tests) and
    for one call at the serving shape (the chip smoke's fault)."""
    import math

    B, H, _, hd = q.shape
    KV, _, ps, _ = k_pages.shape
    G = H // KV
    npg = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KV, G, hd).float()
    out = torch.zeros(B, KV, G, hd, dtype=torch.float32, device=q.device)
    drop = set(drop)
    for b in range(B):
        n = min(int(lengths[b]), npg * ps)
        pos = torch.arange(n, device=q.device)
        pages = block_tables[b].long()[pos // ps]
        k = k_pages[:, pages, pos % ps].float()   # (KV, n, hd)
        v = v_pages[:, pages, pos % ps].float()
        m = torch.full((KV, G), -math.inf, device=q.device)
        parts = []
        for c, c0 in enumerate(range(0, n, keys)):
            s = torch.einsum("kgd,knd->kgn", qf[b], k[:, c0:c0 + keys]) * scale
            mc = s.amax(-1)
            e = torch.exp(s - mc[..., None])
            if (b, c) not in drop:
                parts.append((mc, e.sum(-1), torch.einsum("kgn,knd->kgd", e, v[:, c0:c0 + keys])))
                m = torch.maximum(m, mc)
        if not parts:
            continue
        l = torch.zeros(KV, G, device=q.device)
        acc = torch.zeros(KV, G, hd, device=q.device)
        for mc, lc, ac in parts:
            w = torch.exp(mc - m)
            l = l + lc * w
            acc = acc + ac * w[..., None]
        out[b] = acc / l[..., None]
    return out.reshape(B, H, 1, hd).to(q.dtype)


def rms_residual_fault(h: torch.Tensor, weight, eps: float, left_out: int) -> torch.Tensor:
    """The ``rms_norm_residual`` output that a kernel with a planted fault
    would give from the residual stream ``h`` (the kernel's own): the last
    row's sum of squares leaves out the squares of its last ``left_out``
    values (what a block reduction that drops one warp's partial sum
    computes: 256 of 4096 bf16 values), every other row as the plain
    version. The check that holds the kernel against its plain version must
    fail it."""
    rows = h.reshape(-1, h.shape[-1])
    hf = rows.float()
    ss = (hf * hf).sum(-1)
    kept = hf[-1, :hf.shape[-1] - left_out]
    ss[-1] = (kept * kept).sum()
    y = (hf * torch.rsqrt(ss / h.shape[-1] + eps)[:, None]).to(h.dtype)
    if weight is not None:
        y = y * weight
    return y.reshape(h.shape)


def plain_llama_layer(x, attn_norm, wq, wk, wv, wo, mlp_norm, w_gate, w_up, w_down, *,
                      n_heads: int, n_kv: int, eps: float = 1e-5, cos=None, sin=None):
    """One Llama layer written in plain PyTorch (``F.rms_norm``,
    ``F.linear``, ``F.silu``, ``F.scaled_dot_product_attention``, the
    residual adds), none of the port's routers: under ``jit`` the compiler
    has to find its kernels itself. x (B, T, D); grouped-query k and v are
    expanded to the query heads. ``cos``/``sin`` (T, hd/2), where given,
    rotate q and k as the port's Llama does (``models.llama._apply_rope``,
    the GPT-NeoX half rotation)."""
    import torch.nn.functional as F

    B, T, D = x.shape
    hd, rep = D // n_heads, n_heads // n_kv
    n = F.rms_norm(x, (D,), attn_norm, eps=eps)
    q = F.linear(n, wq).view(B, T, n_heads, hd).transpose(1, 2)
    k = F.linear(n, wk).view(B, T, n_kv, hd).transpose(1, 2)
    v = F.linear(n, wv).view(B, T, n_kv, hd).transpose(1, 2)
    if cos is not None:
        from thunder_tpu_torch.models.llama import _apply_rope

        q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
    k = k.unsqueeze(2).expand(B, n_kv, rep, T, hd).reshape(B, n_heads, T, hd)
    v = v.unsqueeze(2).expand(B, n_kv, rep, T, hd).reshape(B, n_heads, T, hd)
    a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    h = x + F.linear(a.transpose(1, 2).reshape(B, T, D), wo)
    m = F.rms_norm(h, (D,), mlp_norm, eps=eps)
    return h + F.linear(F.silu(F.linear(m, w_gate)) * F.linear(m, w_up), w_down)


class PlainLlamaLayer(torch.nn.Module):
    """A Llama decoder layer as an ``nn.Module``: bias-free ``nn.Linear``
    projections and ``nn.Parameter`` norm weights around
    :func:`plain_llama_layer`."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        D, Fd = cfg.dim, cfg.intermediate_size
        kv_dim = cfg.kv_heads * cfg.head_dim
        kw = {"device": device, "dtype": dtype, "bias": False}
        self.n_heads, self.n_kv, self.eps = cfg.n_heads, cfg.kv_heads, cfg.norm_eps
        self.attn_norm = torch.nn.Parameter(torch.ones(D, device=device, dtype=dtype))
        self.wq, self.wk = torch.nn.Linear(D, D, **kw), torch.nn.Linear(D, kv_dim, **kw)
        self.wv, self.wo = torch.nn.Linear(D, kv_dim, **kw), torch.nn.Linear(D, D, **kw)
        self.mlp_norm = torch.nn.Parameter(torch.ones(D, device=device, dtype=dtype))
        self.w_gate, self.w_up = torch.nn.Linear(D, Fd, **kw), torch.nn.Linear(D, Fd, **kw)
        self.w_down = torch.nn.Linear(Fd, D, **kw)

    def forward(self, x, cos, sin):
        return plain_llama_layer(
            x, self.attn_norm, self.wq.weight, self.wk.weight, self.wv.weight, self.wo.weight,
            self.mlp_norm, self.w_gate.weight, self.w_up.weight, self.w_down.weight,
            n_heads=self.n_heads, n_kv=self.n_kv, eps=self.eps, cos=cos, sin=sin)


class PlainLlama(torch.nn.Module):
    """A Llama language model written in plain PyTorch, the module a user
    would hand to ``jit``: ``nn.Embedding``, :class:`PlainLlamaLayer`\\ s,
    a final ``F.rms_norm`` and a bias-free ``nn.Linear`` head; the rope
    tables in torch ops (``models.llama``'s); ``forward(tokens, targets)``
    is the mean next-token ``F.cross_entropy`` of float32 logits,
    ``models.llama.loss_fn``'s loss. None of the port's routers: under
    ``jit`` the compiler finds the kernels itself. A test fixture (the
    card-side stand-in for a Hugging Face model), not a model of the zoo."""

    def __init__(self, cfg, n_layers: int | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        n_layers = cfg.n_layers if n_layers is None else n_layers
        kw = {"device": device, "dtype": cfg.dtype}
        self.tok_embedding = torch.nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.layers = torch.nn.ModuleList(PlainLlamaLayer(cfg, **kw) for _ in range(n_layers))
        self.norm_f = torch.nn.Parameter(torch.ones(cfg.dim, **kw))
        self.lm_head = torch.nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw)

    @classmethod
    def from_llama_params(cls, cfg, params: dict) -> "PlainLlama":
        """The module holding copies of ``models.llama.init_params``'s tensors
        (built on the meta device, then filled), on their device: it
        computes ``llama.loss_fn(params, ...)``."""
        m = cls(cfg, n_layers=len(params["layers"]), device="meta")

        def put(mod, name, t):
            setattr(mod, name, torch.nn.Parameter(t.detach().clone()))

        put(m.tok_embedding, "weight", params["tok_embedding"])
        put(m, "norm_f", params["norm_f"])
        put(m.lm_head, "weight", params["lm_head"])
        for layer, p in zip(m.layers, params["layers"]):
            for k in ("attn_norm", "mlp_norm"):
                put(layer, k, p[k])
            for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
                put(getattr(layer, k), "weight", p[k])
        return m

    def forward(self, tokens, targets):
        import torch.nn.functional as F

        from thunder_tpu_torch.models.llama import _rope_cos_sin

        h = self.tok_embedding(tokens.long())
        B, T, D = h.shape
        cos, sin = _rope_cos_sin(self.cfg, T, h.dtype, device=tokens.device)
        for layer in self.layers:
            h = layer(h, cos, sin)
        logits = self.lm_head(F.rms_norm(h, (D,), self.norm_f, eps=self.cfg.norm_eps))
        return F.cross_entropy(logits.reshape(B * T, self.cfg.vocab_size).float(),
                               targets.reshape(B * T))


def claimed_kernels(trc) -> dict[str, int]:
    """Launches per kernel that an execution trace's ``cuda`` claims make."""
    from thunder_tpu_torch.executors.cudaex_claims import kernel_of

    out: dict[str, int] = {}
    for b in trc.bound_symbols:
        k = kernel_of(b.sym)
        if k is not None:
            out[k] = out.get(k, 0) + 1
    return out


def jit_launches(jf, *args):
    """One call of the ``jit`` function ``jf`` on ``args``, with the kernels'
    launch counts set to 0 just before it and read just after (a compile
    launches nothing). Returns its output, the launches per kernel and the
    execution trace's claims (the caller holds the two equal)."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.executors import cudaex

    torch.cuda.synchronize()
    cudaex.reset_launch_counts()
    out = jf(*args)
    torch.cuda.synchronize()
    launches = {k: n for k, n in cudaex.launch_counts().items() if n}
    return out, launches, claimed_kernels(ptt.last_execution_trace(jf))


def decode_step(cfg, params, tokens, block_tables, lengths, write_pos, pools, temps, top_ks,
                top_ps, rng, layer_fn):
    """One serving decode step run eagerly, op by op, with each layer one
    call of ``layer_fn`` (``ops.nn.decode_layer``'s signature and contract:
    it returns the layer's output and stores the step's K/V rows into the
    pools in place), then ``rms_norm(norm_f)``, the lm_head and the sampler:
    ``(tokens (S,), logits (S, V))``. The traced runner's planned decode step
    with the layer swapped for a chain of plain functions, to hold a traced
    step against."""
    import torch.nn.functional as F

    from thunder_tpu_torch.models.llama import _rope_tables
    from thunder_tpu_torch.ops import nn as tnn
    from thunder_tpu_torch.serving.sampling import sample_tokens

    S = tokens.shape[0]
    h = F.embedding(tokens, params["tok_embedding"])
    cos, sin = _rope_tables(cfg, lengths - 1, h.dtype)
    cos, sin = cos.reshape(S, 1, 1, -1), sin.reshape(S, 1, 1, -1)
    for layer, kv in zip(params["layers"], pools):
        h = layer_fn(h, layer["attn_norm"], layer["wq"], layer["wk"], layer["wv"], layer["wo"],
                     cos, sin, kv["k"], kv["v"], block_tables, lengths, write_pos,
                     layer["mlp_norm"], layer["w_gate"], layer["w_up"], layer["w_down"],
                     act="silu", eps=cfg.norm_eps)
    x = tnn.rms_norm(h, params["norm_f"], eps=cfg.norm_eps)
    logits = F.linear(x, params["lm_head"]).squeeze(1)
    return sample_tokens(logits, temps, top_ks, top_ps, rng), logits
