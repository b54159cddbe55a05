"""Comparison helpers for holding a kernel against its plain version, the
plain-PyTorch Llama layer and module the trace compiler is held on
(:func:`plain_llama_layer`, :class:`PlainLlama`), and the count of a
``jit`` call's launches against its trace's claims, shared by the port's
tests and ``chip_smoke.py``."""

from __future__ import annotations

import math

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
    """Launches per kernel that an execution trace's ``cuda`` claims and
    its regions on the card (``region``, one launch each) make."""
    from thunder_tpu_torch.executors.cudaex_claims import kernel_of

    out: dict[str, int] = {}
    for b in trc.bound_symbols:
        k = kernel_of(b.sym)
        if k is not None:
            out[k] = out.get(k, 0) + 1
    return out


def regions_of(trc) -> list:
    """The region callables (``regionex.Region``) of an execution trace, in
    program order."""
    return [b.sym.python_impl for b in trc.bound_symbols
            if b.sym.executor is not None and b.sym.executor.name == "region"]


def with_regions(trc, claims: dict) -> dict:
    """``claims`` (the ``cuda`` claims a test expects of an execution trace)
    with the trace's regions on the card, one ``region`` launch each: what
    :func:`claimed_kernels` returns for it."""
    n = sum(1 for r in regions_of(trc) if r.outputs[0].device.type == "cuda")
    return dict(claims, region=n) if n else dict(claims)


def expanded(trc) -> list:
    """An execution trace's bound symbols, each region replaced by its
    members (the prims it runs, in order)."""
    out = []
    for b in trc.bound_symbols:
        if b.sym.executor is not None and b.sym.executor.name == "region":
            out.extend(b.subsymbols)
        else:
            out.append(b)
    return out


def expanded_names(trc) -> list[str]:
    return [b.sym.name for b in expanded(trc)]


def region_inputs(region, gen: torch.Generator, device, strided: bool = False,
                  integer: bool = False) -> list:
    """Random inputs for ``region`` on ``device``, made by ``gen`` on its
    own device: normal floats, integers in [-128, 128) (the loss's ignore
    index -100 among them), random bools; ``strided`` hands each input of
    rank 1 or more as every other element of a tensor twice as wide;
    ``integer`` makes the floats integers in [-4, 4], so that a sum of
    them, or of their sums and products, is exact in any order
    (:func:`sum_bound` 0)."""
    out = []
    for p in region.inputs:
        shape = tuple(p.shape)
        wide = shape[:-1] + (2 * shape[-1],) if strided and shape else shape
        dt = p.dtype.torch
        kw = {"generator": gen, "device": gen.device}
        if dt.is_floating_point and integer:
            t = torch.randint(-4, 5, wide, **kw).to(dt)
        elif dt.is_floating_point:
            t = torch.randn(wide, dtype=torch.float32, **kw).to(dt)
        elif dt == torch.bool:
            t = torch.randint(0, 2, wide, **kw).bool()
        else:
            t = torch.randint(-128, 128, wide, **kw).to(dt)
        t = t.to(device)
        out.append(t[..., ::2] if strided and shape else t)
    return out


SUM_UNIT = {torch.float64: 2.0 ** -53}   # the accumulator's unit roundoff (else 2**-24)
H100_SMS = 132                           # the SMs a region's launch geometry assumes off the card


def sum_bound(x: torch.Tensor, dims, depth: int | None = None) -> torch.Tensor:
    """How far a float sum of ``x`` over ``dims`` may be from the exact
    sum, in float64: ``d u / (1 - d u) sum|x_i|``, where every summand goes
    through at most ``d`` roundings: ``depth`` (a region kernel's order,
    ``regionex.sum_depth``), or n - 1 for any order of the n summands; u
    the accumulator's unit roundoff (float32's for the 16-bit floats and
    float32). 0 for integer values whose magnitudes add to less than
    ``1 / u`` (every partial sum exact, in any order)."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    u = SUM_UNIT.get(x.dtype, 2.0 ** -24)
    du = (n - 1 if depth is None else depth) * u
    xd = x.double()
    total = torch.sum(xd.abs(), tuple(dims))
    whole = torch.all(xd == torch.round(xd), dim=tuple(dims)) & (total < 1 / u)
    return torch.where(whole, 0.0, du / (1 - du) * total)


def prod_bound(x: torch.Tensor, dims) -> torch.Tensor:
    """How far a float product of ``x`` over ``dims`` may be from the exact
    product, in float64, in any order of its n factors: ``g |prod x_i|``
    with g = (n - 1) u / (1 - (n - 1) u), u the accumulator's unit
    roundoff (float32's for the 16-bit floats and float32); 0 for integer
    values whose product stays below ``1 / u`` in magnitude (every partial
    product exact)."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    u = SUM_UNIT.get(x.dtype, 2.0 ** -24)
    g = (n - 1) * u / (1 - (n - 1) * u)
    xd = x.double()
    dims = tuple(d % x.ndim for d in dims)
    kept = [d for d in range(x.ndim) if d not in dims]
    mag = torch.prod(xd.abs().permute(kept + list(dims)).flatten(len(kept)), -1)
    whole = torch.all(xd == torch.round(xd), dim=dims) & (mag < 1 / u)
    return torch.where(whole, 0.0, g * mag)


def region_sum_depths(region, vals, sms: int | None = None) -> list[int]:
    """:func:`regionex.sum_depths` of ``region``'s launch on ``vals``: the
    depth of each float ``sum`` among its members, on the SMs of their
    card, or ``sms`` (:data:`H100_SMS` off the card)."""
    from thunder_tpu_torch.executors.regionex import sum_depths

    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), None)
    if sms is None:
        sms = (torch.cuda.get_device_properties(dev).multi_processor_count
               if dev is not None and dev.type == "cuda" else H100_SMS)
    return sum_depths(region, sms)


def region_sum_depth(region, vals, sms: int | None = None) -> int:
    """The deepest of :func:`region_sum_depths` (0 without a float sum)."""
    return max(region_sum_depths(region, vals, sms), default=0)


def _float_folds(region) -> list:
    """``region``'s ``sum`` and ``prod`` members of a float input, in order."""
    from thunder_tpu_torch.core.prims import PrimIDs

    return [b for b in region.members
            if b.sym.id in (PrimIDs.SUM, PrimIDs.PROD) and b.args[0].dtype.is_float]


def moved_chain(region, vals, sign: int, which: int, depths: list) -> tuple:
    """``region``'s plain chain with its ``which``-th float sum or product
    (of its members, in order) set to the exact value (in float64) moved
    by ``sign`` times its bound, then rounded to its dtype: a sum's
    :func:`sum_bound` at its depth in the kernel's order (``depths``, one
    a float sum, in order) and that float64 sum's own bound, a product's
    :func:`prod_bound` (any order) and the float64 product's own; every
    other member as torch computes it: with ``sign`` +1 and -1 the chain at
    either end of what the kernel's value may be. Returns the outputs and
    whether that value has a bound above 0."""
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.core.symbol import run_bsyms

    env = dict(zip(region.input_names, vals))
    folds = _float_folds(region)
    sums = [b for b in folds if b.sym.id is PrimIDs.SUM]
    k, moved = 0, False
    for b in region.members:
        x = b.args[0]
        if any(b is f for f in folds):
            if k == which:
                t, dims = env[x.name], tuple(b.args[1])
                if b.sym.id is PrimIDs.PROD:
                    dims = tuple(d % t.ndim for d in dims)
                    kept = [d for d in range(t.ndim) if d not in dims]
                    exact = torch.prod(t.double().permute(kept + list(dims)).flatten(len(kept)),
                                       -1)
                    bound = prod_bound(t, dims) + prod_bound(t.double(), dims)
                else:
                    d = depths[next(i for i, f in enumerate(sums) if f is b)]
                    exact = torch.sum(t.double(), dims)
                    bound = sum_bound(t, dims, d) + sum_bound(t.double(), dims)
                moved = bool((bound > 0).any())
                s = exact + sign * bound
                out = b.flat_proxy_outs()[0]
                env[out.name] = s.reshape(tuple(out.shape)).to(out.dtype.torch)
                k += 1
                continue
            k += 1
        run_bsyms([b], env)
    return tuple(env[n] for n in region.output_names), moved


def _ulp_of(w: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of each float of ``w``, in float64."""
    f = torch.finfo(w.dtype)
    mag = w.double().abs().clamp(min=f.tiny)
    return torch.exp2(torch.floor(torch.log2(mag))) * f.eps


def hold_region(region, vals, sms: int | None = None) -> dict:
    """``region``'s kernel against its plain chain on the same inputs:
    ``ulp``, the largest distance of a float output in units of its dtype's
    last place (NaN where both are NaN counts 0), and ``bit_identical``
    (every output equal bit for bit, NaNs at the same places). A region
    without reductions holding a transcendental op (``regionex.TRANSCENDENTAL``)
    is held within 1 ulp, any other bit for bit (``ok``).

    A region with reductions (the row or the column design): ``amax``,
    ``amin``, ``argmax`` and ``argmin`` bit for bit; each float ``sum`` may
    be off the exact sum by its :func:`sum_bound` in the kernel's order
    (``regionex.sum_depths`` of the launch on ``sms`` SMs,
    :func:`region_sum_depths`: a row sum, a column sum's partials and
    their tree, a column-design sum each their own), each float ``prod``
    off the exact product by its :func:`prod_bound`, so every output is
    held to what that moves it by in the plain chain (:func:`moved_chain`,
    each sum or product set to either end of its bound alone, the others
    as torch computes them): a float within the sum over the region's sums
    and products of the larger of its two distances from the chain's value
    (the sums' errors are independent; moved together, two sums' moves can
    cancel where their errors do not, as in a norm's backward), plus 1 ulp
    of its dtype where the region holds a transcendental op (as an
    elementwise region is held); an integer or bool equal to the chain's. Where a moved
    chain changes an integer or bool output, that value turns on a
    comparison the kernel's order may decide (a sampler's bisection):
    ``unstable`` counts those elements, and ``ok`` holds them to 0 too, so
    a check on inputs that sit that close to a decision fails rather than
    passing unheld. ``sum_slack`` is the largest error over the allowance
    (at most 1 where ``ok``); ``sums`` counts the float sums and products,
    ``exact_sums`` those whose bound is 0 (integer terms: the kernel's
    value must be exact); ``depth`` is the deepest sum's depth."""
    got = region(*vals)
    want = region.plain(*vals)
    ulp, same = 0, True
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            nan = torch.isnan(g) & torch.isnan(w)
            g, w = torch.where(nan, 0, g), torch.where(nan, 0, w)
            if g.dtype == torch.float64:
                d = 0 if torch.equal(g, w) else 2
            else:
                d = ulp_distance(g, w) if g.numel() else 0
            ulp = max(ulp, d)
            same = same and d == 0
        else:
            same = same and torch.equal(g, w)
            ulp = max(ulp, 0 if torch.equal(g, w) else 1 << 30)
    out = {"ops": len(region.members), "transcendental": region.spec.transcendental,
           "ulp": ulp, "bit_identical": same}
    if region.spec.design == "elementwise":
        return dict(out, ok=same or (region.spec.transcendental and ulp <= 1))
    depths = region_sum_depths(region, vals, sms)
    depth = max(depths, default=0)
    n_sums = len(_float_folds(region))
    moves, exact = [], 0
    for j in range(n_sums):
        for sign in (1, -1):
            chain, moved = moved_chain(region, vals, sign, j, depths)
            moves.append(chain)
        exact += not moved
    slack, ok, unstable = 0.0, True, 0
    for k, (g, w) in enumerate(zip(got, want)):
        if not g.numel():
            continue
        if g.dtype.is_floating_point:
            both = torch.isnan(g) & torch.isnan(w)
            allow = _ulp_of(torch.where(both, 0, w))
            if not region.spec.transcendental:
                allow = torch.zeros_like(allow)
            wd = torch.where(both, 0, w).double()
            for j in range(0, len(moves), 2):
                a, b = (torch.where(both, 0, m[k]).double() for m in moves[j:j + 2])
                allow = allow + torch.maximum((a - wd).abs(), (b - wd).abs()).nan_to_num(0.0)
            gd = torch.where(both, 0, g).double()
            err = torch.where(gd == wd, 0.0, (gd - wd).abs())
            bad = torch.isnan(err) | (err > allow)
            ok = ok and not bool(bad.any())
            slack = max(slack, float((err / allow.clamp(min=1e-300)).nan_to_num(2.0).max()))
        else:
            loose = torch.zeros_like(w, dtype=torch.bool)
            for m in moves:
                loose |= m[k] != w
            unstable += int(loose.sum())
            hit = bool(torch.equal(g, w))
            ok = ok and hit
            slack = max(slack, 0.0 if hit else 2.0)
    return dict(out, ok=ok and unstable == 0, sum_slack=slack, depth=depth, sums=n_sums,
                exact_sums=exact, unstable=unstable)


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
