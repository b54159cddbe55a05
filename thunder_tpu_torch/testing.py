"""Comparison helpers for holding a kernel against its plain version, the
plain-PyTorch Llama layer the trace compiler is held on, and the count of a
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
                      n_heads: int, n_kv: int, eps: float = 1e-5):
    """One Llama layer written in plain PyTorch (``F.rms_norm``,
    ``F.linear``, ``F.silu``, ``F.scaled_dot_product_attention``, the
    residual adds), none of the port's routers: under ``jit`` the compiler
    has to find its kernels itself. x (B, T, D); grouped-query k and v are
    expanded to the query heads."""
    import torch.nn.functional as F

    B, T, D = x.shape
    hd, rep = D // n_heads, n_heads // n_kv
    n = F.rms_norm(x, (D,), attn_norm, eps=eps)
    q = F.linear(n, wq).view(B, T, n_heads, hd).transpose(1, 2)
    k = F.linear(n, wk).view(B, T, n_kv, hd).transpose(1, 2)
    v = F.linear(n, wv).view(B, T, n_kv, hd).transpose(1, 2)
    k = k.unsqueeze(2).expand(B, n_kv, rep, T, hd).reshape(B, n_heads, T, hd)
    v = v.unsqueeze(2).expand(B, n_kv, rep, T, hd).reshape(B, n_heads, T, hd)
    a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    h = x + F.linear(a.transpose(1, 2).reshape(B, T, D), wo)
    m = F.rms_norm(h, (D,), mlp_norm, eps=eps)
    return h + F.linear(F.silu(F.linear(m, w_gate)) * F.linear(m, w_up), w_down)


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
