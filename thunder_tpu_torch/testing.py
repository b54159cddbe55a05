"""Comparison helpers for holding a kernel against its plain version, shared
by the port's tests and ``chip_smoke.py``."""

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
