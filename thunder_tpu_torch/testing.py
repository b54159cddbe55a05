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
