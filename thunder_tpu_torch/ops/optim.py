"""Optimizer operations of the port, each with its plain PyTorch version.

The counterpart of ``thunder_tpu/ops/optim.py``: ``adamw_step_plain`` is
one parameter's AdamW update in the exact op order of ``optim.adamw_step``
(:45-75) and of the Pallas ``_fused_adamw_kernel``; ``fused_adamw`` is the
multi-tensor form over one dtype bucket, the port of ``optim.fused_adamw``
(:79); ``fused_adamw_slab`` is the form whose moments live in persistent
``(rows, 128)`` slabs, the port of ``optim.fused_adamw_slab`` (:106), with
the slab geometry (``SLAB_LANE``, ``SLAB_ROW_BLOCK``, ``slab_geometry``,
:32-42). Each sends CUDA tensors to its hand-written kernel
(:mod:`thunder_tpu_torch.executors.cudaex`), which raises on what it does
not take, and CPU tensors to a loop of the plain version.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.ops.nn import _on_cuda

# the slab layout of the reference (thunder_tpu/ops/optim.py:30-44), which
# the kernel's wrapper checks against
SLAB_LANE, SLAB_ROW_BLOCK, slab_geometry = (cudaex.SLAB_LANE, cudaex.SLAB_ROW_BLOCK,
                                            cudaex.slab_geometry)


def adamw_step_plain(p, g, m, v, bc1, bc2, *, lr: float, beta1: float, beta2: float,
                     eps: float, weight_decay: float):
    """One parameter's update ``(p, g, m, v) -> (p_new, m_new, v_new)``:
    float32 arithmetic, each result rounded to its input's dtype. ``bc1``
    and ``bc2`` are the bias corrections ``1 - beta**step``."""
    gf, mf, vf = g.float(), m.float(), v.float()
    m_new = mf * beta1 + gf * (1.0 - beta1)
    v_new = vf * beta2 + (gf * gf) * (1.0 - beta2)
    m_hat = m_new / bc1
    v_hat = v_new / bc2
    upd = m_hat / (torch.sqrt(v_hat) + eps)
    pf = p.float()
    if weight_decay:
        upd = upd + pf * weight_decay
    p_new = pf - upd * lr
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def _step_in_place(p, g, m, v, bc, hyper) -> None:
    p_new, m_new, v_new = adamw_step_plain(p, g, m, v, bc[0], bc[1], **hyper)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


def fused_adamw(params, grads, ms, vs, bc: torch.Tensor, *, lr: float, beta1: float,
                beta2: float, eps: float, weight_decay: float) -> None:
    """AdamW over one dtype bucket, in place on ``params``, ``ms`` and
    ``vs``. ``bc`` is the float32 tensor ``[1 - beta1**step, 1 - beta2**step]``
    on the parameters' device. On CUDA this is ONE kernel launch; otherwise
    each parameter takes :func:`adamw_step_plain`."""
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if _on_cuda(params[0], "fused_adamw"):
        cudaex.fused_adamw(params, grads, ms, vs, bc, **hyper)
        return
    for p, g, m, v in zip(params, grads, ms, vs, strict=True):
        _step_in_place(p, g, m, v, bc, hyper)


def fused_adamw_slab_plain(params, grads, m_slab: torch.Tensor, v_slab: torch.Tensor,
                           bc: torch.Tensor, *, sizes, lr: float, beta1: float, beta2: float,
                           eps: float, weight_decay: float) -> None:
    """The reference's decomposition of ``optim.fused_adamw_slab``, in
    place: each parameter's run of ``sizes[i]`` elements is narrowed out of
    the flattened slabs in bucket order, takes :func:`adamw_step_plain`, and
    is written back (m and v rounded to the slabs' dtypes). The zero pad
    tail past ``sum(sizes)`` is not touched, so it stays zero."""
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    m_flat, v_flat = m_slab.view(-1), v_slab.view(-1)
    off = 0
    for p, g, n in zip(params, grads, sizes, strict=True):
        n = int(n)
        _step_in_place(p, g, m_flat.narrow(0, off, n).view(p.shape),
                       v_flat.narrow(0, off, n).view(p.shape), bc, hyper)
        off += n


def fused_adamw_slab(params, grads, m_slab: torch.Tensor, v_slab: torch.Tensor,
                     bc: torch.Tensor, *, sizes, lr: float, beta1: float, beta2: float,
                     eps: float, weight_decay: float) -> None:
    """AdamW over one dtype bucket whose m/v moments live in the persistent
    ``(rows, 128)`` slabs ``m_slab``/``v_slab`` (``slab_geometry(sum(sizes))``
    rows), in place on ``params`` and the slabs. On CUDA this is ONE kernel
    launch that reads and writes the slabs directly; otherwise
    :func:`fused_adamw_slab_plain`. Bit-identical to :func:`fused_adamw` on
    the same values, on either route."""
    params, grads, sizes = list(params), list(grads), [int(s) for s in sizes]
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if _on_cuda(params[0], "fused_adamw_slab"):
        cudaex.fused_adamw_slab(params, grads, m_slab, v_slab, bc, sizes=sizes, **hyper)
        return
    fused_adamw_slab_plain(params, grads, m_slab, v_slab, bc, sizes=sizes, **hyper)
