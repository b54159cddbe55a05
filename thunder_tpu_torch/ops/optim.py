"""Optimizer operations of the port, each with its plain PyTorch version.

The counterpart of ``thunder_tpu/ops/optim.py``: ``adamw_step_plain`` is
one parameter's AdamW update in the exact op order of ``optim.adamw_step``
(:45-75) and of the Pallas ``_fused_adamw_kernel``; ``fused_adamw`` is the
multi-tensor form over one dtype bucket, the port of ``optim.fused_adamw``
(:79), which sends CUDA tensors to the hand-written multi-tensor kernel
(:func:`thunder_tpu_torch.executors.cudaex.fused_adamw`) and CPU tensors to
a loop of the plain version.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.ops.nn import _on_cuda


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


def fused_adamw(params, grads, ms, vs, bc: torch.Tensor, *, lr: float, beta1: float,
                beta2: float, eps: float, weight_decay: float) -> None:
    """AdamW over one dtype bucket, in place on ``params``, ``ms`` and
    ``vs``. ``bc`` is the float32 tensor ``[1 - beta1**step, 1 - beta2**step]``
    on the parameters' device. On CUDA this is ONE kernel launch; on the CPU
    each parameter takes :func:`adamw_step_plain`."""
    params = list(params)
    if _on_cuda(params[0], "fused_adamw"):
        cudaex.fused_adamw(params, grads, ms, vs, bc, lr=lr, beta1=beta1, beta2=beta2,
                           eps=eps, weight_decay=weight_decay)
        return
    for p, g, m, v in zip(params, grads, ms, vs, strict=True):
        p_new, m_new, v_new = adamw_step_plain(p, g, m, v, bc[0], bc[1], lr=lr, beta1=beta1,
                                               beta2=beta2, eps=eps,
                                               weight_decay=weight_decay)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
