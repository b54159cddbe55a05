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

Beside the routers sit the composites of a traced ``AdamW.update``
(``optim.AdamW`` under ``jit``): :data:`adamw_step` (``optim.adamw_step``,
:45, one parameter's update as ops), which the update records once a
parameter, and :data:`fused_adamw_composite` (``optim.fused_adamw``, :79,
one ``adamw_step`` per member of a dtype bucket), which the optimizer
fusion pass builds from them and the ``cuda`` executor claims for the
``fused_adamw`` kernel; the torch executor runs both as the plain version. Their moments are stored
in the configured ``state_dtype``/``v_dtype``, as the reference stores them;
:func:`fused_adamw_into` is what both executors' claims of the bucket run.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch import ops
from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.baseutils import check
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.executors.passes import writes_in_place
from thunder_tpu_torch.ops import opsymbol
from thunder_tpu_torch.ops.nn import _on_cuda, routed

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


def healthy(health: torch.Tensor) -> torch.Tensor:
    """The verdict of a health word, a 0-d bool on its device: its
    non-finite total (grads + loss + state, summed in that order in float32)
    is 0. A NaN total is unhealthy. No host sync."""
    return (health[0] + health[1] + health[2]) == 0


def _step_in_place(p, g, m, v, bc, hyper, health=None) -> None:
    new = adamw_step_plain(p, g, m, v, bc[0], bc[1], **hyper)
    if health is not None:
        ok = healthy(health)
        new = [torch.where(ok, n, old) for n, old in zip(new, (p, m, v))]
    for t, n in zip((p, m, v), new):
        t.copy_(n)


def _tally(p, g, m, v, bc, hyper, acc) -> None:
    """The health pass of one parameter: ``acc += (non-finite g, float32
    sum of g*g, non-finite p', m', v' as stored)``, storing nothing."""
    new = adamw_step_plain(p, g, m, v, bc[0], bc[1], **hyper)
    gf = g.float()
    nonfinite = [(~torch.isfinite(t)).sum() for t in (gf, *new)]
    acc += torch.stack([nonfinite[0].double(), torch.sum(gf * gf).double(),
                        (nonfinite[1] + nonfinite[2] + nonfinite[3]).double()])


def fused_adamw_plain(params, grads, ms, vs, bc: torch.Tensor, *, lr: float, beta1: float,
                      beta2: float, eps: float, weight_decay: float,
                      health: torch.Tensor | None = None) -> None:
    """Each parameter of the bucket takes :func:`adamw_step_plain` in place;
    with ``health``, only where the health word is healthy."""
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    for p, g, m, v in zip(params, grads, ms, vs, strict=True):
        _step_in_place(p, g, m, v, bc, hyper, health)


def _first_param(args) -> torch.Tensor:
    return args[0][0]


@routed("fused_adamw", tensor_of=_first_param)
def fused_adamw(params, grads, ms, vs, bc: torch.Tensor, *, lr: float, beta1: float,
                beta2: float, eps: float, weight_decay: float,
                health: torch.Tensor | None = None) -> None:
    """AdamW over one dtype bucket, in place on ``params``, ``ms`` and
    ``vs``. ``bc`` is the float32 tensor ``[1 - beta1**step, 1 - beta2**step]``
    on the parameters' device; ``health``, a health word, gates the update.
    On CUDA this is ONE kernel launch; otherwise :func:`fused_adamw_plain`."""
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if _on_cuda(params[0], "fused_adamw"):
        cudaex.fused_adamw(params, grads, ms, vs, bc, health=health, **hyper)
        return
    fused_adamw_plain(params, grads, ms, vs, bc, health=health, **hyper)


def fused_adamw_health_plain(params, grads, ms, vs, bc: torch.Tensor, acc: torch.Tensor, *,
                             lr: float, beta1: float, beta2: float, eps: float,
                             weight_decay: float) -> None:
    """The health pass of :func:`fused_adamw_plain`, parameter by parameter,
    into ``acc`` (float64, shape (3,))."""
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    for p, g, m, v in zip(params, grads, ms, vs, strict=True):
        _tally(p, g, m, v, bc, hyper, acc)


@routed("fused_adamw_health", tensor_of=_first_param)
def fused_adamw_health(params, grads, ms, vs, bc: torch.Tensor, acc: torch.Tensor, *,
                       lr: float, beta1: float, beta2: float, eps: float,
                       weight_decay: float) -> None:
    """The health pass of :func:`fused_adamw` over one bucket: the update's
    arithmetic without a store, adding ``(non-finite grads, sum of g*g,
    non-finite p'/m'/v')`` into ``acc``. On CUDA ONE kernel launch (and
    its fold)."""
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if _on_cuda(params[0], "fused_adamw_health"):
        cudaex.fused_adamw_health(params, grads, ms, vs, bc, acc, **hyper)
        return
    fused_adamw_health_plain(params, grads, ms, vs, bc, acc, **hyper)


def _slab_runs(params, m_slab, v_slab, sizes):
    """Each parameter's run of the flattened slabs, in bucket order, viewed
    in the parameter's shape."""
    m_flat, v_flat = m_slab.view(-1), v_slab.view(-1)
    off = 0
    for p, n in zip(params, sizes, strict=True):
        n = int(n)
        yield m_flat.narrow(0, off, n).view(p.shape), v_flat.narrow(0, off, n).view(p.shape)
        off += n


def fused_adamw_slab_plain(params, grads, m_slab: torch.Tensor, v_slab: torch.Tensor,
                           bc: torch.Tensor, *, sizes, lr: float, beta1: float, beta2: float,
                           eps: float, weight_decay: float,
                           health: torch.Tensor | None = None) -> None:
    """The reference's decomposition of ``optim.fused_adamw_slab``, in
    place: each parameter's run of ``sizes[i]`` elements is narrowed out of
    the flattened slabs in bucket order, takes :func:`adamw_step_plain`, and
    is written back (m and v rounded to the slabs' dtypes); with
    ``health``, only where the health word is healthy. The zero pad tail
    past ``sum(sizes)`` is not touched, so it stays zero."""
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    for p, g, (m, v) in zip(params, grads, _slab_runs(params, m_slab, v_slab, sizes)):
        _step_in_place(p, g, m, v, bc, hyper, health)


@routed("fused_adamw_slab", tensor_of=_first_param)
def fused_adamw_slab(params, grads, m_slab: torch.Tensor, v_slab: torch.Tensor,
                     bc: torch.Tensor, *, sizes, lr: float, beta1: float, beta2: float,
                     eps: float, weight_decay: float,
                     health: torch.Tensor | None = None) -> None:
    """AdamW over one dtype bucket whose m/v moments live in the persistent
    ``(rows, 128)`` slabs ``m_slab``/``v_slab`` (``slab_geometry(sum(sizes))``
    rows), in place on ``params`` and the slabs; ``health`` gates it. On
    CUDA this is ONE kernel launch that reads and writes the slabs directly;
    otherwise :func:`fused_adamw_slab_plain`. Bit-identical to
    :func:`fused_adamw` on the same values, on either route."""
    params, grads, sizes = list(params), list(grads), [int(s) for s in sizes]
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if _on_cuda(params[0], "fused_adamw_slab"):
        cudaex.fused_adamw_slab(params, grads, m_slab, v_slab, bc, sizes=sizes, health=health,
                                **hyper)
        return
    fused_adamw_slab_plain(params, grads, m_slab, v_slab, bc, sizes=sizes, health=health,
                           **hyper)


def fused_adamw_slab_health_plain(params, grads, m_slab: torch.Tensor, v_slab: torch.Tensor,
                                  bc: torch.Tensor, acc: torch.Tensor, *, sizes, lr: float,
                                  beta1: float, beta2: float, eps: float,
                                  weight_decay: float) -> None:
    """The health pass of :func:`fused_adamw_slab_plain` into ``acc``."""
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    for p, g, (m, v) in zip(params, grads, _slab_runs(params, m_slab, v_slab, sizes)):
        _tally(p, g, m, v, bc, hyper, acc)


@routed("fused_adamw_slab_health", tensor_of=_first_param)
def fused_adamw_slab_health(params, grads, m_slab: torch.Tensor, v_slab: torch.Tensor,
                            bc: torch.Tensor, acc: torch.Tensor, *, sizes, lr: float,
                            beta1: float, beta2: float, eps: float,
                            weight_decay: float) -> None:
    """The health pass of :func:`fused_adamw_slab` over one bucket, into
    ``acc``."""
    params, grads, sizes = list(params), list(grads), [int(s) for s in sizes]
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    if _on_cuda(params[0], "fused_adamw_slab_health"):
        cudaex.fused_adamw_slab_health(params, grads, m_slab, v_slab, bc, acc, sizes=sizes,
                                       **hyper)
        return
    fused_adamw_slab_health_plain(params, grads, m_slab, v_slab, bc, acc, sizes=sizes, **hyper)


# ---------------------------------------------------------------------------
# the traced optimizer's composites (thunder_tpu/ops/optim.py:45, :79)
# ---------------------------------------------------------------------------

@opsymbol(id="optim.adamw_step")
def adamw_step(p, g, m, v, bc1, bc2, *, lr: float = 1e-3, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
               state_dtype=None, v_dtype=None):
    """One parameter's AdamW update ``(p, g, m, v, bc1, bc2) -> (p_new,
    m_new, v_new)``: float32 arithmetic in :func:`adamw_step_plain`'s order,
    m and v stored in ``state_dtype``/``v_dtype`` (None keeps their own)."""
    gf, mf, vf = (ops.convert_element_type(t, dtypes.float32) for t in (g, m, v))
    m_new = ops.add(ops.mul(mf, beta1), ops.mul(gf, 1.0 - beta1))
    v_new = ops.add(ops.mul(vf, beta2), ops.mul(ops.mul(gf, gf), 1.0 - beta2))
    m_hat = ops.true_divide(m_new, bc1)
    v_hat = ops.true_divide(v_new, bc2)
    upd = ops.true_divide(m_hat, ops.add(ops.sqrt(v_hat), eps))
    pf = ops.convert_element_type(p, dtypes.float32)
    if weight_decay:
        upd = ops.add(upd, ops.mul(pf, weight_decay))
    p_new = ops.sub(pf, ops.mul(upd, lr))
    return (ops.convert_element_type(p_new, p.dtype),
            ops.convert_element_type(m_new, state_dtype if state_dtype is not None else m.dtype),
            ops.convert_element_type(v_new, v_dtype if v_dtype is not None else v.dtype))


@opsymbol(name="fused_adamw", id="optim.fused_adamw")
def fused_adamw_composite(params, grads, ms, vs, bc1, bc2, *, lr: float = 1e-3,
                          beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                          weight_decay: float = 0.0, state_dtype=None, v_dtype=None):
    """Multi-tensor AdamW over one dtype bucket: ``adamw_step`` of every
    ``(p, g, m, v)``, returned as ``(new_params, new_ms, new_vs)``."""
    params, grads, ms, vs = tuple(params), tuple(grads), tuple(ms), tuple(vs)
    check(len(params) > 0, "fused_adamw: empty bucket")
    check(len(params) == len(grads) == len(ms) == len(vs),
          lambda: f"fused_adamw: mismatched bucket lengths "
                  f"{(len(params), len(grads), len(ms), len(vs))}")
    triples = [adamw_step(p, g, m, v, bc1, bc2, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                          weight_decay=weight_decay, state_dtype=state_dtype, v_dtype=v_dtype)
               for p, g, m, v in zip(params, grads, ms, vs)]
    return tuple(tuple(t[i] for t in triples) for i in range(3))


def fused_adamw_into(params, grads, ms, vs, bc1, bc2, *, lr, beta1, beta2, eps,
                     weight_decay, state_dtype=None, v_dtype=None, donated=None):
    """A claimed ``optim.fused_adamw``, on either executor: one
    :func:`fused_adamw` (the kernel on the card, the plain version on the
    CPU) into the donated inputs the claim pass marks (``donated``, one
    tuple of flags per group of :func:`_fused_adamw_targets`, from
    ``passes.donate_in_place``) and dense
    copies of the others, so an input that was not donated is never
    written. Returns the updated ``(params, ms, vs)``. The moments must
    already be in their stored dtypes (``state_dtype``/``v_dtype``): both
    executors' checkers see to it."""
    marks = donated or ((False,) * len(params),) * 3
    ps, ms, vs = ([t if flag else torch.empty_like(t, memory_format=torch.contiguous_format)
                   .copy_(t) for t, flag in zip(group, flags)]
                  for group, flags in zip((params, ms, vs), marks))
    fused_adamw(ps, grads, ms, vs, torch.stack([bc1, bc2]), lr=lr, beta1=beta1, beta2=beta2,
                eps=eps, weight_decay=weight_decay)
    return tuple(ps), tuple(ms), tuple(vs)


def _fused_adamw_targets(params, grads, ms, vs, *args, state_dtype=None, v_dtype=None,
                         **hyper):
    """The groups :func:`fused_adamw_into` may write in place, each input
    with the dtype it is stored in: the params keep theirs, the moments take
    ``state_dtype``/``v_dtype``."""
    return [[(p, p.dtype) for p in params],
            *([(t, dtypes.to_dtype(dt) if dt is not None else t.dtype) for t in group]
              for group, dt in ((ms, state_dtype), (vs, v_dtype)))]


writes_in_place(fused_adamw_into, _fused_adamw_targets)


def moments_stored(ms, vs, state_dtype=None, v_dtype=None) -> bool:
    """Are the moments in the dtypes the optimizer stores them in?"""
    return all(want is None or group[0].dtype == dtypes.to_dtype(want)
               for group, want in ((ms, state_dtype), (vs, v_dtype)))
