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
A slab-persistent ``AdamW`` records :data:`fused_adamw_slab_composite`
(``optim.fused_adamw_slab``, :106) a bucket, and the numerics guard on
``jit`` each bucket's health pass (``optim.fused_adamw_health``,
``optim.fused_adamw_slab_health``: the port's, float64 ``(non-finite
grads, sum of g*g, non-finite p'/m'/v')``) and gated update
(``optim.fused_adamw_gated``, ``optim.fused_adamw_slab_gated``, whose
decomposition is the reference guard's ``where(healthy, new, old)``); each
is claimed by the kernel of the same name, the gated ones by the update
kernels given the health word, through the ``*_into`` callables here.
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


def _written(groups, donated):
    """Each group's tensors as a claimed writer writes them: the donated
    inputs the claim pass marks (``donated``, one tuple of flags a group,
    from ``passes.donate_in_place``) themselves, dense copies of the
    others, so an input that was not donated is never written."""
    marks = donated or tuple((False,) * len(g) for g in groups)
    return [[t if flag else torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
             for t, flag in zip(group, flags)] for group, flags in zip(groups, marks)]


def fused_adamw_into(params, grads, ms, vs, bc1, bc2, *, lr, beta1, beta2, eps,
                     weight_decay, state_dtype=None, v_dtype=None, donated=None, health=None):
    """A claimed ``optim.fused_adamw``, on either executor: one
    :func:`fused_adamw` (the kernel on the card, the plain version on the
    CPU) into the donated inputs the claim pass marks and dense copies of
    the others (:func:`_written`). Returns the updated ``(params, ms, vs)``.
    The moments must already be in their stored dtypes
    (``state_dtype``/``v_dtype``): both executors' checkers see to it.
    ``health`` gates the update (:func:`fused_adamw_gated_into`)."""
    ps, ms, vs = _written((params, ms, vs), donated)
    fused_adamw(ps, grads, ms, vs, torch.stack([bc1, bc2]), lr=lr, beta1=beta1, beta2=beta2,
                eps=eps, weight_decay=weight_decay, health=health)
    return tuple(ps), tuple(ms), tuple(vs)


def fused_adamw_gated_into(params, grads, ms, vs, bc1, bc2, health, *, donated=None, **kw):
    """A claimed ``optim.fused_adamw_gated``: :func:`fused_adamw_into` gated
    on the health word ``health``, so an unhealthy step leaves every output
    equal to its input."""
    return fused_adamw_into(params, grads, ms, vs, bc1, bc2, donated=donated, health=health,
                            **kw)


def fused_adamw_health_into(params, grads, ms, vs, bc1, bc2, *, lr, beta1, beta2, eps,
                            weight_decay, state_dtype=None, v_dtype=None):
    """A claimed ``optim.fused_adamw_health``: a fresh float64 accumulator
    of shape (3,) through one :func:`fused_adamw_health` (the kernel on the
    card, the plain version on the CPU)."""
    acc = torch.zeros(3, dtype=torch.float64, device=params[0].device)
    fused_adamw_health(params, grads, ms, vs, torch.stack([bc1, bc2]), acc, lr=lr,
                       beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    return acc


def fused_adamw_slab_into(params, grads, m_slab, v_slab, bc1, bc2, *, sizes, lr, beta1, beta2,
                          eps, weight_decay, donated=None, health=None):
    """A claimed ``optim.fused_adamw_slab``, on either executor: one
    :func:`fused_adamw_slab` into the donated params and slabs themselves,
    copies of the others (:func:`_written`); ``health`` gates it. Returns
    ``(params, m_slab, v_slab)``."""
    ps, (m,), (v,) = _written((params, (m_slab,), (v_slab,)), donated)
    fused_adamw_slab(ps, grads, m, v, torch.stack([bc1, bc2]), sizes=sizes, lr=lr,
                     beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
                     health=health)
    return tuple(ps), m, v


def fused_adamw_slab_gated_into(params, grads, m_slab, v_slab, bc1, bc2, health, *,
                                donated=None, **kw):
    """A claimed ``optim.fused_adamw_slab_gated``: :func:`fused_adamw_slab_into`
    gated on the health word."""
    return fused_adamw_slab_into(params, grads, m_slab, v_slab, bc1, bc2, donated=donated,
                                 health=health, **kw)


def fused_adamw_slab_health_into(params, grads, m_slab, v_slab, bc1, bc2, *, sizes, lr, beta1,
                                 beta2, eps, weight_decay):
    """A claimed ``optim.fused_adamw_slab_health``: the slab bucket's health
    pass into a fresh float64 accumulator."""
    acc = torch.zeros(3, dtype=torch.float64, device=params[0].device)
    fused_adamw_slab_health(params, grads, m_slab, v_slab, torch.stack([bc1, bc2]), acc,
                            sizes=sizes, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                            weight_decay=weight_decay)
    return acc


def _fused_adamw_targets(params, grads, ms, vs, *args, state_dtype=None, v_dtype=None,
                         **hyper):
    """The groups :func:`fused_adamw_into` may write in place, each input
    with the dtype it is stored in: the params keep theirs, the moments take
    ``state_dtype``/``v_dtype``."""
    return [[(p, p.dtype) for p in params],
            *([(t, dtypes.to_dtype(dt) if dt is not None else t.dtype) for t in group]
              for group, dt in ((ms, state_dtype), (vs, v_dtype)))]


def _slab_targets(params, grads, m_slab, v_slab, *args, **kwargs):
    """The groups :func:`fused_adamw_slab_into` may write in place: the
    params and each slab, in their own dtypes."""
    return [[(p, p.dtype) for p in params], [(m_slab, m_slab.dtype)], [(v_slab, v_slab.dtype)]]


for _fn, _targets in ((fused_adamw_into, _fused_adamw_targets),
                      (fused_adamw_gated_into, _fused_adamw_targets),
                      (fused_adamw_slab_into, _slab_targets),
                      (fused_adamw_slab_gated_into, _slab_targets)):
    writes_in_place(_fn, _targets)


def moments_stored(ms, vs, state_dtype=None, v_dtype=None) -> bool:
    """Are the moments in the dtypes the optimizer stores them in?"""
    return all(want is None or group[0].dtype == dtypes.to_dtype(want)
               for group, want in ((ms, state_dtype), (vs, v_dtype)))


# ---------------------------------------------------------------------------
# the slab update, the health passes and the gated updates on the trace
# (thunder_tpu/ops/optim.py:106; the gated forms and the health passes are
# the port's own: transforms/numerics_guard.py)
# ---------------------------------------------------------------------------

@opsymbol(name="fused_adamw_slab", id="optim.fused_adamw_slab")
def fused_adamw_slab_composite(params, grads, m_slab, v_slab, bc1, bc2, *, sizes,
                               lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                               eps: float = 1e-8, weight_decay: float = 0.0):
    """Multi-tensor AdamW over one dtype bucket whose m and v live in the
    ``(rows, 128)`` slabs between steps (``AdamW(slab_persistent=True)``):
    ``(params, grads, m_slab, v_slab, bc1, bc2) -> (new_params, new_m_slab,
    new_v_slab)``. The reference's decomposition: each parameter's run of
    the flattened slabs takes ``adamw_step`` and is packed back; the zero pad
    tail stays zero."""
    params, grads = tuple(params), tuple(grads)
    sizes = tuple(int(s) for s in sizes)
    check(len(params) > 0, "fused_adamw_slab: empty bucket")
    check(len(params) == len(grads) == len(sizes),
          lambda: f"fused_adamw_slab: mismatched bucket lengths "
                  f"{(len(params), len(grads), len(sizes))}")
    total = sum(sizes)
    rows_pad, _ = slab_geometry(total)
    check(tuple(m_slab.shape) == (rows_pad, SLAB_LANE)
          and tuple(v_slab.shape) == (rows_pad, SLAB_LANE),
          lambda: f"fused_adamw_slab: slab shape {tuple(m_slab.shape)}/{tuple(v_slab.shape)} "
                  f"does not match the bucket geometry ({rows_pad}, {SLAB_LANE}) for {total} "
                  f"elements")
    m_flat = ops.reshape(m_slab, (rows_pad * SLAB_LANE,))
    v_flat = ops.reshape(v_slab, (rows_pad * SLAB_LANE,))
    new_ps, new_ms, new_vs = [], [], []
    off = 0
    for p, g, n in zip(params, grads, sizes):
        m_i = ops.reshape(ops.narrow(m_flat, 0, off, n), tuple(p.shape))
        v_i = ops.reshape(ops.narrow(v_flat, 0, off, n), tuple(p.shape))
        p_new, m_new, v_new = adamw_step(p, g, m_i, v_i, bc1, bc2, lr=lr, beta1=beta1,
                                         beta2=beta2, eps=eps, weight_decay=weight_decay,
                                         state_dtype=m_slab.dtype, v_dtype=v_slab.dtype)
        new_ps.append(p_new)
        new_ms.append(ops.reshape(m_new, (n,)))
        new_vs.append(ops.reshape(v_new, (n,)))
        off += n
    pad = rows_pad * SLAB_LANE - total
    if pad:
        new_ms.append(ops.full((pad,), 0.0, dtype=m_slab.dtype, device=m_slab.device))
        new_vs.append(ops.full((pad,), 0.0, dtype=v_slab.dtype, device=v_slab.device))
    m_out = ops.reshape(ops.cat(new_ms, 0), (rows_pad, SLAB_LANE))
    v_out = ops.reshape(ops.cat(new_vs, 0), (rows_pad, SLAB_LANE))
    return tuple(new_ps), m_out, v_out


def _count_nonfinite(t):
    """The count of ``t``'s non-finite elements, float64 (exact)."""
    return ops.sum(ops.convert_element_type(ops.logical_not(ops.isfinite(t)), dtypes.float64))


def _tally_terms(g, new):
    """One parameter's health terms, float64 (3,): its non-finite grads, the
    float32 sum of g*g, the non-finite elements of ``new`` (p', m', v' as
    stored)."""
    gf = ops.convert_element_type(g, dtypes.float32)
    nf_state = _count_nonfinite(new[0])
    for t in new[1:]:
        nf_state = ops.add(nf_state, _count_nonfinite(t))
    ss = ops.convert_element_type(ops.sum(ops.mul(gf, gf)), dtypes.float64)
    return ops.stack([_count_nonfinite(gf), ss, nf_state], 0)


def _sum_terms(terms, device):
    acc = ops.full((3,), 0.0, dtype=dtypes.float64, device=device)
    for t in terms:
        acc = ops.add(acc, t)
    return acc


@opsymbol(name="fused_adamw_health", id="optim.fused_adamw_health")
def fused_adamw_health_composite(params, grads, ms, vs, bc1, bc2, *, lr: float = 1e-3,
                                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                                 weight_decay: float = 0.0, state_dtype=None, v_dtype=None):
    """The health pass of ``optim.fused_adamw`` over its bucket: float64
    ``(non-finite grads, sum of g*g, non-finite p'/m'/v' as stored)``, the
    update computed and nothing stored."""
    terms = [_tally_terms(g, adamw_step(p, g, m, v, bc1, bc2, lr=lr, beta1=beta1, beta2=beta2,
                                        eps=eps, weight_decay=weight_decay,
                                        state_dtype=state_dtype, v_dtype=v_dtype))
             for p, g, m, v in zip(params, grads, ms, vs, strict=True)]
    return _sum_terms(terms, params[0].device)


@opsymbol(name="fused_adamw_slab_health", id="optim.fused_adamw_slab_health")
def fused_adamw_slab_health_composite(params, grads, m_slab, v_slab, bc1, bc2, *, sizes,
                                      lr: float = 1e-3, beta1: float = 0.9,
                                      beta2: float = 0.999, eps: float = 1e-8,
                                      weight_decay: float = 0.0):
    """The health pass of ``optim.fused_adamw_slab`` over its bucket, as
    ``optim.fused_adamw_health`` is of ``optim.fused_adamw``."""
    m_flat = ops.reshape(m_slab, (int(m_slab.shape[0]) * SLAB_LANE,))
    v_flat = ops.reshape(v_slab, (int(v_slab.shape[0]) * SLAB_LANE,))
    terms, off = [], 0
    for p, g, n in zip(params, grads, sizes, strict=True):
        n = int(n)
        m_i = ops.reshape(ops.narrow(m_flat, 0, off, n), tuple(p.shape))
        v_i = ops.reshape(ops.narrow(v_flat, 0, off, n), tuple(p.shape))
        terms.append(_tally_terms(g, adamw_step(
            p, g, m_i, v_i, bc1, bc2, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
            weight_decay=weight_decay, state_dtype=m_slab.dtype, v_dtype=v_slab.dtype)))
        off += n
    return _sum_terms(terms, params[0].device)


def healthy_of(health):
    """The verdict of a traced health word, a 0-d bool: its non-finite total
    (grads + loss + state, in that order) is 0 (:func:`healthy`)."""
    total = ops.add(ops.add(ops.getitem(health, 0), ops.getitem(health, 1)),
                    ops.getitem(health, 2))
    return ops.eq(total, 0.0)


def _select(ok, new, old):
    return tuple(ops.where(ok, n, o) for n, o in zip(new, old))


@opsymbol(name="fused_adamw_gated", id="optim.fused_adamw_gated")
def fused_adamw_gated_composite(params, grads, ms, vs, bc1, bc2, health, *, lr: float = 1e-3,
                                beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                                weight_decay: float = 0.0, state_dtype=None, v_dtype=None):
    """``optim.fused_adamw`` gated on a health word: the reference guard's
    select, ``where(healthy, new, old)`` for every output, so an unhealthy
    step returns its inputs bit for bit. Claimed, the update kernel reads
    the word and stores nothing unless it is healthy."""
    new = fused_adamw_composite(params, grads, ms, vs, bc1, bc2, lr=lr, beta1=beta1,
                                beta2=beta2, eps=eps, weight_decay=weight_decay,
                                state_dtype=state_dtype, v_dtype=v_dtype)
    ok = healthy_of(health)
    return tuple(_select(ok, n, o) for n, o in zip(new, (params, ms, vs)))


@opsymbol(name="fused_adamw_slab_gated", id="optim.fused_adamw_slab_gated")
def fused_adamw_slab_gated_composite(params, grads, m_slab, v_slab, bc1, bc2, health, *, sizes,
                                     lr: float = 1e-3, beta1: float = 0.9,
                                     beta2: float = 0.999, eps: float = 1e-8,
                                     weight_decay: float = 0.0):
    """``optim.fused_adamw_slab`` gated on a health word, as
    ``optim.fused_adamw_gated`` gates ``optim.fused_adamw``."""
    ps, m, v = fused_adamw_slab_composite(params, grads, m_slab, v_slab, bc1, bc2, sizes=sizes,
                                          lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                                          weight_decay=weight_decay)
    ok = healthy_of(health)
    return _select(ok, ps, params), ops.where(ok, m, m_slab), ops.where(ok, v, v_slab)
