"""``core.transforms.forward_and_backward_from_trace``, the min-cut
(``core.rematerialization.find_cut``, ``rematerialize_forward_and_backward``)
and the front end's ``torch.autograd.Function`` and ``torch.utils.checkpoint``
lookasides, against the JAX package's, on the CPU.

The split and the min-cut: the same function traced by both packages (the
counterparts of ``tests/test_remat.py``'s and ``tests/test_grad.py``'s split
cases) gives the same forward outputs and backward gradients, and the same
count and bytes of saved tensors before and after the min-cut; the
rematerialized pair gives the unrematerialized pair's gradients; no product
(``dot_general``) is recomputed; a tensor of more than 2**31 bytes keeps its
exact cost in the integer capacities.

The lookasides (the counterparts of ``tests/test_autograd_function.py``'s
cases that need no Hugging Face model): a user's ``Function`` records its
``forward`` as a composite whose VJP rule is the user's ``backward``;
``checkpoint`` records a checkpointed region whose backward recomputes it;
``Function.apply`` is restored after the trace; the port's own routers keep
their ``__torch_function__`` entry and never reach the lookaside.

Tolerances (float32): forward values and losses 1e-5 relative, gradients
1e-5 of each leaf's largest magnitude (1e-4 through a checkpointed linear
layer, whose recompute sums in another order).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.utils.checkpoint as tuc

import thunder_tpu.torch as ttorch
from thunder_tpu import ops as jops
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core import prims as jprims
from thunder_tpu.core.proxies import TensorProxy as JTensorProxy
from thunder_tpu.core.rematerialization import find_cut as jfind_cut
from thunder_tpu.core.rematerialization import (
    rematerialize_forward_and_backward as jremat)
from thunder_tpu.core.trace import TraceCtx as JTraceCtx
from thunder_tpu.core.trace import tracectx as jtracectx
from thunder_tpu.core.transforms import forward_and_backward_from_trace as jsplit
import thunder_tpu_torch as ptt
from thunder_tpu_torch import ops
from thunder_tpu_torch.core import dtypes, prims
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.rematerialization import _capacity, _save_cost, find_cut
from thunder_tpu_torch.core.trace import TraceCtx, tracectx
from thunder_tpu_torch.ops import nn as tnn

# the two packages, by the names each function below uses
PORT = dict(ops=ops, TP=TensorProxy, Trace=TraceCtx, ctx=tracectx, dt=dtypes, P=prims,
            kw={"device": "cpu"})
REF = dict(ops=jops, TP=JTensorProxy, Trace=JTraceCtx, ctx=jtracectx, dt=jdtypes, P=jprims, kw={})


def _mlp(pk, x, w):
    h = pk["ops"].tanh(pk["ops"].matmul(x, w))
    return pk["ops"].sum(pk["ops"].mul(h, h))


def _chain(pk, x, w):
    o = pk["ops"]
    h = o.matmul(x, w)
    a = o.exp(o.mul(h, 0.1))
    b = o.sin(a)
    return o.sum(o.mul(o.mul(a, b), o.cos(b)))


def _two_out(pk, x, w):
    o = pk["ops"]
    h = o.tanh(o.matmul(x, w))
    return o.sum(o.mul(h, 2.0)), o.sigmoid(h)


def _dup_out(pk, x, w):
    o = pk["ops"]
    h = o.mul(o.matmul(x, w), 3.0)
    return h, h


FUNCS = {"mlp": _mlp, "chain": _chain, "two-out": _two_out, "dup-out": _dup_out}


def _trace(pk, fn, shapes=((4, 16), (16, 16))):
    trc = pk["Trace"]("computation")
    with pk["ctx"](trc):
        args = [pk["TP"](name, shape=s, dtype=pk["dt"].float32, **pk["kw"])
                for name, s in zip(("x", "w"), shapes)]
        out = fn(pk, *args)
        pk["P"].python_return(out)
    trc.args = args
    trc.output = out
    return trc


def _saved(fwd):
    saved = fwd.output[1]
    return len(saved), sum(int(np.prod(p.shape)) * p.dtype.bytes for p in saved)


def _inputs():
    rng = np.random.RandomState(2)
    return rng.randn(4, 16).astype(np.float32), (0.3 * rng.randn(16, 16)).astype(np.float32)


def _cts(out_flat, seed=5):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*o.shape), np.float32) for o in out_flat]


def _run_pair(fwd, bwd, args, cts, torch_side: bool):
    conv = (lambda a: torch.from_numpy(a)) if torch_side else (lambda a: a)
    out, saved = fwd.python_callable()(*[conv(a) for a in args])
    grads = bwd.python_callable()(*saved, *[conv(c) for c in cts])
    return out, grads


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", list(FUNCS))
def test_split_and_min_cut_match_reference(name):
    """The split's outputs and gradients, and the saved count and bytes
    before and after the min-cut, equal the reference's; the
    rematerialized pair gives the same gradients, and recomputes no
    product."""
    fn = FUNCS[name]
    tf, tb, tsaved = ptt.forward_and_backward_from_trace(_trace(PORT, fn))
    jf, jb, jsaved = jsplit(_trace(REF, fn))
    assert _saved(tf) == _saved(jf) and len(tsaved) == len(jsaved)
    tnf, tnb = ptt.rematerialize_forward_and_backward(tf, tb)
    jnf, jnb = jremat(jf, jb)
    assert _saved(tnf) == _saved(jnf)
    assert _saved(tnf)[1] <= _saved(tf)[1]

    args = _inputs()
    cts = _cts(_flat(tf.output[0]))
    tout, tg = _run_pair(tf, tb, args, cts, True)
    jout, jg = _run_pair(jf, jb, args, cts, False)
    _, rg = _run_pair(tnf, tnb, args, cts, True)
    for a, b in zip(_flat(tout), _flat(jout), strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    for g, want, again in zip(tg, jg, rg):
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(g), _np(want), atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(_np(again), _np(g), atol=1e-6 * scale, rtol=0)
    recomputed = tnb.bound_symbols[:len(tnb.bound_symbols) - len(tb.bound_symbols)]
    assert all(b.sym.id is not PrimIDs.DOT_GENERAL for b in recomputed)


def test_min_cut_keeps_exact_costs_past_2_31_bytes():
    """A (65536, 32000) float32 product (8.39 GB, past int32) feeding a bf16
    copy and an exp: its cost is exact in the capacities, and the cut saves
    a 4.19 GB bf16 tensor, never the product, as the reference's cut over
    float capacities does."""
    def big(pk, x, w):
        o = pk["ops"]
        h = o.convert_element_type(o.matmul(x, w), pk["dt"].bfloat16)
        return o.sum(o.exp(h))

    shapes = ((65536, 128), (128, 32000))
    tf, tb, _ = ptt.forward_and_backward_from_trace(_trace(PORT, big, shapes))
    jf, jb, _ = jsplit(_trace(REF, big, shapes))
    prod = next(b.output for b in tf.bound_symbols if b.sym.id is PrimIDs.DOT_GENERAL)
    assert _save_cost(prod) == 65536 * 32000 * 4 > 2 ** 31
    assert _capacity(prod, free=False) == 65536 * 32000 * 4 * 10 ** 6
    required = [p for p in tb.args if p.name in {s.name for s in tf.output[1]}]
    jrequired = [p for p in jb.args if p.name in {s.name for s in jf.output[1]}]
    cut = find_cut(tf, required)
    jcut = jfind_cut(jf, jrequired)
    sizes = sorted(_save_cost(p) for p in tf.output[1] if p.name in cut)
    jsizes = sorted(float(np.prod(p.shape)) * p.dtype.bytes for p in jf.output[1]
                    if p.name in jcut)
    assert sizes == jsizes and prod.name not in cut
    assert _saved(ptt.rematerialize_forward_and_backward(tf, tb)[0]) == _saved(jremat(jf, jb)[0])


# ---------------------------------------------------------------------------
# the torch.autograd.Function and torch.utils.checkpoint lookasides
# ---------------------------------------------------------------------------

class MulScale(torch.autograd.Function):
    """Classic style: ctx saves, a non-tensor argument, a ctx attribute."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x)
        ctx.scale = scale
        return x * x * scale

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 2 * x * ctx.scale * g, None


class STE(torch.autograd.Function):
    """Straight-through: the backward is not autodiff of round()."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class NewStyleMul(torch.autograd.Function):
    @staticmethod
    def forward(x, y):
        return x * y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * y, g * x


class TwoOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * 2, x * 3

    @staticmethod
    def backward(ctx, ga, gb):
        return ga * 2 + gb * 3


class CtxAttr(torch.autograd.Function):
    """A tensor kept as a plain ctx attribute, replayed like a save."""

    @staticmethod
    def forward(ctx, x):
        ctx.x = x
        ctx.k = 3.0
        return x * x

    @staticmethod
    def backward(ctx, g):
        return g * 2 * ctx.x * (ctx.k / 3.0)


class MeanSq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target):
        diff = pred - target
        ctx.save_for_backward(diff)
        return (diff * diff).mean()

    @staticmethod
    def backward(ctx, g):
        (diff,) = ctx.saved_tensors
        return g * 2 * diff / diff.numel(), None


class _W(nn.Module):
    def __init__(self, w, body):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w))
        self.body = body

    def forward(self, *xs):
        return self.body(self, *xs)


def _lin(body):
    class Ck(nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(8, 8)
            self.l2 = nn.Linear(8, 8)

        def forward(self, *xs):
            return body(self, *xs)

    return Ck


MODULES = {
    "classic ctx": (lambda: _W([1.5, -2.0, 0.5], lambda m, x: MulScale.apply(x * m.w, 3.0).sum()),
                    lambda: (torch.tensor([1.0, 2.0, 3.0]),), 1e-5),
    "new style": (lambda: _W([2.0, -1.0], lambda m, x: NewStyleMul.apply(x, m.w).sum()),
                  lambda: (torch.tensor([3.0, 4.0]),), 1e-5),
    "two outputs": (lambda: _W([1.0, 2.0], lambda m, x: (lambda a, b: (a * 2 + b).sum())(
        *TwoOut.apply(x * m.w))), lambda: (torch.tensor([1.0, 3.0]),), 1e-5),
    "ctx attribute": (lambda: _W([1.0, 2.0, 3.0], lambda m, x: CtxAttr.apply(x * m.w).sum()),
                      lambda: (torch.tensor([0.5, -1.0, 2.0]),), 1e-5),
    "scalar loss": (lambda: _W([0.5, 1.5, -1.0, 2.0], lambda m, x, t: MeanSq.apply(x * m.w, t)),
                    lambda: (torch.randn(4, 4), torch.randn(4, 4)), 1e-5),
    "checkpoint": (_lin(lambda m, x: m.l2(tuc.checkpoint(
        lambda y: torch.tanh(m.l1(y)), x, use_reentrant=False)).sum()),
        lambda: (torch.randn(4, 8),), 1e-4),
    "checkpoint kwargs": (_lin(lambda m, x, mask: tuc.checkpoint(
        lambda y, mask=None: torch.tanh(m.l1(y)) * mask, x, mask=mask,
        use_reentrant=False).sum()),
        lambda: (torch.randn(3, 8), torch.tensor([[1.0], [0.0], [1.0]])), 1e-4),
    "checkpoint sequential": (lambda: type("Seq", (nn.Module,), {
        "__init__": lambda self: (nn.Module.__init__(self), setattr(self, "seq", nn.Sequential(
            nn.Linear(8, 8), nn.Tanh(), nn.Linear(8, 8), nn.Tanh())))[0],
        "forward": lambda self, x: tuc.checkpoint_sequential(self.seq, 2, x,
                                                             use_reentrant=False).sum()})(),
        lambda: (torch.randn(4, 8),), 1e-4),
}


@pytest.mark.parametrize("case", list(MODULES))
def test_lookaside_grads_match_reference_and_eager(case):
    make, inputs, rel = MODULES[case]
    torch.manual_seed(0)
    m = make() if not isinstance(make, type) else make()
    mr, mp = copy.deepcopy(m), copy.deepcopy(m)
    xs = inputs()
    jp = ptt.jit(mp, device="cpu")
    losses = [call(*xs) for call in (m, ttorch.jit(mr), jp)]
    for loss in losses:
        loss.backward()
    want, ref, got = (float(x.detach()) for x in losses)
    assert abs(got - want) <= 1e-5 * abs(want) and abs(got - ref) <= 1e-5 * abs(ref)
    for (n, p), (_, pr), (_, pp) in zip(m.named_parameters(), mr.named_parameters(),
                                        mp.named_parameters()):
        if p.grad is None:   # a parameter the loss does not use
            assert pp.grad is None
            continue
        scale = float(p.grad.abs().max())
        np.testing.assert_allclose(pp.grad.numpy(), p.grad.numpy(), atol=rel * scale, rtol=0)
        np.testing.assert_allclose(pp.grad.numpy(), pr.grad.numpy(), atol=rel * scale, rtol=0)
    step = next(iter(jp._autograd_cache.values()))
    src = step.computation_trace.python()
    if case.startswith("checkpoint"):
        assert "checkpoint(" in src
    else:
        assert "autograd_function_" in src


def test_user_backward_is_respected_and_apply_restored():
    """STE's backward passes the cotangent through, where autodiff of
    round() gives zero; after the trace, real tensors use the real apply;
    the grad-free path runs the composite's forward."""
    m = _W([0.3, 1.7, 2.2], lambda mod, x: (STE.apply(mod.w) * x).sum())
    x = torch.tensor([1.0, 2.0, 3.0])
    ptt.jit(m, device="cpu")(x).backward()
    assert torch.equal(m.w.grad, x)
    jm = ptt.jit(_W([0.0], lambda mod, x: MulScale.apply(x, 2.0)), device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(jm(torch.tensor([1.0, 2.0])).numpy(), [2.0, 8.0], rtol=1e-6)
    xr = torch.tensor([0.3, 1.7], requires_grad=True)
    out = STE.apply(xr)
    out.sum().backward()
    assert torch.equal(out, torch.tensor([0.0, 2.0])) and torch.equal(xr.grad, torch.ones(2))
    assert torch.autograd.Function.__dict__["apply"] is not None
    assert "_traced_apply" not in repr(torch.autograd.Function.apply)


def test_function_level_jit_runs_the_user_backward():
    def f(x):
        return MulScale.apply(x, 4.0).sum()

    x = torch.tensor([1.0, 2.0], requires_grad=True)
    ptt.jit(f, device="cpu")(x).backward()
    np.testing.assert_allclose(x.grad.numpy(), [8.0, 16.0], rtol=1e-6)


def test_checkpoint_backward_recomputes_the_region():
    """sigmoid(tanh(linear(y))) under checkpoint: the backward program
    recomputes the region (its product and tanh), and the forward saves
    no more than the region's inputs and output."""
    class Ck(nn.Module):
        def __init__(self):
            super().__init__()
            self.l1 = nn.Linear(8, 8)

        def forward(self, x):
            return tuc.checkpoint(lambda y: torch.sigmoid(torch.tanh(self.l1(y))), x,
                                  use_reentrant=False).sum()

    torch.manual_seed(0)
    jm = ptt.jit(Ck(), device="cpu")
    jm(torch.randn(4, 8)).backward()
    step = next(iter(jm._autograd_cache.values()))
    fwd, bwd = step.split
    src = bwd.python()
    assert "tanh(" in src and "dot_general(" in src
    assert len([s for s in bwd.args if getattr(s, "ndim", 0) == 2]) <= 3


def test_routers_keep_their_torch_function_entry():
    """The port's routers (autograd Functions inside) record their composites
    under the trace and never reach the lookaside."""
    class Normed(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(8))

        def forward(self, x):
            return tnn.rms_norm(x, self.w, eps=1e-5).sum()

    jm = ptt.jit(Normed(), device="cpu")
    x = torch.randn(4, 8)
    jm(x).backward()
    src = next(iter(jm._autograd_cache.values())).computation_trace.python()
    assert "rms_norm(" in src and "autograd_function" not in src
