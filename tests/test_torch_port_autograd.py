"""Trace-level autograd of the port (``thunder_tpu_torch.value_and_grad``,
``grad``, ``checkpoint``; ``core/transforms.py``) against the JAX
package's, on the CPU.

Every case feeds the same seeded numpy inputs to
``thunder_tpu.jit(lambda ...: tt.value_and_grad(f)(...))`` and to
``thunder_tpu_torch.jit(lambda ...: ptt.value_and_grad(f)(...),
device="cpu")`` and compares the value and the gradients:

- one case per VJP rule of a prim that the port registers (the test checks
  the list is complete): ``f`` calls the prim in each package
  (``on_torch`` hands the port's prim the traced proxies) and reduces its
  output against a fixed random cotangent;
- the nn rules: attention causal and not, the RMS norm with and without
  weight, cross-entropy with mean, sum and an ``ignore_index``; and calls the
  rules decline (an attention mask, label smoothing), differentiated
  through their decompositions;
- ``has_aux``, ``argnums`` as a tuple, and ``grad``;
- ``checkpoint``: the same gradients as the region unchecked, the backward
  reading only the region's inputs, and the recompute kept apart by CSE;
- the errors: a prim without a rule, and ``value_and_grad`` outside a
  trace.

The reference's Pallas claims run in interpret mode. Tolerance (float32):
each value and each gradient leaf to 1e-5 of its largest magnitude (the
same formulas, summed in another order by XLA and by torch).
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import thunder_tpu as tt
from thunder_tpu import ops as jops
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core import prims as jprims
from thunder_tpu.core.rematerialization import checkpoint as jcheckpoint
from thunder_tpu.core.symbol import Symbol as JSymbol
from thunder_tpu.core.proxies import TensorProxy as JTensorProxy
from thunder_tpu.ops import nn as jnn
import thunder_tpu_torch as ptt
from thunder_tpu_torch import ops as pops
from thunder_tpu_torch.core import dtypes as pdtypes
from thunder_tpu_torch.core import prims as pprims
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy as PTensorProxy
from thunder_tpu_torch.core.symbol import Symbol as PSymbol
from thunder_tpu_torch.core.transforms import _vjp_rules
from thunder_tpu_torch.torch import on_torch
from thunder_tpu_torch.testing import expanded_names

REF = SimpleNamespace(ops=jops, prims=jprims, dtypes=jdtypes)
PORT = SimpleNamespace(ops=pops, prims=pprims, dtypes=pdtypes)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=rel * scale, rtol=0)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(got, want):
    """Two (value, grads) results: every leaf within the tolerance."""
    import jax

    g_leaves = [_np(x) for x in jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    w_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape
        _close(g, w)


def _run_both(f, inputs, argnums):
    """``value_and_grad(f, argnums)`` under each package's jit. ``f(P, *xs)``
    is written once against a package namespace ``P`` (ops, prims, dtypes)
    over its proxies."""
    want = tt.jit(lambda *xs: tt.value_and_grad(
        lambda *ys: f(REF, *ys), argnums=argnums)(*xs))(*inputs)
    got = ptt.jit(lambda *xs: ptt.value_and_grad(
        on_torch(lambda *ys: f(PORT, *ys)), argnums=argnums)(*xs), device="cpu")(*inputs)
    return got, want


def _against(P, out, w):
    """The scalar loss ``sum(out * w)`` (float32)."""
    out = P.ops.convert_element_type(out, P.dtypes.float32)
    return P.ops.sum(P.ops.mul(out, w))


# ---------------------------------------------------------------------------
# one case per prim rule
# ---------------------------------------------------------------------------

def _rng(seed=0):
    return np.random.default_rng(seed)


def _u(lo, hi, *shape, seed=0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _unary(name, lo=-1.5, hi=1.5):
    def case():
        x = _u(lo, hi, 3, 5)
        w = _u(-1, 1, 3, 5, seed=1)
        return (lambda P, x, w: _against(P, getattr(P.prims, name)(x), w)), (x, w), 0

    return case


def _binary(name, lo=-1.5, hi=1.5, blo=None, bhi=None):
    def case():
        a = _u(lo, hi, 3, 5)
        b = _u(blo if blo is not None else lo, bhi if bhi is not None else hi, 3, 5, seed=2)
        w = _u(-1, 1, 3, 5, seed=1)
        return (lambda P, a, b, w: _against(P, getattr(P.prims, name)(a, b), w)), (a, b, w), (0, 1)

    return case


def _with_w(shape, fn, *extra):
    """A case of one float input x (3, 4, 5) and extra non-float inputs."""
    def case():
        x = _u(-1.5, 1.5, 3, 4, 5)
        w = _u(-1, 1, *shape, seed=1)
        return (lambda P, x, w, *e: _against(P, fn(P, x, *e), w)), (x, w, *extra), 0

    return case


_IDX = np.array([2, 0, 2, 1], dtype=np.int32)
_ALONG = _rng(3).integers(0, 4, (3, 2, 5)).astype(np.int32)


def _index_add():
    a, v = _u(-1, 1, 3, 4), _u(-1, 1, 3, 2, seed=4)
    w = _u(-1, 1, 3, 4, seed=1)
    idx = np.array([3, 1], dtype=np.int32)
    return (lambda P, a, v, w, i: _against(P, P.prims.index_add(a, i, v, 1), w)), \
        (a, v, w, idx), (0, 1)


def _scatter_add():
    a, v = _u(-1, 1, 3, 4, 5), _u(-1, 1, 3, 2, 5, seed=4)
    w = _u(-1, 1, 3, 4, 5, seed=1)
    return (lambda P, a, v, w, i: _against(P, P.prims.scatter_add(a, i, v, 1), w)), \
        (a, v, w, _ALONG), (0, 1)


def _index_put(accumulate):
    def case():
        a, v = _u(-1, 1, 4, 5), _u(-1, 1, 3, 5, seed=4)
        w = _u(-1, 1, 4, 5, seed=1)
        idx = np.array([2, 0, 2], dtype=np.int32)   # a duplicate: replace keeps one write
        return (lambda P, a, v, w, i: _against(P, P.prims.index_put(a, (i,), v, accumulate), w)), \
            (a, v, w, idx), (0, 1)

    return case


def _dus():
    a, u = _u(-1, 1, 4, 5), _u(-1, 1, 2, 3, seed=4)
    w = _u(-1, 1, 4, 5, seed=1)
    return (lambda P, a, u, w: _against(P, P.prims.dynamic_update_slice(a, u, (1, 2)), w)), \
        (a, u, w), (0, 1)


def _where():
    a, b, c = _u(-1, 1, 3, 5), _u(-1, 1, 3, 5, seed=2), _u(-1, 1, 3, 5, seed=3)
    w = _u(-1, 1, 3, 5, seed=1)
    return (lambda P, a, b, c, w: _against(P, P.prims.where(P.ops.gt(c, 0.0), a, b), w)), \
        (a, b, c, w), (0, 1)


def _cat():
    a, b = _u(-1, 1, 3, 2), _u(-1, 1, 3, 4, seed=2)
    w = _u(-1, 1, 3, 6, seed=1)
    return (lambda P, a, b, w: _against(P, P.prims.cat([a, b], 1), w)), (a, b, w), (0, 1)


def _dot_general():
    a, b = _u(-1, 1, 2, 3, 4), _u(-1, 1, 2, 5, 3, seed=2)
    w = _u(-1, 1, 2, 4, 5, seed=1)
    return (lambda P, a, b, w: _against(P, P.prims.dot_general(
        a, b, contract_dims=((1,), (2,)), batch_dims=((0,), (0,))), w)), (a, b, w), (0, 1)


def _convert():
    x = _u(-1, 1, 3, 5)
    w = _u(-1, 1, 3, 5, seed=1)
    return (lambda P, x, w: _against(P, P.prims.convert_element_type(x, P.dtypes.float16), w)), \
        (x, w), 0


def _detach():
    x = _u(-1, 1, 3, 5)
    w = _u(-1, 1, 3, 5, seed=1)
    return (lambda P, x, w: _against(P, P.ops.mul(P.prims.detach(x), x), w)), (x, w), 0


def _opt_barrier():
    a, b = _u(-1, 1, 3, 5), _u(-1, 1, 3, 5, seed=2)
    w = _u(-1, 1, 3, 5, seed=1)

    def f(P, a, b, w):
        x, y = P.prims.opt_barrier(a, b)
        return P.ops.add(_against(P, x, w), _against(P, P.ops.mul(y, y), w))

    return f, (a, b, w), (0, 1)


PRIM_CASES = {
    PrimIDs.NEG: _unary("neg"), PrimIDs.ABS: _unary("abs"), PrimIDs.EXP: _unary("exp"),
    PrimIDs.EXP2: _unary("exp2"), PrimIDs.EXPM1: _unary("expm1"),
    PrimIDs.LOG: _unary("log", 0.5, 2.0), PrimIDs.LOG1P: _unary("log1p", -0.5, 2.0),
    PrimIDs.LOG2: _unary("log2", 0.5, 2.0), PrimIDs.LOG10: _unary("log10", 0.5, 2.0),
    PrimIDs.SQRT: _unary("sqrt", 0.5, 2.0), PrimIDs.RSQRT: _unary("rsqrt", 0.5, 2.0),
    PrimIDs.SIN: _unary("sin"), PrimIDs.COS: _unary("cos"), PrimIDs.TAN: _unary("tan", -1, 1),
    PrimIDs.TANH: _unary("tanh"), PrimIDs.SINH: _unary("sinh"), PrimIDs.COSH: _unary("cosh"),
    PrimIDs.ASIN: _unary("asin", -0.9, 0.9), PrimIDs.ACOS: _unary("acos", -0.9, 0.9),
    PrimIDs.ATAN: _unary("atan"), PrimIDs.ERF: _unary("erf"), PrimIDs.ERFC: _unary("erfc"),
    PrimIDs.RECIPROCAL: _unary("reciprocal", 0.5, 2.0),
    PrimIDs.ADD: _binary("add"), PrimIDs.SUB: _binary("sub"), PrimIDs.MUL: _binary("mul"),
    PrimIDs.DIV: _binary("div", blo=0.5, bhi=2.0), PrimIDs.POW: _binary("pow", 0.5, 2.0),
    PrimIDs.MAXIMUM: _binary("maximum"), PrimIDs.MINIMUM: _binary("minimum"),
    PrimIDs.ATAN2: _binary("atan2", blo=0.5, bhi=2.0),
    PrimIDs.WHERE: _where, PrimIDs.CONVERT_ELEMENT_TYPE: _convert, PrimIDs.DETACH: _detach,
    PrimIDs.BROADCAST_IN_DIM: _with_w(
        (2, 3, 4, 5), lambda P, x: P.prims.broadcast_in_dim(x, (2, 3, 4, 5), (1, 2, 3))),
    PrimIDs.RESHAPE: _with_w((12, 5), lambda P, x: P.prims.reshape(x, (12, 5))),
    PrimIDs.SQUEEZE: _with_w((3, 5), lambda P, x: P.prims.squeeze(
        P.prims.slice_prim(x, (0, 1, 0), (3, 2, 5)), (1,))),
    PrimIDs.TRANSPOSE: _with_w((5, 3, 4), lambda P, x: P.prims.transpose(x, (2, 0, 1))),
    PrimIDs.SLICE: _with_w((2, 2, 3), lambda P, x: P.prims.slice_prim(
        x, (1, 0, 0), (3, 4, 5), (1, 2, 2))),
    PrimIDs.PAD: _with_w((4, 9, 5), lambda P, x: P.prims.pad(
        x, 0.0, ((1, 0, 0), (0, 2, 1), (0, 0, 0)))),
    PrimIDs.CAT: _cat,
    PrimIDs.FLIP: _with_w((3, 4, 5), lambda P, x: P.prims.flip(x, (0, 2))),
    PrimIDs.SUM: _with_w((3, 5), lambda P, x: P.prims.sum(x, (1,))),
    PrimIDs.PROD: _with_w((4,), lambda P, x: P.prims.prod(x, (0, 2))),
    PrimIDs.AMAX: _with_w((3, 4), lambda P, x: P.prims.amax(x, (2,))),
    PrimIDs.AMIN: _with_w((5,), lambda P, x: P.prims.amin(x, (0, 1))),
    PrimIDs.CUMSUM: _with_w((3, 4, 5), lambda P, x: P.prims.cumsum(x, 1)),
    PrimIDs.TAKE: _with_w((3, 4, 5), lambda P, x, i: P.prims.take(x, i, 1), _IDX),
    PrimIDs.TAKE_ALONG_AXIS: _with_w(
        (3, 2, 5), lambda P, x, i: P.prims.take_along_axis(x, i, 1), _ALONG),
    PrimIDs.DYNAMIC_SLICE: _with_w((2, 2, 3), lambda P, x: P.prims.dynamic_slice(
        x, (1, 2, 1), (2, 2, 3))),
    PrimIDs.DYNAMIC_UPDATE_SLICE: _dus,
    PrimIDs.INDEX_ADD: _index_add, PrimIDs.SCATTER_ADD: _scatter_add,
    PrimIDs.INDEX_PUT: _index_put(False),
    PrimIDs.DOT_GENERAL: _dot_general, PrimIDs.OPT_BARRIER: _opt_barrier,
}


def test_every_prim_rule_has_a_case():
    assert set(PRIM_CASES) == {k for k in _vjp_rules if isinstance(k, PrimIDs)}


@pytest.mark.parametrize("pid", list(PRIM_CASES), ids=[p.name.lower() for p in PRIM_CASES])
def test_prim_vjp_matches_reference(pid):
    f, inputs, argnums = PRIM_CASES[pid]()
    got, want = _run_both(f, inputs, argnums)
    _compare(got, want)


def test_index_put_accumulate_vjp_matches_reference():
    f, inputs, argnums = _index_put(True)()
    _compare(*_run_both(f, inputs, argnums))


# ---------------------------------------------------------------------------
# the nn rules, and calls they decline
# ---------------------------------------------------------------------------

def _attn_inputs(seed=0, B=1, H=2, T=8, S=8, hd=16):
    rng = _rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, T, hd), (B, H, S, hd), (B, H, S, hd), (B, H, T, hd)))


def _nn_both(jfn, tfn, inputs, argnums):
    want = tt.jit(lambda *xs: tt.value_and_grad(jfn, argnums=argnums)(*xs))(*inputs)
    got = ptt.jit(lambda *xs: ptt.value_and_grad(tfn, argnums=argnums)(*xs),
                  device="cpu")(*inputs)
    return got, want


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_sdpa_vjp_matches_reference(causal):
    def jfn(q, k, v, w):
        return jops.sum(jops.mul(jnn.scaled_dot_product_attention(q, k, v, is_causal=causal), w))

    def tfn(q, k, v, w):
        return torch.sum(F.scaled_dot_product_attention(q, k, v, is_causal=causal) * w)

    got, want = _nn_both(jfn, tfn, _attn_inputs(), (0, 1, 2))
    _compare(got, want)


def test_sdpa_vjp_emits_the_flash_pair():
    """The rule differentiates into ``nn.sdpa_fwd`` and ``nn.sdpa_bwd``."""
    pf = ptt.jit(lambda q, k, v: ptt.grad(
        lambda a: torch.sum(F.scaled_dot_product_attention(a, k, v, is_causal=True)))(q),
        device="cpu")
    q, k, v, _ = _attn_inputs()
    pf.compile(q, k, v)
    names = [b.sym.name for b in ptt.last_traces(pf)[2].bound_symbols]
    assert names.count("sdpa_fwd") == 1 and names.count("sdpa_bwd") == 1


@pytest.mark.parametrize("weighted", [True, False], ids=["weight", "no-weight"])
def test_rms_norm_vjp_matches_reference(weighted):
    rng = _rng(5)
    x, g = rng.standard_normal((2, 3, 16)).astype(np.float32), \
        rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (16,)).astype(np.float32)
    if weighted:
        got, want = _nn_both(lambda x, w, g: jops.sum(jops.mul(jnn.rms_norm(x, w, eps=1e-5), g)),
                             lambda x, w, g: torch.sum(F.rms_norm(x, (16,), w, eps=1e-5) * g),
                             (x, w, g), (0, 1))
    else:
        got, want = _nn_both(lambda x, g: jops.sum(jops.mul(jnn.rms_norm(x, None, eps=1e-5), g)),
                             lambda x, g: torch.sum(F.rms_norm(x, (16,), None, eps=1e-5) * g),
                             (x, g), 0)
    _compare(got, want)


@pytest.mark.parametrize("reduction, ignore", [("mean", -100), ("sum", -100), ("mean", 3)],
                         ids=["mean", "sum", "ignore_index"])
def test_cross_entropy_vjp_matches_reference(reduction, ignore):
    rng = _rng(6)
    logits = rng.standard_normal((12, 10)).astype(np.float32)
    target = rng.integers(0, 10, (12,)).astype(np.int32)
    target[::4] = 3
    got, want = _nn_both(
        lambda lg, t: jnn.cross_entropy(lg, t, ignore_index=ignore, reduction=reduction),
        lambda lg, t: F.cross_entropy(lg, t, ignore_index=ignore, reduction=reduction),
        (logits, target), 0)
    _compare(got, want)


@pytest.mark.parametrize("what", ["sdpa-mask", "ce-smoothing"])
def test_declined_rules_differentiate_the_decomposition(what):
    """A mask (attention) and label smoothing (cross-entropy): the rules
    return NotImplemented, and the decompositions are differentiated, as the
    reference does."""
    if what == "sdpa-mask":
        q, k, v, w = _attn_inputs(7)
        mask = _rng(8).standard_normal((8, 8)).astype(np.float32)
        got, want = _nn_both(
            lambda q, k, v, m, w: jops.sum(jops.mul(
                jnn.scaled_dot_product_attention(q, k, v, attn_mask=m), w)),
            lambda q, k, v, m, w: torch.sum(F.scaled_dot_product_attention(
                q, k, v, attn_mask=m) * w), (q, k, v, mask, w), (0, 1, 2))
    else:
        rng = _rng(9)
        logits = rng.standard_normal((12, 10)).astype(np.float32)
        target = rng.integers(0, 10, (12,)).astype(np.int32)
        got, want = _nn_both(lambda lg, t: jnn.cross_entropy(lg, t, label_smoothing=0.1),
                             lambda lg, t: F.cross_entropy(lg, t, label_smoothing=0.1),
                             (logits, target), 0)
    _compare(got, want)


def test_declined_rule_leaves_no_kernel_composite():
    """Label smoothing: neither ``ce_fwd`` nor the composite is left."""
    rng = _rng(9)
    logits = rng.standard_normal((12, 10)).astype(np.float32)
    target = rng.integers(0, 10, (12,)).astype(np.int32)
    pf = ptt.jit(lambda lg, t: ptt.grad(
        lambda a: F.cross_entropy(a, t, label_smoothing=0.1))(lg), device="cpu")
    pf.compile(logits, target)
    names = {b.sym.name for b in ptt.last_traces(pf)[2].bound_symbols}
    assert "ce_fwd" not in names and "cross_entropy" not in names


# ---------------------------------------------------------------------------
# the entry points' options
# ---------------------------------------------------------------------------

def _two_inputs():
    rng = _rng(10)
    return rng.standard_normal((4, 6)).astype(np.float32), \
        rng.standard_normal((6, 3)).astype(np.float32)


def test_has_aux_and_tuple_argnums():
    x, w = _two_inputs()

    def jfn(x, w):
        y = jops.matmul(x, w)
        return jops.sum(jops.tanh(y)), jops.amax(y)

    def tfn(x, w):
        y = x @ w
        return torch.sum(torch.tanh(y)), torch.amax(y)

    want = tt.jit(lambda a, b: tt.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(a, b))(x, w)
    got = ptt.jit(lambda a, b: ptt.value_and_grad(tfn, argnums=(0, 1), has_aux=True)(a, b),
                  device="cpu")(x, w)
    (gl, gaux), ggrads = got
    (wl, waux), wgrads = want
    assert isinstance(ggrads, tuple) and len(ggrads) == 2
    _compare(((gl, gaux), ggrads), ((wl, waux), wgrads))


def test_grad_and_trees():
    x, w = _two_inputs()
    want = tt.jit(lambda p: tt.grad(
        lambda q: jops.sum(jops.exp(jops.matmul(q["x"], q["w"][0]))))(p))({"x": x, "w": [w]})
    got = ptt.jit(lambda p: ptt.grad(
        lambda q: torch.sum(torch.exp(q["x"] @ q["w"][0])))(p), device="cpu")({"x": x, "w": [w]})
    assert set(got) == {"x", "w"} and len(got["w"]) == 1
    _compare(got, want)


# ---------------------------------------------------------------------------
# trace-level checkpoint
# ---------------------------------------------------------------------------

def _region_inputs():
    rng = _rng(11)
    return (rng.standard_normal((4, 8)).astype(np.float32),
            rng.standard_normal((8, 8)).astype(np.float32) / math.sqrt(8),
            rng.standard_normal((8, 8)).astype(np.float32) / math.sqrt(8))


def _tregion(h, w1, w2):
    return h + torch.tanh(torch.exp(h @ w1) * 0.1) @ w2


def _jregion(h, w1, w2):
    return jops.add(h, jops.matmul(jops.tanh(jops.mul(jops.exp(jops.matmul(h, w1)), 0.1)), w2))


def test_checkpoint_gradients_match_reference_and_unchecked():
    h, w1, w2 = _region_inputs()

    def tloss(ckpt):
        def f(h, w1, w2):
            region = ptt.activation_checkpoint(_tregion) if ckpt else _tregion
            return torch.sum(region(region(h, w1, w2), w1, w2))

        return f

    def jloss(h, w1, w2):
        region = jcheckpoint(_jregion)
        return jops.sum(region(region(h, w1, w2), w1, w2))

    want = tt.jit(lambda *a: tt.value_and_grad(jloss, argnums=(0, 1, 2))(*a))(h, w1, w2)
    checked = ptt.jit(lambda *a: ptt.value_and_grad(tloss(True), argnums=(0, 1, 2))(*a),
                      device="cpu")
    plain = ptt.jit(lambda *a: ptt.value_and_grad(tloss(False), argnums=(0, 1, 2))(*a),
                    device="cpu")
    got = checked(h, w1, w2)
    _compare(got, want)
    _compare(got, tuple(np.asarray(x) if not isinstance(x, tuple) else
                        tuple(_np(y) for y in x) for x in plain(h, w1, w2)))


def test_checkpoint_saves_only_its_inputs_and_survives_cse():
    """The backward reads nothing the region computes but its output: it
    recomputes the region from the inputs pinned by ``opt_barrier``, and
    CSE keeps the recompute (two ``exp``s, the forward's and the
    recompute's, after CSE)."""
    h, w1, w2 = _region_inputs()
    pf = ptt.jit(lambda *a: ptt.value_and_grad(
        lambda x, y, z: torch.sum(ptt.activation_checkpoint(_tregion)(x, y, z)),
        argnums=(0, 1, 2))(*a),
        device="cpu")
    pf.compile(h, w1, w2)
    cse_trc = ptt.last_traces(pf)[2]
    bsyms = cse_trc.bound_symbols
    ck = [i for i, b in enumerate(bsyms) if b.sym.name == "checkpoint"]
    assert len(ck) == 1
    inside = set()

    def produced(b):
        for p in b.flat_proxy_outs():
            inside.add(p.name)
        for s in b.subsymbols:
            produced(s)

    for s in bsyms[ck[0]].subsymbols:
        produced(s)
    inside -= {p.name for p in bsyms[ck[0]].flat_proxy_outs()}
    later = {p.name for b in bsyms[ck[0] + 1:] for p in b.flat_proxy_args()}
    assert not inside & later
    assert any(b.sym.name == "opt_barrier" for b in bsyms)
    # the execution trace's prims, a region's members among them
    exec_names = expanded_names(ptt.last_execution_trace(pf))
    assert exec_names.count("exp") == 2


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def _mystery(Sym, TP):
    return Sym("mystery", lambda a: TP(shape=a.shape, dtype=a.dtype, device=a.device),
               id="test.mystery", is_prim=True)


def test_a_prim_without_a_rule_raises_as_in_the_reference():
    x = _u(-1, 1, 3)
    jm, pm = _mystery(JSymbol, JTensorProxy), _mystery(PSymbol, PTensorProxy)
    with pytest.raises(NotImplementedError, match="no VJP rule for prim mystery"):
        tt.jit(lambda a: tt.grad(lambda b: jops.sum(jm(b)))(a))(x)
    with pytest.raises(NotImplementedError, match="no VJP rule for prim mystery"):
        ptt.jit(lambda a: ptt.grad(on_torch(lambda b: pops.sum(pm(b))))(a), device="cpu")(x)


def test_value_and_grad_outside_a_trace_raises():
    x = np.ones(3, np.float32)
    with pytest.raises(RuntimeError, match="must run under tracing"):
        tt.value_and_grad(lambda a: jops.sum(a))(x)
    with pytest.raises(RuntimeError, match=r"must run under tracing \(wrap with "
                                           r"thunder_tpu_torch.jit\)"):
        ptt.value_and_grad(lambda a: torch.sum(a))(torch.ones(3))
