"""The CUDA wrappers' input transforms against the JAX reference.

On a card, ``thunder_tpu_torch.executors.cudaex``'s wrappers take inputs
that the reference computes through its decomposition (its Pallas checkers
refuse them) by transforming them first: a 16-bit attention head dim off
the multiples of 16 is zero-padded (``cudaex.sdpa_head_dim``,
``cudaex.pad_last``) and the results sliced back, at the true head dim's
scale; mixed dtypes are promoted (``cudaex.promote``) where the
decomposition computes in the promoted dtype; ``linear_act``'s tile path
pads K to 16 bytes' worth (``cudaex.tile_k``); a strided or unaligned
read-only operand is made dense (``cudaex._dense``). Each transform is a
plain function: these tests apply it on the CPU, run the plain version on
the result, and hold that against the JAX function on the original inputs,
made with numpy. The kernels are held against the same plain versions on
the card (``tests/test_torch_port_cuda.py``).

Tolerances: float32 1e-5 (attention, the norms: the same operations in
another summation order) and 1e-4 (``linear_act``: BLAS orders a K = 518
sum in blocks); a norm's bf16 or fp16 result within one bf16 rounding step
(2**-7 relative, plus 1e-3 near zero), where an f32 statistic that differs
in its last bits can move a rounding by one step; bf16 ``linear_act`` 2e-2,
as the card tests hold it (the reference's bf16 linear rounds the product
before its activation, the kernel's contract once after it), and the padded
product equal to the unpadded one (zero columns add exact zeros).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
from thunder_tpu.ops import nn as jnn
from thunder_tpu.ops import optim as joptim
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.ops import optim as toptim_ops

EPS = 1e-5
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _xla(fn, *args):
    """The JAX decomposition of ``fn``, traced with no kernel executor."""
    out = tt.jit(fn, executors=["xla"])(*args)
    if isinstance(out, tuple):
        return tuple(np.asarray(jnp.asarray(o, jnp.float32)) for o in out)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _pair(a: np.ndarray, dtype=torch.float32):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    return torch.from_numpy(a).to(dtype), jnp.asarray(a).astype(_JDT[dtype])


def _close(got: torch.Tensor, want: np.ndarray, tol) -> None:
    got = got.float().numpy()
    if tol == "step":   # one rounding step of a 16-bit result
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-3)
    else:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [8, 24, 200])
def test_head_dim_padding_matches_reference(hd, causal):
    """tiny-tp's hd 8 and two others off the multiples of 16: q, k, v (and
    out, g) zero-padded to ``sdpa_head_dim``'s width, the plain forward and
    backward at the true head dim's scale, the results sliced back; the
    padded columns come out zero. In float32, where the rule's padding is
    the 16-bit kernels' (it is the transform under test)."""
    rng = np.random.RandomState(hd)
    B, H, T = 1, 2, 37
    q, k, v, g = (rng.randn(B, H, T, hd).astype(np.float32) for _ in range(4))
    hdp = cudaex.sdpa_head_dim(torch.bfloat16, hd)
    assert hdp % 16 == 0 and hd < hdp < hd + 16
    assert cudaex.sdpa_head_dim(torch.float32, hd) == hd
    scale = 1.0 / math.sqrt(hd)
    tq, tk, tv, tg = (cudaex.pad_last(torch.from_numpy(a), hdp) for a in (q, k, v, g))
    out_p, lse = tnn.sdpa_fwd_plain(tq, tk, tv, causal, scale)
    grads_p = tnn.sdpa_bwd_plain(tg, tq, tk, tv, out_p, lse, causal, scale)
    want_out, want_lse = _xla(lambda a, b, c: jnn.sdpa_fwd(a, b, c, causal), q, k, v)
    want_grads = _xla(lambda *a: jnn.sdpa_bwd(*a, causal), g, q, k, v, want_out, want_lse)
    _close(out_p[..., :hd], want_out, 1e-5)
    _close(lse, want_lse, 1e-5)
    for got, want in zip(grads_p, want_grads):
        _close(got[..., :hd], want, 1e-5)
    for t in (out_p, *grads_p):
        assert float(t[..., hd:].abs().max()) == 0.0


@pytest.mark.parametrize("x_dt,w_dt", [(torch.bfloat16, torch.float32),
                                       (torch.float32, torch.bfloat16),
                                       (torch.float16, torch.float16),
                                       (torch.bfloat16, torch.float16)],
                         ids=["bf16-w_f32", "f32-w_bf16", "f16", "bf16-w_f16"])
def test_norm_weight_dtype_matches_reference(x_dt, w_dt):
    """A weight dtype unlike x's: the norm kernels take it as a type of its
    own (no promotion of x), and the plain version they repeat gives the
    reference's result, in the promoted dtype."""
    rng = np.random.RandomState(2)
    x = rng.randn(6, 96).astype(np.float32)
    w = (rng.rand(96) + 0.5).astype(np.float32)
    (tx, jx), (tw, jw) = _pair(x, x_dt), _pair(w, w_dt)
    got = tnn.rms_norm_plain(tx, tw, EPS)
    assert got.dtype == torch.promote_types(x_dt, w_dt)
    want = _xla(lambda a, b: jnn.rms_norm(a, b, eps=EPS), jx, jw)
    _close(got, want, 1e-5 if got.dtype == torch.float32 else "step")


def test_residual_promotion_matches_reference():
    """rms_norm_residual with a bf16 residual and a float32 x: the wrapper
    promotes both to float32 (``cudaex.promote``), as the reference's add
    does, and runs the float32 kernel."""
    rng = np.random.RandomState(3)
    r, x = rng.randn(4, 64).astype(np.float32), rng.randn(4, 64).astype(np.float32)
    w = (rng.rand(64) + 0.5).astype(np.float32)
    (tr, jr), (tx, jx), (tw, jw) = _pair(r, torch.bfloat16), _pair(x), _pair(w)
    pr, px_ = cudaex.promote(tr, tx)
    assert pr.dtype == px_.dtype == torch.float32
    h, y = tnn.rms_norm_residual_plain(pr, px_, tw, EPS)
    wh, wy = _xla(lambda a, b, c: jnn.rms_norm_residual(a, b, c, eps=EPS), jr, jx, jw)
    _close(h, wh, 1e-5)
    _close(y, wy, 1e-5)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_linear_act_promotion_matches_reference(bias):
    """linear_act with bf16 activations and a float32 weight (and bias): the
    wrapper promotes all three to float32, the reference's linear promotes
    the same way, and the result is float32."""
    rng = np.random.RandomState(4)
    a, w = rng.randn(5, 64).astype(np.float32), (rng.randn(48, 64) / 8).astype(np.float32)
    b = rng.randn(48).astype(np.float32) if bias else None
    (ta, ja), (tw, jw) = _pair(a, torch.bfloat16), _pair(w)
    tb, jb = _pair(b) if bias else (None, None)
    pa, pw, pb = cudaex.promote(ta, tw, tb)
    assert pa.dtype == pw.dtype == torch.float32
    got = tnn.linear_act_plain(pa, pw, pb, "silu")
    assert tnn.linear_act_plain(ta, tw, tb, "silu").dtype == torch.float32
    if bias:
        want = _xla(lambda x, y, z: jnn.linear_act(x, y, z, act="silu"), ja, jw, jb)
    else:
        want = _xla(lambda x, y: jnn.linear_act(x, y, None, act="silu"), ja, jw)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [8, 100])
def test_linear_act_k_pad_matches_reference(dtype, M):
    """K = 518, off 16 bytes' worth in either dtype: the tile path's A and
    W zero-padded along K to ``tile_k`` add nothing to the product."""
    rng = np.random.RandomState(5)
    K = 518
    a, w = rng.randn(M, K).astype(np.float32), (rng.randn(64, K) / 16).astype(np.float32)
    (ta, ja), (tw, jw) = _pair(a, dtype), _pair(w, dtype)
    Kp = cudaex.tile_k(dtype, K)
    assert Kp == 520 and cudaex.tile_k(dtype, Kp) == Kp
    pa, pw = cudaex.pad_last(ta, Kp), cudaex.pad_last(tw, Kp)
    assert float(pa[:, K:].abs().max()) == float(pw[:, K:].abs().max()) == 0.0
    got = tnn.linear_act_plain(pa, pw, None, "gelu")
    torch.testing.assert_close(got, tnn.linear_act_plain(ta, tw, None, "gelu"), atol=1e-6,
                               rtol=0)
    want = _xla(lambda x, y: jnn.linear_act(x, y, None, act="gelu"), ja, jw)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2e-2)


def test_dense_operands_match_reference():
    """A strided read-only operand (a transposed view) and an unaligned one
    (a view one element in) made dense: contiguous, 16-byte aligned, the
    same values, and the plain norm on them equals the reference's."""
    rng = np.random.RandomState(6)
    x = rng.randn(96, 6).astype(np.float32)
    w = (rng.rand(97) + 0.5).astype(np.float32)
    xs = torch.from_numpy(x).t()
    wu = torch.from_numpy(w)[1:]
    assert not xs.is_contiguous() and wu.data_ptr() % 16
    dx, dw = cudaex._dense(xs), cudaex._dense(wu)
    assert dx.is_contiguous() and dx.data_ptr() % 16 == 0 and dw.data_ptr() % 16 == 0
    assert torch.equal(dx, xs) and torch.equal(dw, wu)
    want = _xla(lambda a, b: jnn.rms_norm(a, b, eps=EPS), np.ascontiguousarray(x.T), w[1:])
    _close(tnn.rms_norm_plain(dx, dw, EPS), want, 1e-5)


def test_adamw_grad_dtype_matches_reference():
    """Float32 params with bf16 grads: the kernel reads g in its own dtype
    (a template parameter), as the plain step and the reference's do."""
    rng = np.random.RandomState(7)
    p, g = rng.randn(300).astype(np.float32), rng.randn(300).astype(np.float32)
    m, v = (rng.rand(300) * 0.1).astype(np.float32), (rng.rand(300) * 0.1).astype(np.float32)
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    bc1, bc2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3
    (tg, jg) = _pair(g, torch.bfloat16)
    got = toptim_ops.adamw_step_plain(torch.from_numpy(p), tg, torch.from_numpy(m),
                                      torch.from_numpy(v), bc1, bc2, **hyper)
    want = _xla(lambda a, b, c, d: joptim.adamw_step(a, b, c, d, bc1, bc2, **hyper), p, jg, m, v)
    for a, b in zip(got, want):
        _close(a, b, 1e-6)
