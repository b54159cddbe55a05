"""The chunked loss on the trace: ``nn.fused_linear_cross_entropy`` and its
VJP (``nn.fused_linear_cross_entropy_bwd``, the reference's ``_flce_vjp``)
under ``thunder_tpu_torch.jit``, against the JAX package's op and rule
under ``tt.jit``, on the CPU.

- the loss, the lse and the gradients in h and w of ``loss + lse_weight *
  sum(lse)`` (so the lse's cotangent is exercised too) under
  ``value_and_grad``, at 1e-5: V not a multiple of the chunk, the default
  chunk, and ``ignore_index`` rows (whose gradient rows are 0);
- each packages' composite: the port's traced step records the forward and
  the backward composite whole, run by the torch executor, and its
  decomposition (the reference's ops, run op by op on the CPU) gives the
  same values;
- ``jit(value_and_grad(llama.fused_loss_fn))`` on tiny-gqa equals the
  eager fused loss and its gradients, and a compiled step with it trains.
"""

import numpy as np
import pytest
import torch

import thunder_tpu as tt
from thunder_tpu import ops as jops
from thunder_tpu.ops import nn as jnn
import thunder_tpu_torch as ptt
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.ops import composites as cnn
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.optim import AdamW, tree_leaves
from thunder_tpu_torch.torch import on_torch


def _inputs(seed, N=24, D=16, V=100):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(V, D) / np.sqrt(D)).astype(np.float32)
    target = rng.randint(0, V, size=N).astype(np.int64)
    target[[2, 9, 10]] = -100
    return h, w, target


def _reference(h, w, target, chunk, lse_weight):
    def jfn(hw):
        loss, lse = jnn.fused_linear_cross_entropy(hw[0], hw[1], target.astype(np.int32),
                                                   chunk=chunk)
        return jops.add(loss, jops.mul(jops.sum(lse), lse_weight))

    val, grads = tt.jit(tt.value_and_grad(jfn), executors=["xla"])((h, w))
    return float(val), np.asarray(grads[0]), np.asarray(grads[1])


def _port(h, w, target, chunk, lse_weight):
    """The port's traced value and grads, and the execution trace."""
    def fn(hw, t):
        loss, lse = tnn.fused_linear_cross_entropy(hw[0], hw[1], t, chunk=chunk)
        return loss + lse.sum() * lse_weight

    jf = ptt.jit(lambda hw, t: ptt.value_and_grad(lambda q: fn(q, t))(hw), device="cpu")
    val, grads = jf((torch.from_numpy(h), torch.from_numpy(w)), torch.from_numpy(target))
    return float(val), grads[0].numpy(), grads[1].numpy(), ptt.last_traces(jf)[-1]


@pytest.mark.parametrize("lse_weight", [0.0, 0.25], ids=["loss", "loss+lse"])
@pytest.mark.parametrize("chunk", [32, None], ids=["chunk32", "default"])
def test_traced_flce_and_its_vjp_match_reference(chunk, lse_weight):
    h, w, target = _inputs(5)
    want = _reference(h, w, target, chunk, lse_weight)
    got = _port(h, w, target, chunk, lse_weight)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, r in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0)
    if not lse_weight:
        assert np.abs(got[1][9]).max() == 0.0   # an ignored row gets no gradient
    names = [b.sym.name for b in got[3].bound_symbols]
    assert names.count("fused_linear_cross_entropy") == 1
    assert names.count("fused_linear_cross_entropy_bwd") == 1


@pytest.mark.parametrize("chunk", [32, None], ids=["chunk32", "default"])
def test_flce_decomposition_matches_the_whole_implementation(chunk):
    """The reference's ops (the composites' decompositions, differentiated
    by the VJP rule's backward composite) against the chunked loops the
    torch executor runs whole."""
    h, w, target = _inputs(7, V=75)
    whole = _port(h, w, target, chunk, 0.25)
    fwd = cnn.fused_linear_cross_entropy
    bwd = cnn.fused_linear_cross_entropy_bwd
    th, tw, tt_ = (torch.from_numpy(a) for a in (h, w, target))

    def plain(h_, w_, t_):
        loss, lse = on_torch(fwd.meta)(h_, w_, t_, chunk=chunk)
        dh, dw = on_torch(bwd.meta)(torch.ones(()), torch.full(lse.shape, 0.25), h_, w_, t_,
                                    lse, chunk=chunk)
        return loss + lse.sum() * 0.25, dh, dw

    val, dh, dw = ptt.jit(plain, device="cpu")(th, tw, tt_)
    np.testing.assert_allclose(float(val), whole[0], rtol=1e-5)
    np.testing.assert_allclose(dh.numpy(), whole[1], atol=1e-5 * np.abs(whole[1]).max(), rtol=0)
    np.testing.assert_allclose(dw.numpy(), whole[2], atol=1e-5 * np.abs(whole[2]).max(), rtol=0)


def test_fused_loss_fn_traces_and_trains():
    """``jit(value_and_grad(llama.fused_loss_fn))`` on tiny-gqa: the eager
    fused loss and gradients; the compiled bench step with it takes three
    steps and the loss falls."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=3, device="cpu", n_layers=2)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 32, 4))
    jf = ptt.jit(lambda p, a, b: ptt.value_and_grad(
        lambda q: tllama.fused_loss_fn(q, a, b, cfg))(p), device="cpu")
    loss, grads = jf(params, tok, tgt)
    want_loss, want = pretrain.loss_and_grads(params, tok, tgt, cfg, loss="fused")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for g, r in zip(tree_leaves(grads), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6, rtol=0)
    for p in tree_leaves(params):
        p.requires_grad_(False)
    opt = AdamW(lr=1e-3)
    step = pretrain.jit_train_step(cfg, opt, loss="fused", device="cpu")
    state = opt.init(params)
    losses = []
    for _ in range(3):
        value, params, state = step(params, state, tok, tgt)
        losses.append(float(value))
    assert losses[-1] < losses[0] and float(state["step"]) == 3
