"""thunder_tpu_torch's Mixtral (``models/mixtral.py``) against the JAX
package's, on the CPU.

The reference's tiny-moe weights (carried across by ``params_from_jax``)
and one numpy batch go through both packages: the reference under
``tt.jit(..., block_fusion=False)`` with its Pallas claims in interpret
mode, the port eagerly. Compared: the forward logits; ``loss_fn``, its
gradients and one AdamW step; the routing (top-k experts, each
assignment's slot, tokens kept per expert) exactly; ``moe_ffn``'s output
and aux loss; ``expert_utilization`` and ``capacity_sweep`` against the
reference's reports; the dropless mode and a capacity small enough to drop
tokens; ``remat=True`` and ``fused_loss_fn(remat=True)``; and the routed
calls of one port step against the Pallas claims of the reference's
train-step trace for each loss and remat variant.

Tolerances (float32 throughout):
- logits, ``moe_ffn``'s output 1e-5 absolute; losses and aux 1e-5
  relative: the same operations summed in another order;
- gradients 1e-6 absolute (the largest are ~0.1-1);
- AdamW after one step: tests/test_torch_port_zoo.py's bounds;
- routing exactly: the top-k experts, the slot of every assignment and
  the per-expert counts are integers (a near-tie of router probabilities
  within float32 noise would flip one; the seeds give none);
- reports: counts, capacity and usage exactly, drop rates and load
  imbalance 1e-6, router loads (rounded to 4 places on both sides) 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import thunder_tpu as tt
from thunder_tpu import ops as jops
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.models import mixtral as jmix
from thunder_tpu_torch.benchmarks import zoo
from thunder_tpu_torch.models import mixtral as tmix

from test_torch_port_zoo import (GRAD_ATOL, LOGIT_ATOL, LOSS_RTOL, as_numpy,
                                 assert_same_tree_shapes, assert_trees_close, claims,
                                 compare_step, jax_batch, port_calls)

BATCH, SEQ = 2, 32
MODEL = "mixtral/tiny-moe"
# the default capacity (cf 2.0: C = 32 for 64 tokens), one that drops
# (cf 0.5: C = 8), and dropless (C = S)
VARIANTS = {"cf2": {}, "cf0.5": {"capacity_factor": 0.5}, "dropless": {"dropless": True}}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")


def _cfgs(**kw):
    return (dataclasses.replace(jmix.CONFIGS["tiny-moe"], **kw),
            dataclasses.replace(tmix.CONFIGS["tiny-moe"], **kw))


def _weights(seed=0):
    jparams = jmix.init_params(jmix.CONFIGS["tiny-moe"], seed=seed)
    return jparams, tmix.params_from_jax(as_numpy(jparams), device="cpu")


def _batch(seed=1):
    return zoo.make_batch(MODEL, BATCH, SEQ, seed=seed, device="cpu")


def _reference_routing(x, router_w, cfg):
    """The reference's routing (``thunder_tpu/models/mixtral.py:119-137``),
    op for op in the reference's ops: ``(topi, flat_pos, counts)``."""
    S = x.shape[0]
    E, k = router_w.shape[0], cfg.top_k
    C = tmix.capacity(cfg, S)
    probs = jops.softmax(jops.linear(jops.convert_element_type(x, jdtypes.float32),
                                     jops.convert_element_type(router_w, jdtypes.float32)), -1)
    _topv, topi = jops.topk(probs, k, -1)
    counts = jops.zeros((E,), dtype=jdtypes.float32)
    flat_pos = []
    for j in range(k):
        m = jops.convert_element_type(jops.one_hot(topi[:, j], E), jdtypes.float32)
        pos = jops.add(jops.sub(jops.cumsum(m, 0), m), jops.expand_to(counts, m.shape))
        keep = jops.mul(m, jops.convert_element_type(jops.lt(pos, float(C)), jdtypes.float32))
        counts = jops.add(counts, jops.sum(keep, 0))
        pos_j = jops.sum(jops.mul(pos, m), -1)
        kept_j = jops.gt(jops.sum(keep, -1), 0.0)
        e_j = jops.convert_element_type(topi[:, j], jdtypes.int32)
        fp = jops.add(jops.mul(e_j, C), jops.convert_element_type(pos_j, jdtypes.int32))
        flat_pos.append(jops.where(kept_j, fp, jops.full((S,), E * C, dtype=jdtypes.int32)))
    return topi, jops.stack(flat_pos, 0), counts


def _moe_inputs(seed=2, S=64):
    rng = np.random.RandomState(seed)
    jparams, tparams = _weights(seed)
    x = rng.randn(S, 64).astype(np.float32)
    return x, jparams["layers"][0], tparams["layers"][0]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_routing_is_identical(variant, interpret):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    x, jl, tl = _moe_inputs()
    topi, flat, counts = tt.jit(lambda a, r: _reference_routing(a, r, jcfg))(x, jl["router"])
    _probs, _topv, ttopi, tflat, tcounts, C = tmix.route(torch.from_numpy(x), tl["router"], tcfg)
    assert C == tmix.capacity(tcfg, 64) == {"cf2": 32, "cf0.5": 8, "dropless": 64}[variant]
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(topi))
    np.testing.assert_array_equal(torch.stack(tflat).numpy(), np.asarray(flat))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    dropped = int((torch.stack(tflat) == 8 * C).sum())
    assert (dropped > 0) == (variant == "cf0.5")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_ffn_output_aux_and_metrics_match_reference(variant, interpret):
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    x, jl, tl = _moe_inputs(seed=3)
    keys = ("router", "we_gate", "we_up", "we_down")
    out, aux, m = tt.jit(lambda a, *w: jmix.moe_ffn(a, *w, jcfg, return_metrics=True))(
        x, *(jl[k] for k in keys))
    with torch.no_grad():
        tout, taux, tm = tmix.moe_ffn(torch.from_numpy(x), *(tl[k] for k in keys), tcfg,
                                      return_metrics=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=LOGIT_ATOL, rtol=0)
    assert abs(float(taux) - float(aux)) <= LOSS_RTOL * abs(float(aux))
    np.testing.assert_array_equal(tm["tokens_per_expert"].numpy(),
                                  np.asarray(m["tokens_per_expert"]))
    assert abs(float(tm["drop_rate"]) - float(np.asarray(m["drop_rate"]))) <= 1e-6
    np.testing.assert_allclose(tm["router_load"].numpy(), np.asarray(m["router_load"]),
                               atol=1e-6, rtol=0)
    assert tm["capacity"] == int(m["capacity"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_loss_and_train_step_match_reference(variant, monkeypatch):
    """The grad-free logits, then ``loss_fn`` (cross-entropy plus the
    summed aux), its gradients and one AdamW step, and the port's routed
    calls against the reference trace's claims."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jparams, tparams = _weights()
    batch = _batch()
    compare_step(MODEL, lambda p, a, b: jmix.loss_fn(p, a, b, jcfg), jparams, tparams, batch,
                 monkeypatch, jit_forward=lambda p, a: jmix.forward(p, a, jcfg),
                 tforward=lambda p, a: tmix.forward(p, a, tcfg),
                 tloss=lambda p, a, b: tmix.loss_fn(p, a, b, tcfg))


LOSS_VARIANTS = {"remat": ("naive", True), "fused": ("fused", False),
                 "fused-remat": ("fused", True)}


@pytest.mark.parametrize("variant", list(LOSS_VARIANTS))
def test_remat_and_fused_loss_match_reference(variant, monkeypatch):
    """``loss_fn(remat=True)``, ``fused_loss_fn`` and
    ``fused_loss_fn(remat=True)``: loss and gradients against the
    reference's, and the routed calls of one port step against the claims
    of its trace (under remat: ``rms_norm`` in each checkpointed forward,
    ``rms_norm_residual`` in its recompute; the fused loss claims no
    ``ce_fwd``)."""
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    loss, remat = LOSS_VARIANTS[variant]
    jcfg, tcfg = _cfgs()
    jparams, tparams = _weights(seed=4)
    batch = _batch(seed=5)
    jfn = jmix.fused_loss_fn if loss == "fused" else jmix.loss_fn
    jf = tt.jit(tt.value_and_grad(lambda p, a, b: jfn(p, a, b, jcfg, remat=remat)),
                block_fusion=False)
    jl, jg = jf(jparams, *jax_batch(batch))
    want = claims(tt.last_execution_trace(jf))
    def port_loss(p):
        return zoo.loss_of(MODEL, p, batch, loss=loss, remat=remat)

    tl, tg, _ = zoo.value_and_grad(port_loss, tparams)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_trees_close(tg, jg, GRAD_ATOL)
    expect = zoo.expected_launches(MODEL, loss=loss, remat=remat)
    assert want == {k: n for k, n in expect.items() if k != "fused_adamw"}
    got = port_calls(lambda: zoo.value_and_grad(port_loss, tparams))
    assert got == want


def test_expert_utilization_and_capacity_sweep_match_reference(interpret):
    jparams, tparams = _weights(seed=6)
    tok, _ = _batch(seed=7)
    jtok = tok.numpy().astype(np.int32)
    jcfg, tcfg = _cfgs()
    want, got = jmix.expert_utilization(jparams, jtok, jcfg), \
        tmix.expert_utilization(tparams, tok, tcfg)
    assert len(got) == len(want) == jcfg.n_layers
    for g, w in zip(got, want):
        assert g["tokens_per_expert"] == w["tokens_per_expert"]
        assert (g["capacity"], g["expert_usage"]) == (w["capacity"], w["expert_usage"])
        for key in ("drop_rate", "load_imbalance"):
            assert abs(g[key] - w[key]) <= 1e-6
        np.testing.assert_allclose(g["router_load"], w["router_load"], atol=1e-4, rtol=0)
    factors = (0.25, 1.0, 2.0)
    want_sweep = jmix.capacity_sweep(jparams, jtok, jcfg, factors=factors)
    got_sweep = tmix.capacity_sweep(tparams, tok, tcfg, factors=factors)
    assert list(got_sweep) == list(want_sweep) == [0.25, 1.0, 2.0, "dropless"]
    for key in want_sweep:
        assert abs(got_sweep[key] - want_sweep[key]) <= 1e-6
    assert got_sweep[0.25] > 0.0 and got_sweep["dropless"] == 0.0


def test_init_params_match_reference():
    """The port's own ``init_params`` has the reference's tree, shapes,
    dtypes and scale, and the expert-parallel patterns are the reference's."""
    tcfg = tmix.CONFIGS["tiny-moe"]
    t = tmix.init_params(tcfg, seed=0, device="cpu")
    assert_same_tree_shapes(t, jmix.init_params(jmix.CONFIGS["tiny-moe"]))
    w = t["layers"][0]["we_down"]          # N(0, 1/I)
    assert abs(float(w.std()) * tcfg.intermediate_size ** 0.5 - 1.0) < 0.05
    assert tmix.EP_PATTERNS == jmix.EP_PATTERNS


def test_expert_product_saves_no_float32_weight_copy():
    """The expert products keep the weights in the model dtype for the
    backward: a bf16 layer's saved tensors hold no float32 tensor of an
    expert weight's shape, and the gradients equal those of the plain
    float32 product."""
    torch.manual_seed(0)
    a = torch.randn(2, 5, 16, requires_grad=True)
    w = torch.randn(2, 12, 16).to(torch.bfloat16).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tmix._expert_product(a, w)
    assert not any(t.dtype == torch.float32 and t.shape == w.shape for t in saved)
    g = torch.randn_like(out)
    out.backward(g)
    a2, w2 = a.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    torch.bmm(a2, w2.float().transpose(1, 2)).backward(g)
    torch.testing.assert_close(a.grad, a2.grad, atol=1e-6, rtol=0)
    assert w.grad.dtype == torch.bfloat16
    torch.testing.assert_close(w.grad, w2.grad, atol=0, rtol=0)


def test_force_einsum_raises_naming_the_roadmap_item(monkeypatch):
    monkeypatch.setenv("MIXTRAL_FORCE_EINSUM", "1")
    _, tparams = _weights()
    with pytest.raises(NotImplementedError, match="A.2"):
        tmix.forward(tparams, _batch()[0], tmix.CONFIGS["tiny-moe"])
