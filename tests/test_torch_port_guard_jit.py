"""The numerics guard on the compiled train step, ``jit(train_step,
donate_argnums=(0, 1), transforms=[NumericsGuardTransform(...)])``, against
the JAX package's ``tt.jit`` of the same step with the reference's
``NumericsGuardTransform`` (Pallas in interpret mode), on the CPU.

- tiny-gqa in float32 on the per-step and the slab optimizer: two healthy
  steps, a ``numerics:grads``-poisoned third, a healthy fourth. The health
  words' counts exactly, the grad norm and the loss within 1e-5 relative;
  params at the training tests' 0.2 lr, the moments within MOMENT_REL of
  each leaf's largest value, ``step`` exactly; the poisoned step leaves each package's
  state bit-identical; the sentinels count the same.
- the port's guarded trace: each optimizer bucket takes its health pass
  and its gated update (read on ``FakeTensor`` stand-ins on ``cuda:0``: one
  ``fused_adamw_health`` and one ``fused_adamw`` launch a step, or the slab
  pair), every parameter and moment written in place; the ``step``
  counter keeps the reference's select.
- ``observe_grads`` with an inline SGD step (no optimizer composite): the
  same health words, and a poisoned step skipped in both.
- a persistent ``numerics:kernel:`` fault on the rms_norm kernel without
  donation is bisected to ``cuda.rms_norm`` (the reference:
  ``pallas.rms_norm``) and quarantined, the step re-run with a finite
  loss; with donation both packages raise ``PersistentNonFinite``.
"""

import math

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import thunder_tpu as tt
from thunder_tpu import ops as jops
from thunder_tpu import optim as joptim
from thunder_tpu.models import llama as jllama
from thunder_tpu.runtime import faults as jfaults
from thunder_tpu.runtime import quarantine as jquarantine
from thunder_tpu.runtime import sentinel as jsentinel
from thunder_tpu.transforms import NumericsGuardTransform as JGuard
from thunder_tpu.transforms import observe_grads as jobserve_grads
import thunder_tpu_torch as ptt
from thunder_tpu_torch import observe
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import AdamW, tree_leaves, tree_map, tree_unflatten
from thunder_tpu_torch.runtime import faults, quarantine, sentinel
from thunder_tpu_torch.testing import claimed_kernels, expanded, with_regions
from thunder_tpu_torch.transforms import NumericsGuardTransform, observe_grads

LR = 1e-3
# moments after three float32 steps, each leaf against its largest value:
# the compiled step's gradients sum in another order than the reference's
# (7.2e-5 measured on tiny-gqa)
MOMENT_REL = 2e-4
WORD_KEYS = ("nonfinite_grads", "nonfinite_loss", "nonfinite_state", "grad_norm", "loss")


def _clean():
    for flt, qu in ((jfaults, jquarantine), (faults, quarantine)):
        flt.clear()
        qu.reset()
    observe.disable()
    observe.reset()


@pytest.fixture(autouse=True)
def _clean_runtime():
    _clean()
    yield
    _clean()


def _word(guard):
    v = guard.sentinel.last_verdict
    return [getattr(v, k) for k in WORD_KEYS]


def _reference_step(jcfg, jopt):
    def train_step(params, opt_state, tokens, targets):
        loss, grads = tt.value_and_grad(
            lambda p: jllama.loss_fn(p, tokens, targets, jcfg))(params)
        return loss, *jopt.update(params, grads, opt_state)

    return train_step


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _guarded_runs(slab: bool, layers: int = 2):
    mp = pytest.MonkeyPatch()
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    try:
        jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
        jparams = jllama.init_params(jcfg, seed=0, scale_layers=layers)
        jopt = joptim.AdamW(lr=LR, slab_persistent=slab)
        jstate = jopt.init(jparams)
        jguard = JGuard()
        jstep = tt.jit(_reference_step(jcfg, jopt), donate_argnums=(0, 1), block_fusion=False,
                       transforms=[jguard])
        tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, 2, 32, seed=0)
        jtok, jtgt = tok.astype(np.int32), tgt.astype(np.int32)
        tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        topt = AdamW(lr=LR, slab_persistent=slab)
        tstate = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        tguard = NumericsGuardTransform()
        tstep = pretrain.jit_train_step(tcfg, topt, transforms=[tguard], device="cpu",
                                        block_fusion=False)
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)
        out = {"jl": [], "tl": [], "jw": [], "tw": [], "poisoned": {}}
        p, s, tp, ts = jparams, jstate, tparams, tstate
        for step in range(1, 5):
            poison = step == 3
            jplan = jfaults.FaultPlan([jfaults.FaultSpec("numerics:grads", at_steps={3})])
            tplan = faults.FaultPlan([faults.FaultSpec("numerics:grads", at_steps={3})])
            jbefore = _np_leaves((p, s))
            tbefore = [t.detach().clone() for t in tree_leaves((tp, ts))]
            with jfaults.active(jplan if poison else None):
                loss, p, s = jstep(p, s, jtok, jtgt)
            with faults.active(tplan if poison else None):
                tloss, tp, ts = tstep(tp, ts, ttok, ttgt)
            if poison:
                out["poisoned"] = {
                    "ref_same": all(np.array_equal(a, b, equal_nan=True)
                                    for a, b in zip(jbefore, _np_leaves((p, s)))),
                    "port_same": all(torch.equal(a, b) for a, b in zip(
                        tbefore, tree_leaves((tp, ts)))),
                    "ref_word": _word(jguard), "port_word": _word(tguard)}
                continue
            out["jl"].append(float(loss))
            out["tl"].append(float(tloss))
            out["jw"].append(_word(jguard))
            out["tw"].append(_word(tguard))
        out.update(jparams=p, jstate=s, tparams=tp, tstate=ts,
                   counts=[(g.sentinel.steps, g.sentinel.healthy_steps,
                            g.sentinel.nonfinite_steps, g.sentinel.skipped_steps)
                           for g in (jguard, tguard)],
                   gated=tguard.gated_buckets)
        return out
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=["per-step", "slab"])
def guarded_runs(request):
    _clean()
    try:
        return request.param, _guarded_runs(slab=request.param == "slab")
    finally:
        _clean()


def test_guarded_compiled_steps_match_reference(guarded_runs):
    _, r = guarded_runs
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5)
    for jw, tw in zip(r["jw"], r["tw"]):
        assert tw[:3] == jw[:3] == [0.0, 0.0, 0.0]
        np.testing.assert_allclose(tw[3:], jw[3:], rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(r["jparams"]), tree_leaves(r["tparams"])):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)
    js, ts = r["jstate"], r["tstate"]
    for key in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(js[key]), tree_leaves(ts[key])):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, atol=MOMENT_REL * np.abs(a).max(), rtol=0)
    assert float(ts["step"]) == float(np.asarray(js["step"])) == 3   # the skip did not count
    assert r["gated"] == 1


def test_guarded_poisoned_compiled_step_leaves_state_bit_identical(guarded_runs):
    _, r = guarded_runs
    pz = r["poisoned"]
    assert pz["ref_same"] and pz["port_same"]
    assert pz["port_word"][:3] == pz["ref_word"][:3]
    assert pz["port_word"][0] > 0 and pz["port_word"][2] == 3 * pz["port_word"][0]
    assert math.isnan(pz["port_word"][3]) and math.isnan(pz["ref_word"][3])
    np.testing.assert_allclose(pz["port_word"][4], pz["ref_word"][4], rtol=1e-5)


def test_guarded_sentinel_counts_match_reference(guarded_runs):
    _, r = guarded_runs
    assert r["counts"][0] == r["counts"][1] == (4, 3, 1, 1)


_FAKE = FakeTensorMode()


def _on_cuda(t):
    return FakeTensor(_FAKE, torch.empty(t.shape, dtype=t.dtype, device="meta"),
                      torch.device("cuda:0"))


@pytest.mark.parametrize("slab", [False, True], ids=["per-step", "slab"])
def test_guarded_trace_gates_each_bucket_on_the_card(slab):
    """The card's claims of the guarded step (``FakeTensor`` stand-ins): the
    step's kernels, one health pass and one gated update a bucket, every
    parameter and moment written in place, the counter selected."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    opt = AdamW(lr=LR, slab_persistent=slab)
    fp, fs = tree_map(_on_cuda, params), tree_map(_on_cuda, opt.init(params))
    tok = _on_cuda(torch.zeros(2, 32, dtype=torch.int64))
    step = pretrain.jit_train_step(cfg, opt, transforms=[NumericsGuardTransform()],
                                   block_fusion=False)
    step.compile(fp, fs, tok, tok)
    trc = ptt.last_traces(step)[-2]
    update = "fused_adamw_slab" if slab else "fused_adamw"
    assert claimed_kernels(trc) == with_regions(trc, {
        "rms_norm": 1, "rms_norm_residual": 4, "sdpa_fwd": 2, "sdpa_bwd": 2, "ce_fwd": 1,
        update: 1, f"{update}_health": 1})
    gated = [b for b in trc.bound_symbols if b.sym.name == f"{update}_gated"]
    assert len(gated) == 1 and all(all(group) for group in gated[0].kwargs["donated"])
    assert [a.name for a in trc.args[-2:]] == ["numerics_poison_grads", "numerics_poison_loss"]
    # the one select left is the step counter's
    assert [b.output.shape for b in expanded(trc) if b.sym.name == "where"
            and b.output.shape == ()] == [()]


def _sgd_runs():
    """An inline SGD step whose grads carry ``observe_grads`` markers, in
    both packages from the same weights: a healthy step, a poisoned one."""
    jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(jcfg, seed=1, scale_layers=1)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, 2, 16, seed=1)

    def jstep(params, tokens, targets):
        loss, grads = tt.value_and_grad(lambda p: jllama.loss_fn(p, tokens, targets, jcfg))(
            params)
        grads = jobserve_grads(grads)
        return loss, jax.tree_util.tree_map(lambda p, g: jops.sub(p, jops.mul(g, LR)),
                                            params, grads)

    def tstep(params, tokens, targets):
        loss, grads = ptt.value_and_grad(lambda p: tllama.loss_fn(p, tokens, targets, tcfg))(
            params)
        grads = observe_grads(grads)
        return loss, tree_unflatten(params, [p - g * LR for p, g in zip(tree_leaves(params),
                                                                        tree_leaves(grads))])

    kw = dict(state_argnums=(0,), state_outputs=(1,))
    jg, tg = JGuard(**kw), NumericsGuardTransform(**kw)
    mp = pytest.MonkeyPatch()
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    try:
        jf = tt.jit(jstep, block_fusion=False, transforms=[jg])
        tf = ptt.jit(tstep, device="cpu", block_fusion=False, transforms=[tg])
        out = []
        p, tp = jparams, tparams
        for step in (1, 2):
            plans = [m.FaultPlan([m.FaultSpec("numerics:grads", at_steps={2})])
                     for m in (jfaults, faults)] if step == 2 else [None, None]
            before = [t.clone() for t in tree_leaves(tp)]
            with jfaults.active(plans[0]):
                _, p = jf(p, tok.astype(np.int32), tgt.astype(np.int32))
            with faults.active(plans[1]):
                _, tp = tf(tp, torch.from_numpy(tok), torch.from_numpy(tgt))
            out.append((_word(jg), _word(tg),
                        all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))))
        return out, p, tp
    finally:
        mp.undo()


def test_observe_grads_with_an_inline_sgd_step():
    out, p, tp = _sgd_runs()
    (jw, tw, _), (jpw, tpw, port_same) = out
    assert tw[:3] == jw[:3] == [0.0, 0.0, 0.0]
    np.testing.assert_allclose(tw[3:], jw[3:], rtol=1e-5)
    assert tpw[:3] == jpw[:3] and tpw[0] > 0 and tpw[2] > 0
    assert port_same   # the poisoned step selected the old parameters
    for a, b in zip(jax.tree_util.tree_leaves(p), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def _kernel_fault_steps(donate: bool, tmp_path):
    """Two steps of each package under a persistent NaN out of the rms_norm
    kernel, its guard escalating at the second non-finite step; the
    port's claims run their routers on the CPU (``interpret``)."""
    jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(jcfg, seed=0, scale_layers=1)
    jopt, topt = joptim.AdamW(lr=LR), AdamW(lr=LR)
    pol = dict(bisect_after=2)
    jguard = JGuard(policy=jsentinel.NumericsPolicy(**pol))
    tguard = NumericsGuardTransform(policy=sentinel.NumericsPolicy(**pol))
    donation = dict(donate_argnums=(0, 1)) if donate else {}
    jstep = tt.jit(_reference_step(jcfg, jopt), block_fusion=False, transforms=[jguard],
                   **donation)
    tstep = pretrain.jit_train_step(tcfg, topt, transforms=[tguard], device="cpu",
                                    block_fusion=False, interpret=True)
    if not donate:
        tstep = ptt.jit(tstep.fn, device="cpu", block_fusion=False, interpret=True,
                        transforms=[tguard])
    tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, 2, 16, seed=0)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tstate = topt.init(tparams)
    jquarantine.configure(str(tmp_path / "ref"))
    quarantine.configure(str(tmp_path / "port"))
    res = {}
    with jfaults.active(jfaults.FaultPlan([jfaults.FaultSpec(
            "numerics:kernel:pallas.rms_norm", transient=False)])):
        p, s = jparams, jopt.init(jparams)
        try:
            l1, p, s = jstep(p, s, tok.astype(np.int32), tgt.astype(np.int32))
            l2, p, s = jstep(p, s, tok.astype(np.int32), tgt.astype(np.int32))
            res["ref"] = (float(l1), float(l2))
        except jsentinel.PersistentNonFinite as e:
            res["ref"] = type(e).__name__
    with faults.active(faults.FaultPlan([faults.FaultSpec(
            "numerics:kernel:cuda.rms_norm", transient=False)])):
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)
        try:
            t1, tp, ts = tstep(tparams, tstate, ttok, ttgt)
            t2, tp, ts = tstep(tp, ts, ttok, ttgt)
            res["port"] = (float(t1), float(t2))
            res["step"] = float(ts["step"])
        except sentinel.PersistentNonFinite as e:
            res["port"] = type(e).__name__
    return res


def test_kernel_fault_bisected_to_its_claim_without_donation(tmp_path, monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    res = _kernel_fault_steps(False, tmp_path)
    for name in ("ref", "port"):
        assert math.isnan(res[name][0]) and math.isfinite(res[name][1])
    jq, tq = jquarantine.get_quarantine(), quarantine.get_quarantine()
    assert jq.ids() == ("pallas.rms_norm",) and tq.ids() == ("cuda.rms_norm",)
    assert tq.reason("cuda.rms_norm").startswith("silent numerics fault")
    assert res["step"] == 1.0   # the skipped step did not count
    np.testing.assert_allclose(res["port"][1], res["ref"][1], rtol=1e-5)


def test_donated_step_escalates_to_persistent_nonfinite(tmp_path, monkeypatch):
    """With ``donate_argnums`` the failing call consumed its inputs: no
    bisection, ``PersistentNonFinite`` in both packages, nothing
    quarantined."""
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    res = _kernel_fault_steps(True, tmp_path)
    assert res["ref"] == res["port"] == "PersistentNonFinite"
    assert quarantine.get_quarantine().ids() == ()
