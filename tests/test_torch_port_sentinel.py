"""thunder_tpu_torch's numerics sentinel and guarded train step against the
JAX package's, on the CPU.

The sentinel: one sequence of health words — a warm-up, a loss spike
(``LossSpike``), a rewind (``notify_rewind``) and its replay, a spike past
the rewind budget, skipped non-finite steps, probes, an infinite grad norm
and a run of non-finite steps that escalates to bisection — fed to both
packages' ``NumericsSentinel``: verdicts, counters, raised anomalies and the
loss EWMA equal to 1e-12, and the same registry counters. The bisection
search (``attribute_offenders``, ``bisect_offender``) on synthetic probes:
the same offenders after the same number of probes.

The guarded step: the reference's ``tt.jit(train_step,
transforms=[NumericsGuardTransform()])`` (Pallas in interpret mode) against
the port's ``pretrain.train_step(..., guard=NumericsGuard())`` on tiny-gqa
in float32, on the per-step and the slab path:

- healthy steps at ``test_torch_port_training.py``'s tolerances (loss 1e-5
  relative, parameters 0.2 lr, m 1e-6 and v 1e-9 absolute) and their health
  words within 1e-5 relative (the counts exactly: 0);
- a ``numerics:grads``-poisoned step leaves each package's state
  bit-identical to before it, and both count the same non-finite grads and
  state elements;
- a persistent ``numerics:kernel:`` fault on the rms_norm kernel is
  bisected to the same kernel in each package (``cuda.rms_norm`` ↔
  ``pallas.rms_norm``), which joins the quarantine; the step then runs on
  the fallback with a finite loss.
"""

import math

import jax
import numpy as np
import pytest
import torch

import thunder_tpu as tt
from thunder_tpu import observe as jobserve
from thunder_tpu import optim as joptim
from thunder_tpu.models import llama as jllama
from thunder_tpu.runtime import faults as jfaults
from thunder_tpu.runtime import quarantine as jquarantine
from thunder_tpu.runtime import sentinel as jsentinel
from thunder_tpu.transforms import NumericsGuardTransform
from thunder_tpu_torch import observe
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import AdamW, tree_leaves
from thunder_tpu_torch.runtime import faults, quarantine, sentinel
from thunder_tpu_torch.transforms import NumericsGuard

LR = 1e-3
PKGS = {"ref": (jobserve, jfaults, jquarantine, jsentinel),
        "port": (observe, faults, quarantine, sentinel)}


def _clean():
    for obs, flt, qu, _ in PKGS.values():
        flt.clear()
        qu.reset()
        obs.disable()
        obs.reset()


@pytest.fixture(autouse=True)
def _clean_runtime():
    _clean()
    yield
    _clean()


# ---------------------------------------------------------------------------
# the sentinel's ladder
# ---------------------------------------------------------------------------

def _word(loss, nf=(0.0, 0.0, 0.0), norm=1.0):
    return [nf[0], nf[1], nf[2], norm, loss]


WORDS = ([_word(x) for x in (2.0, 1.9, 1.95, 1.85, 1.9, 1.87)]
         + [_word(10.0)]                                   # spike: rewind
         + ["rewind 2", _word(1.9), _word(1.88)]           # replayed, judged, not refolded
         + [_word(12.0)]                                   # past the budget: accepted
         + [_word(1.0, (5.0, 0.0, 15.0), float("nan")), _word(1.86)]   # one skip
         + ["probe", _word(float("nan"), (0.0, 1.0, 0.0))]
         + [_word(1.85, norm=float("inf"))]                # kept out of the histogram
         + [_word(1.0, (3.0, 0.0, 0.0))] * 3)              # the third escalates


def _sentinel_sequence(obs, sent_mod):
    obs.enable(clear=True)
    pol = sent_mod.NumericsPolicy(spike_zscore=4.0, ewma_alpha=0.1, warmup_steps=3,
                                  max_rewinds=1, bisect_after=3)
    s = sent_mod.NumericsSentinel(policy=pol)
    trail, probe = [], False
    for w in WORDS:
        if w == "probe":
            probe = True
            continue
        if isinstance(w, str):
            s.notify_rewind(int(w.split()[1]))
            continue
        raised = None
        try:
            if probe:
                with s.probing():
                    s.ingest(w)
                probe = False
            else:
                s.ingest(w)
        except sent_mod.NumericsAnomaly as e:
            raised = type(e).__name__
        v = s.last_verdict.to_dict()
        trail.append((raised, v, s.steps, s.healthy_steps, s.nonfinite_steps, s.skipped_steps,
                      s.consecutive_nonfinite, s.rewind_raises, s.spikes_accepted,
                      s.ewma_mean, s.ewma_var))
    snap = obs.snapshot()
    obs.disable()
    return trail, snap["counters"], snap["histograms"]


def _close(a, b, rtol=1e-12):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, rtol) for x, y in zip(a, b))
    return a == b


def test_sentinel_ladder_matches_reference():
    got = {name: _sentinel_sequence(obs, sm) for name, (obs, _, _, sm) in PKGS.items()}
    assert _close(got["port"], got["ref"])
    trail = got["port"][0]
    raised = [t[0] for t in trail]
    assert raised.count("LossSpike") == 1 and raised[-1] == "SilentNumericsFault"
    assert trail[10][8] == 1                     # the second spike was accepted
    assert got["port"][1]["runtime.nonfinite_steps"] == 4
    # every healthy, non-probe step with a finite norm, the spikes included
    assert got["port"][2]["runtime.grad_norm"]["count"] == 11


def test_bisection_search_matches_reference():
    cands = [f"k{i}" for i in range(9)]
    cases = [("k3",), ("k0",), ("k8",), ("k2", "k6"), ()]
    out = {}
    for name, (obs, _, _, sm) in PKGS.items():
        obs.enable(clear=True)
        res = []
        for bad in cases:
            calls = []

            def probe(disabled, bad=bad, calls=calls):
                calls.append(sorted(disabled))
                return all(b in disabled for b in bad) and bool(bad)

            res.append((sm.attribute_offenders(cands, probe), len(calls),
                        sm.bisect_offender(cands, probe)))
        out[name] = (res, obs.snapshot()["counters"])
        obs.disable()
    assert out["port"] == out["ref"]
    assert out["port"][0][3][0] == ["k2", "k6"] and out["port"][0][4][0] == []


def test_claimed_kernel_ids_are_the_routed_claims():
    assert sentinel.claimed_kernel_ids({"cuda.b": 2, "cuda.a": 1, "cuda.c": 0}) == \
        ["cuda.a", "cuda.b"]


def test_replay_bundle_holds_the_verdict_and_inputs(tmp_path):
    """The bundle's meta and inputs (16-bit tensors as float32). Its
    ``replay_bundle`` event names the anomaly ``anomaly=``: the reference's
    ``kind=`` collides with the event's own name and raises after the files
    are written (ROADMAP C, known differences)."""
    v = sentinel.Verdict(_word(float("nan"), (0.0, 1.0, 0.0)), step=7)
    observe.enable(clear=True)
    path = sentinel.dump_replay_bundle(str(tmp_path), kind="skip", verdict=v, fn_name="step",
                                       inputs=(torch.ones(2, dtype=torch.bfloat16),
                                               torch.arange(3)))
    assert observe.snapshot()["events"][-1]["anomaly"] == "skip"
    import json

    meta = json.load(open(f"{path}/meta.json"))
    arrays = np.load(f"{path}/inputs.npz")
    assert meta["kind"] == "skip" and meta["verdict"]["step"] == 7 and not meta["verdict"]["healthy"]
    assert arrays["arg0"].dtype == np.float32 and arrays["arg1"].tolist() == [0, 1, 2]


# ---------------------------------------------------------------------------
# the guarded step, port vs reference
# ---------------------------------------------------------------------------

def _reference_step(jcfg, jopt):
    def train_step(params, opt_state, tokens, targets):
        loss, grads = tt.value_and_grad(
            lambda p: jllama.loss_fn(p, tokens, targets, jcfg))(params)
        return loss, *jopt.update(params, grads, opt_state)

    return train_step


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _guarded_runs(slab: bool, layers: int = 2):
    """Both packages guarded from the same weights: two healthy steps, a
    ``numerics:grads``-poisoned third step, a healthy fourth."""
    mp = pytest.MonkeyPatch()
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    try:
        jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
        jparams = jllama.init_params(jcfg, seed=0, scale_layers=layers)
        jopt = joptim.AdamW(lr=LR, slab_persistent=slab)
        jstate = jopt.init(jparams)
        jguard = NumericsGuardTransform()
        jstep = tt.jit(_reference_step(jcfg, jopt), block_fusion=False, transforms=[jguard])
        tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, 2, 32, seed=0)
        jtok, jtgt = tok.astype(np.int32), tgt.astype(np.int32)
        tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        topt = AdamW(lr=LR, slab_persistent=slab)
        tstate = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)
        tguard = NumericsGuard()
        out = {"jl": [], "tl": [], "jw": [], "tw": [], "poisoned": {}}
        p, s = jparams, jstate
        for step in range(1, 5):
            poison = step == 3
            jplan = jfaults.FaultPlan([jfaults.FaultSpec("numerics:grads", at_steps={3})])
            tplan = faults.FaultPlan([faults.FaultSpec("numerics:grads", at_steps={3})])
            jbefore = _np_leaves((p, s))
            tbefore = [t.detach().clone() for t in tree_leaves(tparams) + tree_leaves(tstate)]
            with jfaults.active(jplan if poison else None):
                loss, p, s = jstep(p, s, jtok, jtgt)
            with faults.active(tplan if poison else None):
                tloss = pretrain.train_step(tparams, topt, tstate, ttok, ttgt, tcfg,
                                            guard=tguard)
            jword = [getattr(jguard.sentinel.last_verdict, k) for k in (
                "nonfinite_grads", "nonfinite_loss", "nonfinite_state", "grad_norm", "loss")]
            if poison:
                out["poisoned"] = {
                    "ref_same": all(np.array_equal(a, b, equal_nan=True)
                                    for a, b in zip(jbefore, _np_leaves((p, s)))),
                    "port_same": all(torch.equal(a, b) for a, b in zip(
                        tbefore, tree_leaves(tparams) + tree_leaves(tstate))),
                    "ref_word": jword, "port_word": list(tguard.last_health),
                    "ref_counts": (jguard.sentinel.nonfinite_steps,
                                   jguard.sentinel.skipped_steps),
                    "port_counts": (tguard.sentinel.nonfinite_steps,
                                    tguard.sentinel.skipped_steps)}
                continue
            out["jl"].append(float(loss))
            out["tl"].append(float(tloss))
            out["jw"].append(jword)
            out["tw"].append(list(tguard.last_health))
        out.update(jparams=p, jstate=s, tparams=tparams, tstate=tstate)
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


def test_guarded_healthy_steps_match_reference(guarded_runs):
    _, r = guarded_runs
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5)
    for jw, tw in zip(r["jw"], r["tw"]):
        assert tw[:3] == jw[:3] == [0.0, 0.0, 0.0]
        np.testing.assert_allclose(tw[3:], jw[3:], rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(r["jparams"]), tree_leaves(r["tparams"])):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)
    js, ts = r["jstate"], r["tstate"]
    for key, tol in (("m", 1e-6), ("v", 1e-9)):
        for a, b in zip(jax.tree_util.tree_leaves(js[key]), tree_leaves(ts[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol, rtol=0)
    # the poisoned step did not advance either counter
    assert float(ts["step"]) == float(np.asarray(js["step"])) == 3


def test_guarded_poisoned_step_leaves_state_bit_identical(guarded_runs):
    _, r = guarded_runs
    pz = r["poisoned"]
    assert pz["ref_same"] and pz["port_same"]
    assert pz["ref_counts"] == pz["port_counts"] == (1, 1)
    # both count every grad element and every new p, m, v element
    assert pz["port_word"][0] == pz["ref_word"][0] > 0
    assert pz["port_word"][2] == pz["ref_word"][2] == 3 * pz["port_word"][0]
    assert math.isnan(pz["port_word"][3]) and math.isnan(pz["ref_word"][3])


def test_kernel_fault_bisected_to_the_same_kernel(monkeypatch, tmp_path):
    """A persistent NaN out of the rms_norm kernel: the second non-finite
    step escalates, bisection names ``pallas.rms_norm`` in the reference and
    ``cuda.rms_norm`` in the port, each quarantined with phase "numerics",
    and the step re-runs on the fallback with a finite loss."""
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(jcfg, seed=0, scale_layers=1)
    jopt = joptim.AdamW(lr=LR)
    jguard = NumericsGuardTransform(policy=jsentinel.NumericsPolicy(bisect_after=2))
    jstep = tt.jit(_reference_step(jcfg, jopt), block_fusion=False, transforms=[jguard])
    tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, 2, 16, seed=0)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    topt = AdamW(lr=LR)
    tstate = topt.init(tparams)
    tguard = NumericsGuard(policy=sentinel.NumericsPolicy(bisect_after=2))
    losses = {}
    jquarantine.configure(str(tmp_path / "ref"))
    quarantine.configure(str(tmp_path / "port"))
    with jfaults.active(jfaults.FaultPlan([jfaults.FaultSpec(
            "numerics:kernel:pallas.rms_norm", transient=False)])):
        p, s = jparams, jopt.init(jparams)
        l1, p, s = jstep(p, s, tok.astype(np.int32), tgt.astype(np.int32))
        l2, p, s = jstep(p, s, tok.astype(np.int32), tgt.astype(np.int32))
        losses["ref"] = (float(l1), float(l2))
    with faults.active(faults.FaultPlan([faults.FaultSpec(
            "numerics:kernel:cuda.rms_norm", transient=False)])):
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)
        t1 = pretrain.train_step(tparams, topt, tstate, ttok, ttgt, tcfg, guard=tguard)
        t2 = pretrain.train_step(tparams, topt, tstate, ttok, ttgt, tcfg, guard=tguard)
        losses["port"] = (float(t1), float(t2))
    for name in ("ref", "port"):
        assert math.isnan(losses[name][0]) and math.isfinite(losses[name][1])
    jq, tq = jquarantine.get_quarantine(), quarantine.get_quarantine()
    assert jq.ids() == ("pallas.rms_norm",) and tq.ids() == ("cuda.rms_norm",)
    assert jq.reason("pallas.rms_norm").startswith("silent numerics fault")
    assert tq.reason("cuda.rms_norm").startswith("silent numerics fault")
    assert float(tstate["step"]) == 1.0   # the skipped step did not count
    np.testing.assert_allclose(losses["port"][1], losses["ref"][1], rtol=1e-5)
