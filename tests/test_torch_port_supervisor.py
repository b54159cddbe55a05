"""thunder_tpu_torch's supervised serving lifecycle against the JAX package,
on the CPU: the ``serving:*`` fault domains and their retry policies, crash
recovery through ``EngineSupervisor`` with the restart budget, graceful
drain and shutdown, the SLO floor, the postmortem bundle, and the event
vocabulary.

The cases of ``tests/test_serving_supervisor.py`` and the fault cases of
``tests/test_serving.py``'s ``TestServingEngine`` run on both packages with
the same weights (tiny-gqa float32; the reference at its per-op rung), the
same requests and the same fault plans, and each compares: tokens, restart
and request counts, the registry's counters, and the serving events in
order with timestamps, durations and engine labels masked, request ids
replaced by their order of appearance, and the launch count the reference's
``serving_decode_bind`` takes from its launch census (ROADMAP A.4) left
out. Both packages' fault plans,
quarantines, registries and flight rings are reset around every test.

Left out of the port (ROADMAP A.3, A.4): the watchdog (``heartbeat_path=``)
and statusz (``statusz_dir=``), which raise ``NotImplementedError`` naming
the item; the bundle's Perfetto timeline and decision log.
"""

import json
import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from thunder_tpu import observe as jobserve
from thunder_tpu.models import llama as jllama
from thunder_tpu.runtime import faults as jfaults
from thunder_tpu.runtime import quarantine as jquarantine
from thunder_tpu.runtime import retry as jretry
from thunder_tpu.serving import EngineFault as JEngineFault
from thunder_tpu.serving import EngineSupervisor as JSupervisor
from thunder_tpu.serving import RestartBudgetExceeded as JRestartBudgetExceeded
from thunder_tpu.serving import SamplingParams as JSamplingParams
from thunder_tpu.serving import ServingEngine as JServingEngine
from thunder_tpu.serving import events as jevents
from thunder_tpu_torch import observe
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.runtime import faults, quarantine, retry
from thunder_tpu_torch.serving import (
    EVENT_KINDS,
    AdmissionRejected,
    DeadlineExceeded,
    EngineFault,
    EngineSupervisor,
    RestartBudgetExceeded,
    RestartState,
    SamplingParams,
    ServingEngine,
)

N_LAYERS = 2
PKG = {"ref": dict(observe=jobserve, faults=jfaults, retry=jretry, sup=JSupervisor,
                   EngineFault=JEngineFault, Budget=JRestartBudgetExceeded),
       "port": dict(observe=observe, faults=faults, retry=retry, sup=EngineSupervisor,
                    EngineFault=EngineFault, Budget=RestartBudgetExceeded)}


def _clean():
    for obs, flt, qu in ((jobserve, jfaults, jquarantine), (observe, faults, quarantine)):
        flt.clear()
        qu.reset()
        obs.disable()
        obs.reset()
        obs.flight.clear()


@pytest.fixture(autouse=True)
def _clean_runtime():
    _clean()
    yield
    _clean()


@pytest.fixture(scope="module")
def model():
    cfg = jllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(cfg, seed=0, scale_layers=N_LAYERS)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, tllama.CONFIGS["tiny-gqa"], jparams, tparams


def _engine(model, pkg, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = {"max_slots": 3, "page_size": 16, "max_context": 64, "prefill_chunk": 32, **kw}
    if "retry_policy" in kw:
        kw["retry_policy"] = PKG[pkg]["retry"].RetryPolicy(**kw["retry_policy"])
    if pkg == "ref":
        return JServingEngine(jparams, jcfg, block_fusion=False, n_layers=N_LAYERS, **kw)
    return ServingEngine(tparams, tcfg, device="cpu", block_fusion=False, **kw)


# fast supervised retries: chaos runs should not sleep through real backoff
FAST = dict(max_attempts=3, base_delay_s=0.001, max_delay_s=0.01)

_MASK = ("ts_us", "dur_us", "tid", "ttft_ms", "restart_ms", "labels", "path", "error",
         "cause")


def _events(snap):
    """The serving events of a registry snapshot, in order: timestamps,
    durations, labels and reprs masked, request ids replaced by their order
    of first appearance."""
    ids: dict = {}

    def rid(v):
        return ids.setdefault(v, len(ids))

    out = []
    for e in snap["events"]:
        if not e["kind"].startswith("serving_"):
            continue
        e = {k: v for k, v in e.items() if k not in _MASK}
        if e["kind"] == "serving_decode_bind":
            e.pop("launches", None)   # the reference's launch census (ROADMAP A.4)
        for k in ("request", "fork_of", "parent"):
            if e.get(k) is not None:
                e[k] = rid(e[k])
        if "recovered" in e:
            e["recovered"] = [rid(r) for r in e["recovered"]]
        if "shed" in e and isinstance(e["shed"], list):
            e["shed"] = [rid(r) for r in e["shed"]]
        out.append(e)
    return out


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, size=n).astype(np.int32) for n in lengths]


def _run(model, pkg, fn, **kw):
    """``fn(engine, supervisor)`` on one package with its registry on;
    returns (fn's result, snapshot)."""
    obs = PKG[pkg]["observe"]
    obs.enable(clear=True)
    try:
        eng = _engine(model, pkg, **kw)
        res = fn(eng, PKG[pkg])
        snap = obs.snapshot()
    finally:
        obs.disable()
    return res, snap


def _counters(snap, *names):
    return {n: snap["counters"].get(n, 0) for n in names}


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_supervisor_restart_recovers_in_flight_token_identical(model):
    prompts = _prompts(0, (5, 9, 17))
    out = {}
    for pkg in PKG:
        def run(eng, P):
            sup = P["sup"](eng, max_restarts=2, restart_window_s=600.0)
            reqs = [sup.submit(p, 6) for p in prompts]
            with P["faults"].active(P["faults"].FaultPlan(
                    [P["faults"].FaultSpec("serving:engine", at_steps={4})])):
                done = sup.drain()
            eng.assert_quiescent()
            return (len(done), sup.restarts, [r.output().tolist() for r in reqs],
                    [r.restarts for r in reqs])

        res, snap = _run(model, pkg, run, retry_policy=FAST)
        out[pkg] = (res, _counters(snap, "serving.engine_restarts", "runtime.faults_injected"),
                    snap["histograms"]["serving.drain_ms"]["count"], _events(snap))
    assert out["port"] == out["ref"]
    (n_done, restarts, toks, req_restarts), counters, drains, events = out["port"]
    assert n_done == 3 and restarts == 1 and req_restarts == [1, 1, 1] and drains == 1
    assert counters["serving.engine_restarts"] == 1
    assert "serving_engine_restart" in {e["kind"] for e in events}
    clean = _engine(model, "port")
    want = [clean.submit(p, 6) for p in prompts]
    clean.drain()
    assert toks == [r.output().tolist() for r in want]


@pytest.mark.chaos
def test_restart_budget_exhaustion_escalates(model):
    out = {}
    for pkg in PKG:
        def run(eng, P):
            sup = P["sup"](eng, restart_budget=P["retry"].RestartBudget(
                max_restarts=1, window_s=3600.0))
            sup.submit(np.ones(5, np.int32), 8)
            plan = P["faults"].FaultPlan([P["faults"].FaultSpec(
                "serving:engine", every_n=3, transient=False)])
            with P["faults"].active(plan):
                with pytest.raises(P["Budget"]) as ei:
                    sup.drain()
            err = ei.value
            assert isinstance(err.__cause__, P["EngineFault"])
            assert isinstance(err.__cause__.__cause__, P["faults"].InjectedFault)
            return sup.restarts, err.max_restarts, err.in_window, err.engine_id == eng.engine_id

        res, snap = _run(model, pkg, run, retry_policy=FAST)
        out[pkg] = (res, _events(snap))
    assert out["port"] == out["ref"]
    assert out["port"][0] == (1, 1, 2, True)


@pytest.mark.chaos
def test_chaos_soak_all_serving_domains(model):
    """The reference's acceptance soak: a seeded plan over all four serving
    domains on a tight pool; every request token-identical to a fault-free
    run, no page leaked, restarts within the budget — and the same
    restarts, injections, preemptions and events in both packages."""
    prompts = _prompts(42, (30, 5, 17, 9, 28, 12))
    out = {}
    for pkg in PKG:
        def run(eng, P):
            F = P["faults"]
            plan = F.FaultPlan([
                F.FaultSpec("serving:prefill", every_n=6, max_fires=3),
                F.FaultSpec("serving:decode", probability=0.06, seed=7, max_fires=3),
                F.FaultSpec("serving:admission", probability=0.2, seed=5, max_fires=2),
                F.FaultSpec("serving:engine", every_n=8, max_fires=2)])
            budget = P["retry"].RestartBudget(max_restarts=3, window_s=3600.0)
            sup = P["sup"](eng, restart_budget=budget)
            reqs = [sup.submit(p, 8) for p in prompts]
            with F.active(plan):
                done = sup.drain()
            eng.assert_quiescent()
            return len(done), sup.restarts, [r.output().tolist() for r in reqs]

        res, snap = _run(model, pkg, run, page_size=8, num_pages=10, prefill_chunk=16,
                         retry_policy=FAST)
        out[pkg] = (res, _counters(snap, "serving.engine_restarts", "runtime.faults_injected",
                                   "serving.shed_requests", "serving.preempted_requests",
                                   "runtime.retries"), _events(snap))
    assert out["port"] == out["ref"]
    (n_done, restarts, toks), counters, _ = out["port"]
    assert n_done == 6 and restarts == 2
    assert counters["runtime.faults_injected"] >= 5 and counters["serving.shed_requests"] == 0
    assert counters["serving.preempted_requests"] >= 1
    clean = _engine(model, "port", page_size=8, num_pages=10, prefill_chunk=16)
    want = [clean.submit(p, 8) for p in prompts]
    clean.drain()
    assert toks == [r.output().tolist() for r in want]


@pytest.mark.chaos
def test_request_survives_retried_step(model):
    """``step``-domain faults: the decode dispatch retries and the request
    completes with the fault-free tokens (test_serving.py)."""
    p = _prompts(4, (9,))[0]
    out = {}
    for pkg in PKG:
        def run(eng, P):
            req = eng.submit(p, 5)
            with P["faults"].active(P["faults"].FaultPlan(
                    [P["faults"].FaultSpec("step", every_n=2, max_fires=2)])):
                eng.drain()
            return req.done, req.output().tolist()

        res, snap = _run(model, pkg, run, retry_policy=FAST)
        out[pkg] = (res, _counters(snap, "runtime.retries"))
    assert out["port"] == out["ref"]
    assert out["port"][1]["runtime.retries"] >= 2


@pytest.mark.chaos
def test_eviction_returns_pages_under_faults(model):
    prompts = _prompts(5, (30, 28, 20))
    out = {}
    for pkg in PKG:
        def run(eng, P):
            reqs = [eng.submit(p, 8) for p in prompts]
            with P["faults"].active(P["faults"].FaultPlan(
                    [P["faults"].FaultSpec("step", every_n=5, max_fires=2)])):
                eng.drain()
            assert eng.cache.pages_free == eng.cache.pages_total
            return [r.output().tolist() for r in reqs]

        res, snap = _run(model, pkg, run, page_size=8, num_pages=10, prefill_chunk=16,
                         retry_policy=FAST)
        out[pkg] = (res, _counters(snap, "serving.preempted_requests", "runtime.retries"))
    assert out["port"] == out["ref"]
    assert out["port"][1]["serving.preempted_requests"] >= 1


@pytest.mark.chaos
def test_permanent_decode_fault_propagates_after_its_retries(model):
    """A fault that every attempt hits: the policy's 3 attempts, then the
    InjectedFault itself (the pools are alive, so no EngineFault)."""
    out = {}
    for pkg in PKG:
        def run(eng, P):
            eng.submit(np.ones(3, np.int32), 2)
            with P["faults"].active(P["faults"].FaultPlan(
                    [P["faults"].FaultSpec("serving:decode", transient=False)])):
                with pytest.raises(P["faults"].InjectedFault):
                    eng.drain()
            return eng.cache.pools_alive()

        res, snap = _run(model, pkg, run, retry_policy=FAST)
        out[pkg] = (res, _counters(snap, "runtime.retries", "runtime.faults_injected"))
    assert out["port"] == out["ref"]
    assert out["port"] == (True, {"runtime.retries": 2, "runtime.faults_injected": 3})


# ---------------------------------------------------------------------------
# graceful drain, shutdown, SLO floor, postmortem
# ---------------------------------------------------------------------------

def test_drain_bounds_wall_clock_and_stops_admissions(model):
    out = {}
    for pkg in PKG:
        def run(eng, P):
            sup = P["sup"](eng)
            r1 = sup.submit(np.ones(5, np.int32), 30)
            sup.step()
            sup.step()
            done = sup.drain(deadline_s=0.0)
            with pytest.raises(Exception, match="draining") as ei:
                sup.submit(np.ones(3, np.int32), 2)
            assert type(ei.value).__name__ == "AdmissionRejected"
            eng.assert_quiescent()
            return done == [], r1.failed, type(r1.error).__name__, len(r1.generated) >= 1

        res, snap = _run(model, pkg, run)
        out[pkg] = (res, snap["histograms"]["serving.drain_ms"]["count"],
                    _counters(snap, "serving.shed_requests"), _events(snap))
    assert out["port"] == out["ref"]
    assert out["port"][0] == (True, True, "DeadlineExceeded", True)


def test_shutdown_drains_to_completion(model):
    out = {}
    for pkg in PKG:
        def run(eng, P):
            sup = P["sup"](eng)
            r = sup.submit(np.ones(4, np.int32), 3)
            done = sup.shutdown()
            eng.assert_quiescent()
            sup.close()                      # idempotent
            return r.done, done == [r], r.output().tolist(), eng.admitting

        out[pkg] = _run(model, pkg, run)[0]
    assert out["port"] == out["ref"]


def test_draining_engine_rejects_admissions(model):
    eng = _engine(model, "port")
    r = eng.submit(np.ones(3, np.int32), 2)
    eng.stop_admissions()
    with pytest.raises(AdmissionRejected, match="draining") as ei:
        eng.submit(np.ones(3, np.int32), 2)
    assert ei.value.engine_id == eng.engine_id
    eng.drain()
    assert r.done and len(eng.shed) == 1
    eng.assert_quiescent()


def test_shed_outstanding_and_deadline_errors_carry_the_engine(model):
    eng = _engine(model, "port", max_slots=1)
    a = eng.submit(np.ones(3, np.int32), 4)
    b = eng.submit(np.ones(5, np.int32), 4)
    eng.step()
    victims = eng.shed_outstanding("test")
    assert {r.request_id for r in victims} == {a.request_id, b.request_id}
    for r in (a, b):
        assert isinstance(r.error, DeadlineExceeded) and r.error.engine_id == eng.engine_id
    eng.assert_quiescent()


def test_slo_floor_collapse_dumps_once(model, tmp_path):
    """Deadlines that cannot be met: the on-time ratio falls below the
    floor, ``serving_slo_collapse`` fires once (latched) and the bundle is
    written; ``rearm_slo`` starts a fresh window. Same events as the
    reference."""
    out = {}
    for pkg in PKG:
        pm = tmp_path / pkg

        def run(eng, P):
            sup = P["sup"](eng, slo_floor=0.5, min_slo_samples=2, postmortem_dir=str(pm))
            for _ in range(3):
                sup.submit(np.ones(4, np.int32), 2, deadline_s=-1.0)
            ok = sup.submit(np.ones(4, np.int32), 2)
            while not eng.idle:
                sup.step()
            sup.step()
            sup.rearm_slo()
            return ok.done, sup._slo_collapsed, sorted(d.split("-", 2)[2] for d in os.listdir(pm))

        res, snap = _run(model, pkg, run)
        out[pkg] = (res, [e for e in _events(snap) if e["kind"] in
                          ("serving_slo_collapse", "serving_postmortem")])
    assert out["port"] == out["ref"]
    assert out["port"][0] == (True, False, ["slo_collapse"])


@pytest.mark.chaos
def test_engine_fault_dumps_a_postmortem_bundle(model, tmp_path):
    """The recovered ``EngineFault`` leaves a bundle: the flight ring, the
    engine's state at the crash (pools consumed, residents stranded), a
    registry snapshot and a manifest."""
    eng = _engine(model, "port", retry_policy=FAST)
    sup = EngineSupervisor(eng, postmortem_dir=str(tmp_path))
    req = sup.submit(np.ones(6, np.int32), 5)
    with faults.active(faults.FaultPlan([faults.FaultSpec("serving:engine", at_steps={3})])):
        sup.drain()
    assert req.done and sup.restarts == 1
    [bundle] = os.listdir(tmp_path)
    assert bundle.endswith("-EngineFault")
    files = sorted(os.listdir(tmp_path / bundle))
    assert files == ["MANIFEST.json", "engine.json", "flight.jsonl", "registry.json"]
    state = json.loads((tmp_path / bundle / "engine.json").read_text())
    assert state["pools_alive"] is False and state["slots"]
    assert state["mesh"] == {"n_layers": N_LAYERS, "kv_heads": 2, "num_pages": eng.geom.num_pages,
                             "tp_degree": 1, "mesh_shape": [1]}
    manifest = json.loads((tmp_path / bundle / "MANIFEST.json").read_text())
    assert manifest["errors"] == [] and manifest["flight_records"] > 0
    kinds = [json.loads(line).get("kind") for line in
             (tmp_path / bundle / "flight.jsonl").read_text().splitlines()]
    assert "serving_submitted" in kinds


def test_restart_state_mismatch_raises(model):
    eng = _engine(model, "port")
    other = RestartState(geometry=eng.geom, dtype=eng.cfg.dtype, device="meta")
    with pytest.raises(ValueError, match="restart state mismatch"):
        eng.rebuild_after_fault(other)
    assert eng.rebuild_after_fault(eng._restart_state) == []
    eng.assert_quiescent()


@pytest.mark.parametrize("arg", ["heartbeat_path", "stall_timeout_s", "on_stall",
                                 "statusz_dir", "statusz_interval_s"])
def test_parts_left_out_raise_naming_the_roadmap_item(model, arg):
    eng = _engine(model, "port")
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        EngineSupervisor(eng, **{arg: "x"})
    with pytest.raises(TypeError, match="unexpected keyword"):
        EngineSupervisor(eng, no_such_option=1)


# ---------------------------------------------------------------------------
# metrics and the event vocabulary
# ---------------------------------------------------------------------------

def test_serving_metrics_and_events_match_reference(model):
    """A prefix-cached engine under page pressure with a best-of request:
    the same serving events in the same order, the same counters, and the
    serving gauges and histograms the reference records."""
    rng = np.random.RandomState(3)
    sysp = rng.randint(1, 512, size=32).astype(np.int32)
    prompts = [np.concatenate([sysp, rng.randint(1, 512, size=n).astype(np.int32)])
               for n in (5, 9, 3)]
    out = {}
    for pkg in PKG:
        def run(eng, P):
            sp = SamplingParams if pkg == "port" else JSamplingParams
            eng.submit(prompts[0], 4)
            eng.drain()
            eng.submit(prompts[1], 4, sampling=sp(temperature=0.9, seed=4), best_of=2)
            eng.submit(prompts[2], 4, priority=1)
            eng.drain()
            eng.assert_quiescent()
            return [r.output().tolist() for r in eng.completed]

        res, snap = _run(model, pkg, run, prefix_cache=True, num_pages=8)
        out[pkg] = (res, _counters(snap, "serving.preempted_requests", "serving.cow_copies",
                                   "serving.cache_evictions", "serving.shed_requests"),
                    _events(snap), sorted(g for g in snap["gauges"] if g.startswith("serving.")
                                          and "quarantine" not in g and "decode_" not in g),
                    sorted(h for h in snap["histograms"] if h.startswith("serving.")))
    assert out["port"] == out["ref"]
    kinds = {e["kind"] for e in out["port"][2]}
    assert {"serving_prefix_hit", "serving_fork", "serving_first_token",
            "serving_complete", "serving_prefill_chunk"} <= kinds


def test_event_kinds_are_the_reference_vocabulary_without_parts_not_ported():
    left_out = {"serving_mesh", "serving_engine_stalled", "serving_health_transition",
                "serving_fleet_postmortem", "serving_route_decision", "serving_route_migrate",
                "serving_route_rebalance", "serving_route_reject"}
    assert EVENT_KINDS == jevents.EVENT_KINDS - left_out


def test_event_kinds_are_emitted_both_ways():
    """Every ``serving_*`` kind the port's code emits is in EVENT_KINDS, and
    every kind there is emitted somewhere in the port."""
    root = Path(__file__).resolve().parents[1] / "thunder_tpu_torch"
    src = "\n".join(p.read_text() for p in root.rglob("*.py"))
    emitted = set(re.findall(r'event\(\s*"(serving_\w+)"', src))
    assert emitted == set(EVENT_KINDS)
