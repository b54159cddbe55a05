"""thunder_tpu_torch's runtime-safety layer against the JAX package's, on the
CPU: the metric registry and the flight ring (``observe``), fault plans,
retry policies, the restart budget and the kernel quarantine (``runtime``),
fed the same call sequences in both packages and compared snapshot for
snapshot with the timestamps masked (fire steps, delays, counters and file
contents equal). Then the port's own wiring: the kernel guard in the
routers (refusals, build and allocation failures pass through and are
never quarantined, launch failures are attributed, a sticky CUDA error is
fatal), the quarantine's rungs (``decode_layer`` → the sub-blocks → the
per-op kernels; a quarantined kernel with no kernel rung below it raises a
fatal error on the card and runs its plain version only on the CPU), the
``checkpoint_io`` hook, and a serving engine with
``kernel:cuda.decode_layer`` injected against the reference engine with
``kernel:pallas.decode_layer`` injected (the ``shim`` fixture of
``test_torch_port_serving_planned.py`` binds the Pallas primitives the
reference's decode-layer kernel needs) and against the port's unfaulted
engine: identical tokens (float32).

ROADMAP C.2: ``clip_grad_norm`` on trees with integer leaves, where the two
packages differ on purpose; the difference is held exactly.
"""

import json

import jax
import numpy as np
import pytest
import torch

from test_torch_port_serving_planned import (  # noqa: F401
    ENGINE_LAYERS, _prompts, bound_layer_kernel, shim)

import thunder_tpu as tt
from thunder_tpu import observe as jobserve
from thunder_tpu import optim as joptim
from thunder_tpu.checkpoint import save_checkpoint as jsave_checkpoint
from thunder_tpu.models import llama as jllama
from thunder_tpu.runtime import faults as jfaults
from thunder_tpu.runtime import quarantine as jquarantine
from thunder_tpu.runtime import retry as jretry
from thunder_tpu.serving import ServingEngine as JServingEngine
from thunder_tpu_torch import checkpoint, observe
from thunder_tpu_torch import optim as toptim
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.ops import optim as toptim_ops
from thunder_tpu_torch.runtime import faults, quarantine, retry
from thunder_tpu_torch.serving import ServingEngine

PKGS = {"ref": (jobserve, jfaults, jretry, jquarantine),
        "port": (observe, faults, retry, quarantine)}


def _clean():
    for obs, flt, _, qu in PKGS.values():
        flt.clear()
        qu.reset()
        obs.disable()
        obs.reset()
        obs.flight.clear()


@pytest.fixture(autouse=True)
def _clean_runtime():
    """Both packages start and end with no fault plan, an empty in-memory
    quarantine, and a clean registry and flight ring."""
    _clean()
    yield
    _clean()


_TIMES = ("ts_us", "dur_us", "tid", "time")


def _masked(x):
    """``x`` with every timestamp, duration and thread id replaced by None."""
    if isinstance(x, dict):
        return {k: None if k in _TIMES else _masked(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_masked(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# observe: the registry and the flight ring
# ---------------------------------------------------------------------------

def _registry_sequence(obs):
    obs.inc("a.count")                       # off: dropped
    obs.set_gauge("a.gauge", 1)              # off: ring only
    obs.event("off_event", x=1)
    obs.enable(clear=True)
    obs.inc("a.count")
    obs.inc("a.count", 2.5)
    obs.set_gauge("a.gauge", 3)
    for v in (0.05, 0.3, 7.0, 99.0, 1e5):
        obs.observe_value("a.hist", v)
    obs.event("e1", k="v", n=2)
    obs.registry.record_span("s1", "serving", 10.0, 5.0, {"req": 1})
    lab = obs.labeled(engine="e0", shard=1)
    lab.inc("a.count")
    lab.set_gauge("b.gauge", 7)
    lab.observe_value("b.hist", 2.0)
    lab.event("e2", req=3)
    lab.record_span("s2", "serving", 20.0, 1.0)
    other = obs.labeled(engine="e1")
    other.inc("a.count", 4)
    snap = obs.snapshot()
    lab_snap = lab.snapshot()
    engines = obs.engines_seen()
    obs.reset()
    after_reset = obs.snapshot()
    obs.disable()
    return snap, lab_snap, engines, after_reset, obs.flight.snapshot()


def test_registry_and_flight_ring_match_reference():
    got = {name: _masked(_registry_sequence(pkg[0])) for name, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    snap, _, engines, after_reset, ring = got["port"]
    assert snap["counters"]["a.count"] == 3.5 + 1 + 4 and engines == ["e0", "e1"]
    assert after_reset["counters"] == {} and len(ring) == 8


def test_disabled_registry_costs_one_check_and_keeps_the_ring():
    """Off: counters and histograms are dropped; events, gauges and spans
    still reach the flight ring, in both packages alike."""
    out = {}
    for name, (obs, *_) in PKGS.items():
        obs.inc("x")
        obs.observe_value("h", 1.0)
        obs.event("ev", a=1)
        obs.set_gauge("g", 2)
        with obs.span("sp", "serving", {"k": 1}):
            pass
        snap, ring = obs.snapshot(), obs.flight.snapshot()
        assert snap["counters"] == {} and snap["histograms"] == {} and snap["events"] == []
        out[name] = [(r["type"], r.get("kind") or r.get("name")) for r in ring]
    assert out["port"] == out["ref"] == [("event", "ev"), ("gauge", "g"), ("span", "sp")]


def test_flight_ring_bound_and_resize_match_reference():
    out = {}
    for name, (obs, *_) in PKGS.items():
        fl = obs.flight
        fl.configure(4)
        for i in range(7):
            obs.event("e", i=i)
        first = (fl.get_recorder().capacity, fl.get_recorder().dropped,
                 [r["i"] for r in fl.snapshot()])
        fl.configure(2)
        out[name] = (first, [r["i"] for r in fl.snapshot()])
        fl.configure(fl.DEFAULT_CAPACITY)
    assert out["port"] == out["ref"] == ((4, 3, [3, 4, 5, 6]), [5, 6])


# ---------------------------------------------------------------------------
# faults: deterministic schedules
# ---------------------------------------------------------------------------

def _fires(flt, plan, calls):
    """Each (method, domain, step) call against ``plan``: True where it
    fired (raised, or reported a corruption)."""
    out = []
    for method, domain, step in calls:
        if method == "corrupt":
            out.append(plan.should_corrupt(domain, step=step))
            continue
        try:
            plan.maybe_fail(domain, step=step)
            out.append(False)
        except flt.InjectedFault as e:
            out.append((e.domain, e.step, e.transient))
    return out


def _plan_sequence(obs, flt):
    obs.enable(clear=True)
    specs = [flt.FaultSpec("step", at_steps={3, 5}),
             flt.FaultSpec("dispatch", at_steps={2}, transient=False),
             flt.FaultSpec("collective", every_n=3, transient=False),
             flt.FaultSpec("io", probability=0.4, seed=11, transient=False),
             flt.FaultSpec("kernel:*", transient=False, max_fires=2),
             flt.FaultSpec("compile"),
             flt.FaultSpec("numerics:grads", at_steps={4})]
    calls = ([("fail", "step", s) for s in (1, 3, 3, 4, 5, 5)]
             + [("fail", "dispatch", 2)] * 3
             + [("fail", "collective", None)] * 7
             + [("fail", "io", None)] * 12
             + [("fail", "kernel:cuda.rms_norm", None)] * 3
             + [("fail", "compile", None)] * 2
             + [("corrupt", "numerics:grads", s) for s in (3, 4, 4)])
    fired = _fires(flt, flt.FaultPlan(specs), calls)
    snap = obs.snapshot()
    obs.disable()
    return fired, snap["counters"], _masked(snap["events"])


def test_fault_plans_fire_as_the_reference_does():
    got = {name: _plan_sequence(obs, flt) for name, (obs, flt, _, _) in PKGS.items()}
    assert got["port"] == got["ref"]
    fired = got["port"][0]
    assert fired[:6] == [False, ("step", 3, True), False, False, ("step", 5, True), False]
    assert sum(bool(f) for f in fired[16:28]) > 0   # the seeded probability fires


def test_no_plan_is_a_noop_and_active_restores():
    for _, flt, _, _ in PKGS.values():
        flt.maybe_fail("dispatch")
        assert flt.should_corrupt("numerics:loss") is False
        plan = flt.FaultPlan([flt.FaultSpec("dispatch")])
        with flt.active(plan):
            assert flt.active_plan() is plan
            with pytest.raises(flt.InjectedFault):
                flt.maybe_fail("dispatch")
        assert flt.active_plan() is None


def test_poison_tree_fills_floating_tensors_with_nan():
    tree = {"a": torch.ones(3), "b": [torch.arange(4), torch.ones(2, dtype=torch.bfloat16)],
            "c": 3}
    out = faults.poison_tree(tree)
    assert torch.isnan(out["a"]).all() and torch.isnan(out["b"][1]).all()
    assert torch.equal(out["b"][0], torch.arange(4)) and out["c"] == 3
    assert torch.equal(tree["a"], torch.ones(3))   # a new tensor: the input is kept


# ---------------------------------------------------------------------------
# retry, restart budget
# ---------------------------------------------------------------------------

def _retry_sequence(obs, flt, rt):
    obs.enable(clear=True)
    delays = [rt.RetryPolicy(jitter=0.5, seed=3, base_delay_s=0.1).delay_s(i)
              for i in range(1, 8)]
    calls, slept = {"n": 0}, []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise RuntimeError("transient")
        return "ok"

    ok = rt.call_with_retry(flaky, policy=rt.RetryPolicy(max_attempts=5, seed=1),
                            domain="dispatch", sleep=slept.append)
    t = {"now": 0.0}

    def sleep(d):
        t["now"] += d

    try:
        rt.call_with_retry(lambda: (_ for _ in ()).throw(OSError("down")),
                           policy=rt.RetryPolicy(max_attempts=100, base_delay_s=1.0,
                                                 jitter=0.0, deadline_s=2.5),
                           sleep=sleep, clock=lambda: t["now"])
        deadline = None
    except OSError:
        deadline = t["now"]
    verdicts = [rt.classify(e) for e in (
        KeyboardInterrupt(), ValueError("bug"), RuntimeError("device"), OSError("io"),
        flt.InjectedFault("x"), flt.KernelExecutionError("cuda.x"))]
    snap = obs.snapshot()
    obs.disable()
    policies = {d: (p.max_attempts, p.base_delay_s, p.max_delay_s)
                for d, p in rt.DEFAULT_POLICIES.items()}
    return (delays, ok, calls["n"], slept, deadline, verdicts, policies, snap["counters"],
            snap["histograms"], _masked(snap["events"]))


def test_retry_policies_match_reference():
    got = {name: _retry_sequence(obs, flt, rt) for name, (obs, flt, rt, _) in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["port"][5] == [retry.FATAL, retry.FATAL, retry.RETRYABLE, retry.RETRYABLE,
                              retry.RETRYABLE, retry.DEGRADABLE]


def test_restart_budget_matches_reference():
    out = {}
    for name, (_, _, rt, _) in PKGS.items():
        t = {"now": 0.0}
        b = rt.RestartBudget(max_restarts=2, window_s=10.0, clock=lambda: t["now"])
        seq = []
        for now in (0.0, 1.0, 2.0, 50.0, 51.0, 52.0, 70.0):
            t["now"] = now
            seq.append((b.record(), b.in_window, b.describe()))
        life = rt.RestartBudget(max_restarts=1, clock=lambda: t["now"])
        seq.append((life.record(), life.record(), life.describe()))
        out[name] = seq
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("msg", ["rms_norm: kernel launch failed with CUDA error 700",
                                 "CUDA error: an illegal memory access was encountered",
                                 "CUDA error: unspecified launch failure",
                                 "decode_layer: kernel launch failed with CUDA error 719"])
def test_sticky_cuda_errors_are_fatal(msg):
    """A sticky CUDA error leaves the context unusable: fatal, also when a
    kernel guard attributed it; other launch errors stay degradable."""
    err = RuntimeError(msg)
    assert retry.classify(err) == retry.FATAL
    wrapped = faults.KernelExecutionError("cuda.rms_norm", cause=err)
    wrapped.__cause__ = err
    assert retry.classify(wrapped) == retry.FATAL
    other = RuntimeError("rms_norm: kernel launch failed with CUDA error 1")
    assert retry.classify(faults.KernelExecutionError("cuda.rms_norm", cause=other)) \
        == retry.DEGRADABLE


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------

def _quarantine_sequence(obs, qu, root, claim):
    obs.enable(clear=True)
    e0 = qu.epoch()
    q = qu.configure(str(root))
    q.add(claim("a"), reason="r1")
    q.add(claim("a"), reason="")
    q.add(claim("b"), phase="numerics")
    q.remove(claim("b"))
    on_disk = json.load(open(q.path))
    # a second process recorded its own entry meanwhile: merge on load
    data = json.load(open(q.path))
    data["kernels"][claim("c")] = {"reason": "r2", "phase": "runtime", "time": 0.0, "count": 1}
    json.dump(data, open(q.path, "w"))
    qu.reset()
    merged = sorted(qu.configure(str(root)).ids())
    with open(q.path, "w") as f:
        f.write('{"version": 1, "kern')   # torn: starts empty
    qu.reset()
    torn = len(qu.configure(str(root)))
    with qu.suppress([claim("x")]):
        with qu.suppress([claim("y")], reason="probe 2"):
            inner = (qu.is_quarantined(claim("x")), qu.quarantine_reason(claim("x")),
                     qu.quarantine_reason(claim("y")))
    outer = qu.quarantine_reason(claim("x"))
    snap = obs.snapshot()
    obs.disable()
    return (qu.epoch() - e0, _masked(on_disk), merged, torn, inner, outer, snap["gauges"],
            _masked(snap["events"]))


def test_quarantine_matches_reference(tmp_path):
    got = {}
    for name, (obs, _, _, qu) in PKGS.items():
        prefix = "cuda" if name == "port" else "pallas"
        got[name] = json.loads(json.dumps(_quarantine_sequence(
            obs, qu, tmp_path / name, lambda c, p=prefix: f"{p}.{c}")).replace("pallas.",
                                                                                "cuda."))
    assert got["port"] == got["ref"]
    assert got["port"][2] == ["cuda.a", "cuda.c"] and got["port"][3] == 0


def test_quarantine_write_is_atomic(tmp_path):
    q = quarantine.configure(str(tmp_path))
    q.add("cuda.a")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["kernel_quarantine.json"]
    assert quarantine.is_routed_off("cuda.a") and not quarantine.is_routed_off("cuda.b")
    with quarantine.suppress(["cuda.b"]):
        assert quarantine.is_routed_off("cuda.b")


# ---------------------------------------------------------------------------
# the kernel guard in the routers
# ---------------------------------------------------------------------------

def _x():
    g = torch.Generator().manual_seed(0)
    return torch.randn(4, 16, generator=g), torch.randn(8, 16, generator=g)


def test_kernel_fault_is_attributed_on_the_cpu():
    """``kernel:cuda.linear_act`` fires in the router on the CPU too, before
    the plain version runs, and surfaces as a degradable
    KernelExecutionError naming the claim."""
    a, w = _x()
    with faults.active(faults.FaultPlan([faults.FaultSpec("kernel:cuda.linear_act")])):
        with pytest.raises(faults.KernelExecutionError) as ei:
            tnn.linear_act(a, w, act="silu")
        out = tnn.linear_act(a, w, act="silu")   # transient: cleared
    assert ei.value.claim_id == "cuda.linear_act" and ei.value.phase == "runtime"
    assert isinstance(ei.value.__cause__, faults.InjectedFault)
    assert retry.classify(ei.value) == retry.DEGRADABLE
    torch.testing.assert_close(out, tnn.linear_act_plain(a, w, act="silu"), rtol=0, atol=0)


def _engine_stub():
    eng = ServingEngine.__new__(ServingEngine)
    eng.engine_id, eng.obs = "t", observe.labeled(engine="t")
    return eng


def test_refusals_pass_through_and_are_never_quarantined(monkeypatch):
    """A refusal (the ValueError a wrapper raises, ``cudaex._refuse``) passes
    the guard unchanged, and an engine-style containment never quarantines
    it; a failed launch (``KernelLaunchError``) is attributed, quarantined
    and replayed (on the CPU the replay runs the plain version)."""
    a, w = _x()
    monkeypatch.setattr(tnn, "_on_cuda", lambda t, name: True)
    monkeypatch.setattr(cudaex, "linear_act",
                        lambda *args, **kw: cudaex._refuse("linear_act: refused here"))
    with faults.active(faults.FaultPlan([faults.FaultSpec("numerics:kernel:cuda.other")])):
        with pytest.raises(ValueError, match="refused here"):
            tnn.linear_act(a, w)
    assert len(quarantine.get_quarantine()) == 0
    eng = _engine_stub()
    with pytest.raises(ValueError):
        eng._contained(lambda: tnn.linear_act(a, w))
    assert len(quarantine.get_quarantine()) == 0

    def launch_fails(*args, **kw):
        raise faults.KernelLaunchError("linear_act: kernel launch failed with CUDA error 1")

    monkeypatch.setattr(cudaex, "linear_act", launch_fails)
    calls = []

    def dispatch():
        calls.append(quarantine.is_routed_off("cuda.linear_act"))
        return tnn.linear_act(a, w)

    monkeypatch.setattr(tnn, "_on_cuda", lambda t, name: t.device.type != "cpu" or
                        not quarantine.is_routed_off("cuda.linear_act"))
    out = eng._contained(dispatch)   # quarantined, then replayed on the plain version
    assert calls == [False, True] and quarantine.is_quarantined("cuda.linear_act")
    torch.testing.assert_close(out, tnn.linear_act_plain(a, w), rtol=0, atol=0)


def _no_device(monkeypatch, tmp_path):
    """The wrapper reaches the build, which finds no CUDA card."""
    monkeypatch.setattr(cudaex.KERNELS["linear_act"], "fn", None)
    monkeypatch.setattr(cudaex, "linear_act", lambda *a, **kw: cudaex._launch("linear_act"))


def _no_nvcc(monkeypatch, tmp_path):
    """The build finds a card but no ``nvcc``."""
    _no_device(monkeypatch, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cudaex.shutil, "which", lambda name: None)
    monkeypatch.setattr(cudaex.os.path, "isfile", lambda path: False)


def _nvcc_fails(monkeypatch, tmp_path):
    """``nvcc`` runs and exits 2: a source that does not compile."""
    _no_device(monkeypatch, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: expected a ;'\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))


def _out_of_memory(monkeypatch, tmp_path):
    monkeypatch.setattr(cudaex, "linear_act", lambda *a, **kw: (_ for _ in ()).throw(
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")))


def _shape_error(monkeypatch, tmp_path):
    monkeypatch.setattr(cudaex, "linear_act", lambda a, w, *rest, **kw: torch.nn.functional.linear(
        a, w[:, :3]))


@pytest.mark.parametrize("cause,kind,match", [
    (_no_device, faults.KernelBuildError, "need a CUDA device"),
    (_no_nvcc, faults.KernelBuildError, "nvcc not found"),
    (_nvcc_fails, faults.KernelBuildError, "nvcc exited 2"),
    (_out_of_memory, torch.cuda.OutOfMemoryError, "out of memory"),
    (_shape_error, RuntimeError, "cannot be multiplied")],
    ids=["no card", "no nvcc", "build failed", "allocation", "shape error"])
def test_unattributed_failures_are_never_quarantined(monkeypatch, tmp_path, cause, kind, match):
    """Only a failed launch or an injected fault is the kernel's: a build
    failure (every kernel shares the one build), an allocation failure and
    a shape error inside the wrapper propagate unwrapped through the guard
    and the engine's containment, with a fault plan installed or not,
    quarantine nothing, and the build and allocation failures are fatal."""
    monkeypatch.setattr(cudaex, "BUILD_DIR", tmp_path / "build")
    a, w = _x()
    monkeypatch.setattr(tnn, "_on_cuda", lambda t, name: True)
    cause(monkeypatch, tmp_path)
    eng = _engine_stub()
    for plan in (None, faults.FaultPlan([faults.FaultSpec("kernel:cuda.other")])):
        with faults.active(plan):
            with pytest.raises(kind, match=match) as ei:
                eng._contained(lambda: tnn.linear_act(a, w))
        assert not isinstance(ei.value, faults.KernelExecutionError)
        assert len(quarantine.get_quarantine()) == 0
    if kind is not RuntimeError:
        assert retry.classify(ei.value) == retry.FATAL


def test_quarantined_leaf_raises_on_the_card():
    """A quarantined kernel with no kernel rung below it never runs its
    plain version on the card: its router raises a fatal
    KernelExecutionError before touching the tensors, and the engine's
    containment re-raises it without quarantining or replaying anything;
    on the CPU the same router runs its plain version, unguarded."""
    on_card = type("OnCard", (), {"device": torch.device("cuda")})()
    quarantine.get_quarantine().add("cuda.linear_act")
    epoch = quarantine.epoch()
    calls = []

    def dispatch():
        calls.append(1)
        return tnn.linear_act(on_card, on_card)

    with pytest.raises(faults.KernelExecutionError) as ei:
        _engine_stub()._contained(dispatch)
    assert ei.value.claim_id == "cuda.linear_act"
    assert ei.value.phase == faults.QUARANTINED and retry.classify(ei.value) == retry.FATAL
    assert calls == [1] and quarantine.epoch() == epoch
    a, w = _x()
    faults.reset_claim_calls()
    out = tnn.linear_act(a, w, act="silu")
    assert torch.equal(out, tnn.linear_act_plain(a, w, act="silu")) and faults.claim_calls() == {}


def test_routed_claims_are_counted_and_poisoned():
    """The guard counts each routed call by claim; a quarantined claim runs
    its fallback and is not counted; ``numerics:kernel:<claim>`` poisons the
    router's output."""
    a, w = _x()
    faults.reset_claim_calls()
    tnn.linear_act(a, w)
    tnn.rms_norm(a, torch.ones(16))
    assert faults.claim_calls() == {"cuda.linear_act": 1, "cuda.rms_norm": 1}
    quarantine.get_quarantine().add("cuda.rms_norm")
    tnn.rms_norm(a, torch.ones(16))
    assert faults.claim_calls() == {"cuda.linear_act": 1, "cuda.rms_norm": 1}
    spec = faults.FaultSpec("numerics:kernel:cuda.linear_act", transient=False)
    with faults.active(faults.FaultPlan([spec])):
        assert torch.isnan(tnn.linear_act(a, w)).all()


_PER_OP = {"cuda.rms_norm", "cuda.paged_decode_attention", "cuda.rms_norm_residual",
           "cuda.linear_act"}


@pytest.mark.parametrize("claims,expect,layer_fn", [
    ((), {"cuda.decode_layer", "cuda.rms_norm"}, "decode_layer"),
    (("cuda.decode_layer",), {"cuda.attn_subblock", "cuda.mlp_subblock", "cuda.rms_norm"},
     "attn_subblock"),
    (("cuda.decode_layer", "cuda.attn_subblock"),
     {"cuda.rms_norm", "cuda.paged_decode_attention", "cuda.mlp_subblock"}, None),
    (("cuda.decode_layer", "cuda.mlp_subblock"),
     {"cuda.attn_subblock", "cuda.rms_norm_residual", "cuda.linear_act"}, "attn_subblock"),
    (("cuda.decode_layer", "cuda.attn_subblock", "cuda.mlp_subblock", "cuda.rms_norm_residual"),
     _PER_OP - {"cuda.rms_norm_residual"}, None),
], ids=["planned", "sub-blocks", "per-op (attn_subblock)", "per-op (mlp_subblock)",
        "per-op, a CPU leaf"])
def test_decode_layer_rungs(claims, expect, layer_fn):
    """A planned engine binds each decode step to the quarantine's rung (its
    traced step's planner plans ``decode_layer``, the two sub-block kernels,
    or, while a sub-block is quarantined too, the other sub-block beside the
    per-op rung's kernels in its place), routes those claims on every decode
    step, and gives the tokens of the unquarantined engine (float32). A quarantined leaf on the CPU
    runs its plain version unguarded (on the card it raises:
    test_quarantined_leaf_raises_on_the_card)."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=ENGINE_LAYERS)
    prompts = _prompts(5, (5, 19, 33))
    kw = {"device": "cpu", "max_slots": 3, "page_size": 16, "max_context": 64,
          "prefill_chunk": 32, "block_fusion": True}

    def serve():
        eng = ServingEngine(params, cfg, **kw)
        routed, decode = [], eng.runner.decode

        def recorded(*args):
            faults.reset_claim_calls()
            out = decode(*args)
            routed.append(set(faults.claim_calls()))
            return out

        eng.runner.decode = recorded
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.drain()
        return [r.output().tolist() for r in reqs], routed, eng

    want, _, _ = serve()
    for c in claims:
        quarantine.get_quarantine().add(c)
    got, routed, eng = serve()
    assert got == want
    assert routed and all(r == expect for r in routed), routed[:2]
    assert bound_layer_kernel(eng) == layer_fn


# ---------------------------------------------------------------------------
# checkpoint_io, and serving with the decode_layer fault
# ---------------------------------------------------------------------------

def test_checkpoint_io_hook_fires_as_the_reference_does(tmp_path):
    state = {"w": np.ones((4,), np.float32)}
    raised = {}
    for name, save in (("ref", jsave_checkpoint), ("port", checkpoint.save_checkpoint)):
        flt = PKGS[name][1]
        path = tmp_path / name
        with flt.active(flt.FaultPlan([flt.FaultSpec("checkpoint_io")])):
            with pytest.raises(flt.InjectedFault) as ei:
                save(str(path), state)
        raised[name] = (ei.value.domain, ei.value.transient, path.exists())
        save(str(path), state)   # healthy after
        assert path.exists()
    assert raised["port"] == raised["ref"] == ("checkpoint_io", True, False)
    np.testing.assert_array_equal(checkpoint.load_checkpoint(str(tmp_path / "port"))["w"],
                                  state["w"])


def _names(trc) -> set:
    out = set()

    def walk(bsyms):
        for b in bsyms:
            out.add(b.sym.codegen_name())
            walk(b.subsymbols)

    walk(trc.bound_symbols)
    return out


def test_engine_decode_layer_fault_tokens_match_reference(shim):
    """A planned engine with ``kernel:cuda.decode_layer`` injected — on its
    first call, or on the 3rd decode step's first layer — gives the tokens of
    the reference engine with ``kernel:pallas.decode_layer`` injected (under
    the reference's whole-program jit the guard runs while the decode step
    is traced, so its fault hits the first compile) and of the port's
    unfaulted engine; the rebind is logged as the reference logs it."""
    jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(jcfg, seed=0, scale_layers=ENGINE_LAYERS)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = _prompts(3, (5, 19, 33))
    kw = {"max_slots": 3, "page_size": 16, "max_context": 64, "prefill_chunk": 32}
    jeng = JServingEngine(jparams, jcfg, block_fusion=True, n_layers=ENGINE_LAYERS, **kw)
    jreqs = [jeng.submit(p, 6) for p in prompts]
    with jfaults.active(jfaults.FaultPlan([jfaults.FaultSpec("kernel:pallas.decode_layer")])):
        jeng.drain()
    assert jquarantine.is_quarantined("pallas.decode_layer")
    names = _names(tt.last_execution_trace(jeng.runner.decode_jit))
    assert "pallas_attn_subblock" in names and "pallas_decode_layer" not in names
    plans = {"none": None, "first call": [faults.FaultSpec("kernel:cuda.decode_layer")],
             "step 3": [faults.FaultSpec("kernel:cuda.decode_layer",
                                         every_n=2 * ENGINE_LAYERS + 1, max_fires=1)]}
    tokens = {}
    for name, specs in plans.items():
        quarantine.reset()
        observe.enable(clear=True)
        teng = ServingEngine(tparams, tcfg, device="cpu", block_fusion=True, **kw)
        treqs = [teng.submit(p, 6) for p in prompts]
        with faults.active(faults.FaultPlan(specs) if specs else None):
            teng.drain()
        snap = observe.snapshot()
        observe.disable()
        tokens[name] = [r.output().tolist() for r in treqs]
    want = [r.output().tolist() for r in jreqs]
    assert tokens["none"] == tokens["first call"] == tokens["step 3"] == want
    assert teng.decode_rebinds == 1 and quarantine.is_quarantined("cuda.decode_layer")
    assert bound_layer_kernel(teng) == "attn_subblock"
    assert snap["counters"]["serving.decode_rebinds"] == 1
    assert snap["gauges"]["serving.decode_layer_fusions"] == 0
    assert snap["gauges"]["serving.quarantine_epoch"] == quarantine.epoch()
    kinds = [e["kind"] for e in snap["events"]]
    assert "serving_decode_rebind" in kinds and "kernel_fallback" in kinds


def test_engine_replays_a_faulted_prefill_chunk():
    """A kernel fault in a prefill chunk quarantines the kernel and the
    chunk is replayed on the next rung down: the tokens are unchanged."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=ENGINE_LAYERS)
    prompts = _prompts(4, (20, 40))
    kw = {"device": "cpu", "max_slots": 2, "page_size": 8, "max_context": 64,
          "prefill_chunk": 16, "block_fusion": True}
    out = []
    for plan in (None, faults.FaultPlan([faults.FaultSpec("kernel:cuda.mlp_subblock")])):
        quarantine.reset()
        eng = ServingEngine(params, cfg, **kw)
        reqs = [eng.submit(p, 5) for p in prompts]
        with faults.active(plan):
            eng.drain()
        out.append([r.output().tolist() for r in reqs])
    assert out[0] == out[1] and quarantine.is_quarantined("cuda.mlp_subblock")


# ---------------------------------------------------------------------------
# ROADMAP C.2: clip_grad_norm on integer leaves, a difference held exactly
# ---------------------------------------------------------------------------

def test_clip_grad_norm_integer_leaves_differ_from_reference_as_recorded():
    """The reference counts every leaf with a dtype in the norm and clips
    it, truncating an integer leaf (its docstring says "every float leaf");
    the port counts floating leaves only, passes the others through, and
    raises on a tree without one (ROADMAP C, known differences)."""
    g, i = np.ones(4, np.float32), np.arange(3, dtype=np.int32)
    jclipped, jnorm = tt.jit(lambda t: joptim.clip_grad_norm(t, 1.0))({"g": g, "i": i})
    assert float(jnorm) == 3.0
    np.testing.assert_array_equal(np.asarray(jclipped["i"]), [0, 0, 0])
    np.testing.assert_allclose(np.asarray(jclipped["g"]), g / 3.0, rtol=1e-6)
    tclipped, tnorm = toptim.clip_grad_norm({"g": torch.from_numpy(g), "i": torch.from_numpy(i)},
                                            1.0)
    assert float(tnorm) == 2.0
    assert torch.equal(tclipped["i"], torch.from_numpy(i))
    torch.testing.assert_close(tclipped["g"], torch.from_numpy(g) / 2.0, rtol=1e-6, atol=0)

    ints = {"i": np.arange(3, dtype=np.int32)}
    _, jn = tt.jit(lambda t: joptim.clip_grad_norm(t, 1.0))(ints)
    assert float(jn) == pytest.approx(2.236, abs=5e-4)
    with pytest.raises(ValueError, match="no floating gradient"):
        toptim.clip_grad_norm({k: torch.from_numpy(v) for k, v in ints.items()}, 1.0)


def test_fused_adamw_health_plain_counts():
    """The health pass's plain twin: non-finite grads, the float32 sum of
    g*g, and the non-finite p', m', v' as stored (a bf16 p' that overflows
    on rounding counts), into a float64 accumulator; nothing is stored."""
    ps = [torch.tensor([1.0, 2.0, 3.0e38], dtype=torch.float32).to(torch.bfloat16),
          torch.ones(5)]
    gs = [torch.tensor([1.0, float("nan"), 0.5]).to(torch.bfloat16), torch.full((5,), 2.0)]
    ms = [torch.zeros(3), torch.zeros(5)]
    vs = [torch.zeros(3), torch.zeros(5)]
    before = [t.clone() for t in ps + ms + vs]
    acc = torch.zeros(3, dtype=torch.float64)
    bc = torch.tensor([0.1, 0.001])
    toptim_ops.fused_adamw_health(ps, gs, ms, vs, bc, acc, lr=-1e38, beta1=0.9, beta2=0.999,
                                  eps=1e-8, weight_decay=0.0)
    nf_g, ss, nf_s = acc.tolist()
    assert nf_g == 1.0 and np.isnan(ss)
    assert nf_s >= 3.0   # the NaN g's p', m', v', and the overflowing p' of 3e38
    assert all(torch.equal(a, b) for a, b in zip(before, ps + ms + vs))


def test_planned_train_step_falls_back_to_the_per_op_mlp():
    """With ``cuda.mlp_subblock`` quarantined the planned train step runs
    as the per-op rung (no sub-block kernel forward or backward; the
    residual adds folded into ``rms_norm_residual``, two a layer): the same
    float32 loss and gradients as the planned step."""
    from thunder_tpu_torch.benchmarks import pretrain

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 16, 0))
    want_loss, want = pretrain.loss_and_grads(params, tok, tgt, cfg, block_fusion=True)
    quarantine.get_quarantine().add("cuda.mlp_subblock")
    faults.reset_claim_calls()
    loss, grads = pretrain.loss_and_grads(params, tok, tgt, cfg, block_fusion=True)
    calls = faults.claim_calls()
    assert "cuda.mlp_subblock" not in calls and "cuda.mlp_subblock_bwd" not in calls
    assert calls["cuda.rms_norm_residual"] == 4 and calls["cuda.rms_norm"] == 1
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for a, b in zip(toptim.tree_leaves(grads), toptim.tree_leaves(want)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
