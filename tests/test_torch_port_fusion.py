"""thunder_tpu_torch's planner — the block, horizontal and optimizer passes
and the decisions they record — against the JAX package's, on the CPU.

- **Trace parity.** Before fusion, the port's and the reference's traces of
  tiny-gqa's ``loss_fn`` hold the same symbol ids in the same order (the
  routers ``rms_norm_residual`` and ``linear_act`` record the unfused ops the
  reference's layer traces).
- **The planned step.** ``pretrain.jit_train_step(..., block_fusion=True)``
  (and its ``value_and_grad``) against ``tt.jit(train_step,
  block_fusion=True)`` with Pallas in interpret mode, tiny-gqa at 4 layers,
  B=2, T=16, float32, ``AdamW(lr=1e-3)``: the loss 1e-5 relative and
  gradients 1e-6 absolute (max |g| ~0.1), as ``test_torch_port_planned.py``
  holds the eager planned step; after two compiled steps the losses 1e-5
  relative, m 1e-5 and v 2e-5 of each leaf's largest magnitude and the
  parameters within 0.2 lr, as ``test_torch_port_jit_train.py`` holds the
  compiled per-op step (v moves by (1 - beta2) g^2, so a gradient's
  relative error doubles in it; a noise-level gradient takes a
  noise-decided Adam step). The planned trace
  holds L ``mlp_subblock`` and L ``mlp_subblock_bwd``, which the torch
  executor runs whole through the plain versions.
- **Claims.** For ``FakeTensor`` stand-ins on ``cuda:0``, the port's claims
  of that step equal the reference's interpret-mode claims, forced and
  unset (unset, the cost model keeps tiny shapes per-op in both).
- **Planner decisions** (after ``tests/test_block_planner.py``): an
  escaping interior, cost-rejected tiny shapes, the registered kinds only,
  the counter and the marker, a quarantined ``cuda.mlp_subblock`` that
  recompiles to the per-op rung, and a chain the kernel refuses; the
  memory-bound claims taken with no cost gate, at decode and prefill rows.
- **Horizontal and optimizer fusion** (after ``tests/test_fusion_passes.py``):
  a forced merge with the reference's values, a sibling whose operand is
  not yet defined left alone; dtype buckets, a bucket of one left as its
  ``adamw_step``, an interleaved consumer, ``fused_optimizer=False``.
- **The bridge.** ``jit(PlainLlama, block_fusion=True)`` plans, and its
  ``.grad``s match eager autograd's (1e-5 of each leaf's largest value).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
import torch.nn.functional as F

import jax

import thunder_tpu as tt
from thunder_tpu import ops as jops
from thunder_tpu.models import llama as jllama
from thunder_tpu.optim import AdamW as JAdamW
from thunder_tpu.runtime import quarantine as jquarantine
import thunder_tpu_torch as ptt
from thunder_tpu_torch import observe
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.core.fusion_passes import BLOCK_DECISION_KINDS
from thunder_tpu_torch.core.pytree import tree_map
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import AdamW, tree_leaves
from thunder_tpu_torch.runtime import quarantine as tquarantine
from thunder_tpu_torch.testing import PlainLlama, claimed_kernels, with_regions

LAYERS, B, T, LR, STEPS = 4, 2, 16, 1e-3, 2
EPS = 1e-5


@pytest.fixture(autouse=True)
def _clean_quarantines():
    jquarantine.reset()
    tquarantine.reset()
    yield
    jquarantine.reset()
    tquarantine.reset()


_FAKE = FakeTensorMode()


def _on_cuda(t):
    """A stand-in for ``t`` on ``cuda:0``: its shape and dtype, no storage."""
    return FakeTensor(_FAKE, torch.empty(t.shape, dtype=t.dtype, device="meta"),
                      torch.device("cuda:0"))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _names(trc) -> list[str]:
    return [b.sym.name for b in trc.bound_symbols]


def _block_decisions(jf) -> list[dict]:
    return [d for d in ptt.compile_stats(jf).last_decisions if d["kind"] == "block"]


# ---------------------------------------------------------------------------
# trace parity at the planner's anchor
# ---------------------------------------------------------------------------

def test_loss_fn_traces_the_reference_ops_before_fusion():
    jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
    jparams = jax.tree.map(np.asarray, jllama.init_params(jcfg, seed=0))
    rng = np.random.default_rng(0)
    tok, tgt = (rng.integers(0, jcfg.vocab_size, (B, T)) for _ in range(2))
    jf = tt.jit(lambda p, t, y: jllama.loss_fn(p, t, y, jcfg))
    jf(jparams, tok.astype(np.int32), tgt.astype(np.int32))
    pf = ptt.jit(lambda p, t, y: tllama.loss_fn(p, t, y, tcfg), device="cpu")
    pf(tllama.params_from_jax(jparams, device="cpu"), torch.from_numpy(tok),
       torch.from_numpy(tgt))
    want = [str(b.sym.id) for b in tt.last_traces(jf)[0].bound_symbols]
    got = [str(b.sym.id) for b in ptt.last_traces(pf)[0].bound_symbols]
    assert got == want
    L = jcfg.n_layers
    assert got.count("nn.rms_norm") == 2 * L + 1 and got.count("ops.silu") == L
    assert "nn.rms_norm_residual" not in got and "nn.linear_act" not in got


# ---------------------------------------------------------------------------
# the planned step against tt.jit(train_step, block_fusion=True)
# ---------------------------------------------------------------------------

def _jtrain_step(jcfg, jopt):
    def train_step(params, opt_state, tokens, targets):
        loss, grads = tt.value_and_grad(
            lambda p: jllama.loss_fn(p, tokens, targets, jcfg))(params)
        return loss, *jopt.update(params, grads, opt_state)

    return train_step


@pytest.fixture(scope="module")
def planned():
    mp = pytest.MonkeyPatch()
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    try:
        jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
        jparams = jllama.init_params(jcfg, seed=0, scale_layers=LAYERS)
        jopt, topt = JAdamW(lr=LR), AdamW(lr=LR)
        jstate = jopt.init(jparams)
        tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, B, T, seed=0)
        jtok, jtgt = tok.astype(np.int32), tgt.astype(np.int32)
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)

        def port_tree(tree):
            return tllama.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

        jgrad = tt.jit(tt.value_and_grad(lambda p, a, b: jllama.loss_fn(p, a, b, jcfg)),
                       block_fusion=True)
        j0 = jgrad(jparams, jtok, jtgt)
        tgrad = ptt.jit(ptt.value_and_grad(lambda p, a, b: tllama.loss_fn(p, a, b, tcfg)),
                        device="cpu", block_fusion=True)
        t0 = tgrad(port_tree(jparams), ttok, ttgt)

        jstep = tt.jit(_jtrain_step(jcfg, jopt), block_fusion=True)
        tstep = pretrain.jit_train_step(tcfg, topt, block_fusion=True)
        jp, js = jparams, jstate
        tp = port_tree(jparams)
        ts = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        jl, tl = [], []
        for _ in range(STEPS):
            loss, jp, js = jstep(jp, js, jtok, jtgt)
            jl.append(float(loss))
            loss, tp, ts = tstep(tp, ts, ttok, ttgt)
            tl.append(float(loss))
        return dict(j0=j0, t0=t0, jl=jl, tl=tl, jp=jp, js=js, tp=tp, ts=ts, jstep=jstep,
                    tstep=tstep, tgrad=tgrad, tcfg=tcfg, topt=topt, jcfg=jcfg, jopt=jopt,
                    batch=(ttok, ttgt), port_tree=port_tree, jparams=jparams)
    finally:
        mp.undo()


def test_planned_loss_and_grads_match_reference(planned):
    (jl, jg), (tl, tg) = planned["j0"], planned["t0"]
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jleaves, tleaves = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 3 + 9 * LAYERS
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), atol=1e-6, rtol=0)


def _leaf_close(got, want, rel):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, atol=rel * scale, rtol=0)


def test_planned_steps_match_reference(planned):
    np.testing.assert_allclose(planned["tl"], planned["jl"], rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(planned["jp"]), tree_leaves(planned["tp"])):
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), atol=0.2 * LR, rtol=0)
    for key, rel in (("m", 1e-5), ("v", 2e-5)):
        for a, b in zip(jax.tree_util.tree_leaves(planned["js"][key]),
                        tree_leaves(planned["ts"][key])):
            _leaf_close(b, a, rel)


def test_planned_trace_holds_the_sub_block_pair(planned):
    for jf in (planned["tgrad"], planned["tstep"]):
        names = _names(ptt.last_execution_trace(jf))
        assert names.count("mlp_subblock") == LAYERS
        assert names.count("mlp_subblock_bwd") == LAYERS
        assert [d["decision"] for d in _block_decisions(jf)] == ["planned"] * LAYERS
    # the step's update went through the optimizer pass: one bucket
    assert _names(ptt.last_execution_trace(planned["tstep"])).count("fused_adamw") == 1


def _reference_claims(trc) -> dict[str, int]:
    out: dict[str, int] = {}

    def walk(bsyms):
        for b in bsyms:
            name = b.sym.codegen_name()
            if name.startswith("pallas_"):
                key = name.removeprefix("pallas_")
                out[key] = out.get(key, 0) + 1
            walk(b.subsymbols)

    walk(trc.bound_symbols)
    return out


def _port_claims(trc) -> dict[str, int]:
    got: dict[str, int] = {}
    for b in trc.bound_symbols:
        if b.sym.executor is not None and b.sym.executor.name == "cuda":
            got[b.sym.name] = got.get(b.sym.name, 0) + 1
    return got


@pytest.mark.parametrize("block_fusion", [True, None], ids=["forced", "unset"])
def test_claims_match_reference_for_cuda_inputs(planned, block_fusion, monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    L = LAYERS
    opts = {} if block_fusion is None else {"block_fusion": block_fusion}
    if block_fusion:
        jstep = planned["jstep"]
    else:
        jstep = tt.jit(_jtrain_step(planned["jcfg"], planned["jopt"]))
        jparams = planned["jparams"]
        tok, tgt = (t.numpy().astype(np.int32) for t in planned["batch"])
        jstep(jparams, planned["jopt"].init(jparams), tok, tgt)
    want = _reference_claims(tt.last_traces(jstep)[-2])
    if block_fusion:
        assert want == {"rms_norm": L + 1, "sdpa_fwd": L, "mlp_subblock": L, "sdpa_bwd": L,
                        "mlp_subblock_bwd": L, "ce_fwd": 1, "fused_adamw": 1}
    else:
        assert want == {"rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L,
                        "sdpa_bwd": L, "ce_fwd": 1, "fused_adamw": 1}
    tcfg, topt = planned["tcfg"], planned["topt"]
    params = planned["port_tree"](planned["jparams"])
    step = pretrain.jit_train_step(tcfg, topt, **opts)
    step.compile(*tree_map(_on_cuda, (params, topt.init(params), *planned["batch"])))
    trc = ptt.last_execution_trace(step)
    assert _port_claims(trc) == want
    assert claimed_kernels(trc) == with_regions(trc, want)
    kinds = [d["decision"] for d in _block_decisions(step)]
    assert kinds == (["planned"] * L if block_fusion else ["cost-rejected"] * L)


# ---------------------------------------------------------------------------
# planner decisions
# ---------------------------------------------------------------------------

def _chain(r, x, wn, wg, wu, wd):
    """The MLP sub-block chain in plain PyTorch."""
    h = r + x
    n = F.rms_norm(h, (h.shape[-1],), wn, EPS)
    return h + F.linear(F.silu(F.linear(n, wg)) * F.linear(n, wu), wd)


def _chain_inputs(N=16, D=32, Fd=48, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    return (rnd(N, D), rnd(N, D), rnd(D) + 1.0, rnd(Fd, D, scale=D ** -0.5),
            rnd(Fd, D, scale=D ** -0.5), rnd(D, Fd, scale=Fd ** -0.5))


def test_planner_plans_when_forced_and_matches_eager():
    args = _chain_inputs()
    jf = ptt.jit(_chain, device="cpu", block_fusion=True)
    got = jf(*args)
    assert "mlp_subblock" in _names(ptt.last_execution_trace(jf))
    torch.testing.assert_close(got, _chain(*args), rtol=1e-5, atol=1e-5)
    assert "block_fusion [set]" in ptt.last_compile_options(jf)


def test_planner_rejects_escaping_interior():
    args = _chain_inputs(seed=4)

    def f(r, x, wn, wg, wu, wd):
        h = r + x
        n = F.rms_norm(h, (h.shape[-1],), wn, EPS)
        return h + F.linear(F.silu(F.linear(n, wg)) * F.linear(n, wu), wd), n   # n escapes

    jf = ptt.jit(f, device="cpu", block_fusion=True)
    out, _ = jf(*args)
    assert "mlp_subblock" not in _names(ptt.last_execution_trace(jf))
    assert any(d["decision"] == "interior-escapes" for d in _block_decisions(jf))
    torch.testing.assert_close(out, _chain(*args), rtol=1e-5, atol=1e-5)


def test_planner_cost_rejects_tiny_shapes_by_default():
    args = _chain_inputs(seed=5)
    jf = ptt.jit(_chain, device="cpu")
    jf(*args)
    assert "mlp_subblock" not in _names(ptt.last_execution_trace(jf))
    rejected = [d for d in _block_decisions(jf) if d["decision"] == "cost-rejected"]
    assert rejected
    assert {"saved_boundary_bytes", "est_saved_us", "backward"} <= set(rejected[0]["cost"])
    assert rejected[0]["cost"]["backward"] is False
    assert "block_fusion [default]" in ptt.last_compile_options(jf)


def test_planner_records_registered_kinds_only_with_counter_and_marker():
    assert "vmem-infeasible" not in BLOCK_DECISION_KINDS
    assert set(BLOCK_DECISION_KINDS) == {"planned", "interior-escapes", "cost-rejected",
                                         "unclaimed", "rebuild-mismatch", "chained",
                                         "chain-blocked"}
    observe.enable(clear=True)
    try:
        jf = ptt.jit(_chain, device="cpu", block_fusion=True)
        jf(*_chain_inputs(seed=6))
        counters = observe.snapshot()["counters"]
    finally:
        observe.disable()
        observe.reset()
    assert counters.get("fusion.block_fusions") == 1
    assert "block fusion: 8-op MLP sub-block chain planned as one kernel" in \
        ptt.last_execution_trace(jf).python()
    for d in ptt.compile_stats(jf).last_decisions:
        if d["kind"] == "block":
            assert d["decision"] in BLOCK_DECISION_KINDS
    assert "decisions recorded" in ptt.compile_stats(jf).summary()


def test_quarantined_sub_block_recompiles_to_the_per_op_rung(planned):
    """On the card a quarantined claim is not planned (the port runs no
    decomposition in a kernel's place): the quarantine epoch in the guard
    key recompiles the forced step to the per-op rung's claims."""
    tcfg, topt, L = planned["tcfg"], planned["topt"], LAYERS
    params = planned["port_tree"](planned["jparams"])
    fake = tree_map(_on_cuda, (params, topt.init(params), *planned["batch"]))
    step = pretrain.jit_train_step(tcfg, topt, block_fusion=True)
    step.compile(*fake)
    assert claimed_kernels(ptt.last_execution_trace(step))["mlp_subblock"] == L
    tquarantine.get_quarantine().add("cuda.mlp_subblock", reason="test", phase="runtime")
    step.compile(*fake)
    assert ptt.cache_misses(step) == 2
    trc = ptt.last_execution_trace(step)
    assert claimed_kernels(trc) == with_regions(trc, {
        "rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L, "sdpa_bwd": L, "ce_fwd": 1,
        "fused_adamw": 1})
    unclaimed = [d for d in _block_decisions(step) if d["decision"] == "unclaimed"]
    assert len(unclaimed) == L and "quarantined" in unclaimed[0]["reason"]


def test_chain_the_kernel_refuses_is_unclaimed():
    """F = 44 is no multiple of 8: the sub-block kernel refuses the chain,
    which keeps the per-op rung, recorded with the refusal's text."""
    args = [_on_cuda(a) for a in _chain_inputs(D=32, Fd=44)]
    jf = ptt.jit(_chain, block_fusion=True)
    jf.compile(*args)
    assert "mlp_subblock" not in _names(ptt.last_execution_trace(jf))
    (d,) = _block_decisions(jf)
    assert d["decision"] == "unclaimed" and "multiples of 8" in d["reason"]


@pytest.mark.parametrize("rows", [4, 2048], ids=["decode-rows", "prefill-rows"])
def test_memory_bound_claims_have_no_cost_gate(rows):
    """Every legal claim is taken on the card, however few bytes it moves:
    the reference's claim gate weighs a claim against an XLA fusion region,
    which the port does not have yet, so its ``fusion_cost_model`` option
    is read by nothing and reported so."""
    def f(x, w):
        return F.rms_norm(x, (x.shape[-1],), w, EPS)

    args = (_on_cuda(torch.empty(rows, 4096, device="meta")),
            _on_cuda(torch.empty(4096, device="meta")))
    jf = ptt.jit(f, fusion_cost_model=True)
    jf.compile(*args)
    assert _port_claims(ptt.last_execution_trace(jf)) == {"rms_norm": 1}
    assert not [d for d in ptt.compile_stats(jf).last_decisions
                if d["kind"] == "claim" and d["decision"] == "rejected"]
    opts = ptt.last_compile_options(jf)
    assert "passed but never queried" in opts and "fusion_cost_model" in opts


# ---------------------------------------------------------------------------
# horizontal fusion
# ---------------------------------------------------------------------------

def test_horizontal_merge_when_forced_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    ws = [rng.standard_normal((n, 16)).astype(np.float32) for n in (16, 8, 8)]

    def f(x, wq, wk, wv):
        return F.linear(x, wq), F.linear(x, wk), F.linear(x, wv)

    def jf_(x, wq, wk, wv):
        return jops.linear(x, wq), jops.linear(x, wk), jops.linear(x, wv)

    want = tt.jit(jf_, horizontal_fusion=True)(x, *ws)
    merged = ptt.jit(f, device="cpu", horizontal_fusion=True)
    got = merged(*(torch.from_numpy(a) for a in (x, *ws)))
    trc = ptt.last_execution_trace(merged)
    assert "horizontal fusion: merged 3 sibling dot_generals (widths 16+8+8)" in trc.python()
    assert _names(trc).count("dot_general") == 1
    unmerged = ptt.jit(f, device="cpu", horizontal_fusion=False)
    plain = unmerged(*(torch.from_numpy(a) for a in (x, *ws)))
    assert _names(ptt.last_execution_trace(unmerged)).count("dot_general") == 3
    for g, w, p in zip(got, want, plain):   # float32 sums of 16 products, in any order
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(_np(g), _np(p), atol=1e-6, rtol=1e-6)
    (d,) = [d for d in ptt.compile_stats(merged).last_decisions if d["op"] == "horizontal_merge"]
    assert d["decision"] == "merged" and d["cost"]["widths"] == [16, 8, 8]


def test_horizontal_merge_skips_unavailable_operands():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w1 = rng.standard_normal((8, 8)).astype(np.float32)

    def f(x, w1):
        a = F.linear(x, w1)
        w2 = (a.T @ a) * 0.01   # depends on a
        return a + F.linear(x, w2)

    def jf_(x, w1):
        a = jops.linear(x, w1)
        w2 = jops.mul(jops.transpose(a, (1, 0)) @ a, 0.01)
        return jops.add(a, jops.linear(x, w2))

    got = ptt.jit(f, device="cpu", horizontal_fusion=True)(torch.from_numpy(x),
                                                           torch.from_numpy(w1))
    want = tt.jit(jf_, horizontal_fusion=True)(x, w1)
    a = x @ w1.T
    np.testing.assert_allclose(_np(got), a + x @ ((a.T @ a) * 0.01).T, atol=1e-4)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# optimizer fusion
# ---------------------------------------------------------------------------

def _mixed_params(seed=12):
    rng = np.random.default_rng(seed)
    return {"wf1": rng.standard_normal((16, 8)).astype(np.float32),
            "wf2": rng.standard_normal((8,)).astype(np.float32),
            "wb1": rng.standard_normal((8, 8)).astype(np.float32),
            "wb2": rng.standard_normal((24,)).astype(np.float32)}


def test_fused_optimizer_dtype_buckets_match_reference():
    import jax.numpy as jnp
    from thunder_tpu.core import dtypes as jdtypes

    raw = _mixed_params()
    jparams = {k: (jnp.asarray(v, jnp.bfloat16) if k.startswith("wb") else v)
               for k, v in raw.items()}
    jgrads = jax.tree_util.tree_map(lambda p: (p * 0.1).astype(p.dtype), jparams)
    jopt = JAdamW(lr=1e-2, state_dtype=jdtypes.bfloat16)
    want_p, _ = tt.jit(lambda p, g, s: jopt.update(p, g, s))(jparams, jgrads,
                                                               jopt.init(jparams))
    tparams = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if k.startswith("wb") else torch.float32) for k, v in raw.items()}
    tgrads = {k: (v * 0.1).to(v.dtype) for k, v in tparams.items()}
    topt = AdamW(lr=1e-2, state_dtype=torch.bfloat16)
    jf = ptt.jit(lambda p, g, s: topt.update(p, g, s), device="cpu")
    got_p, _ = jf(tparams, tgrads, topt.init(tparams))
    names = _names(ptt.last_execution_trace(jf))
    assert names.count("fused_adamw") == 2 and names.count("adamw_step") == 0
    bucketed = [d for d in ptt.compile_stats(jf).last_decisions if d["decision"] == "bucketed"]
    assert len(bucketed) == 2
    assert {"tensors", "total_bytes", "saved_launches"} <= set(bucketed[0]["cost"])
    for k in raw:
        tol = 1e-5 if k.startswith("wf") else 2 ** -7
        np.testing.assert_allclose(_np(got_p[k]), np.asarray(want_p[k], np.float32),
                                   atol=tol, rtol=tol)


def test_singleton_bucket_keeps_its_adamw_step_and_fused_optimizer_false():
    raw = _mixed_params(13)
    tparams = {"w": torch.from_numpy(raw["wf1"]),
               "b": torch.from_numpy(raw["wb2"]).to(torch.bfloat16)}
    tgrads = {k: (v * 0.1).to(v.dtype) for k, v in tparams.items()}
    topt = AdamW(lr=1e-2)
    single = ptt.jit(lambda p, g, s: topt.update(p, g, s), device="cpu")
    got, _ = single(tparams, tgrads, topt.init(tparams))
    names = _names(ptt.last_execution_trace(single))
    assert names.count("fused_adamw") == 0 and names.count("adamw_step") == 2
    reasons = {d["reason"] for d in ptt.compile_stats(single).last_decisions
               if d["op"] == "optim.fused_adamw"}
    assert reasons == {"singleton dtype bucket: nothing to amortize"}
    params = {"a": torch.from_numpy(raw["wf1"]), "b": torch.from_numpy(raw["wf2"])}
    grads = {k: v * 0.1 for k, v in params.items()}
    off = ptt.jit(lambda p, g, s: topt.update(p, g, s), device="cpu", fused_optimizer=False)
    off_p, _ = off(params, grads, topt.init(params))
    names = _names(ptt.last_execution_trace(off))
    assert names.count("fused_adamw") == 0 and names.count("adamw_step") == 2
    on = ptt.jit(lambda p, g, s: topt.update(p, g, s), device="cpu")
    on_p, _ = on(params, grads, topt.init(params))
    assert _names(ptt.last_execution_trace(on)).count("fused_adamw") == 1
    for k in params:
        torch.testing.assert_close(on_p[k], off_p[k], rtol=0, atol=0)


def test_interleaved_consumer_rejects_the_bucket():
    from thunder_tpu_torch.ops.optim import adamw_step
    from thunder_tpu_torch.torch import on_torch

    step = on_torch(adamw_step)
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)

    def f(p1, p2, g1, g2, m1, m2, v1, v2, bc):
        a = step(p1, g1, m1, v1, bc[0], bc[1], **hyper)
        between = a[0] * 2.0   # reads the first member's output before the second step
        b = step(p2, g2, m2, v2, bc[0], bc[1], **hyper)
        return a, b, between

    g = torch.Generator().manual_seed(3)
    ts = [torch.randn(8, 4, generator=g) for _ in range(8)]
    bc = torch.tensor([0.1, 0.001])
    jf = ptt.jit(f, device="cpu")
    jf(*ts, bc)
    names = _names(ptt.last_execution_trace(jf))
    assert names.count("fused_adamw") == 0 and names.count("adamw_step") == 2
    (d,) = [d for d in ptt.compile_stats(jf).last_decisions if d["op"] == "optim.fused_adamw"]
    assert d["decision"] == "rejected" and "interleaved" in d["reason"]


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def test_plain_llama_bridge_plans_and_matches_eager_autograd():
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, B, T, 0))
    m = PlainLlama.from_llama_params(cfg, params)
    import copy

    mp = copy.deepcopy(m)
    tm = ptt.jit(mp, device="cpu", block_fusion=True)
    want, got = m(tok, tgt), tm(tok, tgt)
    want.backward()
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    step = next(iter(tm._autograd_cache.values()))
    assert _names(step.fwd_trace).count("mlp_subblock") == 2
    assert _names(step.bwd_trace).count("mlp_subblock_bwd") == 2
    assert [d["decision"] for d in _block_decisions(tm)] == ["planned"] * 2
    for (_, p), (_, q) in zip(m.named_parameters(), mp.named_parameters()):
        want_g = p.grad.numpy()
        scale = max(float(np.abs(want_g).max()), 1e-30)
        np.testing.assert_allclose(q.grad.numpy(), want_g, atol=1e-5 * scale, rtol=0)
