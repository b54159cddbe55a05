"""thunder_tpu_torch's training slice against the JAX package, on the CPU.

Kernel functions: each new plain version (``sdpa_fwd``, ``sdpa_bwd``,
``ce_fwd``, ``fused_adamw``) against the Pallas kernel it stands for, run in
interpret mode as the JAX package's own tests run it, and against the JAX
``ops`` decomposition, on the same numpy inputs; the autograd functions
against the JAX package's VJP rules.

The slice: a 2-layer float32 tiny-gqa train step (``loss_fn``, its
gradients, ``AdamW``) of the port against ``tt.jit(train_step,
block_fusion=False)`` with the same weights and optimizer state, carried
across with ``params_from_jax`` and ``AdamW.state_from_jax``.

Tolerances (float32 throughout):
- attention and cross-entropy values 1e-5: the same operations summed in
  another order; attention gradients 1e-5 absolute at unit-scale inputs;
- AdamW 4 ULP of the stored dtype, the bound the JAX suite pins between the
  Pallas kernel and the per-op chain (XLA contracts mul+add into FMAs);
- the train step: loss 1e-5 relative, gradients 1e-6 absolute (max |g| is
  ~0.1), moments m 1e-6 and v 1e-9 absolute. Parameters after 3 AdamW steps
  at lr 1e-3: 2e-4 absolute (0.2 lr). An element whose gradient lies within
  float32 summation noise of zero takes an Adam step whose sign and size that
  noise decides (|m_hat / sqrt(v_hat)| <= 1 per step), so such elements can
  differ by up to lr per step; all others agree to ~1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import thunder_tpu as tt
from thunder_tpu.executors import pallasex as px
from thunder_tpu.models import llama as jllama
from thunder_tpu import ops as jops
from thunder_tpu.ops import nn as jnn
from thunder_tpu.optim import AdamW as JAdamW
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.ops import optim as toptim_ops
from thunder_tpu_torch.optim import AdamW, tree_leaves
from thunder_tpu_torch.testing import row_rel_err, ulp_distance

N_LAYERS = 2
LR = 1e-3
STEPS = 3


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")


def _xla(fn, *args):
    """The JAX decomposition of ``fn``, traced with no kernel executor."""
    out = tt.jit(fn, executors=["xla"])(*args)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# attention forward / backward
# ---------------------------------------------------------------------------

def _attn_inputs(seed, T, S, B=1, H=2, hd=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, T, hd).astype(np.float32)
    k = rng.randn(B, H, S, hd).astype(np.float32)
    v = rng.randn(B, H, S, hd).astype(np.float32)
    g = rng.randn(B, H, T, hd).astype(np.float32)
    return q, k, v, g


# T=32: the causal resident variant and, non-causal, the grid-streamed one;
# T=1024: 512-row blocks (causal resident, non-causal streamed over 2 kv
# steps); T != S: the grid-streamed kernels with causal masking top-left
ATTN_CASES = [(32, 32, True), (32, 32, False), (1024, 1024, True), (1024, 1024, False),
              (64, 128, True), (128, 64, False)]
ATTN_IDS = [f"T{t}-S{s}-{'causal' if c else 'full'}" for t, s, c in ATTN_CASES]


@pytest.mark.parametrize("T,S,causal", ATTN_CASES, ids=ATTN_IDS)
def test_sdpa_fwd_matches_pallas_and_decomposition(T, S, causal, interpret):
    q, k, v, _ = _attn_inputs(0, T, S)
    out, lse = tnn.sdpa_fwd(_t(q), _t(k), _t(v), causal)
    p_out, p_lse = px.pallas_sdpa_fwd(q, k, v, is_causal=causal)
    r_out, r_lse = _xla(lambda a, b, c: jnn.sdpa_fwd(a, b, c, causal), q, k, v)
    for got, want in ((out, p_out), (lse, p_lse), (out, r_out), (lse, r_lse)):
        _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("T,S,causal", ATTN_CASES, ids=ATTN_IDS)
def test_sdpa_bwd_matches_pallas_and_decomposition(T, S, causal, interpret):
    q, k, v, g = _attn_inputs(1, T, S)
    r_out, r_lse = _xla(lambda a, b, c: jnn.sdpa_fwd(a, b, c, causal), q, k, v)
    got = tnn.sdpa_bwd(_t(g), _t(q), _t(k), _t(v), _t(r_out), _t(r_lse), causal)
    pallas = px.pallas_sdpa_bwd(g, q, k, v, r_out, r_lse, is_causal=causal)
    ref = _xla(lambda *a: jnn.sdpa_bwd(*a, is_causal=causal), g, q, k, v, r_out, r_lse)
    for mine, p, r in zip(got, pallas, ref):
        _close(mine.numpy(), p, 1e-5)
        _close(mine.numpy(), r, 1e-5)


def test_attention_autograd_matches_reference_vjp():
    """Gradients through ``scaled_dot_product_attention`` (the flash VJP:
    forward saves (q, k, v, out, lse), backward is sdpa_bwd) equal the JAX
    package's gradients of ``ops.scaled_dot_product_attention``."""
    q, k, v, g = _attn_inputs(2, 48, 48, B=2)

    def jloss(a, b, c, w):
        return jops.sum(jops.mul(jnn.scaled_dot_product_attention(a, b, c, is_causal=True),
                                     w))

    ref = tt.jit(tt.grad(jloss, argnums=(0, 1, 2)), executors=["xla"])(q, k, v, g)
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    (tnn.scaled_dot_product_attention(qt, kt, vt, is_causal=True) * _t(g)).sum().backward()
    for mine, want in zip((qt.grad, kt.grad, vt.grad), ref):
        _close(mine.numpy(), np.asarray(want), 1e-5)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------

def _ce_inputs(seed, N=24, V=200):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(N, V) * 3).astype(np.float32)
    target = rng.randint(0, V, size=N).astype(np.int32)
    target[[1, 7, 8]] = -100
    return logits, target


def test_ce_fwd_matches_pallas_and_decomposition(interpret):
    logits, target = _ce_inputs(3)
    nll, lse = tnn.ce_fwd(_t(logits), _t(target))
    p_nll, p_lse = px.pallas_ce_fwd(logits, target)
    r_nll, r_lse = _xla(lambda a, b: jnn.ce_fwd(a, b), logits, target)
    for got, want in ((nll, p_nll), (lse, p_lse), (nll, r_nll), (lse, r_lse)):
        _close(got.numpy(), want, 1e-5)
    assert float(nll[1]) == 0.0 and float(lse[1]) > 0.0   # ignored row keeps its lse


def test_cross_entropy_loss_and_grad_match_reference_vjp():
    logits, target = _ce_inputs(4)
    ref_loss, ref_grad = tt.jit(tt.value_and_grad(lambda a: jnn.cross_entropy(a, target)),
                                executors=["xla"])(logits)
    lt = _t(logits).requires_grad_(True)
    loss = tnn.cross_entropy(lt, _t(target))
    loss.backward()
    _close(loss.detach().numpy(), np.asarray(ref_loss), 1e-6)
    _close(lt.grad.numpy(), np.asarray(ref_grad), 1e-7)
    assert float(lt.grad[7].abs().sum()) == 0.0            # ignored rows get no gradient


# ---------------------------------------------------------------------------
# rms_norm gradients (the reference's _rms_norm_vjp, plain on both sides)
# ---------------------------------------------------------------------------

def test_rms_norm_and_residual_grads_match_reference():
    rng = np.random.RandomState(5)
    r, x, g = (rng.randn(2, 8, 64).astype(np.float32) for _ in range(3))
    w = (rng.rand(64) + 0.5).astype(np.float32)

    def jloss(r_, x_, w_):
        h = jops.add(r_, x_)
        y = jnn.rms_norm(h, w_, eps=1e-5)
        return jops.add(jops.sum(jops.mul(y, g)), jops.sum(jops.mul(h, h)))

    ref = tt.jit(tt.grad(jloss, argnums=(0, 1, 2)), executors=["xla"])(r, x, w)
    rt, xt, wt = (_t(a).requires_grad_(True) for a in (r, x, w))
    h, y = tnn.rms_norm_residual(rt, xt, wt)
    ((y * _t(g)).sum() + (h * h).sum()).backward()
    for mine, want in zip((rt.grad, xt.grad, wt.grad), ref):
        _close(mine.numpy(), np.asarray(want), 1e-5)

    xt2, wt2 = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    (tnn.rms_norm(xt2, wt2) * _t(g)).sum().backward()
    ref2 = tt.jit(tt.grad(lambda a, b: jops.sum(jops.mul(jnn.rms_norm(a, b, eps=1e-5), g)),
                          argnums=(0, 1)), executors=["xla"])(x, w)
    _close(xt2.grad.numpy(), np.asarray(ref2[0]), 1e-5)
    _close(wt2.grad.numpy(), np.asarray(ref2[1]), 1e-5)


# ---------------------------------------------------------------------------
# fused AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=["f32", "bf16"])
def test_fused_adamw_matches_pallas(dtype, interpret):
    """Three steps of pallas_fused_adamw on one bucket with fixed gradients
    (as the JAX suite's parity test drives it: no step cancels m or v to
    near zero, where a distance in ULPs of the result says nothing); at each
    step the port's bucket update, from the same (p, g, m, v), gives params,
    m and v within 4 ULP of their stored dtype."""
    rng = np.random.RandomState(6)
    shapes = [(16, 8), (16,), (8, 16), (37,)]
    jd = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    ps = [jnp.asarray(rng.randn(*s).astype(np.float32), jd) for s in shapes]
    ms = [jnp.zeros(s, jnp.float32) for s in shapes]
    vs = [jnp.zeros(s, jnp.float32) for s in shapes]
    gs = [jnp.asarray(rng.randn(*s).astype(np.float32), jd) for s in shapes]
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    conv = lambda xs: [tllama._tensor_from_numpy(np.asarray(x)) for x in xs]   # noqa: E731
    for step in range(1, 4):
        tp, tg, tm, tv = conv(ps), conv(gs), conv(ms), conv(vs)
        bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
        ps, ms, vs = px.pallas_fused_adamw(ps, gs, ms, vs, np.float32(bc1), np.float32(bc2),
                                           **hyper)
        toptim_ops.fused_adamw(tp, tg, tm, tv, torch.tensor([bc1, bc2], dtype=torch.float32),
                               **hyper)
        for mine, want in zip(tp + tm + tv, conv(ps) + conv(ms) + conv(vs)):
            assert ulp_distance(mine, want) <= 4


def test_adamw_state_round_trip_and_defaults():
    opt = AdamW()
    assert (opt.lr, opt.beta1, opt.beta2, opt.eps, opt.weight_decay) == \
        (1e-3, 0.9, 0.999, 1e-8, 0.01)
    assert opt.state_dtype == torch.float32 and opt.v_dtype == torch.float32
    jcfg = jllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(jcfg, seed=1, scale_layers=1)
    jstate = jax.tree.map(np.asarray, JAdamW().init(jparams))
    st = opt.state_from_jax(jstate, device="cpu")
    assert float(st["step"]) == 0.0 and st["step"].dtype == torch.float32
    for a, b in zip(jax.tree_util.tree_leaves(jstate["m"]), tree_leaves(st["m"])):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32


# ---------------------------------------------------------------------------
# the slice: tiny-gqa train step, port vs tt.jit(train_step, block_fusion=False)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_runs():
    """Both packages from the same weights and batch: gradients at the
    initial weights, then STEPS train steps (losses, final params and
    state). The JAX step runs its Pallas claims in interpret mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    try:
        jcfg = jllama.CONFIGS["tiny-gqa"]
        tcfg = tllama.CONFIGS["tiny-gqa"]
        jparams = jllama.init_params(jcfg, seed=0, scale_layers=N_LAYERS)
        jopt = JAdamW(lr=LR)
        jstate = jopt.init(jparams)
        tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, 2, 64, seed=0)
        jtok, jtgt = tok.astype(np.int32), tgt.astype(np.int32)

        def train_step(params, opt_state, tokens, targets):
            loss, grads = tt.value_and_grad(
                lambda p: jllama.loss_fn(p, tokens, targets, jcfg))(params)
            return loss, *jopt.update(params, grads, opt_state)

        jgrad_fn = tt.jit(tt.value_and_grad(lambda p, a, b: jllama.loss_fn(p, a, b, jcfg)),
                          block_fusion=False)
        j0_loss, j0_grads = jgrad_fn(jparams, jtok, jtgt)
        jstep = tt.jit(train_step, block_fusion=False)

        tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        topt = AdamW(lr=LR)
        tstate = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)
        t0_loss, t0_grads = pretrain.loss_and_grads(tparams, ttok, ttgt, tcfg)

        p, s, jl, tl = jparams, jstate, [], []
        for _ in range(STEPS):
            loss, p, s = jstep(p, s, jtok, jtgt)
            jl.append(float(loss))
            tl.append(float(pretrain.train_step(tparams, topt, tstate, ttok, ttgt, tcfg)))
        return {"j0": (float(j0_loss), j0_grads), "t0": (float(t0_loss), t0_grads),
                "jl": jl, "tl": tl, "jparams": p, "jstate": s, "tparams": tparams,
                "tstate": tstate, "jstep": jstep, "batch": (ttok, ttgt), "tcfg": tcfg}
    finally:
        mp.undo()


def test_train_step_loss_and_grads_match_reference(train_runs):
    (jl0, jg), (tl0, tg) = train_runs["j0"], train_runs["t0"]
    assert abs(tl0 - jl0) <= 1e-5 * abs(jl0)
    jleaves, tleaves = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 3 + 9 * N_LAYERS
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_train_steps_match_reference(train_runs):
    """Losses of every step, then params, moments and step count after
    STEPS steps of AdamW."""
    np.testing.assert_allclose(train_runs["tl"], train_runs["jl"], rtol=1e-5)
    assert train_runs["tl"][-1] < train_runs["tl"][0]
    pairs = zip(jax.tree_util.tree_leaves(train_runs["jparams"]),
                tree_leaves(train_runs["tparams"]))
    for a, b in pairs:
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)
    js, ts = train_runs["jstate"], train_runs["tstate"]
    for key, tol in (("m", 1e-6), ("v", 1e-9)):
        for a, b in zip(jax.tree_util.tree_leaves(js[key]), tree_leaves(ts[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol, rtol=0)
    assert float(ts["step"]) == float(np.asarray(js["step"])) == STEPS


# the Pallas ops the reference's per-op train step claims, counted per step
# at N_LAYERS layers: attention forward/backward per layer, one loss, one
# bf16/f32 bucket of AdamW, layer 0's attn_norm, and every later norm with
# its residual add folded in (mlp_norm and the next attn_norm or norm_f)
EXPECTED_CLAIMS = {"pallas_sdpa_fwd": N_LAYERS, "pallas_sdpa_bwd": N_LAYERS,
                   "pallas_ce_fwd": 1, "pallas_fused_adamw": 1, "pallas_rms_norm": 1,
                   "pallas_rms_norm_residual": 2 * N_LAYERS}


def _claims(trc):
    counts = {}

    def walk(bsyms):
        for b in bsyms:
            name = b.sym.codegen_name()
            if name.startswith("pallas_"):
                counts[name] = counts.get(name, 0) + 1
            walk(b.subsymbols)

    walk(trc.bound_symbols)
    return counts


def test_reference_train_trace_claims_the_ported_kernels(train_runs):
    """The JAX execution trace of the per-op train step claims exactly the
    kernels the port routes: no ``linear_act`` (the training trace leaves
    silu(linear) unfused, so the port's training MLP needs no linear_act
    gradient) and ``rms_norm_residual`` for every norm after the first (so
    the port gives it a gradient)."""
    trc = tt.last_execution_trace(train_runs["jstep"])
    print(trc.python())
    assert _claims(trc) == EXPECTED_CLAIMS


def test_port_routes_the_same_ops_on_the_cpu(train_runs, monkeypatch):
    """One CPU train step of the port calls each routed function as often
    as the reference trace claims its kernel (on a card, each call is one
    launch)."""
    calls = {}

    def counting(mod, attr, name):
        fn = getattr(mod, attr)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, attr, wrapped)

    for attr in ("sdpa_fwd", "sdpa_bwd", "ce_fwd", "rms_norm", "rms_norm_residual"):
        counting(tnn, attr, f"pallas_{attr}")
    counting(toptim_ops, "fused_adamw", "pallas_fused_adamw")
    params = tllama.params_from_jax(jax.tree.map(np.asarray, jllama.init_params(
        jllama.CONFIGS["tiny-gqa"], seed=0, scale_layers=N_LAYERS)), device="cpu")
    opt = AdamW(lr=LR)
    tok, tgt = train_runs["batch"]
    pretrain.train_step(params, opt, opt.init(params), tok, tgt, train_runs["tcfg"])
    assert calls == EXPECTED_CLAIMS
    assert set(cudaex.KERNELS) >= {k.removeprefix("pallas_") for k in EXPECTED_CLAIMS}


# ---------------------------------------------------------------------------
# wrappers, entry points
# ---------------------------------------------------------------------------

def test_pretrain_runs_on_the_cpu_and_learns():
    out = pretrain.run("tiny-gqa", layers=1, batch=2, seq=32, steps=3, lr=1e-3, device="cpu")
    assert out["device"] == "cpu" and len(out["losses"]) == 4
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    assert all(s["launches"] == {} for s in out["per_step"])   # plain versions only
    assert "card" not in out


def test_pretrain_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.run("tiny-gqa", layers=1, batch=1, seq=8, steps=1)


def test_flops_and_params_match_reference():
    for name in ("tiny-gqa", "llama3-8b-bench"):
        jcfg, tcfg = jllama.CONFIGS[name], tllama.CONFIGS[name]
        assert tllama.num_params(tcfg, 4) == jllama.num_params(jcfg, 4)
        assert tllama.flops_per_token(tcfg, 2048, 4) == jllama.flops_per_token(jcfg, 2048, 4)
    assert tllama.num_params(tllama.CONFIGS["llama3-8b-bench"], 4) == 1_134_596_096


# ---------------------------------------------------------------------------
# the comparison helpers the card's checks use
# ---------------------------------------------------------------------------

def test_ulp_distance_counts_neighbouring_floats():
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.tensor([1.0, -2.5, 0.0, 3e-3], dtype=dtype)
        up = torch.nextafter(a, torch.full_like(a, float("inf")))
        assert ulp_distance(a, a) == 0
        assert ulp_distance(a, up) == 1
        assert ulp_distance(up, torch.nextafter(up, torch.full_like(a, float("inf")))) == 1
    # across zero: +tiny and -tiny are two steps apart
    z = torch.tensor([0.0])
    assert ulp_distance(torch.nextafter(z, torch.tensor([1.0])),
                        torch.nextafter(z, torch.tensor([-1.0]))) == 2
    with pytest.raises(ValueError):
        ulp_distance(torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16))


def test_row_check_sees_a_fault_in_late_keys():
    """The per-row check the card holds the attention kernels to, at the
    train path's T=2048 and hd=128 (one head): on causal gradients of the
    plain backward, a dK or a dV whose last 64-key tile is zeroed and an
    output whose last 64 rows are 10% off each fail it at 2e-2, though each
    stays within 2e-2 of its tensor's largest value (a check relative to
    the whole tensor passes them); the exact values pass it."""
    q, k, v, g = (_t(a) for a in _attn_inputs(7, 2048, 2048, H=1, hd=128))
    out, lse = tnn.sdpa_fwd_plain(q, k, v, True)
    dq, dk, dv = tnn.sdpa_bwd_plain(g, q, k, v, out, lse, True)
    faults = []
    for ref in (dk, dv, out):
        bad = ref.clone()
        bad[..., -64:, :] *= 0.9 if ref is out else 0.0
        faults.append((bad, ref))
    for bad, ref in faults:
        assert float((bad - ref).abs().max()) <= 2e-2 * float(ref.abs().max())
        assert row_rel_err(bad, ref) > 2e-2
    for t in (dq, dk, dv, out):
        assert row_rel_err(t, t) == 0.0
