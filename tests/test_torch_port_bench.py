"""thunder_tpu_torch's headline train bench (``benchmarks/bench.py``) against
the JAX package's ``bench.py`` step, on the CPU.

Kernel functions: ``fused_adamw_slab_plain`` against the Pallas kernel it
stands for (``pallas_fused_adamw_slab``, run in interpret mode as the JAX
package's own tests run it), and bit-identical to the per-step update;
the slab state layout (``pack_state``/``unpack_state``/``adapt_opt_state``,
``state_from_jax``) against the reference's; ``fused_linear_cross_entropy``
against the reference op and its VJP. ``cudaex.refusal`` against the
reference checkers' verdicts on the same shapes and dtypes, and the routers
raising that refusal on the card before any launch.

The slice: three tiny-gqa steps of the bench's step (``fused_loss_fn``,
``remat``, ``AdamW(slab_persistent=True)``) against ``tt.jit(train_step)``
from the same weights, tokens and state; and for each variant of the step
(remat or not, block fusion or not) the routed calls of one port step
against the Pallas claims of the reference's trace.

Tolerances:
- AdamW 4 ULP of each stored dtype, the bound the JAX suite pins between the
  Pallas kernel and the per-op chain (XLA contracts mul+add into FMAs); the
  slab and per-step updates of the port are the same operations: equal;
- the fused loss in float32: loss and lse 1e-5 relative (sums of exponentials
  over the vocab chunks in another order), dh and dw 1e-6 absolute (values
  ~1e-2, the softmax rows summed in another order);
- the slice as tests/test_torch_port_training.py: loss 1e-5 relative, m
  1e-6 and v 1e-9 absolute (float32 slabs), parameters after 3 AdamW steps
  at lr 1e-3 within 0.2 lr (an element whose gradient is within float32
  noise of zero takes a noise-decided Adam step).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import thunder_tpu as tt
from thunder_tpu import ops as jops
from thunder_tpu.core import dtypes
from thunder_tpu.core.proxies import TensorProxy
from thunder_tpu.executors import pallasex as px
from thunder_tpu.models import llama as jllama
from thunder_tpu.ops import nn as jnn
from thunder_tpu.ops import optim as jopt_ops
from thunder_tpu import optim as joptim
from thunder_tpu_torch.benchmarks import bench, pretrain
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.ops import optim as toptim_ops
from thunder_tpu_torch import optim as toptim
from thunder_tpu_torch.testing import ulp_distance

LR = 1e-3
STEPS = 3
N_LAYERS = 2
HYPER = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")


def _t(a) -> torch.Tensor:
    return tllama._tensor_from_numpy(np.asarray(a))


def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


# ---------------------------------------------------------------------------
# the slab geometry and the slab update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total", [1, 100, 128, 1000, 65536, 70001, 6_740_000_000])
def test_slab_geometry_matches_reference(total):
    assert toptim_ops.slab_geometry(total) == jopt_ops.slab_geometry(total)
    assert (toptim_ops.SLAB_LANE, toptim_ops.SLAB_ROW_BLOCK) == \
        (jopt_ops.SLAB_LANE, jopt_ops.SLAB_ROW_BLOCK)


# odd sizes: every member after the 7- and 13-element ones starts its slab
# run off the 4-element alignment the vector loads want
SLAB_SHAPES = [(16, 8), (7,), (13,), (3, 5), (), (4099,), (8, 16)]


def _slab_inputs(seed, p_dt, m_dt):
    """numpy params and grads of SLAB_SHAPES (bf16 as ml_dtypes) and zero m/v
    slabs. Driven with fixed gradients, as the JAX suite's parity test drives
    the kernel, no step cancels m or v to near zero, and parameters of
    magnitude 0.5 to 1.5 take steps of about lr = 1e-2, so none is cancelled
    to near zero either: there a distance in ULPs of the result says
    nothing."""
    rng = np.random.RandomState(seed)

    def draw(s, dt, lo=0.0):
        x = rng.randn(*s)
        x = np.sign(x) * (lo + np.abs(x)) if lo else x
        return np.asarray(jnp.asarray(np.asarray(x, np.float32),
                                      jnp.float32 if dt == "f32" else jnp.bfloat16))

    ps = [draw(s, p_dt, lo=0.5) for s in SLAB_SHAPES]
    gs = [draw(s, p_dt) for s in SLAB_SHAPES]
    sizes = [int(np.prod(s)) for s in SLAB_SHAPES]
    rows, _ = jopt_ops.slab_geometry(sum(sizes))
    return ps, gs, draw((rows, 128), m_dt) * 0, draw((rows, 128), "f32") * 0, sizes


@pytest.mark.parametrize("m_dt", ["f32", "bf16"])
@pytest.mark.parametrize("p_dt", ["f32", "bf16"])
def test_fused_adamw_slab_matches_pallas(p_dt, m_dt, interpret):
    """Three steps of pallas_fused_adamw_slab with fixed gradients; at each
    step the port's slab update from the same (p, g, slabs) gives params and
    both slabs within 4 ULP of their stored dtype, and a zero pad tail."""
    ps, gs, m, v, sizes = _slab_inputs(7, p_dt, m_dt)
    total = sum(sizes)
    for step in range(1, 4):
        bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
        tp, tg, tm, tv = [_t(p) for p in ps], [_t(g) for g in gs], _t(m), _t(v)
        new_ps, m, v = px.pallas_fused_adamw_slab(ps, gs, m, v, np.float32(bc1),
                                                  np.float32(bc2), sizes=sizes, **HYPER)
        ps, m, v = [np.asarray(p) for p in new_ps], np.asarray(m), np.asarray(v)
        toptim_ops.fused_adamw_slab(tp, tg, tm, tv, torch.tensor([bc1, bc2]), sizes=sizes,
                                    **HYPER)
        for mine, want in zip(tp + [tm, tv], [_t(p) for p in ps] + [_t(m), _t(v)]):
            assert mine.dtype == want.dtype and ulp_distance(mine, want) <= 4
        for slab in (tm, tv):
            assert float(slab.reshape(-1)[total:].abs().max()) == 0.0


@pytest.mark.parametrize("m_dt", ["f32", "bf16"])
def test_slab_update_is_bit_identical_to_the_per_step_update(m_dt):
    """The slab update and the per-step update of the same values, each
    through its routed op on the CPU, agree bit for bit (the reference pins
    the same identity between its two Pallas paths)."""
    ps, gs, m, v, sizes = _slab_inputs(8, "bf16", m_dt)
    tp, tg, tm, tv = [_t(p) for p in ps], [_t(g) for g in gs], _t(m), _t(v)
    offs = np.cumsum([0] + sizes)
    qp = [p.clone() for p in tp]
    qm = [tm.reshape(-1)[a:b].reshape(p.shape).clone() for a, b, p in zip(offs, offs[1:], tp)]
    qv = [tv.reshape(-1)[a:b].reshape(p.shape).clone() for a, b, p in zip(offs, offs[1:], tp)]
    bc = torch.tensor([1.0 - 0.9 ** 5, 1.0 - 0.999 ** 5])
    toptim_ops.fused_adamw_slab(tp, tg, tm, tv, bc, sizes=sizes, **HYPER)
    toptim_ops.fused_adamw(qp, tg, qm, qv, bc, **HYPER)
    for a, b in zip(tp, qp):
        assert torch.equal(a, b)
    assert torch.equal(torch.cat([t.reshape(-1) for t in qm]), tm.reshape(-1)[:offs[-1]])
    assert torch.equal(torch.cat([t.reshape(-1) for t in qv]), tv.reshape(-1)[:offs[-1]])


# ---------------------------------------------------------------------------
# the slab state layout
# ---------------------------------------------------------------------------

def _mixed_params(seed=3):
    """A tiny-gqa parameter tree with its norm weights in bfloat16, so the
    layout has two dtype buckets interleaved in flattening order."""
    jp = jllama.init_params(jllama.CONFIGS["tiny-gqa"], seed=seed, scale_layers=1)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a.astype(jnp.bfloat16) if "norm" in jax.tree_util.keystr(path) else a,
        jp)
    return jp, tllama.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tree_state(jparams, seed=4):
    rng = np.random.RandomState(seed)
    return {"m": jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32), jparams),
            "v": jax.tree.map(lambda a: jnp.asarray(rng.rand(*a.shape), jnp.float32), jparams),
            "step": jnp.asarray(5.0, jnp.float32)}


@pytest.mark.parametrize("opt_state", sorted(bench.OPT_STATES))
def test_pack_unpack_and_adapt_match_reference(opt_state):
    """Per-parameter state -> slabs -> per-parameter state, in both packages
    from the same numpy state: equal slabs (keys, dtypes, values, zero pad)
    and equal trees, both ways and through adapt_opt_state."""
    sd, vd = {"f32": (dtypes.float32, None), "bf16": (dtypes.bfloat16, None),
              "bf16_all": (dtypes.bfloat16, dtypes.bfloat16)}[opt_state]
    jopt = joptim.AdamW(state_dtype=sd, v_dtype=vd, slab_persistent=True)
    topt = bench.make_opt(opt_state, slab_state=True)
    jparams, tparams = _mixed_params()
    jtree = _tree_state(jparams)
    jslab = jax.tree.map(np.asarray, joptim.adapt_opt_state(jtree, params=jparams, opt=jopt))
    ttree = toptim.AdamW().state_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")
    tslab = toptim.adapt_opt_state(ttree, params=tparams, opt=topt)
    assert toptim.opt_state_layout_version(tslab) == int(jslab["layout_version"]) == 1
    for which in ("m", "v"):
        assert list(tslab[which]) == list(jslab[which]) == ["bfloat16", "float32"]
        for key, a in jslab[which].items():
            assert tslab[which][key].dtype == _t(a).dtype
            assert torch.equal(tslab[which][key], _t(a))
    # the reference's slab state carried across 1:1, then back to trees
    carried = topt.state_from_jax(jslab, device="cpu")
    for which in ("m", "v"):
        for key in jslab[which]:
            assert torch.equal(carried[which][key], tslab[which][key])
    back = toptim.adapt_opt_state(carried, params=tparams, opt=toptim.AdamW())
    jback = joptim.adapt_opt_state(jslab, params=jparams, opt=joptim.AdamW())
    for which in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jback[which]), toptim.tree_leaves(back[which])):
            assert tuple(b.shape) == a.shape and torch.equal(b, _t(a))
    assert toptim.adapt_opt_state(tslab, params=tparams, opt=topt) is tslab


def test_slab_init_matches_reference():
    jparams, tparams = _mixed_params()
    jst = joptim.AdamW(state_dtype=dtypes.bfloat16, slab_persistent=True).init(jparams)
    tst = bench.make_opt("bf16", slab_state=True).init(tparams)
    for which in ("m", "v"):
        for key, a in jst[which].items():
            assert tuple(tst[which][key].shape) == a.shape
            assert tst[which][key].dtype == _t(np.asarray(a)).dtype
            assert float(tst[which][key].abs().max()) == 0.0
    assert int(tst["layout_version"]) == 1 and float(tst["step"]) == 0.0
    with pytest.raises(ValueError, match="adapt_opt_state"):
        bench.make_opt("bf16", slab_state=True).update(
            tparams, tparams, toptim.AdamW().init(tparams))


# ---------------------------------------------------------------------------
# the chunked-vocab loss
# ---------------------------------------------------------------------------

def _flce_inputs(seed, N=24, D=16, V=100):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(V, D) / np.sqrt(D)).astype(np.float32)
    target = rng.randint(0, V, size=N).astype(np.int32)
    target[[2, 9, 10]] = -100
    return h, w, target


@pytest.mark.parametrize("lse_weight", [0.0, 0.25], ids=["loss", "loss+lse"])
@pytest.mark.parametrize("chunk", [32, None], ids=["chunk32", "default"])
def test_fused_linear_cross_entropy_matches_reference(chunk, lse_weight):
    """Loss, lse and the gradients of ``loss + lse_weight * sum(lse)`` in h
    and w, against ``tt.value_and_grad`` of the reference op; chunk 32 does
    not divide V = 100, and three rows are ignored."""
    h, w, target = _flce_inputs(5)

    def jfn(hw):
        loss, lse = jnn.fused_linear_cross_entropy(hw[0], hw[1], target, chunk=chunk)
        return jops.add(loss, jops.mul(jops.sum(lse), lse_weight))

    ref_val, ref_grads = tt.jit(tt.value_and_grad(jfn), executors=["xla"])((h, w))
    ref_loss, ref_lse = tt.jit(lambda a, b: jnn.fused_linear_cross_entropy(
        a, b, target, chunk=chunk), executors=["xla"])(h, w)
    ht, wt = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    loss, lse = tnn.fused_linear_cross_entropy(ht, wt, _t(target), chunk=chunk)
    (loss + lse.sum() * lse_weight).backward()
    np.testing.assert_allclose(_np32(loss), _np32(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(_np32(lse), _np32(ref_lse), rtol=1e-5)
    np.testing.assert_allclose(_np32(loss) + lse_weight * _np32(lse).sum(), _np32(ref_val),
                               rtol=1e-5)
    np.testing.assert_allclose(_np32(ht.grad), _np32(ref_grads[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np32(wt.grad), _np32(ref_grads[1]), atol=1e-6, rtol=0)
    if not lse_weight:
        assert float(ht.grad[9].abs().max()) == 0.0    # an ignored row gets no gradient


def test_fused_loss_equals_naive_loss_in_f32():
    """In float32 ``fused_loss_fn`` is ``loss_fn`` with the logits summed in
    vocab chunks: the same loss and gradients up to summation order."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=2, device="cpu", n_layers=1)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 16, 3))
    a = pretrain.loss_and_grads(params, tok, tgt, cfg, loss="naive")
    b = pretrain.loss_and_grads(params, tok, tgt, cfg, loss="fused")
    assert abs(float(a[0]) - float(b[0])) <= 1e-5 * abs(float(a[0]))
    for x, y in zip(toptim.tree_leaves(a[1]), toptim.tree_leaves(b[1])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, rtol=0)


def test_flce_logits_route_on_the_cpu():
    assert tnn.flce_logits_route(torch.zeros(1)) == "f32"
    assert tnn.flce_logits_route(torch.zeros(1, dtype=torch.bfloat16)) == "f32 upcast"


# ---------------------------------------------------------------------------
# the slice: the bench step, port vs tt.jit(train_step)
# ---------------------------------------------------------------------------

def _reference_step(jcfg, jopt, remat):
    def train_step(params, opt_state, tokens, targets):
        loss, grads = tt.value_and_grad(
            lambda p: jllama.fused_loss_fn(p, tokens, targets, jcfg, remat=remat))(params)
        return loss, *jopt.update(params, grads, opt_state)

    return train_step


@pytest.fixture(scope="module")
def bench_runs():
    """Both packages from the same weights, tokens and slab state: STEPS
    steps of the bench's step with remat, the fused loss and float32 slabs
    (losses, final params and state). The JAX step runs its Pallas claims in
    interpret mode."""
    mp = pytest.MonkeyPatch()
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    try:
        jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
        jparams = jllama.init_params(jcfg, seed=0, scale_layers=N_LAYERS)
        jopt = joptim.AdamW(lr=LR, slab_persistent=True)
        jstate = jopt.init(jparams)
        tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, 2, 64, seed=0)
        jtok, jtgt = tok.astype(np.int32), tgt.astype(np.int32)
        jstep = tt.jit(_reference_step(jcfg, jopt, remat=True))
        tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        topt = toptim.AdamW(lr=LR, slab_persistent=True)
        tstate = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)
        p, s, jl, tl = jparams, jstate, [], []
        for _ in range(STEPS):
            loss, p, s = jstep(p, s, jtok, jtgt)
            jl.append(float(loss))
            tl.append(float(pretrain.train_step(tparams, topt, tstate, ttok, ttgt, tcfg,
                                                loss="fused", remat=True)))
        return {"jl": jl, "tl": tl, "jparams": p, "jstate": s, "tparams": tparams,
                "tstate": tstate, "jstep": jstep, "batch": (ttok, ttgt), "jbatch": (jtok, jtgt)}
    finally:
        mp.undo()


def test_bench_steps_match_reference(bench_runs):
    """Losses of every step, then params, both slabs and the step count
    after STEPS steps."""
    np.testing.assert_allclose(bench_runs["tl"], bench_runs["jl"], rtol=1e-5)
    assert bench_runs["tl"][-1] < bench_runs["tl"][0]
    for a, b in zip(jax.tree_util.tree_leaves(bench_runs["jparams"]),
                    toptim.tree_leaves(bench_runs["tparams"])):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)
    js, ts = bench_runs["jstate"], bench_runs["tstate"]
    for key, tol in (("m", 1e-6), ("v", 1e-9)):
        assert list(ts[key]) == list(js[key]) == ["float32"]
        np.testing.assert_allclose(ts[key]["float32"].numpy(), np.asarray(js[key]["float32"]),
                                   atol=tol, rtol=0)
    assert float(ts["step"]) == float(np.asarray(js["step"])) == STEPS


def _claims(trc) -> dict:
    counts = {}

    def walk(bsyms):
        for b in bsyms:
            name = b.sym.codegen_name()
            if name.startswith("pallas_"):
                counts[name] = counts.get(name, 0) + 1
            walk(b.subsymbols)

    walk(trc.bound_symbols)
    return counts


def _port_calls(monkeypatch, tcfg, batch, remat, block_fusion) -> dict:
    """The routed functions one CPU step of the port's bench step calls, by
    the name of the Pallas claim each stands for."""
    calls = {}

    def counting(mod, attr):
        fn = getattr(mod, attr)

        def wrapped(*a, **k):
            calls[f"pallas_{attr}"] = calls.get(f"pallas_{attr}", 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, attr, wrapped)

    for attr in ("sdpa_fwd", "sdpa_bwd", "ce_fwd", "rms_norm", "rms_norm_residual",
                 "mlp_subblock", "mlp_subblock_bwd"):
        counting(tnn, attr)
    for attr in ("fused_adamw", "fused_adamw_slab"):
        counting(toptim_ops, attr)
    params = tllama.params_from_jax(jax.tree.map(np.asarray, jllama.init_params(
        jllama.CONFIGS["tiny-gqa"], seed=0, scale_layers=N_LAYERS)), device="cpu")
    opt = bench.make_opt("bf16", slab_state=True)
    pretrain.train_step(params, opt, opt.init(params), *batch, tcfg, loss="fused", remat=remat,
                        block_fusion=block_fusion)
    return calls


# the variants of the reference's bench step at N_LAYERS layers (fused loss,
# bf16 m slab): under remat every layer's forward claims rms_norm, the
# lse-free pallas_sdpa and rms_norm, its recompute rms_norm, pallas_sdpa_fwd
# and rms_norm_residual; block fusion plans nothing under remat
VARIANTS = {
    (True, False): {"pallas_rms_norm": 3 * N_LAYERS + 1, "pallas_sdpa": N_LAYERS,
                    "pallas_sdpa_fwd": N_LAYERS, "pallas_sdpa_bwd": N_LAYERS,
                    "pallas_rms_norm_residual": N_LAYERS, "pallas_fused_adamw_slab": 1},
    (False, False): {"pallas_rms_norm": 1, "pallas_rms_norm_residual": 2 * N_LAYERS,
                     "pallas_sdpa_fwd": N_LAYERS, "pallas_sdpa_bwd": N_LAYERS,
                     "pallas_fused_adamw_slab": 1},
    (False, True): {"pallas_rms_norm": N_LAYERS + 1, "pallas_mlp_subblock": N_LAYERS,
                    "pallas_mlp_subblock_bwd": N_LAYERS, "pallas_sdpa_fwd": N_LAYERS,
                    "pallas_sdpa_bwd": N_LAYERS, "pallas_fused_adamw_slab": 1},
}
VARIANTS[(True, True)] = VARIANTS[(True, False)]


@pytest.mark.parametrize("remat,block_fusion", list(VARIANTS),
                         ids=[f"{'remat' if r else 'no_remat'}-{'bf' if b else 'per_op'}"
                              for r, b in VARIANTS])
def test_port_routes_the_reference_claims(bench_runs, monkeypatch, remat, block_fusion):
    """The reference's bench step, traced with ``tt.jit(train_step,
    block_fusion=...)``, claims VARIANTS' Pallas kernels; one CPU step of the
    port calls each routed function as often, its ``sdpa_fwd`` standing for
    both the lse-free forward claim ``pallas_sdpa`` and ``pallas_sdpa_fwd``
    (on a card, each call is one launch of the one forward kernel)."""
    want = VARIANTS[(remat, block_fusion)]
    if remat and not block_fusion:
        trc = tt.last_execution_trace(bench_runs["jstep"])   # float32 slabs; same claims
    else:
        monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
        jcfg = jllama.CONFIGS["tiny-gqa"]
        jparams = jllama.init_params(jcfg, seed=0, scale_layers=N_LAYERS)
        jopt = joptim.AdamW(lr=LR, state_dtype=dtypes.bfloat16, slab_persistent=True)
        jstep = tt.jit(_reference_step(jcfg, jopt, remat), block_fusion=block_fusion)
        jstep(jparams, jopt.init(jparams), *bench_runs["jbatch"])
        trc = tt.last_execution_trace(jstep)
    assert _claims(trc) == want
    folded = dict(want)
    folded["pallas_sdpa_fwd"] = folded["pallas_sdpa_fwd"] + folded.pop("pallas_sdpa", 0)
    tcfg = tllama.CONFIGS["tiny-gqa"]
    assert _port_calls(monkeypatch, tcfg, bench_runs["batch"], remat, block_fusion) == folded


def test_bench_entry_runs_on_the_cpu():
    """The bench's compiled step (``jit(train_step, donate_argnums=(0, 1))``)
    and its two other arms: the guarded step and the eager baseline."""
    out = bench.run("tiny-gqa", layers=2, batch=2, seq=32, steps=3, remat=True,
                    slab_state=True, device="cpu")
    assert out["remat"] and out["slab_persistent"] and out["loss"] == "fused"
    assert out["opt_state"] == ["bfloat16", "float32"] and out["logits_route"] == "f32"
    assert out["losses"][-1] < out["losses"][0]
    assert all(s["launches"] == {} for s in out["per_step"])
    assert out["compiled"] and out["whole_program"] == "per-call (inputs off the card)"
    assert out["sentinel_losses"] == out["losses"] and out["vs_baseline"] > 0


def test_bench_config_matches_reference():
    j, t = jllama.CONFIGS["llama2-7b-bench"], tllama.CONFIGS["llama2-7b-bench"]
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "kv_heads", "intermediate_size",
              "max_seq_len", "rope_theta", "norm_eps", "head_dim"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16
    # the chip check's slab bucket: 8 layers, one bf16 bucket of 1,881,214,976
    assert tllama.num_params(t, 8) == 1_881_214_976


# ---------------------------------------------------------------------------
# the kernels' predicates against the reference checkers, and the routers
# ---------------------------------------------------------------------------

_DT = {"f32": (torch.float32, dtypes.float32), "bf16": (torch.bfloat16, dtypes.bfloat16),
       "f16": (torch.float16, dtypes.float16), "f64": (torch.float64, dtypes.float64),
       "i32": (torch.int32, dtypes.int32), "i64": (torch.int64, dtypes.int64)}


_PROXY_NAMES = itertools.count()


def _pair(shape, dt="f32"):
    """A zero CPU tensor and a reference TensorProxy of one shape and dtype."""
    return (torch.zeros(shape, dtype=_DT[dt][0]),
            TensorProxy(f"t{next(_PROXY_NAMES)}", shape=tuple(shape), dtype=_DT[dt][1]))


def _decode_case(hd=16, wq_dt="f32"):
    S, D, H, KV, P, ps, npg = 2, 64, 4, 2, 5, 8, 2
    return [_pair((S, 1, D)), _pair((D,)), _pair((H * hd, D), wq_dt), _pair((KV * hd, D)),
            _pair((KV * hd, D)), _pair((D, H * hd)), _pair((S, 1, 1, hd // 2)),
            _pair((S, 1, 1, hd // 2)), _pair((KV, P, ps, hd)), _pair((KV, P, ps, hd)),
            _pair((S, npg), "i32"), _pair((S,), "i32"), _pair((S,), "i64")]


def _mlp_case(w_dt="bf16", N=8, D=128, F=256):
    return [_pair((N, D), "bf16"), _pair((N, D), "bf16"), _pair((D,), "bf16"),
            _pair((F, D), w_dt), _pair((F, D), "bf16"), _pair((D, F), "bf16")]


def _adamw_case(p_dt="f32", g_dt="f32"):
    shapes = [(4, 8), (3,)]
    return ([_pair(s, p_dt) for s in shapes], [_pair(s, g_dt) for s in shapes],
            [_pair(s) for s in shapes], [_pair(s) for s in shapes])


def _case(name, args, kw=None):
    """(kernel, port args, reference args, kwargs); each of ``args`` is a
    pair or a list of pairs (a bucket of tensors)."""
    def side(i):
        return [[x[i] for x in a] if isinstance(a, list) else a[i] for a in args]
    return name, side(0), side(1), kw or {}


# each case: (kernel, port args, reference args, kwargs), the reference
# checker's verdict in interpret mode and on a TPU, and the port's (the
# kernel takes the arguments: ``cudaex.refusal`` is None).
# The port's kernels take what the reference computes, through its Pallas
# kernel or through its decomposition, wherever a kernel can repeat the
# decomposition's rounding points: float16, a weight dtype unlike the
# activation's in the norms, mixed dtypes that promote (linear_act, the
# norms' residual add), the head dims 8 and 192, K = 518, p and g of two
# dtypes. They refuse float64 (JAX without x64 makes none), an unknown
# activation, shapes that are not the op's, and a mixed-dtype fused
# sub-block (its decomposition rounds where no kernel here does)
def _cases():
    x, w = _pair((8, 128)), _pair((128,))
    cases = [
        (_case("rms_norm", [x, w]), (True, True, True)),
        (_case("rms_norm", [_pair((8, 128), "bf16"), _pair((128,))]), (False, False, True)),
        (_case("rms_norm", [_pair((8, 128), "f16"), _pair((128,), "f16")]), (True, True, True)),
        # JAX without x64 makes the reference's arrays float32; the port refuses float64
        (_case("rms_norm", [_pair((8, 128), "f64"), _pair((128,), "f64")]),
         (True, True, False)),
        (_case("rms_norm_residual", [x, x, w]), (True, True, True)),
        (_case("rms_norm_residual", [_pair((8, 128), "bf16"), x, w]), (False, False, True)),
        (_case("linear_act", [_pair((8, 4096), "bf16"), _pair((256, 4096), "bf16")],
               {"act": "silu"}), (True, True, True)),
        (_case("linear_act", [_pair((8, 518), "bf16"), _pair((256, 518), "bf16")],
               {"act": "silu"}), (True, False, True)),
        (_case("linear_act", [_pair((8, 512), "bf16"), _pair((256, 512))], {"act": "silu"}),
         (False, False, True)),
        (_case("linear_act", [_pair((8, 512)), _pair((256, 512))], {"act": "tanh"}),
         (False, False, False)),
        (_case("sdpa_fwd", [_pair((1, 2, 128, 128), "bf16")] * 3), (True, True, True)),
        (_case("sdpa_fwd", [_pair((1, 8, 128, 8), "bf16")] * 3), (True, False, True)),
        (_case("sdpa_fwd", [_pair((1, 2, 128, 192), "bf16")] * 3), (True, False, True)),
        (_case("ce_fwd", [_pair((16, 256)), _pair((16,), "i64")]), (True, True, True)),
        (_case("ce_fwd", [_pair((16,)), _pair((16,), "i64")]), (False, False, False)),
        (_case("fused_adamw", list(_adamw_case()) + [_pair((2,))]), (True, True, True)),
        # the grads' dtype is a type of the kernel's own, as the reference's
        (_case("fused_adamw", list(_adamw_case("f32", "bf16")) + [_pair((2,))]),
         (True, True, True)),
        (_case("fused_adamw", list(_adamw_case("f64", "f64")) + [_pair((2,))]),
         (False, False, False)),
        (_case("mlp_subblock", _mlp_case()), (True, True, True)),
        (_case("mlp_subblock", _mlp_case("f32")), (False, False, False)),
        (_case("attn_subblock", _decode_case()), (True, False, True)),
        (_case("attn_subblock", _decode_case(wq_dt="bf16")), (False, False, False)),
        (_case("attn_subblock", _decode_case(hd=8)), (True, False, True)),
    ]
    for sizes, shape, ok in (([32, 3], (8, 128), True), ([32, 3], (16, 128), False)):
        ps, gs = [_pair((4, 8)), _pair((3,))], [_pair((4, 8)), _pair((3,))]
        cases.append((_case("fused_adamw_slab", [ps, gs, _pair(shape), _pair(shape), _pair((2,))],
                            {"sizes": sizes}), (ok, ok, ok)))
    return cases


_CHECKERS = {"rms_norm": px._rms_checker, "rms_norm_residual": px._rms_res_checker,
             "linear_act": px._linear_act_checker, "sdpa_fwd": px._sdpa_checker,
             "ce_fwd": px._ce_checker, "fused_adamw": px._fused_adamw_checker,
             "fused_adamw_slab": px._fused_adamw_slab_checker,
             "mlp_subblock": px._mlp_subblock_checker,
             "attn_subblock": px._attn_subblock_checker}


def _ref_args(name, rargs):
    if name in ("fused_adamw", "fused_adamw_slab"):   # bc -> (bc1, bc2)
        return rargs[:-1] + [rargs[-1], rargs[-1]]
    return rargs


def test_refusals_follow_the_reference_checkers(monkeypatch):
    cases = _cases()
    verdicts = []
    for tpu in (False, True):
        if tpu:   # the reference on a TPU: its checkers' tiling bounds apply
            monkeypatch.delenv("THUNDER_TPU_PALLAS_INTERPRET", raising=False)
            monkeypatch.setattr(px, "_on_tpu", lambda: True)
        else:
            monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
        verdicts.append([bool(_CHECKERS[n](*_ref_args(n, r), **kw))
                         for (n, _, r, kw), _ in cases])
    for i, ((name, targs, _, kw), want) in enumerate(cases):
        got = (verdicts[0][i], verdicts[1][i], cudaex.refusal(name, *targs, **kw) is None)
        assert got == want, (i, name, got, want)


def test_refusals_name_what_the_kernels_do_not_take():
    """ROADMAP C.1's inputs (float16, a strided input, a mixed weight dtype,
    head dims 8 and 192, K = 518 in bf16, attn_subblock at head dim 8) are
    taken: ``cudaex.refusal`` is None for each. What stays refused is named
    with its reason, and the wrapper raises it: float64, which the reference
    never makes, and a strided KV pool, which the kernels read in place."""
    x = torch.zeros(8, 128)
    assert cudaex.refusal("rms_norm", x, torch.ones(128)) is None
    assert cudaex.refusal("rms_norm", x.half(), torch.ones(128).half()) is None
    assert cudaex.refusal("rms_norm", torch.zeros(128, 8).t(), torch.ones(128)) is None
    assert cudaex.refusal("rms_norm", x.bfloat16(), torch.ones(128)) is None
    for hd in (8, 192):
        q = torch.zeros(1, 2, 64, hd, dtype=torch.bfloat16)
        assert cudaex.refusal("sdpa_fwd", q, q, q) is None
    a, w = torch.zeros(8, 518, dtype=torch.bfloat16), torch.zeros(64, 518, dtype=torch.bfloat16)
    assert cudaex.refusal("linear_act", a, w, None, "silu") is None
    args = [pair[0] for pair in _decode_case(hd=8)]
    assert cudaex.refusal("attn_subblock", *args) is None
    assert "not supported" in cudaex.refusal("rms_norm", x.double(), None)
    with pytest.raises(ValueError, match="not supported"):
        cudaex.rms_norm(x.double(), None, 1e-5)
    args[8] = args[8].transpose(2, 3).contiguous().transpose(2, 3)   # a strided k pool
    assert "not contiguous" in cudaex.refusal("attn_subblock", *args)


def test_routers_raise_where_the_kernel_refuses(monkeypatch):
    """Pretending the tensors are on a card: the router sends every call to
    the kernel's wrapper, which launches where the kernel takes the inputs
    and raises the refusal before any launch where it does not; nothing
    runs the plain version on the card."""
    launched = []
    monkeypatch.setattr(tnn, "_on_cuda", lambda t, name: True)
    monkeypatch.setattr(cudaex, "_require_cuda", lambda name, t: None)
    monkeypatch.setattr(cudaex, "_stream", lambda t: 0)
    monkeypatch.setattr(cudaex, "_launch", lambda name, *a, **kw: launched.append(name))
    monkeypatch.setattr(tnn, "rms_norm_plain", lambda *a: pytest.fail("plain version ran"))
    x = torch.randn(4, 32)
    for ok in ((x, torch.ones(32)), (x.half(), torch.ones(32).half()),
               (torch.randn(32, 4).t(), torch.ones(32)), (x.bfloat16(), torch.ones(32))):
        tnn.rms_norm(*ok)
    assert launched == ["rms_norm"] * 4
    with pytest.raises(ValueError, match="^rms_norm: "):
        tnn.rms_norm(x.double(), torch.ones(32).double())
    assert launched == ["rms_norm"] * 4


def test_remat_layer_gradients_match_the_unchecked_layer():
    """One checkpointed layer in float64, whose forward runs ``rms_norm``,
    the add and ``rms_norm`` and whose recompute runs ``rms_norm_residual``
    (the backward reads the tensors the recompute saved, by position),
    against the same layer run once without a checkpoint: the same output
    and gradients of the input and of every weight, to float64 rounding;
    and the checkpointed layer's input gradient against finite differences
    (attention computes in float32, as the reference's does, so the step
    is 1e-2, where float32 rounding leaves the differences within 2e-5 of
    gradients up to 1.6)."""
    from thunder_tpu_torch.core.rematerialization import checkpoint

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=3, device="cpu", n_layers=1)
    layer = {k: w.double().requires_grad_(True) for k, w in params["layers"][0].items()}
    gen = torch.Generator().manual_seed(3)
    B, T = 1, 8
    h = torch.randn(B, T, cfg.dim, generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.randn(B, T, cfg.dim, generator=gen, dtype=torch.float64)
    cos, sin = tllama._rope_cos_sin(cfg, T, torch.float64)

    def plain(x, lay):
        return tllama._remat_block(x, lay, cfg, cos, sin)

    remat = checkpoint(plain)
    leaves = [h, *layer.values()]
    got = {}
    for name, fn in (("remat", remat), ("plain", plain)):
        out = fn(h, layer)
        got[name] = (out.detach(), *torch.autograd.grad(out, leaves, g))
    for a, b in zip(got["remat"], got["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda x: remat(x, layer), (h,), eps=1e-2, atol=1e-4,
                                    rtol=1e-3)
