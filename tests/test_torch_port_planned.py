"""thunder_tpu_torch's planned-rung train step against the JAX package, on
the CPU.

Kernel functions: ``mlp_subblock_plain`` and ``mlp_subblock_bwd_plain``
against the Pallas kernels they stand for (``pallas_mlp_subblock`` and
``pallas_mlp_subblock_bwd``, run in interpret mode as the JAX package's own
tests run them), in float32 and bfloat16, for every activation, at a ragged
F = 176 (tiny-gqa's, not a multiple of the TPU's 128-wide ff block), and
against the JAX decompositions ``nn.mlp_subblock``/``nn.mlp_subblock_bwd``
in float32; the autograd function against ``tt.grad`` of ``nn.mlp_subblock``.

The slice: a 4-layer float32 tiny-gqa train step of the port with
``block_fusion=True`` against ``tt.jit(train_step, block_fusion=True)`` from
the same weights and AdamW state, and the kernels the reference's planned
trace claims against the functions one CPU step of the port routes.

Tolerances:
- float32 kernel functions 1e-5 absolute and relative: the same operations,
  with the K = 64 and K = 176 products summed in another order;
- bfloat16 against the Pallas kernel: each result within 2 bf16 ulps of its
  own magnitude (2**-6 relative) plus 2**-6 of its tensor's largest value
  absolute. Both sides round the same f32 values at the same points, but an
  f32 sum taken in another order can move a rounding by one step, and a
  value rounded one step off (ga, u, dgpre, dup) moves what is computed from
  it by about one more;
- the slice as the per-op slice's tests: loss 1e-5 relative, gradients 1e-6
  absolute (max |g| ~0.1), m 1e-6 and v 1e-9 absolute, parameters after 3
  AdamW steps at lr 1e-3 within 0.2 lr (an element whose gradient is within
  float32 noise of zero takes a noise-decided Adam step;
  tests/test_torch_port_training.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import thunder_tpu as tt
from thunder_tpu import ops as jops
from thunder_tpu.executors import pallasex as px
from thunder_tpu.models import llama as jllama
from thunder_tpu.ops import nn as jnn
from thunder_tpu.optim import AdamW as JAdamW
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.ops import optim as toptim_ops
from thunder_tpu_torch.optim import AdamW, tree_leaves

N_LAYERS = 4
LR = 1e-3
STEPS = 3
EPS = 1e-5
ACTS = ["silu", "relu", "gelu", "gelu_tanh"]
BF16_REL = 2.0 ** -6


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_REL,
                                   atol=BF16_REL * float(np.abs(want).max()))


def _inputs(dtype, act, N=16, D=64, F=176, seed=0):
    """(g, residual, x, w_norm, w_gate, w_up, w_down) as numpy (bf16 as
    ml_dtypes) at the scale of a trained layer: unit-scale activations,
    weights N(0, 1/fan_in), norm weights near 1."""
    rng = np.random.RandomState(seed + ACTS.index(act))
    arrs = [rng.randn(N, D), rng.randn(N, D), rng.randn(N, D), 1.0 + 0.1 * rng.randn(D),
            rng.randn(F, D) / np.sqrt(D), rng.randn(F, D) / np.sqrt(D),
            rng.randn(D, F) / np.sqrt(F)]
    cast = np.float32 if dtype == "f32" else jnp.bfloat16
    if act == "relu":
        # relu's derivative jumps at 0, and the interpret-mode Pallas kernel
        # sums its bf16 products only to ~1e-3: a gate pre-activation that
        # close to 0 could take either mask. So w_gate is solved for gate
        # pre-activations at least 0.25 away from 0 (n has fewer rows than D).
        h = np.asarray(jnp.asarray(arrs[1].astype(np.float32), cast), np.float32) + \
            np.asarray(jnp.asarray(arrs[2].astype(np.float32), cast), np.float32)
        n = h / np.sqrt(np.mean(h * h, -1, keepdims=True) + EPS) * arrs[3]
        target = rng.choice([-1.0, 1.0], size=(N, F)) * rng.uniform(0.25, 1.5, size=(N, F))
        arrs[4] = np.linalg.lstsq(n, target, rcond=None)[0].T
    return [np.asarray(jnp.asarray(a.astype(np.float32), cast)) for a in arrs]


def _torch(arrs):
    return [tllama._tensor_from_numpy(a) for a in arrs]


# ---------------------------------------------------------------------------
# the kernel functions' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_subblock_matches_pallas(dtype, act, interpret):
    _, r, x, wn, wg, wu, wd = _inputs(dtype, act)
    got = tnn.mlp_subblock(*_torch((r, x, wn, wg, wu, wd)), act=act, eps=EPS)
    want = px.pallas_mlp_subblock(r, x, wn, wg, wu, wd, act=act, eps=EPS)
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    _close(got, want, dtype)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_subblock_bwd_matches_pallas(dtype, act, interpret):
    arrs = _inputs(dtype, act, seed=10)
    got = tnn.mlp_subblock_bwd(*_torch(arrs), act=act, eps=EPS)
    want = px.pallas_mlp_subblock_bwd(*arrs, act=act, eps=EPS)
    for mine, ref, inp in zip(got, want, (arrs[2], *arrs[3:])):
        assert mine.dtype == tllama._tensor_from_numpy(inp).dtype
        _close(mine, ref, dtype)


@pytest.mark.parametrize("act", ACTS)
def test_plain_versions_equal_the_decompositions_in_f32(act):
    """In float32 the plain versions are the reference's decompositions
    ``nn.mlp_subblock`` and ``nn.mlp_subblock_bwd``, traced with no kernel
    executor."""
    arrs = _inputs("f32", act, N=24, seed=20)
    fwd = tt.jit(lambda *a: jnn.mlp_subblock(*a, act=act, eps=EPS), executors=["xla"])
    bwd = tt.jit(lambda *a: jnn.mlp_subblock_bwd(*a, act=act, eps=EPS), executors=["xla"])
    ts = _torch(arrs)
    _close(tnn.mlp_subblock_plain(*ts[1:], act=act, eps=EPS), fwd(*arrs[1:]), "f32")
    for mine, ref in zip(tnn.mlp_subblock_bwd_plain(*ts, act=act, eps=EPS), bwd(*arrs)):
        _close(mine, ref, "f32")


def test_mlp_subblock_autograd_matches_reference_grad():
    """Gradients through ``mlp_subblock`` (the autograd function: inputs
    saved, backward ``mlp_subblock_bwd``) equal the JAX package's gradients
    of ``nn.mlp_subblock`` for all six operands, on 3-d activations."""
    g, r, x, wn, wg, wu, wd = _inputs("f32", "silu", N=2 * 12, seed=30)
    r, x, g = (a.reshape(2, 12, -1) for a in (r, x, g))

    def jloss(*a):
        return jops.sum(jops.mul(jnn.mlp_subblock(*a, act="silu", eps=EPS), g))

    ref = tt.jit(tt.grad(jloss, argnums=tuple(range(6))), executors=["xla"])(r, x, wn, wg, wu,
                                                                             wd)
    ts = [t.requires_grad_(True) for t in _torch((r, x, wn, wg, wu, wd))]
    (tnn.mlp_subblock(*ts, act="silu", eps=EPS) * _torch([g])[0]).sum().backward()
    for t, want in zip(ts, ref):
        _close(t.grad, want, "f32")


def test_mlp_subblock_refuses_what_it_does_not_take():
    _, r, x, wn, wg, wu, wd = _torch(_inputs("f32", "silu"))
    with pytest.raises(ValueError, match="unknown activation"):
        tnn.mlp_subblock(r, x, wn, wg, wu, wd, act="tanh")
    with pytest.raises(ValueError, match="not supported"):
        tnn.mlp_subblock(r.to("meta"), x.to("meta"), wn, wg, wu, wd)
    with pytest.raises(ValueError, match="not supported"):
        tnn.mlp_subblock_bwd(x.to("meta"), r.to("meta"), x.to("meta"), wn, wg, wu, wd)


def test_planned_kernels_are_registered_and_hand_written():
    """Both kernels are registered with the Pallas functions they replace,
    and their sources (with the headers they include) call no library
    product: no cuBLAS, no torch header."""
    repo = Path(__file__).resolve().parents[1]
    for name, line in (("mlp_subblock", 1039), ("mlp_subblock_bwd", 1161)):
        k = cudaex.KERNELS[name]
        assert k.replaces == f"thunder_tpu/executors/pallasex.py:{line}"
        assert (repo / k.source).is_file()
    csrc = repo / "thunder_tpu_torch" / "csrc"
    for f in ("mlp_subblock.cu", "mlp_subblock_bwd.cu", "mlp_subblock.cuh", "gemm.cuh"):
        text = (csrc / f).read_text().lower()
        assert "cublas" not in text and "#include <torch" not in text
    assert "mma.sync" in (csrc / "common.cuh").read_text()
    assert '#include "gemm.cuh"' in (csrc / "mlp_subblock.cuh").read_text()


# ---------------------------------------------------------------------------
# the slice: tiny-gqa train step, port vs tt.jit(train_step, block_fusion=True)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planned_runs():
    """Both packages from the same weights and batch at the planned rung:
    gradients at the initial weights, then STEPS train steps (losses, final
    params and state). The JAX step runs its Pallas claims in interpret
    mode."""
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
                          block_fusion=True)
        j0_loss, j0_grads = jgrad_fn(jparams, jtok, jtgt)
        jstep = tt.jit(train_step, block_fusion=True)

        tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        topt = AdamW(lr=LR)
        tstate = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)
        t0_loss, t0_grads = pretrain.loss_and_grads(tparams, ttok, ttgt, tcfg,
                                                    block_fusion=True)

        p, s, jl, tl = jparams, jstate, [], []
        for _ in range(STEPS):
            loss, p, s = jstep(p, s, jtok, jtgt)
            jl.append(float(loss))
            tl.append(float(pretrain.train_step(tparams, topt, tstate, ttok, ttgt, tcfg,
                                                block_fusion=True)))
        return {"j0": (float(j0_loss), j0_grads), "t0": (float(t0_loss), t0_grads),
                "jl": jl, "tl": tl, "jparams": p, "jstate": s, "tparams": tparams,
                "tstate": tstate, "jstep": jstep, "batch": (ttok, ttgt), "tcfg": tcfg}
    finally:
        mp.undo()


def test_planned_loss_and_grads_match_reference(planned_runs):
    (jl0, jg), (tl0, tg) = planned_runs["j0"], planned_runs["t0"]
    assert abs(tl0 - jl0) <= 1e-5 * abs(jl0)
    jleaves, tleaves = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 3 + 9 * N_LAYERS
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_planned_steps_match_reference(planned_runs):
    """Losses of every step, then params, moments and step count after
    STEPS steps of AdamW."""
    np.testing.assert_allclose(planned_runs["tl"], planned_runs["jl"], rtol=1e-5)
    assert planned_runs["tl"][-1] < planned_runs["tl"][0]
    pairs = zip(jax.tree_util.tree_leaves(planned_runs["jparams"]),
                tree_leaves(planned_runs["tparams"]))
    for a, b in pairs:
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)
    js, ts = planned_runs["jstate"], planned_runs["tstate"]
    for key, tol in (("m", 1e-6), ("v", 1e-9)):
        for a, b in zip(jax.tree_util.tree_leaves(js[key]), tree_leaves(ts[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol, rtol=0)
    assert float(ts["step"]) == float(np.asarray(js["step"])) == STEPS


# the Pallas ops the reference's planned train step claims, per step at
# N_LAYERS layers: one mlp_subblock pair per layer takes the attention-out
# residual add, mlp_norm, the MLP and the second residual add, so every other
# norm (each layer's attn_norm and norm_f) is a plain rms_norm and
# rms_norm_residual drops out
EXPECTED_CLAIMS = {"pallas_rms_norm": N_LAYERS + 1, "pallas_sdpa_fwd": N_LAYERS,
                   "pallas_sdpa_bwd": N_LAYERS, "pallas_mlp_subblock": N_LAYERS,
                   "pallas_mlp_subblock_bwd": N_LAYERS, "pallas_ce_fwd": 1,
                   "pallas_fused_adamw": 1}


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


def test_reference_planned_trace_claims_the_ported_kernels(planned_runs):
    trc = tt.last_execution_trace(planned_runs["jstep"])
    print(trc.python())
    assert _claims(trc) == EXPECTED_CLAIMS


def test_port_routes_the_planned_ops_on_the_cpu(planned_runs, monkeypatch):
    """One planned CPU train step of the port calls each routed function as
    often as the reference's planned trace claims its kernel (on a card,
    each call is one launch), and never ``rms_norm_residual``."""
    calls = {}

    def counting(mod, attr, name):
        fn = getattr(mod, attr)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, attr, wrapped)

    for attr in ("sdpa_fwd", "sdpa_bwd", "ce_fwd", "rms_norm", "rms_norm_residual",
                 "mlp_subblock", "mlp_subblock_bwd"):
        counting(tnn, attr, f"pallas_{attr}")
    counting(toptim_ops, "fused_adamw", "pallas_fused_adamw")
    params = tllama.params_from_jax(jax.tree.map(np.asarray, jllama.init_params(
        jllama.CONFIGS["tiny-gqa"], seed=0, scale_layers=N_LAYERS)), device="cpu")
    opt = AdamW(lr=LR)
    tok, tgt = planned_runs["batch"]
    pretrain.train_step(params, opt, opt.init(params), tok, tgt, planned_runs["tcfg"],
                        block_fusion=True)
    assert calls == EXPECTED_CLAIMS
    assert set(cudaex.KERNELS) >= {k.removeprefix("pallas_") for k in EXPECTED_CLAIMS}


def test_both_rungs_agree_on_the_cpu():
    """The planned and per-op rungs are the same function: in float32 their
    losses over 3 steps agree to summation order."""
    kw = dict(layers=2, batch=2, seq=32, steps=3, lr=1e-3, device="cpu")
    a = pretrain.run("tiny-gqa", block_fusion=False, **kw)
    b = pretrain.run("tiny-gqa", block_fusion=True, **kw)
    assert b["block_fusion"] and not a["block_fusion"]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
