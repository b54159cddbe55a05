"""The headline bench and ``pretrain.run`` on ``jit``, on the CPU.

- ``bench.run(device="cpu")`` with the reference's weights and state against
  the reference's compiled bench step (``tt.jit(train_step,
  donate_argnums=(0, 1))`` of ``bench.py``: the ``fused``/``naive`` loss,
  per-step or slab moments, with and without remat; Pallas in interpret
  mode), 2 layers of tiny-gqa in float32, a warm-up and 2 timed steps:
  the losses within 1e-5 relative, the parameters within 0.2 lr, the
  moments within 2e-4 of each leaf's largest value (the compiled steps
  sum their gradients in another order), ``step`` exactly. The run is the
  compiled step (``compiled``), launching nothing on the CPU.
- the bench's three arms from the port's own weights of one seed: the
  guarded arm's losses equal the unguarded arm's bit for bit, the eager
  baseline's within 1e-5, and ``vs_baseline``/``sentinel_overhead_pct``
  follow from the arms' step times.
- ``pretrain.run(guard=True)`` compiles the guard; the eager guard is
  refused there (it guards the eager ``train_step``).
- an eager ``train_step`` (guarded or not) leaves the parameters as plain
  tensors: the compiled step given them afterwards runs its own program,
  not the torch-autograd bridge's, and equals the eager step.
- the traced slab update's decision record equals the reference's.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

import thunder_tpu as tt
from thunder_tpu import optim as joptim
from thunder_tpu.core import dtypes
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch.benchmarks import bench, pretrain
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import tree_leaves
from thunder_tpu_torch.transforms import NumericsGuard

LAYERS, BATCH, SEQ, STEPS = 2, 2, 32, 2
MOMENT_REL = 2e-4
VARIANTS = list(itertools.product(("fused", "naive"), (False, True), (False, True)))


def _reference_run(loss: str, slab: bool, remat: bool):
    jcfg = jllama.CONFIGS["tiny-gqa"]
    params = jllama.init_params(jcfg, seed=0, scale_layers=LAYERS)
    opt = joptim.AdamW(lr=bench.LR, state_dtype=dtypes.float32, v_dtype=dtypes.float32,
                       slab_persistent=slab)
    state = opt.init(params)
    init = (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    base = jllama.fused_loss_fn if loss == "fused" else jllama.loss_fn

    def train_step(params, opt_state, tokens, targets):
        value, grads = tt.value_and_grad(
            lambda p: base(p, tokens, targets, jcfg, remat=remat))(params)
        return value, *opt.update(params, grads, opt_state)

    tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, BATCH, SEQ, seed=0)
    jstep = tt.jit(train_step, donate_argnums=(0, 1), block_fusion=False)
    losses = []
    for _ in range(STEPS + 1):
        value, params, state = jstep(params, state, tok.astype(np.int32), tgt.astype(np.int32))
        losses.append(float(value))
    return init, losses, params, state


@pytest.mark.parametrize("loss,slab,remat", VARIANTS,
                         ids=[f"{l}-{'slab' if s else 'per_step'}-{'remat' if r else 'plain'}"
                              for l, s, r in VARIANTS])
def test_bench_run_matches_the_reference_compiled_step(monkeypatch, loss, slab, remat):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    (jp, js), want, jparams, jstate = _reference_run(loss, slab, remat)
    params = tllama.params_from_jax(jp, device="cpu")
    opt = bench.make_opt("f32", slab_state=slab)
    state = opt.state_from_jax(js, device="cpu")
    out = bench.run("tiny-gqa", layers=LAYERS, batch=BATCH, seq=SEQ, steps=STEPS, loss=loss,
                    opt_state="f32", slab_state=slab, remat=remat, block_fusion=False,
                    device="cpu", params=params, state=state, sentinel=False, baseline=False)
    assert out["compiled"] and out["loss"] == loss and out["slab_persistent"] == slab
    assert all(st["launches"] == {} for st in out["per_step"])
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=0.2 * bench.LR, rtol=0)
    for key in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[key]), tree_leaves(state[key])):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, atol=MOMENT_REL * np.abs(a).max(), rtol=0)
    assert float(state["step"]) == float(np.asarray(jstate["step"])) == STEPS + 1


@pytest.mark.parametrize("slab", [False, True], ids=["per_step", "slab"])
def test_bench_arms_agree(slab):
    out = bench.run("tiny-gqa", layers=LAYERS, batch=BATCH, seq=SEQ, steps=STEPS, remat=True,
                    opt_state="f32", slab_state=slab, device="cpu")
    assert out["sentinel_losses"] == out["losses"]
    np.testing.assert_allclose(out["baseline_losses"], out["losses"], rtol=1e-5)
    assert out["vs_baseline"] == out["baseline_step_ms"] / out["step_ms"]
    assert out["sentinel_overhead_pct"] == pytest.approx(
        (out["sentinel_step_ms"] - out["step_ms"]) / out["step_ms"] * 100)
    counts = out["sentinel_counts"]
    assert counts["steps"] == STEPS + 1 and counts["skipped_steps"] == 0
    assert counts["gated_buckets"] == 1 and counts["last_health_word"][:3] == [0.0, 0.0, 0.0]


def test_pretrain_run_compiles_its_guard():
    out = pretrain.run("tiny-gqa", layers=1, batch=2, seq=16, steps=2, lr=1e-3, device="cpu",
                       guard=True)
    assert out["compiled"] and out["guard"] and out["sentinel"]["healthy_steps"] == 3
    assert out["whole_program"] == "per-call (inputs off the card)"
    with pytest.raises(TypeError, match="NumericsGuardTransform"):
        pretrain.run("tiny-gqa", layers=1, batch=1, seq=8, steps=1, device="cpu",
                     guard=NumericsGuard())
    eager = pretrain.run("tiny-gqa", layers=1, batch=2, seq=16, steps=2, lr=1e-3,
                         device="cpu", eager=True)
    assert not eager["compiled"]
    np.testing.assert_allclose(eager["losses"], out["losses"], rtol=1e-5)
    assert torch.is_grad_enabled()


def test_slab_bucket_decision_matches_reference(monkeypatch):
    """The traced slab update's decision record (one ``bucketed`` verdict a
    bucket, its bytes model with ``pack_bytes_if_unabsorbed`` 0) equals the
    reference's, the estimated times apart (each package's own
    constants)."""
    import thunder_tpu_torch as ptt

    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
    params = jllama.init_params(jcfg, seed=0, scale_layers=1)
    jopt = joptim.AdamW(lr=bench.LR, slab_persistent=True)

    def train_step(params, opt_state, tokens, targets):
        value, grads = tt.value_and_grad(
            lambda p: jllama.fused_loss_fn(p, tokens, targets, jcfg))(params)
        return value, *jopt.update(params, grads, opt_state)

    tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, BATCH, SEQ, seed=0)
    jstep = tt.jit(train_step, donate_argnums=(0, 1))
    jstep.compile(params, jopt.init(params), tok.astype(np.int32), tgt.astype(np.int32))
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    topt = bench.make_opt("f32", slab_state=True)
    tstep = pretrain.jit_train_step(tcfg, topt, loss="fused", device="cpu")
    tstep.compile(tparams, topt.init(tparams), torch.from_numpy(tok), torch.from_numpy(tgt))
    keys = ("tensors", "total_bytes", "saved_launches", "slab_persistent",
            "pack_bytes_if_unabsorbed", "pg_pack_bytes_if_unabsorbed", "dtypes")

    def records(decisions):
        return [(d["decision"], d["reason"], {k: d["cost"][k] for k in keys})
                for d in decisions if d["op"] == "optim.fused_adamw_slab"]

    got = records(ptt.compile_stats(tstep).last_decisions)
    assert got == records(tt.compile_stats(jstep).last_decisions)
    assert len(got) == 1 and got[0][2]["pack_bytes_if_unabsorbed"] == 0


@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
def test_eager_step_leaves_the_parameters_plain(guarded):
    from thunder_tpu_torch.optim import AdamW, tree_map

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=1)
    twin = tree_map(lambda t: t.clone(), params)
    opt = AdamW(lr=1e-3)
    state, twin_state = opt.init(params), opt.init(twin)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 16, 0))
    pretrain.train_step(params, opt, state, tok, tgt, cfg,
                        guard=NumericsGuard() if guarded else None)
    assert not any(p.requires_grad for p in tree_leaves(params))
    step = pretrain.jit_train_step(cfg, opt, device="cpu", block_fusion=False)
    _, new_params, _ = step(params, state, tok, tgt)
    assert not step._autograd_cache and not any(p.requires_grad for p in tree_leaves(new_params))
    for _ in range(2):
        pretrain.train_step(twin, opt, twin_state, tok, tgt, cfg)
    # the bench tests' bound: 0.2 lr (the two steps sum their gradients in
    # another order)
    for a, b in zip(tree_leaves(new_params), tree_leaves(twin)):
        torch.testing.assert_close(a, b, rtol=0, atol=0.2 * opt.lr)
