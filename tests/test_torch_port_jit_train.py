"""The compiled train step, ``pretrain.jit_train_step`` (``value_and_grad``
of ``llama.loss_fn`` then ``AdamW.update`` under ``jit`` with the params and
the optimizer state donated), against the JAX package's ``tt.jit(train_step,
block_fusion=False)``, on the CPU.

tiny-gqa at 4 layers, B=2, T=16, float32, ``AdamW(lr=1e-3)``, with and
without ``remat`` (one trace-level checkpointed region per layer):

- the loss and every gradient leaf at the initial weights, then two steps'
  losses, parameters and moments, against the reference's;
- the claims, traced for ``FakeTensor`` stand-ins on ``cuda:0`` without
  running, against the reference's claims with Pallas in interpret mode
  (the reference's lse-free ``pallas_sdpa`` is the port's ``sdpa``, which
  launches ``sdpa_fwd``);
- the jit step against the port's eager ``pretrain.train_step``;
- the donated inputs written in place, the others untouched, and a
  donated input that a view read after the update reaches left unwritten;
- ``update(health=)`` and ``slab_persistent=True`` refused under a trace.

Tolerances (float32): the loss 1e-5 relative; gradients and the first
moments m 1e-5 of each leaf's largest magnitude (the reference's backward
and the port's are the same rules summed in another order), the second
moments v 2e-5 of theirs (v moves by (1 - beta2) g^2, so a gradient's
relative error doubles in it); parameters after
two steps at lr 1e-3 0.2 lr absolute, the bound
``test_torch_port_training.py`` gives and explains: an element whose
gradient lies within float32 summation noise of zero takes an Adam step
whose sign that noise decides.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import jax

import thunder_tpu as tt
from thunder_tpu.models import llama as jllama
from thunder_tpu.optim import AdamW as JAdamW
import thunder_tpu_torch as ptt
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.core.pytree import tree_map
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import AdamW, tree_leaves
from thunder_tpu_torch.testing import claimed_kernels, with_regions

LAYERS, B, T, LR, STEPS = 4, 2, 16, 1e-3, 2


def _grad_close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=rel * scale, rtol=0)


def _jtrain_step(jcfg, jopt, remat):
    def train_step(params, opt_state, tokens, targets):
        loss, grads = tt.value_and_grad(
            lambda p: jllama.loss_fn(p, tokens, targets, jcfg, remat=remat))(params)
        return loss, *jopt.update(params, grads, opt_state)

    return train_step


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "remat"])
def runs(request):
    """Both packages from the same weights, state and batch: the gradients at
    the initial weights, then STEPS compiled steps; the port's eager step
    beside them."""
    remat = request.param
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

        jgrad = tt.jit(tt.value_and_grad(
            lambda p, a, b: jllama.loss_fn(p, a, b, jcfg, remat=remat)), block_fusion=False)
        j0 = jgrad(jparams, jtok, jtgt)
        tgrad = ptt.jit(ptt.value_and_grad(
            lambda p, a, b: tllama.loss_fn(p, a, b, tcfg, remat=remat)), device="cpu")

        def port_tree(tree):
            return tllama.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

        t0 = tgrad(port_tree(jparams), ttok, ttgt)

        jstep = tt.jit(_jtrain_step(jcfg, jopt, remat), block_fusion=False)
        tstep = pretrain.jit_train_step(tcfg, topt, remat=remat)
        jp, js = jparams, jstate
        tp = port_tree(jparams)
        ts = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        ep = port_tree(jparams)
        es = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
        jl, tl, el = [], [], []
        for _ in range(STEPS):
            loss, jp, js = jstep(jp, js, jtok, jtgt)
            jl.append(float(loss))
            loss, tp, ts = tstep(tp, ts, ttok, ttgt)
            tl.append(float(loss))
            el.append(float(pretrain.train_step(ep, topt, es, ttok, ttgt, tcfg, remat=remat)))
        return dict(remat=remat, j0=j0, t0=t0, jl=jl, tl=tl, el=el, jp=jp, js=js, tp=tp, ts=ts,
                    ep=ep, es=es, jstep=jstep, tcfg=tcfg, topt=topt, batch=(ttok, ttgt),
                    port_tree=port_tree, jparams=jparams)
    finally:
        mp.undo()


def test_loss_and_grads_match_reference(runs):
    (jl, jg), (tl, tg) = runs["j0"], runs["t0"]
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jleaves, tleaves = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 3 + 9 * LAYERS
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape
        _grad_close(b.numpy(), a)


def test_two_steps_match_reference(runs):
    np.testing.assert_allclose(runs["tl"], runs["jl"], rtol=1e-5)
    assert runs["tl"][-1] < runs["tl"][0]
    for a, b in zip(jax.tree_util.tree_leaves(runs["jp"]), tree_leaves(runs["tp"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)
    for key, rel in (("m", 1e-5), ("v", 2e-5)):
        for a, b in zip(jax.tree_util.tree_leaves(runs["js"][key]), tree_leaves(runs["ts"][key])):
            _grad_close(b.numpy(), a, rel)
    assert float(runs["ts"]["step"]) == float(np.asarray(runs["js"]["step"])) == STEPS


def test_jit_step_matches_the_eager_step(runs):
    """The compiled step against the port's eager one (autograd, the same
    AdamW), from the same weights and state."""
    np.testing.assert_allclose(runs["tl"], runs["el"], rtol=1e-5)
    for a, b in zip(tree_leaves(runs["ep"]), tree_leaves(runs["tp"])):
        np.testing.assert_allclose(b.numpy(), a.detach().numpy(), atol=0.2 * LR, rtol=0)
    for key, rel in (("m", 1e-5), ("v", 2e-5)):
        for a, b in zip(tree_leaves(runs["es"][key]), tree_leaves(runs["ts"][key])):
            _grad_close(b.numpy(), a.numpy(), rel)


_FAKE = FakeTensorMode()


def _on_cuda(t):
    """A stand-in for ``t`` on ``cuda:0``: its shape and dtype, no storage."""
    return FakeTensor(_FAKE, torch.empty(t.shape, dtype=t.dtype, device="meta"),
                      torch.device("cuda:0"))


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


def test_claims_match_reference_for_cuda_inputs(runs):
    """The reference's claims of this step (interpret mode), and the port's
    for CUDA inputs: the rows of the two tables, per op and in total."""
    want = _reference_claims(tt.last_traces(runs["jstep"])[-2])
    L = LAYERS
    if runs["remat"]:
        assert want == {"rms_norm": 3 * L + 1, "sdpa": L, "sdpa_fwd": L,
                        "rms_norm_residual": L, "sdpa_bwd": L, "ce_fwd": 1, "fused_adamw": 1}
    else:
        assert want == {"rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L,
                        "sdpa_bwd": L, "ce_fwd": 1, "fused_adamw": 1}
    tcfg, topt = runs["tcfg"], runs["topt"]
    params = runs["port_tree"](runs["jparams"])
    step = pretrain.jit_train_step(tcfg, topt, remat=runs["remat"])
    step.compile(*tree_map(_on_cuda, (params, topt.init(params), *runs["batch"])))
    trc = ptt.last_execution_trace(step)
    got: dict[str, int] = {}
    for b in trc.bound_symbols:
        if b.sym.executor is not None and b.sym.executor.name == "cuda":
            got[b.sym.name] = got.get(b.sym.name, 0) + 1
    assert got == want
    ids = {b.sym.id for b in trc.bound_symbols
           if b.sym.executor is not None and b.sym.executor.name == "cuda"}
    assert ids <= {f"cuda.{k}" for k in ("rms_norm", "rms_norm_residual", "sdpa_fwd", "sdpa",
                                         "sdpa_bwd", "ce_fwd", "fused_adamw")}
    # what the card launches: the lse-free sdpa is an sdpa_fwd launch
    launches = dict(want)
    launches["sdpa_fwd"] = launches.get("sdpa_fwd", 0) + launches.pop("sdpa", 0)
    assert claimed_kernels(trc) == with_regions(trc, launches)
    text = trc.python()
    assert "# backward pass begins" in text and "# backward pass ends" in text


def test_donated_inputs_are_written_in_place(runs):
    """With ``donate_argnums=(0, 1)`` the optimizer writes the parameters and
    moments in place: the outputs are the input tensors. Without donation
    nothing of the input is written and the results agree bit for bit."""
    tcfg, topt = runs["tcfg"], runs["topt"]
    tok, tgt = runs["batch"]
    params = runs["port_tree"](runs["jparams"])
    state = topt.init(params)
    before = [t.clone() for t in tree_leaves((params, state))]
    plain = ptt.jit(pretrain.jit_train_step(tcfg, topt, remat=runs["remat"]).fn, device="cpu")
    loss0, p0, s0 = plain(params, state, tok, tgt)
    for a, b in zip(tree_leaves((params, state)), before):
        assert torch.equal(a, b)
    step = pretrain.jit_train_step(tcfg, topt, remat=runs["remat"])
    loss1, p1, s1 = step(params, state, tok, tgt)
    assert float(loss1) == float(loss0)
    for new, old in zip(tree_leaves((p1, s1["m"], s1["v"])),
                        tree_leaves((params, state["m"], state["v"]))):
        assert new is old
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p0, s0))):
        assert torch.equal(a, b)
    fa = [b for b in ptt.last_execution_trace(step).bound_symbols if b.sym.name == "fused_adamw"]
    assert len(fa) == 1 and all(all(g) for g in fa[0].kwargs["donated"])
    assert ptt.last_execution_trace(plain).python().count("donated=") == 1
    assert not any(any(g) for b in ptt.last_execution_trace(plain).bound_symbols
                   if b.sym.name == "fused_adamw" for g in b.kwargs["donated"])


_VIEWS = {"t": lambda w: w.t(), "reshape": lambda w: w.reshape(-1),
          "to-own-dtype": lambda w: w.to(torch.float32)}


@pytest.mark.parametrize("use", ["read-after", "returned"])
@pytest.mark.parametrize("view", list(_VIEWS))
def test_donation_leaves_a_viewed_input_unwritten(view, use):
    """A view of a donated parameter taken before the update (a transpose,
    a reshape, ``.to`` its own dtype: the torch executor returns views or
    the tensor itself) and read after it, or returned, keeps that parameter
    from being written in place: the result is the old weights', as the
    same jit without donation gives, bit for bit; the parameter no view
    reaches and the moments are still written in place."""
    opt = AdamW(lr=1e-2)
    gen = torch.Generator().manual_seed(3)
    params = {"b": torch.randn(4, generator=gen), "w": torch.randn(6, 4, generator=gen)}
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
    make = _VIEWS[view]

    def step(p, s, g):
        kept = make(p["w"])
        p2, s2 = opt.update(p, g, s)
        return (torch.sum(kept) if use == "read-after" else kept), p2, s2

    want = ptt.jit(step, device="cpu")(tree_map(torch.clone, params),
                                       opt.init(params), grads)
    before = params["w"].clone()
    state = opt.init(params)
    got = ptt.jit(step, donate_argnums=(0, 1), device="cpu")(params, state, grads)
    assert torch.equal(got[0], want[0])
    assert torch.equal(params["w"], before) and got[1]["w"] is not params["w"]
    assert got[1]["b"] is params["b"]
    assert all(n is o for n, o in zip(tree_leaves((got[2]["m"], got[2]["v"])),
                                      tree_leaves((state["m"], state["v"]))))
    for a, b in zip(tree_leaves(got[1:]), tree_leaves(want[1:])):
        assert torch.equal(a, b)


def test_health_and_slab_updates_are_refused_under_jit():
    """Both are ported (ROADMAP A.7.5, A.7.6): under ``jit``,
    ``update(health=)`` takes each bucket's gated update (a healthy word
    the eager update's step, an unhealthy one no step at all, the counter
    included), and a slab-persistent ``AdamW`` one ``optim.fused_adamw_slab``
    a bucket, the eager slab step's values."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, 1, 8, 0))
    opt = AdamW()

    def guarded(p, s, a, b, w):
        loss, grads = ptt.value_and_grad(lambda q: tllama.loss_fn(q, a, b, cfg))(p)
        return opt.update(p, grads, s, health=w)

    for word, moves in ((torch.zeros(5), True), (torch.tensor([1.0, 0, 0, 0, 0]), False)):
        params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=1)
        state = opt.init(params)
        p, s = ptt.jit(guarded, device="cpu")(params, state, tok, tgt, word)
        eager_p = tllama.init_params(cfg, seed=0, device="cpu", n_layers=1)
        eager_s = opt.init(eager_p)
        if moves:
            pretrain.train_step(eager_p, opt, eager_s, tok, tgt, cfg)
        for a, b in zip(tree_leaves((p, s)), tree_leaves((eager_p, eager_s))):
            assert torch.allclose(a, b, rtol=0, atol=1e-6) if moves else torch.equal(a, b)
    slab = AdamW(slab_persistent=True)
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=1)
    eager_p = tllama.init_params(cfg, seed=0, device="cpu", n_layers=1)
    eager_s = slab.init(eager_p)
    _, p, s = pretrain.jit_train_step(cfg, slab, device="cpu")(params, slab.init(params),
                                                                 tok, tgt)
    pretrain.train_step(eager_p, slab, eager_s, tok, tgt, cfg)
    for a, b in zip(tree_leaves((p, s)), tree_leaves((eager_p, eager_s))):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_a_failure_after_donation_says_the_state_is_undefined(runs):
    """A program that writes donated inputs in place and then fails raises
    its own error with a note that the donated values are undefined, as
    the reference's does; a program without donation adds no note."""
    tcfg, topt = runs["tcfg"], runs["topt"]
    tok, tgt = runs["batch"]
    params = runs["port_tree"](runs["jparams"])
    state = topt.init(params)

    def fail(*inps):
        raise RuntimeError("a kernel failed")

    for donate in (True, False):
        step = pretrain.jit_train_step(tcfg, topt, remat=runs["remat"])
        if not donate:
            step = ptt.jit(step.fn, device="cpu")
        entry = step.compile(params, state, tok, tgt)
        assert entry.writes_donated == donate
        entry.computation_fn = fail
        with pytest.raises(RuntimeError, match="a kernel failed") as err:
            step(params, state, tok, tgt)
        notes = " ".join(getattr(err.value, "__notes__", []))
        assert ("values are undefined" in notes) == donate
