"""thunder_tpu_torch's model zoo against the JAX package, on the CPU.

Each family of ``thunder_tpu_torch/models/`` (the five tiny ``gpt`` configs,
nanogpt's ``gpt2-tiny``, seq2seq's ``tiny`` and ``resnet-tiny``) gets the
reference's weights (carried across by the family's ``params_from_jax``)
and the same numpy batch, made from a seed. The reference runs its train
step under ``tt.jit(step, block_fusion=False)`` with its Pallas claims in
interpret mode, as the JAX package's own tests run them; the port runs the
same step eagerly (``benchmarks/zoo.train_step``: the loss, autograd, the
optimizer in place). Compared: the loss, every gradient, the parameters and
optimizer state after the step, the grad-free forward's logits, and the
routed calls of one port step against the Pallas claims of the reference's
trace (of the train step and of the grad-free forward). ``SGD`` with and
without momentum and weight decay against the reference's, resnet's
batch-norm state and eval mode, each family's own ``init_params`` tree
against the reference's, and ``gpt.num_params`` at the published
geometries.

Tolerances (float32 throughout):
- losses 1e-5 relative and logits 1e-5 absolute: the same operations,
  summed in another order;
- gradients 1e-6 absolute (the largest are ~0.1-1; float32 sums of a few
  hundred terms in another order differ by ~1e-8 of them);
- AdamW after one step at lr 1e-3: parameters within 0.2 lr where the
  reference's gradient stands above 1e-6, and within 2 lr where it lies
  within 1e-6 of zero (the first Adam step ``lr * g / (|g| + eps)`` takes
  the sign of a noise-level gradient, such as a key bias's, which is zero
  in exact arithmetic); m 1e-6 and v 1e-9 absolute;
- SGD after three steps 1e-6 absolute (float32 updates; XLA contracts the
  multiply-adds into FMAs, each a half-ulp apart);
- resnet: batch-norm running statistics 1e-6 absolute (float32 batch
  means and variances over a few thousand values in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import thunder_tpu as tt
from thunder_tpu.models import gpt as jgpt
from thunder_tpu.models import nanogpt as jnano
from thunder_tpu.models import resnet as jres
from thunder_tpu.models import seq2seq as js2s
from thunder_tpu.optim import SGD as JSGD
from thunder_tpu.optim import AdamW as JAdamW
from thunder_tpu_torch.benchmarks import zoo
from thunder_tpu_torch.models import gpt as tgpt
from thunder_tpu_torch.models import nanogpt as tnano
from thunder_tpu_torch.models import resnet as tres
from thunder_tpu_torch.models import seq2seq as ts2s
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.ops import optim as toptim_ops
from thunder_tpu_torch.optim import SGD, AdamW, tree_leaves

LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-6
LOGIT_ATOL = 1e-5
PARAM_ATOL = 0.2 * LR
M_ATOL, V_ATOL = 1e-6, 1e-9
BATCH, SEQ, SRC_SEQ, IMAGE = 2, 32, 48, 16

GPT_TINY = ("tiny", "tiny-neox", "tiny-falcon", "tiny-gemma", "tiny-phi")
ROUTED = ("sdpa_fwd", "sdpa_bwd", "ce_fwd", "rms_norm", "rms_norm_residual", "linear_act")


# ---------------------------------------------------------------------------
# helpers (test_torch_port_mixtral.py imports them)
# ---------------------------------------------------------------------------

def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_batch(batch):
    """The port's batch tensors as the reference takes them (int32 tokens)."""
    return tuple(b.numpy().astype(np.int32) if b.dtype == torch.int64 else b.numpy()
                 for b in batch)


def claims(trc) -> dict:
    """The Pallas claims of a reference trace, by the port's kernel name
    (the lse-free forward ``pallas_sdpa`` counts as ``sdpa_fwd``: the port
    runs one forward kernel for both)."""
    counts = {}

    def walk(bsyms):
        for b in bsyms:
            name = b.sym.codegen_name()
            if name.startswith("pallas_"):
                key = name.removeprefix("pallas_")
                key = "sdpa_fwd" if key == "sdpa" else key
                counts[key] = counts.get(key, 0) + 1
            walk(b.subsymbols)

    walk(trc.bound_symbols)
    return counts


def port_calls(fn) -> dict:
    """``fn()`` run with every router of ``ops/`` counted: the routed calls
    by kernel name (on a card, each is one launch)."""
    calls = {}

    def counting(mod, attr):
        orig = getattr(mod, attr)

        def wrapped(*a, **k):
            calls[attr] = calls.get(attr, 0) + 1
            return orig(*a, **k)

        mp.setattr(mod, attr, wrapped)

    with pytest.MonkeyPatch.context() as mp:
        for attr in ROUTED:
            counting(tnn, attr)
        counting(toptim_ops, "fused_adamw")
        fn()
    return calls


def assert_trees_close(got, want, atol, rtol=0.0):
    """The port's tree against the reference's, leaf for leaf in the
    reference's flattening order (shapes equal)."""
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert len(wl) == len(gl)
    for a, b in zip(wl, gl):
        b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert b.shape == np.shape(a)
        np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=atol, rtol=rtol)


def assert_adam_params_close(got, want, want_grads):
    """Parameters after one AdamW step: within PARAM_ATOL where the
    reference's gradient stands above the gradient tolerance; where it lies
    within it of zero (a bias whose gradient is zero in exact arithmetic,
    such as a key bias under softmax's shift invariance), the first Adam
    step ``lr * g / (|g| + eps)`` takes the sign of float32 noise, so the
    two can differ by up to 2 lr there."""
    for a, b, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got),
                       jax.tree_util.tree_leaves(want_grads)):
        diff = np.abs(b.detach().float().numpy() - np.asarray(a, np.float32))
        settled = np.abs(np.asarray(g, np.float32)) > GRAD_ATOL
        assert float(np.max(diff, where=settled, initial=0.0)) <= PARAM_ATOL
        assert float(diff.max(initial=0.0)) <= 2.0 * LR * (1.0 + 1e-3)


def assert_same_tree_shapes(got, want):
    """The port's own ``init_params`` tree has the reference's leaves, in
    its flattening order, with the same shapes and dtypes."""
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert [(tuple(a.shape), str(np.asarray(a).dtype)) for a in wl] == \
        [(tuple(b.shape), str(b.dtype).removeprefix("torch.")) for b in gl]


def reference_step(loss, jopt):
    """The reference's train step: ``(loss, grads, new params, new state)``."""
    def step(params, opt_state, *batch):
        value, grads = tt.value_and_grad(lambda p: loss(p, *batch))(params)
        return (value, grads, *jopt.update(params, grads, opt_state))

    return step


def compare_step(model, jloss, jparams, tparams, batch, monkeypatch, jit_forward=None,
                 tforward=None, tloss=None):
    """With ``jit_forward``/``tforward``, the grad-free logits at the shared
    weights and the routed calls against the claims of that trace; then one
    AdamW step of both packages from the same weights and batch: loss,
    gradients, parameters, moments, and the routed calls of the port's
    step against the reference trace's claims. ``tloss(params, *batch)``
    replaces the named model's loss (a variant of its config)."""
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    jopt = JAdamW(lr=LR)
    jstate = jopt.init(jparams)
    jb = jax_batch(batch)
    fwd_claims = None
    if jit_forward is not None:
        jf = tt.jit(jit_forward, block_fusion=False)
        want_logits = np.asarray(jf(jparams, *jb[:-1]))
        fwd_claims = claims(tt.last_execution_trace(jf))
        out = {}

        def run():
            with torch.no_grad():
                out["logits"] = tforward(tparams, *batch[:-1])

        assert port_calls(run) == fwd_claims
        np.testing.assert_allclose(out["logits"].numpy(), want_logits, atol=LOGIT_ATOL, rtol=0)

    jstep = tt.jit(reference_step(jloss, jopt), block_fusion=False)
    jl, jg, jp, js = jstep(jparams, jstate, *jb)
    want_claims = claims(tt.last_execution_trace(jstep))

    topt = AdamW(lr=LR)
    tstate = topt.init(tparams)
    if tloss is None:
        def port_loss(p):
            return zoo.loss_of(model, p, batch)
    else:
        def port_loss(p):
            return tloss(p, *batch), None
    tl, tg, _ = zoo.value_and_grad(port_loss, tparams)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_trees_close(tg, jg, GRAD_ATOL)
    topt.update(tparams, tg, tstate)
    assert_adam_params_close(tparams, jp, jg)
    assert_trees_close(tstate["m"], js["m"], M_ATOL)
    assert_trees_close(tstate["v"], js["v"], V_ATOL)
    assert float(tstate["step"]) == float(np.asarray(js["step"])) == 1.0

    assert want_claims == zoo.expected_launches(model)
    got = port_calls(lambda: topt.update(tparams, zoo.value_and_grad(port_loss, tparams)[1],
                                         tstate))
    assert got == want_claims
    return fwd_claims


# ---------------------------------------------------------------------------
# gpt: the five tiny configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GPT_TINY)
def test_gpt_train_step_and_forward_match_reference(name, monkeypatch):
    """Loss, gradients (the tied embedding's two uses summed for
    tiny-gemma), one AdamW step, and the grad-free logits of each tiny gpt
    config against the reference's; the port's routed calls against the
    claims of the reference's train-step trace (no ``linear_act``: the gelu
    backward keeps the pre-activation) and of its grad-free forward (one
    ``linear_act`` a layer for the gelu and GeGLU MLPs; SwiGLU has none)."""
    jcfg, tcfg = jgpt.CONFIGS[name], tgpt.CONFIGS[name]
    jparams = jgpt.init_params(jcfg, seed=3)
    tparams = tgpt.params_from_jax(as_numpy(jparams), device="cpu")
    batch = zoo.make_batch(f"gpt/{name}", BATCH, SEQ, seed=5, device="cpu")
    fwd = compare_step(f"gpt/{name}", lambda p, a, b: jgpt.loss_fn(p, a, b, jcfg), jparams,
                       tparams, batch, monkeypatch,
                       jit_forward=lambda p, a: jgpt.forward(p, a, jcfg),
                       tforward=lambda p, a: tgpt.forward(p, a, tcfg))
    assert fwd.get("linear_act", 0) == (jcfg.n_layers if jcfg.mlp != "swiglu" else 0)
    if jcfg.tie_embedding:
        assert "lm_head" not in tparams


def test_gpt_swiglu_and_gqa_switches_match_reference(monkeypatch):
    """The switches no named tiny config sets: SwiGLU with rmsnorm and GQA
    (2 kv heads for 4 query heads), untied head."""
    jcfg = dataclasses.replace(jgpt.CONFIGS["tiny"], norm="rmsnorm", mlp="swiglu",
                               n_kv_heads=2, intermediate_size=96)
    tcfg = dataclasses.replace(tgpt.CONFIGS["tiny"], norm="rmsnorm", mlp="swiglu",
                               n_kv_heads=2, intermediate_size=96)
    jparams = jgpt.init_params(jcfg, seed=4)
    tparams = tgpt.params_from_jax(as_numpy(jparams), device="cpu")
    batch = zoo.make_batch("gpt/tiny", BATCH, SEQ, seed=6, device="cpu")
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    jl, jg = tt.jit(tt.value_and_grad(lambda p, a, b: jgpt.loss_fn(p, a, b, jcfg)),
                    block_fusion=False)(jparams, *jax_batch(batch))
    for p in tree_leaves(tparams):
        p.requires_grad_(True)
    tl = tgpt.loss_fn(tparams, *batch, tcfg)
    tg = torch.autograd.grad(tl, tree_leaves(tparams))
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_trees_close(list(tg), jax.tree_util.tree_leaves(jg), GRAD_ATOL)


def test_gpt_num_params_match_reference_at_published_geometries():
    for name, jcfg in jgpt.CONFIGS.items():
        assert tgpt.num_params(tgpt.CONFIGS[name]) == jgpt.num_params(jcfg), name
        assert tgpt.num_params(tgpt.CONFIGS[name], 2) == jgpt.num_params(jcfg, 2), name
    assert tgpt.num_params(tgpt.CONFIGS["falcon-7b"]) == 7_217_189_760


def test_gpt_init_params_shapes_and_scale_match_reference():
    jcfg, tcfg = jgpt.CONFIGS["tiny-phi"], tgpt.CONFIGS["tiny-phi"]
    j = jax.eval_shape(lambda: jgpt.init_params(jcfg, seed=0))
    t = tgpt.init_params(tcfg, seed=0, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(j), tree_leaves(t)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    assert all(b.dtype == torch.float32 for b in tl)
    w = t["layers"][0]["w_proj"]          # N(0, 1/F)
    assert abs(float(w.std()) * (tcfg.ffn_dim ** 0.5) - 1.0) < 0.05
    assert float(t["layers"][0]["bq"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# nanogpt, seq2seq
# ---------------------------------------------------------------------------

def test_nanogpt_train_step_and_forward_match_reference(monkeypatch):
    """gpt2-tiny: the fused qkv split, tanh-gelu (``linear_act(gelu_tanh)``
    in the grad-free forward), the tied head."""
    jcfg, tcfg = jnano.CONFIGS["gpt2-tiny"], tnano.CONFIGS["gpt2-tiny"]
    jparams = jnano.init_params(jcfg, seed=2)
    tparams = tnano.params_from_jax(as_numpy(jparams), device="cpu")
    batch = zoo.make_batch("nanogpt/gpt2-tiny", BATCH, SEQ, seed=7, device="cpu")
    fwd = compare_step("nanogpt/gpt2-tiny", lambda p, a, b: jnano.loss_fn(p, a, b, jcfg),
                       jparams, tparams, batch, monkeypatch,
                       jit_forward=lambda p, a: jnano.forward(p, a, jcfg),
                       tforward=lambda p, a: tnano.forward(p, a, tcfg))
    assert fwd == {"sdpa_fwd": jcfg.n_layer, "linear_act": jcfg.n_layer}
    assert_same_tree_shapes(tnano.init_params(tcfg, seed=0, device="cpu"), jparams)


def test_nanogpt_dropout_draws_from_the_generator():
    """With dropout the masks come from the caller's ``torch.Generator``:
    the same seed gives the same loss, another seed another one, and
    without training the loss is dropout-free (ROADMAP C, "Known
    differences": the masks differ from the reference's by design)."""
    cfg = dataclasses.replace(tnano.CONFIGS["gpt2-tiny"], dropout=0.2)
    params = tnano.init_params(cfg, seed=0, device="cpu")
    tok, tgt = zoo.make_batch("nanogpt/gpt2-tiny", BATCH, SEQ, seed=1, device="cpu")

    def loss(seed, training=True):
        gen = torch.Generator().manual_seed(seed)
        return float(tnano.loss_fn(params, tok, tgt, cfg, training=training, generator=gen))

    assert loss(1) == loss(1) != loss(2)
    plain = tnano.loss_fn(params, tok, tgt, dataclasses.replace(cfg, dropout=0.0))
    assert loss(1, training=False) == float(plain)
    x = torch.ones(20000)
    kept = tnano.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert abs(float((kept > 0).float().mean()) - 0.75) < 0.02
    assert torch.allclose(kept[kept > 0], torch.full_like(kept[kept > 0], 1 / 0.75))


def test_seq2seq_train_step_and_forward_match_reference(monkeypatch):
    """The encoder, the causal decoder and its non-causal cross-attention
    over a longer source (T 32 against S 48); every norm of the train step
    a ``rms_norm_residual`` (the embedding adds folded in), the grad-free
    forward's two embedding norms ``rms_norm`` and its FFNs ``linear_act``."""
    jcfg, tcfg = js2s.CONFIGS["tiny"], ts2s.CONFIGS["tiny"]
    jparams = js2s.init_params(jcfg, seed=1)
    tparams = ts2s.params_from_jax(as_numpy(jparams), device="cpu")
    batch = zoo.make_batch("seq2seq/tiny", BATCH, SEQ, seed=8, device="cpu", src_seq=SRC_SEQ)
    fwd = compare_step("seq2seq/tiny", lambda p, s, a, b: js2s.loss_fn(p, s, a, b, jcfg),
                       jparams, tparams, batch, monkeypatch,
                       jit_forward=lambda p, s, a: js2s.forward(p, s, a, jcfg),
                       tforward=lambda p, s, a: ts2s.forward(p, s, a, tcfg))
    n_norms = 2 * jcfg.enc_layers + 3 * jcfg.dec_layers + 1
    assert fwd == {"sdpa_fwd": jcfg.enc_layers + 2 * jcfg.dec_layers, "rms_norm": 2,
                   "rms_norm_residual": n_norms - 2,
                   "linear_act": jcfg.enc_layers + jcfg.dec_layers}
    assert_same_tree_shapes(ts2s.init_params(tcfg, seed=0, device="cpu"), jparams)


def test_seq2seq_rejects_a_sequence_past_its_positions():
    cfg = ts2s.CONFIGS["tiny"]
    params = ts2s.init_params(cfg, seed=0, device="cpu")
    too_long = torch.zeros((1, cfg.max_seq_len + 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        ts2s.forward(params, too_long, too_long[:, :4], cfg)


# ---------------------------------------------------------------------------
# SGD, resnet
# ---------------------------------------------------------------------------

SGD_CASES = [(0.0, 0.0), (0.9, 0.0), (0.0, 0.01), (0.9, 0.01)]


@pytest.mark.parametrize("momentum,weight_decay", SGD_CASES,
                         ids=[f"mom{m}-wd{w}" for m, w in SGD_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_matches_reference(momentum, weight_decay, dtype):
    """Three SGD steps on a tree with a None leaf (resnet's missing
    projection), float32 or bf16 parameters, float32 momenta: parameters
    and momenta against the reference's."""
    import jax.numpy as jnp

    rng = np.random.RandomState(9)
    shapes = {"a": (4, 8), "b": [(8,), None], "c": {"w": (3, 3, 2)}}
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def tree(fn):
        return {"a": fn(shapes["a"]), "b": [fn(shapes["b"][0]), None],
                "c": {"w": fn(shapes["c"]["w"])}}

    jp = tree(lambda s: jnp.asarray(rng.randn(*s).astype(np.float32), jd))
    grads = [tree(lambda s: jnp.asarray(rng.randn(*s).astype(np.float32), jd))
             for _ in range(3)]
    jopt = JSGD(lr=0.1, momentum=momentum, weight_decay=weight_decay)
    js = jopt.init(jp)
    topt = SGD(lr=0.1, momentum=momentum, weight_decay=weight_decay)
    conv = tgpt.params_from_jax
    tp = conv(as_numpy(jp), device="cpu")
    ts = topt.init(tp)
    assert (ts == {}) == (momentum == 0.0)
    jupd = tt.jit(jopt.update)
    for g in grads:
        jp, js = jupd(jp, g, js)
        tp, ts = topt.update(tp, conv(as_numpy(g), device="cpu"), ts)
    assert tp["b"][1] is None
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    assert_trees_close(tp, jp, tol, rtol=0 if dtype == "float32" else 2.0 ** -7)
    if momentum:
        assert_trees_close(ts["mom"], js["mom"], 1e-6, rtol=1e-6)


def _resnet_pair(seed=0):
    jcfg, tcfg = jres.CONFIGS["resnet-tiny"], tres.CONFIGS["resnet-tiny"]
    jparams, jstate = jres.init_params(jcfg, seed=seed)
    tparams, tstate = tres.params_from_jax(as_numpy((jparams, jstate)), device="cpu")
    return jcfg, tcfg, jparams, jstate, tparams, tstate


def test_resnet_train_step_state_and_eval_match_reference(monkeypatch):
    """resnet-tiny: the loss, every gradient and the new batch-norm state
    of a training step, the parameters after one SGD(momentum=0.9) step,
    then eval-mode logits from the updated statistics; the step's routed
    calls against the reference trace's claims (``ce_fwd`` only)."""
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    jcfg, tcfg, jparams, jstate, tparams, tstate = _resnet_pair()
    x, y = zoo.make_batch("resnet/resnet-tiny", 4, 0, seed=3, device="cpu", image=IMAGE)
    jx, jy = x.numpy(), y.numpy().astype(np.int32)
    jopt = JSGD(lr=LR, momentum=0.9)

    def jstep(params, mom, state, xx, yy):
        (value, new_state), grads = tt.value_and_grad(
            lambda p: jres.loss_fn(p, xx, yy, jcfg, state=state), has_aux=True)(params)
        new_p, new_m = jopt.update(params, grads, mom)
        return value, grads, new_state, new_p, new_m

    jf = tt.jit(jstep, block_fusion=False)
    jl, jg, jns, jp, _ = jf(jparams, jopt.init(jparams), jstate, jx, jy)
    assert claims(tt.last_execution_trace(jf)) == zoo.expected_launches("resnet/resnet-tiny")

    topt = SGD(lr=LR, momentum=0.9)
    tmom = topt.init(tparams)
    tl, tg, tns = zoo.value_and_grad(
        lambda p: zoo.loss_of("resnet/resnet-tiny", p, (x, y), tstate), tparams)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_trees_close(tg, jg, GRAD_ATOL)
    assert_trees_close(tns, jns, 1e-6)
    assert not any(t.requires_grad for t in tree_leaves(tns))
    topt.update(tparams, tg, tmom)
    assert_trees_close(tparams, jp, 1e-6)

    jlog, jst = tt.jit(lambda p, s, xx: jres.forward(p, xx, jcfg, state=s, training=False))(
        as_numpy(jp), as_numpy(jns), jx)
    with torch.no_grad():
        tlog, tst = tres.forward(tparams, x, tcfg, state=tns, training=False)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    assert all(a is b for a, b in zip(tree_leaves(tst), tree_leaves(tns)))

    got = port_calls(lambda: zoo.train_step(
        "resnet/resnet-tiny", tparams, topt, tmom, (x, y), tstate))
    assert got == {"ce_fwd": 1}


def test_resnet_forward_without_state_runs_eval_on_identity_statistics():
    jcfg, tcfg, jparams, _, tparams, _ = _resnet_pair(seed=2)
    x, _ = zoo.make_batch("resnet/resnet-tiny", 2, 0, seed=4, device="cpu", image=IMAGE)
    jlog, _ = tt.jit(lambda p, xx: jres.forward(p, xx, jcfg))(jparams, x.numpy())
    with torch.no_grad():
        tlog, ts = tres.forward(tparams, x, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
    assert float(ts["stem"]["var"].min()) == 1.0
    assert_same_tree_shapes(tres.init_params(tcfg, seed=0, device="cpu"),
                            jres.init_params(jcfg, seed=0))


# ---------------------------------------------------------------------------
# the zoo's entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["gpt/tiny-gemma", "nanogpt/gpt2-tiny", "seq2seq/tiny",
                                   "resnet/resnet-tiny"])
def test_zoo_run_trains_on_the_cpu(model):
    """``benchmarks.zoo.run`` on the CPU: finite losses that fall on the
    repeated batch, and no kernel launch (plain versions only)."""
    out = zoo.run(model, batch=2, seq=32, steps=2, lr=1e-2 if "resnet" in model else 1e-3,
                  device="cpu", src_seq=SRC_SEQ, image=IMAGE)
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert all(s["launches"] == {} for s in out["per_step"])
    assert "card" not in out


def test_zoo_refuses_unknown_models_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="unknown model"):
        zoo.split_name("gpt/none")
    with pytest.raises(ValueError, match="unknown model"):
        zoo.split_name("llama/tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        zoo.run("gpt/tiny", steps=0)
