"""``thunder_tpu_torch.jit(nn.Module)`` (``ThunderModule``), ``functional_call``
and the torch-autograd bridge against the JAX package's
``thunder_tpu.torch.jit``, on the CPU.

Each case builds one torch module with seeded weights and hands copies of
it to both packages (and to eager torch): outputs, losses, every ``.grad``
and the buffers written back are compared. The counterparts of
``tests/test_torch_interop.py``'s module, training and alias cases, apart
from those that need batch norm or dropout (ROADMAP A.7.7): an MLP, manual
attention, ``F.scaled_dot_product_attention``, a tied embedding head, a
buffer written in place, train/eval recompiles, ``state_dict`` round trips,
``functional_call`` gradients, an unmodified ``torch.optim`` loop, gradient
accumulation under ``no_sync``, input gradients and the double-backward
error, duplicate output cotangents, the function path's bridge and
``torch_autograd=False``, the alias audit; and ``testing.PlainLlama`` on
tiny-gqa against the port's ``llama.loss_fn`` and the reference's bridge,
with its claims for the card traced on ``FakeTensor`` stand-ins.

Tolerances (float32): outputs and losses 1e-5 relative (1e-4 for the
attention cases, whose softmax sums run in another order); gradients 1e-5
of each leaf's largest magnitude; parameters after four AdamW steps at lr
1e-2 1e-5 absolute (no gradient element sits at float32 noise on these
shapes, so no step's sign flips). PlainLlama's eager loss against
``llama.loss_fn`` 1e-6 relative: the same ops, with ``F.rms_norm`` and
``F.silu`` in place of the port's plain norm and ``y * sigmoid(y)``.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import thunder_tpu as tt
import thunder_tpu.torch as ttorch
import thunder_tpu_torch as ptt
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.testing import PlainLlama, claimed_kernels, with_regions
from thunder_tpu_torch.torch import AliasedInputMutationError, functional_call
from thunder_tpu_torch.torch.autograd_bridge import compile_autograd_step

RTOL, GRAD_REL = 1e-5, 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _grad_close(got, want, rel=GRAD_REL):
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, atol=rel * scale, rtol=0)


def _copies(make, seed=0):
    """Three copies of one seeded module: eager, reference, port."""
    torch.manual_seed(seed)
    m = make()
    return m, copy.deepcopy(m), copy.deepcopy(m)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d=16):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)
        self.ln = nn.LayerNorm(d)

    def forward(self, x):
        h = F.gelu(self.fc1(self.ln(x)), approximate="tanh")
        return x + self.fc2(h)


class TinyAttention(nn.Module):
    def __init__(self, d=32, h=4, maxlen=16):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.h = h
        self.register_buffer("bias", torch.tril(torch.ones(maxlen, maxlen)))

    def forward(self, x):
        B, T, C = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = q.view(B, T, self.h, C // self.h).transpose(1, 2)
        k = k.view(B, T, self.h, C // self.h).transpose(1, 2)
        v = v.view(B, T, self.h, C // self.h).transpose(1, 2)
        att = (q @ k.transpose(-2, -1)) * (1.0 / (C // self.h) ** 0.5)
        att = att.masked_fill(self.bias[:T, :T] == 0, float("-inf"))
        y = F.softmax(att, dim=-1) @ v
        return self.proj(y.transpose(1, 2).contiguous().view(B, T, C))


class SDPABlock(nn.Module):
    def __init__(self, d=32, h=4):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.h = h

    def forward(self, x):
        B, T, C = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = q.view(B, T, self.h, C // self.h).transpose(1, 2)
        k = k.view(B, T, self.h, C // self.h).transpose(1, 2)
        v = v.view(B, T, self.h, C // self.h).transpose(1, 2)
        y = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return y.transpose(1, 2).reshape(B, T, C)


class Tied(nn.Module):
    def __init__(self, v=11, d=8):
        super().__init__()
        self.emb = nn.Embedding(v, d)
        self.head = nn.Linear(d, v, bias=False)
        self.head.weight = self.emb.weight   # weight tying

    def forward(self, ids):
        return self.head(self.emb(ids))


CASES = {
    "mlp": (MLP, lambda: torch.randn(4, 16), 1e-5),
    "attention": (TinyAttention, lambda: torch.randn(2, 8, 32), 1e-4),
    "sdpa": (SDPABlock, lambda: torch.randn(2, 8, 32), 1e-4),
    "tied": (Tied, lambda: torch.randint(0, 11, (3, 5)), 1e-5),
}


@pytest.mark.parametrize("path", ["bridge", "no_grad"])
@pytest.mark.parametrize("case", list(CASES))
def test_module_matches_reference_and_eager(case, path):
    """Each module in eval mode, through the bridge (with grad: outputs
    tracked by autograd, then the gradients of ``sum(out**2)``) and through
    the grad-free program, against the reference's and eager torch's."""
    make, inp, rtol = CASES[case]
    m, mr, mp = _copies(make)
    for mod in (m, mr, mp):
        mod.eval()
    x = inp()
    jr, jp = ttorch.jit(mr), ptt.jit(mp, device="cpu")
    if path == "no_grad":
        with torch.no_grad():
            want, ref, got = m(x), jr(x), jp(x)
        assert got.grad_fn is None
        _close(got, want, rtol)
        _close(got, ref, rtol)
        assert not jp._autograd_cache and ptt.cache_misses(jp) == 1
        return
    want, ref, got = m(x), jr(x), jp(x)
    assert got.grad_fn is not None
    _close(got, want, rtol)
    _close(got, ref, rtol)
    for mod, out in ((m, want), (mr, ref), (mp, got)):
        (out * out).sum().backward()
    for (name, p), (_, pr), (_, pp) in zip(m.named_parameters(), mr.named_parameters(),
                                           mp.named_parameters()):
        _grad_close(pp.grad, p.grad, 1e-4 if rtol > 1e-5 else GRAD_REL)
        _grad_close(pp.grad, pr.grad, 1e-4 if rtol > 1e-5 else GRAD_REL)
    if case == "tied":   # both sites trace to one input, which sums both gradients
        assert len(dict(jp.named_parameters())) == 1
        step = next(iter(jp._autograd_cache.values()))
        assert step.n_params == 1


class Running(nn.Module):
    """Buffers written in place while training: an exponential mean and a
    step count (the epilogue writes them back)."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 4)
        self.register_buffer("mean", torch.zeros(4))
        self.register_buffer("count", torch.zeros(()))

    def forward(self, x):
        h = self.fc(x)
        if self.training:
            self.mean.mul_(0.9).add_(0.1 * h.detach().mean(0))
            self.count.add_(1.0)
        return h - self.mean


def test_buffers_written_in_place_come_back():
    """Two bridge calls then a grad-free one: after each, the live module's
    buffers equal eager torch's and the reference's."""
    m, mr, mp = _copies(Running)
    jr, jp = ttorch.jit(mr), ptt.jit(mp, device="cpu")
    rng = np.random.RandomState(0)
    for i in range(3):
        x = torch.tensor(rng.randn(5, 4).astype(np.float32))
        if i < 2:
            want, ref, got = m(x), jr(x), jp(x)
            assert got.grad_fn is not None
        else:
            with torch.no_grad():
                want, ref, got = m(x), jr(x), jp(x)
        _close(got, want)
        _close(got, ref)
        for name in ("mean", "count"):
            _close(getattr(mp, name), getattr(m, name))
            _close(getattr(mp, name), getattr(mr, name))
    assert float(mp.count) == 3.0


class Branchy(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 4)

    def forward(self, x):
        h = self.fc(x)
        return h * 2.0 if self.training else h * 3.0


def test_train_eval_recompile_and_state_dict_round_trip():
    """train() and eval() compile one bridge pair each and agree with the
    reference's; a state_dict round trip between two ThunderModules and a
    torch module keeps the outputs."""
    m, mr, mp = _copies(Branchy)
    jr, jp = ttorch.jit(mr), ptt.jit(mp, device="cpu")
    x = torch.randn(2, 4)
    for mode in ("eval", "train"):
        getattr(jr, mode)()
        getattr(jp, mode)()
        getattr(m, mode)()
        _close(jp(x), m(x))
        _close(jp(x), jr(x))
        assert jp.training == (mode == "train")
    assert len(jp._autograd_cache) == len(jr._autograd_cache) == 2

    torch.manual_seed(1)
    other = MLP()
    jm, jo = ptt.jit(MLP(), device="cpu"), ptt.jit(other, device="cpu")
    m2 = MLP()
    m2.load_state_dict(jm.state_dict())
    jo.load_state_dict(jm.state_dict())
    xm = torch.randn(2, 16)
    with torch.no_grad():
        _close(jo(xm), jm(xm))
        _close(m2(xm), jm(xm))
    assert set(jm.state_dict()) == set(ttorch.jit(MLP()).state_dict())
    with pytest.raises(RuntimeError, match="missing keys"):
        jo.load_state_dict({"fc1.weight": other.fc1.weight})


def test_functional_call_grads_match_torch_autograd():
    """``grad`` of a loss over ``functional_call(module, params, ...)`` under
    ``jit``, against the reference's and torch autograd's."""
    m = MLP(d=8).eval()
    x = torch.randn(4, 8)

    def loss_fn(params, xv):
        out, _ = functional_call(m, params, (xv,))
        return (out * out).sum()

    params = {k: v.detach() for k, v in m.named_parameters()}
    g = ptt.jit(ptt.grad(loss_fn), device="cpu")(params, x)

    def jloss_fn(params, xv):
        out, _ = ttorch.functional_call(m, params, (xv,))
        return tt.ops.sum(tt.ops.mul(out, out))

    jg = tt.jit(tt.grad(jloss_fn))({k: ttorch.tensor_to_jax(v) for k, v in params.items()},
                                    ttorch.tensor_to_jax(x))
    out = m(x)
    tg = torch.autograd.grad((out * out).sum(), list(m.parameters()))
    for (name, _), want in zip(m.named_parameters(), tg):
        _grad_close(g[name], want)
        _grad_close(g[name], jg[name])


def test_unmodified_torch_training_loop():
    """``jit(model)``, ``loss.backward()`` and a stock ``torch.optim.AdamW``
    for four steps: losses and parameters equal eager torch's and the
    reference's; one compiled pair serves every step."""
    def make():
        return nn.Sequential(nn.Linear(8, 32), nn.GELU(), nn.Linear(32, 4))

    mods = _copies(make)
    jr, jp = ttorch.jit(mods[1]), ptt.jit(mods[2], device="cpu")
    calls = (mods[0], jr, jp)
    opts = [torch.optim.AdamW(mod.parameters(), lr=1e-2) for mod in mods]
    rng = np.random.RandomState(0)
    for _ in range(4):
        x = torch.tensor(rng.randn(16, 8).astype(np.float32))
        y = torch.tensor(rng.randn(16, 4).astype(np.float32))
        losses = []
        for call, opt in zip(calls, opts):
            loss = F.mse_loss(call(x), y)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        assert abs(losses[2] - losses[0]) <= RTOL * abs(losses[0])
        assert abs(losses[2] - losses[1]) <= RTOL * abs(losses[1])
    for p, pr, pp in zip(*(mod.parameters() for mod in mods)):
        np.testing.assert_allclose(_np(pp), _np(p), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_np(pp), _np(pr), atol=1e-5, rtol=0)
    assert len(jp._autograd_cache) == 1


def test_grad_accumulation_under_no_sync():
    """Three microbatches' ``backward()`` accumulate into ``.grad`` as in
    eager torch and the reference."""
    mods = _copies(lambda: nn.Linear(6, 3), seed=3)
    jr, jp = ttorch.jit(mods[1]), ptt.jit(mods[2], device="cpu")
    rng = np.random.RandomState(2)
    with jp.no_sync(), jr.no_sync():
        assert jp._grad_sync is False
        for _ in range(3):
            x = torch.tensor(rng.randn(4, 6).astype(np.float32))
            y = torch.tensor(rng.randn(4, 3).astype(np.float32))
            for call in (mods[0], jr, jp):
                F.mse_loss(call(x), y).backward()
    assert jp._grad_sync is True
    for p, pr, pp in zip(*(mod.parameters() for mod in mods)):
        _grad_close(pp.grad, p.grad)
        _grad_close(pp.grad, pr.grad)


def test_input_grads_and_the_double_backward_error():
    """Gradients reach an input that requires grad; a second backward
    through the same graph raises, with or without ``retain_graph``."""
    mods = _copies(lambda: nn.Linear(5, 5).eval(), seed=1)
    jp = ptt.jit(mods[2], device="cpu")
    x = torch.randn(3, 5, requires_grad=True)
    xs = [x.detach().clone().requires_grad_(True) for _ in range(2)]
    loss = jp(x).pow(2).sum()
    loss.backward()
    mods[0](xs[0]).pow(2).sum().backward()
    ttorch.jit(mods[1])(xs[1]).pow(2).sum().backward()
    _grad_close(x.grad, xs[0].grad)
    _grad_close(x.grad, xs[1].grad)
    with pytest.raises(RuntimeError, match="backward through the (same )?graph a? ?second"
                                           "|backward through the same graph twice"):
        loss.backward()
    loss = jp(x).pow(2).sum()
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="backward through the same graph twice"):
        loss.backward()


class Dup(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 4)

    def forward(self, x):
        h = self.fc(x)
        return h, h


def test_duplicate_output_cotangents_accumulate():
    """A module returning one tensor twice accumulates both cotangents."""
    mods = _copies(Dup)
    jr, jp = ttorch.jit(mods[1]), ptt.jit(mods[2], device="cpu")
    x = torch.randn(3, 4)
    for call in (mods[0], jr, jp):
        y1, y2 = call(x)
        (2.0 * y1.sum() + 3.0 * y2.sum()).backward()
    for p, pr, pp in zip(*(mod.parameters() for mod in mods)):
        _grad_close(pp.grad, p.grad)
        _grad_close(pp.grad, pr.grad)


def test_function_bridge_and_opt_out():
    """``jit(fn)`` called on a tensor that requires grad returns an
    autograd-tracked loss whose ``backward()`` runs the compiled backward
    (one compiled pair for two calls); under ``no_grad`` or with
    ``torch_autograd=False`` the grad-free program runs."""
    def fn(x, w):
        return torch.tanh(x @ w).pow(2).sum()

    torch.manual_seed(0)
    x = torch.randn(4, 5)
    w = torch.randn(5, 3, requires_grad=True)
    w_eager, w_ref = (w.detach().clone().requires_grad_(True) for _ in range(2))
    jf = ptt.jit(fn, device="cpu")
    loss = jf(x, w)
    assert isinstance(loss, torch.Tensor) and loss.grad_fn is not None
    loss.backward()
    fn(x, w_eager).backward()
    ttorch.jit(fn)(x, w_ref).backward()
    _grad_close(w.grad, w_eager.grad)
    _grad_close(w.grad, w_ref.grad)
    w.grad = None
    jf(x, w).backward()
    _grad_close(w.grad, w_eager.grad)
    assert len(jf._autograd_cache) == 1 and ptt.cache_misses(jf) == 0
    with torch.no_grad():
        out = jf(x, w)
    assert out.grad_fn is None and ptt.cache_misses(jf) == 1
    _close(out, loss)
    jo = ptt.jit(fn, device="cpu", torch_autograd=False)
    out = jo(x, w)
    assert out.grad_fn is None and not jo._autograd_cache
    _close(out, loss)


# ---------------------------------------------------------------------------
# the alias audit (the reference's TestInputAliasGuards)
# ---------------------------------------------------------------------------

def _add_one(a, b):
    a.add_(1.0)
    return a + b


def test_alias_overlapping_views_mutated_raise():
    base = torch.arange(8, dtype=torch.float32)
    for jit in (ttorch.jit, lambda f: ptt.jit(f, device="cpu")):
        with pytest.raises((AliasedInputMutationError, ttorch.AliasedInputMutationError),
                           match="overlaps"):
            jit(_add_one)(base[0:4], base[2:6])


def test_alias_read_only_and_disjoint_views_are_fine():
    base = torch.arange(8, dtype=torch.float32)
    jf = ptt.jit(lambda a, b: a + b, device="cpu")
    _close(jf(base[0:4], base[2:6]), base[0:4] + base[2:6])
    got = ptt.jit(_add_one, device="cpu")(base[0:4], base[4:8])
    _close(got, ttorch.jit(_add_one)(base[0:4], base[4:8]))
    _close(got, base[0:4] + 1 + base[4:8])


def test_alias_distinct_tensors_do_not_retrace():
    def f(a, b):
        a.mul_(2.0)
        return a + b

    jf = ptt.jit(f, device="cpu")
    _close(jf(torch.ones(4), torch.ones(4) * 3), [5.0] * 4)
    _close(jf(torch.full((4,), 2.0), torch.full((4,), 5.0)), [9.0] * 4)
    assert ptt.cache_misses(jf) == 1 and ptt.cache_hits(jf) == 1


def test_alias_pattern_specializes_the_cache():
    def f(a, b):
        a.add_(10.0)
        return a + b

    jf = ptt.jit(f, device="cpu")
    _close(jf(torch.zeros(4), torch.ones(4)), [11.0] * 4)
    base = torch.zeros(8)
    with pytest.raises(AliasedInputMutationError):
        jf(base[0:4], base[1:5])


def test_alias_audit_covers_the_bridge_and_the_module_path():
    w = torch.randn(4, requires_grad=True)

    def f(w, a, b):
        a.add_(1.0)
        return (w * a + b).sum()

    jf = ptt.jit(f, device="cpu")
    base = torch.zeros(8)
    with pytest.raises(AliasedInputMutationError):
        jf(w, base[0:4], base[2:6])
    jf(w, torch.ones(4), torch.ones(4)).backward()
    assert w.grad is not None

    class Mut(nn.Module):
        def forward(self, a, b):
            a.add_(1.0)
            return a + b

    tm = ptt.jit(Mut(), device="cpu")
    with torch.no_grad():
        with pytest.raises(AliasedInputMutationError):
            tm(base[0:4], base[2:6])
        out = tm(torch.zeros(4), torch.ones(4))
    _close(out, ttorch.jit(Mut())(torch.zeros(4), torch.ones(4)))


# ---------------------------------------------------------------------------
# PlainLlama: the module phase 20 trains on the card
# ---------------------------------------------------------------------------

LAYERS, B, T = 2, 2, 16


@pytest.fixture(scope="module")
def plain_llama():
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=LAYERS)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, B, T, 0))
    return cfg, params, tok, tgt


def test_plain_llama_computes_llama_loss_fn(plain_llama):
    cfg, params, tok, tgt = plain_llama
    m = PlainLlama.from_llama_params(cfg, params)
    want = float(tllama.loss_fn(params, tok, tgt, cfg))
    assert abs(float(m(tok, tgt).detach()) - want) <= 1e-6 * abs(want)
    # copies: training the module leaves the parameter dict as it was
    assert m.tok_embedding.weight.data_ptr() != params["tok_embedding"].data_ptr()


def test_plain_llama_bridge_matches_reference(plain_llama):
    """The port's bridge against the reference's and eager torch's: the
    loss and every gradient; then a grad-free call's loss."""
    cfg, params, tok, tgt = plain_llama
    m = PlainLlama.from_llama_params(cfg, params)
    mr, mp = copy.deepcopy(m), copy.deepcopy(m)
    jp = ptt.jit(mp, device="cpu")
    losses = [call(tok, tgt) for call in (m, ttorch.jit(mr), jp)]
    for loss in losses:
        loss.backward()
    want, ref, got = (float(x) for x in losses)
    assert abs(got - want) <= RTOL * abs(want) and abs(got - ref) <= RTOL * abs(ref)
    for (name, p), (_, pr), (_, pp) in zip(m.named_parameters(), mr.named_parameters(),
                                           mp.named_parameters()):
        _grad_close(pp.grad, p.grad)
        _grad_close(pp.grad, pr.grad)
    with torch.no_grad():
        assert abs(float(jp(tok, tgt)) - got) <= RTOL * abs(got)


def test_plain_llama_claims_on_the_card(plain_llama):
    """Traced for ``FakeTensor`` stand-ins on ``cuda:0`` without running, at
    llama3-8b-bench width: the bridge's forward claims rms_norm 1, sdpa_fwd
    L, rms_norm_residual 2L and ce_fwd 1, its backward sdpa_bwd L (the cost
    model, forward and backward counted, keeps the per-op rung); the
    grad-free program, whose forward-only verdict plans each MLP sub-block,
    rms_norm 1 + L, sdpa_fwd L (the lse-free ``sdpa``), mlp_subblock L and
    ce_fwd 1, and with ``block_fusion=False`` (phase 20's program)
    rms_norm 1, sdpa_fwd L, rms_norm_residual 2L, linear_act L and ce_fwd 1."""
    mode = FakeTensorMode()

    def fake(shape, dtype):
        return FakeTensor(mode, torch.empty(shape, dtype=dtype, device="meta"),
                          torch.device("cuda:0"))

    cfg = tllama.CONFIGS["llama3-8b-bench"]
    m = PlainLlama(cfg, n_layers=LAYERS, device="meta")
    for mod in m.modules():
        for k, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[k] = fake(p.shape, p.dtype).requires_grad_(True)
    tm = ptt.jit(m)
    tm._jfn.device = torch.device("cuda:0")
    tok, tgt = fake((2, 128), torch.int64), fake((2, 128), torch.int64)
    step = compile_autograd_step(tm, (tok, tgt), {})
    L = LAYERS
    assert claimed_kernels(step.fwd_trace) == with_regions(step.fwd_trace, {
        "rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L, "ce_fwd": 1})
    assert claimed_kernels(step.bwd_trace) == with_regions(step.bwd_trace, {"sdpa_bwd": L})
    assert [d["decision"] for d in ptt.compile_stats(tm).last_decisions
            if d["kind"] == "block"] == ["cost-rejected"] * L
    with torch.no_grad():
        tm._jfn.compile(dict(m.named_parameters()), {}, False, (tok, tgt), {})
    trc = ptt.last_execution_trace(tm)
    assert claimed_kernels(trc) == with_regions(trc, {
        "rms_norm": 1 + L, "sdpa_fwd": L, "mlp_subblock": L, "ce_fwd": 1})
    assert [d["decision"] for d in ptt.compile_stats(tm).last_decisions
            if d["kind"] == "block"] == ["planned"] * L
    per_op = ptt.jit(m, block_fusion=False)
    per_op._jfn.device = torch.device("cuda:0")
    with torch.no_grad():
        per_op._jfn.compile(dict(m.named_parameters()), {}, False, (tok, tgt), {})
    trc = ptt.last_execution_trace(per_op)
    assert claimed_kernels(trc) == with_regions(trc, {
        "rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L, "linear_act": L, "ce_fwd": 1})


def test_bf16_layer_gradients_against_float32():
    """A bf16 plain-PyTorch Llama layer (D 512, 8/2 heads, F 1024, T 256)
    through the function bridge, with x and the weights requiring grad: each
    gradient within 5e-2 of a row's largest value of float32 autograd's on
    the same inputs, of eager bf16 autograd's and of the reference's bridge.
    bf16 eager autograd and the reference are themselves about 2e-2 off the
    float32 gradients here (the bound chip_smoke.py's MODULE_GRAD_TOL
    states): two bf16 computations of a gradient round at different
    points."""
    from thunder_tpu_torch.testing import plain_llama_layer, row_rel_err

    gen = torch.Generator().manual_seed(181)
    Dm, Fd, H, KV, T = 512, 1024, 8, 2, 256

    def dense(n_out, n_in):
        return (torch.randn(n_out, n_in, generator=gen) * n_in ** -0.5).to(torch.bfloat16)

    def norm_w():
        return (torch.rand(Dm, generator=gen) + 0.5).to(torch.bfloat16)

    kv = KV * Dm // H
    inputs = (torch.randn(1, T, Dm, generator=gen).to(torch.bfloat16), norm_w(), dense(Dm, Dm),
              dense(kv, Dm), dense(kv, Dm), dense(Dm, Dm), norm_w(), dense(Fd, Dm),
              dense(Fd, Dm), dense(Dm, Fd))

    def layer(x, *w):
        return plain_llama_layer(x, *w, n_heads=H, n_kv=KV)

    def grads(fn, ts):
        leaves = [t.detach().clone().requires_grad_(True) for t in ts]
        fn(*leaves).float().square().mean().backward()
        return [t.grad for t in leaves]

    f32 = grads(layer, [t.float() for t in inputs])
    got = grads(ptt.jit(layer, device="cpu"), inputs)
    for want in (f32, grads(layer, inputs), grads(ttorch.jit(layer), inputs)):
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16 and row_rel_err(a, b) <= 5e-2
