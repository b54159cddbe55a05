"""thunder_tpu_torch.jit against the JAX package's torch front end and jit,
on the CPU.

(i) Front-end parity: small torch functions (elementwise ops and
promotion, reductions, views and indexing, in-place ops, ``F.linear``,
softmax, ``F.rms_norm``, ``F.scaled_dot_product_attention``,
``F.cross_entropy``, and the MLP and attention blocks of
``test_torch_interop.py`` written as functions) go through
``thunder_tpu.torch.jit`` and ``thunder_tpu_torch.jit`` on the same
numpy-made inputs: the outputs agree, the computation traces' top-level
bound symbols are the same sequence of names, and the port's execution
trace, printed and executed, gives the same output.

(ii) Cache behaviour: one call sequence (same shapes, a new shape, a new
constant) gives the same hits and misses in both packages.

(iii) Claim parity: tiny-gqa's forward and loss, traced for CUDA inputs
without running (the inputs are ``FakeTensor`` stand-ins that report
``cuda:0``), claim the composites the reference's claim-level trace claims
with Pallas in interpret mode, in the same order (``pallas.X`` is
``cuda.X``; the reference's lse-free ``pallas_sdpa`` is the port's
``cuda_sdpa``, which launches ``sdpa_fwd``). One documented difference: the
port also claims the grad-free loss's ``nn.cross_entropy`` (its eager loss
has always launched ``ce_fwd``), which the reference's Pallas executor
leaves to its decomposition.

(iv) The whole slice: ``jit(llama.forward)`` and ``jit(llama.loss_fn)`` on
tiny-gqa with the reference's weights (``params_from_jax``) against the
reference's ``tt.jit`` and against the port's eager call; the rope tables
and rotation, where the jit runs the same torch calls as the eager code in
the same order, bit for bit.

(v) Isolation: a subprocess imports the port and runs a ``jit`` with
neither ``jax`` nor ``thunder_tpu`` in ``sys.modules``.

Tolerances (float32): outputs 1e-5 relative with a 1e-6 absolute floor
(the same operations, summed in another order by XLA and by torch); the
tiny llama's logits and loss 1e-5 relative with a 1e-5 absolute floor, as
``test_torch_port_zoo.py`` holds logits (four layers of sums over 64 to 176
terms in another order: near-zero logits differ by a few 1e-6).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import jax

import thunder_tpu as tt
import thunder_tpu.torch as jtorch
from thunder_tpu.models import llama as jllama
from thunder_tpu.runtime import quarantine as jquarantine
import thunder_tpu_torch as ptt
from thunder_tpu_torch.core.pytree import tree_flatten, tree_map
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.testing import plain_llama_layer
from thunder_tpu_torch.runtime import quarantine as tquarantine

RTOL, ATOL = 1e-5, 1e-6
LOGIT_ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_quarantines():
    jquarantine.reset()
    tquarantine.reset()
    yield
    jquarantine.reset()
    tquarantine.reset()


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _weight(rng, n_out, n_in):
    """A linear weight at the usual 1/sqrt(fan_in) scale."""
    return _rand(rng, n_out, n_in) / float(np.sqrt(n_in))


# ---------------------------------------------------------------------------
# (i) front-end parity
# ---------------------------------------------------------------------------

MASK = torch.tril(torch.ones(16, 16))


def f_elementwise(x, y):
    return torch.exp(x) * y - x / (y.abs() + 1.0)


def f_promotion(x, i):
    return x * i + 2, i * 3 + 1


def f_unary(x, y):
    return torch.tanh(x) * torch.sigmoid(y) + torch.sqrt(torch.abs(x)) - torch.exp(-x * x) \
        + torch.log1p(y.abs())


def f_where(x, y):
    return torch.where(x > 0, x, y * 0.1) + (x <= y).float()


def f_clamp(x, y):
    return torch.clamp(x, min=-0.5, max=0.5) + torch.maximum(x, y) - torch.minimum(x, 0.2 * y)


def f_reductions(x):
    return x.sum(1, keepdim=True) * x.mean() - x.amax(0)


def f_argmax(x):
    return x.argmax(-1), x.amax(-1)


def f_var_std(x):
    return x.var(-1, keepdim=True) + x.std(0).sum()


def f_views(x):
    return x.reshape(2, -1).t().flatten()


def f_permute(x):
    return x.unsqueeze(0).permute(2, 0, 1).squeeze(1)


def f_indexing(x):
    return x[:, 1:5] + x[0, 2:6] - x[::2, :4].sum(0)


def f_cat_stack(x, y):
    return torch.cat([x, y], dim=-1).sum(-1) + torch.stack([x, y]).mean(0)[:, 0]


def f_chunk_split(x, y):
    a, b = x.chunk(2, dim=-1)
    c, d = torch.split(y, [3, 5], dim=1)
    return a * b + c.sum() * d[:, :4]


def f_inplace(x):
    y = x.clone()
    y.add_(1.0)
    y.mul_(x)
    return y


def f_setitem(x):
    y = x.clone()
    y[:, 0] = 1.0
    y[1] = y[2]
    return y


def f_activations(x, y):
    return F.gelu(x) + F.silu(y) + F.relu(x - y) + F.gelu(y, approximate="tanh")


def f_linear(x, w, b):
    return F.linear(x, w, b) + F.linear(x, w) - x @ w.T


def f_bmm(a, b):
    return torch.matmul(a, b) + torch.bmm(a, b)


def f_softmax(x, y):
    return torch.softmax(x, -1) + F.log_softmax(y, dim=0)


def f_layer_norm(x, w, b):
    return F.layer_norm(x, (8,), w, b)


def f_rms_norm(x, w):
    return F.rms_norm(x, (8,), w, eps=1e-5)


def f_embedding(ids, table):
    return F.embedding(ids, table)


def f_sdpa(q, k, v):
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def f_cross_entropy(logits, target):
    return F.cross_entropy(logits, target)


def f_mlp_block(x, ln_w, ln_b, w1, b1, w2, b2):
    h = F.gelu(F.linear(F.layer_norm(x, (x.shape[-1],), ln_w, ln_b), w1, b1), approximate="tanh")
    return x + F.linear(h, w2, b2)


def f_attention_block(x, wqkv, bqkv, wp, bp):
    B, T, C = x.shape
    H = 4
    q, k, v = F.linear(x, wqkv, bqkv).chunk(3, dim=-1)
    q = q.view(B, T, H, C // H).transpose(1, 2)
    k = k.view(B, T, H, C // H).transpose(1, 2)
    v = v.view(B, T, H, C // H).transpose(1, 2)
    att = (q @ k.transpose(-2, -1)) * (1.0 / (C // H) ** 0.5)
    att = att.masked_fill(MASK[:T, :T] == 0, float("-inf"))
    att = F.softmax(att, dim=-1)
    y = (att @ v).transpose(1, 2).contiguous().view(B, T, C)
    return F.linear(y, wp, bp)


def f_sdpa_block(x, wqkv, bqkv):
    B, T, C = x.shape
    H = 4
    q, k, v = F.linear(x, wqkv, bqkv).chunk(3, dim=-1)
    q = q.view(B, T, H, C // H).transpose(1, 2)
    k = k.view(B, T, H, C // H).transpose(1, 2)
    v = v.view(B, T, H, C // H).transpose(1, 2)
    y = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    return y.transpose(1, 2).reshape(B, T, C)


def _inputs(name, rng):
    x, y = _rand(rng, 4, 8), _rand(rng, 4, 8)
    ints = torch.from_numpy(rng.integers(-5, 5, (4, 8)))
    table = {
        "elementwise": (x, y), "promotion": (x, ints), "unary": (x, y), "where": (x, y),
        "clamp": (x, y), "reductions": (x,), "argmax": (x,), "var_std": (x,), "views": (x,),
        "permute": (x,), "indexing": (x,), "cat_stack": (x, y), "chunk_split": (x, y),
        "inplace": (x,), "setitem": (x,), "activations": (x, y),
        "linear": (x, _rand(rng, 16, 8), _rand(rng, 16)),
        "bmm": (_rand(rng, 2, 4, 8), _rand(rng, 2, 8, 5)), "softmax": (x, y),
        "layer_norm": (x, _rand(rng, 8), _rand(rng, 8)), "rms_norm": (x, _rand(rng, 8)),
        "embedding": (torch.from_numpy(rng.integers(0, 11, (3, 5))), _rand(rng, 11, 8)),
        "sdpa": tuple(_rand(rng, 2, 4, 8, 16) for _ in range(3)),
        "cross_entropy": (_rand(rng, 8, 10), torch.from_numpy(rng.integers(0, 10, (8,)))),
        "mlp_block": (_rand(rng, 4, 16), _rand(rng, 16), _rand(rng, 16), _weight(rng, 64, 16),
                      _rand(rng, 64), _weight(rng, 16, 64), _rand(rng, 16)),
        "attention_block": (_rand(rng, 2, 8, 32), _weight(rng, 96, 32), _rand(rng, 96),
                            _weight(rng, 32, 32), _rand(rng, 32)),
        "sdpa_block": (_rand(rng, 2, 8, 32), _weight(rng, 96, 32), _rand(rng, 96)),
    }
    return table[name]


CASES = ["elementwise", "promotion", "unary", "where", "clamp", "reductions", "argmax",
         "var_std", "views", "permute", "indexing", "cat_stack", "chunk_split", "inplace",
         "setitem", "activations", "linear", "bmm", "softmax", "layer_norm", "rms_norm",
         "embedding", "sdpa", "cross_entropy", "mlp_block", "attention_block", "sdpa_block"]


def _top_names(trc):
    return [b.sym.name for b in trc.bound_symbols]


def _assert_outputs_close(got, want):
    gl, wl = tree_flatten(got)[0], jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_front_end_parity(name):
    fn = globals()[f"f_{name}"]
    args = _inputs(name, np.random.default_rng(CASES.index(name)))
    jf = jtorch.jit(fn)
    want = jf(*args)
    pf = ptt.jit(fn, device="cpu")
    got = pf(*args)
    _assert_outputs_close(got, want)
    assert _top_names(ptt.last_traces(pf)[0]) == _top_names(tt.last_traces(jf._jfn)[0])
    # the printed execution trace is a program: run it on the same inputs
    trc = ptt.last_traces(pf)[-1]
    ns = dict(trc.python_ctx())
    exec(compile(trc.python(), f"<{name}>", "exec"), ns)
    again = ns[trc.siginfo().name](*[a for a in tree_flatten(args)[0]
                                     if isinstance(a, torch.Tensor)])
    _assert_outputs_close(again, want)


def test_traces_print_every_stage():
    """The trace stages carry their provenance, and the prologue guards the
    inputs' shapes, dtypes and device."""
    pf = ptt.jit(f_linear, device="cpu")
    pf(*_inputs("linear", np.random.default_rng(0)))
    stages = [str(t.provenance) for t in ptt.last_traces(pf)]
    assert stages == ["# Constructed by Tracing (torch function dispatch)",
                      "# Constructed by Dead code elimination",
                      "# Constructed by Common subexpression elimination",
                      "# Constructed by Transform for execution",
                      "# Constructed by Delete last used"]
    pro = ptt.last_prologue_traces(pf)[0].python()
    assert "check_tensor_shape_and_metadata(arg0, (4, 8), dtypes.float32, 'cpu')" in pro
    assert ptt.last_execution_trace(pf) is ptt.last_traces(pf)[-1]
    assert "del " in ptt.last_execution_trace(pf).python()
    stats = ptt.compile_stats(pf)
    assert set(stats.last_pass_times) == {"trace", "prologue", "dce+cse",
                                          "transform_for_execution", "del_last_used", "codegen"}


# ---------------------------------------------------------------------------
# (ii) cache behaviour
# ---------------------------------------------------------------------------

def f_scaled(x, c):
    return x * c + 1.0


def test_cache_hits_and_misses_match_reference():
    rng = np.random.default_rng(7)
    x, x2 = _rand(rng, 4, 8), _rand(rng, 3, 8)
    calls = [(x, 2.0), (x, 2.0), (x2, 2.0), (x, 3.0), (x2, 2.0), (x, 2.0)]
    jf = jtorch.jit(f_scaled)
    pf = ptt.jit(f_scaled, device="cpu")
    seen = []
    for a, c in calls:
        _assert_outputs_close(pf(a, c), jf(a, c))
        seen.append(((tt.cache_hits(jf._jfn), tt.cache_misses(jf._jfn)),
                     (ptt.cache_hits(pf), ptt.cache_misses(pf))))
    assert all(j == p for j, p in seen)
    assert seen[-1][1] == (3, 3)
    # bind() skips the guard key and runs the bound entry
    bound = pf.bind(x, 2.0)
    np.testing.assert_array_equal(bound(x, 2.0).numpy(), pf(x, 2.0).numpy())


def test_compile_fault_site_and_observe_counters():
    """A fault planned in the ``compile`` domain fails the compile (the
    reference's fault site), and the registry counts misses, hits and
    compiles under the reference's names."""
    from thunder_tpu_torch import observe
    from thunder_tpu_torch.runtime import faults

    x = _rand(np.random.default_rng(8), 4, 8)
    pf = ptt.jit(f_scaled, device="cpu")
    with faults.active(faults.FaultPlan([faults.FaultSpec("compile")])):
        with pytest.raises(faults.InjectedFault, match="compile"):
            pf(x, 2.0)
    observe.enable(clear=True)
    try:
        pf(x, 2.0)
        pf(x, 2.0)
        counters = observe.snapshot()["counters"]
    finally:
        observe.disable()
        observe.reset()
    assert (counters["cache.misses"], counters["cache.hits"], counters["compile.count"]) == \
        (1, 1, 1)


def test_transforms_and_modules_are_not_ported_yet():
    """``jit(transforms=)`` is ported (ROADMAP A.7.6): a transform with the
    base class's hooks leaves the program as it was. ``jit(module,
    seq_buckets=)`` is not (A.7.7)."""
    from thunder_tpu_torch.core.transform_common import Transform

    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    plain = ptt.jit(f_scaled, device="cpu")
    hooked = ptt.jit(f_scaled, device="cpu", transforms=[Transform()])
    assert torch.equal(hooked(x, 2.0), plain(x, 2.0))
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        ptt.jit(torch.nn.Linear(2, 2), seq_buckets=(8,))


# ---------------------------------------------------------------------------
# (iii) claim parity
# ---------------------------------------------------------------------------

_FAKE = FakeTensorMode()


def _on_cuda(t):
    """A stand-in for ``t`` on ``cuda:0``: its shape and dtype, no storage."""
    return FakeTensor(_FAKE, torch.empty(t.shape, dtype=t.dtype, device="meta"),
                      torch.device("cuda:0"))


def _reference_claims(trc) -> list[str]:
    out = []

    def walk(bsyms):
        for b in bsyms:
            name = b.sym.codegen_name()
            if name.startswith("pallas_"):
                out.append(name.removeprefix("pallas_"))
            walk(b.subsymbols)

    walk(trc.bound_symbols)
    return out


def _port_claims(trc) -> list[str]:
    return [b.sym.name for b in trc.bound_symbols
            if b.sym.executor is not None and b.sym.executor.name == "cuda"]


TINY = "tiny-gqa"


def _tiny(seed=0, B=2, T=16):
    jcfg, tcfg = jllama.CONFIGS[TINY], tllama.CONFIGS[TINY]
    jparams = jax.tree.map(np.asarray, jllama.init_params(jcfg, seed=seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (B, T))
    targets = rng.integers(0, jcfg.vocab_size, (B, T))
    return jcfg, tcfg, jparams, tokens, targets


@pytest.mark.parametrize("what", ["forward", "loss"])
def test_claims_match_reference_for_cuda_inputs(what, monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    jcfg, tcfg, jparams, tokens, targets = _tiny()
    tparams = tllama.params_from_jax(jparams, device="cpu")
    if what == "forward":
        jfn, tfn = (lambda p, t: jllama.forward(p, t, jcfg)), \
            (lambda p, t: tllama.forward(p, t, tcfg))
        jargs, targs = (jparams, tokens.astype(np.int32)), (tparams, torch.from_numpy(tokens))
    else:
        jfn, tfn = (lambda p, t, y: jllama.loss_fn(p, t, y, jcfg)), \
            (lambda p, t, y: tllama.loss_fn(p, t, y, tcfg))
        jargs = (jparams, tokens.astype(np.int32), targets.astype(np.int32))
        targs = (tparams, torch.from_numpy(tokens), torch.from_numpy(targets))
    jf = tt.jit(jfn, block_fusion=False)
    jf(*jargs)
    want = _reference_claims(tt.last_traces(jf)[-2])
    L = jcfg.n_layers
    assert want == ["rms_norm"] + ["sdpa", "rms_norm_residual", "linear_act",
                                   "rms_norm_residual"] * L
    pf = ptt.jit(tfn)
    pf.compile(*tree_map(_on_cuda, targs))
    got = _port_claims(ptt.last_execution_trace(pf))
    # the port's own claim: the grad-free loss's cross-entropy (module docstring)
    assert got == want + (["cross_entropy"] if what == "loss" else [])
    ids = [b.sym.id for b in ptt.last_execution_trace(pf).bound_symbols
           if b.sym.executor is not None and b.sym.executor.name == "cuda"]
    assert set(ids) <= {"cuda.rms_norm", "cuda.sdpa_fwd", "cuda.rms_norm_residual",
                        "cuda.linear_act", "cuda.ce_fwd"}


def f_plain_layer(x, *weights):
    """One Llama layer in plain PyTorch (no router of the port), 4 heads."""
    return plain_llama_layer(x, *weights, n_heads=4, n_kv=4)


def _layer_inputs(rng, B=2, T=8, D=32, Fd=64):
    return (_rand(rng, B, T, D), _rand(rng, D), _weight(rng, D, D), _weight(rng, D, D),
            _weight(rng, D, D), _weight(rng, D, D), _rand(rng, D), _weight(rng, Fd, D),
            _weight(rng, Fd, D), _weight(rng, D, Fd))


def test_plain_layer_fuses_and_claims_on_cuda_and_decomposes_on_cpu(monkeypatch):
    """The compiler finds the kernels of a plain-PyTorch layer itself: for
    CUDA inputs the epilogue pass builds rms_norm_residual and linear_act
    and the claim pass takes rms_norm and attention, matching the
    reference's claims of the same function; on the CPU nothing is claimed
    or fused, and the output matches the reference's and eager PyTorch."""
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    args = _layer_inputs(np.random.default_rng(3))
    jf = jtorch.jit(f_plain_layer)
    want = jf(*args)
    jclaims = _reference_claims(tt.last_traces(jf._jfn)[-2])
    assert jclaims == ["rms_norm", "sdpa", "rms_norm_residual", "linear_act"]
    pf = ptt.jit(f_plain_layer)
    pf.compile(*[_on_cuda(a) for a in args])
    trc = ptt.last_execution_trace(pf)
    assert _port_claims(trc) == jclaims
    assert "epilogue fusion: residual add absorbed into rms_norm" in trc.python()
    cpu = ptt.jit(f_plain_layer, device="cpu")
    got = cpu(*args)
    assert _port_claims(ptt.last_execution_trace(cpu)) == []
    assert "epilogue fusion" not in ptt.last_execution_trace(cpu).python()
    _assert_outputs_close(got, want)
    np.testing.assert_allclose(got.numpy(), f_plain_layer(*args).numpy(), rtol=1e-4, atol=1e-5)


def test_unfused_claims_and_a_stack_without_cuda():
    """Without the epilogue pass, the claim pass alone keeps the plain
    layer's adds and activations apart (both norms claimed as rms_norm);
    an executor stack that leaves out ``cuda`` is refused for CUDA inputs,
    as every composite would decompose on the card in place of its kernel,
    and claims nothing for CPU inputs."""
    from thunder_tpu_torch.executors import resolve_executors
    from thunder_tpu_torch.executors.passes import claim_bsym, transform_for_execution

    inputs = _layer_inputs(np.random.default_rng(4))
    pf = ptt.jit(f_plain_layer)
    pf.compile(*[_on_cuda(a) for a in inputs])
    cse_trc = ptt.last_traces(pf)[2]
    claimed = [c for b in cse_trc.bound_symbols for c in claim_bsym(b, pf.executors)]
    assert [c.sym.name for c in claimed if c.sym.executor is not None
            and c.sym.executor.name == "cuda"] == ["rms_norm", "sdpa", "rms_norm"]
    with pytest.raises(ValueError, match="leaves out cuda"):
        transform_for_execution(cse_trc, resolve_executors(["torch"]))
    cpu = ptt.jit(f_plain_layer, device="cpu")
    cpu.compile(*inputs)
    assert _port_claims(transform_for_execution(ptt.last_traces(cpu)[2],
                                                resolve_executors(["torch"]))) == []


@pytest.mark.parametrize("cause, degradable", [
    ("rms_norm: kernel launch failed with CUDA error 700", False),
    ("CUDA error: an illegal memory access was encountered", False),
    ("rms_norm: kernel launch failed with CUDA error 1", True),
])
def test_failed_claim_is_quarantined_only_when_degradable(cause, degradable):
    """A claimed kernel that fails with a degradable error is quarantined and
    the call raises the fatal quarantined error (no rung lies below a claim
    on the card); a sticky CUDA error is fatal as it comes and quarantines
    nothing, as an innocent kernel would stay off across restarts."""
    from thunder_tpu_torch.runtime import faults

    x = _rand(np.random.default_rng(9), 4, 8)
    pf = ptt.jit(f_scaled, device="cpu")
    entry = pf.compile(x, 2.0)
    err = RuntimeError(cause)

    def fail(*inps):
        raise faults.KernelExecutionError("cuda.rms_norm", cause=err) from err

    entry.computation_fn = fail
    with pytest.raises(faults.KernelExecutionError) as got:
        pf(x, 2.0)
    assert tquarantine.is_quarantined("cuda.rms_norm") == degradable
    assert got.value.claim_id == "cuda.rms_norm"
    assert got.value.phase == (faults.QUARANTINED if degradable else "runtime")
    raised = got.value.__cause__ if degradable else got.value
    assert raised.__cause__ is err
    assert ptt.cache_misses(pf) == 1


def test_claim_refused_by_the_kernel_raises_instead_of_decomposing():
    """A claim the checker takes and the kernel refuses (float64, which no
    kernel takes) raises at compile time on the card: nothing decomposes
    there in place of a kernel. An explicit attention mask, which the
    reference's checker refuses, decomposes as there."""
    x, w = torch.zeros(4, 8, dtype=torch.float64), torch.zeros(8, dtype=torch.float64)
    pf = ptt.jit(lambda x, w: F.rms_norm(x, (8,), w, eps=1e-5))
    with pytest.raises(ValueError, match="cuda.rms_norm: the kernel refuses"):
        pf.compile(_on_cuda(x), _on_cuda(w))
    q = torch.zeros(1, 2, 4, 16)
    mask = torch.zeros(4, 4)
    pf = ptt.jit(lambda q, m: F.scaled_dot_product_attention(q, q, q, attn_mask=m))
    pf.compile(_on_cuda(q), _on_cuda(mask))
    assert _port_claims(ptt.last_execution_trace(pf)) == []


# ---------------------------------------------------------------------------
# (iv) the whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["forward", "loss"])
def test_tiny_llama_matches_reference_and_eager(what):
    jcfg, tcfg, jparams, tokens, targets = _tiny(seed=1)
    tparams = tllama.params_from_jax(jparams, device="cpu")
    tt_tokens, tt_targets = torch.from_numpy(tokens), torch.from_numpy(targets)
    if what == "forward":
        jf = tt.jit(lambda p, t: jllama.forward(p, t, jcfg), block_fusion=False)
        want = np.asarray(jf(jparams, tokens.astype(np.int32)))
        pf = ptt.jit(lambda p, t: tllama.forward(p, t, tcfg), device="cpu")
        got = pf(tparams, tt_tokens)
        with torch.no_grad():
            eager = tllama.forward(tparams, tt_tokens, tcfg)
    else:
        jf = tt.jit(lambda p, t, y: jllama.loss_fn(p, t, y, jcfg), block_fusion=False)
        want = np.asarray(jf(jparams, tokens.astype(np.int32), targets.astype(np.int32)))
        pf = ptt.jit(lambda p, t, y: tllama.loss_fn(p, t, y, tcfg), device="cpu")
        got = pf(tparams, tt_tokens, tt_targets)
        with torch.no_grad():
            eager = tllama.loss_fn(tparams, tt_tokens, tt_targets, tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=RTOL, atol=LOGIT_ATOL)
    # a second call hits the cache and gives the same values
    again = pf(tparams, tt_tokens) if what == "forward" else pf(tparams, tt_tokens, tt_targets)
    assert ptt.cache_hits(pf) == 1 and torch.equal(again, got)


def test_rope_is_bitwise_equal_to_eager():
    """Where the jit runs the same torch calls in the same order as the
    eager code (the rope tables and the half rotation), it is bit for bit
    the eager result."""
    cfg = tllama.CONFIGS[TINY]
    x = _rand(np.random.default_rng(5), 2, 4, 16, cfg.head_dim)

    def rope(x):
        cos, sin = tllama._rope_cos_sin(cfg, x.shape[2], x.dtype, device=x.device)
        return tllama._apply_rope(x, cos, sin)

    got = ptt.jit(rope, device="cpu")(x)
    assert torch.equal(got, rope(x))


def test_eager_llama_forward_takes_linear_act_without_a_gradient(monkeypatch):
    """The port's eager grad-free forward routes the MLP gate through
    linear_act, as the reference's grad-free trace claims it; with a
    gradient it keeps the unfused gate (the reference's train trace)."""
    from thunder_tpu_torch.ops import nn as tnn

    jcfg, tcfg, jparams, tokens, _ = _tiny(seed=2)
    tparams = tllama.params_from_jax(jparams, device="cpu")
    calls = []
    orig = tnn.linear_act
    monkeypatch.setattr(tnn, "linear_act", lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert len(calls) == jcfg.n_layers
    calls.clear()
    for t in tparams["layers"][0].values():
        t.requires_grad_(True)
    tllama.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert calls == []   # every later layer's input needs a gradient too


# ---------------------------------------------------------------------------
# (v) isolation
# ---------------------------------------------------------------------------

def test_port_jit_runs_without_jax():
    code = (
        "import sys, torch\n"
        "import thunder_tpu_torch as ptt\n"
        "import torch.nn.functional as F\n"
        "f = ptt.jit(lambda x, w: F.silu(F.rms_norm(x, (8,), w, eps=1e-5)), device='cpu')\n"
        "out = f(torch.ones(2, 8), torch.ones(8))\n"
        "assert out.shape == (2, 8)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'thunder_tpu' or m.startswith('thunder_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_language_contexts_resolve_ops_and_prims():
    """The ops and prims languages resolve the op layer's and the prims'
    names, as the reference's langctxs do."""
    from thunder_tpu_torch import ops
    from thunder_tpu_torch.core import langctxs, prims

    assert langctxs.resolve_method("add") is ops.add
    assert langctxs.resolve_method("rms_norm") is ops.rms_norm
    with langctxs.langctx(langctxs.Languages.PRIMS):
        assert langctxs.resolve_method("add") is prims.add
    with pytest.raises(AttributeError, match="no method 'nonexistent'"):
        langctxs.resolve_method("nonexistent")
