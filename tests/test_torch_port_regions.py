"""The region executor (``thunder_tpu_torch/executors/regionex.py``) on the
CPU, where a region runs its plain chain (the members' torch calls in
order), against the reference's XLA executor and against the same programs
with ``region_disable_fusion=True``.

- tiny-gqa's ``pretrain.jit_train_step`` at 4 layers, plain and remat, with
  regions, against the reference's ``tt.jit(train_step,
  block_fusion=False)`` (Pallas in interpret mode): the loss and every
  gradient at the initial weights, then two steps' losses, parameters and
  moments, at ``test_torch_port_jit_train.py``'s tolerances (the loss 1e-5
  relative; gradients and m 1e-5, v 2e-5 of each leaf's largest magnitude;
  parameters 0.2 lr absolute);
- the same step with regions against ``region_disable_fusion=True``: the
  losses, parameters and moments bit for bit;
- the traced serving engine's tokens with regions against the engine with
  the executor's optimization fuel at 0 (no region);
- a region's generated source: the same at two shapes, another for another
  dtype; every constant printed exactly (a float32 hex literal that reads
  back to the constant); ``--fmad=false`` and no fast math in the flags;
- the options ``region_disable_fusion``, ``region_min_region_size`` and
  ``region_partitioner`` act as the reference's ``xla_*`` do.
"""

import re

import jax
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu.torch as jtorch
from thunder_tpu.models import llama as jllama
from thunder_tpu.optim import AdamW as JAdamW
import thunder_tpu_torch as ptt
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.core import prims
from thunder_tpu_torch.executors import regionex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import AdamW, tree_leaves
from thunder_tpu_torch.testing import regions_of

LAYERS, B, T, LR, STEPS = 4, 2, 16, 1e-3, 2
FUSIBLE = {"broadcast_in_dim", "convert_element_type"}


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
    """The reference's step and the port's, with regions and without, from
    the same weights, state and batch."""
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

        def port_tree(tree):
            return tllama.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")

        jgrad = tt.jit(tt.value_and_grad(
            lambda p, a, b: jllama.loss_fn(p, a, b, jcfg, remat=remat)), block_fusion=False)
        j0 = jgrad(jparams, jtok, jtgt)
        tgrad = ptt.jit(ptt.value_and_grad(
            lambda p, a, b: tllama.loss_fn(p, a, b, tcfg, remat=remat)), device="cpu")
        t0 = tgrad(port_tree(jparams), ttok, ttgt)
        grad_regions = len(regions_of(ptt.last_execution_trace(tgrad)))

        jstep = tt.jit(_jtrain_step(jcfg, jopt, remat), block_fusion=False)
        jp, js, jl = jparams, jstate, []
        for _ in range(STEPS):
            loss, jp, js = jstep(jp, js, jtok, jtgt)
            jl.append(float(loss))
        out = {}
        for name, opts in (("on", {}), ("off", {"region_disable_fusion": True})):
            step = pretrain.jit_train_step(tcfg, topt, remat=remat, **opts)
            tp = port_tree(jparams)
            ts = topt.state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
            tl = []
            for _ in range(STEPS):
                loss, tp, ts = step(tp, ts, ttok, ttgt)
                tl.append(loss.clone())
            out[name] = dict(tl=tl, tp=tp, ts=ts, trc=ptt.last_execution_trace(step))
        return dict(j0=j0, t0=t0, grad_regions=grad_regions, jl=jl, jp=jp, js=js, **out)
    finally:
        mp.undo()


def test_regions_form_of_unclaimed_elementwise_prims(runs):
    """The step's execution trace holds regions, each of at least two
    unclaimed elementwise, broadcast or convert prims, reductions, or views
    that add or drop 1s: an elementwise region of one output shape, a
    region with reductions of one space (its members of shape S, its
    reductions of S over the space's dims D, a row space's column sums
    over its kept dims, its per-row members of the kept shape); with
    regions off it holds none."""
    regions = regions_of(runs["on"]["trc"])
    assert len(regions) > 10 and runs["grad_regions"] > 10
    assert any(r.spec.rows for r in regions)
    for r in regions:
        assert len(r.members) >= 2
        for b in r.members:
            assert b.sym.executor is None
            assert (prims.OpTags.ELEMENTWISE_OP in b.sym.tags or b.sym.name in FUSIBLE
                    or regionex._reduced_dims(b) or regionex.is_unit_view(b)), b
        if r.spec.design == "elementwise":
            assert len({tuple(b.flat_proxy_outs()[0].shape) for b in r.members}) == 1
            continue
        S, D = r.spec.cols if r.spec.cols else (r.spec.rows[0], tuple(
            range(len(r.spec.rows[0]) - r.spec.rows[1], len(r.spec.rows[0]))))
        kept = [n for d, n in enumerate(S) if d not in D and n != 1]
        for b in r.members:
            out = tuple(b.flat_proxy_outs()[0].shape)
            if regionex._reduced_dims(b):
                # a reduction of S over the space's dims, or a row space's
                # column sum over its kept dims
                assert tuple(b.args[0].shape) == S and (
                    regionex._reduced_dims(b) == D
                    or r.spec.rows and regionex.is_column_sum(b, *r.spec.rows)), b
            else:
                assert out == S or [n for n in out if n != 1] == kept, (b, S)
    assert regions_of(runs["off"]["trc"]) == []
    assert "region_fusion0" in runs["on"]["trc"].python()


def test_loss_and_grads_match_reference(runs):
    (jl, jg), (tl, tg) = runs["j0"], runs["t0"]
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jleaves, tleaves = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 3 + 9 * LAYERS
    for a, b in zip(jleaves, tleaves):
        _grad_close(b.numpy(), a)


def test_two_steps_match_reference(runs):
    on = runs["on"]
    np.testing.assert_allclose([float(x) for x in on["tl"]], runs["jl"], rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(runs["jp"]), tree_leaves(on["tp"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)
    for key, rel in (("m", 1e-5), ("v", 2e-5)):
        for a, b in zip(jax.tree_util.tree_leaves(runs["js"][key]), tree_leaves(on["ts"][key])):
            _grad_close(b.numpy(), a, rel)


def test_regions_equal_regions_off_bit_for_bit(runs):
    on, off = runs["on"], runs["off"]
    assert all(torch.equal(a, b) for a, b in zip(on["tl"], off["tl"]))
    for a, b in zip(tree_leaves((on["tp"], on["ts"])), tree_leaves((off["tp"], off["ts"]))):
        assert torch.equal(a, b)


def test_serving_tokens_unchanged_with_regions(monkeypatch):
    """The traced engine (tiny-gqa float32, 2 layers) with regions and with
    the region executor's fuel at 0 (no region forms): the same tokens;
    the decode program holds regions only in the first."""
    from thunder_tpu_torch.serving import ServingEngine

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32) for n in (1, 9, 20)]
    out = []
    for fuel in (None, 0):
        monkeypatch.setattr(regionex.ex, "_fuel", fuel)
        eng = ServingEngine(params, cfg, device="cpu", max_slots=2, page_size=8,
                            max_context=64, prefill_chunk=16)
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.drain()
        out.append(([r.output().tolist() for r in reqs],
                    len(regions_of(eng.runner._decode_bound.entry.traces[-1]))))
    assert out[0][0] == out[1][0]
    assert out[0][1] > 0 and out[1][1] == 0


def _chain(a, b):
    return torch.exp(a * b + 0.1) / 3.0 - torch.rsqrt(a * a + 1e-5) * -2.5


def _region_specs(fn, *args, **opts):
    jf = ptt.jit(fn, device="cpu", **opts)
    jf(*args)
    return [r.spec for r in regions_of(ptt.last_execution_trace(jf))]


def test_source_keyed_by_structure_not_shapes():
    (a,) = _region_specs(_chain, torch.rand(4, 8), torch.rand(4, 8))
    (b,) = _region_specs(_chain, torch.rand(16, 3), torch.rand(16, 3))
    (c,) = _region_specs(_chain, torch.rand(4, 8, dtype=torch.float16),
                         torch.rand(4, 8, dtype=torch.float16))
    assert a.source == b.source and a.entry == b.entry
    assert c.source != a.source
    assert "ttr::rnd_f16" in c.source and "ttr::rnd_f16" not in a.source
    assert a.transcendental


def test_constants_printed_exactly():
    """Every float literal in the source is a float32 hex literal; the
    constants read back exactly: 0.1 and 1e-5 as float32, -2.5, and the
    division by 3 as torch computes it, times float32(1) / float32(3)."""
    (spec,) = _region_specs(_chain, torch.rand(4, 8), torch.rand(4, 8))
    lits = re.findall(r"(-?0x[0-9a-f.]+p[+-]\d+)f", spec.source)
    got = {np.float32(float.fromhex(x)) for x in lits}
    want = {np.float32(0.1), np.float32(1e-5), np.float32(-2.5),
            np.float32(1.0) / np.float32(3.0)}
    assert want <= got, (lits, spec.source)
    assert not re.search(r"[^x0-9a-fA-F_.]\d+\.\d+", spec.source.split("\n", 1)[1])


def test_no_fma_contraction_and_no_fast_math():
    flags = " ".join(regionex.NVCC_FLAGS)
    assert "--fmad=false" in flags and "fast_math" not in flags and "fast-math" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags


def _count(jf, name):
    return jf.python().count(f"= {name}_fusion")


def _options_fn(a, b):
    x = (a + 1.0) * 2.0
    s = b.sum().item()
    y = (a + 3.0) * 4.0
    return x + y, s


@pytest.mark.parametrize("case", ["disable", "min_size", "contiguous", "dataflow"])
def test_options_act_as_the_reference(case):
    """Each option on both packages over the same program (two elementwise
    chains on either side of an ``item``): disabling fusion forms no region;
    a minimum size above every region's forms none; the contiguous
    partitioner splits at the ``item`` (two regions), the dataflow one
    joins the chains (one)."""
    opts, want = {
        "disable": ({"disable_fusion": True}, 0),
        "min_size": ({"min_region_size": 100}, 0),
        "contiguous": ({"partitioner": "contiguous"}, 2),
        "dataflow": ({"partitioner": "dataflow", "min_region_size": 2}, 1),
    }[case]
    args = (torch.ones(4, 4), torch.ones(2))
    jf = jtorch.jit(_options_fn, **{f"xla_{k}": v for k, v in opts.items()})
    jout = jf(*args)
    tf = ptt.jit(_options_fn, device="cpu", **{f"region_{k}": v for k, v in opts.items()})
    tout = tf(*args)
    assert _count(tt.last_traces(jf._jfn)[-1], "xla") == want
    assert _count(ptt.last_execution_trace(tf), "region") == want
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    read = ptt.last_compile_options(tf)
    assert all(f"region_{k}" in read for k in opts)


def test_unknown_partitioner_raises():
    with pytest.raises(ValueError, match="region_partitioner"):
        ptt.jit(_options_fn, device="cpu", region_partitioner="greedy")(torch.ones(2),
                                                                         torch.ones(2))


@pytest.mark.parametrize("what", ["plain chain", "train step"])
def test_calls_leave_no_reference_cycle(what):
    """A region's plain chain and a compiled step leave nothing for the
    cyclic collector: every tensor they make is freed when its last
    reference goes (a cycle would hold card memory until a collection; the
    port's pytree flatten was one, a closure that called itself)."""
    import gc

    if what == "plain chain":
        jf = ptt.jit(lambda x, y: torch.exp(x - y).to(torch.bfloat16) * 2.0 + 1.0, device="cpu")
        jf(torch.randn(8, 16), torch.randn(8, 1))
        (region,) = regions_of(ptt.last_execution_trace(jf))
        vals = [torch.randn(8, 16), torch.randn(8, 1)]
        call = lambda: region.plain(*vals)  # noqa: E731
    else:
        cfg = tllama.CONFIGS["tiny-gqa"]
        params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
        opt = AdamW(lr=LR)
        state = [(params, opt.init(params))]
        tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, B, T, 0))
        step = pretrain.jit_train_step(cfg, opt, device="cpu")

        def call():
            _, p, s = step(*state[0], tok, tgt)
            state[0] = (p, s)
    call()
    gc.collect()
    gc.disable()
    try:
        call()
        assert gc.collect() == 0
    finally:
        gc.enable()
