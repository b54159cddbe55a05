"""``jit(transforms=)`` and the trace utilities of
``core/transform_common.py`` against the JAX package's, on the CPU.

- Two recording transforms on both packages' ``jit``: the same hook order
  (the pre-prologue hooks in list order, the post-optimization hooks in
  list order after the claims, the runtime wrappers built in reverse) and
  the same wrapper nesting at a call (the first transform's outermost).
- ``bsym_list_to_dag`` and ``toposort_bsym_dag`` (top-down, bottom-up and
  with a selector) on the same tiny-gqa loss trace in each package: the
  same roots, leaves and orders, by bound-symbol name.
- ``visitor_transform``: the same rewrite (every add replaced by a sub,
  a negation inserted after every multiply) gives the same program values
  in each package.
- ``ThunderModule``'s parameter overrides, as the reference's.
- ``last_traces(f)[0]`` is the program as traced, before the transforms:
  the guarded tiny-gqa step's first trace prints as the unguarded step's,
  while its execution trace takes the poison inputs and the health pass.
"""

import jax
import numpy as np
import pytest
import torch

import thunder_tpu as tt
from thunder_tpu import ops as jops
from thunder_tpu.core import transform_common as jtc
from thunder_tpu.models import llama as jllama
import thunder_tpu_torch as ptt
from thunder_tpu_torch import ops as tops
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.core import transform_common as ptc
from thunder_tpu_torch.models import llama as tllama


class Recording:
    """A transform that logs each hook it is called through and wraps each
    entry's calls, logging entry and exit."""

    def __init__(self, name: str, log: list):
        self.name, self.log = name, log

    def transform_traces_pre_prologue(self, prologue, computation, epilogue, **kwargs):
        self.log.append(("pre", self.name, computation.bound_symbols[-1].sym.name))
        return prologue, computation, epilogue

    def transform_trace_post_optimization(self, trc, **kwargs):
        self.log.append(("post", self.name, trc.bound_symbols[-1].sym.name))
        return trc

    def transform_module(self, model):
        return model

    def wrap_run_fn(self, jfn, entry, inner):
        self.log.append(("wrap", self.name))

        def wrapped(*inps):
            self.log.append(("enter", self.name))
            out = inner(*inps)
            self.log.append(("exit", self.name))
            return out

        return wrapped


def f_small(x, y):
    return x * 2.0 + y


def test_hook_order_and_wrapper_nesting_match_reference():
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    logs = {}
    for name, jit, kw in (("ref", tt.jit, {}), ("port", ptt.jit, {"device": "cpu"})):
        log: list = []
        jf = jit(f_small, transforms=[Recording("a", log), Recording("b", log)], **kw)
        out = jf(x, y)
        log.append(("result", np.asarray(out).round(6).tolist()))
        jf(x, y)   # a cache hit: the wrappers again, no hook
        logs[name] = log
    assert logs["port"] == logs["ref"]
    assert logs["port"][:6] == [("pre", "a", "python_return"), ("pre", "b", "python_return"),
                                ("post", "a", "python_return"), ("post", "b", "python_return"),
                                ("wrap", "b"), ("wrap", "a")]
    assert logs["port"][6:10] == [("enter", "a"), ("enter", "b"), ("exit", "b"), ("exit", "a")]


def test_the_transform_base_class_matches_reference():
    for hook in ("transform_traces_pre_prologue", "transform_trace_post_optimization",
                 "transform_module"):
        assert hasattr(ptc.Transform, hook) and hasattr(jtc.Transform, hook)
    t = ptc.Transform()
    assert t.transform_traces_pre_prologue(1, 2, 3) == (1, 2, 3)
    assert t.transform_trace_post_optimization("trc") == "trc" and t.transform_module("m") == "m"
    assert [v.name for v in ptc.VisitType] == [v.name for v in jtc.VisitType]


@pytest.fixture(scope="module")
def loss_traces():
    """The DCE'd traces of tiny-gqa's loss (1 layer, B=2, T=16) in each
    package, their bound symbols named alike."""
    jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
    jp = jllama.init_params(jcfg, seed=0, scale_layers=1)
    tp = tllama.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, 2, 16, seed=0)
    jf = tt.jit(lambda p, a, b: jllama.loss_fn(p, a, b, jcfg), block_fusion=False)
    jf(jp, tok.astype(np.int32), tgt.astype(np.int32))
    tf = ptt.jit(lambda p, a, b: tllama.loss_fn(p, a, b, tcfg), device="cpu",
                 block_fusion=False)
    tf(tp, torch.from_numpy(tok), torch.from_numpy(tgt))
    jt, pt = tt.last_traces(jf)[1], ptt.last_traces(tf)[1]
    assert [b.sym.name for b in jt.bound_symbols] == [b.sym.name for b in pt.bound_symbols]
    return jt, pt


def _names(bsyms):
    return [b.sym.name for b in bsyms]


def _orders(mod, trc):
    roots, leaves = mod.bsym_list_to_dag(trc.bound_symbols)
    index = {id(b): i for i, b in enumerate(trc.bound_symbols)}
    # the ready node that comes last in the trace: a selector that reorders
    last = lambda eligible: max(range(len(eligible)),  # noqa: E731
                                key=lambda k: index[id(eligible[k].bsym)])
    return {"roots": _names(n.bsym for n in roots), "leaves": _names(n.bsym for n in leaves),
            "parents": [len(n.parents) for n in roots + leaves],
            "top_down": _names(mod.toposort_bsym_dag(roots, "top_down")),
            "bottom_up": _names(mod.toposort_bsym_dag(leaves, "bottom_up")),
            "selected": _names(mod.toposort_bsym_dag(roots, "top_down", last))}


def test_dag_and_toposort_match_reference(loss_traces):
    jt, pt = loss_traces
    want, got = _orders(jtc, jt), _orders(ptc, pt)
    assert got == want
    assert len(got["top_down"]) == len(got["bottom_up"]) == len(pt.bound_symbols)
    assert got["selected"] != got["top_down"]


def _rewrite(mod, ops, add_ids, mul_ids):
    def visit(bsym):
        if bsym.sym.id in add_ids:
            ops.sub(*bsym.args)
            return mod.VisitType.REPLACE
        if bsym.sym.id in mul_ids:
            ops.neg(bsym.output)
            return mod.VisitType.INSERT_AFTER
        return mod.VisitType.NO_OP

    return visit


def test_visitor_transform_matches_reference():
    """``(x * 2 + y)`` with each add replaced by a sub and a negation
    recorded after each multiply (whose value nothing reads): both
    packages compute ``x * 2 - y`` and record the same ops."""
    from thunder_tpu.core.prims import PrimIDs as JP
    from thunder_tpu_torch.core.prims import PrimIDs as PP

    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    y = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    got = {}
    for name, jit, mod, ops, P, kw in (
            ("ref", tt.jit, jtc, jops, JP, {}),
            ("port", ptt.jit, ptc, tops, PP, {"device": "cpu"})):
        class Rewrite:
            def transform_traces_pre_prologue(self, pro, trc, epi, **kwargs):
                self.seen = mod.visitor_transform(
                    trc, _rewrite(mod, ops, (P.ADD, "ops.add"), (P.MUL, "ops.mul")),
                    provenance="rewrite")
                return pro, self.seen, epi

            def transform_trace_post_optimization(self, trc, **kwargs):
                return trc

        rw = Rewrite()
        out = np.asarray(jit(f_small, transforms=[rw], **kw)(x, y))
        got[name] = (out, _names(rw.seen.bound_symbols))
    np.testing.assert_allclose(got["port"][0], x * 2.0 - y, rtol=1e-6)
    np.testing.assert_allclose(got["ref"][0], got["port"][0], rtol=1e-6)
    assert got["port"][1] == got["ref"][1]
    assert "neg" in got["port"][1] and "add" not in got["port"][1]


def test_module_overrides_match_reference():
    """``ThunderModule``'s ``_overrides_parameters``/``_overrides_buffers``,
    which transforms fill: a call reads the override in place of the live
    parameter, even with grad enabled (no bridge), and ``named_parameters``
    and ``state_dict`` report it; the same as the reference's module."""
    import thunder_tpu.torch as ttorch

    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 3)
    x = torch.randn(2, 4)
    over = torch.full((3, 4), 0.5)
    got = {}
    for name, tm in (("ref", ttorch.jit(lin)), ("port", ptt.jit(lin, device="cpu"))):
        tm._overrides_parameters["weight"] = over if name == "port" else over.numpy()
        out = tm(x)
        params = dict(tm.named_parameters())
        got[name] = (np.asarray(out.detach() if isinstance(out, torch.Tensor) else out),
                     np.asarray(params["weight"]),
                     np.asarray(tm.state_dict()["weight"]))
    want = (x @ over.T + lin.bias).detach().numpy()
    for name in ("ref", "port"):
        np.testing.assert_allclose(got[name][0], want, rtol=1e-6)
        np.testing.assert_array_equal(got[name][1], over.numpy())
        np.testing.assert_array_equal(got[name][2], over.numpy())


def test_first_trace_is_the_program_before_the_transforms():
    from thunder_tpu_torch.optim import AdamW
    from thunder_tpu_torch.transforms import NumericsGuardTransform

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=1)
    opt = AdamW(lr=1e-3)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 16, 0))
    traces = {}
    for name, transforms in (("plain", ()), ("guarded", [NumericsGuardTransform()])):
        step = pretrain.jit_train_step(cfg, opt, transforms=transforms, device="cpu",
                                       block_fusion=False)
        step.compile(params, opt.init(params), tok, tgt)
        traces[name] = ptt.last_traces(step)
    first, last = traces["guarded"][0], traces["guarded"][-1]
    assert first.python() == traces["plain"][0].python()
    assert "numerics_poison_grads" not in first.python()
    assert [a.name for a in last.args[-2:]] == ["numerics_poison_grads", "numerics_poison_loss"]
    assert "fused_adamw_health" in last.python()
