"""Reductions over any dims in the region executor
(``thunder_tpu_torch/executors/regionex.py``) on the CPU, where a region
runs its plain chain (its members' torch calls).

- The port's partitioner under the region executor's predicate, which now
  takes ``sum``, ``prod``, ``amax`` and ``amin`` over any dims, gives the
  reference partitioner's groups over a program with leading, middle,
  trailing and all-dims reductions and a ``prod`` (``fuse_bound_symbols``
  of both packages); each reduction sits in a region, and each region's
  plain run gives the reference's ``xla`` region's outputs from the same
  numpy inputs (made from a seed) within the stated float32 bounds: a sum
  within twice its bound in any order (``testing.sum_bound``: the two
  packages' orders differ), a product within twice its relative bound
  (``testing.prod_bound``), ``amax``/``amin`` exactly.
- tiny-gqa's compiled train step at 2 layers: no reduction left as a torch
  call, the norm weights' column sums in their norm backward's row space
  (the product they sum no longer written), the GQA group sums in regions
  of the column design; the loss and every gradient of the traced
  ``value_and_grad`` equal to the reference's ``value_and_grad`` at
  ``test_torch_port_regions.py``'s tolerance (the loss 1e-5 relative, each
  gradient 1e-5 of its leaf's largest magnitude).
- The generated sources, keyed by structure; the design and the launch
  plan chosen on the CPU (``row_plan``, ``column_launch``); the new orders'
  depths (``column_depth``, ``partials_depth``, ``tree_depth``).
- ``hold_region`` fails a norm backward whose column sum drops one row,
  and a product off by a part in a thousand.
"""

import collections

import jax
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu.torch as jtorch
from thunder_tpu.executors.data_dependent_partition import (
    fuse_bound_symbols as jfuse_bound_symbols)
from thunder_tpu.models import llama as jllama
import thunder_tpu_torch as ptt
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.executors import regionex
from thunder_tpu_torch.executors.data_dependent_partition import fuse_bound_symbols
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import AdamW, tree_leaves
from thunder_tpu_torch.testing import (expanded, hold_region, prod_bound, regions_of,
                                       sum_bound)

FOLDS = ("sum", "prod", "amax", "amin", "argmax", "argmin")
SHAPES = {"x": (6, 5, 40), "w": (40,), "v": (4, 7, 3, 16), "u": (12, 9), "q": (3, 4, 5)}


def _prims(bsyms):
    out = []
    for b in bsyms:
        out.extend(_prims(b.subsymbols) if b.subsymbols else [b])
    return out


def _program(x, w, v, u, q):
    h = x * w
    rows = torch.sum(h * h, -1)              # trailing: the row design
    col = torch.sum(h * x, (0, 1))           # the row space's kept dims: its column sum
    y = v * 2.0
    mid_sum, mid_min = torch.sum(y, 2), torch.amin(y, 2)     # a middle dim: the column design
    lead_max = torch.amax(torch.exp(u * 0.5), 0)              # a leading dim
    lead_prod = torch.prod(u * 0.1 + 1.0, 0)
    whole = torch.sum(q * q)                 # every dim
    return rows, col, mid_sum, mid_min, lead_max, lead_prod, whole


def _inputs():
    rng = np.random.RandomState(31)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.fixture(scope="module")
def both():
    """The program through both packages from the same numpy inputs: the
    reference's ``jit`` (its ``xla`` regions) and the port's (regions on
    the CPU run their plain chains)."""
    a = _inputs()
    targs = [torch.from_numpy(a[k]) for k in SHAPES]
    jf = jtorch.jit(_program)
    jout = jf(*targs)
    tf = ptt.jit(_program, device="cpu")
    tout = tf(*targs)
    return dict(a=a, targs=targs, jf=jf, tf=tf, jout=jout, tout=tout)


def test_same_groups_as_the_reference_over_any_dims(both):
    """Both packages trace the program to the same prims; under the region
    executor's predicate every reduction is in, and the two partitioners
    give the same groups."""
    jb = _prims(tt.last_traces(both["jf"]._jfn)[0].bound_symbols)
    tb = _prims(ptt.last_traces(both["tf"])[0].bound_symbols)
    assert [b.sym.name for b in tb] == [b.sym.name for b in jb]
    ok = [regionex.ex.can_fuse(b) for b in tb]
    assert all(f for b, f in zip(tb, ok) if b.sym.name in FOLDS)
    by_id = {id(b): f for b, f in zip(jb, ok)}
    want = [[b.sym.name for b in g] for g in jfuse_bound_symbols(jb, lambda b: by_id[id(b)])]
    got = [[b.sym.name for b in g] for g in fuse_bound_symbols(tb, regionex.ex.can_fuse)]
    assert got == want
    names = collections.Counter(b.sym.name for b in tb if b.sym.name in FOLDS)
    assert names == {"sum": 4, "amin": 1, "amax": 1, "prod": 1}


def test_each_reduction_sits_in_a_region_of_its_space(both):
    """No reduction is left a torch call: the row sums and the column sum
    in one row space, the middle-dim sum and amin in one column region,
    the leading amax and prod in another, the all-dims sum in a row space
    of one row."""
    trc = ptt.last_execution_trace(both["tf"])
    assert not [b for b in trc.bound_symbols if b.sym.name in FOLDS]
    spaces = {}
    for r in regions_of(trc):
        folds = sorted(b.sym.name for b in r.members if b.sym.name in FOLDS)
        if folds:
            spaces[r.spec.rows or r.spec.cols] = (r.spec.design, folds, r)
    assert spaces[((6, 5, 40), 1)][:2] == ("row", ["sum", "sum"])
    assert spaces[((4, 7, 3, 16), (2,))][:2] == ("column", ["amin", "sum"])
    assert spaces[((12, 9), (0,))][:2] == ("column", ["amax", "prod"])
    assert spaces[((3, 4, 5), 3)][:2] == ("row", ["sum"])
    norm = spaces[((6, 5, 40), 1)][2]
    assert len(norm.spec.col_sums) == 1 and all(tuple(o.shape) != (6, 5, 40)
                                                for o in norm.outputs)


def test_regions_equal_the_reference_xla_region(both):
    """Every output (each one a reduction's result that a region computes)
    against the reference's ``xla`` region's: sums within twice their
    bound in any order, the product within twice its relative bound, the
    extremes exactly."""
    a, jout, tout = both["a"], both["jout"], both["tout"]
    jtrc = tt.last_traces(both["jf"]._jfn)[-1]
    assert any(b.sym.executor is not None and b.sym.executor.name == "xla"
               for b in jtrc.bound_symbols)
    x, w, v, u, q = (torch.from_numpy(a[k]) for k in SHAPES)
    h = x * w
    bounds = [2 * sum_bound(h * h, (2,)), 2 * sum_bound(h * x, (0, 1)),
              2 * sum_bound(v * 2.0, (2,)), None, None,
              2 * prod_bound(u * 0.1 + 1.0, (0,)), 2 * sum_bound(q * q, (0, 1, 2))]
    for got, want, bound in zip(tout, jout, bounds):
        want = torch.from_numpy(np.array(want))
        assert got.shape == want.shape and got.dtype == want.dtype
        if bound is None:
            assert torch.equal(got, want)
        else:
            err = (got.double() - want.double()).abs()
            assert bool((err <= bound).all()), float((err - bound).max())


# -- tiny-gqa's train step -------------------------------------------------------

LAYERS, B, T = 2, 2, 16


@pytest.fixture(scope="module")
def gqa():
    """tiny-gqa at 2 layers: the reference's ``value_and_grad`` (Pallas in
    interpret mode), the port's traced one, and the port's compiled train
    step's execution trace, from the same weights and batch."""
    mp = pytest.MonkeyPatch()
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    try:
        jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
        jparams = jllama.init_params(jcfg, seed=0, scale_layers=LAYERS)
        tok, tgt = pretrain.synthetic_batch(jcfg.vocab_size, B, T, seed=0)
        jgrad = tt.jit(tt.value_and_grad(
            lambda p, a, b: jllama.loss_fn(p, a, b, jcfg)), block_fusion=False)
        j0 = jgrad(jparams, tok.astype(np.int32), tgt.astype(np.int32))
        tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        ttok, ttgt = torch.from_numpy(tok), torch.from_numpy(tgt)
        tgrad = ptt.jit(ptt.value_and_grad(lambda p, a, b: tllama.loss_fn(p, a, b, tcfg)),
                        device="cpu")
        t0 = tgrad(tparams, ttok, ttgt)
        opt = AdamW(lr=1e-3)
        step = pretrain.jit_train_step(tcfg, opt, device="cpu")
        step(tparams, opt.init(tparams), ttok, ttgt)
        return dict(j0=j0, t0=t0, grad_trc=ptt.last_execution_trace(tgrad),
                    step_trc=ptt.last_execution_trace(step))
    finally:
        mp.undo()


def _read_only_by_reductions(trc) -> list[str]:
    """The regions' outputs that only reductions read (a product written
    so that a reduction reads it back)."""
    readers: dict[str, list] = {}
    for b in expanded(trc):
        for p in b.flat_proxy_args():
            readers.setdefault(p.name, []).append(b)
    returned = {p.name for p in trc.bound_symbols[-1].flat_proxy_args()}
    return [name for r in regions_of(trc) for name in r.output_names
            if name not in returned and readers.get(name)
            and all(u.sym.name in FOLDS for u in readers[name])]


@pytest.mark.parametrize("which", ["step", "grad"])
def test_train_step_leaves_no_reduction_a_torch_call(gqa, which):
    """The compiled step and the traced gradient: no reduction is a torch
    call; no region writes a value that only a reduction reads; the five
    norms' weight gradients are column sums in their norm backward's row
    space, and dK's and dV's group sums (2 layers) column regions."""
    trc = gqa[f"{which}_trc"]
    assert not [b for b in trc.bound_symbols if b.sym.name in FOLDS]
    assert not _read_only_by_reductions(trc)
    regions = regions_of(trc)
    cols = [b for r in regions if r.spec.rows for b in r.members
            if regionex.is_column_sum(b, *r.spec.rows)]
    assert len(cols) == 1 + 2 * LAYERS
    assert [r.spec.cols[1] for r in regions if r.spec.cols] == [(2,)] * (2 * LAYERS)


def test_train_step_loss_and_grads_match_reference(gqa):
    (jl, jg), (tl, tg) = gqa["j0"], gqa["t0"]
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    jleaves, tleaves = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves) == 3 + 9 * LAYERS
    for a, b in zip(jleaves, tleaves):
        want = np.asarray(a, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(b.numpy(), want, atol=1e-5 * scale, rtol=0)


# -- the generated sources and the launch plans -------------------------------------

def _regions(fn, *args):
    jf = ptt.jit(fn, device="cpu")
    jf(*args)
    return [r for r in regions_of(ptt.last_execution_trace(jf)) if r.spec.design != "elementwise"]


def _norm_backward(x, g, w):
    rstd = torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-5)
    xh = x * rstd
    gx = g * w
    dx = rstd * (gx - xh * torch.mean(gx * xh, -1, keepdim=True))
    return dx, torch.sum(g * xh, (0, 1))


def test_sources_keyed_by_structure():
    """A column region's source is the same at two shapes of the same rank
    and dims, another for another dtype; a norm backward's row space holds
    its column sum (accumulated in shared memory, finished as a tree) and
    stages its inputs of S that two passes read (x, g and the broadcast
    weight); its product is no output."""
    (a,) = _regions(lambda t: torch.sum(t * 2, 1), torch.randn(2, 3, 4))
    (b,) = _regions(lambda t: torch.sum(t * 2, 1), torch.randn(5, 9, 7))
    (c,) = _regions(lambda t: torch.sum(t * 2, 1), torch.randn(2, 3, 4, dtype=torch.float64))
    assert a.spec.design == "column" and a.spec.cols == ((2, 3, 4), (1,))
    assert a.spec.source == b.spec.source and c.spec.source != a.spec.source
    assert "ttr::tile_reduce<float>" in a.spec.source
    assert "ttr::tile_reduce<double>" in c.spec.source
    x, g = torch.randn(4, 8, 64), torch.randn(4, 8, 64)
    (n,) = _regions(_norm_backward, x, g, torch.rand(64))
    (m,) = _regions(_norm_backward, torch.randn(2, 3, 64), torch.randn(2, 3, 64),
                    torch.rand(64))
    assert n.spec.source == m.spec.source and n.spec.design == "row"
    shapes = [tuple(o.shape) for o in n.outputs]
    assert sorted(shapes) == [(4, 8, 64), (64,)]
    assert n.spec.rows == ((4, 8, 64), 1) and n.spec.col_sums == [(shapes.index((64,)), "float")]
    assert "ttr::finish_columns<float, float>" in n.spec.source
    # each staged input: once a CTA where it is the same for every row (the
    # weight), else once a row
    assert [k for k, _ in n.spec.staged] == [0, 1, 2] and n.spec.source.count("stage_row") == 6
    # the two row sums' passes and the last pass for dx
    assert n.spec.source.count("for (I col") == 3


def test_prod_accumulates_as_torch():
    """A product accumulates as torch's: float32 for the 16-bit floats and
    float32 (the result rounded once to its dtype), int64 for integers and
    bools, starting from 1."""
    for x, acc, rnd in ((torch.rand(4, 8, dtype=torch.bfloat16), "float", "ttr::rnd_bf16"),
                        (torch.randint(-3, 3, (4, 8), dtype=torch.int32), "long long", None)):
        (r,) = _regions(lambda t: torch.prod(t * 1, 0), x)
        assert r.spec.design == "column"
        assert f"{acc} acc" in r.spec.source and f"({acc})1" in r.spec.source
        assert "ttr::Prod()" in r.spec.source
        if rnd:
            assert f"= {rnd}(t" in r.spec.source


def test_design_and_launch_plan_on_the_cpu():
    """The launch plans at the main path's shapes on 132 SMs: the GQA group
    sum at llama3-8b-bench (8 x 8 x 4 x 2048 x 128, dim 2) a thread a kept
    element summing its 4 terms alone, 4 elements at a time, 8 CTAs of 256
    an SM; a long leading sum
    over too few tiles split across a cluster of 8; the norm backward's row
    space (16,384 rows of 4096 bf16, two staged inputs and a float column
    sum) 6 CTAs an SM for its 32 KB of shared memory, its rows in 1056
    groups (one partial each) whatever it stages; the
    sampler's rows staged (64 KB a CTA of a cluster of 8); a norm backward's
    four inputs and column sum (56 KB) 3 CTAs an SM; rows that do not fit
    read again (``reduce``), as do rows launched with ``stage=False``, in
    the staged launch's groups."""
    assert regionex.column_launch(8 * 8 * 2048 * 128, 4, 132) == (1, 256, 1, 1056)
    assert regionex.column_launch(2 * 2 * 16 * 16, 2, 132) == (1, 256, 1, 4)
    assert regionex.column_launch(64, 65536, 132) == (8, 32, 8, 16)

    def spec(staged, col_sums):
        return regionex.RegionSpec([], "", "e", False, rows=((1, 1), 1), staged=staged,
                                   col_sums=col_sums)

    norm = regionex.row_plan(spec([(0, 2), (1, 2)], [(0, "float")]), 16384, 4096, 132)
    assert norm == dict(cluster=1, threads=256, blocks=792, staged=True, smem=32768, parts=1056,
                        design="smem_partials")
    # the partials as without shared memory: the column sum's order does not
    # depend on what else the region stages
    alone = regionex.row_plan(spec([], [(0, "float")]), 16384, 4096, 132)
    assert alone["parts"] == alone["blocks"] == 1056 and alone["design"] == "reduce_partials"
    sampler = regionex.row_plan(spec([(0, 4)], []), 8, 128256, 132)
    assert sampler == dict(cluster=8, threads=1024, blocks=64, staged=True, smem=64128,
                           parts=8, design="smem")
    wide = regionex.row_plan(spec([(0, 4), (1, 4)], []), 8, 1 << 20, 132)
    assert wide["design"] == "reduce" and wide["smem"] == 0 and not wide["staged"]
    crowded = regionex.row_plan(spec([(0, 2), (1, 2), (2, 2), (3, 4)], [(0, "float")]),
                                16384, 4096, 132)
    assert crowded["design"] == "smem_partials" and crowded["blocks"] == 3 * 132
    single = regionex.row_plan(spec([], []), 512, 4096, 132)
    assert single["design"] == "reduce" and single["blocks"] == 512
    # launched not to stage (the reread measured against the staged row):
    # the same rows in the same groups, so the same bits
    for sp, size, plan in ((spec([(0, 2), (1, 2)], [(0, "float")]), (16384, 4096), norm),
                           (spec([(0, 4)], []), (8, 128256), sampler)):
        reread = regionex.row_plan(sp, *size, 132, stage=False)
        assert not reread["staged"] and reread["design"] == plan["design"].replace("smem",
                                                                                   "reduce")
        assert [reread[k] for k in ("cluster", "threads", "parts")] == [
            plan[k] for k in ("cluster", "threads", "parts")]


def test_depths_of_the_new_orders():
    """The roundings a summand goes through: a column-design sum its
    thread's share (all its terms, where it sums them alone), the tree
    down the thread rows, the cluster's partials;
    a column sum its CTA's rows, a lane's tree over its partials, the tree
    over 32 lanes; ``tree_depth`` the binary counter's deepest term."""
    assert [regionex.tree_depth(n) for n in (0, 1, 2, 3, 4, 5, 25, 32)] == [0, 0, 1, 2, 2, 3, 5,
                                                                             5]
    assert regionex.column_depth(8 * 8 * 2048 * 128, 4, 132) == 3
    assert regionex.column_depth(1024, 64, 132) == 7 + 3
    assert regionex.column_depth(64, 65536, 132) == 1023 + 3 + 7
    assert regionex.partials_depth(16384, dict(parts=1056)) == 15 + 6 + 5
    assert regionex.partials_depth(16384, dict(parts=792)) == 20 + 5 + 5
    assert regionex.partials_depth(8, dict(parts=8)) == 0 + 0 + 5


def test_hold_region_fails_a_column_sum_that_drops_one_row():
    """The norm backward's region held to its bounds (the column sum at
    ``partials_depth``): its chain passes; a column sum short of one row's
    terms fails, by far more than the bound allows."""
    import copy

    rng = np.random.RandomState(37)
    x, g = (torch.from_numpy(rng.randn(4, 256, 64).astype(np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.rand(64).astype(np.float32) + 0.5)
    jf = ptt.jit(_norm_backward, device="cpu")
    jf(x, g, w)
    trc = ptt.last_execution_trace(jf)
    (region,) = regions_of(trc)
    arg = {p.name: t for p, t in zip(trc.args, (x, g, w))}
    vals = [arg[p.name] for p in region.inputs]
    held = hold_region(region, vals, sms=132)
    assert held["ok"] and held["sums"] == 3, held
    k = [tuple(o.shape) for o in region.outputs].index((64,))
    xh = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-5)
    drop = (g * xh)[0, 0]

    class Faulty(type(region)):
        def __call__(self, *vals):
            out = [t.clone() for t in self.plain(*vals)]
            out[k] = out[k] - drop
            return tuple(out)

    faulty = copy.copy(region)
    faulty.__class__ = Faulty
    held = hold_region(faulty, vals, sms=132)
    assert not held["ok"] and held["sum_slack"] > 1, held


@pytest.mark.parametrize("dims", [(-1,), (0,)], ids=["row", "column"])
def test_hold_region_holds_a_prod_to_its_relative_bound(dims):
    """A float product held within (n - 1) u of the exact product's
    magnitude (any order): its chain passes; a product off by a part in a
    thousand fails."""
    import copy

    x = torch.from_numpy((1 + 0.25 * np.random.RandomState(41).randn(6, 5, 7)).astype(np.float32))
    (region,) = _regions(lambda t: torch.prod(t * 1, dims[0]), x)
    held = hold_region(region, [x], sms=132)
    assert held["ok"] and held["sums"] == 1, held

    class Faulty(type(region)):
        def __call__(self, *vals):
            return tuple(t * (1 + 1e-3) for t in self.plain(*vals))

    faulty = copy.copy(region)
    faulty.__class__ = Faulty
    held = hold_region(faulty, [x], sms=132)
    assert not held["ok"] and held["sum_slack"] > 1, held
