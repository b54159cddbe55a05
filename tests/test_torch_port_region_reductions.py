"""Regions with row reductions (``thunder_tpu_torch/executors/regionex.py``)
on the CPU, where a region runs its plain chain (its members' torch calls).

- The port's partitioner under the region executor's predicate, which now
  takes ``sum``/``amax``/``amin``/``argmax``/``argmin`` over trailing dims
  and the unit views of ``keepdim``, gives the reference partitioner's
  groups over the same program (``fuse_bound_symbols`` of both packages).
- The row-space rule on tiny-gqa's compiled train step (2 layers) and on
  the traced engine's decode step with top-k/top-p sampling: each region
  is one row space ``(S, r)``; no reduction over a leading or middle dim
  sits in a region; the norms' row sums (forward and backward), the loss's
  mean and the sampler's ``sum``/``amax``/``amin``/``argmax`` do.
- The engine's sampled tokens with regions equal the engine's with the
  region executor's fuel at 0 (no region), and the reference engine's
  (``test_torch_port_serving_jit.py`` holds every rung against it with
  top-k/top-p requests); the train step against the reference is
  ``test_torch_port_regions.py``'s (its regions now hold reductions).
- The generated source: keyed by structure, one pass a reduction level,
  torch's accumulators (float32 for the 16-bit floats and float32, float64,
  int64 for bools and integers), nothing of the row space written but the
  region's outputs, the passes reading only what they need.
- The regions' nvcc: one ``nvcc`` a program; where it fails, each region
  is built alone, so only the bad region fails.
- The check a reduce region is held to on the card (``testing.hold_region``)
  fails a kernel that drops one typical summand, or one 1024-wide stride,
  of the sampler's (8, 128256) row, and a sum of integer values one ulp
  off; it holds the sum to the kernel's own order
  (``regionex.sum_depth``), not to any order of the row.
"""

import collections

import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu.torch as jtorch
from thunder_tpu.executors.data_dependent_partition import (
    fuse_bound_symbols as jfuse_bound_symbols)
import thunder_tpu_torch as ptt
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.executors import cudaex, regionex
from thunder_tpu_torch.executors.data_dependent_partition import fuse_bound_symbols
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import AdamW
from thunder_tpu_torch.serving import SamplingParams, ServingEngine
from thunder_tpu_torch.testing import regions_of

REDUCTIONS = ("sum", "amax", "amin", "argmax", "argmin")


def _prims(bsyms):
    out = []
    for b in bsyms:
        out.extend(_prims(b.subsymbols) if b.subsymbols else [b])
    return out


def _program(a, b):
    x = torch.exp(a * b)
    m = x.amax(-1, keepdim=True)
    s = torch.sum(x - m, -1, keepdim=True)
    c = x.sum(0)                     # a leading dim: the column design
    y = (x - m) / s
    return y * 2.0, c + 1.0, torch.argmax(y, -1)


def test_same_groups_as_the_reference_with_trailing_reductions():
    """Both packages trace the program to the same prims; under the region
    executor's predicate (reductions over any dims and unit views in, the
    leading ``sum`` too) the two partitioners give the same groups, and one
    group holds the row reductions."""
    a = torch.linspace(-1, 1, 12).reshape(3, 4)
    jf = jtorch.jit(_program)
    jf(a, a)
    tf = ptt.jit(_program, device="cpu")
    tf(a, a)
    jb = _prims(tt.last_traces(jf._jfn)[0].bound_symbols)
    tb = _prims(ptt.last_traces(tf)[0].bound_symbols)
    assert [b.sym.name for b in tb] == [b.sym.name for b in jb]
    ok = [regionex.ex.can_fuse(b) for b in tb]
    by_id = {id(b): f for b, f in zip(jb, ok)}
    want = [[b.sym.name for b in g] for g in jfuse_bound_symbols(jb, lambda b: by_id[id(b)])]
    got = [[b.sym.name for b in g] for g in fuse_bound_symbols(tb, regionex.ex.can_fuse)]
    assert got == want
    fused = {b.sym.name for b, f in zip(tb, ok) if f}
    assert {"amax", "sum", "argmax", "reshape"} <= fused
    sums = [b for b in tb if b.sym.name == "sum"]
    assert [regionex.ex.can_fuse(b) for b in sums] == [True, True]    # (-1,) and (0,) in
    assert any({"amax", "sum", "argmax"} <= set(g) for g in got)


def _check_row_space(r):
    """Every member of a region plays its part of one space: a row space
    ``(S, r)`` (its reductions of S's last r dims, and the column sums over
    its kept dims) or a column space ``(S, D)``."""
    if r.spec.design == "elementwise":
        assert len({tuple(b.flat_proxy_outs()[0].shape) for b in r.members}) == 1
        assert not any(b.sym.name in REDUCTIONS + ("prod",) for b in r.members)
        return
    if r.spec.design == "column":
        S, D = r.spec.cols
        assert D != tuple(range(len(S) - len(D), len(S))), D     # not trailing dims
        kept = [n for d, n in enumerate(S) if d not in D and n != 1]
        for b in r.members:
            out = tuple(b.flat_proxy_outs()[0].shape)
            if b.sym.name in REDUCTIONS + ("prod",):
                assert tuple(b.args[0].shape) == S and regionex._reduced_dims(b) == D, b
            else:
                assert out == S or [n for n in out if n != 1] == kept, (b, S, D)
        return
    S, rd = r.spec.rows
    kept = [n for n in S[:len(S) - rd] if n != 1]
    for b in r.members:
        out = tuple(b.flat_proxy_outs()[0].shape)
        if b.sym.name in REDUCTIONS + ("prod",):
            a = b.args[0]
            assert tuple(a.shape) == S and (regionex.trailing_r(b) == rd
                                            or regionex.is_column_sum(b, S, rd)), b
        else:
            assert out == S or [n for n in out if n != 1] == kept, (b, S, rd)


@pytest.fixture(scope="module")
def train_trace():
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    opt = AdamW(lr=1e-3)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 16, 0))
    step = pretrain.jit_train_step(cfg, opt, device="cpu")
    step(params, opt.init(params), tok, tgt)
    return ptt.last_execution_trace(step)


def test_train_step_regions_follow_the_row_space_rule(train_trace):
    """Every region of the step is one space; no reduction is left a torch
    call: the norms' row sums, forward and backward (5 norms: 10), and the
    loss's reductions (its row max and sum, the mean over the rows) sit in
    row spaces, the norm weights' column sums over (0, 1) (5) in their
    norm backward's row space, the GQA group sums over dim 2 (2 layers, dK
    and dV: 4) in column regions."""
    regions = regions_of(train_trace)
    for r in regions:
        _check_row_space(r)
    left = [b for b in train_trace.bound_symbols if b.sym.name in REDUCTIONS + ("prod",)]
    assert not left, left
    cols = [b for r in regions if r.spec.rows for b in r.members
            if regionex.is_column_sum(b, *r.spec.rows)]
    assert len(cols) == 5 and {tuple(b.args[1]) for b in cols} == {(0, 1)}
    groups = [r for r in regions if r.spec.cols]
    assert len(groups) == 4 and {r.spec.cols[1] for r in groups} == {(2,)}
    inside = collections.Counter(b.sym.name for r in regions for b in r.members
                                 if b.sym.name in REDUCTIONS)
    norm_rows = sum(1 for r in regions if r.spec.rows for b in r.members
                    if b.sym.name == "sum" and r.spec.rows[0][-1] == 64
                    and regionex.trailing_r(b))
    assert norm_rows >= 10 and inside["amax"] >= 1, inside
    full = [r for r in regions if r.spec.rows and len(r.spec.rows[0]) == r.spec.rows[1]]
    assert full, "the loss's mean over the rows is in no region"


@pytest.fixture(scope="module")
def sampled_runs():
    """The traced engine (tiny-gqa float32, 2 layers) with top-k/top-p
    requests, with regions and with the region executor's fuel at 0."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32) for n in (1, 9, 20)]
    sps = [SamplingParams(temperature=0.8, top_k=5, top_p=0.9, seed=1),
           SamplingParams(temperature=1.0, top_p=0.5, seed=2), None]
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, fuel in (("on", None), ("off", 0)):
            mp.setattr(regionex.ex, "_fuel", fuel)
            eng = ServingEngine(params, cfg, device="cpu", max_slots=2, page_size=8,
                                max_context=64, prefill_chunk=16)
            reqs = [eng.submit(p, 5, sampling=s) for p, s in zip(prompts, sps)]
            eng.drain()
            out[name] = ([r.output().tolist() for r in reqs],
                         eng.runner._decode_bound.entry.traces[-1])
    finally:
        mp.undo()
    return out


def test_sampled_tokens_equal_with_regions_on_and_off(sampled_runs):
    assert sampled_runs["on"][0] == sampled_runs["off"][0]


def test_sampler_reductions_sit_in_regions(sampled_runs):
    """The decode step's sampler (its top-k and top-p bisections, the
    softmax and both argmaxes) runs in regions: no reduction is left a
    torch call, and the regions hold the 37 sums, 2 amax, 1 amin and 2
    argmax that ran as torch calls without them."""
    on, off = sampled_runs["on"][1], sampled_runs["off"][1]
    assert not [b for b in on.bound_symbols if b.sym.name in REDUCTIONS]
    before = collections.Counter(b.sym.name for b in off.bound_symbols
                                 if b.sym.name in REDUCTIONS)
    regions = regions_of(on)
    inside = collections.Counter(b.sym.name for r in regions for b in r.members
                                 if b.sym.name in REDUCTIONS)
    assert before == {"sum": 37, "amax": 2, "amin": 1, "argmax": 2} == inside
    for r in regions:
        _check_row_space(r)
    assert len(regions) < 10


# -- the generated source ------------------------------------------------------

def _spec(fn, *args):
    jf = ptt.jit(fn, device="cpu")
    jf(*args)
    (r,) = regions_of(ptt.last_execution_trace(jf))
    return r.spec


def _softmax(x):
    return torch.softmax(x, -1)


def test_reduce_source_keyed_by_structure():
    a = _spec(_softmax, torch.randn(4, 8))
    b = _spec(_softmax, torch.randn(16, 300))
    c = _spec(_softmax, torch.randn(4, 8, dtype=torch.float64))
    assert a.rows == ((4, 8), 1) and b.rows == ((16, 300), 1)
    assert a.source == b.source and a.entry == b.entry and c.source != a.source
    # amax, then exp and sum, then the division: three passes over the row
    assert a.source.count("for (I col") == 3
    assert "ttr::block_reduce<float>" in a.source and "ttr::block_reduce<double>" in c.source


@pytest.mark.parametrize("case", ["bf16", "f16", "f64", "bool", "int8"])
def test_sums_accumulate_as_torch(case):
    """torch's accumulators: float32 for 16-bit floats (the result rounded
    once to the dtype), float64 for float64, int64 for bools and integers."""
    x, acc, rnd = {
        "bf16": (torch.randn(4, 8, dtype=torch.bfloat16), "float", "ttr::rnd_bf16"),
        "f16": (torch.randn(4, 8, dtype=torch.float16), "float", "ttr::rnd_f16"),
        "f64": (torch.randn(4, 8, dtype=torch.float64), "double", None),
        "bool": (torch.rand(4, 8) > 0.5, "long long", None),
        "int8": (torch.randint(-9, 9, (4, 8), dtype=torch.int8), "long long", None),
    }[case]
    fn = (lambda t: (t & t).sum(-1)) if case == "bool" else (lambda t: (t * 1).sum(-1))
    spec = _spec(fn, x)
    assert f"{acc} acc" in spec.source
    assert f"ttr::block_reduce<{acc}>" in spec.source
    if rnd:   # the sum rounded once to its dtype
        assert f"= {rnd}(t" in spec.source


def test_only_outputs_of_the_row_space_are_written():
    """A norm's region writes its output and nothing else of S; the passes
    read x again instead of a stored square."""
    spec = _spec(lambda x, w: x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-5) * w,
                 torch.randn(4, 16), torch.rand(16))
    stores = [line for line in spec.source.splitlines() if "[i] =" in line or "[row] =" in line]
    assert len(stores) == 1 and "[i] =" in stores[0]
    assert spec.source.count("for (I col") == 2


def test_extremes_and_indices_in_one_pass():
    spec = _spec(lambda x: (torch.amax(x * 2, -1), torch.argmin(x * 2, -1)), torch.randn(3, 5))
    assert spec.source.count("for (I col") == 1
    assert "ttr::arg_step<false>" in spec.source and "ttr::MaxNan" in spec.source


def test_long_rows_and_leading_reductions_stay_out():
    """A row past ``MAX_ROW`` elements (trailing or leading) and a
    reduction over a dim of one element run as torch calls; a reduction
    over a leading or a middle dim now joins a region of the column
    design."""
    for fn, shape in ((lambda x: (x * 2).sum(0), (4, 8)), (lambda x: (x * 2).sum(1), (2, 3, 4))):
        jf = ptt.jit(fn, device="cpu")
        jf(torch.randn(shape))
        names = [b.sym.name for b in ptt.last_execution_trace(jf).bound_symbols]
        assert "sum" not in names, names
        (r,) = regions_of(ptt.last_execution_trace(jf))
        assert r.spec.design == "column" and r.spec.cols[1] == ((0,) if len(shape) == 2 else (1,))
    jf = ptt.jit(lambda x: (x * 2).sum(-1), device="cpu")
    jf(torch.randn(4, 1))
    assert "sum" in [b.sym.name for b in ptt.last_execution_trace(jf).bound_symbols]
    for shape, dim in (((2, regionex.MAX_ROW + 1), -1), ((regionex.MAX_ROW + 1, 2), 0)):
        jf = ptt.jit(lambda x: (x * 2).sum(dim), device="cpu")
        jf.compile(torch.empty(shape))
        assert "sum" in [b.sym.name for b in ptt.last_execution_trace(jf).bound_symbols]


# -- the regions' nvcc ----------------------------------------------------------

NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
src = open(sys.argv[-1]).read()
with open({log!r}, "a") as f:
    f.write(f"start {{time.time()}}\\n")
time.sleep(0.3)
if "planted region failure" in src:
    print("error: planted region failure")
    sys.exit(2)
open(out, "w").write(src)
with open({log!r}, "a") as f:
    f.write(f"end {{time.time()}}\\n")
"""


def test_one_nvcc_a_program_and_a_bad_region_fails_alone(monkeypatch, tmp_path):
    """Four regions of one program: one nvcc over all of them; where it
    fails, each region is built alone, so the three good regions bind and
    the bad one's log is kept."""
    import sys

    log = tmp_path / "log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cudaex, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cudaex, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(regionex, "_bound", {})
    monkeypatch.setattr(regionex, "_failures", {})
    bound = []
    monkeypatch.setattr(regionex, "_bind", lambda lib, specs: bound.extend(s.entry
                                                                           for s in specs))
    specs = [regionex.RegionSpec([], f"// {name}\n" + "x" * n, name, False)
             for name, n in (("a", 40), ("b", 30), ("c", 20), ("d", 10))]
    specs[2] = regionex.RegionSpec([], "// planted region failure\n" + "x" * 20, "c", False)
    runs = regionex.nvcc_runs()
    regionex.build_regions(specs)
    assert regionex.nvcc_runs() == runs + 5       # the program, then its four regions
    events = log.read_text().split()
    starts = [float(t) for k, t in zip(events[::2], events[1::2]) if k == "start"]
    ends = [float(t) for k, t in zip(events[::2], events[1::2]) if k == "end"]
    assert len(starts) == 5 and len(ends) == 3    # the program's run and c's failed
    assert max(starts[1:]) < min(ends)            # the regions' runs at once
    assert sorted(bound) == ["a", "b", "d"]
    assert list(regionex.build_failures()) == ["c"]
    assert "planted region failure" in regionex.build_failures()["c"]


def test_row_launch_splits_few_long_rows_across_clusters():
    """Rows that fill the card: one CTA a row (at most 256 threads), 8 an SM;
    few long rows (the sampler's 8 of 128,256) split across clusters of 8
    CTAs of 1024 threads; a row never split below 2048 elements a CTA."""
    assert regionex.row_launch(16384, 4096, 132) == (1, 256, 1056)
    assert regionex.row_launch(16384, 16, 132) == (1, 32, 1056)
    assert regionex.row_launch(8, 128256, 132) == (8, 1024, 64)
    assert regionex.row_launch(8, 4096, 132) == (2, 1024, 16)
    assert regionex.row_launch(1, 16384, 132) == (8, 1024, 8)
    assert regionex.row_launch(100, 1000, 132) == (1, 1000 // 32 * 32 + 32, 100)


def test_hold_region_fails_a_planted_fault():
    """The bound ``hold_region`` holds a region with a sum to: a norm's
    output with one row's sum short of its last summand's share by a part
    in a thousand fails it; the chain itself passes."""
    import copy

    from thunder_tpu_torch.testing import hold_region

    jf = ptt.jit(lambda x, w: x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-5) * w,
                 device="cpu")
    x, w = torch.randn(64, 512), torch.rand(512) + 0.5
    jf(x, w)
    (region,) = regions_of(ptt.last_execution_trace(jf))
    assert hold_region(region, [x, w])["ok"]

    class Faulty(type(region)):
        def __call__(self, *vals):
            out = [t.clone() for t in self.plain(*vals)]
            out[0][-1] *= 1 + 1e-3
            return tuple(out)

    faulty = copy.copy(region)
    faulty.__class__ = Faulty
    held = hold_region(faulty, [x, w])
    assert not held["ok"] and held["sum_slack"] > 1


def test_sum_depth_follows_the_launch():
    """The roundings a summand goes through in the kernel's order: its
    thread's columns, two shuffle trees, the cluster's partials."""
    # 8 rows of 128,256: clusters of 8 CTAs of 1024 threads, 16 columns a thread
    assert regionex.sum_depth(8, 128256, 132) == 15 + 10 + 7
    # rows that fill the card: one CTA of 256 threads a row, 16 columns a thread
    assert regionex.sum_depth(16384, 4096, 132) == 15 + 10
    assert regionex.sum_depth(4, 231, 132) == 10


def _sampler_sum_region():
    """A softmax's row sum over the sampler's (8, 128256) row, one region
    with ``amax`` and ``sum`` on the CPU, and its input."""
    jf = ptt.jit(lambda x: torch.sum(torch.exp(x - torch.amax(x, -1, keepdim=True)), -1),
                 device="cpu")
    x = torch.from_numpy(np.random.RandomState(5).randn(8, 128256).astype(np.float32))
    jf(x)
    (region,) = regions_of(ptt.last_execution_trace(jf))
    assert region.spec.rows == ((8, 128256), 1)
    return region, x


def _faulty(region, change):
    """``region`` with its first output changed by ``change(out, vals)``."""
    import copy

    class Faulty(type(region)):
        def __call__(self, *vals):
            out = [t.clone() for t in self.plain(*vals)]
            out[0] = change(out[0], vals)
            return tuple(out)

    faulty = copy.copy(region)
    faulty.__class__ = Faulty
    return faulty


@pytest.mark.parametrize("fault", ["one-summand", "one-stride"])
def test_hold_region_fails_a_dropped_part_of_the_sampler_row(fault):
    """The chain passes at the card's depth (32); a sum short of one summand
    no smaller than the row's mean, or of its last 1024 columns (0.8% of
    the row), fails, where the bound of any order (2 (n - 1) u, 1.5% of
    the sum) would pass both."""
    from thunder_tpu_torch.testing import hold_region

    region, x = _sampler_sum_region()
    held = hold_region(region, [x], sms=132)
    assert held["ok"] and held["depth"] == 32 and held["unstable"] == 0, held
    p = torch.exp(x - x.amax(-1, keepdim=True))
    if fault == "one-summand":
        # each row's first summand at or above its mean
        col = (p >= p.mean(-1, keepdim=True)).float().argmax(-1, keepdim=True)
        drop = torch.gather(p, 1, col).squeeze(1)
    else:
        drop = p[:, -1024:].sum(-1)
    assert bool((drop <= 2 * 128255 * 2.0 ** -24 * p.sum(-1)).all())   # inside the old bound
    held = hold_region(_faulty(region, lambda s, vals: s - drop), [x], sms=132)
    assert not held["ok"] and held["sum_slack"] > 1, held


def test_hold_region_holds_integer_sums_exactly():
    """On integer values every partial sum is exact: the bound is 0, and a
    sum one ulp off fails."""
    from thunder_tpu_torch.testing import hold_region, region_inputs

    region, _ = _sampler_sum_region()
    jf = ptt.jit(lambda x: torch.sum(x * x, -1), device="cpu")
    x = region_inputs(region, torch.Generator().manual_seed(2), "cpu", integer=True)[0]
    assert bool((x == x.round()).all()) and float(x.abs().max()) <= 4
    jf(x)
    (sq,) = regions_of(ptt.last_execution_trace(jf))
    held = hold_region(sq, [x], sms=132)
    assert held["ok"] and held["exact_sums"] == held["sums"] == 1, held
    off = _faulty(sq, lambda s, vals: torch.nextafter(s, s + 1))
    held = hold_region(off, [x], sms=132)
    assert not held["ok"], held
