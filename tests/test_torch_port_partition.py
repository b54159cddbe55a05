"""The port's data-dependent partitioner
(``thunder_tpu_torch/executors/data_dependent_partition.py``) against the
reference's (``thunder_tpu/executors/data_dependent_partition.py``), on the
CPU.

- The reference's ``tests/test_partition.py`` cases, each through both
  packages' ``jit``: two independent chains on either side of an
  unfusible sync op (``item``) form one region; a chain that feeds ``item``
  and one that reads it form no cycle and compute the reference's value;
  the groups come out in a topological order.
- ``fuse_bound_symbols`` of the two packages over the same small program,
  with the same fusible set, gives the same groups (by member prim names).
- Fuzzed DAGs of elementwise prims and reductions (a random subset marked
  fusible): the port's partitioner forms no cycle, keeps every group's
  inputs produced before it, and loses no bound symbol.

The reference fuses a reduction into an XLA region; the port's region
executor takes no reduction, so where a reduction sits in a chain the two
count regions differently, and the cases say which.
"""

import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu.torch as jtorch
from thunder_tpu.executors.data_dependent_partition import (
    fuse_bound_symbols as jfuse_bound_symbols)
import thunder_tpu_torch as ptt
from thunder_tpu_torch.core import dtypes as tdtypes
from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.trace import TraceCtx, tracectx
from thunder_tpu_torch.executors.data_dependent_partition import fuse_bound_symbols

ELEMENTWISE = {"add", "mul", "sub", "exp", "neg", "tanh", "convert_element_type",
               "broadcast_in_dim"}


def _chains(a, b):
    x = (a + 1.0) * 2.0            # chain 1 (fusible)
    s = b.sum().item()             # unfusible sync op
    y = (a + 3.0) * 4.0            # chain 2, independent of s
    return x + y, s


def _cycle(a):
    b = a + 1.0
    c = b.sum().item()             # unfusible, depends on b
    d = b * 2.0                    # fusible, depends on b only
    return d + c


def _both(fn, *args):
    """``fn`` through the reference's torch front end and the port's jit:
    (the reference's output and traces, the port's output and traces)."""
    jf = jtorch.jit(fn)
    jout = jf(*args)
    tf = ptt.jit(fn, device="cpu")
    tout = tf(*args)
    return jout, tt.last_traces(jf._jfn), tout, ptt.last_traces(tf)


def _regions(src: str, name: str) -> int:
    return src.count(f"= {name}_fusion")


def test_one_region_across_an_unfusible_sync_op():
    """Both chains (and, in the reference, the sum feeding ``item``) join
    one region in both packages; ``item`` stays out (the port's region
    takes no reduction: its ``sum`` stays out too)."""
    jout, jtr, tout, ttr = _both(_chains, torch.ones(4, 4), torch.ones(2))
    assert _regions(jtr[-1].python(), "xla") == 1
    src = ttr[-1].python()
    assert _regions(src, "region") == 1, src
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    assert float(tout[1]) == float(jout[1])


def test_no_cycle_through_item():
    """The chain that feeds ``item`` and the add after it that reads it stay
    apart in both packages (one region holding both would read its own
    output), and the value is the reference's."""
    jout, jtr, tout, ttr = _both(_cycle, torch.ones(3))
    assert np.allclose(np.asarray(jout), (1.0 + 1.0) * 2.0 + 6.0)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert _regions(jtr[-1].python(), "xla") >= 1
    assert _regions(ttr[-1].python(), "region") >= 1
    for b in ttr[-1].bound_symbols:
        if b.sym.name.startswith("fusion"):
            assert "item" not in {s.sym.name for s in b.subsymbols}


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_groups_are_topological(pkg):
    """Every group's inputs are produced by an earlier group or are trace
    inputs, and no bound symbol is lost."""
    def fn(a):
        return (a + 1.0) * 2.0

    _, jtr, _, ttr = _both(fn, torch.ones(2))
    trc, fuse = (jtr[0], jfuse_bound_symbols) if pkg == "reference" else (ttr[0],
                                                                          fuse_bound_symbols)
    groups = fuse(trc.bound_symbols, lambda b: b.sym.name != "python_return")
    flat = [b for g in groups for b in g]
    assert len(flat) == len(trc.bound_symbols)
    produced = {a.name for a in trc.args}
    for b in flat:
        for a in b.flat_proxy_args():
            assert a.name in produced, a.name
        produced.update(o.name for o in b.flat_proxy_outs())


def _program(a, b):
    x = a + b
    y = torch.exp(x * 0.5)
    s = y.sum(1)                   # a reduction: unfusible here
    z = y - torch.tanh(x)
    w = z.to(torch.float32) * -b
    return w + 1.0, s * 2.0


def test_same_groups_as_the_reference():
    """The two partitioners over the same program (traced by each package;
    the traces hold the same prims in the same order) with the same
    fusible set give the same groups."""
    a = torch.linspace(-1, 1, 12).reshape(3, 4)
    _, jtr, _, ttr = _both(_program, a, a)
    jtrc, ttrc = jtr[0], ttr[0]

    def prims_of(bsyms):
        # the composites' decompositions, flattened to prims
        out = []
        for b in bsyms:
            out.extend(prims_of(b.subsymbols) if b.subsymbols else [b])
        return out

    jb, tb = prims_of(jtrc.bound_symbols), prims_of(ttrc.bound_symbols)
    assert [b.sym.name for b in tb] == [b.sym.name for b in jb]

    def fusible(b):
        return b.sym.name in ELEMENTWISE

    want = [[b.sym.name for b in g] for g in jfuse_bound_symbols(jb, fusible)]
    got = [[b.sym.name for b in g] for g in fuse_bound_symbols(tb, fusible)]
    assert got == want
    assert max(len(g) for g in got) > 2


def _random_trace(seed: int):
    """A random program of ``n`` ops over (4, 3) float32 tensors: binary and
    unary elementwise prims, and reductions broadcast back (a sum over the
    last dim, then ``broadcast_in_dim``), reading random earlier values.
    Returns the trace and a random fusible mask over its bound symbols."""
    rng = np.random.RandomState(seed)
    trc = TraceCtx()
    shape = (4, 3)
    with tracectx(trc):
        args = [TensorProxy(shape=shape, dtype=tdtypes.float32, device="cpu") for _ in range(3)]
        trc.args = args
        vals = list(args)
        for _ in range(int(rng.randint(8, 30))):
            kind = rng.randint(0, 5)
            x = vals[rng.randint(len(vals))]
            if kind == 0:
                vals.append(prims.add(x, vals[rng.randint(len(vals))]))
            elif kind == 1:
                vals.append(prims.mul(x, vals[rng.randint(len(vals))]))
            elif kind == 2:
                vals.append(prims.exp(x))
            elif kind == 3:
                vals.append(prims.neg(x))
            else:
                vals.append(prims.broadcast_in_dim(prims.sum(x, (1,)), shape, (0,)))
        prims.python_return(tuple(vals[-3:]))
        trc.output = tuple(vals[-3:])
    mask = {id(b): bool(rng.rand() < 0.7) for b in trc.bound_symbols}
    return trc, mask


@pytest.mark.parametrize("seed", range(12))
def test_fuzzed_dag_no_cycle_no_loss(seed):
    trc, mask = _random_trace(seed)
    bsyms = trc.bound_symbols
    groups = fuse_bound_symbols(bsyms, lambda b: mask[id(b)] and b.sym.name != "python_return")
    flat = [b for g in groups for b in g]
    assert sorted(map(id, flat)) == sorted(map(id, bsyms))
    produced = {a.name for a in trc.args}
    for g in groups:
        if len(g) > 1:
            assert all(mask[id(b)] for b in g)
        for b in g:   # members in program order: each reads what came before it
            for a in b.flat_proxy_args():
                assert a.name in produced, (seed, a.name)
            produced.update(o.name for o in b.flat_proxy_outs())
    assert groups[-1][-1].sym.name == "python_return"
