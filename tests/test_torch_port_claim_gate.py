"""The claims' cost-model gate (``core/cost_model.py``'s gate half,
``ImplInfo.profitable``, ``executors/passes.claim_bsym``,
``executors/cudaex_claims._cuda_claim_profitable``, the epilogue pass's
probe) against the reference's, on the CPU.

- The gated claims are the reference's five (``nn.ce_fwd``, ``nn.rms_norm``,
  ``nn.rms_norm_residual``, ``nn.linear_act``, ``nn.paged_decode_attention``).
- ``bsym_cost`` of each gated composite, bound by each
  package over the same proxies at several shapes, give the reference's
  flops and bytes exactly (``nn.ce_fwd``'s flops one a row fewer: the
  reference's decomposition converts the int64 target to int32 first, the
  port's reads it as it is), and ``region_cost`` of the norms' and
  ``linear_act``'s decompositions (the others decompose differently: the
  port's paged attention gathers its pages in other ops); with the port's
  ridge and ``MIN_CLAIM_BYTES``
  set to the reference's, ``claim_worthwhile`` gives the reference's
  answers, on both sides of its 1 MiB.
- On ``FakeTensor`` stand-ins on ``cuda:0`` (no card), the gate's decisions
  at the serving decode shape and the train shape (D = 4096, bf16) follow
  the fitted constant; a claim it turns down is logged with its flops,
  bytes and ``min_claim_bytes``, and its decomposition forms one region
  with row reductions; ``fusion_cost_model=False`` and ``interpret`` take
  every legal claim.
- A ``profitable`` that raises turns the claim down (fails closed).
- The epilogue pass builds no ``nn.rms_norm_residual`` composite that the
  gate would turn down.
- Every claim turned down is counted (``passes.gate_rejections``), a
  decision log or not; at the fitted constant the per-op decode step is
  one program with the gate on and off.
"""

import collections

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import thunder_tpu.ops as jops
import thunder_tpu.ops.nn  # noqa: F401  (registers the reference's nn composites)
from thunder_tpu.core import cost_model as jcm
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core.proxies import TensorProxy as JProxy
from thunder_tpu.core.trace import TraceCtx as JTrace
from thunder_tpu.core.trace import tracectx as jtracectx
from thunder_tpu.executors import pallasex
import thunder_tpu_torch as ptt
import thunder_tpu_torch.ops as tops
from thunder_tpu_torch.core import cost_model as tcm
from thunder_tpu_torch.core import dtypes as tdtypes
from thunder_tpu_torch.core.proxies import TensorProxy as TProxy
from thunder_tpu_torch.core.trace import TraceCtx as TTrace
from thunder_tpu_torch.core.trace import tracectx as ttracectx
from thunder_tpu_torch.executors import cudaex_claims
from thunder_tpu_torch.testing import claimed_kernels, regions_of

EPS = 1e-5
_FAKE = FakeTensorMode()


def _on_cuda(shape, dtype=torch.bfloat16):
    return FakeTensor(_FAKE, torch.empty(shape, dtype=dtype, device="meta"),
                      torch.device("cuda:0"))


def test_the_gated_claims_are_the_reference_five():
    want = sorted(k for k, v in pallasex.ex.implmap.items() if v.profitable is not None)
    got = sorted(k for k, v in cudaex_claims.ex.implmap.items() if v.profitable is not None)
    assert got == want == sorted(cudaex_claims.GATED)


# op id -> (the argument shapes at ``n`` rows, their dtypes, keyword arguments)
CASES = {
    "nn.rms_norm": (lambda n: [(n, 4096), (4096,)], ["bfloat16"] * 2, {"eps": EPS}),
    "nn.rms_norm_residual": (lambda n: [(n, 4096), (n, 4096), (4096,)], ["bfloat16"] * 3,
                             {"eps": EPS}),
    "nn.linear_act": (lambda n: [(n, 4096), (14336, 4096)], ["bfloat16"] * 2, {"act": "silu"}),
    "nn.ce_fwd": (lambda n: [(n, 32000), (n,)], ["float32", "int64"], {}),
    "nn.paged_decode_attention": (
        lambda n: [(n, 32, 1, 128), (8, 64, 16, 128), (8, 64, 16, 128), (n, 16), (n,)],
        ["bfloat16"] * 3 + ["int32"] * 2, {}),
}


def _bind(op_id, rows, pkg):
    """The composite ``op_id`` bound by one package over fresh proxies of
    the case's shapes at ``rows`` rows: its bound symbol."""
    ops, Trace, ctx, Proxy, dts = {
        "reference": (jops, JTrace, jtracectx, JProxy, jdtypes),
        "port": (tops, TTrace, ttracectx, TProxy, tdtypes)}[pkg]
    shapes, types, kw = CASES[op_id]
    trc = Trace("gate")
    with ctx(trc):
        ops.get_op(op_id)(*[Proxy(shape=sh, dtype=getattr(dts, dt))
                            for sh, dt in zip(shapes(rows), types)], **kw)
    return trc.bound_symbols[-1]


ROWS = (1, 8, 64, 512, 16384)


@pytest.mark.parametrize("op_id", sorted(CASES))
@pytest.mark.parametrize("rows", ROWS)
def test_costs_are_the_reference_counts(op_id, rows):
    jb, tb = _bind(op_id, rows, "reference"), _bind(op_id, rows, "port")
    jf, jbytes = jcm.bsym_cost(jb)
    tf, tbytes = tcm.bsym_cost(tb)
    assert tbytes == jbytes
    # the reference converts ce_fwd's int64 target to int32 first: one op a row
    assert tf == jf - (rows if op_id == "nn.ce_fwd" else 0)
    assert tcm.region_cost([tb])[1] == jcm.region_cost([jb])[1]
    if op_id in ("nn.rms_norm", "nn.rms_norm_residual", "nn.linear_act"):
        # the same decomposition: its region's flops and boundary too
        assert tcm.region_cost(tb.subsymbols) == jcm.region_cost(jb.subsymbols)


@pytest.mark.parametrize("op_id", sorted(CASES))
def test_claim_worthwhile_gives_the_reference_answers(op_id, monkeypatch):
    """With the reference's ridge and 1 MiB in the port's module, the two
    gates agree at every size, and they disagree with each other somewhere
    only where the reference's TPU figures and the port's differ."""
    monkeypatch.setattr(tcm, "RIDGE_FLOPS_PER_BYTE", jcm.TPU_RIDGE_FLOPS_PER_BYTE)
    monkeypatch.setattr(tcm, "MIN_CLAIM_BYTES", jcm.MIN_CLAIM_BYTES)
    answers = []
    for rows in ROWS:
        jb, tb = _bind(op_id, rows, "reference"), _bind(op_id, rows, "port")
        assert tcm.claim_worthwhile(tb) == jcm.claim_worthwhile(jb), rows
        assert tcm.is_memory_bound(*tcm.bsym_cost(tb)) == jcm.is_memory_bound(
            *jcm.bsym_cost(jb))
        answers.append(jcm.claim_worthwhile(jb))
    if op_id in ("nn.rms_norm", "nn.rms_norm_residual", "nn.ce_fwd"):
        assert answers[0] is False and answers[-1] is True    # both sides of 1 MiB


def _norm(x, w):
    return F.rms_norm(x, (x.shape[-1],), w, EPS)


def _residual_norm(r, x, w):
    h = r + x
    return h, F.rms_norm(h, (x.shape[-1],), w, EPS)


def _compile(fn, args, **opts):
    jf = ptt.jit(fn, **opts)
    jf.compile(*args)
    trc = ptt.last_execution_trace(jf)
    return jf, trc, claimed_kernels(trc)


@pytest.mark.parametrize("rows", [8, 16384], ids=["decode", "train"])
def test_decisions_at_decode_and_train_shapes_follow_the_constant(rows):
    """rms_norm and rms_norm_residual at 8 rows (a decode step's 8 slots)
    and 16384 (the train step's B T) of 4096 bf16: claimed where their
    boundary reaches ``MIN_CLAIM_BYTES``, else decomposed into a region."""
    for fn, n_in, kernel in ((_norm, 1, "rms_norm"), (_residual_norm, 2, "rms_norm_residual")):
        args = [_on_cuda((rows, 4096)) for _ in range(n_in)] + [_on_cuda((4096,))]
        # x in and y out; with the residual, r and x in, h and y out
        nbytes = 2 * n_in * rows * 4096 * 2 + 4096 * 2
        _, trc, claims = _compile(fn, args)
        if nbytes >= tcm.MIN_CLAIM_BYTES:
            assert claims == {kernel: 1}, claims
        else:
            assert claims == {"region": 1}, claims


def test_a_turned_down_claim_is_logged_and_forms_a_region(monkeypatch):
    """With the constant raised past the claim, rms_norm at the decode shape
    is turned down: the decision log has its flops, bytes and the constant;
    its decomposition forms one region with the norm's row sum; with
    ``fusion_cost_model=False``, and on the CPU under ``interpret``, the
    claim is taken."""
    monkeypatch.setattr(tcm, "MIN_CLAIM_BYTES", 1 << 40)
    args = [_on_cuda((8, 4096)), _on_cuda((4096,))]
    jf, trc, claims = _compile(_norm, args)
    assert claims == {"region": 1}
    (region,) = regions_of(trc)
    assert region.spec.rows == ((8, 4096), 1)
    assert "sum" in [b.sym.name for b in region.members]
    (d,) = [d for d in ptt.compile_stats(jf).last_decisions
            if d["kind"] == "claim" and d["decision"] == "rejected"]
    assert d["op"] == "rms_norm" and "cost model" in d["reason"]
    assert d["cost"] == {"flops": 229416, "bytes": 139264, "min_claim_bytes": 1 << 40}
    _, _, claims = _compile(_norm, args, fusion_cost_model=False)
    assert claims == {"rms_norm": 1}
    cpu = ptt.jit(_norm, device="cpu", interpret=True)
    cpu(torch.randn(8, 4096), torch.rand(4096))
    assert [b.sym.name for b in ptt.last_execution_trace(cpu).bound_symbols
            if b.sym.executor is cudaex_claims.ex] == ["rms_norm"]


def test_a_gate_that_raises_fails_closed(monkeypatch):
    def broken(bsym):
        raise RuntimeError("cost model broken")

    impl = cudaex_claims.ex.implmap["nn.rms_norm"]
    monkeypatch.setattr(impl, "profitable", broken)
    jf, trc, claims = _compile(_norm, [_on_cuda((16384, 4096)), _on_cuda((4096,))])
    assert claims == {"region": 1}
    rejected = [d for d in ptt.compile_stats(jf).last_decisions
                if d["kind"] == "claim" and d["decision"] == "rejected"]
    assert [d["op"] for d in rejected] == ["rms_norm"]
    assert rejected[0]["cost"]["bytes"] == 2 * 16384 * 4096 * 2 + 4096 * 2


def test_the_epilogue_pass_builds_no_composite_the_gate_turns_down(monkeypatch):
    """The residual add and the norm stay apart (no ``nn.rms_norm_residual``
    in any trace) when the gate would turn the fused claim down, and the
    decision names the gate; the add and the norm's decomposition then form
    one region. At the default constant the train shape fuses and claims."""
    monkeypatch.setattr(tcm, "MIN_CLAIM_BYTES", 1 << 40)
    args = [_on_cuda((8, 4096)), _on_cuda((8, 4096)), _on_cuda((4096,))]
    jf, trc, claims = _compile(_residual_norm, args)
    assert claims == {"region": 1}
    assert not any(b.sym.id == "nn.rms_norm_residual"
                   for t in ptt.last_traces(jf) for b in t.bound_symbols)
    fused = [d for d in ptt.compile_stats(jf).last_decisions
             if d["kind"] == "fusion" and d["op"] == "nn.rms_norm_residual"]
    assert fused and fused[0]["decision"] == "rejected"
    assert "cost-model gate" in fused[0]["reason"]
    monkeypatch.undo()
    args = [_on_cuda((16384, 4096)), _on_cuda((16384, 4096)), _on_cuda((4096,))]
    _, _, claims = _compile(_residual_norm, args)
    assert claims == {"rms_norm_residual": 1}


def test_turned_down_claims_are_counted_without_a_log(monkeypatch):
    """Every claim the gate turns down is counted by op and why, whether or
    not a decision log is kept: the cost model's no, and a gate that
    raised."""
    from thunder_tpu_torch.executors import passes
    from thunder_tpu_torch.observe import decisions

    monkeypatch.setattr(passes, "GATE_REJECTIONS", collections.Counter())
    monkeypatch.setattr(decisions, "active", lambda: False)
    monkeypatch.setattr(tcm, "MIN_CLAIM_BYTES", 1 << 40)
    args = [_on_cuda((8, 4096)), _on_cuda((4096,))]
    _compile(_norm, args)
    assert passes.gate_rejections() == {("rms_norm", "cost model"): 1}

    def broken(bsym):
        raise RuntimeError("cost model broken")

    monkeypatch.setattr(cudaex_claims.ex.implmap["nn.rms_norm"], "profitable", broken)
    _compile(_norm, args)
    assert passes.gate_rejections() == {("rms_norm", "cost model"): 1, ("rms_norm", "raised"): 1}


def test_gate_on_and_off_decode_programs_are_one_at_the_fitted_constant():
    """The per-op serving decode step at llama3-8b's width (3 layers, 8
    slots, FakeTensors on cuda:0), compiled with the gate on and with
    ``fusion_cost_model=False``: while ``MIN_CLAIM_BYTES`` is 0 the gate
    turns nothing down, so both are the same program, text for text (what
    ``chip_smoke.gate_decode_programs`` holds on the card)."""
    from test_torch_port_serving_jit import _card_runner

    from thunder_tpu_torch.executors import passes

    assert tcm.MIN_CLAIM_BYTES == 0
    run, decode, _ = _card_runner(False)
    before = passes.gate_rejections()
    texts = []
    for opts in ({}, {"fusion_cost_model": False}):
        jf = ptt.jit(run._decode_fn, fn_name="serving_decode", whole_program_jit=False,
                     block_fusion=False, **opts)
        jf.compile(*decode)
        texts.append(ptt.last_execution_trace(jf).python())
    assert texts[0] == texts[1]
    assert passes.gate_rejections() == before
