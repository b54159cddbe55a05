"""thunder_tpu_torch's cost model (``core/cost_model.py``) against the JAX
package's (``thunder_tpu/core/cost_model.py``), on the CPU.

- With the reference's constants patched into the port's module (inside
  the test only), every ported cost function returns the reference's
  numbers and verdicts on a grid of shapes: tiny-gqa's MLP sub-block
  (32 rows, D 64, F 176), the 512-row prefill chunk and llama3-8b-bench's
  train shape (16384 rows, D 4096, F 14336), in bf16 and float32, and
  ``tensor_bytes`` of the same proxies in both packages. Two fields differ
  by design:
  the port has no VMEM model (the kernel's own refusal takes its place),
  so the reference's ``vmem_bytes_per_step``/``vmem_feasible`` have no
  counterpart and its verdict is compared where the reference's VMEM gate
  passes; the port's sub-block dict adds ``backward``.
- With the port's own constants (NVIDIA H100 80GB HBM3, 700.00 W): they
  reproduce the card times they were fitted to (PERF.md §6 rows 7, 8, 11)
  within 0.1%; at phase 7's cell the verdict taken before autodiff is the
  per-op rung; at the 512-row prefill chunk the forward-only verdict plans
  (by 14.1 us of 384: the model adds byte time to product time, so the
  interior bytes outweigh the kernel's rate handicap, where the card
  measured a tie, 0.3367 against 0.3375 ms); no TPU constant is left.
- ``fusion_passes.mlp_block_verdict``, the one verdict the block pass and
  the eager entry points read: the cost model's, never planned inside a
  checkpointed region.
"""

import inspect
import math

import pytest

from thunder_tpu.core import cost_model as jcm
from thunder_tpu.core import dtypes as jdtypes
from thunder_tpu.core.proxies import TensorProxy as JTensorProxy
from thunder_tpu.core.trace import TraceCtx as JTraceCtx, tracectx as jtracectx
from thunder_tpu_torch.core import cost_model as tcm
from thunder_tpu_torch.core import dtypes as tdtypes
from thunder_tpu_torch.core.fusion_passes import mlp_block_verdict
from thunder_tpu_torch.core.proxies import TensorProxy as TTensorProxy
from thunder_tpu_torch.core.trace import TraceCtx as TTraceCtx, tracectx as ttracectx

# the port's name -> the reference's constant it stands for
REFERENCE_NAMES = {
    "PEAK_FLOPS": "TPU_PEAK_FLOPS",
    "HBM_GBPS": "ADAMW_HBM_GBPS",
    "ADAMW_LAUNCH_OVERHEAD_US": "ADAMW_LAUNCH_OVERHEAD_US",
    "ADAMW_CHAIN_EFFICIENCY": "ADAMW_CHAIN_EFFICIENCY",
    "ADAMW_FUSED_EFFICIENCY": "ADAMW_FUSED_EFFICIENCY",
    "SUBBLOCK_CHAIN_EFFICIENCY": "SUBBLOCK_XLA_EFFICIENCY",
    "SUBBLOCK_FUSED_EFFICIENCY": "SUBBLOCK_FUSED_EFFICIENCY",
    "SUBBLOCK_LAUNCH_OVERHEAD_US": "SUBBLOCK_LAUNCH_OVERHEAD_US",
}
SHAPES = [(32, 64, 176), (512, 4096, 14336), (16384, 4096, 14336)]
VMEM_ONLY = {"vmem_bytes_per_step", "vmem_feasible"}


@pytest.fixture
def reference_constants(monkeypatch):
    for port, ref in REFERENCE_NAMES.items():
        monkeypatch.setattr(tcm, port, getattr(jcm, ref))


def _same_fields(got: dict, want: dict, extra_got=(), extra_want=()):
    assert set(got) - set(want) == set(extra_got)
    assert set(want) - set(got) == set(extra_want)
    for k in set(got) & set(want):
        assert got[k] == want[k], (k, got[k], want[k])


# ---------------------------------------------------------------------------
# the reference's numbers under the reference's constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=["tiny-gqa", "chunk512", "llama3-8b-bench"])
@pytest.mark.parametrize("dtype_bytes", [2, 4], ids=["bf16", "f32"])
def test_subblock_cost_matches_reference(reference_constants, shape, dtype_bytes):
    got = tcm.subblock_cost(*shape, dtype_bytes)
    want = jcm.subblock_cost(*shape, dtype_bytes)
    # the reference's decode term comes with the decode stages (A.7.5)
    assert want["decode"] is False
    _same_fields(got, want, extra_got={"backward"}, extra_want=VMEM_ONLY | {"decode"})
    assert got["backward"] is False
    if want["vmem_feasible"]:
        assert tcm.subblock_profitable(got) == jcm.subblock_profitable(want)
    else:   # the port's kernel has no VMEM budget: the estimate alone decides
        assert tcm.subblock_profitable(got) == (want["est_saved_us"] > 0.0)


@pytest.mark.parametrize("n", [1, 2, 39, 100])
@pytest.mark.parametrize("total_bytes", [64 << 10, 2_700_000_000, 24_963_400_000])
def test_fused_adamw_cost_matches_reference(reference_constants, n, total_bytes):
    _same_fields(tcm.fused_adamw_cost(n, total_bytes), jcm.fused_adamw_cost(n, total_bytes))
    assert tcm.fused_adamw_profitable(n, total_bytes) == jcm.fused_adamw_profitable(n,
                                                                                    total_bytes)


@pytest.mark.parametrize("m_tokens,widths", [
    (16384, [4096, 1024, 1024]), (16384, [14336, 14336]), (4096, [4096, 1024, 1024]),
    (64, [64, 32, 32]), (32, [64, 32, 32]), (2048, [6144]), (16384, [4096, 4096, 4096])])
def test_horizontal_merge_verdict_matches_reference(m_tokens, widths):
    assert tcm.horizontal_merge_profitable(m_tokens, widths) == \
        jcm.horizontal_merge_profitable(m_tokens, widths)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int64"])
@pytest.mark.parametrize("shape", [(16384, 4096), (4096,), (2, 3, 5)])
def test_tensor_bytes_matches_reference(dtype, shape):
    with ttracectx(TTraceCtx("t")):
        got = tcm.tensor_bytes(TTensorProxy("a", shape=shape, dtype=getattr(tdtypes, dtype)))
    with jtracectx(JTraceCtx("t")):
        want = jcm.tensor_bytes(JTensorProxy("a", shape=shape, dtype=getattr(jdtypes, dtype)))
    assert got == want
    assert tcm.tensor_bytes(None) == jcm.tensor_bytes(None) == 0


# ---------------------------------------------------------------------------
# the card's constants
# ---------------------------------------------------------------------------

def _close(got, want, rel=1e-3):
    assert abs(got - want) <= rel * want, (got, want)


def test_constants_reproduce_the_card_times():
    """PERF.md §6 (H100 80GB HBM3, 700.00 W): row 7 mlp_subblock 8.498 ms
    against its chain's 9.042, row 8 mlp_subblock_bwd 24.32 against 20.19,
    at 16384 x 4096 x 14336 bf16; row 11 fused_adamw 8.312 ms against its
    plain chains' 67.18 over llama3-8b-bench's 39 tensors (1.1347 G
    parameters, 22 bytes an element)."""
    c = tcm.subblock_cost(16384, 4096, 14336, 2, backward=True)
    _close(c["est_fused_fwd_us"], 8498.0)
    _close(c["est_unfused_fwd_us"], 9042.0)
    _close(c["est_fused_bwd_us"], 24320.0)
    _close(c["est_unfused_bwd_us"], 20190.0)
    a = tcm.fused_adamw_cost(39, 22 * 1_134_700_000)
    _close(a["est_fused_us"], 8312.0)
    _close(a["est_unfused_us"], 67180.0)


def test_card_verdicts():
    # phase 7's cell, decided before autodiff: the kernel pair loses
    train = tcm.subblock_cost(16384, 4096, 14336, 2, backward=True)
    assert not tcm.subblock_profitable(train)
    assert train["est_unfused_us"] < train["est_fused_us"]
    # the same chain in a grad-free trace: the forward kernel wins, as measured
    assert tcm.subblock_profitable(tcm.subblock_cost(16384, 4096, 14336, 2))
    # the 512-row prefill chunk (card: 0.3367 against 0.3375 ms, a tie): the
    # model plans, by the 14.1 us its summed byte time gives the interiors
    chunk = tcm.subblock_cost(512, 4096, 14336, 2)
    assert tcm.subblock_profitable(chunk)
    assert 10.0 < chunk["est_saved_us"] < 20.0
    # tiny shapes: the launch dwarfs the saving, forward or not
    for backward in (False, True):
        assert not tcm.subblock_profitable(tcm.subblock_cost(32, 64, 176, 4,
                                                             backward=backward))
    # llama2-7b-bench's bench shape (row 8: 18.87 against 16.52): per-op
    assert not tcm.subblock_profitable(tcm.subblock_cost(16384, 4096, 11008, 2,
                                                         backward=True))
    # the optimizer buckets at the train cell, and a bucket of one never
    assert tcm.fused_adamw_profitable(39, 22 * 1_134_700_000)
    assert not tcm.fused_adamw_profitable(1, 22 * 1_134_700_000)


def test_no_tpu_constant_is_left():
    """No constant of the module equals one of the reference's TPU figures,
    and the module names the card and power limit its constants come from."""
    names = [n for n in dir(tcm) if n.isupper() and isinstance(getattr(tcm, n), (int, float))]
    tpu = {getattr(jcm, n) for n in dir(jcm) if n.isupper()
           and isinstance(getattr(jcm, n), (int, float)) and not isinstance(getattr(jcm, n), bool)}
    for n in names:
        assert not any(math.isclose(getattr(tcm, n), v) for v in tpu), n
    src = inspect.getsource(tcm)
    assert "H100 80GB HBM3" in src and "700.00 W" in src
    for word in ("v5e", "v5p", "VMEM_BUDGET", "TPU_"):
        assert word not in src.replace("TPU_PEAK_FLOPS", ""), word


# ---------------------------------------------------------------------------
# the one verdict the planner and the eager entry points read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (rows, D, F, bytes, backward, checkpointed, planned)
    (16384, 4096, 14336, 2, True, False, False),    # phase 7's train cell: per-op
    (16384, 4096, 14336, 2, False, False, True),    # the same chain, grad-free
    (512, 4096, 14336, 2, False, False, True),      # the prefill chunk
    (512, 4096, 14336, 2, False, True, False),      # inside a checkpointed region
    (32, 64, 176, 4, True, False, False),           # tiny-gqa
], ids=["train-cell", "grad-free", "chunk512", "checkpointed", "tiny"])
def test_mlp_block_verdict(case):
    n, d, f, nbytes, backward, checkpointed, planned = case
    v = mlp_block_verdict(n, d, f, nbytes, backward=backward, checkpointed=checkpointed)
    assert v["planned"] is planned
    cost = tcm.subblock_cost(n, d, f, nbytes, backward=backward)
    assert {k: v[k] for k in cost} == cost
    if not checkpointed:
        assert v["planned"] == tcm.subblock_profitable(cost)
