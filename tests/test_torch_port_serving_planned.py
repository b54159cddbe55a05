"""thunder_tpu_torch's serving planned rung against the JAX package, on the
CPU.

Kernel functions: ``decode_layer_plain`` and ``attn_subblock_plain`` against
the Pallas kernel they stand for (``_decode_call`` as ``pallas_decode_layer``
and ``pallas_attn_subblock`` call it), in float32 and bfloat16, GQA
(tiny-gqa) and MHA (tiny) head layouts, every activation for the layer, on
ragged lengths with a page-boundary crossing, an idle length-1 slot and a
replay slot (its write goes to the scratch page, and its pool row at
``len - 1`` differs from the fresh row the kernel attends). The installed
jax exposes the primitives the kernel calls only as
``jax._src.pallas.primitives.load``/``store``; the ``shim`` fixture binds
them to ``pl.load``/``pl.store`` for the test and edits no file of the JAX
package. Then the plain versions, without the shim, against the reference's
``nn.decode_layer``/``nn.attn_subblock`` decompositions in float32.

The slice: the port's ``ServingEngine(block_fusion=True, device="cpu")``
against the reference's ``ServingEngine(block_fusion=True)`` from the same
weights (greedy, sampled, chunked prefill, preemption, EOS), and the Pallas
kernels the reference's planned prefill chunk and decode step claim against
the functions one planned chunk and step of the port route.

Tolerances:
- float32 2e-5 absolute and relative: the reference's own
  kernel-vs-decomposition bound (tests/test_decode_layer.py);
- bfloat16 against the Pallas kernel: each result within 2 bf16 ulps of its
  own magnitude (2**-6 relative) plus 2**-6 of its tensor's largest value,
  as tests/test_torch_port_planned.py: both round the same float32 values at
  the same points, but a float32 sum taken in another order can move a
  rounding by one step, and a value rounded one step off (the normed rows,
  act(gate), up) moves what is computed from it by about one more;
- tokens identical: both engines run float32.
"""

from pathlib import Path

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.pallas import primitives as pallas_primitives

import thunder_tpu as tt
from thunder_tpu.executors import pallasex as px
from thunder_tpu.models import llama as jllama
from thunder_tpu.ops import nn as jnn
from thunder_tpu.runtime import quarantine
from thunder_tpu.serving import SamplingParams as JSamplingParams
from thunder_tpu.serving import ServingEngine as JServingEngine
from thunder_tpu.serving.kv_cache import PageGeometry as JPageGeometry
from thunder_tpu.serving.runner import PagedLlamaRunner as JRunner
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.runtime import faults
from thunder_tpu_torch.serving import PageGeometry, SamplingParams, ServingEngine
from thunder_tpu_torch.serving.runner import PagedLlamaRunner

ACTS = ["silu", "relu", "gelu", "gelu_tanh"]
MODELS = ["tiny-gqa", "tiny"]
BF16_REL = 2.0 ** -6
EPS = 1e-5
ENGINE_LAYERS = 2
CLAIM_LAYERS = 4


def _bind_pallas_primitives(mp: pytest.MonkeyPatch) -> None:
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    mp.setattr(pl, "store", pallas_primitives.store, raising=False)
    mp.setattr(pl, "load", pallas_primitives.load, raising=False)
    # another file in this worker may have quarantined pallas.decode_layer
    # when it failed to claim without the primitives
    quarantine.reset()


@pytest.fixture
def shim(monkeypatch):
    _bind_pallas_primitives(monkeypatch)
    yield
    quarantine.reset()


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_REL,
                                   atol=BF16_REL * float(np.abs(want).max()))


def _decode_inputs(model, dtype, seed=0):
    """One decode step's operands for the layer, as numpy (bf16 as
    ml_dtypes), in the layout of tests/test_decode_layer.py's inputs:
    4 slots of tiny-gqa's or tiny's layer over 3 pages of 8 per request.
    Slot 0 has 9 tokens (its fresh row opens page 2), slot 1 6, slot 2 is a
    replay row of 20 tokens (its write goes to the scratch position 0 and
    its pool row at position 19 is a random row, not its fresh row), slot 3
    is idle (length 1 on the scratch page)."""
    cfg = jllama.CONFIGS[model]
    D, H, KV, hd, F = cfg.dim, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.intermediate_size
    S, npg, ps = 4, 3, 8
    P = S * npg + 1
    rng = np.random.RandomState(seed + MODELS.index(model))
    bt = np.arange(1, P, dtype=np.int32).reshape(S, npg)
    bt[3] = 0
    lengths = np.asarray([ps + 1, 6, 20, 1], np.int32)
    write_pos = np.asarray([bt[b, (lengths[b] - 1) // ps] * ps + (lengths[b] - 1) % ps
                            for b in range(S)], np.int32)
    write_pos[2:] = 0
    ang = rng.uniform(0, 6.3, size=(S, 1, 1, hd // 2))
    arrs = [rng.randn(S, 1, D), 1.0 + 0.1 * rng.randn(D), rng.randn(H * hd, D) / np.sqrt(D),
            rng.randn(KV * hd, D) / np.sqrt(D), rng.randn(KV * hd, D) / np.sqrt(D),
            rng.randn(D, H * hd) / np.sqrt(H * hd), np.cos(ang), np.sin(ang),
            rng.randn(KV, P, ps, hd), rng.randn(KV, P, ps, hd)]
    mlp = [1.0 + 0.1 * rng.randn(D), rng.randn(F, D) / np.sqrt(D), rng.randn(F, D) / np.sqrt(D),
           rng.randn(D, F) / np.sqrt(F)]
    cast = np.float32 if dtype == "f32" else jnp.bfloat16
    arrs, mlp = ([np.array(jnp.asarray(a.astype(np.float32), cast)) for a in xs]
                 for xs in (arrs, mlp))
    return arrs, (bt, lengths, write_pos), mlp


def _torch(arrs):
    return [tllama._tensor_from_numpy(np.asarray(a)) for a in arrs]


def _port_call(fn, arrs, tables, mlp, **kw):
    """The routed function on CPU tensors: ``out`` and the pools it wrote."""
    t = _torch(arrs)
    bt, ln, wp = (torch.from_numpy(a) for a in tables)
    args = (*t, bt, ln, wp) + (tuple(_torch(mlp)) if mlp is not None else ())
    out = fn(*args, eps=EPS, **kw)
    return out, t[8], t[9]


def _check_against_reference(got, ref, dtype):
    """``out`` everywhere; the pools on every page but the scratch page 0,
    where the replay and idle slots' duplicate writes may land in either
    order."""
    out, kp, vp = got
    _close(out, ref[0], dtype)
    for mine, theirs in ((kp, ref[1]), (vp, ref[2])):
        _close(mine[:, 1:], np.asarray(theirs)[:, 1:], dtype)


# ---------------------------------------------------------------------------
# the kernel functions' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_layer_matches_pallas(dtype, model, act, shim):
    arrs, tables, mlp = _decode_inputs(model, dtype)
    ref = px.pallas_decode_layer(*map(jnp.asarray, arrs), *tables, *map(jnp.asarray, mlp),
                                 act=act, eps=EPS)
    got = _port_call(tnn.decode_layer, arrs, tables, mlp, act=act)
    assert got[0].dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    _check_against_reference(got, ref, dtype)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attn_subblock_matches_pallas(dtype, model, shim):
    arrs, tables, _ = _decode_inputs(model, dtype, seed=10)
    ref = px.pallas_attn_subblock(*map(jnp.asarray, arrs), *tables, eps=EPS)
    _check_against_reference(_port_call(tnn.attn_subblock, arrs, tables, None), ref, dtype)


def test_replay_row_attends_its_fresh_row(shim):
    """The replay slot's output depends on the row the kernel computed, not
    on the pool's row at ``len - 1``: changing that pool row changes
    neither the reference's nor the port's output, and attending it instead
    (the pool row written where the fresh row goes) changes both."""
    arrs, tables, _ = _decode_inputs("tiny-gqa", "f32", seed=20)
    ps, pos = 8, 19
    page = tables[0][2, pos // ps]
    outs = []
    for scale in (1.0, 5.0):
        a = [x.copy() for x in arrs]
        a[8][:, page, pos % ps] *= scale
        a[9][:, page, pos % ps] *= scale
        ref = px.pallas_attn_subblock(*map(jnp.asarray, a), *tables, eps=EPS)
        got = _port_call(tnn.attn_subblock, a, tables, None)
        _close(got[0], ref[0], "f32")
        outs.append(_f32(got[0]))
    np.testing.assert_array_equal(outs[0], outs[1])
    t = _torch(arrs)
    bt, ln, _ = (torch.from_numpy(x) for x in tables)
    q, k, v = tnn.decode_qkv_plain(t[0], t[1], t[2], t[3], t[4], t[6], t[7], EPS)
    k_rows, v_rows = k.transpose(0, 1).clone(), v.transpose(0, 1).clone()
    fresh = tnn.decode_attention_plain(q, k_rows, v_rows, t[8], t[9], bt, ln)
    k_rows[:, 2], v_rows[:, 2] = t[8][:, page, pos % ps], t[9][:, page, pos % ps]
    stale = tnn.decode_attention_plain(q, k_rows, v_rows, t[8], t[9], bt, ln)
    assert float((fresh[2] - stale[2]).abs().max()) > 1e-2
    torch.testing.assert_close(fresh[:2], stale[:2], rtol=0, atol=0)


@pytest.mark.parametrize("model", MODELS)
def test_plain_versions_equal_the_decompositions_in_f32(model):
    """In float32 the plain versions are the reference's ``nn.decode_layer``
    and ``nn.attn_subblock`` decompositions, traced with no kernel
    executor (no Pallas, no shim). The decompositions attend the pools
    after the row writes, so the replay slot reads its pool row: it holds
    the replay's own fresh row here, as prefill leaves it in an engine."""
    arrs, tables, mlp = _decode_inputs(model, "f32", seed=30)
    t = _torch(arrs)
    _, k, v = tnn.decode_qkv_plain(t[0], t[1], t[2], t[3], t[4], t[6], t[7], EPS)
    page, off = tables[0][2, 19 // 8], 19 % 8
    arrs[8][:, page, off], arrs[9][:, page, off] = k[2].numpy(), v[2].numpy()
    layer = tt.jit(lambda *a: jnn.decode_layer(*a, act="silu", eps=EPS), executors=["xla"])
    sub = tt.jit(lambda *a: jnn.attn_subblock(*a, eps=EPS), executors=["xla"])
    _check_against_reference(_port_call(tnn.decode_layer, arrs, tables, mlp),
                             layer(*arrs, *tables, *mlp), "f32")
    _check_against_reference(_port_call(tnn.attn_subblock, arrs, tables, None),
                             sub(*arrs, *tables), "f32")
    # the sub-block rung (attn_subblock, then mlp_subblock) is the same function
    _check_against_reference(_port_call(tnn.decode_layer_subblocks, arrs, tables, mlp),
                             layer(*arrs, *tables, *mlp), "f32")


def test_decode_wrappers_refuse_what_they_do_not_take():
    """The kernel wrappers refuse a CPU tensor, a dtype mismatch, and the
    shapes ``_attn_subblock_checker``/``_decode_layer_checker`` refuse; the
    routed functions refuse an unknown activation and other devices."""
    arrs, tables, mlp = _decode_inputs("tiny-gqa", "f32")
    t, tabs, m = _torch(arrs), [torch.from_numpy(a) for a in tables], _torch(mlp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cudaex.decode_layer(*t, *tabs, *m)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cudaex.attn_subblock(*t, *tabs)
    with pytest.raises(ValueError, match="dtype"):
        cudaex.attn_subblock(*t[:2], t[2].to(torch.bfloat16), *t[3:], *tabs)
    with pytest.raises(ValueError, match="decode only"):
        cudaex.attn_subblock(t[0].reshape(2, 2, -1), *t[1:], *tabs)
    with pytest.raises(ValueError, match="kv heads"):        # H % KV
        cudaex.attn_subblock(t[0], t[1], t[2][:3 * 16], *t[3:], *tabs)
    with pytest.raises(ValueError, match="cos"):
        cudaex.attn_subblock(*t[:6], t[6].reshape(4, 8), *t[7:], *tabs)
    with pytest.raises(ValueError, match="wo"):
        cudaex.attn_subblock(*t[:5], t[5][:, :32], *t[6:], *tabs)
    with pytest.raises(ValueError, match="slots"):
        cudaex.attn_subblock(*t, tabs[0][:2], *tabs[1:])
    with pytest.raises(ValueError, match="w_down"):
        cudaex.decode_layer(*t, *tabs, *m[:3], m[3][:, :8])
    with pytest.raises(ValueError, match="unknown activation"):
        cudaex.decode_layer(*t, *tabs, *m, act="tanh")
    with pytest.raises(ValueError, match="unknown activation"):
        tnn.decode_layer(*t, *tabs, *m, act="tanh")
    with pytest.raises(ValueError, match="not supported"):
        tnn.decode_layer(t[0].to("meta"), *t[1:], *tabs, *m)


def test_decode_kernels_are_registered_and_hand_written():
    """Both launches are registered with the Pallas functions they replace;
    their sources (with the header they share) are one cooperative kernel
    with grid-wide barriers and call no library product."""
    repo = Path(__file__).resolve().parents[1]
    for name, line in (("decode_layer", 1751), ("attn_subblock", 1743)):
        k = cudaex.KERNELS[name]
        assert k.replaces == f"thunder_tpu/executors/pallasex.py:{line}"
        text = (repo / k.source).read_text()
        assert '#include "decode_layer.cuh"' in text and "_decode_call (:1623)" in text
    header = (repo / "thunder_tpu_torch" / "csrc" / "decode_layer.cuh").read_text()
    assert "cudaLaunchCooperativeKernel" in header and "grid.sync()" in header
    for f in ("decode_layer.cu", "attn_subblock.cu", "decode_layer.cuh"):
        text = (repo / "thunder_tpu_torch" / "csrc" / f).read_text().lower()
        assert "cublas" not in text and "#include <torch" not in text


# ---------------------------------------------------------------------------
# the slice: planned engines, port vs reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = jllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(cfg, seed=0, scale_layers=ENGINE_LAYERS)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, tllama.CONFIGS["tiny-gqa"], jparams, tparams


def _prompts(seed, lengths, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).astype(np.int32) for n in lengths]


def _run_both(model, prompts, max_new, *, samplings=None, eos_id=None, **kw):
    """Both planned engines over the same requests; the reference's with its
    decode megakernel in interpret mode."""
    jcfg, tcfg, jparams, tparams = model
    kw = {"max_slots": 3, "page_size": 16, "max_context": 64, "prefill_chunk": 32, **kw}
    samplings = samplings or [None] * len(prompts)
    mp = pytest.MonkeyPatch()
    _bind_pallas_primitives(mp)
    try:
        jeng = JServingEngine(jparams, jcfg, block_fusion=True, n_layers=ENGINE_LAYERS, **kw)
        jreqs = [jeng.submit(p, max_new, eos_id=eos_id,
                             sampling=None if s is None else JSamplingParams(**s))
                 for p, s in zip(prompts, samplings)]
        jeng.drain()
        names = _claims(tt.last_execution_trace(jeng.runner.decode_jit))
    finally:
        mp.undo()
        quarantine.reset()
    assert names.get("pallas_decode_layer") == ENGINE_LAYERS, names
    teng = ServingEngine(tparams, tcfg, device="cpu", block_fusion=True, **kw)
    assert teng.runner.block_fusion
    treqs = [teng.submit(p, max_new, eos_id=eos_id,
                         sampling=None if s is None else SamplingParams(**s))
             for p, s in zip(prompts, samplings)]
    teng.drain()
    teng.assert_quiescent()
    return jreqs, treqs


@pytest.fixture(scope="module")
def engine_runs(model):
    """The four request mixes of tests/test_torch_port_serving.py, run once
    for the module: mixed lengths with a chunk-spanning prompt, a pool small
    enough to preempt, sampled beside greedy rows, EOS."""
    runs = {
        "mixed": _run_both(model, _prompts(0, (1, 7, 16, 33, 24)), 6),
        "preempt": _run_both(model, _prompts(1, (30, 28, 20)), 8, page_size=8,
                             num_pages=10, prefill_chunk=16),
        "sampled": _run_both(model, _prompts(2, (5, 12, 9, 20)), 8, samplings=[
            dict(temperature=0.8, top_k=50, top_p=0.9, seed=7), None,
            dict(temperature=1.0, seed=11), dict(temperature=0.7, top_p=0.5, seed=3)]),
    }
    eos = int(runs["mixed"][0][2].output()[2])
    runs["eos"] = _run_both(model, _prompts(0, (1, 7, 16)), 6, eos_id=eos)
    runs["eos_id"] = eos
    return runs


@pytest.mark.parametrize("mix", ["mixed", "preempt", "sampled", "eos"])
def test_planned_engine_tokens_identical(engine_runs, mix):
    jreqs, treqs = engine_runs[mix]
    for j, t in zip(jreqs, treqs):
        assert t.done
        np.testing.assert_array_equal(t.output(), j.output())
    if mix == "mixed":
        assert max(t.prefill_chunks for t in treqs) == 2
    if mix == "preempt":
        assert sum(t.preemptions for t in treqs) > 0
        assert [t.preemptions for t in treqs] == [j.preemptions for j in jreqs]
    if mix == "eos":
        out = treqs[2].output()
        assert len(out) == 3 and out[-1] == engine_runs["eos_id"]


def test_planned_engine_matches_the_per_op_engine(model):
    """The two rungs of the port are the same function: in float32 their
    greedy tokens agree."""
    _, tcfg, _, tparams = model
    kw = dict(device="cpu", max_slots=3, page_size=8, num_pages=10, max_context=64,
              prefill_chunk=16)
    outs = []
    for bf in (False, True):
        eng = ServingEngine(tparams, tcfg, block_fusion=bf, **kw)
        reqs = [eng.submit(p, 8) for p in _prompts(1, (30, 28, 20))]
        eng.drain()
        outs.append([r.output().tolist() for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# claims: the reference's planned chunk and step vs the port's routed calls
# ---------------------------------------------------------------------------

def _claims(trc):
    counts = {}

    def walk(bsyms):
        for b in bsyms:
            name = b.sym.codegen_name()
            if name.startswith("pallas_"):
                counts[name] = counts.get(name, 0) + 1
            walk(b.subsymbols)

    walk(trc.bound_symbols)
    return counts


def bound_layer_kernel(eng):
    """The kernel each layer of the engine's bound decode program runs:
    ``"decode_layer"``, ``"attn_subblock"`` (the sub-block rung, with
    ``mlp_subblock``), or None (the per-op rung)."""
    from thunder_tpu_torch.executors.cudaex_claims import kernel_of

    entry = eng.runner._decode_bound.entry
    kernels = [kernel_of(b.sym) for b in entry.traces[-1].bound_symbols]
    for name in ("decode_layer", "attn_subblock"):
        if kernels.count(name) == ENGINE_LAYERS:
            return name
    return None


EXPECTED_PREFILL = {"pallas_rms_norm": CLAIM_LAYERS, "pallas_mlp_subblock": CLAIM_LAYERS - 1}
EXPECTED_DECODE = {"pallas_decode_layer": CLAIM_LAYERS, "pallas_rms_norm": 1}


@pytest.fixture(scope="module")
def claim_runs():
    """One planned prefill chunk and one planned decode step of both
    runners at 4 layers, on the same weights, pools and tables."""
    jcfg, tcfg = jllama.CONFIGS["tiny-gqa"], tllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(jcfg, seed=1, scale_layers=CLAIM_LAYERS)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    S, npg, ps, P = 4, 3, 8, 13
    rng = np.random.RandomState(5)
    geom = dict(n_layers=CLAIM_LAYERS, kv_heads=jcfg.kv_heads, head_dim=jcfg.head_dim,
                page_size=ps, num_pages=P, pages_per_request=npg)
    pools = [{k: (rng.rand(jcfg.kv_heads, P, ps, jcfg.head_dim) - 0.5).astype(np.float32)
              for k in ("k", "v")} for _ in range(CLAIM_LAYERS)]
    chunk = rng.randint(1, jcfg.vocab_size, size=(1, 16)).astype(np.int32)
    chunk_tables = (np.asarray([[5, 2, 7]], np.int32), np.asarray([ps + 16], np.int32),
                    np.asarray([2, 7], np.int32))
    tokens = rng.randint(1, jcfg.vocab_size, size=(S, 1)).astype(np.int32)
    bt = np.asarray([[1, 2, 0], [3, 0, 0], [4, 5, 6], [0, 0, 0]], np.int32)
    lengths = np.asarray([9, 6, 20, 1], np.int32)
    write_pos = np.asarray([2 * ps, 3 * ps + 5, 0, 0], np.int32)   # slot 2 replays
    sampling = (np.zeros(S, np.float32), np.zeros(S, np.int32), np.ones(S, np.float32),
                np.zeros((S, 2), np.uint32))
    mp = pytest.MonkeyPatch()
    _bind_pallas_primitives(mp)
    try:
        jrun = JRunner(jcfg, JPageGeometry(**geom), n_layers=CLAIM_LAYERS, block_fusion=True)
        jpools = [{k: jnp.asarray(v) for k, v in kv.items()} for kv in pools]
        jpools = jrun.prefill_jit(jparams, chunk, chunk_tables[0], chunk_tables[1],
                                  chunk_tables[2] * ps, jpools)
        prefill_claims = _claims(tt.last_execution_trace(jrun.prefill_jit))
        jtok, jlogits, jpools = jrun.decode_jit(jparams, tokens, bt, lengths, write_pos,
                                                jpools, *sampling)
        decode_claims = _claims(tt.last_execution_trace(jrun.decode_jit))
    finally:
        mp.undo()
        quarantine.reset()
    t = torch.from_numpy
    return {"tparams": tparams, "tcfg": tcfg, "geom": PageGeometry(**geom),
            "pools": pools, "prefill": (t(chunk).long(), *map(t, chunk_tables[:2]),
                                        t(chunk_tables[2]).long()),
            "decode": (t(tokens).long(), t(bt), t(lengths), t(write_pos).long(),
                       t(sampling[0]), t(sampling[1]), t(sampling[2]),
                       t(sampling[3].astype(np.int64))),
            "ref": (np.asarray(jtok), np.asarray(jlogits), jpools),
            "claims": (prefill_claims, decode_claims)}


def test_reference_planned_steps_claim_the_ported_kernels(claim_runs):
    assert claim_runs["claims"] == (EXPECTED_PREFILL, EXPECTED_DECODE)


def test_planned_steps_match_reference(claim_runs):
    """One planned chunk, then one planned decode step, of the port's traced
    runner (on the CPU its claims run their routers, the pools written in
    place) against the reference's: logits and tokens, and the pools on
    every page but the scratch page. Each routed function is called as
    often as the reference claims its kernel (on a card, each call is one
    launch), and no other kernel-backed function is."""
    def calls():
        return {f"pallas_{k.removeprefix('cuda.')}": n for k, n in faults.claim_calls().items()}

    run = PagedLlamaRunner(claim_runs["tcfg"], claim_runs["geom"], block_fusion=True,
                           device=torch.device("cpu"))
    pools = [{k: torch.from_numpy(v.copy()) for k, v in kv.items()}
             for kv in claim_runs["pools"]]
    faults.reset_claim_calls()
    run.prefill(claim_runs["tparams"], *claim_runs["prefill"][:3],
                claim_runs["prefill"][3] * claim_runs["geom"].page_size, pools)
    assert calls() == EXPECTED_PREFILL
    faults.reset_claim_calls()
    tok, logits = run.decode(claim_runs["tparams"], *claim_runs["decode"][:4], pools,
                             *claim_runs["decode"][4:])
    assert calls() == EXPECTED_DECODE
    jtok, jlogits, jpools = claim_runs["ref"]
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    for jkv, tkv in zip(jpools, pools):
        for k in ("k", "v"):
            np.testing.assert_allclose(tkv[k][:, 1:].numpy(), np.asarray(jkv[k])[:, 1:],
                                       atol=2e-5, rtol=2e-5)
