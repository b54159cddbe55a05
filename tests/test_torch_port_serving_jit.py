"""thunder_tpu_torch's serving engine on ``jit`` against the JAX package's, on
the CPU.

The engine's steps are traced programs (``serving/runner.py``: ``jit`` of
``_decode_fn`` and ``_prefill_fn``, the pools donated), planned by the block
planner's decode stages (``core/fusion_passes.py``) under the decode half of
the cost model, and, on the card, replayed as one CUDA graph a cached entry
(``executors/cudagraphex.py``). Here, at tiny-gqa float32 (2 layers, the
same weights through ``params_from_jax``, the same numpy requests):

- the engine at ``block_fusion=False``, ``True`` and unset against the
  reference's ``ServingEngine`` at the same setting: identical greedy tokens,
  and identical sampled ones (the traced epilogue draws the reference's
  uniforms bit for bit); the donated pools written in place;
- the decode and prefill execution traces on ``FakeTensor``\\ s on
  ``cuda:0`` at llama3-8b's geometry (3 layers): the claims of the kernel
  table's rows 4, 5, 6, 9 and 10 at each rung, and the pool writes marked
  ``donated``;
- the decode stages' verdicts against the reference's decision records on
  the engine's own decode and prefill programs (the reference's
  ``_decode_call`` in Pallas interpret mode, through the ``shim`` fixture);
- ``attn_subblock_cost`` and ``decode_layer_cost`` recomputed from the
  fitted constants, which return PERF.md row 10's four times, and the
  per-op launch counts they charge counted in a traced step;
- the replay's rules that need no card: which entries run as a graph, the
  per-call reason of a trace that reads the device, and when a graph is
  captured again or an input copied.
"""

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from test_torch_port_serving_planned import _bind_pallas_primitives, shim  # noqa: F401

import thunder_tpu as tt
from thunder_tpu.models import llama as jllama
from thunder_tpu.runtime import quarantine as jquarantine
from thunder_tpu.serving import SamplingParams as JSamplingParams
from thunder_tpu.serving import ServingEngine as JServingEngine
import thunder_tpu_torch as ptt
from thunder_tpu_torch.core import cost_model as tcm
from thunder_tpu_torch.executors.cudaex_claims import kernel_of
from thunder_tpu_torch.executors.cudagraphex import WholeProgram
from thunder_tpu_torch.executors.eagertorch import MAY_ALIAS
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.runtime import quarantine
from thunder_tpu_torch.serving import PageGeometry, SamplingParams, ServingEngine
from thunder_tpu_torch.serving.runner import PagedLlamaRunner

N_LAYERS = 2
RUNGS = [False, True, None]
RUNG_IDS = ["per-op", "planned", "unset"]
KW = {"max_slots": 3, "page_size": 16, "max_context": 64, "prefill_chunk": 32}


@pytest.fixture(scope="module")
def model():
    cfg = jllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(cfg, seed=0, scale_layers=N_LAYERS)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, tllama.CONFIGS["tiny-gqa"], jparams, tparams


@pytest.fixture(autouse=True)
def _clean_quarantines():
    quarantine.reset()
    jquarantine.reset()
    yield
    quarantine.reset()
    jquarantine.reset()


def _prompts(seed, lengths, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=n).astype(np.int32) for n in lengths]


SAMPLINGS = [dict(temperature=0.8, top_k=50, top_p=0.9, seed=7), None,
             dict(temperature=1.0, seed=11), None, dict(temperature=0.7, top_p=0.5, seed=3)]


def _serve(model, block_fusion, prompts, samplings, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = {**KW, **kw}
    jeng = JServingEngine(jparams, jcfg, block_fusion=block_fusion, n_layers=N_LAYERS, **kw)
    teng = ServingEngine(tparams, tcfg, device="cpu", block_fusion=block_fusion, **kw)
    out = []
    for eng, SP in ((jeng, JSamplingParams), (teng, SamplingParams)):
        reqs = [eng.submit(p, 6, sampling=None if s is None else SP(**s))
                for p, s in zip(prompts, samplings)]
        eng.drain()
        out.append(reqs)
    return jeng, teng, out


# ---------------------------------------------------------------------------
# the engine against the reference's, at each rung
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_fusion", RUNGS, ids=RUNG_IDS)
def test_engine_tokens_match_reference(model, shim, block_fusion):
    """Greedy and sampled requests of mixed lengths (a two-chunk prompt)
    through 3 slots: every token identical to the reference engine's at the
    same ``block_fusion``; the engine's pools are the tensors it allocated,
    written in place."""
    prompts = _prompts(0, (1, 7, 16, 33, 24))
    jeng, teng, (jreqs, treqs) = _serve(model, block_fusion, prompts, SAMPLINGS)
    for j, t in zip(jreqs, treqs):
        assert t.done
        np.testing.assert_array_equal(t.output(), j.output())
    assert max(t.prefill_chunks for t in treqs) == 2
    teng.assert_quiescent()


def test_engine_writes_the_donated_pools_in_place(model):
    """Every decode step and prefill chunk writes the engine's own pool
    tensors: none is replaced by a copy."""
    _, tcfg, _, tparams = model
    eng = ServingEngine(tparams, tcfg, device="cpu", **KW)
    ptrs = [(kv["k"].data_ptr(), kv["v"].data_ptr()) for kv in eng.cache.pools]
    objs = [(kv["k"], kv["v"]) for kv in eng.cache.pools]
    reqs = [eng.submit(p, 4) for p in _prompts(1, (5, 19, 40))]
    eng.drain()
    assert all(r.done for r in reqs)
    assert [(kv["k"].data_ptr(), kv["v"].data_ptr()) for kv in eng.cache.pools] == ptrs
    assert all(a is kv["k"] and b is kv["v"] for (a, b), kv in zip(objs, eng.cache.pools))
    assert any(float(kv["k"].abs().sum()) > 0 for kv in eng.cache.pools)


# ---------------------------------------------------------------------------
# the claims on the card (FakeTensors on cuda:0)
# ---------------------------------------------------------------------------

_MODE = FakeTensorMode()
CARD_LAYERS, CARD_SLOTS, CARD_PS, CARD_NPG = 3, 8, 16, 128


def _fake(shape, dtype):
    return FakeTensor(_MODE, torch.empty(shape, dtype=dtype, device="meta"),
                      torch.device("cuda:0"))


def _card_runner(block_fusion):
    """A runner at llama3-8b's geometry and 3 layers, and the FakeTensor
    operands of its decode step and of a 512-row prefill chunk."""
    cfg = tllama.CONFIGS["llama3-8b"]
    L, S, ps, npg = CARD_LAYERS, CARD_SLOTS, CARD_PS, CARD_NPG
    P = S * npg + 1
    D, hd, F, KV, dt = cfg.dim, cfg.head_dim, cfg.intermediate_size, cfg.kv_heads, cfg.dtype
    geom = PageGeometry(n_layers=L, kv_heads=KV, head_dim=hd, page_size=ps, num_pages=P,
                        pages_per_request=npg)
    shapes = {"attn_norm": (D,), "wq": (D, D), "wk": (KV * hd, D), "wv": (KV * hd, D),
              "wo": (D, D), "mlp_norm": (D,), "w_gate": (F, D), "w_up": (F, D),
              "w_down": (D, F)}
    params = {"tok_embedding": _fake((cfg.vocab_size, D), dt), "norm_f": _fake((D,), dt),
              "lm_head": _fake((cfg.vocab_size, D), dt),
              "layers": [{k: _fake(s, dt) for k, s in shapes.items()} for _ in range(L)]}
    pools = [{k: _fake((KV, P, ps, hd), dt) for k in ("k", "v")} for _ in range(L)]
    decode = (params, _fake((S, 1), torch.int64), _fake((S, npg), torch.int32),
              _fake((S,), torch.int32), _fake((S,), torch.int64), pools,
              _fake((S,), torch.float32), _fake((S,), torch.int64), _fake((S,), torch.float32),
              _fake((S, 2), torch.int64))
    C = 512
    prefill = (params, _fake((1, C), torch.int64), _fake((1, npg), torch.int32),
               _fake((1,), torch.int32), _fake((C // ps,), torch.int64), pools)
    return PagedLlamaRunner(cfg, geom, block_fusion=block_fusion), decode, prefill


def _kernels(trc) -> dict:
    out: dict = {}
    for b in trc.bound_symbols:
        k = kernel_of(b.sym)
        if k is not None:
            out[k] = out.get(k, 0) + 1
    return out


@pytest.mark.parametrize("block_fusion", RUNGS, ids=RUNG_IDS)
def test_decode_claims_on_the_card(block_fusion):
    """Per-op: rows 4, 5, 6 and 9 (``rms_norm`` for layer 0's norm,
    ``rms_norm_residual`` for every later norm, the gate's ``linear_act``,
    ``paged_decode_attention``), each row scatter donated; planned, and
    unset at serving shape (the decode cost model plans): row 10, one
    ``decode_layer`` a layer writing both donated pools in place, and
    ``rms_norm``. Every entry on the card runs as one graph."""
    run, decode, _ = _card_runner(block_fusion)
    entry = run.decode_jit.compile(*decode)
    L = CARD_LAYERS
    trc = entry.traces[-2]
    if block_fusion is False:
        assert _kernels(trc) == {"rms_norm": 1, "rms_norm_residual": 2 * L, "linear_act": L,
                                 "paged_decode_attention": L}
        writes = [b for b in trc.bound_symbols if b.sym.name == "scatter"]
        assert len(writes) == 2 * L and all(b.kwargs.get("donated") is True for b in writes)
    else:
        assert _kernels(trc) == {"decode_layer": L, "rms_norm": 1}
        layers = [b for b in trc.bound_symbols if kernel_of(b.sym) == "decode_layer"]
        assert all(b.kwargs["donated"] == ((True,), (True,)) for b in layers)
        assert not any(b.sym.name == "scatter" for b in trc.bound_symbols)
    assert entry.writes_donated and entry.whole_program == "graph"
    assert "donated=True" in trc.python() or "donated=((True,), (True,))" in trc.python()


@pytest.mark.parametrize("block_fusion", RUNGS, ids=RUNG_IDS)
def test_prefill_claims_on_the_card(block_fusion):
    """A 512-row chunk: per-op, ``rms_norm`` once, ``rms_norm_residual``
    and ``linear_act`` for all but the last layer (its attention and MLP
    feed nothing); planned, and unset (the forward cost plans at 512 rows),
    ``rms_norm`` a layer and ``mlp_subblock`` for all but the last. The
    chunk's attention keeps the decomposition (T > 1). Every page write is
    a donated ``dynamic_update_slice``."""
    run, _, prefill = _card_runner(block_fusion)
    entry = run.prefill_jit.compile(*prefill)
    L = CARD_LAYERS
    trc = entry.traces[-2]
    if block_fusion is False:
        assert _kernels(trc) == {"rms_norm": 1, "rms_norm_residual": 2 * (L - 1),
                                 "linear_act": L - 1}
    else:
        assert _kernels(trc) == {"rms_norm": L, "mlp_subblock": L - 1}
    writes = [b for b in trc.bound_symbols if b.sym.name == "dynamic_update_slice"]
    assert len(writes) == 2 * L * (512 // CARD_PS)
    assert all(b.kwargs.get("donated") is True for b in writes)


def test_quarantine_reroutes_the_planned_step():
    """The quarantine epoch is in the guard key: with ``cuda.decode_layer``
    quarantined the next compile of the planned step plans the two
    sub-blocks (recorded ``unclaimed`` for the chain), and with
    ``cuda.attn_subblock`` too, the per-op attention (each layer's norm a
    plain ``rms_norm``: the sub-block before it took the residual add)
    beside the ``mlp_subblock`` kernel."""
    run, decode, _ = _card_runner(True)
    L = CARD_LAYERS
    assert _kernels(run.decode_jit.compile(*decode).traces[-2]) == {"decode_layer": L,
                                                                    "rms_norm": 1}
    quarantine.get_quarantine().add("cuda.decode_layer", reason="test")
    assert _kernels(run.decode_jit.compile(*decode).traces[-2]) == {
        "attn_subblock": L, "mlp_subblock": L, "rms_norm": 1}
    verdicts = {d["decision"] for d in ptt.compile_stats(run.decode_jit).last_decisions
                if d["op"] == "nn.decode_layer"}
    assert verdicts == {"unclaimed"}
    quarantine.get_quarantine().add("cuda.attn_subblock", reason="test")
    assert _kernels(run.decode_jit.compile(*decode).traces[-2]) == {
        "mlp_subblock": L, "rms_norm": L + 1, "paged_decode_attention": L}
    assert run.decode_jit.cache_misses == 3


# ---------------------------------------------------------------------------
# the decode stages' verdicts against the reference's decision records
# ---------------------------------------------------------------------------

def _block_verdicts(decisions):
    return [(d["op"], d["decision"]) for d in decisions if d["kind"] == "block"]


@pytest.mark.parametrize("block_fusion", [True, None], ids=["planned", "unset"])
def test_decode_stage_verdicts_match_reference(model, shim, block_fusion):
    """The same requests through both engines: the block planner's verdicts
    on the decode program (attention sub-blocks planned, MLP sub-blocks
    planned as part of a decode step, the pairs chained into
    ``nn.decode_layer``) and on the prefill program equal the reference's,
    in order."""
    jeng, teng, _ = _serve(model, block_fusion, _prompts(2, (5, 19, 33)), [None] * 3)
    verdicts = {}
    for name in ("decode_jit", "prefill_jit"):
        want = _block_verdicts(tt.compile_stats(getattr(jeng.runner, name)).last_decisions)
        got = _block_verdicts(ptt.compile_stats(getattr(teng.runner, name)).last_decisions)
        assert got == want, name
        verdicts[name] = got
    assert verdicts["decode_jit"].count(("nn.decode_layer", "chained")) == N_LAYERS


def test_decode_stage_verdicts_unset_chain_at_serving_shape():
    """At the serving shape the unset verdicts plan every attention and MLP
    sub-block (scored ``decode=True``) and chain each pair, as the
    reference's planner does."""
    run, decode, _ = _card_runner(None)
    run.decode_jit.compile(*decode)
    decisions = ptt.compile_stats(run.decode_jit).last_decisions
    L = CARD_LAYERS
    assert _block_verdicts(decisions) == ([("nn.attn_subblock", "planned")] * L
                                          + [("nn.mlp_subblock", "planned")] * L
                                          + [("nn.decode_layer", "chained")] * L)
    mlp = [d["cost"] for d in decisions if d["op"] == "nn.mlp_subblock"]
    assert all(c["decode"] for c in mlp)


# ---------------------------------------------------------------------------
# the decode half of the cost model
# ---------------------------------------------------------------------------

def _close(got, want, rel=1e-3):
    assert abs(got - want) <= rel * want, (got, want)


def test_decode_costs_recomputed_from_the_constants():
    """PERF.md §6 row 10 (H100 80GB HBM3, 700.00 W; 8 slots, D 4096, 32/8
    heads of 128, a 2048-token window of 16-token pages, F 14336, bf16):
    attn_subblock 0.0929 ms against its chain's 0.1423, decode_layer 0.2522
    against 0.3142. Recomputed here from the constants, and the functions
    return the same numbers."""
    S, D, H, KV, hd, ps, npg, b, F = 8, 4096, 32, 8, 128, 16, 128, 2, 14336
    bw = 1.0 / (tcm.HBM_GBPS * 1e3)
    g = tcm.DECODE_GRAPH_LAUNCH_US
    L = npg * ps
    qkv = (H + 2 * KV) * hd
    flop_a = (2 * S * D * qkv + 4 * S * H * hd * L + 2 * S * H * hd * D) / tcm.PEAK_FLOPS * 1e6
    bnd_a = (qkv * D + D * H * hd) * b + 2 * S * D * b + 2 * S * KV * L * hd * b
    int_a = 2 * S * (2 * D + 2 * qkv + H * hd) * b
    a_fused = flop_a / tcm.SUBBLOCK_FUSED_EFFICIENCY + bnd_a * bw / \
        tcm.DECODE_ATTN_FUSED_EFFICIENCY + g
    a_chain = (flop_a / tcm.SUBBLOCK_CHAIN_EFFICIENCY + (bnd_a + int_a) * bw
               / tcm.DECODE_ATTN_CHAIN_EFFICIENCY + tcm.DECODE_UNFUSED_LAUNCHES_ATTN * g)
    flop_m = 6 * S * D * F / tcm.PEAK_FLOPS * 1e6
    bnd_m = 3 * S * D * b + 3 * D * F * b
    int_m = 2 * S * (3 * D + 3 * F) * b
    m_fused = flop_m / tcm.SUBBLOCK_FUSED_EFFICIENCY + bnd_m * bw / \
        tcm.DECODE_MLP_FUSED_EFFICIENCY + g
    m_chain = (flop_m / tcm.SUBBLOCK_CHAIN_EFFICIENCY + (bnd_m + int_m) * bw
               / tcm.DECODE_MLP_CHAIN_EFFICIENCY + tcm.DECODE_UNFUSED_LAUNCHES_MLP * g)
    l_fused = a_fused + m_fused - g - 2 * S * D * b * bw
    for got, want in ((a_fused, 92.9), (a_chain, 142.3), (l_fused, 252.2),
                      (a_chain + m_chain, 314.2)):
        _close(got, want)
    a = tcm.attn_subblock_cost(S, D, H, KV, hd, ps, npg, b)
    m = tcm.subblock_cost(S, D, F, b, decode=True)
    lay = tcm.decode_layer_cost(a, m, S, D, ps, b)
    _close(a["est_fused_us"], a_fused)
    _close(a["est_unfused_us"], a_chain)
    _close(m["est_fused_us"], m_fused)
    _close(m["est_unfused_us"], m_chain)
    _close(lay["est_fused_us"], l_fused)
    _close(lay["est_unfused_us"], a_chain + m_chain)
    assert tcm.subblock_profitable(a) and tcm.subblock_profitable(m)
    assert lay["saved_launches"] == 1 and lay["est_saved_us"] > a["est_saved_us"]


def test_per_op_launch_counts_are_the_traced_steps():
    """``DECODE_UNFUSED_LAUNCHES_ATTN`` and ``_MLP`` are the kernels one
    layer of the traced per-op decode step runs: its bound symbols that are
    no view, per layer (the per-op step less the planned one, plus the
    planned step's one launch a layer)."""
    counts = {}
    for bf in (False, True):
        run, decode, _ = _card_runner(bf)
        trc = run.decode_jit.compile(*decode).traces[-2]
        counts[bf] = sum(1 for b in trc.bound_symbols
                         if not (b.sym.executor is None and b.sym.id in MAY_ALIAS)
                         and b.sym.name not in ("python_return", "python_del"))
    per_layer = (counts[False] - counts[True]) / CARD_LAYERS + 1
    assert per_layer == tcm.DECODE_UNFUSED_LAUNCHES_ATTN + tcm.DECODE_UNFUSED_LAUNCHES_MLP


# ---------------------------------------------------------------------------
# the replay's rules that need no card
# ---------------------------------------------------------------------------

def test_which_entries_run_as_a_graph():
    """On the card an entry replays one graph; with inputs on the CPU, with
    ``whole_program_jit=False``, or with a host-sync op it runs per call,
    and the decision log says why."""
    def f(x):
        return x * 2

    def g(x):
        return x * x.sum().item()

    card = _fake((4,), torch.float32)
    cases = [(ptt.jit(f), card, "graph"),
             (ptt.jit(f, whole_program_jit=False), card, "per-call (whole_program_jit=False)"),
             (ptt.jit(f), torch.ones(4), "per-call (inputs off the card)"),
             (ptt.jit(g), card, "per-call (item)")]
    for jf, x, want in cases:
        entry = jf.compile(x)
        assert entry.whole_program == want
        assert ptt.compile_stats(jf).last_whole_program == want
        rec = [d for d in ptt.compile_stats(jf).last_decisions if d["kind"] == "whole_program"]
        assert len(rec) == 1 and rec[0]["decision"] == want.split(" ")[0]
        assert (entry.graph is not None) == (want == "graph")
    assert "whole_program_jit" in ptt.last_compile_options(cases[0][0])


def _graph_state(donated=frozenset({1})):
    """A WholeProgram past its capture, with CPU tensors standing in for
    its inputs: input 0 read where it lies (a weight), 1 donated, 2 copied
    into a buffer of its own (a step's tokens)."""
    stats = ptt.CompileStats()
    wp = WholeProgram(None, donated, stats, None)
    w, pool, tok = torch.ones(8), torch.zeros(8), torch.arange(3.0)
    wp.by_ref = {0, 1}
    wp.static = [w, pool, tok.clone()]
    return wp, stats, (w, pool, tok)


def test_graph_input_rules():
    """A replay copies an input of its own buffer (its bytes counted) and
    reads a weight and a donated input where they lie; a donated input at
    another address is captured again, never copied; a weight at another
    address is captured again and copied from then on."""
    wp, stats, (w, pool, tok) = _graph_state()
    new_tok = torch.arange(3.0) + 5
    assert not wp._must_recapture((w, pool, new_tok))
    wp._copy_in((w, pool, new_tok))
    assert torch.equal(wp.static[2], new_tok) and wp.static[2] is not new_tok
    assert stats.whole_program_copied_bytes == new_tok.numel() * 4
    assert wp.static[0] is w and wp.static[1] is pool
    assert wp._must_recapture((w, torch.zeros(8), new_tok))
    assert 1 in wp.by_ref                     # donated: recaptured, never copied
    assert wp._must_recapture((torch.ones(8), pool, new_tok))
    assert 0 not in wp.by_ref                 # a weight that moved: copied from now on


def test_capture_stats_in_the_summary():
    stats = ptt.CompileStats()
    stats.last_whole_program = "graph"
    stats.whole_program_captures, stats.whole_program_replays = 1, 4
    assert "whole program: graph; 1 capture(s)" in stats.summary()
