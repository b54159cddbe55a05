"""thunder_tpu_torch's copy-on-write allocator, prefix cache and best-of-N
forks against the JAX package, on the CPU.

The cases of ``tests/test_prefix_cache.py`` and of ``tests/test_serving.py``'s
``TestPagedKVCache`` run through both packages on the same call sequences,
and each compares what the port observes with what the reference observes:

- the allocator (``PagedKVCache``): page ids handed out, refcounts, free and
  parked counts, peaks, ``cow_copies``, the errors raised, and after a fork
  the pools' bytes (the tail copy);
- the trie (``PrefixCache``): lookups, donations, evictions and the
  ``serving.cache_evictions`` counter;
- a randomized alloc/fork/free/donate soak, drawn by hypothesis and by the
  reference's own seeded sequence, run on both allocators in lockstep:
  refcounts, free and parked pages equal after every operation, the
  invariants of the reference's property held on both, and a quiescent
  teardown;
- the engines (tiny-gqa float32, the reference at its per-op rung):
  identical tokens for warm prefix hits, best-of-N (against independent
  requests with ``sampling.fork(i)``), eviction under page pressure,
  page-aligned donation, clones spilled to a bounded queue, clones behind a
  higher-priority request, and a crash with live forks under the
  supervisor; equal hit counts, prefill chunks, ``cow_copies``, pages
  allocated, and ``describe_state`` with the engine id masked.

Both packages' fault plans, quarantines, registries and flight rings are
reset around every test.
"""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from thunder_tpu import observe as jobserve
from thunder_tpu.models import llama as jllama
from thunder_tpu.runtime import faults as jfaults
from thunder_tpu.runtime import quarantine as jquarantine
from thunder_tpu.serving import EngineSupervisor as JSupervisor
from thunder_tpu.serving import OutOfPages as JOutOfPages
from thunder_tpu.serving import PagedKVCache as JPagedKVCache
from thunder_tpu.serving import PageGeometry as JPageGeometry
from thunder_tpu.serving import PrefixCache as JPrefixCache
from thunder_tpu.serving import SamplingParams as JSamplingParams
from thunder_tpu.serving import ServingEngine as JServingEngine
from thunder_tpu_torch import observe
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.runtime import faults, quarantine
from thunder_tpu_torch.serving import (
    AdmissionRejected,
    EngineSupervisor,
    OutOfPages,
    PagedKVCache,
    PageGeometry,
    PrefixCache,
    SamplingParams,
    ServingEngine,
    content_key,
    page_chunks,
)
from thunder_tpu_torch.serving import prefix_cache as tprefix

N_LAYERS = 2


def _clean():
    for obs, flt, qu in ((jobserve, jfaults, jquarantine), (observe, faults, quarantine)):
        flt.clear()
        qu.reset()
        obs.disable()
        obs.reset()
        obs.flight.clear()


@pytest.fixture(autouse=True)
def _clean_runtime():
    _clean()
    yield
    _clean()


def _geometry(**kw):
    g = dict(n_layers=1, kv_heads=2, head_dim=16, page_size=8, num_pages=16,
             pages_per_request=6)
    g.update(kw)
    return g


PKGS = {
    "ref": SimpleNamespace(
        cache=lambda **kw: JPagedKVCache(JPageGeometry(**_geometry(**kw)), jnp.float32),
        trie=JPrefixCache, OutOfPages=JOutOfPages, observe=jobserve,
        pool=lambda a: np.asarray(a)),
    "port": SimpleNamespace(
        cache=lambda **kw: PagedKVCache(PageGeometry(**_geometry(**kw)), torch.float32, "cpu"),
        trie=PrefixCache, OutOfPages=OutOfPages, observe=observe,
        pool=lambda a: a.numpy()),
}


def _both(scenario):
    """Run ``scenario(pkg)`` for both packages; their observations must be
    equal. Returns the port's."""
    ref, port = scenario(PKGS["ref"]), scenario(PKGS["port"])
    assert port == ref
    return port


def _err(fn, *args):
    """The error ``fn(*args)`` raises, as a comparable (type name, first
    words of the message), or None."""
    try:
        fn(*args)
    except (ValueError, RuntimeError, AssertionError) as e:
        name = "OutOfPages" if type(e).__name__ == "OutOfPages" else type(e).__name__
        return name, " ".join(str(e).split()[:3])
    return None


def _state(cache):
    n = cache.geometry.num_pages
    return ([cache.refcount(p) for p in range(n)], cache.pages_free, cache.cached_pages,
            cache.cow_copies, cache.pages_allocated, cache.peak_pages_used)


def _tok(*chunks):
    return np.concatenate([np.asarray(c, np.int32) for c in chunks])


# ---------------------------------------------------------------------------
# the allocator (test_serving.py TestPagedKVCache, test_prefix_cache.py
# TestRefcounts / TestParkedPages), each scenario run on both packages
# ---------------------------------------------------------------------------

def _alloc_free_reuse(P):
    cache = P.cache(num_pages=12, pages_per_request=4)
    a = cache.alloc(3)
    out = [cache.pages_total, a, cache.pages_free]
    cache.free(a)
    b = cache.alloc(11)
    out += [cache.pages_free, sorted(b)]
    cache.free(b)
    return out + [_state(cache)]


def _out_of_pages_and_peak(P):
    cache = P.cache(num_pages=12, pages_per_request=4)
    a = cache.alloc(10)
    out = [_err(cache.alloc, 2), cache.peak_pages_used]
    cache.free(a)
    out.append(cache.peak_pages_used)
    cache.reset_peak()
    return out + [cache.peak_pages_used, cache.utilization()]


def _double_free_and_bad_page(P):
    cache = P.cache()
    a = cache.alloc(2)
    out = [_err(cache.free, a + a)]
    cache.free(a)
    return out + [_err(cache.free, [a[0]]), _err(cache.retain, [a[0]]),
                  _err(cache.free, [0]), _err(cache.retain, [0]), _state(cache)]


def _quiescence_audit(P):
    cache = P.cache(num_pages=12, pages_per_request=4)
    out = [_err(cache.assert_quiescent)]
    held = cache.alloc(2)
    cache.retain([held[0]])
    out.append(_err(cache.assert_quiescent))
    cache.free(held)
    cache.free([held[0]])
    out += [_err(cache.assert_quiescent, np.zeros((3, 4), np.int32)),
            _err(cache.assert_quiescent, np.asarray([[0, 3, 0, 0]], np.int32))]
    cache._free_set.discard(cache._free[0])          # corrupt the mirror
    return out + [_err(cache.assert_quiescent)]


def _retain_free_last_reference(P):
    cache = P.cache()
    a = cache.alloc(3)
    cache.retain(a)
    out = [[cache.refcount(p) for p in a]]
    cache.free(a)
    out.append(cache.pages_free)
    cache.free(a)
    return out + [_state(cache), _err(cache.assert_quiescent)]


def _fork_partial_tail(P):
    cache = P.cache()
    pages = cache.alloc(3)
    forked = cache.fork(pages, 17)
    out = [pages, forked, _state(cache)]
    cache.free(forked)
    cache.free(pages)
    return out + [_err(cache.assert_quiescent)]


def _fork_page_aligned(P):
    cache = P.cache()
    pages = cache.alloc(2)
    forked = cache.fork(pages, 16)
    out = [forked == pages, _state(cache)]
    cache.free(forked)
    cache.free(pages)
    return out + [_err(cache.fork, [], 0)]


def _fork_atomic(P):
    cache = P.cache(num_pages=5)
    pages = cache.alloc(3)
    cache.alloc(1)
    return [_err(cache.fork, pages, 17), _state(cache), _err(cache.fork, pages[:1], 17)]


def _parks_and_reclaims(P):
    cache = P.cache()
    a = cache.alloc(2)
    cache.register_cached(a[0])
    cache.free(a)
    out = [_state(cache), _err(cache.assert_quiescent)]
    got = cache.alloc(cache.pages_total)
    out += [a[0] in got, _state(cache)]
    cache.free(got)
    return out + [_err(cache.assert_quiescent), _err(cache.register_cached, a[1]),
                  _err(cache.register_cached, 0)]


def _can_alloc_counts_parked(P):
    cache = P.cache()
    a = cache.alloc(cache.pages_total)
    for p in a[:4]:
        cache.register_cached(p)
    cache.free(a)
    return [_state(cache), cache.can_alloc(cache.pages_total),
            cache.can_alloc(cache.pages_total + 1)]


def _retain_unparks(P):
    cache = P.cache()
    [p] = cache.alloc(1)
    cache.register_cached(p)
    cache.free([p])
    out = [_state(cache)]
    cache.retain([p])
    out.append(_state(cache))
    cache.free([p])
    out.append(_state(cache))
    cache.unregister_cached(p)               # a parked page frees at once
    return out + [_state(cache), _err(cache.assert_quiescent)]


ALLOCATOR_CASES = {f.__name__.strip("_"): f for f in (
    _alloc_free_reuse, _out_of_pages_and_peak, _double_free_and_bad_page, _quiescence_audit,
    _retain_free_last_reference, _fork_partial_tail, _fork_page_aligned, _fork_atomic,
    _parks_and_reclaims, _can_alloc_counts_parked, _retain_unparks)}


@pytest.mark.parametrize("case", list(ALLOCATOR_CASES))
def test_allocator_matches_reference(case):
    _both(ALLOCATOR_CASES[case])


def test_fork_copies_the_tail_page_bytes():
    """The COW tail copy: after a fork of a 17-token context the new tail
    page holds the source tail's K/V in every layer, bit for bit, and no
    other page moved — in both packages, on the same pool contents."""
    g = _geometry(n_layers=3)
    rng = np.random.RandomState(0)
    shape = (g["kv_heads"], g["num_pages"], g["page_size"], g["head_dim"])
    init = [{k: rng.rand(*shape).astype(np.float32) for k in ("k", "v")} for _ in range(3)]
    ref = PKGS["ref"].cache(n_layers=3)
    ref.pools = [{k: jnp.asarray(v) for k, v in kv.items()} for kv in init]
    port = PKGS["port"].cache(n_layers=3)
    port.pools = [{k: torch.from_numpy(v.copy()) for k, v in kv.items()} for kv in init]
    results = []
    for cache, pool in ((ref, PKGS["ref"].pool), (port, PKGS["port"].pool)):
        pages = cache.alloc(3)
        forked = cache.fork(pages, 17)
        results.append((forked, [{k: pool(v) for k, v in kv.items()} for kv in cache.pools]))
    assert results[0][0] == results[1][0]
    tail, src = results[1][0][2], 3
    for (rkv, pkv, kv0) in zip(results[0][1], results[1][1], init):
        for k in ("k", "v"):
            np.testing.assert_array_equal(pkv[k], rkv[k])
            np.testing.assert_array_equal(pkv[k][:, tail], kv0[k][:, src])
            others = [p for p in range(g["num_pages"]) if p != tail]
            np.testing.assert_array_equal(pkv[k][:, others], kv0[k][:, others])


def test_copy_page_reads_no_host_index():
    """``copy_page`` builds its destination index on the pools' device (a
    fill, no host-to-device copy) and copies in place."""
    cache = PKGS["port"].cache()
    before = [v.data_ptr() for kv in cache.pools for v in kv.values()]
    cache.pools[0]["k"][:, 5] = 1.0
    cache.copy_page(5, 9)
    assert torch.equal(cache.pools[0]["k"][:, 9], cache.pools[0]["k"][:, 5])
    assert [v.data_ptr() for kv in cache.pools for v in kv.values()] == before


def test_pools_alive_detects_consumed_pools():
    """The port's consumed-pool state (the reference deletes donated
    buffers; the port drops the tensors)."""
    cache = PKGS["port"].cache(n_layers=2)
    assert cache.pools_alive()
    cache.pools[1]["v"] = None
    assert not cache.pools_alive()
    cache = PKGS["port"].cache(n_layers=2)
    cache.consume_pools()
    assert not cache.pools_alive()
    with pytest.raises(RuntimeError, match="consumed"):
        cache.copy_page(1, 2)


def test_pool_shapes_and_geometry():
    g = PageGeometry(**_geometry(n_layers=3, num_pages=12, pages_per_request=4))
    cache = PagedKVCache(g, torch.bfloat16, "cpu")
    assert len(cache.pools) == 3
    assert cache.pools[0]["k"].shape == (2, 12, 8, 16)
    assert cache.pools[0]["v"].dtype == torch.bfloat16
    assert g.pages_for(1) == 1 and g.pages_for(8) == 1
    assert g.pages_for(9) == 2 and g.max_context == 32


# ---------------------------------------------------------------------------
# the trie (test_prefix_cache.py TestPrefixTrie)
# ---------------------------------------------------------------------------

def _roundtrip(P):
    cache = P.cache(page_size=4)
    trie = P.trie(cache)
    pages = cache.alloc(3)
    tokens = _tok(range(10))
    out = [trie.donate(tokens, pages)]
    cache.free(pages)
    return out + [cache.cached_pages, trie.lookup(tokens), trie.lookup(_tok(range(8))),
                  trie.lookup(_tok(range(4), [9, 9, 9, 9], range(4))),
                  trie.lookup(_tok([5, 5, 5, 5, 5])), trie.registered_pages]


def _duplicate_donor(P):
    cache = P.cache(page_size=4)
    trie = P.trie(cache)
    a, b = cache.alloc(2), cache.alloc(2)
    tokens = _tok(range(9))
    out = [trie.donate(tokens, a), trie.donate(tokens, b)]
    cache.free(a)
    cache.free(b)
    return out + [_state(cache), trie.lookup(tokens)]


def _eviction_drops_subtree(P):
    cache = P.cache(page_size=4, num_pages=8)
    trie = P.trie(cache)
    chain = cache.alloc(3)
    trie.donate(_tok(range(12), [1]), chain)
    cache.free(chain)
    out = [cache.cached_pages]
    P.observe.enable(clear=True)
    try:
        got = cache.alloc(6)
        snap = P.observe.snapshot()
    finally:
        P.observe.disable()
    out += [len(got), snap["counters"]["serving.cache_evictions"],
            [(e["kind"], e["pages"], e["trigger_page"]) for e in snap["events"]],
            trie.lookup(_tok(range(12), [1])), trie.registered_pages]
    cache.free(got)
    return out + [_err(cache.assert_quiescent)]


def _live_hit_pins_chain(P):
    cache = P.cache(page_size=4, num_pages=8)
    trie = P.trie(cache)
    chain = cache.alloc(2)
    trie.donate(_tok(range(8), [1]), chain)
    cache.free(chain)
    hit = trie.probe(_tok(range(8), [2, 3]))
    got = cache.alloc(5)
    out = [hit == chain, _err(cache.alloc, 1), trie.lookup(_tok(range(8), [9])) == chain,
           trie.hit_rate()]
    cache.free(hit)
    cache.free(got)
    trie.clear()
    return out + [_state(cache), trie.lookup(_tok(range(8), [9])), trie.hit_rate()]


TRIE_CASES = {f.__name__.strip("_"): f for f in (
    _roundtrip, _duplicate_donor, _eviction_drops_subtree, _live_hit_pins_chain)}


@pytest.mark.parametrize("case", list(TRIE_CASES))
def test_trie_matches_reference(case):
    _both(TRIE_CASES[case])


@pytest.mark.parametrize("n", [1, 4, 7, 8, 9, 16, 17])
@pytest.mark.parametrize("ps", [4, 16])
def test_page_chunks_and_content_key_match_reference(n, ps):
    from thunder_tpu.serving import prefix_cache as jprefix

    tokens = np.arange(100, 100 + n, dtype=np.int32)
    assert page_chunks(tokens, ps) == jprefix.page_chunks(tokens, ps)
    assert content_key(tokens, ps) == jprefix.content_key(tokens, ps)
    assert content_key(tokens) == jprefix.content_key(tokens)
    assert tprefix.page_chunks is page_chunks


# ---------------------------------------------------------------------------
# the randomized soak, both allocators in lockstep
# ---------------------------------------------------------------------------

def _soak(ops):
    """Run ``ops`` — (kind, a, b) triples — on both allocators and tries in
    lockstep; after every op the refcounts, free and parked counts equal
    and the reference property's invariants hold on both."""
    pair = [(P.cache(num_pages=24, page_size=4), P) for P in PKGS.values()]
    tries = [P.trie(c) for c, P in pair]
    tables = [[], []]
    donated = 0
    for step, (kind, a, b) in enumerate(ops):
        for i, ((cache, P), trie) in enumerate(zip(pair, tries)):
            tb = tables[i]
            if kind == 0 and cache.can_alloc(3):
                n = 1 + a % 3
                if cache.can_alloc(n):
                    length = (n - 1) * 4 + 1 + b % 4
                    tb.append((cache.alloc(n), length))
            elif kind == 1 and tb:
                pages, length = tb[a % len(tb)]
                try:
                    tb.append((cache.fork(pages, length), length))
                except P.OutOfPages:
                    pass
            elif kind == 2 and tb:
                pages, _ = tb.pop(a % len(tb))
                cache.free(pages)
            elif kind == 3 and tb:
                pages, length = tb[a % len(tb)]
                trie.donate(np.arange(donated * 1000, donated * 1000 + length,
                                      dtype=np.int32), pages)
            model: dict[int, int] = {}
            for pages, _ in tb:
                for p in pages:
                    model[p] = model.get(p, 0) + 1
            for p in range(1, cache.geometry.num_pages):
                assert cache.refcount(p) == model.get(p, 0), (step, p)
            live = sum(1 for p in range(1, cache.geometry.num_pages) if cache.refcount(p))
            assert live + cache.pages_free + cache.cached_pages == cache.pages_total, step
        if kind == 3 and tables[0]:
            donated += 1
        assert _state(pair[1][0]) == _state(pair[0][0]), step
        assert tables[1] == tables[0], step
    for i, (cache, _) in enumerate(pair):
        for pages, _ in tables[i]:
            cache.free(pages)
        cache.assert_quiescent()
    assert _state(pair[1][0]) == _state(pair[0][0])


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 63), st.integers(0, 63)),
                min_size=1, max_size=120))
def test_allocator_property_random_fork_free_donate(ops):
    _soak(ops)


def test_allocator_soak_reference_sequence():
    """The reference property's own seeded sequence (300 draws of
    ``RandomState(0)``), on both allocators in lockstep."""
    rng = np.random.RandomState(0)
    _soak([(int(rng.randint(4)), int(rng.randint(64)), int(rng.randint(64)))
           for _ in range(300)])


# ---------------------------------------------------------------------------
# the engines: prefix hits, best-of-N, eviction, crash recovery
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = jllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(cfg, seed=0, scale_layers=N_LAYERS)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, tllama.CONFIGS["tiny-gqa"], jparams, tparams


def _engines(model, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = {"max_slots": 3, "page_size": 16, "max_context": 128, "prefill_chunk": 32, **kw}
    return (JServingEngine(jparams, jcfg, block_fusion=False, n_layers=N_LAYERS, **kw),
            ServingEngine(tparams, tcfg, device="cpu", **kw))


def _sp(pkg, **kw):
    return (JSamplingParams if pkg == "ref" else SamplingParams)(**kw)


def _describe(eng):
    """``describe_state`` with the engine id masked and the (process-wide)
    request ids replaced by their rank: each package counts its own."""
    d = eng.describe_state()
    d["engine_id"] = None
    ids = sorted([s["request"] for s in d["slots"]] + d["queued"])
    rank = {r: i for i, r in enumerate(ids)}
    d["slots"] = [dict(s, request=rank[s["request"]]) for s in d["slots"]]
    d["queued"] = [rank[r] for r in d["queued"]]
    # "engine not idle: resident [ids], queued [ids]" names the requests too
    d["quiescence"] = re.sub(r"\d+", lambda m: str(rank.get(int(m.group()), m.group())),
                             d["quiescence"])
    return d


def _rand(rng, n):
    return rng.randint(1, 512, size=n).astype(np.int32)


def test_warm_prefix_hits_identical(model):
    """A shared 64-token system prompt: the cold request donates, warm ones
    hit all 4 system pages, prefill one tail chunk, and match the reference
    token for token; the hit-rate and parked-page gauges agree."""
    rng = np.random.RandomState(0)
    sysp = _rand(rng, 64)
    prompts = [np.concatenate([sysp, _rand(rng, 8)]) for _ in range(4)]
    out = {}
    for pkg, eng in zip(PKGS, _engines(model, prefix_cache=True)):
        obs = PKGS[pkg].observe
        obs.enable(clear=True)
        try:
            cold = eng.submit(prompts[0], 6)
            eng.drain()
            warm = [eng.submit(p, 6) for p in prompts[1:]]
            eng.drain()
            snap = obs.snapshot()
        finally:
            obs.disable()
        reqs = [cold] + warm
        out[pkg] = ([r.output().tolist() for r in reqs], [r.prefix_hit_tokens for r in reqs],
                    [r.prefill_chunks for r in reqs], snap["gauges"]["serving.prefix_hit_rate"],
                    snap["gauges"]["serving.cached_pages"], _describe(eng))
        eng.assert_quiescent()
    assert out["port"] == out["ref"]
    assert out["port"][1] == [0, 64, 64, 64] and out["port"][2] == [3, 1, 1, 1]


def test_best_of_parity_and_page_amplification(model):
    """best_of=4 equals 4 independent requests on the forked seeds, token
    for token, in both packages; 3 tail copies; best-of-4 allocates under
    1.5x best-of-1's pages, and the 4 independent requests over 2x
    best-of-4's."""
    rng = np.random.RandomState(1)
    p = _rand(rng, 100)
    out = {}
    for pkg in PKGS:
        sp = _sp(pkg, temperature=0.9, top_k=40, seed=7)
        engs = [_engines(model, max_slots=4)[pkg == "port"] for _ in range(3)]
        prim = engs[0].submit(p, 8, sampling=sp, best_of=4)
        engs[0].drain()
        engs[1].submit(p, 8, sampling=sp)
        engs[1].drain()
        indep = [engs[2].submit(p, 8, sampling=sp.fork(i) if i else sp) for i in range(4)]
        engs[2].drain()
        for a, b in zip(prim.fork_group, indep):
            np.testing.assert_array_equal(a.output(), b.output())
        pages = [e.cache.pages_allocated for e in engs]
        assert pages[0] < 1.5 * pages[1] and pages[2] > 2 * pages[0], pages
        engs[0].assert_quiescent()
        out[pkg] = ([r.output().tolist() for r in prim.fork_group], engs[0].cache.cow_copies,
                    pages, [e.cache.peak_pages_used for e in engs], _describe(engs[0]))
    assert out["port"] == out["ref"]
    assert out["port"][1] == 3


def test_forked_tail_page_equals_the_primary_tail(model):
    """In the port's engine, the page a clone's fork copied holds the
    primary's tail page bytes at the moment of the fork."""
    _, teng = _engines(model, max_slots=4)
    copies = []
    copy_page = teng.cache.copy_page

    def recorded(src, dst):
        copy_page(src, dst)
        copies.append([(kv["k"][:, src].clone(), kv["k"][:, dst].clone(),
                        kv["v"][:, src].clone(), kv["v"][:, dst].clone())
                       for kv in teng.cache.pools])

    teng.cache.copy_page = recorded
    prim = teng.submit(_rand(np.random.RandomState(2), 40), 5,
                       sampling=SamplingParams(temperature=0.8, seed=1), best_of=3)
    teng.drain()
    assert len(copies) == 2 and all(r.done for r in prim.fork_group)
    for layers in copies:
        for ks, kd, vs, vd in layers:
            assert torch.equal(ks, kd) and torch.equal(vs, vd)
            assert ks.abs().sum() > 0            # the primary's rows were written


def test_eviction_under_pressure_keeps_live_tables_intact(model):
    rng = np.random.RandomState(2)
    prompts = [_rand(rng, 48), _rand(rng, 20), _rand(rng, 64)]
    out = {}
    for pkg, eng in zip(PKGS, _engines(model, max_slots=2, num_pages=10, prefix_cache=True)):
        obs = PKGS[pkg].observe
        obs.enable(clear=True)
        try:
            donor = eng.submit(prompts[0], 8)
            eng.drain()
            parked = eng.cache.cached_pages
            live = eng.submit(prompts[1], 8)
            big = eng.submit(prompts[2], 8)
            eng.drain()
            snap = obs.snapshot()
        finally:
            obs.disable()
        eng.assert_quiescent()
        out[pkg] = ([r.output().tolist() for r in (donor, live, big)], parked,
                    snap["counters"].get("serving.cache_evictions", 0), _describe(eng))
    assert out["port"] == out["ref"]
    assert out["port"][1] == 3 and out["port"][2] >= 1


def test_page_aligned_donation_never_caches_the_unwritten_final_row(model):
    """The reference's regression, ported as is on the port's engine (and
    its result held against the reference's): a completed request's final
    token has no K/V row, so a page-aligned work prompt donates one page
    fewer, and a longer prompt extending the donor's tokens hits exactly one
    page and still gives generate()'s tokens."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.RandomState(6)
    jeng, eng = _engines(model, prefix_cache=True)
    p = _rand(rng, 24)
    donor = eng.submit(p, 8)                 # work_prompt = 32: aligned
    eng.drain()
    assert len(donor.work_prompt) % eng.geom.page_size == 0
    assert eng.cache.cached_pages == 1       # only the page whose rows are all written
    ext = np.concatenate([p, np.asarray(donor.output(), np.int32), _rand(rng, 8)])
    ref = tllama.generate(tparams, tcfg, ext[None], 6, device="cpu")[0].numpy()
    r = eng.submit(ext, 6)
    eng.drain()
    assert r.prefix_hit_tokens == eng.geom.page_size
    np.testing.assert_array_equal(r.output(), ref)
    eng.assert_quiescent()
    jdonor = jeng.submit(p, 8)
    jeng.drain()
    jr = jeng.submit(ext, 6)
    jeng.drain()
    assert jdonor.output().tolist() == donor.output().tolist()
    assert jr.output().tolist() == r.output().tolist()
    assert jr.prefix_hit_tokens == r.prefix_hit_tokens
    assert _describe(jeng) == _describe(eng)


def test_spilled_clones_respect_the_queue_bound(model):
    rng = np.random.RandomState(5)
    p = _rand(rng, 20)
    out = {}
    for pkg, eng in zip(PKGS, _engines(model, max_slots=1, max_queue=1)):
        prim = eng.submit(p, 4, best_of=3, sampling=_sp(pkg, temperature=0.7, seed=3))
        eng.drain()
        shed = [r for r in prim.fork_group if r.failed]
        assert len(shed) == 1 and "queue is full" in str(shed[0].error)
        assert type(shed[0].error).__name__ == "AdmissionRejected"
        eng.assert_quiescent()
        out[pkg] = ([r.state for r in prim.fork_group],
                    [r.output().tolist() for r in prim.fork_group], _describe(eng))
    assert out["port"] == out["ref"]
    assert isinstance(shed[0].error, AdmissionRejected)
    assert sorted(out["port"][0]) == ["done", "done", "shed"]


def test_fork_respects_priority_ordered_slots(model):
    rng = np.random.RandomState(7)
    p, hp = _rand(rng, 20), _rand(rng, 8)
    out = {}
    for pkg, eng in zip(PKGS, _engines(model, max_slots=2)):
        prim = eng.submit(p, 10, best_of=3, sampling=_sp(pkg, temperature=0.8, seed=5))
        for _ in range(3):
            eng.step()
        mid = (sum(r.state == "decode" for r in prim.fork_group), len(prim.fork_pending),
               _describe(eng))
        high = eng.submit(hp, 4, priority=5)
        eng.drain()
        assert high.done and all(r.done for r in prim.fork_group)
        assert high.admit_seq < prim.fork_group[2].admit_seq
        eng.assert_quiescent()
        out[pkg] = (mid, [r.output().tolist() for r in prim.fork_group], high.output().tolist())
    assert out["port"] == out["ref"]
    assert out["port"][0][:2] == (2, 1)


@pytest.mark.chaos
def test_crash_with_live_forks_recovers_and_quiesces(model):
    """A ``serving:engine`` crash while best-of forks are live: every forked
    page is released through the refcounts, the supervisor's restart
    re-prefills the branches, outputs equal a fault-free run, the rebuilt
    pool is quiescent — the same in both packages."""
    rng = np.random.RandomState(3)
    p = _rand(rng, 40)
    out = {}
    for pkg in PKGS:
        sp = _sp(pkg, temperature=0.8, top_k=25, seed=11)
        clean, eng = (_engines(model, max_slots=4, prefix_cache=True)[pkg == "port"]
                      for _ in range(2))
        ref_prim = clean.submit(p, 8, sampling=sp, best_of=3)
        clean.drain()
        sup = (JSupervisor if pkg == "ref" else EngineSupervisor)(eng)
        prim = eng.submit(p, 8, sampling=sp, best_of=3)
        for _ in range(4):
            sup.step()
        live = sum(r.state == "decode" for r in prim.fork_group)
        assert live >= 2
        flt = jfaults if pkg == "ref" else faults
        with flt.active(flt.FaultPlan([flt.FaultSpec("serving:engine", max_fires=1)])):
            sup.drain()
        for r, ref in zip(prim.fork_group, ref_prim.fork_group):
            assert r.done
            np.testing.assert_array_equal(r.output(), ref.output())
        assert any(r.restarts for r in prim.fork_group)
        eng.assert_quiescent()
        out[pkg] = ([r.output().tolist() for r in prim.fork_group], live, sup.restarts,
                    [r.restarts for r in prim.fork_group], _describe(eng))
    assert out["port"] == out["ref"]


def test_best_of_contract(model):
    _, teng = _engines(model)
    with pytest.raises(ValueError, match="best_of"):
        teng.submit([1, 2, 3], 2, best_of=0)
    sp = SamplingParams(temperature=0.5, seed=9)
    assert sp.fork(2) == SamplingParams(temperature=0.5, seed=11)
    assert SamplingParams(temperature=0.5).fork(1).seed is None
    assert SamplingParams(seed=0xFFFFFFFF).fork(1).seed == 0
    assert SamplingParams().greedy and not sp.greedy
    a, b = SamplingParams(seed=3, top_k=4), JSamplingParams(seed=3, top_k=4)
    assert a.fork(5).seed == b.fork(5).seed and a.fork(5).top_k == b.fork(5).top_k
