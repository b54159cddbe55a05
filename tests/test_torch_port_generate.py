"""thunder_tpu_torch's contiguous-cache inference path against the JAX
package, on the CPU: ``init_kv_cache``, ``forward_step``, ``generate`` (with
and without ``prefill_buckets``) and ``generate_fused``.

The same weights (the JAX ``init_params`` tree carried across with
``params_from_jax``) and the same numpy prompts go through
``thunder_tpu.models.llama`` and the port, both in float32 on tiny-gqa:

- greedy tokens identical (``generate`` and ``generate_fused``, batched and
  single prompts, prefill buckets, a page-crossing decode);
- ``forward_step`` logits (a prefill of T rows, then a T == 1 step) to 1e-4
  absolute and relative, the written cache rows to 1e-5 (float32 sums in
  another order);
- the sampled pick held on identical uniforms: the reference's
  ``generate(temperature=, key=)`` first token equals the port's
  ``_gumbel_pick`` on the uniforms the reference drew from its key. Sampled
  ``generate`` itself draws from a ``torch.Generator`` where the reference
  splits a threefry key (ROADMAP, "Known differences"), so its tokens are
  held for determinism, not against the reference's;
- the port's engine gives the port's ``generate`` tokens (the reference's
  oracle relation, ``tests/test_serving.py:264-267``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.serving import ServingEngine

N_LAYERS = 2


@pytest.fixture(scope="module")
def model():
    cfg = jllama.CONFIGS["tiny-gqa"]
    jparams = jllama.init_params(cfg, seed=0, scale_layers=N_LAYERS)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, tllama.CONFIGS["tiny-gqa"], jparams, tparams


def _prompts(seed, B, T, vocab=512):
    return np.random.RandomState(seed).randint(1, vocab, size=(B, T)).astype(np.int32)


@pytest.mark.parametrize("B,T,new", [(1, 7, 6), (3, 16, 5), (2, 33, 9), (1, 1, 4)])
def test_generate_greedy_identical(model, B, T, new):
    jcfg, tcfg, jparams, tparams = model
    prompt = _prompts(B * 100 + T, B, T)
    ref = np.asarray(jllama.generate(jparams, jcfg, prompt, new, n_layers=N_LAYERS))
    got = tllama.generate(tparams, tcfg, prompt, new, device="cpu")
    assert got.shape == (B, new) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("T", [5, 17, 40])
def test_generate_prefill_buckets_identical(model, T):
    """A bucketed prefill (pad rows past Tp) and the bucket-rounded cache
    length give the reference's tokens."""
    jcfg, tcfg, jparams, tparams = model
    prompt = _prompts(T, 2, T)
    buckets = (16, 32, 64)
    ref = np.asarray(jllama.generate(jparams, jcfg, prompt, 6, n_layers=N_LAYERS,
                                     prefill_buckets=buckets))
    got = tllama.generate(tparams, tcfg, prompt, 6, prefill_buckets=buckets, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("B,T,new", [(1, 7, 6), (3, 16, 1), (2, 30, 8), (2, 9, 2)])
def test_generate_fused_identical(model, B, T, new):
    jcfg, tcfg, jparams, tparams = model
    prompt = _prompts(B * 7 + T, B, T)
    ref = np.asarray(jllama.generate_fused(jparams, jcfg, prompt, new, n_layers=N_LAYERS))
    stats = {}
    got = tllama.generate_fused(tparams, tcfg, prompt, new, device="cpu", stats=stats)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), tllama.generate(tparams, tcfg, prompt, new, device="cpu").numpy())
    if new > 1:
        assert stats == {"graph": False, "replays": 0}   # the CPU loop, uncaptured


def test_forward_step_logits_and_cache_match_reference(model):
    """A 12-row prefill into a 32-long cache, then one T == 1 step at
    position 12: logits and the written cache rows against the reference's
    forward_step; the unwritten rows stay zero."""
    jcfg, tcfg, jparams, tparams = model
    B, T, L = 2, 12, 32
    prompt = _prompts(3, B, T)
    step = tt.jit(lambda p, t, c, pos: jllama.forward_step(p, t, c, pos, jcfg))
    jcache = jllama.init_kv_cache(jcfg, B, L, n_layers=N_LAYERS)
    jlog, jcache = step(jparams, prompt, jcache, jnp.int32(0))
    tcache = tllama.init_kv_cache(tcfg, B, L, n_layers=N_LAYERS, device="cpu")
    tlog, _ = tllama.forward_step(tparams, torch.from_numpy(prompt), tcache, 0, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)[:, None]
    jlog2, jcache = step(jparams, nxt, jcache, jnp.int32(T))
    pos = torch.tensor(T)     # a 0-d tensor, as the captured step passes it
    tlog2, _ = tllama.forward_step(tparams, torch.from_numpy(nxt), tcache, pos, tcfg)
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), atol=1e-4, rtol=1e-4)
    for jc, tc in zip(jcache, tcache):
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5)
            assert not tc[k][:, :, T + 1:].any()


def test_forward_step_last_idx_selects_one_row(model):
    _, tcfg, _, tparams = model
    prompt = torch.from_numpy(_prompts(4, 2, 10))
    full, _ = tllama.forward_step(tparams, prompt, tllama.init_kv_cache(
        tcfg, 2, 16, n_layers=N_LAYERS, device="cpu"), 0, tcfg)
    for idx in (9, torch.tensor(4)):
        one, _ = tllama.forward_step(tparams, prompt, tllama.init_kv_cache(
            tcfg, 2, 16, n_layers=N_LAYERS, device="cpu"), 0, tcfg, last_idx=idx)
        assert one.shape == (2, 1, tcfg.vocab_size)
        torch.testing.assert_close(one[:, 0], full[:, int(idx)], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_gumbel_pick_matches_reference_on_identical_uniforms(model, temperature):
    """The reference's sampled first token (``generate(..., key=K)``: one
    split of K, its uniforms through the Gumbel pick) equals the port's
    pick on the same uniforms and the port's own last-row logits."""
    jcfg, tcfg, jparams, tparams = model
    prompt = _prompts(5, 4, 9)
    key = jax.random.PRNGKey(17)
    ref = np.asarray(jllama.generate(jparams, jcfg, prompt, 1, temperature=temperature,
                                     key=key, n_layers=N_LAYERS))
    _, sub = jax.random.split(key)
    u = np.asarray(jax.random.uniform(sub, (4, jcfg.vocab_size)))
    last, _ = tllama.forward_step(tparams, torch.from_numpy(prompt), tllama.init_kv_cache(
        tcfg, 4, 10, n_layers=N_LAYERS, device="cpu"), 0, tcfg, last_idx=8)
    got = tllama._gumbel_pick(last[:, 0], temperature, torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got.numpy(), ref[:, 0])


def test_sampled_generate_follows_its_generator(model):
    """Sampled tokens are a function of the generator's seed (the port's
    stream, not the reference's threefry split): equal for equal seeds,
    different from greedy."""
    _, tcfg, _, tparams = model
    prompt = _prompts(6, 2, 8)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tllama.generate(tparams, tcfg, prompt, 12, temperature=1.0, generator=gen,
                               device="cpu")

    a, b = run(3), run(3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    greedy = tllama.generate(tparams, tcfg, prompt, 12, device="cpu")
    assert not torch.equal(a, greedy)
    assert not torch.equal(run(4), a)


def test_generate_contract(model):
    _, tcfg, _, tparams = model
    prompt = _prompts(7, 1, 20)
    assert tllama.generate(tparams, tcfg, prompt, 0, device="cpu").shape == (1, 0)
    with pytest.raises(ValueError, match="context window"):
        tllama.generate(tparams, tcfg, prompt, 10, max_len=24, device="cpu")
    with pytest.raises(ValueError, match="exceeds the KV cache length"):
        tllama.generate(tparams, tcfg, prompt, 2, max_len=24, prefill_buckets=(8, 32),
                        device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        tllama.generate_fused(tparams, tcfg, prompt, 10, max_len=24, device="cpu")


def test_engine_tokens_equal_generate(model):
    """The port's engine (chunked prefill, page growth, continuous batching)
    gives the port's ``generate`` tokens: the reference's oracle."""
    _, tcfg, _, tparams = model
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, size=n).astype(np.int32) for n in (1, 7, 16, 33, 24)]
    eng = ServingEngine(tparams, tcfg, device="cpu", max_slots=3, page_size=16,
                        max_context=64, prefill_chunk=32)
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.drain()
    for r, p in zip(reqs, prompts):
        want = tllama.generate(tparams, tcfg, p[None], 6, device="cpu")[0].numpy()
        np.testing.assert_array_equal(r.output(), want)


def test_entry_points_refuse_missing_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tparams = model
    for fn in (tllama.generate, tllama.generate_fused):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(tparams, tcfg, _prompts(8, 1, 4), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_bmm_f32_off_the_card(dtype):
    """The cache attention's float32 scores: float32 operands multiply as
    they are, 16-bit ones off the card are taken to float32 (a product of
    two 16-bit values is exact in float32), so the result equals the
    float32 bmm of the same values exactly."""
    from thunder_tpu_torch.ops import nn as tnn

    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 16, generator=g).to(dtype)
    b = torch.randn(3, 16, 7, generator=g).to(dtype)
    got = tnn.bmm_f32(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), b.float()))


def test_generate_benchmark_on_cpu():
    """``benchmarks/generate.py`` on tiny-gqa on the CPU: both functions'
    tokens agree, every timing is positive, and the graph's numbers, which
    only the card has, are None."""
    from thunder_tpu_torch.benchmarks import generate as bench_generate

    out = bench_generate.run("tiny-gqa", layers=1, batch=2, prompt_len=8, decode=3,
                             max_len=16, repeats=1, device="cpu")
    assert out["tokens_identical"] and out["layers"] == 1 and out["device"] == "cpu"
    for k in ("prefill_ms", "generate_ms", "generate_fused_ms"):
        assert out[k] > 0
    for k in ("generate_fused_replay_ms", "generate_fused_replay_tok_per_s",
              "eager_step_host_ms", "replay_host_ms", "profile"):
        assert out[k] is None
