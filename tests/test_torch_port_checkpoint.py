"""thunder_tpu_torch's checkpoints, gradient clipping and resumable training
from a token file, against the JAX package, on the CPU.

- ``checkpoint.py``: round trips in sync and async form of bf16, float32,
  int and numpy leaves with scalars (mirroring ``tests/test_tooling.py:42``
  and ``tests/test_elastic.py:131``), the one-writer-per-path rules, a
  failed save reaching every joiner, a torn write never loaded, and an AdamW
  state saved in one layout loading into the other through
  ``optim.adapt_opt_state``. The reference's file format (orbax, or a
  pickled JAX tree) is not the port's, so the reference is held to the
  values: the same state saved and loaded by each package compares equal.
- ``optim.clip_grad_norm`` against ``thunder_tpu.optim.clip_grad_norm``
  (inside ``tt.jit``) and ``torch.nn.utils.clip_grad_norm_``, above and
  below the threshold and with mixed dtypes (the reference's cases,
  ``tests/test_sentinel.py:544,561``). Norms 1e-6 relative (float32 sums in
  another order); clipped float32 grads 1e-6; float16 ones to one float16
  rounding step.
- ``pretrain.run(data=..., start_step=...)``: a 2-layer float32 tiny-gqa run
  fed by the port's stream against the reference's ``train_step`` fed by
  the reference's stream (its Pallas claims in interpret mode), straight
  through and resumed from a checkpoint (mirroring
  ``tests/test_tooling.py:58``). Tolerances as
  ``tests/test_torch_port_training.py``'s: losses 1e-5 relative, parameters
  0.2 lr after the AdamW steps; the port's resumed run equals its straight
  run bit for bit.
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax

import thunder_tpu as tt
from thunder_tpu.checkpoint import load_checkpoint as jload_checkpoint
from thunder_tpu.checkpoint import save_checkpoint as jsave_checkpoint
from thunder_tpu import data as jdata
from thunder_tpu.models import llama as jllama
from thunder_tpu.optim import AdamW as JAdamW
from thunder_tpu.optim import clip_grad_norm as jclip
from thunder_tpu_torch import checkpoint, data
from thunder_tpu_torch.benchmarks import pretrain
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.optim import AdamW, adapt_opt_state, clip_grad_norm, tree_leaves

LR = 1e-3


def _state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g),
            "layers": [torch.randn(5, generator=g).to(torch.bfloat16),
                       torch.arange(6, dtype=torch.int32).reshape(2, 3)],
            "opt": {"step": torch.tensor(3.0), "count": 7, "name": "adamw", "none": None},
            "pair": (np.arange(4, dtype=np.int64), np.float32(2.5))}


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


# ---------------------------------------------------------------------------
# checkpoint.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
def test_checkpoint_round_trip(tmp_path, asynchronous):
    state = _state()
    path = str(tmp_path / "ck")
    assert checkpoint.save_checkpoint(path, state, asynchronous=asynchronous) == asynchronous
    if asynchronous:
        checkpoint.wait_for_checkpoints()
    assert sorted(os.listdir(path)) == [checkpoint.LEAVES, checkpoint.TREE]
    _same(state, checkpoint.load_checkpoint(path))


def test_checkpoint_values_match_reference(tmp_path):
    """The reference's round trip of ``tests/test_tooling.py:42`` and the
    port's give the same values."""
    state = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
             "opt": {"step": np.asarray(3.0, np.float32)},
             "layers": [np.ones((2,), np.float32), np.zeros((2,), np.float32)]}
    jsave_checkpoint(str(tmp_path / "ref"), state)
    ref = jload_checkpoint(str(tmp_path / "ref"), template=state)
    tstate = {"w": torch.from_numpy(state["w"]), "opt": {"step": torch.tensor(3.0)},
              "layers": [torch.from_numpy(a) for a in state["layers"]]}
    checkpoint.save_checkpoint(str(tmp_path / "port"), tstate)
    got = checkpoint.load_checkpoint(str(tmp_path / "port"), template=tstate)
    for a, b in zip(jax.tree_util.tree_leaves(ref), tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_async_save_copies_before_returning(tmp_path):
    """An asynchronous save has its tensors on the host when it returns: an
    in-place update after the call does not reach the checkpoint; a load
    joins the in-flight write (``tests/test_elastic.py:131``)."""
    state = {"w": torch.arange(100, dtype=torch.float32), "step": torch.tensor(3)}
    path = str(tmp_path / "ck")
    assert checkpoint.save_checkpoint(path, state, asynchronous=True)
    state["w"].add_(1.0)
    back = checkpoint.load_checkpoint(path, template=state)   # implicit join
    assert torch.equal(back["w"], torch.arange(100, dtype=torch.float32))
    assert int(back["step"]) == 3


def test_template_casts_moves_and_checks(tmp_path):
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, {"a": torch.ones(4), "b": [torch.zeros(2)]})
    back = checkpoint.load_checkpoint(path, template={"a": torch.zeros(4, dtype=torch.bfloat16),
                                                      "b": [torch.zeros(2)]})
    assert back["a"].dtype == torch.bfloat16 and torch.equal(back["a"].float(), torch.ones(4))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_checkpoint(path, template={"a": torch.zeros(5), "b": [torch.zeros(2)]})
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.load_checkpoint(path, template={"a": torch.zeros(4)})


def test_resave_replaces_and_leaves_no_temporaries(tmp_path):
    path = str(tmp_path / "ck")
    for v in range(3):
        checkpoint.save_checkpoint(path, {"v": torch.tensor(v)}, asynchronous=bool(v % 2))
    assert int(checkpoint.load_checkpoint(path)["v"]) == 2
    assert os.listdir(tmp_path) == ["ck"]


def test_torn_write_is_never_loaded(tmp_path, monkeypatch):
    """A write that fails midway leaves the last committed checkpoint as it
    was (and no new directory where there was none)."""
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, {"v": torch.tensor(1)})
    real = torch.save

    def torn(obj, f):
        real(obj, f)
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(path, {"v": torch.tensor(2)})
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(str(tmp_path / "fresh"), {"v": torch.tensor(2)})
    assert int(checkpoint.load_checkpoint(path)["v"]) == 1
    assert os.listdir(tmp_path) == ["ck"]


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failed_async_save_reaches_every_joiner(tmp_path, monkeypatch):
    """The writer thread's failure reaches every joiner (the thread itself
    re-raises it, which pytest reports as an unhandled thread exception)."""
    gate = threading.Event()
    real = torch.save

    def failing(obj, f):
        gate.wait(5)
        raise OSError("device lost")

    monkeypatch.setattr(torch, "save", failing)
    path = str(tmp_path / "ck")
    assert checkpoint.save_checkpoint(path, {"v": torch.tensor(1)}, asynchronous=True)
    errors = []

    def join():
        try:
            checkpoint.wait_for_checkpoints(path)
        except RuntimeError as e:
            errors.append(e)

    joiners = [threading.Thread(target=join) for _ in range(3)]
    for t in joiners:
        t.start()
    gate.set()
    for t in joiners:
        t.join(10)
    assert len(errors) == 3 and all("device lost" in str(e) for e in errors)
    monkeypatch.setattr(torch, "save", real)
    checkpoint.wait_for_checkpoints()   # the failure was collected: nothing left in flight
    assert not os.path.exists(path)


def test_one_writer_per_path_and_bounded_backlog(tmp_path, monkeypatch):
    """Saves of one path run one after another, in call order; at most
    four asynchronous saves are in flight."""
    order, live, peak = [], [0], [0]
    lock = threading.Lock()
    real = torch.save

    def slow(obj, f):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        threading.Event().wait(0.05)
        order.append(int(obj[0]))
        real(obj, f)
        with lock:
            live[0] -= 1

    monkeypatch.setattr(torch, "save", slow)
    path = str(tmp_path / "same")
    for v in range(3):
        checkpoint.save_checkpoint(path, {"v": torch.tensor(v)}, asynchronous=True)
    checkpoint.wait_for_checkpoints()
    assert order == [0, 1, 2] and int(checkpoint.load_checkpoint(path)["v"]) == 2
    peak[0] = 0
    for i in range(8):
        checkpoint.save_checkpoint(str(tmp_path / f"p{i}"), {"v": torch.tensor(i)},
                                   asynchronous=True)
        assert len(checkpoint._inflight) <= 4
    checkpoint.wait_for_checkpoints()
    assert peak[0] <= 4 and not checkpoint._inflight
    for i in range(8):
        assert int(checkpoint.load_checkpoint(str(tmp_path / f"p{i}"))["v"]) == i


def test_unsupported_leaves_raise(tmp_path):
    with pytest.raises(TypeError, match="cannot save"):
        checkpoint.save_checkpoint(str(tmp_path / "a"), {"f": object()})
    with pytest.raises(TypeError, match="strings"):
        checkpoint.save_checkpoint(str(tmp_path / "b"), {1: torch.zeros(1)})
    assert not checkpoint._inflight


@pytest.mark.parametrize("src_slab", [False, True], ids=["per-step->slab", "slab->per-step"])
def test_opt_state_round_trips_across_layouts(tmp_path, src_slab):
    """An AdamW state saved in one layout loads into the other through
    ``adapt_opt_state``, and one step from it gives the same parameters as
    one step from the state it was saved from."""
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=1)
    g = torch.Generator().manual_seed(1)
    grads = [torch.randn(p.shape, generator=g) * 1e-2 for p in tree_leaves(params)]
    src, dst = AdamW(lr=LR, slab_persistent=src_slab), AdamW(lr=LR, slab_persistent=not src_slab)
    state = src.init(params)
    src.update(params, grads, state)
    path = str(tmp_path / "opt")
    checkpoint.save_checkpoint(path, {"opt": state}, asynchronous=True)
    loaded = adapt_opt_state(checkpoint.load_checkpoint(path)["opt"], params=params, opt=dst)
    p_src = [p.clone() for p in tree_leaves(params)]
    p_dst = tllama.init_params(cfg, seed=0, device="cpu", n_layers=1)
    for a, b in zip(tree_leaves(p_dst), p_src):
        a.copy_(b)
    src.update(params, grads, state)
    dst.update(p_dst, grads, loaded)
    for a, b in zip(tree_leaves(params), tree_leaves(p_dst)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# optim.clip_grad_norm
# ---------------------------------------------------------------------------

def _jclipped(grads, max_norm):
    clipped, norm = tt.jit(lambda g: jclip(g, max_norm))(grads)
    return jax.tree.map(np.asarray, clipped), float(np.asarray(norm))


@pytest.mark.parametrize("max_norm", [1.0, 1e6], ids=["clipped", "below"])
def test_clip_grad_norm_matches_reference_and_torch(max_norm):
    """The reference's first case (``test_sentinel.py:544``: grads 2 a x of
    a linspace) and the same above and below the threshold, against the
    reference and ``torch.nn.utils.clip_grad_norm_``."""
    a = np.linspace(-2, 3, 16).astype(np.float32)
    rng = np.random.RandomState(0)
    grads = {"a": 2 * a * 2.0, "b": [rng.randn(3, 5).astype(np.float32)]}
    ref, ref_norm = _jclipped(grads, max_norm)
    tgrads = {"a": torch.from_numpy(grads["a"]), "b": [torch.from_numpy(grads["b"][0])]}
    clipped, norm = clip_grad_norm(tgrads, max_norm)
    assert norm.dtype == torch.float32 and norm.shape == ()
    assert float(norm) == pytest.approx(ref_norm, rel=1e-6)
    n_ref = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                              for g in (grads["a"], grads["b"][0]))))
    assert float(norm) == pytest.approx(n_ref, rel=1e-6)
    copies = [torch.nn.Parameter(torch.zeros_like(t)) for t in tree_leaves(tgrads)]
    for p, t in zip(copies, tree_leaves(tgrads)):
        p.grad = t.clone()
    torch_norm = torch.nn.utils.clip_grad_norm_(copies, max_norm)
    assert float(torch_norm) == pytest.approx(n_ref, rel=1e-6)
    for mine, r, p in zip(tree_leaves(clipped), jax.tree_util.tree_leaves(ref), copies):
        np.testing.assert_allclose(mine.numpy(), r, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(mine.numpy(), p.grad.numpy(), rtol=1e-6, atol=1e-7)
    if max_norm > n_ref:
        for mine, t in zip(tree_leaves(clipped), tree_leaves(tgrads)):
            assert torch.equal(mine, t)


@pytest.mark.parametrize("max_norm", [1e6, 2.0], ids=["below", "clipped"])
def test_clip_grad_norm_mixed_dtypes_match_reference(max_norm):
    """The reference's mixed-dtype case (``test_sentinel.py:561``: a float32
    and a float16 leaf): dtypes kept, the norm accumulated in float32, the
    float16 leaf within one rounding step of the reference's."""
    grads = {"a": np.full((4,), 3.0, np.float32),
             "b": np.linspace(0.5, 1.5, 4).astype(np.float16)}
    ref, ref_norm = _jclipped(grads, max_norm)
    clipped, norm = clip_grad_norm({k: torch.from_numpy(v) for k, v in grads.items()},
                                   max_norm)
    assert clipped["a"].dtype == torch.float32 and clipped["b"].dtype == torch.float16
    assert float(norm) == pytest.approx(ref_norm, rel=1e-6)
    np.testing.assert_allclose(clipped["a"].numpy(), ref["a"], rtol=1e-6)
    np.testing.assert_allclose(clipped["b"].numpy().astype(np.float32),
                               ref["b"].astype(np.float32), rtol=2.0 ** -10, atol=0)


def test_clip_grad_norm_passes_other_leaves_and_refuses_no_floats():
    clipped, norm = clip_grad_norm({"g": torch.ones(4), "i": torch.arange(3), "n": None}, 1.0)
    assert torch.equal(clipped["i"], torch.arange(3)) and clipped["n"] is None
    assert float(norm) == pytest.approx(2.0) and torch.allclose(clipped["g"], torch.full((4,), 0.5))
    with pytest.raises(ValueError, match="no floating"):
        clip_grad_norm({"i": torch.arange(3)}, 1.0)


# ---------------------------------------------------------------------------
# pretrain from a token file, straight through and resumed, against the reference
# ---------------------------------------------------------------------------

N_LAYERS, BATCH, SEQ, DATA_SEED = 2, 2, 64, 11


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "tokens.bin")
    # ids above tiny-gqa's vocabulary too: both packages clip them to vocab - 1
    data.write_token_file(path, np.random.RandomState(5).randint(0, 300, 20000))
    return path


@pytest.fixture(scope="module")
def reference_run(token_file):
    """The reference's per-op train step (``pretrain.py``'s ``train_step``,
    Pallas claims in interpret mode) fed by the reference's stream: the
    losses of batches 0..3 and the final parameters."""
    mp = pytest.MonkeyPatch()
    mp.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")
    try:
        cfg = jllama.CONFIGS["tiny-gqa"]
        params = jllama.init_params(cfg, seed=0, scale_layers=N_LAYERS)
        opt = JAdamW(lr=LR)
        state = opt.init(params)
        stream = jdata.ShardedTokenStream(token_file, batch=BATCH, seq=SEQ, seed=DATA_SEED)

        def train_step(params, opt_state, tokens, targets):
            loss, grads = tt.value_and_grad(
                lambda p: jllama.loss_fn(p, tokens, targets, cfg))(params)
            return loss, *opt.update(params, grads, opt_state)

        jstep = tt.jit(train_step, block_fusion=False)
        losses = []
        for step in range(4):
            t, g = stream.batch_at(step)
            loss, params, state = jstep(params, state, np.clip(t, 0, cfg.vocab_size - 1),
                                        np.clip(g, 0, cfg.vocab_size - 1))
            losses.append(float(loss))
        init = jllama.init_params(cfg, seed=0, scale_layers=N_LAYERS)
        return {"losses": losses, "params": params, "init": jax.tree.map(np.asarray, init)}
    finally:
        mp.undo()


def _port_params(reference_run):
    return tllama.params_from_jax(reference_run["init"], device="cpu")


def _run(params, opt, state, token_file, **kw):
    return pretrain.run("tiny-gqa", layers=N_LAYERS, batch=BATCH, seq=SEQ, lr=LR, device="cpu",
                        params=params, opt=opt, state=state, data=token_file,
                        data_seed=DATA_SEED, **kw)


def test_pretrain_from_a_token_file_matches_reference(reference_run, token_file, capsys):
    params = _port_params(reference_run)
    opt = AdamW(lr=LR)
    out = _run(params, opt, opt.init(params), token_file, steps=3, audit=True)
    assert out["stream_path"] == "native" and out["data"] == token_file
    assert out["compiled"]   # jit(train_step, donate_argnums=(0, 1)), as the reference
    assert [s["batch"] for s in out["per_step"]] == [1, 2, 3]
    np.testing.assert_allclose(out["losses"], reference_run["losses"], rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(reference_run["params"]), tree_leaves(params)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)
    audit = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("step ")]
    assert audit == [f"step {k} loss {x:.6f}" for k, x in zip((1, 2, 3), out["losses"][1:])]


@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
def test_pretrain_resumed_from_a_checkpoint_matches_straight_run(reference_run, token_file,
                                                                 tmp_path, asynchronous):
    """2 steps, a checkpoint of parameters and AdamW state, every tensor
    dropped, a load, and 2 steps from ``start_step=2``: the same losses and
    parameters as 4 steps straight through, bit for bit, and the
    reference's losses and parameters to its tolerances."""
    params = _port_params(reference_run)
    opt = AdamW(lr=LR)
    straight = _run(params, opt, opt.init(params), token_file, steps=3)
    want = [p.detach().clone() for p in tree_leaves(params)]

    params = _port_params(reference_run)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    first = _run(params, opt, state, token_file, steps=1)
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, {"params": params, "opt": state},
                               asynchronous=asynchronous)
    del params, state
    loaded = checkpoint.load_checkpoint(path)
    second = _run(loaded["params"], AdamW(lr=LR), loaded["opt"], token_file, steps=1,
                  start_step=2)
    assert [s["batch"] for s in first["per_step"] + second["per_step"]] == [1, 3]
    assert first["losses"] + second["losses"] == straight["losses"]
    for a, b in zip(tree_leaves(loaded["params"]), want):
        assert torch.equal(a.detach(), b)
    np.testing.assert_allclose(first["losses"] + second["losses"], reference_run["losses"],
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(reference_run["params"]),
                    tree_leaves(loaded["params"])):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=0.2 * LR, rtol=0)


def test_pretrain_without_data_keeps_the_synthetic_batch():
    a = pretrain.run("tiny-gqa", layers=1, batch=2, seq=16, steps=2, lr=LR, device="cpu")
    b = pretrain.run("tiny-gqa", layers=1, batch=2, seq=16, steps=2, lr=LR, device="cpu",
                     start_step=7)
    assert a["losses"] == b["losses"] and a["stream_path"] is None


def test_pretrain_cli_streams_from_a_token_file_deterministically(token_file):
    """Two separate ``pretrain`` processes streaming the same file print
    identical per-step losses (``--audit``), numbered from ``--start-step``
    as the reference numbers them (``tests/test_data.py``'s CLI test)."""
    import subprocess
    import sys

    def run(extra):
        r = subprocess.run(
            [sys.executable, "-m", "thunder_tpu_torch.benchmarks.pretrain", "--model",
             "tiny-gqa", "--layers", "1", "--batch", "2", "--seq", "16", "--steps", "3",
             "--device", "cpu", "--data", token_file, "--data-seed", "2", "--audit", *extra],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert r.returncode == 0, r.stderr[-2000:]
        return [ln for ln in r.stderr.splitlines() if ln.startswith("step ")]

    a, b = run([]), run([])
    assert a == b and [ln.split()[1] for ln in a] == ["1", "2", "3"]
    assert [ln.split()[1] for ln in run(["--start-step", "5"])] == ["6", "7", "8"]
