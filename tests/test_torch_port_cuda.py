"""thunder_tpu_torch's hand-written CUDA kernels against their plain
versions, on an NVIDIA card.

Every test here is marked ``cuda`` and skips, from inside its fixture, where
no card is present: a CUDA kernel has no CPU mode. This file imports only
torch and the port, so it runs on a machine without JAX:
``python -m pytest tests/test_torch_port_cuda.py -m cuda``.

Tolerances: float32 1e-5 for the norms and paged attention and 1e-4 for
``linear_act`` (other summation orders); bf16 about one bf16 ulp for the
norms (the kernel's f32 statistics round differently in the last f32 bits,
which can move a bf16 rounding by one step) and 2e-2 for ``linear_act`` and
paged attention (bf16 inputs, f32 sums in another order). float16 is held
to bf16's bounds (its rounding step is 8x finer, so they hold with room).

gemm.cuh's two mainloops (the TMA + wgmma one for bf16 and fp16, the
cp.async + FMA one for float32) are held through the six kernels that run
on them, at ragged M, N and K, so that each operand layout pair of the
wgmma descriptors (A and B K-major; B MN-major; both MN-major) is covered,
and each launch is checked to have taken the design ``cudaex.gemm_design``
names. ROADMAP C.1's inputs (float16, a strided input, a mixed weight
dtype, head dims 8 and 192, K = 518, attn_subblock at head dim 8) each
launch a kernel and match the plain version; float64 still raises.

``sdpa_fwd``, ``sdpa_bwd``, ``rms_norm``, ``rms_norm_residual`` and
``linear_act`` hold several designs, chosen by the wrapper from dtype and
shape (``cudaex.sdpa_fwd_design``, ``cudaex.sdpa_bwd_design``,
``cudaex.rms_norm_design``, ``cudaex.rms_norm_residual_design``,
``cudaex.linear_act_path``): their tests cover
each design at ragged sizes (T and S across the 64- and 128-row tiles, T !=
S, six batch*heads; D on both sides of the norm's 16-byte rule; M across
the decode kernel's 8- and 16-row limits, N and K ragged against its tiles)
and check that the launch took the design the rule names. The attention
backward is also checked for bit-identical gradients over two calls.

Training kernels: attention output and gradients row by row, each row's
error relative to that row's own largest reference value (``row_rel_err``:
causal rows and keys late in the sequence hold small values that an error
relative to the whole tensor would not see), output 1e-5 (f32) and 2e-2
(bf16: P is rounded to bf16 before the PV product), gradients 1e-4 (f32)
and 2e-2 (bf16: P and dS are rounded to bf16 before their products); lse
1e-4; cross-entropy 1e-5
relative; AdamW 4 ULP of each stored dtype (the kernel repeats the plain
version's op order with every operation rounded on its own, so it is
expected to agree bit for bit).

MLP sub-block kernels: each output and gradient row by row (``row_rel_err``
over its last dim: out and dh per token, each weight gradient per output
row), 1e-4 in float32 (FMA products summed in another order) and 2e-2 in
bf16 (act(gate), up, the SwiGLU product, dgpre and dup round to bf16 before
the next product, where a one-step difference in the f32 sum moves them).

Decode layer and attention sub-block (one cooperative launch each): out and
the fresh k/v rows row by row, 1e-4 in float32 (products and the attention
split across blocks summed in another order) and 2e-2 in bf16 (the normed
rows, the probabilities, act(gate) and up round to bf16 before the next
product), each launch on the design ``cudaex.decode_design`` names (the
weight stream at up to 8 slots in 16-bit, FMAs otherwise). Paged attention's
split design at lengths on both sides of its chunk and a length of 0 (zeros),
bit-identical over two calls.

``rms_norm_residual`` at the decode and train shapes in bf16, fp16 and
float32, with a weight of x's dtype, a float32 weight and none, and at D =
4100 (the scalar design in 16-bit): h bit for bit, y within one (unweighted)
or two (weighted) 16-bit rounding steps, 1e-5 in float32; its check fails a
planted fault (``testing.rms_residual_fault``). The train path's pieces
that run on the card machine: the C++ token loader's build and windows, a
tiny-gqa run from a token file resumed from a checkpoint bit for bit, and
``clip_grad_norm`` against ``torch.nn.utils.clip_grad_norm_``.

The numerics guard's pieces of ``csrc/fused_adamw.cu``, on both table
layouts (per-step and slab) and every dtype mix the update takes, with a NaN
planted in a scalar tail, in the last chunk, or an inf in a moment: the
health pass against its plain twin (the non-finite counts exactly, the sum
of g*g 1e-5 relative: float32 chunk sums folded in float64 against float32
sums per tensor), two calls bit-identical, nothing stored; the gated update
bit-identical to the ungated kernel when healthy and to the state before it
when not, and within 4 ULP of its plain twin.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.testing import row_rel_err, ulp_distance

EPS = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _paged_inputs(seed, B, H, KV, hd, ps, P, npg, lengths):
    rng = np.random.RandomState(seed)
    q = (rng.rand(B, H, 1, hd) - 0.5).astype(np.float32)
    kp = (rng.rand(KV, P, ps, hd) - 0.5).astype(np.float32)
    vp = (rng.rand(KV, P, ps, hd) - 0.5).astype(np.float32)
    bt = np.zeros((B, npg), np.int32)
    perm = rng.permutation(np.arange(1, P))
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        bt[b, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    cudaex.build()
    return torch.device("cuda")


def _bf16_tol(ref):
    # about one bf16 ulp of the reference, plus a small floor near zero
    return (ref.float().abs() * 2.0 ** -7 + 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows", [8, 512])
@pytest.mark.parametrize("D", [4096, 4100, 64, 8192])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "base-off-16-bytes"])
def test_cuda_norm_kernels_match_plain(cuda_device, dtype, rows, D, offset):
    """Both norms against their plain versions at widths on both sides of
    rms_norm's vector rule (4100 16-bit values put row starts off 16 bytes;
    64 puts several rows in a block), on an aligned tensor and on a view
    whose base is off 16 bytes (the wrapper copies it to an aligned base,
    so it runs the vector design too); each rms_norm launch took the design
    ``cudaex.rms_norm_design`` names. Every output, weighted and not, is
    held to the plain version within one rounding step, but for the
    weighted outputs at 512 rows of 8192 in bf16 (below); besides, the weighted
    output must be exactly the kernel's own normalised rows times the
    weight, rounded once more."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rows_of(n):
        flat = torch.randn(offset + rows * n, generator=g, device=cuda_device).to(dtype)
        return flat[offset:].view(rows, n)

    x, r = rows_of(D), rows_of(D)
    w = (torch.rand(offset + D, generator=g, device=cuda_device) + 0.5).to(dtype)[offset:]
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    cudaex.reset_launch_counts()
    got_norm = cudaex.rms_norm(x, w, EPS)
    torch.cuda.synchronize()
    assert cudaex.design_counts()["rms_norm"] == {cudaex.rms_norm_design(dtype, D): 1}
    got_h, got_y = cudaex.rms_norm_residual(r, x, w, EPS)
    want_h, want_y = tnn.rms_norm_residual_plain(r, x, w, EPS)
    normed = cudaex.rms_norm(x, None, EPS)
    h, normed_h = cudaex.rms_norm_residual(r, x, None, EPS)
    # A kernel sums the squares in another order than the plain version, so
    # a normalised value can round one step apart (held to one step below);
    # the weight, up to 1.5, and the second rounding can carry that to two
    # steps of the weighted output. At 512 rows of 8192 in bf16 the
    # rms_norm_residual kernel reaches two steps as well, so there the
    # weighted outputs are held to two steps; everywhere else to one.
    two_steps = dtype == torch.bfloat16 and D == 8192 and rows == 512
    weighted = ((got_norm, tnn.rms_norm_plain(x, w, EPS)), (got_y, want_y))
    for got, want in (*(() if two_steps else weighted), (got_h, want_h),
                      (normed, tnn.rms_norm_plain(x, None, EPS)),
                      *zip((h, normed_h), tnn.rms_norm_residual_plain(r, x, None, EPS))):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = _bf16_tol(want) if dtype != torch.float32 else 1e-5
        assert bool((err <= tol).all()), float(err.max())
    if two_steps:
        for got, want in weighted:
            assert ulp_distance(got, want) <= 2
    assert torch.equal(got_h, h)
    assert torch.equal(got_norm, (normed.float() * w.float()).to(dtype))
    assert torch.equal(got_y, (normed_h.float() * w.float()).to(dtype))


# rows on both sides of the decode kernel's limits (8 and 16 activation rows)
# and of the tile kernel's 128-row tiles; N ragged against 16- and 128-row
# tiles; K ragged against 64-column slabs
LINEAR_ROWS = ([(torch.bfloat16, m) for m in (1, 8, 13, 16, 17, 512, 515)]
               + [(torch.float16, 8), (torch.float16, 515), (torch.float32, 33)])


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("N,K", [(200, 520), (200, 4096), (14336, 520), (14336, 4096)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("dtype,M", LINEAR_ROWS,
                         ids=[f"{str(d)[6:]}-M{m}" for d, m in LINEAR_ROWS])
def test_cuda_linear_act_matches_plain(cuda_device, act, dtype, M, N, K, with_bias):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randn(M, K, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(N, K, generator=g, device=cuda_device) / math.sqrt(K)).to(dtype)
    b = torch.randn(N, generator=g, device=cuda_device).to(dtype) if with_bias else None
    cudaex.reset_launch_counts()
    got = cudaex.linear_act(a, w, b, act)
    torch.cuda.synchronize()
    assert cudaex.design_counts()["linear_act"] == {cudaex.linear_act_design(dtype, M): 1}
    want = tnn.linear_act_plain(a, w, b, act)
    tol = 2e-2 if dtype != torch.float32 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_paged_decode_matches_plain(cuda_device, dtype):
    q, kp, vp, bt, ln = _paged_inputs(4, B=4, H=8, KV=2, hd=128, ps=16, P=12, npg=4,
                                      lengths=[1, 16, 17, 40])
    args = [_t(a).to(cuda_device) for a in (q, kp, vp)]
    args = [a.to(dtype) for a in args] + [_t(bt).to(cuda_device), _t(ln).to(cuda_device)]
    got = cudaex.paged_decode_attention(*args)
    torch.cuda.synchronize()
    want = tnn.paged_decode_attention_plain(*args)
    tol = 2e-2 if dtype != torch.float32 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# the split-context design at lengths that straddle its chunk of C keys (1,
# C - 1, C, C + 1, several chunks) and a length of 0; hd 6 and 5 take the
# scalar staging (rows off the 16-byte multiples)
PAGED_SPLIT = [(dt, G, hd) for dt in (torch.float32, torch.bfloat16, torch.float16)
               for G in (1, 4, 8) for hd in (64, 128)] + [(torch.bfloat16, 4, 6),
                                                          (torch.float32, 2, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,G,hd", PAGED_SPLIT,
                         ids=[f"{str(d)[6:]}-G{g}-hd{h}" for d, g, h in PAGED_SPLIT])
def test_cuda_paged_split_matches_plain(cuda_device, dtype, G, hd):
    """Every launch takes the split design; the live rows match the plain
    version, the empty request's rows are zeros, and two calls are
    bit-identical (the chunks merge in chunk order)."""
    KV, ps = 2, 16
    keys = cudaex.paged_chunk_keys(G, hd, torch.finfo(dtype).bits // 8)
    lengths = [1, keys - 1, keys, keys + 1, 3 * keys + 5, 0]
    npg = -(-max(lengths) // ps)
    q, kp, vp, bt, ln = _paged_inputs(11, B=len(lengths), H=G * KV, KV=KV, hd=hd, ps=ps,
                                      P=len(lengths) * npg + 1, npg=npg, lengths=lengths)
    args = [_t(a).to(cuda_device).to(dtype) for a in (q, kp, vp)]
    args += [_t(bt).to(cuda_device), _t(ln).to(cuda_device)]
    cudaex.reset_launch_counts()
    got = cudaex.paged_decode_attention(*args)
    again = cudaex.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert cudaex.design_counts()["paged_decode_attention"] == {"split": 2}
    assert torch.equal(got, again)
    want = tnn.paged_decode_attention_plain(*args)
    tol = 2e-2 if dtype != torch.float32 else 1e-5
    torch.testing.assert_close(got[:-1].float(), want[:-1].float(), atol=tol, rtol=tol)
    assert bool((got[-1] == 0).all())


@pytest.mark.cuda
def test_cuda_engine_tokens_match_cpu(cuda_device):
    """A float32 tiny-gqa engine on the card, through all four kernels,
    gives the CPU engine's greedy tokens, preemptions included."""
    from thunder_tpu_torch.models import llama
    from thunder_tpu_torch.serving import ServingEngine

    cfg = llama.CONFIGS["tiny-gqa"]
    params = llama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (1, 7, 16, 33, 24)]
    outs = {}
    cudaex.reset_launch_counts()
    for device in ("cuda", "cpu"):
        eng = ServingEngine(params, cfg, device=device, max_slots=3, page_size=8,
                            num_pages=9, max_context=64, prefill_chunk=16, block_fusion=False)
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.drain()
        eng.assert_quiescent()
        outs[device] = [r.output().tolist() for r in reqs]
    assert outs["cuda"] == outs["cpu"]
    counts = cudaex.launch_counts()
    assert all(counts[k] > 0 for k in ("rms_norm", "rms_norm_residual", "linear_act",
                                       "paged_decode_attention")), counts


# ---------------------------------------------------------------------------
# training kernels
# ---------------------------------------------------------------------------

# T and S on both sides of the 64- and 128-row tiles, T != S, causal and
# not; batch*heads 6, so a tile that read past its head's rows would read
# the next head's
ATTN_SHAPES = [(64, 64, True), (100, 100, True), (64, 130, False), (130, 64, True)] + [
    (t, s, c) for t in (100, 128, 130, 2049) for s in (100, 128, 130, 2049) for c in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,causal", ATTN_SHAPES,
                         ids=[f"T{t}-S{s}-{'causal' if c else 'full'}" for t, s, c in ATTN_SHAPES])
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 16), (torch.bfloat16, 16),
                                      (torch.bfloat16, 64), (torch.bfloat16, 128),
                                      (torch.float16, 64), (torch.float16, 128),
                                      (torch.float16, 48), (torch.bfloat16, 192),
                                      (torch.bfloat16, 256), (torch.float32, 192)])
def test_cuda_sdpa_matches_plain(cuda_device, dtype, hd, T, S, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, g = rnd(2, 3, T, hd), rnd(2, 3, S, hd), rnd(2, 3, S, hd), rnd(2, 3, T, hd)
    cudaex.reset_launch_counts()
    out, lse = cudaex.sdpa_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert cudaex.design_counts()["sdpa_fwd"] == {cudaex.sdpa_fwd_design(dtype, hd): 1}
    want_out, want_lse = tnn.sdpa_fwd_plain(q, k, v, causal)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert row_rel_err(out, want_out) <= tol
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    # the backward from the plain forward's (out, lse), so it is checked alone
    cudaex.reset_launch_counts()
    got = cudaex.sdpa_bwd(g, q, k, v, want_out, want_lse, causal)
    torch.cuda.synchronize()
    assert cudaex.design_counts()["sdpa_bwd"] == {cudaex.sdpa_bwd_design(dtype, hd): 1}
    want = tnn.sdpa_bwd_plain(g, q, k, v, want_out, want_lse, causal)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, want):
        assert row_rel_err(a, b) <= rel
    if causal and T < S:   # no q row reaches kv rows c >= T: their dk and dv are zero
        for grad in got[1:]:
            assert bool((grad[..., T:, :] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_sdpa_bwd_is_deterministic(cuda_device, dtype):
    """Two calls on the same inputs give bit-identical dq, dk and dv: every
    gradient row is written once by the block that owns it, no atomics."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, g = (torch.randn(2, 4, 1024, 128, generator=gen, device=cuda_device).to(dtype)
                  for _ in range(4))
    out, lse = cudaex.sdpa_fwd(q, k, v, True)
    cudaex.reset_launch_counts()
    first = cudaex.sdpa_bwd(g, q, k, v, out, lse, True)
    second = cudaex.sdpa_bwd(g, q, k, v, out, lse, True)
    torch.cuda.synchronize()
    assert cudaex.design_counts()["sdpa_bwd"] == {"wgmma": 2}
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("V", [32000, 1001])
def test_cuda_ce_fwd_matches_plain(cuda_device, dtype, V):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    logits = (torch.randn(37, V, generator=gen, device=cuda_device) * 4).to(dtype)
    target = torch.randint(0, V, (37,), generator=gen, device=cuda_device)
    target[[0, 5, 36]] = -100
    nll, lse = cudaex.ce_fwd(logits, target)
    torch.cuda.synchronize()
    want_nll, want_lse = tnn.ce_fwd_plain(logits, target)
    torch.testing.assert_close(nll, want_nll, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    assert float(nll[5]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype,m_dtype,g_dtype", [
    (torch.float32, torch.float32, None), (torch.bfloat16, torch.float32, None),
    (torch.bfloat16, torch.bfloat16, None), (torch.float16, torch.float32, None),
    (torch.float32, torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32, torch.float32)])
def test_cuda_fused_adamw_matches_plain(cuda_device, p_dtype, m_dtype, g_dtype):
    """Three steps with fixed gradients over a bucket of ragged sizes (a
    tensor's tail of fewer than 4 elements, several chunks): at each step
    the kernel, from the same state, matches adamw_step_plain; the grads in
    the params' dtype or (g_dtype) in one of their own."""
    from thunder_tpu_torch.ops import optim as toptim_ops

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    shapes = [(64, 64), (37,), (4097,), (3, 5000), (1,)]
    ps = [torch.randn(s, generator=gen, device=cuda_device).to(p_dtype) for s in shapes]
    gs = [torch.randn(s, generator=gen, device=cuda_device).to(g_dtype or p_dtype)
          for s in shapes]
    ms = [torch.zeros(s, device=cuda_device, dtype=m_dtype) for s in shapes]
    vs = [torch.zeros(s, device=cuda_device, dtype=torch.float32) for s in shapes]
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    for step in range(1, 4):
        bc = torch.tensor([1 - 0.9 ** step, 1 - 0.999 ** step], dtype=torch.float32,
                          device=cuda_device)
        want = [toptim_ops.adamw_step_plain(p, g, m, v, bc[0], bc[1], **hyper)
                for p, g, m, v in zip(ps, gs, ms, vs)]
        cudaex.fused_adamw(ps, gs, ms, vs, bc, **hyper)
        torch.cuda.synchronize()
        for got, w in zip(zip(ps, ms, vs), want):
            for a, b in zip(got, w):
                assert ulp_distance(a, b) <= 4
        ps = [w[0] for w in want]   # the next step starts from the plain result
        ms = [w[1].clone() for w in want]
        vs = [w[2].clone() for w in want]


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """Three float32 tiny-gqa train steps on the card (every kernel of the
    train path) and on the CPU from the same weights: losses to 1e-5
    relative, parameters to 0.2 lr (see tests/test_torch_port_training.py)."""
    from thunder_tpu_torch.benchmarks import pretrain
    from thunder_tpu_torch.models import llama
    from thunder_tpu_torch.optim import tree_leaves, tree_map

    cfg = llama.CONFIGS["tiny-gqa"]
    cpu = llama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    card = tree_map(lambda t: t.cuda(), cpu)
    cudaex.reset_launch_counts()
    a = pretrain.run("tiny-gqa", batch=2, seq=64, steps=3, lr=1e-3, device="cuda", params=card)
    b = pretrain.run("tiny-gqa", batch=2, seq=64, steps=3, lr=1e-3, device="cpu", params=cpu)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    for x, y in zip(tree_leaves(card), tree_leaves(cpu)):
        np.testing.assert_allclose(x.detach().cpu().numpy(), y.detach().numpy(), atol=2e-4)
    for step in a["per_step"]:
        assert step["launches"] == {"sdpa_fwd": 2, "sdpa_bwd": 2, "ce_fwd": 1,
                                    "fused_adamw": 1, "rms_norm": 1, "rms_norm_residual": 4}


# ---------------------------------------------------------------------------
# the planned rung: the MLP sub-block pair
# ---------------------------------------------------------------------------

def _subblock_inputs(gen, device, dtype, N, D, F):
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    return (rnd(N, D), rnd(N, D, scale=0.5), rnd(N, D, scale=0.5),
            (1.0 + 0.1 * torch.randn(D, generator=gen, device=device)).to(dtype),
            rnd(F, D, scale=D ** -0.5), rnd(F, D, scale=D ** -0.5), rnd(D, F, scale=F ** -0.5))


SUBBLOCK_SHAPES = [(torch.bfloat16, 200, 256, 512), (torch.float32, 128, 64, 176)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "relu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("dtype,N,D,F", SUBBLOCK_SHAPES,
                         ids=[f"{str(d)[6:]}-{n}x{dd}x{f}" for d, n, dd, f in SUBBLOCK_SHAPES])
def test_cuda_mlp_subblock_matches_plain(cuda_device, dtype, N, D, F, act):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    _, r, x, wn, wg, wu, wd = _subblock_inputs(gen, cuda_device, dtype, N, D, F)
    got = cudaex.mlp_subblock(r, x, wn, wg, wu, wd, act)
    torch.cuda.synchronize()
    want = tnn.mlp_subblock_plain(r, x, wn, wg, wu, wd, act)
    assert got.dtype == dtype and got.shape == want.shape
    assert row_rel_err(got, want) <= (1e-4 if dtype == torch.float32 else 2e-2)


# relu is left out of the backward's cases: its derivative jumps at 0, so a
# gate pre-activation within f32 rounding of 0 may take either mask on the
# two sides (the CPU tests hold relu against the reference with the gate
# kept away from 0)
@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("dtype,N,D,F", SUBBLOCK_SHAPES,
                         ids=[f"{str(d)[6:]}-{n}x{dd}x{f}" for d, n, dd, f in SUBBLOCK_SHAPES])
def test_cuda_mlp_subblock_bwd_matches_plain(cuda_device, dtype, N, D, F, act):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    args = _subblock_inputs(gen, cuda_device, dtype, N, D, F)
    got = cudaex.mlp_subblock_bwd(*args, act)
    torch.cuda.synchronize()
    want = tnn.mlp_subblock_bwd_plain(*args, act)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("dh", "dw_norm", "dw_gate", "dw_up", "dw_down"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert row_rel_err(a, b) <= tol, (name, row_rel_err(a, b))


@pytest.mark.cuda
def test_cuda_planned_train_step_matches_cpu(cuda_device):
    """Three float32 tiny-gqa train steps at the planned rung on the card
    (the sub-block pair, rms_norm, attention, cross-entropy, AdamW) and on
    the CPU from the same weights: losses to 1e-5 relative, parameters to
    0.2 lr (see tests/test_torch_port_training.py)."""
    from thunder_tpu_torch.benchmarks import pretrain
    from thunder_tpu_torch.models import llama
    from thunder_tpu_torch.optim import tree_leaves, tree_map

    cfg = llama.CONFIGS["tiny-gqa"]
    cpu = llama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    card = tree_map(lambda t: t.cuda(), cpu)
    kw = dict(batch=2, seq=64, steps=3, lr=1e-3, block_fusion=True)
    a = pretrain.run("tiny-gqa", device="cuda", params=card, **kw)
    b = pretrain.run("tiny-gqa", device="cpu", params=cpu, **kw)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    for x, y in zip(tree_leaves(card), tree_leaves(cpu)):
        np.testing.assert_allclose(x.detach().cpu().numpy(), y.detach().numpy(), atol=2e-4)
    for step in a["per_step"]:
        assert step["launches"] == {"sdpa_fwd": 2, "sdpa_bwd": 2, "ce_fwd": 1, "fused_adamw": 1,
                                    "rms_norm": 3, "mlp_subblock": 2, "mlp_subblock_bwd": 2}


# ---------------------------------------------------------------------------
# the serving planned rung: the whole decode layer and its attention half
# ---------------------------------------------------------------------------

# (S, D, H, KV, hd, ps, npg, F, lengths, replay slot): tiny-gqa's layer, and
# 8 slots at hd = 128 whose longer contexts split into several key chunks
DECODE_SHAPES = {
    "tiny-gqa": (4, 64, 4, 2, 16, 8, 3, 176, [9, 6, 20, 1], 2),
    "8-slot-hd128": (8, 1024, 8, 2, 128, 16, 40, 2816, [1, 17, 100, 255, 256, 400, 639, 640], 3),
    "tiny-tp-hd8": (4, 64, 8, 8, 8, 8, 3, 192, [9, 6, 20, 1], 2),
    # the stream design's slot counts and a ragged K and N (D 520: a last
    # slab of 8 columns, a last 16-row tile of 8 rows; F 1416 likewise)
    "1-slot-hd64": (1, 512, 8, 2, 64, 16, 8, 1024, [100], 0),
    "1-slot-hd128": (1, 1024, 8, 2, 128, 16, 20, 1536, [300], 0),
    "3-slot-hd64": (3, 512, 8, 2, 64, 16, 20, 1024, [1, 129, 300], 1),
    "3-slot-hd128": (3, 1024, 8, 2, 128, 16, 20, 1536, [1, 129, 300], 1),
    "8-slot-hd64-ragged": (8, 520, 8, 4, 64, 16, 20, 1416,
                           [1, 17, 100, 127, 128, 129, 250, 300], 2),
    # past the stream design's 8 rows: the FMA design in every dtype
    "9-slot-hd64": (9, 256, 4, 2, 64, 16, 6, 512, [1, 2, 3, 17, 33, 50, 64, 80, 96], 4),
    "16-slot-hd64": (16, 256, 4, 2, 64, 16, 6, 512, list(range(1, 96, 6)), 5),
}


def _decode_args(device, dtype, shape, seed):
    """The decode step's operands on the card: random pools, each slot's
    pages drawn at random, slot ``replay`` writing to the scratch position
    (its pool row at len - 1 is a random row, not its fresh row)."""
    S, D, H, KV, hd, ps, npg, F, lengths, replay = DECODE_SHAPES[shape]
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shp, scale=1.0):
        return (torch.randn(*shp, generator=gen, device=device) * scale).to(dtype)

    P = S * npg + 1
    bt = (torch.randperm(P - 1, generator=gen, device=device) + 1)
    bt = bt.reshape(S, npg).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=device)
    last = (ln.long() - 1)
    wp = bt.long().gather(1, (last // ps)[:, None])[:, 0] * ps + last % ps
    wp[replay] = 0
    ang = torch.rand(S, 1, 1, hd // 2, generator=gen, device=device) * 6.3
    args = (rnd(S, 1, D), (1 + 0.1 * torch.randn(D, generator=gen, device=device)).to(dtype),
            rnd(H * hd, D, scale=D ** -0.5), rnd(KV * hd, D, scale=D ** -0.5),
            rnd(KV * hd, D, scale=D ** -0.5), rnd(D, H * hd, scale=(H * hd) ** -0.5),
            torch.cos(ang).to(dtype), torch.sin(ang).to(dtype), rnd(KV, P, ps, hd),
            rnd(KV, P, ps, hd), bt, ln, wp)
    mlp = ((1 + 0.1 * torch.randn(D, generator=gen, device=device)).to(dtype),
           rnd(F, D, scale=D ** -0.5), rnd(F, D, scale=D ** -0.5), rnd(D, F, scale=F ** -0.5))
    return args, mlp


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(DECODE_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layer", [True, False], ids=["decode_layer", "attn_subblock"])
def test_cuda_decode_kernels_match_plain(cuda_device, layer, dtype, shape):
    """Each launch takes the design ``cudaex.decode_design`` names (the
    weight stream for 16-bit at up to 8 slots, FMAs otherwise)."""
    args, mlp = _decode_args(cuda_device, dtype, shape, seed=7)
    S, D, H, KV, hd = DECODE_SHAPES[shape][:5]
    cudaex.reset_launch_counts()
    if layer:
        got = cudaex.decode_layer(*args, *mlp, act="silu")
        want = tnn.decode_layer_plain(*args, *mlp, act="silu")
    else:
        got = cudaex.attn_subblock(*args)
        want = tnn.attn_subblock_plain(*args)
    torch.cuda.synchronize()
    design = cudaex.decode_design(dtype, S, D, H, KV, hd)
    assert design == ("stream" if dtype != torch.float32 and S <= 8 else "fma")
    name = "decode_layer" if layer else "attn_subblock"
    assert cudaex.design_counts()[name] == {design: 1}
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("out", "k_rows", "v_rows"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert row_rel_err(a, b) <= tol, (name, row_rel_err(a, b))


@pytest.mark.cuda
def test_cuda_planned_engine_tokens_match_cpu(cuda_device):
    """The float32 tiny-gqa engine at the planned rung on the card (one
    decode_layer launch per layer per step) gives the CPU engine's greedy
    tokens, preemptions included."""
    from thunder_tpu_torch.models import llama
    from thunder_tpu_torch.serving import ServingEngine

    cfg = llama.CONFIGS["tiny-gqa"]
    params = llama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (1, 7, 16, 33, 24)]
    outs = {}
    cudaex.reset_launch_counts()
    for device in ("cuda", "cpu"):
        eng = ServingEngine(params, cfg, device=device, max_slots=3, page_size=8,
                            num_pages=9, max_context=64, prefill_chunk=16, block_fusion=True)
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.drain()
        eng.assert_quiescent()
        outs[device] = [r.output().tolist() for r in reqs]
    assert outs["cuda"] == outs["cpu"]
    counts = cudaex.launch_counts()
    assert counts["decode_layer"] > 0 and counts["mlp_subblock"] > 0, counts
    assert counts["paged_decode_attention"] == counts["linear_act"] == 0, counts


# ---------------------------------------------------------------------------
# the headline train bench: the slab-persistent AdamW kernel, the refusals
# of inputs a kernel does not take, the chunked-vocab loss, the bench step
# ---------------------------------------------------------------------------

# ragged and odd sizes: after the 7- and 13-element members every slab run
# starts off the 4-element alignment, so the kernel's scalar path runs
SLAB_SIZES = [(64, 64), (7,), (13,), (4099,), (65537,), (1,), (3, 5000)]


def _slab_bucket(device, p_dtype, m_dtype, v_dtype, shapes, seed=5):
    from thunder_tpu_torch.ops import optim as toptim_ops

    gen = torch.Generator(device=device).manual_seed(seed)
    ps = [(torch.randn(s, generator=gen, device=device).sign() * 0.5
           + torch.randn(s, generator=gen, device=device)).to(p_dtype) for s in shapes]
    gs = [torch.randn(s, generator=gen, device=device).to(p_dtype) for s in shapes]
    sizes = [p.numel() for p in ps]
    rows, _ = toptim_ops.slab_geometry(sum(sizes))
    m = torch.zeros(rows, 128, dtype=m_dtype, device=device)
    v = torch.zeros(rows, 128, dtype=v_dtype, device=device)
    return ps, gs, m, v, sizes


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype,m_dtype,v_dtype", [
    (torch.float32, torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16, torch.bfloat16)])
def test_cuda_fused_adamw_slab_matches_plain_and_per_step(cuda_device, p_dtype, m_dtype, v_dtype):
    """Three steps with fixed gradients: the slab kernel, the slab plain
    version and the per-step kernel on copies of the same values. The slab
    kernel is bit-identical to the per-step kernel, within 4 ULP of the
    plain version (0 expected), and leaves the pad tail zero."""
    from thunder_tpu_torch.ops import optim as toptim_ops

    ps, gs, m, v, sizes = _slab_bucket(cuda_device, p_dtype, m_dtype, v_dtype, SLAB_SIZES)
    offs = np.cumsum([0] + sizes)
    runs = list(zip(offs, offs[1:]))
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    plain = ([p.clone() for p in ps], m.clone(), v.clone())
    step_p = [p.clone() for p in ps]
    step_m = [torch.zeros(p.shape, dtype=m_dtype, device=cuda_device) for p in ps]
    step_v = [torch.zeros(p.shape, dtype=v_dtype, device=cuda_device) for p in ps]
    for step in range(1, 4):
        bc = torch.tensor([1 - 0.9 ** step, 1 - 0.999 ** step], dtype=torch.float32,
                          device=cuda_device)
        cudaex.fused_adamw_slab(ps, gs, m, v, bc, sizes=sizes, **hyper)
        toptim_ops.fused_adamw_slab_plain(*plain[:1], gs, *plain[1:], bc, sizes=sizes, **hyper)
        cudaex.fused_adamw(step_p, gs, step_m, step_v, bc, **hyper)
        torch.cuda.synchronize()
        for a, b, c in zip(ps, plain[0], step_p):
            assert torch.equal(a, c) and ulp_distance(a, b) <= 4
        for slab, plain_slab, per in ((m, plain[1], step_m), (v, plain[2], step_v)):
            flat = slab.reshape(-1)
            assert ulp_distance(slab, plain_slab) <= 4
            assert all(torch.equal(flat[a:b], t.reshape(-1)) for (a, b), t in zip(runs, per))
            assert float(flat[offs[-1]:].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_fused_adamw_slab_past_2_31_elements(cuda_device):
    """One bf16 bucket of 2^31 + 4,103 elements (bf16 m slab, f32 v slab,
    about 22 GB in all): the runs that start past 2^31 elements of the slab
    (a misaligned 7-element one, then 4,096) and the first chunk of the
    bucket match the plain version on copies of their values, and the pad
    tail stays zero."""
    from thunder_tpu_torch.ops import optim as toptim_ops

    big = 1 << 30
    ps, gs, m, v, sizes = _slab_bucket(cuda_device, torch.bfloat16, torch.bfloat16,
                                       torch.float32, [(big,), (big,), (7,), (4096,)])
    assert sum(sizes) > 2 ** 31
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    bc = torch.tensor([0.1, 0.001], dtype=torch.float32, device=cuda_device)
    offs = np.cumsum([0] + sizes)
    checked = [(2, 0, 7), (3, 0, 4096), (0, 0, 4096)]   # (member, first, last) elements
    before = [(ps[i][a:b].clone(), gs[i][a:b].clone(),
               m.view(-1)[offs[i] + a:offs[i] + b].clone(),
               v.view(-1)[offs[i] + a:offs[i] + b].clone()) for i, a, b in checked]
    cudaex.fused_adamw_slab(ps, gs, m, v, bc, sizes=sizes, **hyper)
    torch.cuda.synchronize()
    for (i, a, b), (p0, g0, m0, v0) in zip(checked, before):
        toptim_ops.fused_adamw_slab_plain([p0], [g0], m0, v0, bc, sizes=[b - a], **hyper)
        assert torch.equal(ps[i][a:b], p0)
        assert torch.equal(m.view(-1)[offs[i] + a:offs[i] + b], m0)
        assert torch.equal(v.view(-1)[offs[i] + a:offs[i] + b], v0)
    for slab in (m, v):
        assert float(slab.view(-1)[offs[-1]:].float().abs().max()) == 0.0


# gemm.cuh's mainloops through the six kernels on them: M (the sub-block's
# rows, linear_act's rows) on both sides of the 128-row tile and the decode
# path's 16, and 16900 (enough row tiles that the forward's down projection
# takes its 256-wide tiles); D = 200 and F = 344 off the 64-deep slabs and
# the 128- and 256-wide tiles, so every product has a ragged M, N and K.
# Layout pairs: gate/up, down, recompute's gate and up and linear_act's tile
# are K-major x K-major; dy and dn are K-major x MN-major; the weight
# gradients MN-major x MN-major.
GEMM_ROWS = [1, 8, 100, 512, 515, 16900]
GEMM_KERNELS = ["mlp_subblock", "mlp_subblock_bwd", "linear_act"]


@pytest.mark.cuda
@pytest.mark.parametrize("M", GEMM_ROWS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "f32"])
@pytest.mark.parametrize("kernel", GEMM_KERNELS)
def test_cuda_gemm_mainloops_match_plain(cuda_device, kernel, dtype, M):
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    D, F = 200, 344
    g, r, x, wn, wg, wu, wd = _subblock_inputs(gen, cuda_device, dtype, M, D, F)
    cudaex.reset_launch_counts()
    if kernel == "mlp_subblock":
        got = [cudaex.mlp_subblock(r, x, wn, wg, wu, wd, "silu")]
        want = [tnn.mlp_subblock_plain(r, x, wn, wg, wu, wd, "silu")]
        design = cudaex.gemm_design(dtype)
    elif kernel == "mlp_subblock_bwd":
        got = cudaex.mlp_subblock_bwd(g, r, x, wn, wg, wu, wd, "silu")
        want = tnn.mlp_subblock_bwd_plain(g, r, x, wn, wg, wu, wd, "silu")
        design = cudaex.gemm_design(dtype)
    else:
        b = torch.randn(F, generator=gen, device=cuda_device).to(dtype)
        got = [cudaex.linear_act(x, wg, b, "gelu")]
        want = [tnn.linear_act_plain(x, wg, b, "gelu")]
        design = cudaex.linear_act_design(dtype, M)
    torch.cuda.synchronize()
    assert cudaex.design_counts()[kernel] == {design: 1}
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert row_rel_err(a, w) <= tol, row_rel_err(a, w)


def _c1_cases(device):
    """ROADMAP C.1's inputs, which the reference computes through its
    decomposition: (routed call on the card, the plain version on the same
    inputs, the kernel the call must launch, the comparison's bound)."""
    gen = torch.Generator(device=device).manual_seed(9)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    x16, w16 = rnd(8, 256, dtype=torch.float16), rnd(256, dtype=torch.float16)
    xs, wf = rnd(256, 8).t(), rnd(256)                            # strided (8, 256)
    xb = rnd(8, 256, dtype=torch.bfloat16)                        # with wf: mixed weight dtype
    q8 = [rnd(2, 8, 64, 8, dtype=torch.bfloat16) for _ in range(4)]     # tiny-tp's head dim
    q192 = [rnd(2, 2, 64, 192, dtype=torch.bfloat16) for _ in range(4)]
    a518, w518 = rnd(8, 518, dtype=torch.bfloat16), rnd(64, 518, dtype=torch.bfloat16)
    a518t = rnd(100, 518, dtype=torch.bfloat16)                   # the tile path, K padded
    dec, _ = _decode_args(device, torch.bfloat16, "tiny-tp-hd8", seed=9)

    def attn(qkvg):   # forward and backward through the autograd function
        q, k, v = (t.clone().requires_grad_(True) for t in qkvg[:3])
        out = tnn.scaled_dot_product_attention(q, k, v, is_causal=True)
        out.backward(qkvg[3])
        return [out.detach(), q.grad, k.grad, v.grad]

    def attn_plain(qkvg):
        # the backward from the (out, lse) the forward kernel saved, so that
        # each kernel is held against its own plain version on its own inputs
        q, k, v, g = qkvg
        out, lse = tnn.sdpa_fwd(q, k, v, True)
        return [tnn.sdpa_fwd_plain(q, k, v, True)[0],
                *tnn.sdpa_bwd_plain(g, q, k, v, out, lse, True)]

    return {
        "float16": (lambda: [tnn.rms_norm(x16, w16)], lambda: [tnn.rms_norm_plain(x16, w16)],
                    "rms_norm", "ulp"),
        "strided": (lambda: [tnn.rms_norm(xs, wf)], lambda: [tnn.rms_norm_plain(xs, wf)],
                    "rms_norm", 1e-5),
        "mixed-weight-dtype": (lambda: [tnn.rms_norm(xb, wf)],
                               lambda: [tnn.rms_norm_plain(xb, wf)], "rms_norm", "ulp"),
        "hd8": (lambda: attn(q8), lambda: attn_plain(q8), "sdpa_bwd", 2e-2),
        "hd192": (lambda: attn(q192), lambda: attn_plain(q192), "sdpa_bwd", 2e-2),
        "K518-bf16": (lambda: [tnn.linear_act(a518, w518, None, "silu")],
                      lambda: [tnn.linear_act_plain(a518, w518, None, "silu")], "linear_act",
                      2e-2),
        "K518-bf16-tile": (lambda: [tnn.linear_act(a518t, w518, None, "silu")],
                           lambda: [tnn.linear_act_plain(a518t, w518, None, "silu")],
                           "linear_act", 2e-2),
        "attn_subblock-hd8": (lambda: list(cudaex.attn_subblock(*dec)),
                              lambda: list(tnn.attn_subblock_plain(*dec)), "attn_subblock",
                              2e-2),
    }


C1_CASES = ["float16", "strided", "mixed-weight-dtype", "hd8", "hd192", "K518-bf16",
            "K518-bf16-tile", "attn_subblock-hd8"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", C1_CASES)
def test_cuda_c1_inputs_launch_and_match(cuda_device, case):
    """Each of ROADMAP C.1's inputs launches its hand-written kernel on the
    card and matches the plain version on the same inputs: the norms within
    one rounding step of their output dtype where they round (``ulp``), 1e-5
    in float32; attention (forward and gradients, through the autograd
    function, head dims padded to 16's multiples) and linear_act row by row
    at 2e-2 (bf16 inputs); the decode sub-block at 2e-2 row by row."""
    routed, plain, kernel, tol = _c1_cases(cuda_device)[case]
    cudaex.reset_launch_counts()
    got = routed()
    torch.cuda.synchronize()
    assert cudaex.launch_counts()[kernel] > 0, cudaex.launch_counts()
    want = plain()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        if tol == "ulp":
            assert bool(((a.float() - b.float()).abs() <= _bf16_tol(b)).all())
        elif isinstance(tol, float) and tol < 1e-3:
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)
        else:
            assert row_rel_err(a, b) <= tol, row_rel_err(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64"])
def test_cuda_refused_inputs_raise(cuda_device, case):
    """What stays refused raises the reason ``cudaex.refusal`` gives, before
    any launch: float64, which the reference (JAX without x64) never makes.
    No plain version runs on the card."""
    x = torch.randn(8, 256, device=cuda_device, dtype=torch.float64)
    assert "not supported" in cudaex.refusal("rms_norm", x, None)
    cudaex.reset_launch_counts()
    with pytest.raises(ValueError, match="not supported"):
        tnn.rms_norm(x, None)
    assert sum(cudaex.launch_counts().values()) == 0, cudaex.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_linear_cross_entropy_matches_cpu(cuda_device, dtype):
    """Loss, lse and both gradients on the card against the CPU route from
    the same values: float32 1e-5; bf16 loss and lse 1e-5 relative (the
    products are exact in float32 on both routes, summed in another order)
    and gradients about one bf16 ulp (d(logits) rounds to bf16 before the
    products, where a one-step difference in an f32 sum can move it)."""
    gen = torch.Generator().manual_seed(11)
    N, D, V = 512, 256, 1000
    h = torch.randn(N, D, generator=gen).to(dtype)
    w = (torch.randn(V, D, generator=gen) / D ** 0.5).to(dtype)
    target = torch.randint(0, V, (N,), generator=gen)
    target[::37] = -100
    out = {}
    for device in ("cuda", "cpu"):
        ht, wt = (t.to(device).requires_grad_(True) for t in (h, w))
        loss, lse = tnn.fused_linear_cross_entropy(ht, wt, target.to(device), chunk=384)
        (loss + 0.1 * lse.sum()).backward()
        out[device] = [t.detach().cpu() for t in (loss, lse, ht.grad, wt.grad)]
    print("logits route on the card:", tnn.flce_logits_route(h.to(cuda_device)))
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    for a, b in zip(out["cuda"][2:], out["cpu"][2:]):
        assert a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert bool(((a.float() - b.float()).abs() <= _bf16_tol(b)).all())


@pytest.mark.cuda
def test_cuda_bench_step_matches_cpu(cuda_device):
    """Three float32 tiny-gqa steps of the bench's step (fused loss, remat,
    slab state with bf16 m) on the card and on the CPU from the same
    weights: losses to 1e-5 relative, parameters to 0.2 lr, the f32 v slab
    to 1e-9 and the bf16 m slab within two bf16 rounding steps (2**-6 of
    the larger value, + 1e-6), as chip_smoke.py's phase 12, and every
    step's launches those of the reference's claims at 2 layers."""
    from thunder_tpu_torch.benchmarks import bench
    from thunder_tpu_torch.models import llama
    from thunder_tpu_torch.optim import tree_leaves, tree_map

    cfg = llama.CONFIGS["tiny-gqa"]
    cpu = llama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    card = tree_map(lambda t: t.cuda(), cpu)
    kw = dict(layers=2, batch=2, seq=64, steps=3, remat=True, slab_state=True)
    opt = bench.make_opt("bf16", slab_state=True)
    st_card, st_cpu = opt.init(card), opt.init(cpu)
    a = bench.run("tiny-gqa", device="cuda", params=card, state=st_card, **kw)
    b = bench.run("tiny-gqa", device="cpu", params=cpu, state=st_cpu, **kw)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    for x, y in zip(tree_leaves(card), tree_leaves(cpu)):
        np.testing.assert_allclose(x.detach().cpu().numpy(), y.detach().numpy(),
                                   atol=0.2 * bench.LR)
    for which, rtol, atol in (("m", 2.0 ** -6, 1e-6), ("v", 0.0, 1e-9)):
        assert set(st_card[which]) == set(st_cpu[which])
        for key, got in st_card[which].items():
            got, want = got.cpu().float(), st_cpu[which][key].float()
            bound = rtol * torch.maximum(got.abs(), want.abs()) + atol
            assert bool(((got - want).abs() <= bound).all()), (which, key)
    assert float(st_card["step"]) == float(st_cpu["step"]) == 4.0
    for step in a["per_step"]:
        assert step["launches"] == {"rms_norm": 7, "rms_norm_residual": 2, "sdpa_fwd": 4,
                                    "sdpa_bwd": 2, "fused_adamw_slab": 1}


# ---------------------------------------------------------------------------
# rms_norm_residual's designs; the planted fault its check must fail
# ---------------------------------------------------------------------------

RESIDUAL_SHAPES = {"decode": (8, 4096), "train": (8, 2048, 4096), "off16": (8, 4100)}
RESIDUAL_WEIGHTS = ("same", "float32", "none")


def _residual_inputs(device, dtype, shape, weight, seed=5):
    g = torch.Generator(device=device).manual_seed(seed)
    r, x = (torch.randn(*shape, generator=g, device=device).to(dtype) for _ in range(2))
    w = (torch.rand(shape[-1], generator=g, device=device) + 0.5)
    w = None if weight == "none" else w.to(dtype if weight == "same" else torch.float32)
    return r, x, w


@pytest.mark.cuda
@pytest.mark.parametrize("weight", RESIDUAL_WEIGHTS)
@pytest.mark.parametrize("shape", list(RESIDUAL_SHAPES), ids=list(RESIDUAL_SHAPES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_cuda_rms_norm_residual_designs_match_plain(cuda_device, dtype, shape, weight):
    """rms_norm_residual at the decode (8 x 4096) and train ((8, 2048, 4096))
    shapes on its vector design, and at D = 4100 (16-bit rows off 16 bytes:
    the scalar design; float32 rows of 4100 still take vector), with a
    weight of x's dtype, a float32 weight (float32 output) and none. Each
    launch takes the design ``cudaex.rms_norm_residual_design`` names. h is
    the plain version's bit for bit; y within one rounding step unweighted
    and two weighted in 16-bit (the sum of squares in another order can
    move the normalised value one step, which the weight multiply and its
    rounding can carry to two), 2**-7 relative with a float32 weight (one
    step of the 16-bit normalised value) and 1e-5 in float32; and y is
    exactly the kernel's own unweighted output times the weight."""
    shp = RESIDUAL_SHAPES[shape]
    r, x, w = _residual_inputs(cuda_device, dtype, shp, weight)
    cudaex.reset_launch_counts()
    got_h, got_y = cudaex.rms_norm_residual(r, x, w, EPS)
    torch.cuda.synchronize()
    design = cudaex.rms_norm_residual_design(dtype, shp[-1])
    assert cudaex.design_counts()["rms_norm_residual"] == {design: 1}
    assert design == ("scalar" if shape == "off16" and dtype != torch.float32 else "vector")
    want_h, want_y = tnn.rms_norm_residual_plain(r, x, w, EPS)
    assert got_y.dtype == want_y.dtype and got_y.shape == want_y.shape
    assert torch.equal(got_h, want_h)
    if dtype == torch.float32:
        torch.testing.assert_close(got_y, want_y, atol=1e-5, rtol=1e-5)
    elif weight == "float32":
        assert bool(((got_y - want_y).abs() <= want_y.abs() * 2.0 ** -7 + 1e-6).all())
    else:
        assert ulp_distance(got_y, want_y) <= (1 if weight == "none" else 2)
    if w is not None:
        _, normed = cudaex.rms_norm_residual(r, x, None, EPS)
        assert torch.equal(got_y, (normed.float() * w.float()).to(got_y.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["decode", "train"])
def test_cuda_rms_norm_residual_check_fails_planted_fault(cuda_device, shape):
    """chip_smoke.py's check of rms_norm_residual (h bit for bit, y within
    2**-6 relative) passes the kernel and fails its output with a fault
    planted: the last row's sum of squares without its last 256 values,
    what a reduction that drops one warp's partial computes."""
    from thunder_tpu_torch.testing import rms_residual_fault

    r, x, w = _residual_inputs(cuda_device, torch.bfloat16, RESIDUAL_SHAPES[shape], "same")
    got_h, got_y = cudaex.rms_norm_residual(r, x, w, EPS)
    want_h, want_y = tnn.rms_norm_residual_plain(r, x, w, EPS)

    def close(h, y):
        dy = (y.float() - want_y.float()).abs()
        return torch.equal(h, want_h) and bool((dy <= want_y.float().abs() * 2.0 ** -6
                                                + 1e-6).all())

    assert close(got_h, got_y)
    assert not close(got_h, rms_residual_fault(got_h, w, EPS, 256))


# ---------------------------------------------------------------------------
# the train path's input pipeline, checkpoints and clipping on the card machine
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_machine_builds_the_native_loader(cuda_device, tmp_path):
    """The C++ token loader builds on the card's machine (g++ into
    ``_build/``) and streams the same windows as its plain Python version."""
    from thunder_tpu_torch import data

    path = str(tmp_path / "tokens.bin")
    data.write_token_file(path, np.random.RandomState(0).randint(0, 32000, 20000))
    native = data.ShardedTokenStream(path, batch=4, seq=63, seed=2, native=True)
    plain = data.ShardedTokenStream(path, batch=4, seq=63, seed=2, native=False)
    assert native.stream_path() == "native" and plain.stream_path() == "python"
    for step in (0, 1, 2, 90, 3):
        for a, b in zip(native.batch_at(step), plain.batch_at(step)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_pretrain_from_a_token_file_resumes_bit_identically(cuda_device, tmp_path):
    """tiny-gqa at 2 layers on the card from a token file: 4 steps straight
    through, and 2 steps, an asynchronous checkpoint, a load and 2 more
    from ``start_step=2``, give the same losses and parameters bit for bit
    (chip_smoke.py's phase 14 at a small size)."""
    from thunder_tpu_torch import checkpoint, data
    from thunder_tpu_torch.benchmarks import pretrain
    from thunder_tpu_torch.models import llama
    from thunder_tpu_torch.optim import AdamW, tree_leaves

    cfg = llama.CONFIGS["tiny-gqa"]
    path = str(tmp_path / "tokens.bin")
    data.write_token_file(path, np.random.RandomState(1).randint(0, cfg.vocab_size, 40000))
    kw = dict(layers=2, batch=2, seq=64, lr=1e-3, device="cuda", data=path, data_seed=4)

    def fresh():
        params = llama.init_params(cfg, seed=0, device="cuda", n_layers=2)
        opt = AdamW(lr=1e-3)
        return params, opt, opt.init(params)

    params, opt, state = fresh()
    a = pretrain.run("tiny-gqa", steps=3, params=params, opt=opt, state=state, **kw)
    want = [t.detach().cpu() for t in tree_leaves(params)]
    params, opt, state = fresh()
    b1 = pretrain.run("tiny-gqa", steps=1, params=params, opt=opt, state=state, **kw)
    ck = str(tmp_path / "ck")
    assert checkpoint.save_checkpoint(ck, {"params": params, "opt": state}, asynchronous=True)
    loaded = checkpoint.load_checkpoint(ck, device="cuda")
    b2 = pretrain.run("tiny-gqa", steps=1, params=loaded["params"], opt=AdamW(lr=1e-3),
                      state=loaded["opt"], start_step=2, **kw)
    assert a["stream_path"] == b1["stream_path"] == b2["stream_path"] == "native"
    assert b1["losses"] + b2["losses"] == a["losses"]
    for got, w in zip(tree_leaves(loaded["params"]), want):
        assert torch.equal(got.detach().cpu(), w)


@pytest.mark.cuda
def test_cuda_clip_grad_norm_matches_torch(cuda_device):
    """clip_grad_norm on CUDA grads: over a tree of float32 and bf16 leaves
    its norm against a float64 sum of squares (1e-6 relative); over a tree
    of one dtype its clipped grads against ``torch.nn.utils.clip_grad_norm_``
    on copies, float32 1e-6, bf16 2**-6 relative (torch takes a bf16 leaf's
    norm in bf16, 2**-9, which can move the bf16 product one rounding
    step). A tree mixing the two is not compared with torch: torch's total
    norm then carries the bf16 group's rounded norm into the float32
    leaves' scale as well."""
    from thunder_tpu_torch.optim import clip_grad_norm

    g = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randn(1000, 37, generator=g, device=cuda_device)
    b = torch.randn(4096, generator=g, device=cuda_device).to(torch.bfloat16)
    norm64 = math.sqrt(sum(float(t.double().square().sum()) for t in (a, b)))
    _, norm = clip_grad_norm({"a": a, "b": [b]}, 0.25 * norm64)
    assert abs(float(norm) - norm64) <= 1e-6 * norm64
    for t, rtol in ((a, 1e-6), (b, 2.0 ** -6)):
        n = math.sqrt(float(t.double().square().sum()))
        clipped, norm = clip_grad_norm({"g": [t]}, 0.25 * n)
        assert abs(float(norm) - n) <= 1e-6 * n
        p = torch.nn.Parameter(torch.empty_like(t))
        p.grad = t.clone()
        torch.nn.utils.clip_grad_norm_([p], 0.25 * n)
        mine, ref = clipped["g"][0].float(), p.grad.float()
        assert bool(((mine - ref).abs() <= ref.abs() * rtol + 1e-12).all())


# ---------------------------------------------------------------------------
# the numerics guard's pieces in csrc/fused_adamw.cu: the health pass and
# the gated update, on both table layouts
# ---------------------------------------------------------------------------

# (layout, p, g, m, v): every dtype mix the update takes, per-step and slab
HEALTH_MIXES = [
    ("step", torch.float32, torch.float32, torch.float32, torch.float32),
    ("step", torch.bfloat16, torch.bfloat16, torch.float32, torch.float32),
    ("step", torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32),
    ("step", torch.float16, torch.float16, torch.float32, torch.float32),
    ("step", torch.float32, torch.bfloat16, torch.float32, torch.float32),
    ("step", torch.bfloat16, torch.float32, torch.float32, torch.float32),
    ("slab", torch.float32, torch.float32, torch.float32, torch.float32),
    ("slab", torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32),
    ("slab", torch.bfloat16, torch.bfloat16, torch.float32, torch.float32),
    ("slab", torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.bfloat16),
]
# where a NaN (or an inf moment) is planted: nowhere; the last element of the
# (37,) member, a tail of fewer than 4 elements (the scalar path); the last
# element of the last member, in the bucket's last chunk; an inf in the first
# member's m, so only the state counts it
HEALTH_PLANTS = ["none", "tail", "last_chunk", "state"]


def _health_bucket(device, layout, p_dtype, g_dtype, m_dtype, v_dtype, plant):
    """A bucket of ragged sizes with random moments (as after some steps),
    the plant applied: ``(args, kwargs)`` of the layout's update without
    ``bc``/``acc``/hyper."""
    shapes = SLAB_SIZES[:6] + [(37,), (3, 5000)]
    gen = torch.Generator(device=device).manual_seed(8)
    ps = [torch.randn(s, generator=gen, device=device).to(p_dtype) for s in shapes]
    gs = [torch.randn(s, generator=gen, device=device).to(g_dtype) for s in shapes]
    ms = [(0.1 * torch.randn(s, generator=gen, device=device)).to(m_dtype) for s in shapes]
    vs = [(0.01 * torch.rand(s, generator=gen, device=device)).to(v_dtype) for s in shapes]
    if plant == "tail":
        gs[-2].view(-1)[-1] = float("nan")
    elif plant == "last_chunk":
        gs[-1].view(-1)[-1] = float("nan")
    elif plant == "state":
        ms[0].view(-1)[5] = float("inf")
    if layout == "step":
        return (ps, gs, ms, vs), {}
    from thunder_tpu_torch.ops import optim as toptim_ops

    sizes = [p.numel() for p in ps]
    rows, _ = toptim_ops.slab_geometry(sum(sizes))
    m = torch.zeros(rows, 128, dtype=m_dtype, device=device)
    v = torch.zeros(rows, 128, dtype=v_dtype, device=device)
    m.view(-1)[:sum(sizes)] = torch.cat([t.reshape(-1) for t in ms])
    v.view(-1)[:sum(sizes)] = torch.cat([t.reshape(-1) for t in vs])
    return (ps, gs, m, v), {"sizes": sizes}


def _health_fns(layout):
    from thunder_tpu_torch.ops import optim as toptim_ops

    if layout == "step":
        return (cudaex.fused_adamw_health, toptim_ops.fused_adamw_health_plain,
                cudaex.fused_adamw, toptim_ops.fused_adamw_plain)
    return (cudaex.fused_adamw_slab_health, toptim_ops.fused_adamw_slab_health_plain,
            cudaex.fused_adamw_slab, toptim_ops.fused_adamw_slab_plain)


HEALTH_HYPER = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("plant", HEALTH_PLANTS)
@pytest.mark.parametrize("mix", HEALTH_MIXES, ids=lambda m: "-".join(
    [m[0]] + [str(t).removeprefix("torch.") for t in m[1:]]))
def test_cuda_fused_adamw_health_matches_plain(cuda_device, mix, plant):
    """The health pass against its plain twin: the counts of non-finite g
    and of non-finite p', m', v' (as stored) exactly, the sum of g*g within
    1e-5 relative (float32 chunk sums folded in float64, against float32
    sums per tensor); two calls bit-identical; nothing stored. A planted NaN
    in a scalar tail or in the last chunk is counted once, an inf moment
    in the state only."""
    layout = mix[0]
    args, kw = _health_bucket(cuda_device, layout, *mix[1:], plant)
    health, health_plain, _, _ = _health_fns(layout)
    bc = torch.tensor([0.5, 0.02], dtype=torch.float32, device=cuda_device)
    before = [t.clone() for t in (*args[0], *args[1])]
    accs = []
    for _ in range(2):
        acc = torch.zeros(3, dtype=torch.float64, device=cuda_device)
        health(*args, bc, acc, **kw, **HEALTH_HYPER)
        accs.append(acc)
    want = torch.zeros(3, dtype=torch.float64, device=cuda_device)
    health_plain(*args, bc, want, **kw, **HEALTH_HYPER)
    torch.cuda.synchronize()
    assert torch.equal(accs[0].view(torch.int64), accs[1].view(torch.int64))   # NaN bits too
    got, want = accs[0].tolist(), want.tolist()
    assert got[0] == want[0] and got[2] == want[2], (got, want)
    assert got[0] == (1.0 if plant in ("tail", "last_chunk") else 0.0)
    if plant == "state":
        assert got[2] >= 1.0
    if plant in ("none", "state"):
        assert abs(got[1] - want[1]) <= 1e-5 * want[1]
    else:
        assert math.isnan(got[1]) and math.isnan(want[1])
    # nothing stored: the same bits (a planted NaN is not equal to itself)
    assert all(ulp_distance(a, b) == 0 for a, b in zip(before, (*args[0], *args[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("plant", HEALTH_PLANTS)
@pytest.mark.parametrize("mix", HEALTH_MIXES, ids=lambda m: "-".join(
    [m[0]] + [str(t).removeprefix("torch.") for t in m[1:]]))
def test_cuda_gated_update_matches_plain(cuda_device, mix, plant):
    """The update gated on the word the health pass and the loss build:
    healthy, it is the ungated kernel bit for bit; unhealthy, it leaves
    p, m and v bit-identical; the plain twin (torch.where on the device
    bool) agrees with it in both cases within the update's 4 ULP."""
    from thunder_tpu_torch.ops import optim as toptim_ops

    layout = mix[0]
    args, kw = _health_bucket(cuda_device, layout, *mix[1:], plant)
    health, _, update, update_plain = _health_fns(layout)
    bc = torch.tensor([0.5, 0.02], dtype=torch.float32, device=cuda_device)
    acc = torch.zeros(3, dtype=torch.float64, device=cuda_device)
    health(*args, bc, acc, **kw, **HEALTH_HYPER)
    word = torch.stack([acc[0].float(), torch.zeros((), device=cuda_device), acc[2].float(),
                        torch.sqrt(acc[1]).float(), torch.ones((), device=cuda_device)])
    ok = bool(toptim_ops.healthy(word))
    assert ok == (plant == "none")

    def copy():
        return ([t.clone() for t in args[0]], args[1],
                *([t.clone() for t in x] if isinstance(x, list) else x.clone()
                  for x in args[2:]))

    gated, ungated, plain, before = copy(), copy(), copy(), copy()
    update(*gated, bc, **kw, **HEALTH_HYPER, health=word)
    update(*ungated, bc, **kw, **HEALTH_HYPER)
    update_plain(*plain, bc, **kw, **HEALTH_HYPER, health=word)
    torch.cuda.synchronize()

    def leaves(x):
        return [t for part in (x[0], *x[2:]) for t in (part if isinstance(part, list) else [part])]

    want = ungated if ok else before
    for a, b, c in zip(leaves(gated), leaves(want), leaves(plain)):
        assert torch.equal(a, b)
        assert ulp_distance(a, c) <= 4


# ---------------------------------------------------------------------------
# the serving fleet's pieces on the card: copy-on-write pages, the captured
# decode loop
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_copy_page_and_fork_bit_for_bit(cuda_device, dtype):
    """``copy_page`` and a fork's tail copy on the card: the new page holds
    the source page's bytes in every layer and no other page moves; the same
    calls on a CPU copy of the pools give the same pools, bit for bit. The
    copy is ordered before a later write on the same stream."""
    from thunder_tpu_torch.serving import PagedKVCache, PageGeometry

    g = PageGeometry(n_layers=3, kv_heads=8, head_dim=128, page_size=16, num_pages=40,
                     pages_per_request=8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = PagedKVCache(g, dtype, "cuda")
    for kv in card.pools:
        for t in kv.values():
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(dtype))
    cpu = PagedKVCache(g, dtype, "cpu")
    cpu.pools = [{k: v.cpu() for k, v in kv.items()} for kv in card.pools]
    before = [{k: v.clone() for k, v in kv.items()} for kv in cpu.pools]
    outs = []
    for cache in (card, cpu):
        pages = cache.alloc(3)
        forked = cache.fork(pages, 37)            # 2 full pages shared, the tail copied
        cache.copy_page(pages[0], 30)
        outs.append((pages, forked, cache.cow_copies))
        cache.pools[0]["k"][:, forked[2]] = 0     # a write after the copy
    assert outs[0] == outs[1] and outs[0][2] == 1
    pages, forked, _ = outs[0]
    for a, b, kv0 in zip(card.pools, cpu.pools, before):
        for k in ("k", "v"):
            assert torch.equal(a[k].cpu(), b[k])
            want = kv0[k].clone()
            want[:, forked[2]] = kv0[k][:, pages[2]]
            want[:, 30] = kv0[k][:, pages[0]]
            if a is card.pools[0] and k == "k":
                want[:, forked[2]] = 0
            assert torch.equal(b[k], want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_bmm_f32_accumulates_16_bit_operands(cuda_device, dtype):
    """The contiguous cache's scores on the card: one bmm of the 16-bit
    operands with float32 output, equal to the float32 product of the same
    values up to the order of the float32 sums."""
    from thunder_tpu_torch.ops import nn as tnn

    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(16, 32, 128, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(16, 128, 2048, generator=g, device=cuda_device).to(dtype)
    got = tnn.bmm_f32(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.bmm(a.float(), b.float()), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_name,dtype", [("tiny-gqa", torch.float32),
                                            ("tiny-gqa", torch.bfloat16)])
def test_cuda_generate_fused_matches_generate(cuda_device, cfg_name, dtype):
    """The captured decode loop gives ``generate``'s greedy tokens bit for
    bit, its capture launched what one eager step launched, a replay's
    device time was read, and in float32 the tokens equal the CPU's."""
    import dataclasses

    from thunder_tpu_torch.models import llama as tllama

    cfg = dataclasses.replace(tllama.CONFIGS[cfg_name], dtype=dtype)
    params = tllama.init_params(cfg, seed=0, device="cuda", n_layers=2)
    prompt = np.random.RandomState(1).randint(1, cfg.vocab_size, size=(3, 21))
    stats = {}
    fused = tllama.generate_fused(params, cfg, prompt, 12, max_len=64, stats=stats)
    eager = tllama.generate(params, cfg, prompt, 12, max_len=64)
    assert torch.equal(fused, eager)
    assert stats["graph"] and stats["replays"] == 10
    assert stats["captured_launches"] == stats["eager_launches"]
    assert stats["eager_launches"] == {"rms_norm": 1, "rms_norm_residual": 4, "linear_act": 2}
    assert stats["replay_ms"] > 0
    if dtype == torch.float32:
        cpu = tllama.generate(tllama.to_device(params, "cpu"),
                              cfg, prompt, 12, max_len=64, device="cpu")
        assert torch.equal(eager.cpu(), cpu)


# ---------------------------------------------------------------------------
# the model zoo's shapes (chip_smoke.py phases 3 and 17)
# ---------------------------------------------------------------------------

# (dtype, B, H, T, S, hd, causal): falcon's 71 heads at hd 64, gemma's hd 256,
# gpt2-xl's 25 heads, BART's non-causal cross-attention (T 512 against S
# 1024) in float32 (its dtype) and in bf16
ZOO_ATTN = [(torch.bfloat16, 1, 71, 512, 512, 64, True),
            (torch.bfloat16, 1, 8, 1024, 1024, 256, True),
            (torch.bfloat16, 2, 25, 256, 256, 64, True),
            (torch.float32, 1, 12, 512, 1024, 64, False),
            (torch.bfloat16, 1, 12, 512, 1024, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,T,S,hd,causal", ZOO_ATTN,
                         ids=[f"{str(d)[6:]}-{b}x{h}x{t}x{s}x{hd}{'-causal' if c else ''}"
                              for d, b, h, t, s, hd, c in ZOO_ATTN])
def test_cuda_sdpa_at_zoo_shapes_matches_plain(cuda_device, dtype, B, H, T, S, hd, causal):
    """Attention forward and backward at the zoo's shapes, row by row, on
    the design the rule names (the bounds of test_cuda_sdpa_matches_plain)."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)

    q, g, k, v = rnd(B, H, T, hd), rnd(B, H, T, hd), rnd(B, H, S, hd), rnd(B, H, S, hd)
    cudaex.reset_launch_counts()
    out, lse = cudaex.sdpa_fwd(q, k, v, causal)
    dq, dk, dv = cudaex.sdpa_bwd(g, q, k, v, out, lse, causal)
    torch.cuda.synchronize()
    design = cudaex.sdpa_fwd_design(dtype, hd)
    assert cudaex.design_counts()["sdpa_fwd"] == {design: 1}
    assert cudaex.design_counts()["sdpa_bwd"] == {cudaex.sdpa_bwd_design(dtype, hd): 1}
    want_out, want_lse = tnn.sdpa_fwd_plain(q, k, v, causal)
    f32 = dtype == torch.float32
    assert row_rel_err(out, want_out) <= (1e-5 if f32 else 2e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    got = cudaex.sdpa_bwd(g, q, k, v, want_out, want_lse, causal)
    for a, b in zip(got, tnn.sdpa_bwd_plain(g, q, k, v, want_out, want_lse, causal)):
        assert row_rel_err(a, b) <= (1e-4 if f32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [50257, 50265, 256000, 1000])
def test_cuda_ce_fwd_at_zoo_vocabularies_matches_plain(cuda_device, V):
    """cross-entropy on the float32 logits of the zoo's vocabularies: GPT-2's
    50257 and BART's 50265 take the kernel's scalar loads (V % 4 != 0),
    Gemma's 256000 the widest rows, ResNet's 1000 classes."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    logits = torch.randn(37, V, generator=gen, device=cuda_device) * 4
    target = torch.randint(0, V, (37,), generator=gen, device=cuda_device)
    target[[0, 36]] = -100
    nll, lse = cudaex.ce_fwd(logits, target)
    want_nll, want_lse = tnn.ce_fwd_plain(logits, target)
    torch.testing.assert_close(nll, want_nll, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    assert float(nll[0]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 2048), (torch.float32, 768)])
def test_cuda_norms_at_zoo_widths_match_plain(cuda_device, dtype, D):
    """rms_norm and rms_norm_residual at Gemma's D = 2048 (bf16) and BART's
    D = 768 (float32): h bit for bit, the normed rows within one bf16
    rounding step (2**-6 relative) or 1e-5 in float32."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    x, r = (torch.randn(3, 100, D, generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    w = (torch.rand(D, generator=gen, device=cuda_device) + 0.5).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    y = cudaex.rms_norm(x, w, EPS)
    torch.testing.assert_close(y.float(), tnn.rms_norm_plain(x, w, EPS).float(), rtol=tol,
                               atol=1e-5)
    h, y = cudaex.rms_norm_residual(r, x, w, EPS)
    wh, wy = tnn.rms_norm_residual_plain(r, x, w, EPS)
    assert torch.equal(h, wh)
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=1e-5)


@pytest.mark.cuda
def test_cuda_expert_product_matches_cpu(cuda_device):
    """The MoE's float32 expert product from bf16 weights on the card (a
    float32 bmm on the weight's float32 copy, made and dropped inside the
    forward and the backward) against the CPU's."""
    from thunder_tpu_torch.models import mixtral

    gen = torch.Generator().manual_seed(16)
    a = torch.randn(4, 64, 256, generator=gen)
    w = torch.randn(4, 512, 256, generator=gen).mul_(0.05).to(torch.bfloat16)
    g = torch.randn(4, 64, 512, generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        ad, wd = (t.detach().to(dev).requires_grad_(True) for t in (a, w))
        out = mixtral._expert_product(ad, wd)
        out.backward(g.to(dev))
        outs[dev] = (out.detach().cpu(), ad.grad.cpu(), wd.grad.float().cpu())
    for x, y in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(x, y, atol=1e-3, rtol=1e-4)


ZOO_TINY = ["mixtral/tiny-moe", "gpt/tiny", "gpt/tiny-neox", "gpt/tiny-falcon",
            "gpt/tiny-gemma", "gpt/tiny-phi", "nanogpt/gpt2-tiny", "seq2seq/tiny",
            "resnet/resnet-tiny"]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ZOO_TINY)
def test_cuda_zoo_tiny_train_steps_match_cpu(cuda_device, model):
    """Three float32 train steps of each tiny zoo config on the card and on
    the CPU from the same weights and batch (``benchmarks.zoo.run``): the
    losses to 1e-5 relative, every step launching the reference's claims."""
    from thunder_tpu_torch.benchmarks import zoo
    from thunder_tpu_torch.optim import tree_map

    params, bn = zoo.init_model(model, seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), params)
    card_bn = tree_map(lambda t: t.cuda(), bn) if bn is not None else None
    kw = dict(batch=2, seq=32, steps=2, lr=1e-3, src_seq=48, image=16)
    a = zoo.run(model, device="cuda", params=card, bn_state=card_bn, **kw)
    b = zoo.run(model, device="cpu", params=params, bn_state=bn, **kw)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    want = zoo.expected_launches(model)
    assert all(s["launches"] == want for s in a["per_step"])


# ---------------------------------------------------------------------------
# the trace compiler's slice (thunder_tpu_torch.jit) on the card
# ---------------------------------------------------------------------------

def _jit_launches(jf, *args):
    """A cached call of ``jf``: its output and launches, which must equal
    the trace's claims."""
    from thunder_tpu_torch.testing import jit_launches

    jf.compile(*args)
    out, launches, claims = jit_launches(jf, *args)
    assert launches == claims
    return out, launches


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["forward", "loss"])
def test_cuda_jit_tiny_llama_matches_cpu(cuda_device, what):
    """jit(llama.forward) and jit(llama.loss_fn), tiny-gqa float32, on the
    card against the same jit on the CPU: logits 1e-4, the loss 1e-5
    relative (the kernels sum in other orders than the CPU's decomposition);
    the card's launches are the trace's claims."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.optim import tree_map

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    if what == "forward":
        fn, args = (lambda p, t: tllama.forward(p, t, cfg)), (params, tokens)
    else:
        fn, args = (lambda p, t, y: tllama.loss_fn(p, t, y, cfg)), (params, tokens, targets)
    cpu = ptt.jit(fn, device="cpu")(*args)
    card_args = tuple(tree_map(lambda t: t.cuda(), a) for a in args)
    out, launches = _jit_launches(ptt.jit(fn), *card_args)
    L = cfg.n_layers
    want = {"rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L, "linear_act": L}
    if what == "loss":
        want["ce_fwd"] = 1
        np.testing.assert_allclose(float(out), float(cpu), rtol=1e-5)
    else:
        torch.testing.assert_close(out.cpu(), cpu, atol=1e-4, rtol=1e-4)
    assert launches == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_jit_plain_layer_finds_its_kernels(cuda_device, dtype):
    """One Llama layer in plain PyTorch at a small width (D 256, 4 heads, 2
    kv heads, F 512) through jit: the epilogue pass builds rms_norm_residual
    and linear_act, the claim pass takes rms_norm and attention, each
    launching once; the output against the same function run eagerly on
    PyTorch's library calls, row by row: 1e-4 (float32) and 2e-2 (bf16) of
    each row's largest value."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import plain_llama_layer

    gen = torch.Generator(device="cuda").manual_seed(5)
    Dm, Fd = 256, 512

    def dense(n_out, n_in):
        return (torch.randn(n_out, n_in, generator=gen, device="cuda") * n_in ** -0.5).to(dtype)

    def norm_w():
        return (torch.rand(Dm, generator=gen, device="cuda") + 0.5).to(dtype)

    x = torch.randn(2, 64, Dm, generator=gen, device="cuda").to(dtype)
    w = (norm_w(), dense(Dm, Dm), dense(128, Dm), dense(128, Dm), dense(Dm, Dm), norm_w(),
         dense(Fd, Dm), dense(Fd, Dm), dense(Dm, Fd))

    def layer(x, *w):
        return plain_llama_layer(x, *w, n_heads=4, n_kv=2)

    out, launches = _jit_launches(ptt.jit(layer), x, *w)
    assert launches == {"rms_norm": 1, "sdpa_fwd": 1, "rms_norm_residual": 1, "linear_act": 1}
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert row_rel_err(out, layer(x, *w)) <= tol


@pytest.mark.cuda
def test_cuda_jit_quarantined_claim_raises(cuda_device):
    """With cuda.rms_norm quarantined, a jit call on the card raises the
    router's fatal KernelExecutionError instead of decomposing; the same
    function on the CPU still runs."""
    import torch.nn.functional as F

    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.runtime import faults, quarantine

    def f(x, w):
        return F.rms_norm(x, (64,), w, eps=1e-5) * 2.0

    x, w = torch.randn(8, 64), torch.rand(64) + 0.5
    quarantine.reset()
    try:
        quarantine.get_quarantine().add("cuda.rms_norm", reason="test")
        with pytest.raises(faults.KernelExecutionError) as err:
            ptt.jit(f)(x.cuda(), w.cuda())
        assert err.value.claim_id == "cuda.rms_norm" and err.value.phase == faults.QUARANTINED
        torch.testing.assert_close(ptt.jit(f, device="cpu")(x, w),
                                   F.rms_norm(x, (64,), w, eps=1e-5) * 2.0)
    finally:
        quarantine.reset()


# ---------------------------------------------------------------------------
# trace-level autograd on the card: the sdpa_bwd and fused_adamw claims
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_jit_sdpa_bwd_claim_matches_eager(cuda_device, dtype):
    """grad of causal attention under jit: the claims launch sdpa_fwd and
    sdpa_bwd once each, and dq, dk, dv are bit for bit the eager autograd's
    through the same kernels (``ops.nn.scaled_dot_product_attention``: the
    same forward, cotangent and deterministic backward). Against an
    independent witness, the plain backward fed the kernel forward's own
    ``(out, lse)`` and the cotangent in the input dtype, row by row: 1e-4
    (float32) and 2e-2 (bf16) of each row's largest value, the bounds the
    kernel tests hold. Printed beside it, the error against the plain
    backward fed the plain forward's ``(out, lse)``: in bf16 the two
    forwards' ``out`` differ by bf16 rounding, and ``delta = rowsum(dO *
    out)`` carries that into the rows where ``dP - delta`` cancels. In
    float32 also against the same jit on the CPU, 1e-4 of a row."""
    import torch.nn.functional as F

    import thunder_tpu_torch as ptt

    gen = torch.Generator().manual_seed(7)
    q, k, v, g = (torch.randn(2, 4, 128, 64, generator=gen) for _ in range(4))
    q, k, v = (t.to(dtype) for t in (q, k, v))

    def f(q, k, v, g):
        return ptt.grad(lambda a, b, c: torch.sum(
            F.scaled_dot_product_attention(a, b, c, is_causal=True).float() * g),
            argnums=(0, 1, 2))(q, k, v)

    card = [t.cuda() for t in (q, k, v, g)]
    out, launches = _jit_launches(ptt.jit(f), *card)
    assert launches == {"sdpa_fwd": 1, "sdpa_bwd": 1}
    leaves = [t.clone().requires_grad_(True) for t in card[:3]]
    loss = torch.sum(tnn.scaled_dot_product_attention(*leaves, is_causal=True).float() * card[3])
    for a, b in zip(out, torch.autograd.grad(loss, leaves)):
        assert a.dtype == dtype and torch.equal(a, b)
    dout = card[3].to(dtype)
    kernel_fed = tnn.sdpa_bwd_plain(dout, *card[:3], *tnn.sdpa_fwd(*card[:3], True, None), True)
    plain_fed = tnn.sdpa_bwd_plain(dout, *card[:3], *tnn.sdpa_fwd_plain(*card[:3], True), True)
    errs = [row_rel_err(a, b) for a, b in zip(out, kernel_fed)]
    print(f"sdpa_bwd claim, {dtype}: dq/dk/dv against the plain backward fed the kernel "
          f"forward's (out, lse) {errs}, fed the plain forward's "
          f"{[row_rel_err(a, b) for a, b in zip(out, plain_fed)]} of their rows' largest values")
    assert max(errs) <= (1e-4 if dtype == torch.float32 else 2e-2)
    if dtype == torch.float32:
        for a, b in zip(out, ptt.jit(f, device="cpu")(q, k, v, g)):
            assert row_rel_err(a.cpu(), b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("donate", [True, False], ids=["donated", "copied"])
def test_cuda_jit_fused_adamw_claim_matches_cpu(cuda_device, donate):
    """AdamW.update under jit on a bf16 and a float32 bucket of two
    parameters each (the optimizer pass leaves a bucket of one as its
    adamw_step): one fused_adamw launch a bucket; donated inputs are
    written in place (the outputs are the inputs), others are not written;
    params and moments against the same jit on the CPU: 4 ULP of the stored
    dtype, the bound the per-step kernel tests hold."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.optim import AdamW, tree_leaves, tree_map

    gen = torch.Generator().manual_seed(8)
    params = {"a": torch.randn(300, 17, generator=gen).bfloat16(),
              "b": [torch.randn(33, generator=gen), torch.randn(5, 4, generator=gen).bfloat16(),
                    torch.randn(7, 3, generator=gen)]}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen).to(p.dtype), params)
    opt = AdamW(lr=1e-2)

    def step(p, s, g):
        return opt.update(p, g, s)

    cpu_p = tree_map(torch.clone, params)
    want_p, want_s = ptt.jit(step, device="cpu")(cpu_p, opt.init(cpu_p), grads)
    card_p = tree_map(lambda t: t.cuda(), params)
    card_s = opt.init(card_p)
    before = [t.clone() for t in tree_leaves((card_p, card_s))]
    jf = ptt.jit(step, donate_argnums=(0, 1) if donate else ())
    (got_p, got_s), launches = _jit_launches(jf, card_p, card_s, tree_map(torch.Tensor.cuda,
                                                                         grads))
    assert launches == {"fused_adamw": 2}
    written = [n is o for n, o in zip(tree_leaves((got_p, got_s["m"], got_s["v"])),
                                      tree_leaves((card_p, card_s["m"], card_s["v"])))]
    assert all(written) if donate else not any(written)
    if not donate:
        for a, b in zip(tree_leaves((card_p, card_s)), before):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves((got_p, got_s)), tree_leaves((want_p, want_s))):
        assert ulp_distance(a.cpu(), b) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_cuda_jit_train_step_matches_cpu(cuda_device, remat):
    """pretrain.jit_train_step on tiny-gqa float32 (4 layers, B=2, T=64),
    two steps on the card against the same on the CPU: every step launches
    exactly the trace's claims (the reference's per-op rows), the losses
    1e-5 relative."""
    from thunder_tpu_torch.benchmarks import pretrain
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.optim import AdamW, tree_map

    cfg = tllama.CONFIGS["tiny-gqa"]
    opt = AdamW(lr=1e-3)
    tok, tgt = (torch.from_numpy(a) for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 64, 0))
    cpu_p = tllama.init_params(cfg, seed=0, device="cpu")
    card_p = tree_map(torch.Tensor.cuda, cpu_p)
    cpu_s, card_s = opt.init(cpu_p), opt.init(card_p)
    cpu_step = pretrain.jit_train_step(cfg, opt, remat=remat)
    card_step = pretrain.jit_train_step(cfg, opt, remat=remat)
    L = cfg.n_layers
    want = ({"rms_norm": 3 * L + 1, "sdpa_fwd": 2 * L, "rms_norm_residual": L} if remat else
            {"rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L})
    want.update({"sdpa_bwd": L, "ce_fwd": 1, "fused_adamw": 1})
    for _ in range(2):
        cpu_loss, cpu_p, cpu_s = cpu_step(cpu_p, cpu_s, tok, tgt)
        (loss, card_p, card_s), launches = _jit_launches(card_step, card_p, card_s, tok.cuda(),
                                                         tgt.cuda())
        assert launches == want
        np.testing.assert_allclose(float(loss), float(cpu_loss), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,N,D,F", SUBBLOCK_SHAPES,
                         ids=[f"{str(d)[6:]}-{n}x{dd}x{f}" for d, n, dd, f in SUBBLOCK_SHAPES])
def test_cuda_jit_planner_sub_block_matches_eager_planned(cuda_device, dtype, N, D, F):
    """The planner on the card: ``jit(..., block_fusion=True)`` of the MLP
    sub-block chain in plain PyTorch (residual add, ``F.rms_norm``, the SwiGLU
    products, the residual add) under ``value_and_grad`` claims one
    ``mlp_subblock`` and one ``mlp_subblock_bwd``, and launches exactly
    those; against the eager planned rung (``ops.nn.mlp_subblock``, whose
    autograd runs the same two kernels) the output is bit for bit, and each
    gradient within 1e-4 (float32) or 2e-2 (bf16) of each row's largest
    value, the kernel tests' bounds (the two programs hand the backward
    kernel the same cotangent, but the trace adds the residual's and x's
    shares of ``dh`` as its own ops)."""
    import torch.nn.functional as Fn

    import thunder_tpu_torch as ptt

    gen = torch.Generator(device=cuda_device).manual_seed(21)
    g, r, x, wn, wg, wu, wd = _subblock_inputs(gen, cuda_device, dtype, N, D, F)
    g = g.float()

    def chain(r, x, wn, wg, wu, wd):
        h = r + x
        n = Fn.rms_norm(h, (D,), wn, EPS)
        return h + Fn.linear(Fn.silu(Fn.linear(n, wg)) * Fn.linear(n, wu), wd)

    def f(r, x, wn, wg, wu, wd, g):
        def loss(*ws):
            out = chain(*ws)
            return torch.sum(out.float() * g), out

        (_, out), grads = ptt.value_and_grad(loss, argnums=(0, 1, 2, 3, 4, 5),
                                             has_aux=True)(r, x, wn, wg, wu, wd)
        return out, grads

    jf = ptt.jit(f, block_fusion=True)
    (out, grads), launches = _jit_launches(jf, r, x, wn, wg, wu, wd, g)
    assert launches == {"mlp_subblock": 1, "mlp_subblock_bwd": 1}
    assert [d["decision"] for d in ptt.compile_stats(jf).last_decisions
            if d["kind"] == "block"] == ["planned"]
    leaves = [t.clone().requires_grad_(True) for t in (r, x, wn, wg, wu, wd)]
    want = tnn.mlp_subblock(*leaves, act="silu", eps=EPS)
    want_grads = torch.autograd.grad(torch.sum(want.float() * g), leaves)
    assert torch.equal(out, want.detach())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    errs = [row_rel_err(a, b) for a, b in zip(grads, want_grads)]
    print(f"planner sub-block {dtype}: gradients {errs} of their rows' largest values, bit "
          f"for bit {[torch.equal(a, b) for a, b in zip(grads, want_grads)]}")
    assert max(errs) <= tol


# ---------------------------------------------------------------------------
# jit(nn.Module): the torch-autograd bridge on the card
# ---------------------------------------------------------------------------

def _bridge_launches(fn):
    """``fn()`` with the launch counts set to 0 just before it and read just
    after."""
    torch.cuda.synchronize()
    cudaex.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n for k, n in cudaex.launch_counts().items() if n}


@pytest.mark.cuda
def test_cuda_module_bridge_launches_and_matches_cpu(cuda_device):
    """``testing.PlainLlama`` on tiny-gqa (float32, 2 layers) through
    ``jit(module)``: the bridge's forward launches exactly its trace's claims
    (rms_norm 1, sdpa_fwd L, rms_norm_residual 2L, ce_fwd 1), its backward
    sdpa_bwd L, the grad-free call rms_norm 1, sdpa_fwd L, rms_norm_residual
    2L, linear_act L, ce_fwd 1; the loss within 1e-5 relative and every
    gradient within 1e-4 of each leaf's largest magnitude of the same
    module's bridge on the CPU (the kernels sum in other orders)."""
    import copy

    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.testing import PlainLlama, claimed_kernels

    cfg = tllama.CONFIGS["tiny-gqa"]
    L = 2
    cpu_mod = PlainLlama.from_llama_params(cfg, tllama.init_params(cfg, seed=0, device="cpu",
                                                                     n_layers=L))
    card_mod = copy.deepcopy(cpu_mod).cuda()
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    tgt = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    want = ptt.jit(cpu_mod, device="cpu")(tok, tgt)
    want.backward()
    tm = ptt.jit(card_mod)
    tok_c, tgt_c = tok.cuda(), tgt.cuda()
    tm(tok_c, tgt_c)   # compile
    step = next(iter(tm._autograd_cache.values()))
    loss, fwd = _bridge_launches(lambda: tm(tok_c, tgt_c))
    card_mod.zero_grad()
    _, bwd = _bridge_launches(loss.backward)
    assert fwd == claimed_kernels(step.fwd_trace) == {
        "rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L, "ce_fwd": 1}
    assert bwd == claimed_kernels(step.bwd_trace) == {"sdpa_bwd": L}
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for (name, p), (_, q) in zip(card_mod.named_parameters(), cpu_mod.named_parameters()):
        scale = float(q.grad.abs().max())
        assert float((p.grad.cpu() - q.grad).abs().max()) <= 1e-4 * scale, name
    with torch.no_grad():
        tm(tok_c, tgt_c)
        ev, launches = _bridge_launches(lambda: tm(tok_c, tgt_c))
    assert launches == {"rms_norm": 1, "sdpa_fwd": L, "rms_norm_residual": 2 * L,
                        "linear_act": L, "ce_fwd": 1}
    np.testing.assert_allclose(float(ev), float(want), rtol=1e-5)


@pytest.mark.cuda
def test_cuda_function_bridge_launches(cuda_device):
    """``jit(plain_llama_layer)`` (bf16, D 256) with x and the weights
    requiring grad: ``backward()`` of ``out.float().square().mean()`` runs the
    compiled backward; the forward launches rms_norm 1, sdpa_fwd 1,
    rms_norm_residual 1, the backward sdpa_bwd 1; the gradients within 5e-2
    of each row's largest value of eager bf16 autograd's and of float32
    autograd's on the same inputs (bf16 eager autograd is itself 2e-2 off
    the float32 gradients of such a layer: chip_smoke.py's
    MODULE_GRAD_TOL)."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import plain_llama_layer

    gen = torch.Generator(device="cuda").manual_seed(5)
    Dm, Fd = 256, 512

    def dense(n_out, n_in):
        return (torch.randn(n_out, n_in, generator=gen, device="cuda") * n_in ** -0.5).to(
            torch.bfloat16)

    def norm_w():
        return (torch.rand(Dm, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)

    x = torch.randn(2, 64, Dm, generator=gen, device="cuda").to(torch.bfloat16)
    w = (norm_w(), dense(Dm, Dm), dense(128, Dm), dense(128, Dm), dense(Dm, Dm), norm_w(),
         dense(Fd, Dm), dense(Fd, Dm), dense(Dm, Fd))

    def layer(x, *w):
        return plain_llama_layer(x, *w, n_heads=4, n_kv=2)

    leaves = [t.clone().requires_grad_(True) for t in (x, *w)]
    eager = [t.clone().requires_grad_(True) for t in (x, *w)]
    jf = ptt.jit(layer)
    jf(*leaves)   # compile
    out, fwd = _bridge_launches(lambda: jf(*leaves))
    loss = out.float().square().mean()
    _, bwd = _bridge_launches(loss.backward)
    assert fwd == {"rms_norm": 1, "sdpa_fwd": 1, "rms_norm_residual": 1}
    assert bwd == {"sdpa_bwd": 1}
    layer(*eager).float().square().mean().backward()
    f32 = [t.detach().float().requires_grad_(True) for t in (x, *w)]
    layer(*f32).square().mean().backward()
    for a, b, c in zip(leaves, eager, f32):
        assert row_rel_err(a.grad, b.grad) <= 5e-2 and row_rel_err(a.grad, c.grad) <= 5e-2


@pytest.mark.cuda
def test_cuda_one_failed_source_stops_only_its_kernels(cuda_device, monkeypatch, tmp_path):
    """ROADMAP C.4 with the real nvcc: a copy of csrc/ whose decode_layer.cu
    does not compile, built into a temporary directory. Every other kernel
    binds and launches (attn_subblock, the other library of
    decode_layer.cuh, against its plain version); decode_layer's router
    raises its own build error, attributed to its claim (degradable), and
    once it is quarantined its router runs the sub-block rung's kernels on
    the card, whose output is the sub-block rung's plain version's."""
    import shutil

    from thunder_tpu_torch.runtime import faults, quarantine, retry

    csrc = tmp_path / "csrc"
    shutil.copytree(cudaex.CSRC, csrc)
    broken = csrc / "decode_layer.cu"
    broken.write_text(broken.read_text() + "\nstatic_assert(false, \"planted build failure\");\n")
    monkeypatch.setattr(cudaex, "CSRC", csrc)
    monkeypatch.setattr(cudaex, "BUILD_DIR", tmp_path / "build")
    for k in cudaex.KERNELS.values():
        monkeypatch.setattr(k, "fn", None)
        monkeypatch.setattr(k, "build_error", None)
    quarantine.reset()
    try:
        cudaex.build()
        failed = cudaex.build_failures()
        assert set(failed) == {"decode_layer"} and "planted build failure" in failed["decode_layer"]
        args, mlp = _decode_args(cuda_device, torch.bfloat16, list(DECODE_SHAPES)[0], seed=7)
        cudaex.reset_launch_counts()
        got = cudaex.attn_subblock(*args)
        want = tnn.attn_subblock_plain(*args)
        for a, b in zip(got, want):
            assert row_rel_err(a, b) <= 2e-2
        with pytest.raises(faults.KernelExecutionError) as ei:
            tnn.decode_layer(*[a.clone() for a in args], *mlp, act="silu")
        assert ei.value.claim_id == "cuda.decode_layer" and ei.value.phase == "build"
        assert retry.classify(ei.value) == retry.DEGRADABLE
        quarantine.get_quarantine().add("cuda.decode_layer", reason=repr(ei.value.__cause__))
        cudaex.reset_launch_counts()
        card = [a.clone() for a in args]
        out = tnn.decode_layer(*card, *mlp, act="silu")
        torch.cuda.synchronize()
        counts = {k: n for k, n in cudaex.launch_counts().items() if n}
        assert counts == {"attn_subblock": 1, "mlp_subblock": 1}, counts
        plain = [a.clone() for a in args]
        ref = tnn.decode_layer_subblocks(*[a.cpu() for a in plain], *[m.cpu() for m in mlp],
                                         act="silu")
        assert row_rel_err(out.cpu(), ref) <= 2e-2
    finally:
        quarantine.reset()


# ---------------------------------------------------------------------------
# the whole-program replay (executors/cudagraphex.py) and serving on jit
# ---------------------------------------------------------------------------

def _replay_pair(make, calls):
    """``calls`` calls of a fresh ``jit`` function per setting of
    ``whole_program_jit`` (``make(flag)`` builds the function, ``calls``
    takes it and returns a list of per-call results on the CPU), each call
    counted: ``{flag: (results, launches per call, claims, stats)}``."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import claimed_kernels

    out = {}
    for flag in (True, False):
        jf = make(flag)
        launches = []

        def counted(*args):
            torch.cuda.synchronize()
            cudaex.reset_launch_counts()
            res = jf(*args)
            torch.cuda.synchronize()
            launches.append({k: n for k, n in cudaex.launch_counts().items() if n})
            return res

        results = calls(counted)
        out[flag] = (results, launches, claimed_kernels(ptt.last_execution_trace(jf)),
                     ptt.compile_stats(jf))
    return out


def _equal_trees(a, b) -> bool:
    from thunder_tpu_torch.optim import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.cuda
def test_cuda_replay_forward_is_the_per_call_run(cuda_device):
    """jit(llama.forward), tiny-gqa bf16, 4 calls on other tokens each: with
    the replay (a warm-up call, a capture, two replays) the logits equal the
    per-call program's bit for bit, every call launches the trace's claims,
    and a later replay leaves an earlier call's logits as they were."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.optim import tree_map

    cfg = dataclasses.replace(tllama.CONFIGS["tiny-gqa"], dtype=torch.bfloat16)
    params = tree_map(lambda t: t.cuda(), tllama.init_params(cfg, seed=0, device="cpu"))
    gen = torch.Generator().manual_seed(9)
    batches = [torch.randint(0, cfg.vocab_size, (2, 48), generator=gen) for _ in range(4)]

    def calls(fn):
        outs = [fn(params, b.cuda()) for b in batches]
        first = outs[0].clone()
        return [o.cpu() for o in outs], torch.equal(first, outs[0])

    runs = _replay_pair(lambda flag: ptt.jit(lambda p, t: tllama.forward(p, t, cfg),
                                             whole_program_jit=flag), calls)
    (got, kept), launches, claims, stats = runs[True]
    (want, _), want_launches, _, off = runs[False]
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and kept
    assert launches == want_launches == [claims] * 4
    assert stats.last_whole_program == "graph" and off.last_whole_program.startswith("per-call")
    assert (stats.whole_program_captures, stats.whole_program_replays) == (1, 3)
    assert stats.whole_program_copied_bytes > 0     # the tokens, copied in each replay


@pytest.mark.cuda
def test_cuda_replay_train_step_is_the_per_call_run(cuda_device):
    """3 steps of pretrain.jit_train_step (tiny-gqa float32, the params and
    moments donated) with and without the replay: losses and parameters bit
    for bit; the donated state is written in place (its storage stays the
    caller's); then the same step on a copy of the state (new addresses)
    captures again, and its loss equals the per-call step's."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.benchmarks import pretrain
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.optim import AdamW, tree_leaves, tree_map

    cfg = tllama.CONFIGS["tiny-gqa"]
    opt = AdamW(lr=1e-3)
    tok, tgt = (torch.from_numpy(a).cuda()
                for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 64, 0))
    results = {}
    for flag in (True, False):
        p = tree_map(torch.Tensor.cuda, tllama.init_params(cfg, seed=0, device="cpu"))
        s = opt.init(p)
        ptrs = [t.data_ptr() for t in tree_leaves((p, s["m"], s["v"]))]
        step = pretrain.jit_train_step(cfg, opt, whole_program_jit=flag)
        losses = []
        for _ in range(3):
            loss, p, s = step(p, s, tok, tgt)
            losses.append(loss.clone())
        assert [t.data_ptr() for t in tree_leaves((p, s["m"], s["v"]))] == ptrs
        p2, s2 = tree_map(torch.clone, (p, s))
        loss2, _, _ = step(p2, s2, tok, tgt)
        results[flag] = (losses, tree_map(torch.clone, p), loss2, ptt.compile_stats(step))
    on, off = results[True], results[False]
    assert all(torch.equal(a, b) for a, b in zip(on[0], off[0]))
    assert _equal_trees(on[1], off[1])
    assert torch.equal(on[2], off[2])
    assert on[3].whole_program_captures == 2 and on[3].whole_program_recaptures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("block_fusion", [False, True], ids=["per-op", "planned"])
def test_cuda_replay_serving_decode_is_the_per_call_run(cuda_device, block_fusion):
    """The traced engine, tiny-gqa float32 on the card, with and without the
    replay: identical tokens, every decode step's logits bit for bit, each
    step's launches the bound program's claims (a replay counts what it
    runs); with the replay, later steps replay one graph."""
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.serving import ServingEngine
    from thunder_tpu_torch.testing import claimed_kernels

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32) for n in (1, 7, 16, 33)]
    out = {}
    for flag in (True, False):
        eng = ServingEngine(params, cfg, device="cuda", max_slots=3, page_size=8,
                            max_context=64, prefill_chunk=16, block_fusion=block_fusion,
                            whole_program_jit=flag)
        steps = []
        decode = eng.runner.decode

        def recorded(*args):
            torch.cuda.synchronize()
            cudaex.reset_launch_counts()
            toks, logits = decode(*args)
            torch.cuda.synchronize()
            steps.append((logits.clone(), {k: n for k, n in cudaex.launch_counts().items()
                                           if n}))
            return toks, logits

        eng.runner.decode = recorded
        reqs = [eng.submit(p, 6) for p in prompts]
        eng.drain()
        eng.assert_quiescent()
        claims = claimed_kernels(eng.runner._decode_bound.entry.traces[-1])
        assert all(c == claims for _, c in steps), (steps[0][1], claims)
        out[flag] = ([r.output().tolist() for r in reqs], [s[0] for s in steps],
                     eng.runner.decode_jit._stats.whole_program_replays)
    assert out[True][0] == out[False][0]
    assert len(out[True][1]) == len(out[False][1])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    assert out[True][2] == len(out[True][1]) - 1 and out[False][2] == 0


@pytest.mark.cuda
def test_cuda_quarantine_between_replays_reroutes(cuda_device):
    """A planned engine replaying its decode graph: quarantining
    ``cuda.decode_layer`` between steps re-binds the engine to a new compile
    whose steps launch the two sub-block kernels, and the tokens equal an
    engine that ran the sub-block rung throughout."""
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.runtime import quarantine
    from thunder_tpu_torch.serving import ServingEngine

    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 19)]
    kw = dict(device="cuda", max_slots=2, page_size=8, max_context=64, prefill_chunk=16,
              block_fusion=True)
    quarantine.reset()
    try:
        eng = ServingEngine(params, cfg, **kw)
        reqs = [eng.submit(p, 10) for p in prompts]
        for _ in range(8):
            eng.step()
        assert eng.runner.decode_jit._stats.whole_program_replays > 0
        quarantine.get_quarantine().add("cuda.decode_layer", reason="test")
        cudaex.reset_launch_counts()
        eng.drain()
        counts = cudaex.launch_counts()
        assert counts["decode_layer"] == 0 and counts["attn_subblock"] > 0, counts
        assert eng.decode_rebinds == 1
        ref = ServingEngine(params, cfg, **kw)
        ref_reqs = [ref.submit(p, 10) for p in prompts]
        ref.drain()
        assert [r.output().tolist() for r in reqs] == [r.output().tolist() for r in ref_reqs]
    finally:
        quarantine.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged_decode_attention", "attn_subblock", "decode_layer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_claims_match_routers(cuda_device, kernel, dtype):
    """paged_decode_attention, attn_subblock and decode_layer through their
    jit claims (a function calling the router, traced: the pools it writes
    are returned) equal the routers' eager calls bit for bit, outputs and
    written pools, and each launches its kernel once."""
    import thunder_tpu_torch as ptt

    args, mlp = _decode_args(cuda_device, dtype, "8-slot-hd128", seed=11)
    if kernel == "paged_decode_attention":
        S, D, H, KV, hd = DECODE_SHAPES["8-slot-hd128"][:5]
        gen = torch.Generator(device=cuda_device).manual_seed(12)
        q = torch.randn(S, H, 1, hd, generator=gen, device=cuda_device).to(dtype)
        inputs = (q, args[8], args[9], args[10], args[11])

        def fn(q, kp, vp, bt, ln):
            return tnn.paged_decode_attention(q, kp, vp, bt, ln), kp, vp
    else:
        inputs = args + (mlp if kernel == "decode_layer" else ())
        router = getattr(tnn, kernel)

        def fn(*a):
            return router(*a), a[8], a[9]
    eager_in = [t.clone() for t in inputs]
    want = fn(*eager_in)
    jf = ptt.jit(fn, donate_argnums=(1, 2) if kernel == "paged_decode_attention" else (8, 9))
    out, launches = _jit_launches(jf, *[t.clone() for t in inputs])
    assert launches == {kernel: 1}
    for a, b in zip(out, want):
        assert torch.equal(a, b)


def _adamw_bucket(dev, slab: bool, seed: int = 21):
    """A bf16 bucket of odd sizes (7, 13, 4099), f32 moments, per-step or
    in slabs, with grads: ``(opt, params, grads, state)``."""
    from thunder_tpu_torch.optim import AdamW

    gen = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn(7, generator=gen).bfloat16(),
              "b": [torch.randn(13, generator=gen).bfloat16(),
                    torch.randn(4099, generator=gen).bfloat16()]}
    params = {"a": params["a"].to(dev), "b": [t.to(dev) for t in params["b"]]}
    grads = {"a": torch.randn(7, generator=gen).bfloat16().to(dev),
             "b": [torch.randn(13, generator=gen).bfloat16().to(dev),
                   torch.randn(4099, generator=gen).bfloat16().to(dev)]}
    opt = AdamW(lr=1e-2, slab_persistent=slab)
    state = opt.init(params)
    # a first eager step, so that the moments are not zero
    opt.update(params, grads, state)
    return opt, params, grads, state


@pytest.mark.cuda
@pytest.mark.parametrize("slab", [False, True], ids=["per-step", "slab"])
@pytest.mark.parametrize("plant", [None, "nan"], ids=["healthy", "nan-grad"])
def test_cuda_jit_slab_health_and_gated_claims_match_eager(cuda_device, slab, plant):
    """The slab update, the health pass and the gated update through their
    ``jit`` claims (``AdamW.health`` and ``AdamW.update(health=)`` traced,
    the params and state donated) against the eager kernels on copies of
    the same values, bit for bit: the health word, the params, the moments
    (or slabs) and the counter; one launch of each kernel. A NaN planted in
    a grad leaves both unchanged. Then the ungated traced slab update
    against the eager one."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.optim import tree_leaves, tree_map

    opt, params, grads, state = _adamw_bucket(cuda_device, slab)
    if plant:
        grads["b"][1][17] = float("nan")
    loss = torch.tensor(2.5, device=cuda_device)
    ep, es = tree_map(torch.clone, (params, state))
    eword = opt.health(ep, grads, es, loss)
    opt.update(ep, grads, es, health=eword)

    def step(p, s, g, value):
        word = opt.health(p, g, s, value)
        return (*opt.update(p, g, s, health=word), word)

    jf = ptt.jit(step, donate_argnums=(0, 1))
    (p, s, word), launches = _jit_launches(jf, params, state, grads, loss)
    update = "fused_adamw_slab" if slab else "fused_adamw"
    assert launches == {update: 1, f"{update}_health": 1}
    assert torch.allclose(word, eword, rtol=0, atol=0, equal_nan=True)   # a NaN norm planted
    assert _equal_trees((p, s), (ep, es))
    if not slab:
        return
    opt2, p2, g2, s2 = _adamw_bucket(cuda_device, True, seed=22)
    ep2, es2 = tree_map(torch.clone, (p2, s2))
    opt2.update(ep2, g2, es2)
    (got_p, got_s), launches = _jit_launches(
        ptt.jit(lambda p, s, g: opt2.update(p, g, s), donate_argnums=(0, 1)), p2, s2, g2)
    assert launches == {"fused_adamw_slab": 1}
    assert _equal_trees((got_p, got_s), (ep2, es2))
    assert all(a is b for a, b in zip(tree_leaves((got_p, got_s["m"], got_s["v"])),
                                      tree_leaves((p2, s2["m"], s2["v"]))))


@pytest.mark.cuda
@pytest.mark.parametrize("slab", [False, True], ids=["per-step", "slab"])
def test_cuda_guarded_compiled_step_runs_as_a_graph(cuda_device, slab):
    """The tiny-gqa float32 step compiled with ``NumericsGuardTransform``
    (4 steps, the third ``numerics:grads``-poisoned): the entry replays one
    CUDA graph captured once, copying 8 bytes of poison (and the 4-byte
    counter) a replay; every step launches the trace's claims, the health pass and the
    gated update once each; the losses equal the unguarded compiled step's
    bit for bit, the poisoned step leaves the state bit-identical."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.benchmarks import pretrain
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.optim import AdamW, tree_leaves, tree_map
    from thunder_tpu_torch.runtime import faults
    from thunder_tpu_torch.transforms import NumericsGuardTransform

    cfg = tllama.CONFIGS["tiny-gqa"]
    opt = AdamW(lr=1e-3, slab_persistent=slab)
    tok, tgt = (torch.from_numpy(a).cuda()
                for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 64, 0))
    guard = NumericsGuardTransform()
    runs = {}
    for name, transforms in (("guarded", [guard]), ("plain", [])):
        p = tree_map(torch.Tensor.cuda, tllama.init_params(cfg, seed=0, device="cpu"))
        s = opt.init(p)
        step = pretrain.jit_train_step(cfg, opt, transforms=transforms, block_fusion=False)
        losses, same = [], None
        for i in range(4):
            poison = name == "guarded" and i == 2
            before = [t.clone() for t in tree_leaves((p, s))] if poison else None
            plan = faults.FaultPlan([faults.FaultSpec("numerics:grads", at_steps={3})])
            with faults.active(plan if poison else None):
                (loss, p, s), launches = _jit_launches(step, p, s, tok, tgt)
            if poison:
                same = all(torch.equal(a, b) for a, b in zip(before, tree_leaves((p, s))))
            else:
                losses.append(loss.clone())
        runs[name] = (losses, launches, ptt.compile_stats(step), same)
    losses, launches, stats, same = runs["guarded"]
    update = "fused_adamw_slab" if slab else "fused_adamw"
    assert launches[update] == launches[f"{update}_health"] == 1
    assert stats.last_whole_program == "graph" and same
    assert guard.sentinel.skipped_steps == 1
    # one entry (a plan of numerics:grads is no part of the key) and one
    # capture (the slabs' layout version comes back as the input it is):
    # each replay copies in the two poison scalars and the step counter
    assert stats.cache_misses == 1 and stats.whole_program_captures == 1
    assert stats.whole_program_copied_bytes == stats.whole_program_replays * 12
    plain = runs["plain"][0]
    assert all(torch.equal(a, b) for a, b in zip(losses[:2], plain[:2]))


# ---------------------------------------------------------------------------
# the region executor's generated kernels (executors/regionex.py)
# ---------------------------------------------------------------------------

def _region_programs(device, dtype):
    """The regions of tiny-gqa's compiled train step (2 layers, plain and
    remat) and of the traced engine's per-op decode step, at ``dtype``, with
    their inputs on the card: ``{"train": [...], "train-remat": [...],
    "decode": [...]}``."""
    import dataclasses

    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.benchmarks import pretrain
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.optim import AdamW, tree_map
    from thunder_tpu_torch.serving import ServingEngine
    from thunder_tpu_torch.testing import regions_of

    cfg = dataclasses.replace(tllama.CONFIGS["tiny-gqa"], dtype=dtype)
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=2)
    opt = AdamW(lr=1e-3)
    tok, tgt = (torch.from_numpy(a).to(device)
                for a in pretrain.synthetic_batch(cfg.vocab_size, 2, 64, 0))
    out = {}
    for name, remat in (("train", False), ("train-remat", True)):
        p = tree_map(lambda t: t.to(device), params)
        step = pretrain.jit_train_step(cfg, opt, remat=remat)
        step.compile(p, opt.init(p), tok, tgt)
        out[name] = regions_of(ptt.last_execution_trace(step))
    eng = ServingEngine(params, cfg, device=device.type, max_slots=3, page_size=8,
                        max_context=64, prefill_chunk=16, block_fusion=False)
    eng.submit(np.arange(1, 10, dtype=np.int32), 2)
    eng.drain()
    out["decode"] = regions_of(eng.runner._decode_bound.entry.traces[-1])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_cuda_regions_match_their_plain_chains(cuda_device, dtype):
    """Every region of the train step and of the decode step, on random
    inputs (dense, then every input strided), against its plain chain on
    the same inputs: arithmetic-only regions bit for bit, regions with a
    transcendental op within 1 ulp of the output dtype; each launch counts
    one ``region``."""
    from thunder_tpu_torch.testing import hold_region, region_inputs

    progs = _region_programs(cuda_device, dtype)
    assert all(progs.values()), {k: len(v) for k, v in progs.items()}
    gen = torch.Generator().manual_seed(0)
    for name, regions in progs.items():
        for r in regions:
            for strided in (False, True):
                vals = region_inputs(r, gen, cuda_device, strided=strided)
                cudaex.reset_launch_counts()
                held = hold_region(r, vals)
                torch.cuda.synchronize()
                assert held["ok"], (name, r.name, strided, held, r.spec.source)
                assert cudaex.launch_counts()["region"] == 1


@pytest.mark.cuda
def test_cuda_region_that_fails_to_build_raises(cuda_device, monkeypatch, tmp_path):
    """Two regions of one program, one with a planted compile error: the
    program's one nvcc fails, each region is built alone, the good one
    launches, the bad one raises ``KernelBuildError`` naming it at its first
    launch (its log in ``cudaex.build_failures()``), and nothing runs in
    its place."""
    import dataclasses

    from thunder_tpu_torch.executors import regionex
    from thunder_tpu_torch.runtime.faults import KernelBuildError
    from thunder_tpu_torch.testing import region_inputs

    monkeypatch.setattr(regionex, "_bound", {})
    monkeypatch.setattr(regionex, "_failures", {})
    monkeypatch.setattr(cudaex, "BUILD_DIR", tmp_path / "build")
    good, bad = _region_programs(cuda_device, torch.float32)["train"][:2]
    # an entry of its own: the engine's run above may have bound the original
    entry = bad.spec.entry + "_planted"
    planted = (bad.spec.source.replace(bad.spec.entry, entry)
               + "\nstatic_assert(false, \"planted region failure\");\n")
    spec = dataclasses.replace(bad.spec, source=planted, entry=entry)
    monkeypatch.setattr(bad, "spec", spec)
    monkeypatch.setattr(bad, "program", [good, bad])
    monkeypatch.setattr(good, "program", [good, bad])
    gen = torch.Generator().manual_seed(1)
    with pytest.raises(KernelBuildError, match="planted region failure") as ei:
        bad(*region_inputs(bad, gen, cuda_device))
    assert ei.value.kernel == "region"
    assert f"region:{spec.entry}" in cudaex.build_failures()
    out = good(*region_inputs(good, gen, cuda_device))
    torch.cuda.synchronize()
    assert all(o.is_cuda for o in out)


@pytest.mark.cuda
@pytest.mark.parametrize("replay", [False, True], ids=["per-call", "replay"])
def test_cuda_region_launches_equal_the_trace_regions(cuda_device, replay):
    """tiny-gqa's compiled train step (float32, 2 layers): each call
    launches one ``region`` kernel per region of its execution trace, the
    trace's claims and the launches equal (a replay counts what it runs)."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.benchmarks import pretrain
    from thunder_tpu_torch.models import llama as tllama
    from thunder_tpu_torch.optim import AdamW, tree_map
    from thunder_tpu_torch.testing import claimed_kernels, jit_launches, regions_of

    cfg = tllama.CONFIGS["tiny-gqa"]
    opt = AdamW(lr=1e-3)
    p = tree_map(torch.Tensor.cuda, tllama.init_params(cfg, seed=0, device="cpu", n_layers=2))
    s = opt.init(p)
    tok, tgt = (torch.from_numpy(a).cuda() for a in pretrain.synthetic_batch(cfg.vocab_size, 2,
                                                                              64, 0))
    step = pretrain.jit_train_step(cfg, opt, whole_program_jit=replay)
    for _ in range(3):
        (loss, p, s), launches, claims = jit_launches(step, p, s, tok, tgt)
        n = len(regions_of(ptt.last_execution_trace(step)))
        assert n > 0 and launches["region"] == claims["region"] == n
        assert launches == claims
    assert claimed_kernels(ptt.last_execution_trace(step))["region"] == n


# ---------------------------------------------------------------------------
# regions with row reductions (executors/regionex.py reduce_source)
#
# Bounds: amax, amin, argmax and argmin bit for bit (ties go to the lowest
# index, a NaN is the extreme, as torch documents); integer sums exactly,
# and float sums of integer values (every partial sum exact) too; each
# other float sum within g sum|x_i| of the exact sum (float64), g = d u /
# (1 - d u), u = 2**-24 and d the roundings a summand goes through in the
# kernel's order (``regionex.sum_depth``: its thread's columns, two shuffle
# trees of 5 levels, the cluster's partials; 32 at (8, 128256), 25 at
# (512, 4096)), plus one ulp of a 16-bit result (it rounds once); an output
# computed from a sum within the plain chain's own move when each sum is
# set to either end of that bound, plus 1 ulp of its dtype where the region
# holds a transcendental op, and every integer or bool output equal, none
# left unheld (``testing.hold_region``). Two launches on the same inputs
# bit for bit.
# ---------------------------------------------------------------------------

def _reduce_region(fn, *args):
    """``jit(fn)`` run on ``args`` (on the card): its output, the eager
    ``fn``'s on the same inputs, and its one region with row reductions."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import regions_of

    jf = ptt.jit(fn)
    got = jf(*args)
    rs = [r for r in regions_of(ptt.last_execution_trace(jf)) if r.spec.rows is not None]
    assert len(rs) == 1, [r.spec.rows for r in regions_of(ptt.last_execution_trace(jf))]
    return got, fn(*args), rs[0]


def _ties(gen, shape, device, dtype):
    """Small integers as ``dtype`` (every row full of equal values), with a
    NaN planted in every fourth row of a float dtype."""
    x = torch.randint(-3, 4, shape, generator=gen).to(dtype)
    if dtype.is_floating_point:
        x.view(-1, shape[-1])[::4, shape[-1] // 3] = float("nan")
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64, torch.int64,
                                   torch.int32], ids=["f32", "bf16", "f64", "i64", "i32"])
@pytest.mark.parametrize("shape", [(8, 96), (3, 70001), (2, 5, 33)],
                         ids=["short", "long-row", "rank3"])
def test_cuda_region_extremes_bit_for_bit(cuda_device, dtype, shape):
    """amax, amin, argmax and argmin over the last dim in one region, on
    rows full of ties (and NaNs in floats): bit for bit against torch's,
    the lowest index among equal extremes; a row longer than 65,536; two
    launches the same; the launch on the ``reduce`` design."""
    gen = torch.Generator().manual_seed(7)
    x = _ties(gen, shape, cuda_device, dtype)

    def fn(x):
        y = x * 1
        return torch.amax(y, -1), torch.amin(y, -1), torch.argmax(y, -1), torch.argmin(y, -1)

    got, want, region = _reduce_region(fn, x)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.nan_to_num(0.5), w.nan_to_num(0.5)), (g, w)
    before = cudaex.design_counts().get("region", {}).get("reduce", 0)
    again = region(x)
    assert cudaex.design_counts()["region"]["reduce"] == before + 1
    assert all(torch.equal(a.nan_to_num(0.5), b.nan_to_num(0.5))
               for a, b in zip(again, region(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["normal", "integer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(8, 128256), (512, 4096), (4, 3, 77)],
                         ids=["sampler-rows", "norm-rows", "two-dims"])
def test_cuda_region_sums_within_their_bound(cuda_device, dtype, shape, values):
    """A float sum over the trailing dims (the last two for rank 3), a mean
    and a softmax-style chain from it, in one region: the sum within the
    stated bound of the exact sum in the kernel's order, and exactly the
    exact sum on integer values; every output within the stated bound of
    the plain chain (``hold_region``); two launches bit for bit."""
    from thunder_tpu_torch.testing import hold_region, region_sum_depth, sum_bound

    gen = torch.Generator().manual_seed(11)
    if values == "integer":
        x = torch.randint(-4, 5, shape, generator=gen).to(dtype).to(cuda_device)
    else:
        x = torch.randn(shape, generator=gen).to(dtype).to(cuda_device)
    dims = (-2, -1) if len(shape) == 3 else (-1,)

    def fn(x):
        s = torch.sum(x * 2, dims, keepdim=True)
        return s, torch.exp(x - s / x[0].numel()) / s

    got, want, region = _reduce_region(fn, x)
    x2 = (x * 2).float()
    exact = torch.sum(x2.double(), dims, keepdim=True)
    depth = region_sum_depth(region, [x])
    assert depth == (32 if shape == (8, 128256) else 25 if shape == (512, 4096) else 10)
    if values == "integer":
        assert torch.equal(got[0], exact.to(dtype))
    bound = sum_bound(x2, dims, depth).reshape(exact.shape) + sum_bound(
        x2.double(), dims).reshape(exact.shape)
    err = (got[0].double() - exact).abs()
    one = torch.finfo(dtype).eps * exact.abs() if dtype != torch.float32 else 0
    assert bool((err <= bound + one).all()), float((err - bound - one).max())
    held = hold_region(region, [x])
    assert held["ok"], held
    a, b = region(x), region(x)
    assert all(torch.equal(p.nan_to_num(0.5), q.nan_to_num(0.5)) for p, q in zip(a, b))


@pytest.mark.cuda
def test_cuda_region_norms_and_sampler_rows_within_bounds(cuda_device):
    """The reductions of a traced rms_norm with the claims' gate turning it
    down (bf16, 8 and 16384 rows of 4096) and of the sampler's top-k/top-p
    bisection (float32, 8 rows of 128,256): each program's regions with
    reductions held within the stated bounds on random and on
    integer-valued inputs, two launches bit for bit."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.core import cost_model
    from thunder_tpu_torch.serving.sampling import sample_tokens
    from thunder_tpu_torch.testing import hold_region, region_inputs, regions_of

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    saved = cost_model.MIN_CLAIM_BYTES
    cost_model.MIN_CLAIM_BYTES = float("inf")
    try:
        progs = []
        for n in (8, 16384):
            x = torch.randn(n, 4096, device=cuda_device).to(torch.bfloat16)
            w = torch.rand(4096, device=cuda_device).to(torch.bfloat16)
            jf = ptt.jit(lambda x, w: tnn.rms_norm(x, w, 1e-5))
            jf.compile(x, w)
            progs.append(ptt.last_execution_trace(jf))
    finally:
        cost_model.MIN_CLAIM_BYTES = saved
    S, V = 8, 128256
    args = (torch.randn(S, V, device=cuda_device), torch.full((S,), 0.8, device=cuda_device),
            torch.full((S,), 50, dtype=torch.int32, device=cuda_device),
            torch.full((S,), 0.9, device=cuda_device),
            torch.randint(0, 1 << 30, (S, 2), dtype=torch.int32, device=cuda_device))
    jf = ptt.jit(sample_tokens)
    tokens = jf(*args)
    progs.append(ptt.last_execution_trace(jf))
    assert tokens.shape == (S,) and bool(((tokens >= 0) & (tokens < V)).all())
    held = 0
    for trc in progs:
        for r in regions_of(trc):
            if r.spec.rows is None:
                continue
            vals = region_inputs(r, gen, cuda_device)
            h = hold_region(r, vals)
            assert h["ok"], (r.name, h)
            hi = hold_region(r, region_inputs(r, gen, cuda_device, integer=True))
            assert hi["ok"], (r.name, hi)
            a, b = r(*vals), r(*vals)
            assert all(torch.equal(p, q) for p, q in zip(a, b))
            held += 1
    assert held >= 3


@pytest.mark.cuda
def test_cuda_region_reduction_with_64_bit_indices(cuda_device):
    """A row space past 2**31 elements (32,768 rows of 65,540 int8 values):
    the launch takes 64-bit indices, and its integer sums equal torch's."""
    x = torch.randint(-100, 100, (32768, 65540), dtype=torch.int8, device=cuda_device)
    got, want, region = _reduce_region(lambda x: torch.sum(x + 1, -1), x)
    assert torch.equal(got, want) and got.dtype == torch.int64
    del x


@pytest.mark.cuda
def test_cuda_region_reduction_strided_and_broadcast(cuda_device):
    """A row reduction over a strided input and a broadcast weight (the
    norm's statistics over every other column, times a (D,) weight) within
    its bound (``hold_region``), for dense and strided inputs."""
    from thunder_tpu_torch.testing import hold_region, region_inputs

    x = torch.randn(64, 2 * 1000, device=cuda_device)[:, ::2]
    w = torch.rand(1000, device=cuda_device)
    got, want, region = _reduce_region(
        lambda x, w: x * w * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-5), x, w)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for strided in (False, True):
        h = hold_region(region, region_inputs(region, gen, cuda_device, strided=strided))
        assert h["ok"], (strided, h)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_region_cluster_launch_replays_in_a_graph(cuda_device):
    """The sampler's region (8 rows of 128,256: its rows split across
    clusters) inside a ``jit`` entry's CUDA graph: the captured and the
    replayed calls give the per-call call's tokens bit for bit, and each
    replay counts the region's launches."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.executors import regionex
    from thunder_tpu_torch.serving.sampling import sample_tokens
    from thunder_tpu_torch.testing import regions_of

    S, V = 8, 128256
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    args = (torch.randn(S, V, device=cuda_device, generator=gen),
            torch.full((S,), 0.8, device=cuda_device),
            torch.full((S,), 50, dtype=torch.int32, device=cuda_device),
            torch.full((S,), 0.9, device=cuda_device),
            torch.randint(0, 1 << 30, (S, 2), dtype=torch.int32, device=cuda_device,
                          generator=gen))
    per_call = ptt.jit(sample_tokens, whole_program_jit=False)(*args)
    jf = ptt.jit(sample_tokens)
    regions = None
    for _ in range(3):          # per call, the capture, a replay
        cudaex.reset_launch_counts()
        got = jf(*args)
        torch.cuda.synchronize()
        regions = regions_of(ptt.last_execution_trace(jf))
        assert torch.equal(got, per_call)
        assert cudaex.launch_counts()["region"] == len(regions)
    assert ptt.compile_stats(jf).whole_program_replays >= 1
    (big,) = [r for r in regions if r.spec.rows]
    assert regionex.row_launch(S, V, torch.cuda.get_device_properties(0).multi_processor_count
                               )[0] > 1
    assert big.spec.rows == ((S, V), 1)


# ---------------------------------------------------------------------------
# reductions over any dims (executors/regionex.py column_source, the row
# design's column sums and its shared-memory rows)
#
# Bounds as above, each sum in its own kernel order
# (``regionex.sum_depths``): a column-design sum its thread's share of the
# reduced elements, the tree down the tile's thread rows and the cluster's
# partials; a row space's column sum its CTA's rows, then the finishing
# pass's trees over the partials; a float ``prod`` within (n - 1) u /
# (1 - (n - 1) u) of the exact product's magnitude in any order
# (``testing.prod_bound``), integer products exactly; amax and amin bit for
# bit. Two launches on the same inputs bit for bit.
# ---------------------------------------------------------------------------

def _one_region(fn, *args):
    """``jit(fn)`` run on ``args`` (on the card): its output and its one
    region with reductions."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import regions_of

    jf = ptt.jit(fn)
    got = jf(*args)
    rs = [r for r in regions_of(ptt.last_execution_trace(jf)) if r.spec.design != "elementwise"]
    assert len(rs) == 1, [r.spec.design for r in regions_of(ptt.last_execution_trace(jf))]
    return got, rs[0]


def _design_count(design: str) -> int:
    return cudaex.design_counts().get("region", {}).get(design, 0)


_COLUMN_CASES = {
    # name: (shape, dims) -- a leading dim, the GQA group sum's middle dim,
    # every kept dim of a norm's rows, dims around a kept one, a long leading
    # extent that fills too few tiles (split across a cluster)
    "leading": ((512, 4096), (0,)),
    "gqa-middle": ((2, 8, 4, 512, 128), (2,)),
    "all-leading": ((8, 64, 1024), (0, 1)),
    "outer-and-last": ((16, 8, 64), (0, 2)),
    "long-few-tiles": ((65536, 64), (0,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["normal", "integer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32],
                         ids=["f32", "bf16", "i32"])
@pytest.mark.parametrize("case", list(_COLUMN_CASES))
def test_cuda_region_column_reductions_within_their_bound(cuda_device, case, dtype, values):
    """``sum``, ``amax`` and ``amin`` over leading, middle and all-but-last
    dims in one region of the column design: the sum within its bound of
    the exact sum in the kernel's order (exact on integer values), the
    extremes bit for bit against torch's, every output held
    (``hold_region``), two launches bit for bit, each launch counted under
    ``column``."""
    from thunder_tpu_torch.testing import hold_region, region_inputs

    shape, dims = _COLUMN_CASES[case]
    gen = torch.Generator().manual_seed(13)
    if dtype == torch.int32 or values == "integer":
        x = torch.randint(-4, 5, shape, generator=gen).to(dtype).to(cuda_device)
    else:
        x = torch.randn(shape, generator=gen).to(dtype).to(cuda_device)

    def fn(x):
        y = x * 2
        return torch.sum(y, dims), torch.amax(y, dims), torch.amin(y, dims)

    got, region = _one_region(fn, x)
    assert region.spec.design == "column" and region.spec.cols[1] == dims
    want = fn(x)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    if dtype == torch.int32 or values == "integer":
        assert torch.equal(got[0], torch.sum((x * 2).double(), dims).to(got[0].dtype))
    for vals in ([x], region_inputs(region, torch.Generator(device=cuda_device).manual_seed(2),
                                    cuda_device, strided=True)):
        held = hold_region(region, vals)
        assert held["ok"], held
    before = _design_count("column")
    a, b = region(x), region(x)
    assert _design_count("column") == before + 2
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64],
                         ids=["f32", "bf16", "i64"])
@pytest.mark.parametrize("dims", [(-1,), (0,), (1,), (0, 1, 2)],
                         ids=["trailing", "leading", "middle", "all"])
def test_cuda_region_prods_within_their_bound(cuda_device, dims, dtype):
    """``prod`` over trailing (the row design), leading, middle and all
    dims: float products within their relative bound of the exact product,
    integer products (int64, wrapping as torch's) equal to torch's; two
    launches bit for bit."""
    from thunder_tpu_torch.testing import hold_region

    gen = torch.Generator().manual_seed(17)
    shape = (6, 5, 7)
    if dtype == torch.int64:
        x = torch.randint(-3, 4, shape, generator=gen).to(cuda_device)
    else:
        x = (1 + 0.25 * torch.randn(shape, generator=gen)).to(dtype).to(cuda_device)

    def fn(x):
        return torch.prod(x * 1, dims[0]) if len(dims) == 1 else torch.prod(x * 1)

    got, region = _one_region(fn, x)
    if dtype == torch.int64:
        assert torch.equal(got, fn(x))
    held = hold_region(region, [x])
    assert held["ok"], held
    a, b = region(x), region(x)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def _norm_backward(x, g, w):
    """An rms_norm's backward as the traced train step computes it: the
    input gradient from the row sums, the weight gradient as the column
    sum over every row."""
    xf, gf = x.float(), g.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-5)
    xh = xf * rstd
    gx = gf * w.float()
    dx = rstd * (gx - xh * torch.mean(gx * xh, -1, keepdim=True))
    return dx.to(x.dtype), torch.sum(gf * xh, (0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 2048, 4096), (1, 8, 4096), (2, 3, 100)],
                         ids=["train-rows", "decode-rows", "odd"])
def test_cuda_region_norm_backward_with_its_column_sum(cuda_device, shape, dtype):
    """A norm backward's row space with the weight gradient's column sum
    in it (design ``smem_partials`` or ``reduce_partials``: the rows staged
    in shared memory or read again each pass, as ``regionex.row_plan``
    picks, the column sum as partials of row groups and a tree): held
    within the stated bounds (the column sum at
    ``regionex.partials_depth``) on random and integer-valued inputs, two
    launches bit for bit, the product of the column sum not written."""
    from thunder_tpu_torch.executors import regionex
    from thunder_tpu_torch.testing import hold_region, region_inputs

    gen = torch.Generator(device=cuda_device).manual_seed(19)
    x, g = (torch.randn(shape, device=cuda_device, generator=gen).to(dtype) for _ in range(2))
    w = (torch.rand(shape[-1], device=cuda_device, generator=gen) + 0.5).to(dtype)
    got, region = _one_region(_norm_backward, x, g, w)
    S, r = region.spec.rows
    assert len(region.spec.col_sums) == 1 and len(region.outputs) == 2
    assert [tuple(o.shape) for o in region.outputs if tuple(o.shape) == S] == [S]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, R = regionex.space_sizes(region.spec)
    design = regionex.row_plan(region.spec, rows, R, sms)["design"]
    assert design in ("smem_partials", "reduce_partials")
    before = _design_count(design)
    for integer in (False, True):
        held = hold_region(region, region_inputs(region, gen, cuda_device, integer=integer))
        assert held["ok"], (integer, held)
    assert _design_count(design) == before + 2
    depths = regionex.sum_depths(region, sms)
    assert depths == [regionex.sum_depth(rows, R, sms)] * 2 + [
        regionex.partials_depth(rows, regionex.row_plan(region.spec, rows, R, sms))]
    vals = region_inputs(region, gen, cuda_device)
    a, b = region(*vals), region(*vals)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sampler-rows", "norm-rows"])
def test_cuda_region_smem_and_reduce_designs_agree(cuda_device, case):
    """A softmax's region (three passes over its row) at the sampler's
    shape (8 rows of 128,256 float32, each row split across a cluster:
    64 KB of it a CTA) and the norm's (16,384 rows of 4096 bf16): the
    launch stages the row in shared memory (``smem``), held within its
    bound; launched not to stage (``stage=False``) it reads the row again
    each pass (``reduce``) and gives the same bits (the same order)."""
    from thunder_tpu_torch.executors import regionex
    from thunder_tpu_torch.testing import hold_region

    shape, dtype = ((8, 128256), torch.float32) if case == "sampler-rows" else (
        (16384, 4096), torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    x = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    _, region = _one_region(lambda x: torch.softmax(x.float(), -1), x)
    assert region.spec.staged
    before = _design_count("smem")
    held = hold_region(region, [x])
    assert held["ok"] and _design_count("smem") == before + 1, held
    staged = region(x)
    before = _design_count("reduce")
    reread = regionex.launch(region, [x], stage=False)
    assert _design_count("reduce") == before + 1
    assert all(torch.equal(p, q) for p, q in zip(staged, reread))


@pytest.mark.cuda
def test_cuda_region_partials_replay_in_a_graph(cuda_device):
    """The norm backward's region (its column sum's partials in scratch the
    launch allocates) and a GQA group sum (the column design) inside a
    ``jit`` entry's CUDA graph: the captured and the replayed calls give
    the per-call call's outputs bit for bit, each replay counting the
    regions' launches."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import regions_of

    gen = torch.Generator(device=cuda_device).manual_seed(29)
    x, g = (torch.randn(2, 256, 1024, device=cuda_device, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    w = torch.rand(1024, device=cuda_device, generator=gen).to(torch.bfloat16)
    dk = torch.randn(2, 8, 256, 64, device=cuda_device, generator=gen)

    def fn(x, g, w, dk):
        dx, dw = _norm_backward(x, g, w)
        return dx, dw, torch.sum(dk.reshape(2, 2, 4, 256, 64) * 2.0, 2)

    per_call = ptt.jit(fn, whole_program_jit=False)(x, g, w, dk)
    jf = ptt.jit(fn)
    for _ in range(3):          # per call, the capture, a replay
        cudaex.reset_launch_counts()
        got = jf(x, g, w, dk)
        torch.cuda.synchronize()
        regions = regions_of(ptt.last_execution_trace(jf))
        assert all(torch.equal(a, b) for a, b in zip(got, per_call))
        assert cudaex.launch_counts()["region"] == len(regions)
    assert ptt.compile_stats(jf).whole_program_replays >= 1
    assert {r.spec.design for r in regions} >= {"row", "column"}


@pytest.mark.cuda
def test_cuda_region_column_sum_with_64_bit_indices(cuda_device):
    """A column space past 2**31 elements (65,540 rows of 32,768 int8
    values, summed over the rows): the launch takes 64-bit indices, and its
    integer sums equal torch's."""
    x = torch.randint(-100, 100, (65540, 32768), dtype=torch.int8, device=cuda_device)
    got, region = _one_region(lambda x: torch.sum(x + 1, 0), x)
    assert region.spec.design == "column"
    assert torch.equal(got, torch.sum(x + 1, 0)) and got.dtype == torch.int64
    del x
