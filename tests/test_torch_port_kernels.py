"""thunder_tpu_torch kernel functions against the JAX package.

On the CPU each public function of ``thunder_tpu_torch.ops.nn`` runs its
plain version; these tests hold that plain version against the JAX Pallas
kernel it stands for (run in interpret mode, as the JAX package's own tests
run it on the CPU) and against the JAX ``ops/nn.py`` decomposition, on the
same numpy inputs. Tolerances, all float32: 1e-5 for the norms and paged
attention (the same operations in another summation order), 1e-4 for
``linear_act`` (a K=64 product; BLAS blocking orders the sum differently).

``tests/test_torch_port_cuda.py`` holds each hand-written kernel against its
plain version on a card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import thunder_tpu as tt
from thunder_tpu.executors import pallasex as px
from thunder_tpu.ops import nn as jnn
from thunder_tpu_torch.executors import cudaex, regionex
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.testing import rms_residual_fault

EPS = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")


def _xla(fn, *args):
    """The JAX decomposition of ``fn``, traced with no kernel executor."""
    out = tt.jit(fn, executors=["xla"])(*args)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# rms_norm / rms_norm_residual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False], ids=["w", "no_w"])
@pytest.mark.parametrize("shape", [(8, 64), (2, 8, 128)], ids=["2d", "3d"])
def test_rms_norm_matches_pallas_and_decomposition(shape, weighted, interpret):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.rand(shape[-1]) + 0.5).astype(np.float32) if weighted else None
    port = tnn.rms_norm(_t(x), None if w is None else _t(w), eps=EPS).numpy()
    pallas = np.asarray(px.pallas_rms_norm(x, w, EPS))
    if w is None:
        ref = _xla(lambda a: jnn.rms_norm(a, None, eps=EPS), x)
    else:
        ref = _xla(lambda a, b: jnn.rms_norm(a, b, eps=EPS), x, w)
    _close(port, pallas, 1e-5)
    _close(port, ref, 1e-5)


@pytest.mark.parametrize("weighted", [True, False], ids=["w", "no_w"])
def test_rms_norm_residual_matches_pallas_and_decomposition(weighted, interpret):
    rng = np.random.RandomState(1)
    r = rng.randn(2, 8, 64).astype(np.float32)
    x = rng.randn(2, 8, 64).astype(np.float32)
    w = (rng.rand(64) + 0.5).astype(np.float32) if weighted else None
    h, y = tnn.rms_norm_residual(_t(r), _t(x), None if w is None else _t(w), eps=EPS)
    ph, py = px.pallas_rms_norm_residual(r, x, w, EPS)
    if w is None:
        rh, ry = _xla(lambda a, b: jnn.rms_norm_residual(a, b, None, eps=EPS), r, x)
    else:
        rh, ry = _xla(lambda a, b, c: jnn.rms_norm_residual(a, b, c, eps=EPS), r, x, w)
    for got, want in ((h, ph), (y, py), (h, rh), (y, ry)):
        _close(got.numpy(), want, 1e-5)


def test_rms_norm_residual_equals_add_then_norm():
    """The fused function is exactly the unfused chain (numerics contract)."""
    rng = np.random.RandomState(2)
    r, x = _t(rng.randn(4, 32).astype(np.float32)), _t(rng.randn(4, 32).astype(np.float32))
    w = _t(rng.rand(32).astype(np.float32))
    h, y = tnn.rms_norm_residual(r, x, w)
    assert torch.equal(h, r + x)
    assert torch.equal(y, tnn.rms_norm(r + x, w))


def test_rms_norm_plain_rounds_like_the_kernel_in_bf16():
    """bf16: statistics in f32, the normed row rounded to bf16 BEFORE the
    weight multiply (pallasex._rms_kernel's order)."""
    rng = np.random.RandomState(3)
    x = _t(rng.randn(4, 64).astype(np.float32)).to(torch.bfloat16)
    w = _t((rng.rand(64) + 0.5).astype(np.float32)).to(torch.bfloat16)
    y = tnn.rms_norm(x, w)
    assert y.dtype == torch.bfloat16
    xf = x.float()
    normed = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + EPS)).to(torch.bfloat16)
    assert torch.equal(y, normed * w)


# ---------------------------------------------------------------------------
# linear_act
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("act", ["relu", "silu", "gelu", "gelu_tanh"])
def test_linear_act_matches_pallas_and_decomposition(act, with_bias, interpret):
    rng = np.random.RandomState(4)
    a = rng.randn(2, 8, 64).astype(np.float32)
    w = (rng.randn(48, 64) / 8).astype(np.float32)
    b = rng.randn(48).astype(np.float32) if with_bias else None
    port = tnn.linear_act(_t(a), _t(w), None if b is None else _t(b), act=act).numpy()
    pallas = np.asarray(px.pallas_linear_act(a, w, b, act=act))
    if b is None:
        ref = _xla(lambda x, y: jnn.linear_act(x, y, None, act=act), a, w)
    else:
        ref = _xla(lambda x, y, z: jnn.linear_act(x, y, z, act=act), a, w, b)
    assert port.shape == (2, 8, 48)
    _close(port, pallas, 1e-4)
    _close(port, ref, 1e-4)


def test_linear_act_rejects_unknown_activation():
    with pytest.raises(ValueError, match="unknown activation"):
        tnn.linear_act(torch.zeros(2, 4), torch.zeros(3, 4), act="tanh")


# ---------------------------------------------------------------------------
# paged_decode_attention / decode_row_write (tiny-gqa geometry)
# ---------------------------------------------------------------------------

def _paged_inputs(seed, T=1, B=4, H=4, KV=2, hd=16, ps=8, P=12, npg=4, lengths=None):
    rng = np.random.RandomState(seed)
    q = (rng.rand(B, H, T, hd) - 0.5).astype(np.float32)
    kp = (rng.rand(KV, P, ps, hd) - 0.5).astype(np.float32)
    vp = (rng.rand(KV, P, ps, hd) - 0.5).astype(np.float32)
    bt = np.zeros((B, npg), np.int32)
    perm = rng.permutation(np.arange(1, P))
    lengths = np.asarray(lengths if lengths is not None else [1, 8, 9, 30][:B], np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        bt[b, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, bt, lengths


def _jax_paged(q, kp, vp, bt, ln):
    return _xla(lambda *a: jnn.paged_decode_attention(*a), q, kp, vp, bt, ln)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_matches_pallas_and_decomposition(seed, interpret):
    """Ragged lengths (1, a full page, a page boundary crossing, a long
    context) with G=2 grouped query rows per kv head."""
    q, kp, vp, bt, ln = _paged_inputs(seed)
    port = tnn.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln)).numpy()
    pallas = np.asarray(px.pallas_paged_decode_attention(q, kp, vp, bt, ln))
    ref = _jax_paged(q, kp, vp, bt, ln)
    _close(port, pallas, 1e-5)
    _close(port, ref, 1e-5)


# the split-context kernel's algorithm (csrc/paged_decode_attention.cu) at
# the chunk geometry its wrapper computes: lengths that straddle a chunk (1,
# C - 1, C, C + 1, several chunks) and a length of 0, which gets zeros
SPLIT_CASES = [(dt, G, hd) for dt in (torch.float32, torch.bfloat16, torch.float16)
               for G in (1, 4, 8) for hd in (64, 128)]


@pytest.mark.parametrize("dtype,G,hd", SPLIT_CASES,
                         ids=[f"{str(d)[6:]}-G{g}-hd{h}" for d, g, h in SPLIT_CASES])
def test_paged_split_model_matches_plain(dtype, G, hd):
    """The chunks' (m, l, acc) in float32 merged in chunk order equal the
    plain version's one softmax over the whole context: float32 to 1e-5,
    16-bit to one rounding step of the result (both round once, from f32
    sums in another order)."""
    from thunder_tpu_torch.testing import rms_residual_fault, paged_split_model

    KV, ps = 2, 16
    keys, _, _ = cudaex.paged_geometry(1, G * KV, KV, hd, ps, 1, dtype)
    lengths = [1, keys - 1, keys, keys + 1, 2 * keys + 3, 0]
    npg = -(-max(lengths) // ps)
    q, kp, vp, bt, ln = _paged_inputs(5, B=len(lengths), H=G * KV, KV=KV, hd=hd, ps=ps,
                                      P=len(lengths) * npg + 1, npg=npg, lengths=lengths)
    args = [_t(a).to(dtype) for a in (q, kp, vp)] + [_t(bt), _t(ln)]
    B, H, _, _ = args[0].shape
    k2, nch, ws = cudaex.paged_geometry(B, H, KV, hd, ps, npg, dtype)
    assert k2 == keys and nch == -(-npg * ps // keys) and ws == (B, KV, nch, G, 2 + hd)
    got = paged_split_model(*args, keys)
    want = tnn.paged_decode_attention_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    live = slice(0, len(lengths) - 1)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got[live].float(), want[live].float(), atol=tol, rtol=tol)
    assert bool((got[-1] == 0).all())


def test_paged_split_model_fails_a_dropped_chunk():
    """The chip smoke's planted fault: the longest request's last chunk left
    out of the merge must move that request's rows well past the check."""
    from thunder_tpu_torch.testing import paged_split_model, row_rel_err

    keys = cudaex.paged_chunk_keys(4, 64, 2)
    lengths = [3, 2 * keys + 40]
    npg = -(-max(lengths) // 16)
    q, kp, vp, bt, ln = _paged_inputs(6, B=2, H=8, KV=2, hd=64, ps=16, P=2 * npg + 1, npg=npg,
                                      lengths=lengths)
    args = [_t(a).to(torch.bfloat16) for a in (q, kp, vp)] + [_t(bt), _t(ln)]
    want = tnn.paged_decode_attention_plain(*args)
    assert row_rel_err(paged_split_model(*args, keys), want) <= 2e-2
    bad = paged_split_model(*args, keys, drop={(1, 2)})
    assert row_rel_err(bad, want) > 2e-2
    torch.testing.assert_close(bad[0], want[0])


@pytest.mark.parametrize("dtype,esize", [(torch.bfloat16, 2), (torch.float16, 2),
                                         (torch.float32, 4)])
def test_paged_geometry_sizes_the_chunks(dtype, esize):
    """The chunk geometry: 128 keys at 16-bit and hd 128 and G 4 (the serving
    shape: 16 chunks over 128 pages of 16), 64 at float32, every block within
    72 KB of shared memory; the grid comes from the block table's width,
    never from the lengths."""
    keys, nch, ws = cudaex.paged_geometry(8, 32, 8, 128, 16, 128, dtype)
    assert keys == (128 if esize == 2 else 64)
    assert nch == 2048 // keys and ws == (8, 8, nch, 4, 130)
    for G, hd in ((1, 128), (4, 64), (8, 128), (32, 128), (1, 3), (2048, 1)):
        k = cudaex.paged_chunk_keys(G, hd, esize)
        assert k >= 4 and k & (k - 1) == 0 and k <= cudaex.PAGED_MAX_KEYS
        assert cudaex._paged_smem(G, hd, k, esize) <= cudaex.PAGED_CHUNK_SMEM
        assert k == cudaex.PAGED_MAX_KEYS or cudaex._paged_smem(G, hd, 2 * k, esize) > \
            cudaex.PAGED_CHUNK_SMEM


def test_paged_refusal_has_no_accumulator_cap():
    """The split design holds no per-thread accumulators: 32 grouped rows of
    128 (beyond the parent kernel's G * hd <= 2048) are taken, and only a
    4-key chunk that outgrows a block's shared memory is refused."""
    q = torch.zeros(2, 32, 1, 128, dtype=torch.bfloat16)
    kp = torch.zeros(1, 5, 16, 128, dtype=torch.bfloat16)
    bt, ln = torch.zeros(2, 2, dtype=torch.int32), torch.tensor([3, 20], dtype=torch.int32)
    assert cudaex.refusal("paged_decode_attention", q, kp, kp, bt, ln) is None
    q = torch.zeros(1, 4096, 1, 16)
    kp = torch.zeros(1, 2, 16, 16)
    assert "shared memory" in cudaex.refusal("paged_decode_attention", q, kp, kp, bt[:1], ln[:1])


def test_paged_prefill_rows_masked_per_row():
    """T > 1 (a prefill chunk): per-row ragged causal masking, plain path."""
    q, kp, vp, bt, ln = _paged_inputs(2, T=8, B=1, lengths=[19])
    port = tnn.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln)).numpy()
    _close(port, _jax_paged(q, kp, vp, bt, ln), 1e-5)


def test_paged_decode_reads_only_the_block_table():
    """Pages outside a request's block table never reach its output."""
    q, kp, vp, bt, ln = _paged_inputs(3)
    out = tnn.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(ln))
    kp2, vp2 = kp.copy(), vp.copy()
    unused = sorted(set(range(kp.shape[1])) - set(bt[bt != 0].tolist()) - {0})
    kp2[:, unused] = 1e3
    vp2[:, unused] = -1e3
    out2 = tnn.paged_decode_attention(_t(q), _t(kp2), _t(vp2), _t(bt), _t(ln))
    assert torch.equal(out, out2)


def test_paged_decode_rejects_bad_shapes():
    q, kp, vp, bt, ln = _paged_inputs(0)
    with pytest.raises(ValueError, match="divisible"):
        tnn.paged_decode_attention(_t(q[:, :3]), _t(kp), _t(vp), _t(bt), _t(ln))
    with pytest.raises(ValueError, match="must be"):
        tnn.paged_decode_attention(_t(q[0]), _t(kp), _t(vp), _t(bt), _t(ln))


def test_decode_row_write_matches_reference():
    rng = np.random.RandomState(5)
    KV, P, ps, hd, S = 2, 6, 4, 8, 3
    pool = rng.randn(KV, P, ps, hd).astype(np.float32)
    rows = rng.randn(S, KV, 1, hd).astype(np.float32)
    pos = np.asarray([5, 13, 22], np.int32)
    ref = _xla(lambda p, r, i: jnn.decode_row_write(p, r, i),
               pool.reshape(KV, P * ps, hd), rows, pos)
    port = _t(pool)
    tnn.decode_row_write(port, _t(rows), _t(pos))
    np.testing.assert_array_equal(port.numpy().reshape(KV, P * ps, hd), ref)


# ---------------------------------------------------------------------------
# wrappers and devices
# ---------------------------------------------------------------------------

def test_kernel_table_names_the_pallas_functions():
    """Each kernel names the Pallas function it replaces, and its source
    note names it too; the AdamW health passes, which replace the numerics
    guard's XLA reductions (no Pallas function), name those."""
    repo = Path(cudaex.__file__).resolve().parents[2]
    src = (repo / "thunder_tpu/executors/pallasex.py").read_text().splitlines()
    guard = (repo / "thunder_tpu/transforms/numerics_guard.py").read_text().splitlines()
    xla = (repo / "thunder_tpu/executors/xla.py").read_text().splitlines()
    for k in (*cudaex.KERNELS.values(), *cudaex.GENERATED.values()):
        path, line = k.replaces.split(":")
        note = " ".join((repo / k.source).read_text().split())
        if k.name == "region":
            # generated per region: it stands for the reference's XLA regions
            assert path == "thunder_tpu/executors/xla.py" and k is regionex.KERNEL
            assert xla[int(line) - 1].startswith("class XLAFusionExecutor("), k.replaces
            assert f"xla.py XLAFusionExecutor, :{line}" in note.replace("// ", "")
            continue
        if k.name in ("fused_adamw_health", "fused_adamw_slab_health"):
            assert path == "thunder_tpu/transforms/numerics_guard.py"
            assert guard[int(line) - 1].strip().startswith("def count_nonfinite("), k.replaces
            assert f"numerics_guard.py:317-320" in note and f"at :{line}-" in note
            continue
        assert path == "thunder_tpu/executors/pallasex.py"
        assert src[int(line) - 1].startswith(f"def pallas_{k.name}("), k.replaces
        assert f"pallasex.py pallas_{k.name} (:{line})" in note.replace("// ", "")


def _cpu_region():
    """A region of ``x * y + 1`` over (2, 1, 16) float32, traced for the CPU."""
    import thunder_tpu_torch as ptt
    from thunder_tpu_torch.testing import regions_of

    jf = ptt.jit(lambda x, y: x * y + 1.0, device="cpu")
    jf(torch.zeros(2, 1, 16), torch.zeros(2, 1, 16))
    (region,) = regions_of(ptt.last_execution_trace(jf))
    return region


@pytest.mark.parametrize("name", sorted({**cudaex.KERNELS, **cudaex.GENERATED}))
def test_wrappers_refuse_cpu_tensors(name):
    """A wrapper launches its kernel or raises: it never computes on the CPU."""
    x = torch.zeros(2, 1, 16)
    w = torch.zeros(8, 16)
    sq, pool = torch.zeros(16, 16), torch.zeros(1, 3, 4, 16)
    decode = (x, x[0, 0], sq, sq, sq, sq, torch.zeros(2, 1, 1, 8), torch.zeros(2, 1, 1, 8), pool,
              pool, torch.zeros(2, 1, dtype=torch.int32), torch.ones(2, dtype=torch.int32),
              torch.zeros(2, dtype=torch.int64))
    calls = {
        "rms_norm": lambda: cudaex.rms_norm(x, None, EPS),
        "rms_norm_residual": lambda: cudaex.rms_norm_residual(x, x, None, EPS),
        "linear_act": lambda: cudaex.linear_act(x, torch.zeros(8, 16), act="silu"),
        "paged_decode_attention": lambda: cudaex.paged_decode_attention(
            x.reshape(2, 1, 1, 16), torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16),
            torch.zeros(2, 1, dtype=torch.int32), torch.ones(2, dtype=torch.int32)),
        "sdpa_fwd": lambda: cudaex.sdpa_fwd(x, x, x, True),
        "sdpa_bwd": lambda: cudaex.sdpa_bwd(x, x, x, x, x, torch.zeros(2, 1), True),
        "ce_fwd": lambda: cudaex.ce_fwd(x[:, 0], torch.zeros(2, dtype=torch.int64)),
        "fused_adamw": lambda: cudaex.fused_adamw(
            [x], [x], [x], [x], torch.ones(2), lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
            weight_decay=0.0),
        "fused_adamw_slab": lambda: cudaex.fused_adamw_slab(
            [x], [x], torch.zeros(8, 128), torch.zeros(8, 128), torch.ones(2), sizes=[32],
            lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0),
        "fused_adamw_health": lambda: cudaex.fused_adamw_health(
            [x], [x], [x], [x], torch.ones(2), torch.zeros(3, dtype=torch.float64), lr=1e-3,
            beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0),
        "fused_adamw_slab_health": lambda: cudaex.fused_adamw_slab_health(
            [x], [x], torch.zeros(8, 128), torch.zeros(8, 128), torch.ones(2),
            torch.zeros(3, dtype=torch.float64), sizes=[32], lr=1e-3, beta1=0.9, beta2=0.999,
            eps=1e-8, weight_decay=0.0),
        "mlp_subblock": lambda: cudaex.mlp_subblock(x, x, x[0, 0], w, w, w.t().contiguous()),
        "mlp_subblock_bwd": lambda: cudaex.mlp_subblock_bwd(x, x, x, x[0, 0], w, w,
                                                            w.t().contiguous()),
        "decode_layer": lambda: cudaex.decode_layer(*decode, x[0, 0], w, w, w.t().contiguous()),
        "attn_subblock": lambda: cudaex.attn_subblock(*decode),
        "region": lambda: regionex.launch(_cpu_region(), (x, x)),
    }
    before = cudaex.launch_counts()[name]
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[name]()
    assert cudaex.launch_counts()[name] == before


SDPA_DESIGNS = [(torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
                (torch.bfloat16, 16, "mma"), (torch.bfloat16, 96, "mma"),
                (torch.bfloat16, 112, "mma"), (torch.float32, 128, "fma"),
                (torch.float32, 64, "fma")]


@pytest.mark.parametrize("dtype,hd,design", SDPA_DESIGNS,
                         ids=[f"{str(d)[6:]}-hd{h}" for d, h, _ in SDPA_DESIGNS])
def test_sdpa_fwd_design_by_dtype_and_head_dim(dtype, hd, design):
    """The wrapper's fixed rule: bf16 at hd 64 and 128 takes the TMA + wgmma
    kernel, bf16 at other head dims the mma.sync kernel, float32 the FMA
    kernel; the C entry reads the design by its index."""
    assert cudaex.sdpa_fwd_design(dtype, hd) == design
    repo = Path(cudaex.__file__).resolve().parents[2]
    note = (repo / cudaex.KERNELS["sdpa_fwd"].source).read_text()
    assert f"{cudaex.SDPA_FWD_DESIGNS.index(design)} {design}" in note


SDPA_BWD_DESIGNS = [(dt, hd, "wgmma" if hd in (64, 128) else "mma")
                    for dt in (torch.bfloat16, torch.float16) for hd in (64, 128, 8, 48, 192)] + [
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"), (torch.float32, 8, "fma")]


@pytest.mark.parametrize("dtype,hd,design", SDPA_BWD_DESIGNS,
                         ids=[f"{str(d)[6:]}-hd{h}" for d, h, _ in SDPA_BWD_DESIGNS])
def test_sdpa_bwd_design_by_dtype_and_head_dim(dtype, hd, design):
    """The backward's fixed rule, the forward's: bf16 and fp16 at hd 64 and
    128 take the TMA + wgmma dK/dV and dQ kernels, other 16-bit head dims
    (hd 8 padded to 16, 48, 192) the mma.sync kernels, float32 the FMA
    kernels; the C entry reads the design by its index."""
    assert cudaex.sdpa_bwd_design(dtype, cudaex.sdpa_head_dim(dtype, hd)) == design
    repo = Path(cudaex.__file__).resolve().parents[2]
    note = (repo / cudaex.KERNELS["sdpa_bwd"].source).read_text()
    assert f"{cudaex.SDPA_BWD_DESIGNS.index(design)} {design}" in note


RMS_DESIGNS = [(dt, D, "vector") for dt in (torch.bfloat16, torch.float16, torch.float32)
               for D in (4096, 64, 8192)] + [
    (torch.bfloat16, 4100, "scalar"), (torch.float16, 4100, "scalar"),
    (torch.float32, 4100, "vector"), (torch.float32, 4102, "scalar"),
    (torch.bfloat16, 32768, "vector"), (torch.bfloat16, 32776, "scalar"),
    (torch.float32, 16384, "vector"), (torch.float32, 16388, "scalar")]


@pytest.mark.parametrize("dtype,D,design", RMS_DESIGNS,
                         ids=[f"{str(d)[6:]}-D{n}" for d, n, _ in RMS_DESIGNS])
def test_rms_norm_design_by_dtype_and_width(dtype, D, design):
    """rms_norm's fixed rule: rows whose starts lie on 16 bytes (D a multiple
    of 8 16-bit or 4 float32 values) and that fit the registers (at most
    4096 16-byte accesses) take the one-read vector kernel, the rest the
    scalar two-sweep kernel; the C entry reads the design by its index."""
    assert cudaex.rms_norm_design(dtype, D) == design
    repo = Path(cudaex.__file__).resolve().parents[2]
    note = (repo / cudaex.KERNELS["rms_norm"].source).read_text()
    assert f"{cudaex.RMS_NORM_DESIGNS.index(design)} {design}" in note


@pytest.mark.parametrize("dtype,D,design", RMS_DESIGNS,
                         ids=[f"{str(d)[6:]}-D{n}" for d, n, _ in RMS_DESIGNS])
def test_rms_norm_residual_design_by_dtype_and_width(dtype, D, design):
    """rms_norm_residual takes rms_norm's rule (both vector designs hold one
    row of the same values in registers, csrc/rms_row.cuh); its C entry
    reads the design by its index."""
    assert cudaex.rms_norm_residual_design(dtype, D) == design
    repo = Path(cudaex.__file__).resolve().parents[2]
    note = (repo / cudaex.KERNELS["rms_norm_residual"].source).read_text()
    assert f"{cudaex.RMS_NORM_DESIGNS.index(design)} {design}" in note


@pytest.mark.parametrize("weighted", [True, False], ids=["weight", "no-weight"])
def test_rms_residual_fault_model(weighted):
    """testing.rms_residual_fault, the planted fault of chip_smoke.py's
    rms_norm_residual check: with nothing left out it is the plain norm of
    h; leaving out the last row's last 256 of 4096 values moves that row
    past the check's 2**-6 and no other row."""
    g = torch.Generator().manual_seed(0)
    r, x = (torch.randn(3, 4096, generator=g).to(torch.bfloat16) for _ in range(2))
    w = (torch.rand(4096, generator=g) + 0.5).to(torch.bfloat16) if weighted else None
    h, y = tnn.rms_norm_residual_plain(r, x, w, EPS)
    assert torch.equal(rms_residual_fault(h, w, EPS, 0), y)
    bad = rms_residual_fault(h, w, EPS, 256)
    assert torch.equal(bad[:-1], y[:-1])
    rel = ((bad[-1].float() - y[-1].float()).abs() / y[-1].float().abs().clamp_min(1e-6))
    assert float(rel.max()) > 2.0 ** -6


LINEAR_PATHS = [(torch.bfloat16, 1, "stream"), (torch.bfloat16, 8, "stream"),
                (torch.bfloat16, 13, "stream"), (torch.bfloat16, 16, "stream"),
                (torch.bfloat16, 17, "tile"), (torch.bfloat16, 512, "tile"),
                (torch.bfloat16, 515, "tile"), (torch.float32, 1, "tile"),
                (torch.float32, 8, "tile"), (torch.float32, 512, "tile")]


@pytest.mark.parametrize("dtype,M,path", LINEAR_PATHS,
                         ids=[f"{str(d)[6:]}-M{m}" for d, m, _ in LINEAR_PATHS])
def test_linear_act_path_by_rows(dtype, M, path):
    """The wrapper's fixed rule: bf16 decode rows (M <= 16) take the
    weight-streaming kernel, everything else gemm.cuh's tile mainloop; the C
    entry reads the path by its index."""
    assert cudaex.linear_act_path(dtype, M) == path
    repo = Path(cudaex.__file__).resolve().parents[2]
    note = (repo / cudaex.KERNELS["linear_act"].source).read_text()
    assert f"{cudaex.LINEAR_ACT_PATHS.index(path)} {path}" in note


DECODE_DESIGNS = [(torch.bfloat16, 1, 4096, 32, 128, "stream"),
                  (torch.bfloat16, 3, 4096, 32, 128, "stream"),
                  (torch.bfloat16, 8, 4096, 32, 128, "stream"),
                  (torch.float16, 8, 4096, 32, 128, "stream"),
                  (torch.bfloat16, 4, 64, 8, 8, "stream"),
                  (torch.bfloat16, 9, 4096, 32, 128, "fma"),
                  (torch.bfloat16, 16, 4096, 32, 128, "fma"),
                  (torch.bfloat16, 8, 8192, 64, 128, "fma"),
                  (torch.float32, 8, 4096, 32, 128, "fma"),
                  (torch.float32, 1, 64, 4, 16, "fma")]


@pytest.mark.parametrize("dtype,S,D,H,hd,design", DECODE_DESIGNS,
                         ids=[f"{str(d)[6:]}-S{s}-D{n}" for d, s, n, *_ in DECODE_DESIGNS])
def test_decode_design_by_dtype_and_slots(dtype, S, D, H, hd, design):
    """decode_layer's and attn_subblock's fixed rule: bf16 and fp16 at up to
    8 slots, with D and H * hd within the 4096 staged columns, run their
    products on the swap-AB mma.sync weight stream, everything else on f32
    FMAs; the C entries read the design by its index."""
    assert cudaex.decode_design(dtype, S, D, H, 8, hd) == design
    repo = Path(cudaex.__file__).resolve().parents[2]
    for name in ("decode_layer", "attn_subblock"):
        note = (repo / cudaex.KERNELS[name].source).read_text()
        assert f"{cudaex.DECODE_DESIGNS.index(design)} {design}" in note


def test_design_counts_start_empty_and_reset():
    cudaex.reset_launch_counts()
    assert cudaex.design_counts() == {}
    cudaex.KERNELS["sdpa_fwd"].designs["wgmma"] = 3
    assert cudaex.design_counts() == {"sdpa_fwd": {"wgmma": 3}}
    cudaex.reset_launch_counts()
    assert cudaex.design_counts() == {}


@pytest.mark.parametrize("name,design", [("sdpa_bwd", "wgmma"), ("sdpa_bwd", "mma"),
                                         ("rms_norm", "vector"),
                                         ("rms_norm_residual", "vector")])
def test_design_counts_by_kernel(name, design):
    """Each kernel with several designs reports its launches by design, and
    a reset clears them with the launch counts."""
    cudaex.reset_launch_counts()
    cudaex.KERNELS[name].designs[design] = 2
    cudaex.KERNELS["sdpa_fwd"].designs["wgmma"] = 1
    assert cudaex.design_counts() == {name: {design: 2}, "sdpa_fwd": {"wgmma": 1}}
    cudaex.reset_launch_counts()
    assert cudaex.design_counts() == {}


def test_build_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cudaex.build()


def test_public_functions_refuse_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tnn.rms_norm(x)
    with pytest.raises(ValueError, match="not supported"):
        tnn.linear_act(x, torch.zeros(4, 8, device="meta"))
    q = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tnn.sdpa_fwd(q, q, q, True)
    with pytest.raises(ValueError, match="not supported"):
        tnn.ce_fwd(x, torch.zeros(2, dtype=torch.int64, device="meta"))
