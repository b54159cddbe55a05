"""thunder_tpu_torch's input pipeline (``data.py``) against the JAX package's.

The same token file, seed and steps go through ``thunder_tpu.data`` and the
port, on the port's native path (its own copy of the C++ loader, built into
``thunder_tpu_torch/_build/``) and on its plain Python path, mirroring
``tests/test_data.py``: restart determinism, epoch-exact coverage and
reshuffle, two hosts' disjoint cover, the Python mirror bit-exact with the
native path, prefetch equal to a synchronous fill, and the errors. Windows
are compared exactly: both packages compute them from the same integer
arithmetic.

``TokenDataset.sample`` is held against the reference's native path only:
the reference's numpy fallback of ``sample`` (``thunder_tpu/data.py:144``)
draws other windows than its native loader, while the port's Python path
mirrors the native one.
"""

import numpy as np
import pytest

from thunder_tpu import data as jdata
from thunder_tpu_torch import data

PATHS = [True, False]
PATH_IDS = ["native", "python"]


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "shard.bin")
    toks = np.random.RandomState(0).randint(0, 65000, 1003).astype(np.uint16)
    data.write_token_file(path, toks)
    return path, toks


def _reference(path, **kw):
    ref = jdata.ShardedTokenStream(path, **kw)
    if ref._ds._lib is None:
        pytest.skip("the reference's native loader did not build here")
    return ref


@pytest.mark.parametrize("native", PATHS, ids=PATH_IDS)
def test_stream_path_is_the_one_asked_for(shard, native):
    s = data.ShardedTokenStream(shard[0], batch=4, seq=7, seed=1, native=native)
    assert s.stream_path() == ("native" if native else "python")
    assert s.prefetch == native


@pytest.mark.parametrize("native", PATHS, ids=PATH_IDS)
def test_windows_match_reference(shard, native):
    path, _ = shard
    ref = _reference(path, batch=4, seq=7, seed=42)
    s = data.ShardedTokenStream(path, batch=4, seq=7, seed=42, native=native)
    assert s.n_windows == ref.n_windows and s.steps_per_epoch() == ref.steps_per_epoch()
    for step in (0, 1, 2, 5, 33, 250, 1):
        for a, b in zip(s.batch_at(step), ref.batch_at(step)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        assert s.epoch_of(step) == ref.epoch_of(step)


@pytest.mark.parametrize("native", PATHS, ids=PATH_IDS)
def test_restart_determinism(shard, native):
    path, _ = shard
    s1 = data.ShardedTokenStream(path, batch=4, seq=7, seed=42, native=native)
    s2 = data.ShardedTokenStream(path, batch=4, seq=7, seed=42, native=native)
    for step in (0, 3, 17, 100, 17):   # going back a step too
        for a, b in zip(s1.batch_at(step), s2.batch_at(step)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", PATHS, ids=PATH_IDS)
def test_epoch_exact_coverage_and_reshuffle(shard, native):
    path, toks = shard
    s = data.ShardedTokenStream(path, batch=4, seq=7, seed=1, native=native)
    nw = s.n_windows
    want = {tuple(toks[w * 8:w * 8 + 7].astype(np.int32)) for w in range(nw)}

    def epoch_rows(start_step):
        rows, g, step = [], 0, start_step
        while g < nw:
            t, _ = s.batch_at(step)
            for i in range(4):
                if g < nw:
                    rows.append(tuple(t[i]))
                g += 1
            step += 1
        return rows

    e0 = epoch_rows(0)
    assert set(e0) == want and len(e0) == nw   # every window exactly once
    e1 = epoch_rows((nw + 3) // 4)
    assert e0[:8] != e1[:8]                    # the next epoch in another order


@pytest.mark.parametrize("native", PATHS, ids=PATH_IDS)
def test_two_hosts_disjoint_and_covering(shard, native):
    path, toks = shard
    hosts = [data.ShardedTokenStream(path, batch=2, seq=7, seed=9, n_hosts=2, host=h,
                                     native=native) for h in (0, 1)]
    refs = [_reference(path, batch=2, seq=7, seed=9, n_hosts=2, host=h) for h in (0, 1)]
    nw = hosts[0].n_windows
    want = {tuple(toks[w * 8:w * 8 + 7].astype(np.int32)) for w in range(nw)}
    rows = []
    for st in range(nw // 4 + 1):
        for s, r in zip(hosts, refs):
            t, _ = s.batch_at(st)
            np.testing.assert_array_equal(t, r.batch_at(st)[0])
            rows += [tuple(x) for x in t]
    assert set(rows[:nw]) == want


def test_python_mirror_is_bit_exact_with_native(shard):
    path, _ = shard
    native = data.ShardedTokenStream(path, batch=4, seq=7, seed=42, native=True)
    plain = data.ShardedTokenStream(path, batch=4, seq=7, seed=42, native=False)
    for step in (0, 5, 33, 250):
        for a, b in zip(native.batch_at(step), plain.batch_at(step)):
            np.testing.assert_array_equal(a, b)


def test_prefetch_matches_sync(shard):
    path, _ = shard
    pre = data.ShardedTokenStream(path, batch=4, seq=7, seed=3, prefetch=True, native=True)
    syn = data.ShardedTokenStream(path, batch=4, seq=7, seed=3, prefetch=False, native=True)
    assert pre.prefetch and not syn.prefetch
    for step in list(range(6)) + [40, 41]:   # sequential hits, then a discarded prefetch
        np.testing.assert_array_equal(pre.batch_at(step)[0], syn.batch_at(step)[0])


@pytest.mark.parametrize("native", PATHS, ids=PATH_IDS)
def test_token_dataset_sample_matches_reference_native(shard, native):
    """Both of the port's paths draw the reference's native windows."""
    path, _ = shard
    ref = jdata.TokenDataset(path, batch=3, seq=9, seed=7)
    if ref._lib is None:
        pytest.skip("the reference's native loader did not build here")
    ds = data.TokenDataset(path, batch=3, seq=9, seed=7, native=native)
    assert ds.num_tokens == ref.num_tokens == 1003
    for step in (0, 1, 99, 2 ** 40):
        for a, b in zip(ds.sample(step), ref.sample(step)):
            np.testing.assert_array_equal(a, b)


def test_uint32_tokens(tmp_path):
    path = str(tmp_path / "wide.bin")
    toks = np.random.RandomState(2).randint(0, 200000, 500).astype(np.uint32)
    data.write_token_file(path, toks, dtype_bytes=4)
    ref = _reference(path, batch=2, seq=9, seed=1, dtype_bytes=4)
    for native in PATHS:
        s = data.ShardedTokenStream(path, batch=2, seq=9, seed=1, dtype_bytes=4, native=native)
        for step in (0, 4, 60):
            np.testing.assert_array_equal(s.batch_at(step)[0], ref.batch_at(step)[0])


@pytest.mark.parametrize("native", PATHS, ids=PATH_IDS)
def test_errors(shard, tmp_path, native):
    path, _ = shard
    with pytest.raises(ValueError, match="out of range"):
        data.ShardedTokenStream(path, batch=2, seq=7, host=2, n_hosts=2, native=native)
    tiny = str(tmp_path / "tiny.bin")
    data.write_token_file(tiny, np.arange(4, dtype=np.uint16))
    with pytest.raises(ValueError, match="need at least"):
        data.ShardedTokenStream(tiny, batch=1, seq=7, native=native)
    with pytest.raises(RuntimeError, match="shorter than seq"):
        data.TokenDataset(tiny, batch=1, seq=7, native=native).sample(0)


def test_native_required_raises_when_the_build_fails(shard, monkeypatch):
    """``native=True`` never streams through Python: a loader that does not
    build raises; ``native=None`` then takes the Python path."""
    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(data, "_lib", None)
    monkeypatch.setattr(data, "_lib_error", None)
    monkeypatch.setattr(data, "build_native", broken)
    with pytest.raises(RuntimeError, match="native token loader unavailable"):
        data.ShardedTokenStream(shard[0], batch=2, seq=7, native=True)
    assert data.ShardedTokenStream(shard[0], batch=2, seq=7).stream_path() == "python"


def test_loader_builds_into_the_port_build_dir():
    lib = data.build_native()
    assert lib.parent == data.BUILD_DIR and lib.name.startswith("libttdata-")
    assert data.BUILD_DIR.parent.name == "thunder_tpu_torch"


@pytest.mark.parametrize("max_len", [1, 128, 129, 1000, 2048, 5000])
@pytest.mark.parametrize("factor,align", [(2, 128), (4, 64)])
def test_default_buckets_match_reference(max_len, factor, align):
    assert data.default_buckets(max_len, factor=factor, align=align) == \
        jdata.default_buckets(max_len, factor=factor, align=align)
    b = data.LengthBucketer(data.default_buckets(max_len))
    assert b.bucket_for(max_len) >= max_len
