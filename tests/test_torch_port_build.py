"""ROADMAP C.4 on the CPU: a kernel source that fails to build stops only
its own kernels.

The card and ``nvcc`` are stubbed: ``torch.cuda.is_available`` reports a
card, a stand-in ``nvcc`` (a Python script) fails on ``decode_layer.cu``
with a compiler's error and writes an empty library for every other source,
and ``ctypes`` hands back entry points that return 0 (cudaSuccess). Then
``cudaex.build`` binds every other kernel and keeps the failed source's log
against ``decode_layer``, whose first launch raises its own
``KernelBuildError``; the kernel guard attributes it to ``cuda.decode_layer``
(degradable), and a planned serving engine with that error injected into
``decode_layer`` quarantines it and decodes on the sub-block rung with the
tokens of an unfaulted engine (float32). A build in which every source fails
stays one fatal error (``test_torch_port_runtime.py``); the same repair on
the card, with a real ``nvcc``, is ``test_torch_port_cuda.py -k
one_failed_source``.
"""

import ctypes
import sys
import types

import pytest
import torch

from test_torch_port_serving_planned import ENGINE_LAYERS, _prompts, bound_layer_kernel
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.ops import nn as tnn
from thunder_tpu_torch.runtime import faults, quarantine, retry
from thunder_tpu_torch.serving import ServingEngine

BROKEN = "decode_layer"
NVCC = f"""#!{sys.executable}
import sys
src, out = sys.argv[-1], sys.argv[sys.argv.index("-o") + 1]
if src.endswith("/{BROKEN}.cu"):
    print("{BROKEN}.cu(41): error: identifier \\"phase\\" is undefined")
    sys.exit(2)
open(out, "w").close()
"""


class _Library:
    """A bound library whose every entry point returns 0."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, symbol):
        def entry(*args):
            return 0

        return entry


@pytest.fixture
def stubbed_build(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cudaex, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cudaex, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cudaex, "ctypes", types.SimpleNamespace(CDLL=_Library,
                                                                c_int=ctypes.c_int))
    for k in cudaex.KERNELS.values():
        monkeypatch.setattr(k, "fn", None)
        monkeypatch.setattr(k, "build_error", None)
    quarantine.reset()
    faults.clear()
    yield
    quarantine.reset()
    faults.clear()
    cudaex.reset_launch_counts()


def test_failed_source_stops_only_its_kernels(stubbed_build):
    seconds = cudaex.build()
    assert set(seconds) == {k.source.rsplit("/", 1)[1][:-3] for k in cudaex.KERNELS.values()}
    failed = cudaex.build_failures()
    assert set(failed) == {BROKEN} and 'identifier "phase" is undefined' in failed[BROKEN]
    assert all(k.fn is not None for name, k in cudaex.KERNELS.items() if name != BROKEN)
    cudaex.reset_launch_counts()
    cudaex._launch("attn_subblock")   # decode_layer.cuh's other library built
    cudaex._launch("rms_norm", design="vector")
    assert cudaex.launch_counts()["attn_subblock"] == cudaex.launch_counts()["rms_norm"] == 1
    with pytest.raises(faults.KernelBuildError, match="decode_layer.cu did not build") as ei:
        cudaex._launch(BROKEN)
    assert ei.value.kernel == BROKEN and "identifier" in str(ei.value)
    assert retry.classify(ei.value) == retry.DEGRADABLE
    assert cudaex.launch_counts()[BROKEN] == 0
    assert cudaex.build() == {stem: 0.0 for stem in seconds}   # no second compile


def test_the_guard_attributes_the_failed_kernel(stubbed_build):
    cudaex.build()
    guarded = faults.kernel_guard(f"cuda.{BROKEN}", lambda: cudaex._launch(BROKEN))
    with pytest.raises(faults.KernelExecutionError) as ei:
        guarded()
    assert ei.value.claim_id == f"cuda.{BROKEN}" and ei.value.phase == "build"
    assert retry.classify(ei.value) == retry.DEGRADABLE
    assert isinstance(ei.value.__cause__, faults.KernelBuildError)
    whole = faults.KernelBuildError("kernel build failed: nvcc exited 2")
    with pytest.raises(faults.KernelBuildError) as ei:
        faults.kernel_guard("cuda.rms_norm", lambda: (_ for _ in ()).throw(whole))()
    assert ei.value is whole and retry.classify(whole) == retry.FATAL


def test_engine_takes_the_subblock_rung():
    """The planned engine's decode layer raising its own build error is
    quarantined, the engine re-binds to the sub-block rung and replays the
    step: the tokens are the unfaulted engine's."""
    quarantine.reset()
    cfg = tllama.CONFIGS["tiny-gqa"]
    params = tllama.init_params(cfg, seed=0, device="cpu", n_layers=ENGINE_LAYERS)
    prompts = _prompts(3, (5, 19, 33))
    kw = {"device": "cpu", "max_slots": 3, "page_size": 16, "max_context": 64,
          "prefill_chunk": 32, "block_fusion": True}

    def build_error(msg):
        return faults.KernelBuildError(f"{BROKEN}: its source did not build: {msg}",
                                       kernel=BROKEN)

    tokens = []
    try:
        for spec in (None, faults.FaultSpec(f"kernel:cuda.{BROKEN}", exc=build_error)):
            quarantine.reset()
            eng = ServingEngine(params, cfg, **kw)
            reqs = [eng.submit(p, 6) for p in prompts]
            with faults.active(faults.FaultPlan([spec]) if spec else None):
                eng.drain()
            tokens.append([r.output().tolist() for r in reqs])
        assert tokens[0] == tokens[1]
        assert quarantine.is_quarantined(f"cuda.{BROKEN}")
        assert eng.decode_rebinds == 1 and bound_layer_kernel(eng) == "attn_subblock"
    finally:
        quarantine.reset()
