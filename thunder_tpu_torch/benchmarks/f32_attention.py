"""Why ``sdpa_fwd``/``sdpa_bwd``'s float32 design (``fma``, one thread per
query row) runs far behind its plain version at bart-base's shapes (B=1,
12 heads, hd 64: encoder self-attention 1024 x 1024, decoder causal
512 x 512, cross-attention 512 x 1024).

Two readings:

- ``ptxas -v`` on ``csrc/sdpa_fwd.cu`` and ``csrc/sdpa_bwd.cu`` with the
  build's flags: registers, stack frame and spills of each float32 kernel
  (a per-thread accumulator indexed by a runtime head dim lives in local
  memory, not registers);
- device time of the kernel and its plain version at each shape with B=1
  and with B=8 (the same per-row work over 8x the rows): a kernel whose
  time grows far less than 8x was leaving the card idle at B=1. Beside it,
  the warps each SM holds (a block is 64 threads, one per q row) and the
  share of the card's float32 peak reached.

    PYTHONPATH=. python3 thunder_tpu_torch/benchmarks/f32_attention.py [--iters 5]

Needs a CUDA card and ``nvcc``; prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch

F32_FLOPS = 67e12   # H100 SXM float32 (non-tensor) peak, NVIDIA data sheet
# (B, H, T, S, hd, causal): bart-base's three attention calls
SHAPES = ((1, 12, 1024, 1024, 64, False), (1, 12, 512, 512, 64, True),
          (1, 12, 512, 1024, 64, False))


def ptxas_report() -> dict:
    """``{kernel: ptxas's resource line}`` for the float32 kernels."""
    from thunder_tpu_torch.executors import cudaex

    out_dir = cudaex.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {}
    for stem in ("sdpa_fwd", "sdpa_bwd"):
        p = subprocess.run([cudaex._nvcc(), *cudaex.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                            str(cudaex.CSRC), "-o", str(out_dir / f"{stem}.so"),
                            str(cudaex.CSRC / f"{stem}.cu")], capture_output=True, text=True)
        name = None
        for line in (p.stdout + p.stderr).splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if m:
                name = m.group(1) if "f32" in m.group(1) else None
            elif name and ("stack frame" in line or "registers" in line):
                report.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return report


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_times(B, H, T, S, hd, causal, iters) -> dict:
    from thunder_tpu_torch.executors import cudaex
    from thunder_tpu_torch.ops import nn as tnn

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, g = (torch.randn(B, H, T, hd, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(B, H, S, hd, generator=gen, device="cuda") for _ in range(2))
    out, lse = tnn.sdpa_fwd_plain(q, k, v, causal)
    flops = 4.0 * B * H * T * S * hd * (0.5 if causal and T == S else 1.0)
    r = {"shape": f"{B}x{H}x{T}x{S}x{hd}{' causal' if causal else ''}",
         "warps_per_sm": B * H * -(-T // 64) * 2 / torch.cuda.get_device_properties(0)
         .multi_processor_count}
    for what, kern, plain, f in (
            ("fwd", lambda: cudaex.sdpa_fwd(q, k, v, causal),
             lambda: tnn.sdpa_fwd_plain(q, k, v, causal), flops),
            ("bwd", lambda: cudaex.sdpa_bwd(g, q, k, v, out, lse, causal),
             lambda: tnn.sdpa_bwd_plain(g, q, k, v, out, lse, causal), 2.5 * flops)):
        r[f"{what}_ms"] = time_ms(kern, iters)
        r[f"{what}_plain_ms"] = time_ms(plain, iters)
        r[f"{what}_share_of_f32_peak"] = f / (r[f"{what}_ms"] * 1e-3) / F32_FLOPS
    return r


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    from thunder_tpu_torch.executors import cudaex

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0))
    cudaex.build()
    rows = []
    for B, H, T, S, hd, causal in SHAPES:
        one, eight = (attention_times(b, H, T, S, hd, causal, args.iters) for b in (B, 8 * B))
        rows.append({"b1": one, "b8": eight,
                     "fwd_time_ratio_b8_b1": eight["fwd_ms"] / one["fwd_ms"],
                     "bwd_time_ratio_b8_b1": eight["bwd_ms"] / one["bwd_ms"]})
    print(json.dumps({"ptxas": ptxas_report(), "shapes": rows}))


if __name__ == "__main__":
    main()
