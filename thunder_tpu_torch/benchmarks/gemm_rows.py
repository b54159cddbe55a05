"""Device time of the redesigned kernels at the shapes of PERF.md's kernel
table: those on gemm.cuh's mainloops, ``mlp_subblock`` (row 7) and
``mlp_subblock_bwd`` (row 8) at llama3-8b-bench's train shape (16384 rows,
D=4096, F=14336) and llama2-7b-bench's (F=11008), ``mlp_subblock`` at the
serving prefill chunk (512 rows) and at 8 rows, and ``linear_act`` at the
decode rows (row 6: 8 x 4096 -> 14336, silu, the weight stream the decode
layer shares) and the 512-row prefill chunk (row 6b); ``sdpa_bwd``
(row 2) at the train path's (8, 32, 2048, 128) causal and full, beside
aten's flash-attention backward; ``rms_norm`` (row 4) at 8 x 4096 and
(8, 2048, 4096), beside ``F.rms_norm``; ``rms_norm_residual`` (row 5) at
the same shapes, beside the per-op chain ``torch.add`` then ``F.rms_norm``
(no one PyTorch call computes both its outputs); the decode kernels at the serving
shape of ``chip_smoke.py``'s phase 3 (8 requests of 1..2048 tokens, 32/8
heads, hd 128, 16-token pages, bf16): ``paged_decode_attention`` (row 9,
rotating over four pool copies so each call finds its pages out of L2) and
``decode_layer`` and ``attn_subblock`` (row 10: D 4096, F 14336, one replay
slot), ``attn_subblock`` also with every length 1, where its attention
phase has almost nothing to read: the difference is that phase's time.

    PYTHONPATH=. python3 thunder_tpu_torch/benchmarks/gemm_rows.py [--rows 7,8,6,6b,2,4,5,9,10]
        [--iters 10] [--profile]

Each kernel is timed with CUDA events around ``--iters`` back-to-back calls
after a warm-up, on bf16 inputs made from a seed, and its launches are
counted by design (``cudaex.design_counts``). ``--profile`` also traces one
call of each with ``torch.profiler`` and prints the device time of each
CUDA kernel it launched (the sub-block's row pass, products and epilogue
passes apart). It uses only the wrappers that
every version of the port has, so the same script times another checkout's
kernels when that checkout's root comes first on ``PYTHONPATH``: that is how
two versions are compared in one call on one card. Needs a CUDA card;
prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import torch

# (row, kernel, rows N, D, F): the table's shapes
SHAPES = (
    ("7", "mlp_subblock", 16384, 4096, 14336),
    ("7", "mlp_subblock", 512, 4096, 14336),
    ("7", "mlp_subblock", 16384, 4096, 11008),
    ("7", "mlp_subblock", 8, 4096, 14336),
    ("8", "mlp_subblock_bwd", 16384, 4096, 14336),
    ("8", "mlp_subblock_bwd", 16384, 4096, 11008),
    ("6", "linear_act", 8, 4096, 14336),
    ("6b", "linear_act", 512, 4096, 14336),
    ("2", "sdpa_bwd causal", 8, 32, 2048),
    ("2", "sdpa_bwd", 8, 32, 2048),
    ("4", "rms_norm", 1, 8, 4096),
    ("4", "rms_norm", 8, 2048, 4096),
    ("5", "rms_norm_residual", 1, 8, 4096),
    ("5", "rms_norm_residual", 8, 2048, 4096),
    ("9", "paged_decode_attention", 8, 4096, 0),
    ("10", "decode_layer", 8, 4096, 14336),
    ("10", "attn_subblock", 8, 4096, 0),
    ("10", "attn_subblock len 1", 8, 4096, 0),
)
ATTN_HD = 128
# the decode rows' serving shape: context lengths, kv heads, grouped rows,
# page size, and the replay slot (its fresh row is written to page 0)
LENGTHS = (1, 17, 300, 512, 1000, 1500, 2047, 2048)
KV, G, PS, REPLAY = 8, 4, 16, 1


def decode_operands(rnd, gen, dev, lengths, D, F):
    """The operands of one planned decode step's layer at the serving shape:
    (h, wn, wq, wk, wv, wo, cos, sin, k pool, v pool, block tables, lengths,
    write positions) and the MLP's (mlp_norm, w_gate, w_up, w_down), bf16,
    every request's pages drawn at random from one pool."""
    S, H, hd = len(lengths), KV * G, ATTN_HD
    npg = 2048 // PS
    P = S * npg + 1
    perm = torch.randperm(P - 1, generator=gen, device=dev).add_(1).to(torch.int32)
    bt = torch.zeros(S, npg, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lengths):
        k = -(-n // PS)
        bt[b, :k] = perm[used:used + k]
        used += k
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    last = ln.long() - 1
    wp = bt.long().gather(1, (last // PS)[:, None])[:, 0] * PS + last % PS
    wp[REPLAY] = 0
    ang = torch.rand(S, 1, 1, hd // 2, generator=gen, device=dev) * 6.3
    norm = lambda: (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)  # noqa
    args = (rnd(S, 1, D, scale=0.25), norm(), rnd(H * hd, D, scale=D ** -0.5),
            rnd(KV * hd, D, scale=D ** -0.5), rnd(KV * hd, D, scale=D ** -0.5),
            rnd(D, H * hd, scale=(H * hd) ** -0.5), torch.cos(ang).to(torch.bfloat16),
            torch.sin(ang).to(torch.bfloat16), rnd(KV, P, PS, hd), rnd(KV, P, PS, hd), bt, ln,
            wp)
    mlp = ((norm(), rnd(F, D, scale=D ** -0.5), rnd(F, D, scale=D ** -0.5),
            rnd(D, F, scale=F ** -0.5)) if F else ())
    return args, mlp


# spin-kernel cycles per millisecond: the H100's 1.98 GHz top clock
SPIN_CYCLES_PER_MS = 1.98e6


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call: CUDA events around ``iters`` calls
    queued behind a spin kernel that outlasts the host's issuing them, so
    the events time the card's work back to back (a 0.1 ms kernel takes
    the host about as long to issue)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * issue_ms + 5.0) * SPIN_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile(fn) -> dict[str, float]:
    """Device ms of each CUDA kernel one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        ms = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)) / 1e3
        key = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
        key = re.split(r"[<(]", key)[0][:60]
        if ms > 0:
            out[key] = out.get(key, 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="7,8,6,6b,2,4,5,9,10",
                    help="table rows to time, comma separated")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile", action="store_true",
                    help="device time of each CUDA kernel of one call, from torch.profiler")
    args = ap.parse_args()
    from thunder_tpu_torch.executors import cudaex

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cudaex.build()
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    wanted = set(args.rows.split(","))
    results = []
    for row, name, N, D, F in SHAPES:
        if row not in wanted:
            continue
        lib, moved = None, None   # moved: the bytes of the row's bound, where bytes bound it
        if row == "2":   # (B, H, T) at hd 128, bf16; the 5-product count of the row's bound
            causal = name.endswith("causal")
            q, k, v, g = (rnd(N, D, F, ATTN_HD) for _ in range(4))
            out, lse = cudaex.sdpa_fwd(q, k, v, causal)
            fn = lambda: cudaex.sdpa_bwd(g, q, k, v, out, lse, causal)   # noqa: E731
            flops = 10.0 * N * D * F * F * ATTN_HD * (0.5 if causal else 1.0)
            fa = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal)
            lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(  # noqa
                g, q, k, v, fa[0], fa[1], fa[2], fa[3], fa[4], fa[5], 0.0, causal, fa[6],
                fa[7])
        elif row == "4":   # (N, D, F) rows of F
            x, w = rnd(N, D, F), (torch.rand(F, generator=gen, device=dev) + 0.5).to(bf16)
            fn = lambda: cudaex.rms_norm(x, w, 1e-5)   # noqa: E731
            lib = lambda: torch.nn.functional.rms_norm(x, (F,), w, 1e-5)   # noqa: E731
            flops = 4.0 * N * D * F
        elif row == "5":   # residual and x (N, D, F), rows of F; bytes as its bound
            r, x = rnd(N, D, F), rnd(N, D, F)
            w = (torch.rand(F, generator=gen, device=dev) + 0.5).to(bf16)
            fn = lambda: cudaex.rms_norm_residual(r, x, w, 1e-5)   # noqa: E731
            lib = lambda: torch.nn.functional.rms_norm(torch.add(r, x), (F,), w, 1e-5)  # noqa
            flops = 5.0 * N * D * F
            moved = 4 * N * D * F * 2 + F * 2
        elif row == "9":   # 8 requests over four rotating pool copies, bytes as its bound
            B, H, hd = len(LENGTHS), KV * G, ATTN_HD
            npg = 2048 // PS
            q = rnd(B, H, 1, hd)
            pools = [(rnd(KV, B * npg + 1, PS, hd), rnd(KV, B * npg + 1, PS, hd))
                     for _ in range(4)]
            (_, _, _, _, _, _, _, _, _, _, bt, ln, _), _ = decode_operands(rnd, gen, dev, LENGTHS,
                                                                           64, 0)
            turn = [0]

            def fn():
                kp, vp = pools[turn[0] % 4]
                turn[0] += 1
                return cudaex.paged_decode_attention(q, kp, vp, bt, ln)
            flops = 4.0 * sum(LENGTHS) * H * hd
            moved = sum(LENGTHS) * KV * hd * 2 * 2
        elif row == "10":
            lengths = (1,) * len(LENGTHS) if name.endswith("len 1") else LENGTHS
            dargs, mlp = decode_operands(rnd, gen, dev, lengths, D, F)
            if F:
                fn = lambda: cudaex.decode_layer(*dargs, *mlp)   # noqa: E731
            else:
                fn = lambda: cudaex.attn_subblock(*dargs)   # noqa: E731
            H = KV * G
            flops = (2.0 * N * (2 * H * ATTN_HD * D + 2 * KV * ATTN_HD * D + 3 * F * D)
                     + 4.0 * sum(lengths) * H * ATTN_HD)
            moved = ((2 * H * ATTN_HD * D + 2 * KV * ATTN_HD * D + 3 * F * D) * 2
                     + sum(lengths) * KV * ATTN_HD * 2 * 2)
        elif name == "linear_act":
            a, w = rnd(N, D), rnd(F, D, scale=D ** -0.5)
            fn = lambda: cudaex.linear_act(a, w, None, "silu")   # noqa: E731
            flops = 2.0 * N * D * F
        else:
            g, r, x = rnd(N, D), rnd(N, D, scale=0.25), rnd(N, D, scale=0.25)
            wn = (1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(bf16)
            ws = (rnd(F, D, scale=D ** -0.5), rnd(F, D, scale=D ** -0.5),
                  rnd(D, F, scale=F ** -0.5))
            if name == "mlp_subblock":
                fn = lambda: cudaex.mlp_subblock(r, x, wn, *ws)   # noqa: E731
                flops = 6.0 * N * D * F
            else:
                fn = lambda: cudaex.mlp_subblock_bwd(g, r, x, wn, *ws)   # noqa: E731
                flops = 16.0 * N * D * F
        cudaex.reset_launch_counts()
        ms = time_ms(fn, args.iters)
        res = {"row": row, "name": name, "shape": f"{N}x{D}x{F}", "ms": ms,
               "tflops": flops / ms / 1e9, "designs": cudaex.design_counts()}
        lib_key = "per_op_chain_ms" if row == "5" else "library_ms"
        if lib is not None:
            res[lib_key] = time_ms(lib, args.iters)
        if moved is not None:
            res["tb_per_s"] = moved / ms / 1e9
        print(f"row {row:3s} {name:17s} {N}x{D}x{F}: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, "
              + (f"{res['tb_per_s']:.2f} TB/s, " if moved is not None else "")
              + f"{cudaex.design_counts()}"
              + (f", {lib_key} {res[lib_key]:.4f} ms" if lib is not None else ""), flush=True)
        if args.profile:
            res["kernels_ms"] = profile(fn)
            print("    " + ", ".join(f"{k} {v:.4f}" for k, v in res["kernels_ms"].items()))
        results.append(res)
        del fn, lib
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "rows": results}))


if __name__ == "__main__":
    main()
