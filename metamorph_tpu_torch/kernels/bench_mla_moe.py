"""Kernel G and the routed experts' grouped products on one card, at the
serving path's shapes of Kimi-VL-A3B's decoder (16 heads, latent 512 +
rope 64; 64 experts of 2,048 x 1,408, 6 a token):
  * kernel G (`ops/mla_decode.py`) over a 128-slot, 4,096-token latent
    cache, 64 rows advancing at lengths drawn from 32-3,000 and 64 idle
    rows of one key, against its plain version;
  * one expert layer's routing, dispatch, three grouped products and
    combine (`ops/moe.experts_forward`) at 128 decode rows and at 8,192
    prefill tokens, and the three products alone.
Launches alternate between copies of the inputs larger than L2, so each
finds its operands in device memory.

    python -m metamorph_tpu_torch.kernels.bench_mla_moe

Prints the card's name and power limit, then one JSON line per case: the
median ms per call from a CUDA graph of 20 calls (device time), the
least time the card could take (bytes over 3.35 TB/s or FLOPs over 989
TFLOP/s, whichever is larger) and its share of the measured time, and
for kernel G the plain version's ms and the largest error against it.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from metamorph_tpu_torch.ops import mla_decode, moe

H, D_LAT, D_V, S, B = 16, 576, 512, 4096, 128
D, E, K, FE = 2048, 64, 6, 1408


def _graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / 3.35e9, flops / 989e9)


def _row(case: str, ms: float, nbytes: float, flops: float, **extra):
    b = _bound_ms(nbytes, flops)
    print(json.dumps(dict(case=case, ms=round(ms, 4), bound_ms=round(b, 4),
                          share=round(b / ms, 3), **extra)), flush=True)


def kernel_g(dev, gen) -> None:
    copies = 4            # 4 x 604 MB of latent rows: none stays in L2
    caches = [torch.randn((1, B, S, D_LAT), generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(copies)]
    q = torch.randn((B, H, D_LAT), generator=gen, device=dev
                    ).to(torch.bfloat16)
    lens = torch.ones(B, dtype=torch.int32, device=dev)
    lens[:B // 2] = torch.randint(32, 3001, (B // 2,), generator=gen,
                                  device=dev, dtype=torch.int32)
    scale = 192 ** -0.5
    turn = [0]

    def call():
        turn[0] += 1
        mla_decode.mla_decode_attention(q, caches[turn[0] % copies], lens, 0,
                                        D_V, scale)

    ms = _graph_ms(call)
    got = mla_decode.mla_decode_attention(q, caches[0], lens, 0, D_V, scale)
    torch.cuda.synchronize()
    t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t[0].record()
    want = mla_decode.mla_decode_plain(q.float(), caches[0][0].float(), lens,
                                       D_V, scale)
    t[1].record()
    torch.cuda.synchronize()
    active = lens[:B // 2].tolist()
    keys = sum(active)
    _row("kernelG", ms, 2 * D_LAT * keys + 2 * len(active) * H * (D_LAT
                                                                  + D_V),
         2 * H * (D_LAT + D_V) * keys, plain_ms=round(t[0].elapsed_time(
             t[1]), 3), max_err=float((got.float() - want).abs().max()),
         rows=len(active), keys=keys)


def experts(dev, gen, n: int) -> None:
    copies = 2 if n > 1024 else 3   # each copy 1.66 GB of expert weights
    layers = [tuple(torch.randn((E, a, b), generator=gen, device=dev
                                ).to(torch.bfloat16) * a ** -0.5
                    for a, b in ((D, FE), (D, FE), (FE, D)))
              for _ in range(copies)]
    router = (torch.randn((D, E), generator=gen, device=dev)
              * D ** -0.5).to(torch.bfloat16)
    bias = torch.zeros(E, device=dev)
    x = torch.randn((n, D), generator=gen, device=dev).to(torch.bfloat16)
    idx, w = moe.route(x, router, bias, K, 2.446)
    counts = moe.expert_counts(idx, E)
    touched = int((counts > 0).sum())
    order, offs = moe.dispatch(idx, E)
    xs = x[order // K]
    h = torch.randn((n * K, FE), generator=gen, device=dev
                    ).to(torch.bfloat16)
    turn = [0]

    def layer():
        turn[0] += 1
        g, u, d = layers[turn[0] % copies]
        idx, w = moe.route(x, router, bias, K, 2.446)
        moe.experts_forward(x, idx, w, g, u, d)

    def products():
        turn[0] += 1
        g, u, d = layers[turn[0] % copies]
        moe.grouped_mm(xs, g, offs)
        moe.grouped_mm(xs, u, offs)
        moe.grouped_mm(h, d, offs)

    picks = n * K
    nbytes = 2 * 3 * D * FE * touched + 2 * picks * (2 * D + 3 * FE)
    flops = 2 * 3 * D * FE * picks
    _row(f"expert_layer_{n}", _graph_ms(layer), nbytes, flops,
         touched=touched)
    _row(f"grouped_products_{n}", _graph_ms(products), nbytes, flops,
         touched=touched)


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        kernel_g(dev, gen)
        torch.cuda.empty_cache()
        for n in (B, 8192):
            experts(dev, gen, n)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
