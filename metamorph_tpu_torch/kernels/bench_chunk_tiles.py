"""Kernel E's two CTA shapes at the speculative-verify shape, on the card.

Kernel E (`csrc/chunk_attn.cu`) launches 16-query-row CTAs (WQ = 1, four
warps splitting each key tile, merged through shared memory) when a
(chunk, kv head) has at most 16 query rows, and 64-row CTAs (WQ = 4)
otherwise. This script builds the source twice, as shipped and with the
16-row shape switched off, and times both through the port's wrapper at
the verify shape of the serving path (B = 8 rows, C = spec_k = 4, H = 32,
KV = 8, Dh = 128, S = 4096 + 12), bf16 and int8, ragged and long offsets,
each against the plain version:

    python -m metamorph_tpu_torch.kernels.bench_chunk_tiles

Prints the card's name and power limit, then one JSON line per case with
the median ms of each build (CUDA events, two alternating rounds) and its
largest error relative to each query row's own magnitude.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import torch

from metamorph_tpu_torch.kernels import _build
from metamorph_tpu_torch.ops import decode_attention as da
from metamorph_tpu_torch.ops.quant import quantize_kv

NARROW = "const bool narrow = (H / KV) * C <= 16;"


def _build_variants() -> dict:
    src = (_build.CSRC / "chunk_attn.cu").read_text()
    if NARROW not in src:
        raise RuntimeError("chunk_attn.cu no longer picks its CTA shape with "
                           f"`{NARROW}`")
    texts = {"wq1": src, "wq4": src.replace(NARROW,
                                            "const bool narrow = false;")}
    out = _build.BUILD_DIR / "chunk_tiles"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = out / f"chunk_attn_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(out / f"{name}.so"), str(cu)])
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} build")
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in texts}


def _use(lib) -> None:
    for kern in (da.CHUNK_ATTN, da.CHUNK_ATTN_INT8):
        fn = getattr(lib, kern.symbol)
        fn.argtypes = kern.argtypes
        fn.restype = ctypes.c_int
        kern._fn = fn


def _cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_chunk_tiles needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = _build_variants()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(777)
    H, KV, Dh, L, B, C, S_max = 32, 8, 128, 4, 8, 4, 4096
    S = S_max + C + 8
    offsets = {"ragged": [S_max - 4, 17, S_max // 4, S_max - 96,
                          S_max * 5 // 8, 0, S_max * 13 // 16, S_max // 7],
               "long": [S_max - 4] * B}
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    layer = 2
    for oname, offs in offsets.items():
        k = torch.randn(L, B, KV, S, Dh, generator=gen, device=dev)
        v = torch.randn(L, B, KV, S, Dh, generator=gen, device=dev)
        q = torch.randn(B, C, H, Dh, generator=gen, device=dev).to(
            torch.bfloat16)
        offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        for quant in (False, True):
            if quant:
                (kc, ksc), (vc, vsc) = quantize_kv(k), quantize_kv(v)
            else:
                kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
                ksc = vsc = None
            ref = da.chunk_attention_plain(
                q.float(), kc[layer], vc[layer], offs_t,
                k_scale=None if ksc is None else ksc[layer],
                v_scale=None if vsc is None else vsc[layer])

            def call(l):
                return da.chunk_attention_batched(
                    q, kc, vc, offs_t, layer=l, k_scale=ksc, v_scale=vsc,
                    rows=rows)

            res = {"offsets": oname, "offs": offs,
                   "dtype": "int8" if quant else "bf16", "B": B, "C": C,
                   "S": S}
            for _ in range(2):                  # wq1, wq4, wq1, wq4
                for name, lib in libs.items():
                    _use(lib)
                    o = call(layer).float()
                    rel = ((o - ref).abs().amax(-1)
                           / ref.abs().amax(-1).clamp_min(1e-3)).max().item()
                    res[f"{name}_max_rel_err"] = rel
                    flip = [layer]

                    def kern():   # alternate layers: each launch reads cold
                        flip[0] = 0 if flip[0] == layer else layer
                        call(flip[0])

                    res.setdefault(f"{name}_ms", []).append(_cuda_ms(kern))
            print(json.dumps(res), flush=True)
            del kc, vc, ksc, vsc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
