"""Kernel B and kernel E (both forms) of two source trees, side by side on
one card.

Builds every `csrc/*.cu` of this checkout and of another one, such as the
parent commit unpacked with `git archive`, into two libraries, loads each
tree's own `ops/decode_attention.py` beside it (the C signatures differ
between designs, so each tree's wrappers call its own library), and times
both in turns (other, this, this, other) at the serving path's shapes
(H = 32, KV = 8, Dh = 128, a 4,096-token cache):
  * K5 bf16: kernel B, B = 8 ragged rows (11,696 window keys);
  * K5 int8: kernel B's int8 branch, 8 full rows;
  * K6 bf16 and int8: kernel E's fill form, one 256-token chunk at offset
    3840;
  * K7 bf16 and int8: kernel E's verify form, 8 chunks of 4 tokens at
    ragged offsets over a 4,108-token cache (`chip_smoke.py` 3c's case),
    with stale entries past each chunk. This tree runs it at two grid
    densities, VERIFY_CTAS_PER_SM = 4 and 8 (`this4`, `this8`: other,
    this4, this8, this8, this4, other).
Launches alternate between two layers of the stacked cache, so each finds
its rows out of L2.

    python -m metamorph_tpu_torch.kernels.bench_decode_designs --other DIR

DIR is the root of the other checkout. Prints the card's name and power
limit, then one JSON line per case: for each tree the median ms per call
from a CUDA graph of 20 calls (device time, `ms`), of 20 calls queued back
to back (`ms_queued`) and of one call alone (`ms_alone`, host time
included), and the largest error against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import torch

from metamorph_tpu_torch.kernels import _build
from metamorph_tpu_torch.kernels.bench_flash_designs import _ms as _queued
from metamorph_tpu_torch.ops.quant import quantize_kv

SYMBOLS = ("DECODE_ATTN", "DECODE_ATTN_INT8", "CHUNK_ATTN", "CHUNK_ATTN_INT8")


def _build_trees(trees: dict) -> dict:
    """One library per tree, every nvcc of both trees started together."""
    procs, objs = [], {}
    for name, csrc in trees.items():
        out = _build.BUILD_DIR / "decode_designs" / name
        out.mkdir(parents=True, exist_ok=True)
        objs[name] = []
        for src in sorted(csrc.glob("*.cu")):
            obj = out / f"{src.stem}.o"
            objs[name].append(obj)
            procs.append(subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-c",
                 "-o", str(obj), str(src)]))
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("nvcc failed")
    libs = {}
    for name, obj_list in objs.items():
        lib = obj_list[0].parent / "lib.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(lib), *map(str, obj_list)], check=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _wrappers(root: Path, name: str, lib):
    """The tree's ops/decode_attention.py as its own module, its kernels
    bound to the tree's library."""
    path = root / "metamorph_tpu_torch" / "ops" / "decode_attention.py"
    spec = importlib.util.spec_from_file_location(f"_decode_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for sym in SYMBOLS:
        kern = getattr(mod, sym)
        fn = getattr(lib, kern.symbol)
        fn.argtypes = kern.argtypes
        fn.restype = ctypes.c_int
        kern._fn = fn
    return mod


def _graph(fn, calls: int = 20) -> float:
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
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _cases(dev, gen):
    """(description, call(mod, layer) -> output, plain(mod) -> reference,
    the trees in turn)."""
    L, B, H, KV, S, Dh = 2, 8, 32, 8, 4096, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = randn(B, H, Dh).to(torch.bfloat16)
    k, v = randn(L, B, KV, S, Dh), randn(L, B, KV, S, Dh)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    caches = {"bf16": (k.to(torch.bfloat16), v.to(torch.bfloat16), {}),
              "int8": (k8, v8, dict(k_scale=ks, v_scale=vs))}
    del k, v
    ragged = torch.tensor([1, 1024, 1025, 4096, 37, 2000, 3000, 513],
                          dtype=torch.int32, device=dev)
    full = torch.full((B,), S, dtype=torch.int32, device=dev)
    turns = ("other", "this", "this", "other")
    for dtype, lengths in (("bf16", ragged), ("int8", full)):
        ck, cv, sc = caches[dtype]
        yield (dict(kernel="B", dtype=dtype, B=B, S=S,
                    lengths=lengths.tolist()),
               lambda m, l, ck=ck, cv=cv, sc=sc, n=lengths:
                   m.decode_attention(q, ck, cv, n, layer=l, **sc),
               lambda m, ck=ck, cv=cv, sc=sc, n=lengths:
                   m.decode_attention_plain(
                       q.float(), ck[0], cv[0], n,
                       **{a: x[0] for a, x in sc.items()}), turns)
    C, off, row = 256, S - 256, 5
    qc = randn(C, H, Dh).to(torch.bfloat16)
    r_t = torch.tensor([row], dtype=torch.int32, device=dev)
    o_t = torch.tensor([off], dtype=torch.int32, device=dev)
    for dtype in ("bf16", "int8"):
        ck, cv, sc = caches[dtype]
        scr = {a: x[0][r_t] for a, x in sc.items()}
        yield (dict(kernel="E fill", dtype=dtype, C=C, S=S, offset=off),
               lambda m, l, ck=ck, cv=cv, sc=sc:
                   m.chunk_attention(qc, ck, cv, r_t, o_t, layer=l, **sc),
               lambda m, ck=ck, cv=cv, scr=scr:
                   m.chunk_attention_plain(qc[None].float(), ck[0][r_t],
                                           cv[0][r_t], o_t, **scr)[0],
               turns)
    del caches
    # K7: the spec step's verify chunks (S = 4096 + spec_k + 8)
    Sv, Cv = S + 12, 4
    offs = [S - 4, 17, S // 4, S - 96, S * 5 // 8, 0, S * 13 // 16, S // 7]
    k, v = randn(L, B, KV, Sv, Dh), randn(L, B, KV, Sv, Dh)
    for r, off in enumerate(offs):     # stale entries past each chunk
        k[:, r, :, off + Cv:] = 30.0
        v[:, r, :, off + Cv:] = -50.0
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    caches = {"bf16": (k.to(torch.bfloat16), v.to(torch.bfloat16), {}),
              "int8": (k8, v8, dict(k_scale=ks, v_scale=vs))}
    del k, v
    qv = randn(B, Cv, H, Dh).to(torch.bfloat16)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    for dtype in ("bf16", "int8"):
        ck, cv, sc = caches[dtype]
        yield (dict(kernel="E verify", dtype=dtype, B=B, C=Cv, S=Sv,
                    offs=offs),
               lambda m, l, ck=ck, cv=cv, sc=sc:
                   m.chunk_attention_batched(qv, ck, cv, offs_t, layer=l,
                                             rows=rows, **sc),
               lambda m, ck=ck, cv=cv, sc=sc:
                   m.chunk_attention_plain(qv.float(), ck[0], cv[0], offs_t,
                                           **{a: x[0] for a, x in sc.items()}),
               ("other", "this4", "this8", "this8", "this4", "other"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_designs needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = {"other": Path(args.other).resolve(),
             "this": _build.CSRC.parent.parent}
    libs = _build_trees({n: r / "metamorph_tpu_torch" / "csrc"
                         for n, r in roots.items()})
    mods = {n: _wrappers(roots[n], n, libs[n]) for n in roots}
    # this tree's verify form at two grid densities
    for density in (4, 8):
        mods[f"this{density}"] = _wrappers(roots["this"], f"this{density}",
                                           libs["this"])
        mods[f"this{density}"].VERIFY_CTAS_PER_SM = density
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    for res, call, plain, turns in _cases(dev, gen):
        for name in turns:
            mod = mods[name]
            ref = plain(mod)
            res[f"{name}_max_abs_err"] = (call(mod, 0).float() - ref).abs(
                ).max().item()
            flip = [0]

            def kern():
                flip[0] ^= 1
                call(mod, flip[0])

            res.setdefault(f"{name}_ms", []).append(_graph(kern))
            res.setdefault(f"{name}_ms_queued", []).append(_queued(kern, 20))
            res.setdefault(f"{name}_ms_alone", []).append(_queued(kern, 1))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
