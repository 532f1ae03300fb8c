"""Kernels A, C and D of two source trees, side by side on one card.

Builds `flash_fwd.cu` and `flash_bwd.cu` (with the headers beside them) of
this checkout and of another one, such as the parent commit unpacked with
`git archive`, into two libraries, and times both through the port's
wrappers in turns (other, this, this, other) at the main paths' shapes
(H = 32, KV = 8, Dh = 128): kernel A causal at T = 2048 (the prefill
bucket) and T = 4096 (the train forward), non-causal T = 512 over S = 777,
ragged; kernel C (dq) causal at T = 4096 and T = 2048 and non-causal
T = 512 over S = 777 with an lse cotangent; kernel D causal at T = 4096 and
non-causal T = 512 over S = 777. The entry points keep one C signature
across the trees.

    python -m metamorph_tpu_torch.kernels.bench_flash_designs --other DIR

DIR is the root of the other checkout. Prints the card's name and power
limit, then one JSON line per case: for each tree the median ms of one
call alone (CUDA events around it, host time included) and of 20 calls
queued back to back, per call, and the largest error against the plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from metamorph_tpu_torch.kernels import _build
from metamorph_tpu_torch.ops import flash_attention as fa

KERNELS = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)


def _build_tree(csrc: Path, name: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "flash_designs" / name
    out.mkdir(parents=True, exist_ok=True)
    srcs = [csrc / "flash_fwd.cu", csrc / "flash_bwd.cu"]
    objs = [out / f"{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               str(csrc), "-c", "-o", str(o), str(s)])
             for s, o in zip(srcs, objs)]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError(f"nvcc failed on {csrc}")
    lib = out / "lib.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), *map(str, objs)], check=True)
    return ctypes.CDLL(str(lib))


def _use(lib) -> None:
    for kern in KERNELS:
        fn = getattr(lib, kern.symbol)
        fn.argtypes = kern.argtypes
        fn.restype = ctypes.c_int
        kern._fn = fn


def _ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _cases(dev, gen):
    H, KV, Dh = 32, 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for kernel, B, T, S, causal, lens in (
            ("A", 1, 2048, 2048, True, [2048]),
            ("A", 1, 4096, 4096, True, [4096]),
            ("A", 2, 512, 777, False, [777, 600]),
            ("C", 1, 4096, 4096, True, [4096]),
            ("C", 1, 2048, 2048, True, [2048]),
            ("C", 2, 512, 777, False, [777, 600]),
            ("D", 1, 4096, 4096, True, [4096]),
            ("D", 2, 512, 777, False, [777, 600])):
        # model layout, read through strides, as the main paths call them
        q, k, v, do = (randn(B, T, H, Dh), randn(B, S, KV, Dh),
                       randn(B, S, KV, Dh), randn(B, T, H, Dh))
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = Dh ** -0.5
        if kernel == "A":
            ref, _ = fa.flash_attention_plain(qt.float(), kt.float(),
                                              vt.float(), lengths, causal)
            call = lambda: fa._fwd(qt, kt, vt, lengths, causal, scale)[0]
            outs = lambda o: [(o, ref)]
        elif kernel == "C":
            # the non-causal case carries an lse cotangent, as ring
            # attention's chunks do
            o, lse = fa.flash_attention_plain(qt.float(), kt.float(),
                                              vt.float(), lengths, causal)
            o = o.to(torch.bfloat16)
            dlse = None if causal else torch.randn(lse.shape, generator=gen,
                                                   device=dev)
            rq, _, _ = fa.flash_attention_bwd_plain(
                qt.float(), kt.float(), vt.float(), o.float(), lse,
                dot.float(), dlse, lengths, causal, scale)
            dd = (dot.float() * o.float()).sum(-1)
            dd = (dd if dlse is None else dd - dlse).contiguous()
            dq = torch.empty_like(qt)

            def call():
                fa._launch_dq(qt, kt, vt, dot, lse, dd, dq, lengths, causal,
                              scale)
                return dq

            outs = lambda r: [(r, rq)]
        else:
            o, lse = fa.flash_attention_plain(qt.float(), kt.float(),
                                              vt.float(), lengths, causal)
            o = o.to(torch.bfloat16)
            _, rk, rv = fa.flash_attention_bwd_plain(
                qt.float(), kt.float(), vt.float(), o.float(), lse,
                dot.float(), None, lengths, causal, scale)
            dd = (dot.float() * o.float()).sum(-1).contiguous()
            dk, dv = torch.empty_like(kt), torch.empty_like(vt)

            def call():
                fa._launch_dkv(qt, kt, vt, dot, lse, dd, dk, dv, lengths,
                               causal, scale)
                return dk, dv

            outs = lambda r: [(r[0], rk), (r[1], rv)]
        yield dict(kernel=kernel, B=B, T=T, S=S, causal=causal,
                   lengths=lens, dlse=kernel == "C" and not causal), call, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_designs needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {"other": _build_tree(
                Path(args.other) / "metamorph_tpu_torch" / "csrc", "other"),
            "this": _build_tree(_build.CSRC, "this")}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    for res, call, outs in _cases(dev, gen):
        for name in ("other", "this", "this", "other"):
            _use(libs[name])
            err = max((x.float() - r).abs().max().item()
                      for x, r in outs(call()))
            res[f"{name}_max_abs_err"] = err
            res.setdefault(f"{name}_ms", []).append(_ms(call, 1))
            res.setdefault(f"{name}_ms_queued", []).append(_ms(call, 20))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
