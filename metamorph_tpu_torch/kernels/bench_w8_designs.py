"""Kernel F (the weight-only int8 product) of two source trees, side by side
on one card.

Builds every `csrc/*.cu` of this checkout and of another one, such as the
parent commit unpacked with `git archive`, into two libraries, loads each
tree's own `ops/quant.py` beside it (the C signatures of kernel F differ
between designs, so each tree's wrapper calls its own library), and times
both through their wrappers in turns at the 8B shapes (K, N) of
`chip_smoke.py` 11a:
  * M = 8 and 32 rows on the five decode shapes (wq / wo, wk / wv, gate /
    up, down, the lm head): other, this, this, other;
  * M = 32, 48 and 64 on the four layer shapes, this tree in both forms
    (GEMV_MAX_M set to 64, then to 0): other, gemv, tiled, tiled, gemv,
    other; this sets where the gemv form should end;
  * M = 264 (the fill step's 8 + 256 rows) and 4096 on the four layer
    shapes: other, this, this, other.
Successive calls rotate over copies of the weight that exceed the card's
50 MB L2 together (at least 64 MB), so each call finds its weight out of
L2, as a decode step does.

    python -m metamorph_tpu_torch.kernels.bench_w8_designs --other DIR \
        [--rows 8,264]

DIR is the root of the other checkout; --rows keeps only the cases of
those row counts. Prints the card's name and power
limit, then one JSON line per case: for each tree (or form) the median ms
per call (a CUDA graph of 20 calls up to M = 64, device time only; 20
calls queued beyond), the bound's share of it, and the largest error
against the plain version relative to its largest value.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import subprocess
from pathlib import Path

import torch

from metamorph_tpu_torch.kernels import _build
from metamorph_tpu_torch.kernels.bench_decode_designs import _build_trees
from metamorph_tpu_torch.kernels.bench_decode_designs import _graph
from metamorph_tpu_torch.kernels.bench_flash_designs import _ms as _queued

DECODE_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 128256))
LAYER_SHAPES = DECODE_SHAPES[:4]
ROTATE_BYTES = 64 * 2**20
PEAK_HBM_TBS, PEAK_BF16_TFLOPS = 3.35, 989.0   # H100 SXM data sheet


def _wrappers(root: Path, name: str, lib):
    """The tree's ops/quant.py as its own module, every kernel entry point
    it declares bound to the tree's library."""
    path = root / "metamorph_tpu_torch" / "ops" / "quant.py"
    spec = importlib.util.spec_from_file_location(f"_quant_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for kern in vars(mod).values():
        if isinstance(kern, _build.Kernel):
            fn = getattr(lib, kern.symbol)
            fn.argtypes = kern.argtypes
            fn.restype = ctypes.c_int
            kern._fn = fn
    return mod


def bound_ms(M: int, K: int, N: int) -> float:
    """x, the int8 weight, the scales and the bf16 output moved once, or
    the products at the bf16 tensor rate, whichever takes longer."""
    nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
    return max(nbytes / (PEAK_HBM_TBS * 1e9), 2 * M * N * K /
               (PEAK_BF16_TFLOPS * 1e9))


def _cases():
    both = ("other", "this", "this", "other")
    forms = ("other", "gemv", "tiled", "tiled", "gemv", "other")
    for M in (8, 32):
        for K, N in DECODE_SHAPES:
            yield M, K, N, both
    for M in (32, 48, 64):
        for K, N in LAYER_SHAPES:
            yield M, K, N, forms
    for M in (264, 4096):
        for K, N in LAYER_SHAPES:
            yield M, K, N, both


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rows", default="",
                    help="comma-separated row counts to keep (default: all)")
    args = ap.parse_args(argv)
    rows = {int(r) for r in args.rows.split(",") if r}
    if not torch.cuda.is_available():
        raise SystemExit("bench_w8_designs needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    roots = {"other": Path(args.other).resolve(),
             "this": _build.CSRC.parent.parent}
    libs = _build_trees({n: r / "metamorph_tpu_torch" / "csrc"
                         for n, r in roots.items()})
    mods = {n: _wrappers(roots[n], n, libs[n]) for n in roots}
    for form, max_m in (("gemv", 64), ("tiled", 0)):
        mods[form] = _wrappers(roots["this"], form, libs["this"])
        mods[form].GEMV_MAX_M = max_m
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    for M, K, N, turns in _cases():
        if rows and M not in rows:
            continue
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        base = mods["this"].quantize_weight(w)
        del w
        n_copies = 1 if K * N > ROTATE_BYTES else math.ceil(
            ROTATE_BYTES / (K * N))
        qs = [(base.q.clone(), base.scale.clone()) for _ in range(n_copies)]
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        ref = mods["this"].quantized_matmul_plain(x.float(), base)
        b = bound_ms(M, K, N)
        res = dict(M=M, K=K, N=N, copies=n_copies, bound_ms=b,
                   timer="cuda graph of 20 calls" if M <= 64 else
                   "20 calls queued")
        for name in turns:
            mod = mods[name]
            ws = [mod.QuantizedWeight(q, s) for q, s in qs]
            out = mod.quantized_matmul(x, ws[0])
            res[f"{name}_rel_err"] = ((out.float() - ref).abs().max()
                                      / ref.abs().max()).item()
            turn = [0]

            def call():
                turn[0] = (turn[0] + 1) % len(ws)
                mod.quantized_matmul(x, ws[turn[0]])

            ms = _graph(call) if M <= 64 else _queued(call, 20)
            res.setdefault(f"{name}_ms", []).append(ms)
            res.setdefault(f"{name}_share", []).append(b / ms)
            del ws
        print(json.dumps(res), flush=True)
        del qs, base, x, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
