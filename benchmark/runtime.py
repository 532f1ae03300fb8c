"""What every run shares: where caches go, the look for the card, the
card's name and power limit, the check that no JAX was loaded, and the
host-clock spans that the per-layer metrics read."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the JAX package and its libraries, by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "metamorph_tpu")


def set_cache_dirs() -> None:
    """Fixed directories inside the checkout for every build and kernel
    cache (the port builds its kernels into `metamorph_tpu_torch/build/`
    already), set before torch initialises CUDA."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    # the model and its state run near the card's memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: `metamorph_tpu_torch` is not
    `metamorph_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def log(*a) -> None:
    print("bench:", *a, file=sys.stderr, flush=True)


def power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:          # noqa: BLE001 -- reported, not fatal
        return f"nvidia-smi unavailable: {e}"


class Spans:
    """Host-clock spans (perf_counter_ns) of the benchmark's own calls
    into the program's layers."""

    def __init__(self):
        self.items = []

    def add(self, name: str, t0: int, t1: int, **info) -> None:
        self.items.append(dict(name=name, t0=t0, t1=t1, **info))
