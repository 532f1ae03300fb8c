"""Build and bind the hand-written CUDA kernels.

`metamorph_tpu_torch/csrc/*.cu` compile with nvcc, one process per source,
all started together, with `-I csrc` for the shared headers (`*.cuh`, such
as `sm90.cuh`), and link into one shared library with a plain C interface,
which loads through ctypes. The library lands in `metamorph_tpu_torch/build/`
(listed in .gitignore) under a name keyed by a hash of the sources, the
headers and the flags, so a changed source or header rebuilds and an
unchanged tree is reused. Nothing here runs at import: the first kernel
launch builds and loads the library.

The sources include only CUDA's own headers, never PyTorch's, which keeps
the build at seconds rather than minutes. The TMA tensor maps need the
driver's `cuTensorMapEncodeTiled`, which `sm90.cuh` fetches through
`cudaGetDriverEntryPoint`, so the library links no more than the runtime.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of metamorph_tpu_torch are built from source")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources() + headers()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmetamorph_kernels_{h.hexdigest()[:16]}.so"


class _Library:
    """The loaded shared library, built on first use. `build_seconds` is
    the nvcc wall time of this process's build (0.0 when a build from an
    earlier process was reused); `ptxas_log` holds nvcc's output."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.ptxas_log = ""

    def build(self, verbose: bool = False) -> Path:
        out = library_path()
        if out.exists():
            if self.build_seconds is None:
                self.build_seconds = 0.0
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC),
             *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                                   str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            failed = [link.returncode] if link.returncode != 0 else []
        self.build_seconds = time.perf_counter() - t0
        self.ptxas_log = "\n".join(logs)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({failed}):\n{self.ptxas_log}")
        os.replace(tmp, out)
        return out

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                lib.mm_cuda_error_string.argtypes = [ctypes.c_int]
                lib.mm_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


LIBRARY = _Library()


class Kernel:
    """One C entry point of the library plus its launch count.

    `launch` calls the entry point, raises if it returned a nonzero
    cudaError_t (a refused launch never runs, and a later synchronize would
    not report it), and only then adds one to `launches`, when the wrapper
    names its call site to `sites[site]`, and when it names the kernel's
    form (kernel E's verify or fill kernel) to `forms[form]`."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.sites: Dict[str, int] = {}
        self.forms: Dict[str, int] = {}
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.sites = {}
        self.forms = {}

    def _bind(self):
        fn = getattr(LIBRARY.get(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def call(self, *args) -> None:
        """Calls the entry point and raises on a nonzero cudaError_t, with
        no count: for host-side helpers that launch nothing."""
        fn = self._fn or self._bind()
        err = fn(*args)
        if err != 0:
            msg = LIBRARY.get().mm_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")

    def launch(self, *args, site: Optional[str] = None,
               form: Optional[str] = None) -> None:
        fn = self._fn or self._bind()      # inline, not `call`: decode
        err = fn(*args)                    # launches kernel F ~225 times a step
        if err != 0:
            msg = LIBRARY.get().mm_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
        if site is not None:
            self.sites[site] = self.sites.get(site, 0) + 1
        if form is not None:
            self.forms[form] = self.forms.get(form, 0) + 1
