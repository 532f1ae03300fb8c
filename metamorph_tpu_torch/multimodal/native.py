"""ctypes bridge to the native packer (`metamorph_tpu_torch/native/packer.cpp`),
the counterpart of `metamorph_tpu/multimodal/native.py`.

`pack_sequences_native`, `jsonl_index_native` and `modality_lengths_native`
have the JAX package's signatures and results. The library builds on first
use with `g++ -O3 -fPIC -std=c++17 -shared` into `metamorph_tpu_torch/build/`
(git-ignored), under a name keyed by a hash of the source, the flags and the
C library, so a changed source rebuilds and an unchanged tree is reused. It
builds without `-march=native`: a copy of the tree, build directory
included, may run on a host with another CPU, where instructions of this
host's would die with SIGILL.

Where no compiler is found, `native_available()` is False and callers take
the Python packer, as the JAX package does. `pack` makes that choice and
counts it in `PACKS`, so a caller can tell which packer ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from metamorph_tpu_torch.constants import IGNORE_INDEX
from metamorph_tpu_torch.multimodal.packing import PackedBatch, pack_sequences

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "packer.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

# packs by packer, as `pack` chose them: {"native": n, "python": m}
PACKS: Counter = Counter()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(" ".join((platform.machine(), *platform.libc_ver())).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmmpack_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the packer unless this tree's library exists. Raises
    RuntimeError when no compiler is found or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for the native packer")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native packer build failed:\n{proc.stderr}")
    os.replace(tmp, out)     # atomic: concurrent builders race harmlessly
    return out


class _Native:
    """The loaded library, built on first use; `error` says why it is
    unavailable."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False
        self.error: Optional[str] = None

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if not self._tried:
                self._tried = True
                try:
                    self._lib = _bind(ctypes.CDLL(str(build())))
                except (OSError, RuntimeError) as e:
                    self.error = str(e)
            return self._lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mm_pack.restype = ctypes.c_int
    lib.mm_pack.argtypes = [i32p, i32p, i32p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int,
                            i32p, ctypes.c_int, ctypes.c_int,
                            i32p, i32p, i32p, i32p, i32p, u8p, i32p,
                            i32p, i32p, i32p, f32p, f32p]
    lib.jsonl_index.restype = ctypes.c_long
    lib.jsonl_index.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int64), ctypes.c_long]
    lib.modality_lengths.restype = ctypes.c_long
    lib.modality_lengths.argtypes = [ctypes.c_char_p, i32p, ctypes.c_long]
    return lib


NATIVE = _Native()


def native_available() -> bool:
    return NATIVE.get() is not None


def _lib() -> ctypes.CDLL:
    lib = NATIVE.get()
    if lib is None:
        raise RuntimeError(f"native packer unavailable: {NATIVE.error}")
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_sequences_native(
    input_ids: Sequence[Sequence[int]],
    labels: Optional[Sequence[Sequence[int]]],
    num_image_tokens: int,
    max_seq_len: int,
    num_image_slots: int,
    padding_side: str = "right",
    tokens_per_image: Optional[Sequence[int]] = None,
    gather_capacity: Optional[int] = None,
) -> PackedBatch:
    """`pack_sequences` in C++: the same arguments, the same PackedBatch."""
    lib = _lib()
    B, K, T, N = len(input_ids), num_image_tokens, max_seq_len, num_image_slots
    if tokens_per_image is not None:
        tpi = np.asarray(tokens_per_image, np.int32)
        A = gather_capacity if gather_capacity is not None else int(tpi.sum())
        tpi_ptr, n_tpi = _ptr(tpi, ctypes.c_int32), len(tpi)
    else:
        A = N * K
        tpi_ptr, n_tpi = None, 0
    flat_ids = np.asarray([t for row in input_ids for t in row], np.int32)
    if labels is None:
        flat_labs = np.full_like(flat_ids, IGNORE_INDEX)
    else:
        flat_labs = np.asarray([t for row in labels for t in row], np.int32)
        if flat_labs.shape != flat_ids.shape:
            raise ValueError("input_ids/labels length mismatch")
    row_lens = np.asarray([len(r) for r in input_ids], np.int32)

    tokens = np.zeros((B, T), np.int32)
    labels_out = np.zeros((B, T), np.int32)
    attn = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    gather = np.zeros((B, T), np.int32)
    is_img = np.zeros((B, T), np.uint8)
    ar_mask = np.zeros((B, T), np.int32)
    ar_b = np.zeros((A,), np.int32)
    ar_p = np.zeros((A,), np.int32)
    ar_t = np.zeros((A,), np.int32)
    ar_v = np.zeros((A,), np.float32)
    slot_used = np.zeros((N,), np.float32)

    rc = lib.mm_pack(
        _ptr(flat_ids, ctypes.c_int32), _ptr(flat_labs, ctypes.c_int32),
        _ptr(row_lens, ctypes.c_int32), B, K, T, N,
        1 if padding_side == "left" else 0,
        tpi_ptr, n_tpi, A,
        _ptr(tokens, ctypes.c_int32), _ptr(labels_out, ctypes.c_int32),
        _ptr(attn, ctypes.c_int32), _ptr(pos, ctypes.c_int32),
        _ptr(gather, ctypes.c_int32), _ptr(is_img, ctypes.c_uint8),
        _ptr(ar_mask, ctypes.c_int32), _ptr(ar_b, ctypes.c_int32),
        _ptr(ar_p, ctypes.c_int32), _ptr(ar_t, ctypes.c_int32),
        _ptr(ar_v, ctypes.c_float), _ptr(slot_used, ctypes.c_float))
    if rc != 0:
        raise ValueError(
            f"native packer error {rc} (-1/-2: image slots exceed budget {N}; "
            f"-3: more images than tokens_per_image entries)")

    return PackedBatch(
        tokens=tokens, labels=labels_out, attn_mask=attn, position_ids=pos,
        img_gather_idx=gather, is_image=is_img.astype(bool),
        image_ar_mask=ar_mask, ar_batch_idx=ar_b, ar_pred_pos=ar_p,
        ar_target_idx=ar_t, ar_valid=ar_v, image_slot_used=slot_used)


def pack(*args, **kwargs) -> PackedBatch:
    """The native packer where it built, else the Python one (the JAX
    collator's choice); counts the packer it used in `PACKS`."""
    if native_available():
        out = pack_sequences_native(*args, **kwargs)
        PACKS["native"] += 1
    else:
        out = pack_sequences(*args, **kwargs)
        PACKS["python"] += 1
    return out


def modality_lengths_native(path: str) -> np.ndarray:
    """Sign-coded per-line conversation word counts (positive = has image),
    computed in one native pass over the JSONL, with no per-line json.loads.
    Raises on malformed lines; callers fall back to the Python scan."""
    lib = _lib()
    n = lib.modality_lengths(path.encode(), None, 0)
    if n < 0:
        raise OSError(f"modality_lengths count failed on {path} ({n})")
    out = np.zeros((n,), np.int32)
    n2 = lib.modality_lengths(path.encode(), _ptr(out, ctypes.c_int32), n)
    if n2 != n:
        raise ValueError(f"modality_lengths failed on {path} ({n2})")
    return out


def jsonl_index_native(path: str) -> np.ndarray:
    """Byte offset of every line of a JSONL file."""
    lib = _lib()
    n = lib.jsonl_index(path.encode(), None, 0)
    if n < 0:
        raise OSError(f"jsonl_index failed on {path} ({n})")
    out = np.zeros((n,), np.int64)
    n2 = lib.jsonl_index(path.encode(),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
    if n2 != n:
        raise OSError(f"jsonl_index read {n2} of {n} lines of {path}")
    return out
