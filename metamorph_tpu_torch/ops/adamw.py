"""Kernel H (`csrc/adamw.cu`): AdamW in two passes over the optimizer
state, on CUDA tensors.

The plain version is `train/optimizer.py`'s chain (`AdamW.global_norm`,
`adamw_chunk_`), which CPU tensors take; this module is what CUDA tensors
take, with the same arithmetic in the same order (the update bitwise the
plain chain's for the same norm).

Each step the host builds a table of the tensors to update (`build_table`:
one 64-byte `ENTRY` per tensor with its pointers, numel, first work block
of `BLOCK` elements, the group's lr in fp32 and its norm group), and copies
it to the card once from pinned memory without a sync (`upload`); the
gradients are reallocated every step, so the table is too. Then:
  * `group_sums`: the sum-of-squares pass (one fp32 partial per work block)
    and the per-group reduction (fixed order, fp64): [n_groups] fp32 on the
    card, which the caller all-reduces per group and turns into the norm;
  * `update`: one launch per dtype combination of (p, g, moments) over the
    table's entries, the clip reading the norm from device memory (the
    offloaded update passes each staged chunk as a one-entry table).
A tensor that is not a contiguous bf16 or fp32 CUDA tensor raises: nothing
here falls back to the plain chain.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from metamorph_tpu_torch.kernels._build import Kernel

BLOCK = 8192   # elements per work block (csrc/adamw.cu kBlock)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ADAMW_SUMSQ = Kernel("mm_adamw_sumsq", [_P, _I, _L, _P, _P])
ADAMW_REDUCE = Kernel("mm_adamw_reduce", [_P, _I, _I, _P, _P, _P])
ADAMW_UPDATE = Kernel("mm_adamw_update", [_P, _I, _I, _L, _L, _I, _P, _P, _P])
KERNELS = (ADAMW_SUMSQ, ADAMW_REDUCE, ADAMW_UPDATE)

# csrc/adamw.cu's Entry
ENTRY = np.dtype([("p", "<u8"), ("g", "<u8"), ("mu", "<u8"), ("nu", "<u8"),
                  ("numel", "<i8"), ("blk", "<i8"), ("lr", "<f4"),
                  ("group", "<i4"), ("g_bf16", "<i4"), ("pad", "<i4")])
assert ENTRY.itemsize == 64


class Scalars(ctypes.Structure):
    """csrc/adamw.cu's Scalars: the fp32 values PyTorch's kernels use for
    the plain chain's host scalars."""
    _fields_ = [(n, ctypes.c_float) for n in (
        "c1", "b1", "c2", "b2", "inv_bc1", "inv_bc2", "eps", "wd",
        "max_norm")] + [("has_wd", ctypes.c_int), ("clip", ctypes.c_int)]


_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def scalars(count: int, b1: float, b2: float, eps: float, wd: float,
            max_norm: Optional[float]) -> Scalars:
    """The update's scalars at step `count` (bias correction at count + 1),
    each as PyTorch's CUDA kernels see the plain chain's Python floats: a
    scalar operand cast to fp32, and a division by a host scalar done as a
    product with its reciprocal, taken in fp64 and then cast to fp32 (on
    an H100 with torch 2.11, `x / s` matched x * fp32(1 / s) bitwise for
    600 of 600 bias corrections, x * (1 / fp32(s)) for 482). `max_norm`
    None: no clip."""
    f = np.float32
    bc1 = 1 - b1 ** (count + 1)
    bc2 = 1 - b2 ** (count + 1)
    return Scalars(c1=f(1 - b1), b1=f(b1), c2=f(1 - b2), b2=f(b2),
                   inv_bc1=f(1 / bc1), inv_bc2=f(1 / bc2), eps=f(eps),
                   wd=f(wd), max_norm=f(max_norm or 0.0), has_wd=int(bool(wd)),
                   clip=int(max_norm is not None))


def dtype_code(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor) -> int:
    """mm_adamw_update's `dtypes`: bit 0 p, bit 1 g, bit 2 the moments, 1
    for bf16."""
    return _BF16[p.dtype] | _BF16[g.dtype] << 1 | _BF16[m.dtype] << 2


@dataclass
class Table:
    """The host side of a step's table. `entries` are sorted by dtype
    combination (stable: the given order within one); `runs` holds
    (dtypes, lo, hi, blk_lo, blk_hi) per combination; `tensors` the
    (p, g, mu, nu) of each entry, in its order."""
    entries: np.ndarray
    runs: List[Tuple[int, int, int, int, int]]
    n_blocks: int
    n_groups: int
    elements: int
    tensors: list


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype not in _BF16:
        raise ValueError(f"kernel H takes bf16 or fp32 tensors; {name} is "
                         f"{t.dtype}")
    if not t.is_contiguous() or t.numel() != like.numel():
        raise ValueError(f"kernel H: {name} must be contiguous with "
                         f"{like.numel()} elements")


def build_table(items: Sequence[tuple], n_groups: int) -> Table:
    """items: (p, g, mu, nu, lr, group) per tensor to update, group in
    [0, n_groups); mu and nu may be None (a table for the norm pass only,
    the offloaded update's). Tensors with no element are left out."""
    rows = []
    for p, g, mu, nu, lr, group in items:
        _check("g", g, p)
        _check("p", p, p)
        if mu is not None:
            _check("mu", mu, p)
            _check("nu", nu, p)
            if mu.dtype != nu.dtype:
                raise ValueError("kernel H: mu and nu differ in dtype")
        if not 0 <= group < n_groups:
            raise ValueError(f"norm group {group} not in [0, {n_groups})")
        if p.numel():
            code = dtype_code(p, g, p if mu is None else mu)
            rows.append((code, p, g, mu, nu, lr, group))
    rows.sort(key=lambda r: r[0])
    entries = np.zeros(len(rows), dtype=ENTRY)
    numel = [r[1].numel() for r in rows]
    blocks = np.cumsum([0] + [-(-n // BLOCK) for n in numel])
    for col, vals in (
            ("p", [r[1].data_ptr() for r in rows]),
            ("g", [r[2].data_ptr() for r in rows]),
            ("mu", [0 if r[3] is None else r[3].data_ptr() for r in rows]),
            ("nu", [0 if r[4] is None else r[4].data_ptr() for r in rows]),
            ("numel", numel), ("blk", blocks[:-1]),
            ("lr", [r[5] for r in rows]), ("group", [r[6] for r in rows]),
            ("g_bf16", [_BF16[r[2].dtype] for r in rows])):
        entries[col] = vals
    runs = []
    for i, r in enumerate(rows):
        if not runs or runs[-1][0] != r[0]:
            runs.append([r[0], i, len(rows), int(blocks[i]),
                         int(blocks[-1])])
            if len(runs) > 1:
                runs[-2][2], runs[-2][4] = i, int(blocks[i])
    return Table(entries, [tuple(r) for r in runs], int(blocks[-1]),
                 n_groups, int(sum(numel)), [r[1:5] for r in rows])


def _check_device(table: Table, dev: torch.device) -> None:
    for t in (t for row in table.tensors for t in row if t is not None):
        if t.device != dev:
            raise ValueError(f"kernel H: a tensor on {t.device}, not {dev}")


def upload(table: Table, dev: torch.device) -> torch.Tensor:
    """The table's bytes on `dev`: one copy from pinned memory, queued on
    the current stream without a sync (the pinned buffer is not reused
    before the copy has run)."""
    _check_device(table, dev)
    host = torch.empty(table.entries.nbytes, dtype=torch.uint8,
                       pin_memory=True)
    host.numpy()[:] = table.entries.view(np.uint8)
    return host.to(dev, non_blocking=True)


def group_sums(table: Table, dev_table: torch.Tensor) -> torch.Tensor:
    """Each norm group's sum of squares of the gradients: [n_groups] fp32 on
    the card, two launches, no sync."""
    dev = dev_table.device
    sums = torch.zeros(table.n_groups, dtype=torch.float32, device=dev)
    if not len(table.entries):
        return sums
    partials = torch.empty(table.n_blocks, dtype=torch.float32, device=dev)
    n = len(table.entries)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ADAMW_SUMSQ.launch(dev_table.data_ptr(), n, table.n_blocks,
                           partials.data_ptr(), stream)
        ADAMW_REDUCE.launch(dev_table.data_ptr(), n, table.n_groups,
                            partials.data_ptr(), sums.data_ptr(), stream)
    return sums


def _norm_ptr(sc: Scalars, norm: Optional[torch.Tensor], dev) -> Optional[int]:
    if not sc.clip:
        return None
    if (norm is None or norm.device != dev or norm.dtype != torch.float32
            or norm.numel() != 1):
        raise ValueError("kernel H's clip reads an fp32 norm on the card")
    return norm.data_ptr()


def update(table: Table, dev_table: torch.Tensor, sc: Scalars,
           norm: Optional[torch.Tensor]) -> None:
    """The update pass over every entry of the table (mu and nu given),
    one launch per dtype combination."""
    dev = dev_table.device
    nptr = _norm_ptr(sc, norm, dev)
    if (table.entries["mu"] == 0).any():
        raise ValueError("kernel H's update needs every entry's moments")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for code, lo, hi, blk_lo, blk_hi in table.runs:
            ADAMW_UPDATE.launch(dev_table.data_ptr(), lo, hi, blk_lo, blk_hi,
                                code, ctypes.byref(sc), nptr, stream)


def launches() -> int:
    return sum(k.launches for k in KERNELS)
