"""Decode and chunk attention (counterpart of
`metamorph_tpu/ops/decode_attention.py`).

Two hand-written CUDA kernels replace the three Pallas TPU kernels of the
JAX module:

  * kernel B, `csrc/decode_attn.cu`, replaces `_decode_kernel`: one query
    token per batch row attends to the row's valid cache window
    [start, length). It has a bf16 instance and an int8 one (the cache
    holds int8 entries plus fp32 per-(token, kv head) scales, applied to
    the score and to the probability, never to a dequantized slab). Each
    row's keys are split across CTAs (`decode_splits`, from S and the SM
    count, never from `lengths`) and the last CTA of a (row, kv head)
    merges the partials in the same launch (`merge_partials` is the
    arithmetic in plain PyTorch, for the tests);
  * kernel E, `csrc/chunk_attn.cu` + `csrc/chunk_fill.cu`, replaces
    `_chunk_kernel` (chunked fill: a C-token prompt chunk of one cache
    row, `chunk_attention`; wgmma + TMA, key splits from `fill_splits`)
    and `_chunk_kernel_batched` (speculative verification: every row's
    C-token chunk against its own row, `chunk_attention_batched`; kernel
    B's split-and-merge on 16 packed rows, key splits from
    `verify_splits`, `verify_merge_partials` the arithmetic in plain
    PyTorch). Key j is visible to chunk token c iff j <= off + c; entries
    past the chunk may be stale and are never loaded. bf16 and int8
    instances.

CPU tensors take the plain PyTorch versions (`decode_attention_plain`, the
counterpart of `decode_attention_xla`, and `chunk_attention_plain`): fp32
einsums over the dequantized slab. CUDA tensors launch a kernel or raise.

Pass the whole stacked cache [L, B, KV, S, Dh] (and scales [L, B, KV, S])
plus `layer`: the kernels offset their pointers by the layer, so no
per-layer slice is copied. A decode row whose window is empty gets 0, as in
the Pallas kernel. The split kernels' fp32 partials go to a workspace, and
their arrival counters to an int32 vector that each launch leaves at zero;
the wrappers allocate both once per (device, shape) and reuse them, so
calls for one shape must stay on one stream. No wrapper reads a device
tensor to the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple, Union

import torch

from metamorph_tpu_torch.kernels._build import Kernel

NEG_INF = -1e30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F = ctypes.c_float
# trailing (split_len, n_split, ws, counters) / (n_split, ws, counters)
_SPLIT = [_I, _I, _P, _P, _P]
DECODE_ATTN = Kernel("mm_decode_attn_bf16",
                     [_P] * 6 + [_I] * 5 + [_L] * 3 + [_F] + _SPLIT)
DECODE_ATTN_INT8 = Kernel("mm_decode_attn_int8",
                          [_P] * 8 + [_I] * 5 + [_L] * 6 + [_F] + _SPLIT)
CHUNK_ATTN = Kernel("mm_chunk_attn_bf16",
                    [_P] * 6 + [_I] * 7 + [_L] * 3 + [_F] + _SPLIT[1:])
CHUNK_ATTN_INT8 = Kernel("mm_chunk_attn_int8",
                         [_P] * 8 + [_I] * 7 + [_L] * 6 + [_F] + _SPLIT[1:])

SPLIT_QUANTUM = 64      # kernels B's and E-verify's split lengths are
                        # multiples of this
MAX_SPLITS = 32         # partials per (row, kv head) or (chunk, kv head)
FILL_ROWS = 128         # packed query rows per CTA of the fill kernel
FILL_MIN_SPLIT = 512    # keys of S per fill split, at least
VERIFY_ROWS = 16        # packed rows (G * C) up to which chunk_attn.cu runs
                        # its verify kernel instead of the fill kernel
VERIFY_CTAS_PER_SM = 4  # the verify kernel's grid density (CTAs per SM)


def decode_splits(S: int, B: int, KV: int, sm_count: int) -> Tuple[int, int]:
    """Kernel B's key splits: (split_len, n_split) with split_len a
    multiple of SPLIT_QUANTUM and split_len * n_split >= S, aiming at four
    CTAs per SM over the (n_split, KV, B) grid (a 4,096-key row then takes
    16 tiles of one CTA, which a 3-stage ring streams near the card's
    rate), and at most MAX_SPLITS partials for the last CTA to merge. A
    function of host-known sizes only: the rows' lengths live on the
    device and are never read here."""
    want = min(MAX_SPLITS, max(1, math.ceil(4 * sm_count / (B * KV))))
    split = math.ceil(math.ceil(S / want) / SPLIT_QUANTUM) * SPLIT_QUANTUM
    return split, math.ceil(S / split)


def verify_splits(S: int, NB: int, KV: int, sm_count: int) -> int:
    """Key splits of the verify kernel: about VERIFY_CTAS_PER_SM CTAs per
    SM over the (n_split, KV, NB) grid, at most MAX_SPLITS partials for
    the last CTA to merge. Host-known sizes only: the chunks' offsets live
    on the device and are never read here. The kernel cuts the keys into
    splits of `verify_split_len(S, n_split)`."""
    want = min(MAX_SPLITS,
               max(1, math.ceil(VERIFY_CTAS_PER_SM * sm_count / (NB * KV))))
    split = math.ceil(math.ceil(S / want) / SPLIT_QUANTUM) * SPLIT_QUANTUM
    return math.ceil(S / split)


def verify_split_len(S: int, n_split: int) -> int:
    """The verify kernel's split length (`chunk_attn.cu` computes the
    same): the least multiple of SPLIT_QUANTUM with
    n_split * split_len >= S."""
    return (math.ceil(math.ceil(S / n_split) / SPLIT_QUANTUM)
            * SPLIT_QUANTUM)


def fill_splits(S: int, NB: int, C: int, G: int, KV: int,
                sm_count: int) -> int:
    """Key splits of the fill kernel: as many as keep the grid within one
    wave of the card (one 384-thread CTA per SM), and no more than one per
    FILL_MIN_SPLIT keys of S. Host-known sizes only (never the offsets)."""
    ctas = NB * KV * math.ceil(G * C / FILL_ROWS)
    return max(1, min(sm_count // ctas, math.ceil(S / FILL_MIN_SPLIT)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SCRATCH: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(kind: str, dev, n_floats: int, n_counters: int):
    """The split kernels' fp32 workspace and zeroed arrival counters, made
    once per (kind, device, shape) and reused: each launch overwrites the
    workspace and leaves the counters at zero."""
    key = (kind, dev, n_floats, n_counters)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.empty(n_floats, dtype=torch.float32, device=dev),
            torch.zeros(n_counters, dtype=torch.int32, device=dev))
    return _SCRATCH[key]


def _dequant(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor,
                           starts: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version over one layer's cache: q [B,H,Dh], k/v
    [B,KV,S,Dh] (int8 with k_scale/v_scale [B,KV,S]), lengths/starts [B].
    fp32 math; returns [B,H,Dh] in q.dtype. The grouped einsum never
    materializes repeated K/V heads."""
    B, H, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.float().reshape(B, KV, G, Dh)
    s = torch.einsum("bkgd,bksd->bkgs", qg, _dequant(k, k_scale)) * scale
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < lengths.to(q.device)[:, None]
    if starts is not None:
        mask = mask & (pos >= starts.to(q.device)[:, None])
    mask = mask[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bkgs,bksd->bkgd", p, _dequant(v, v_scale))
    return o.reshape(B, H, Dh).to(q.dtype)


def merge_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, starts: Optional[torch.Tensor],
                   split: int, scale: Optional[float] = None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B's split-and-merge arithmetic in fp32 (for the tests; the
    path never calls it). Same arguments as `decode_attention_plain`, plus
    the split length: split s holds the keys [s * split, (s + 1) * split)
    of each row's window [start, length). Each split gives (m, l, o) in
    the log2 domain with o unnormalised (an empty split: m = -1e30,
    l = 0); the splits merge in order, skipping empty ones, and a row with
    no visible key gets 0."""
    B, H, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    n = math.ceil(S / split)
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.float().reshape(B, KV, G, Dh)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float())
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None]
    s = s * (scale * math.log2(math.e))
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < lengths.to(q.device)[:, None]
    if starts is not None:
        mask = mask & (pos >= starts.to(q.device)[:, None])
    pad = n * split - S
    s = torch.nn.functional.pad(s, (0, pad)).reshape(B, KV, G, n, split)
    mask = torch.nn.functional.pad(mask, (0, pad)).reshape(B, 1, 1, n, split)
    vf = v.float() if v_scale is None else v.float() * v_scale.float()[..., None]
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad)).reshape(B, KV, n, split,
                                                             Dh)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)                                              # [B,KV,G,n]
    p = torch.exp2(s - m[..., None]) * mask
    l = p.sum(-1)
    o = torch.einsum("bkgnj,bknjd->bkgnd", p, vf)
    M = m.masked_fill(l == 0, NEG_INF).amax(-1, keepdim=True)
    f = torch.where(l > 0, torch.exp2(m - M), torch.zeros_like(m))
    L = (l * f).sum(-1)
    O = (o * f[..., None]).sum(-2)
    out = O / torch.where(L > 0, L, torch.ones_like(L))[..., None]
    return out.reshape(B, H, Dh).to(q.dtype)


def verify_merge_partials(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, offs: torch.Tensor, split: int,
                          scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Kernel E verify form's split-and-merge arithmetic in fp32 (for the
    tests; the path never calls it). Same arguments as
    `chunk_attention_plain`, plus the split length: split s holds the keys
    [s * split, (s + 1) * split) of each chunk's row, and chunk token c
    sees key j iff j <= offs + c. Each split gives (m, l, o) per query in
    the log2 domain with o unnormalised (an empty split: m = -1e30,
    l = 0); the splits merge in order, skipping empty ones."""
    NB, C, H, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    n = math.ceil(S / split)
    pad = n * split - S
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.float().reshape(NB, C, KV, G, Dh)
    s = torch.einsum("nckgd,nksd->nkgcs", qg, k.float())
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, None]
    s = s * (scale * math.log2(math.e))
    last = offs.to(q.device).long()[:, None] + torch.arange(C, device=q.device)
    mask = torch.arange(S, device=q.device)[None, None, :] <= last[..., None]
    s = torch.nn.functional.pad(s, (0, pad)).reshape(NB, KV, G, C, n, split)
    mask = torch.nn.functional.pad(mask, (0, pad)).reshape(NB, 1, 1, C, n,
                                                           split)
    vf = v.float() if v_scale is None else v.float() * v_scale.float()[..., None]
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad)).reshape(NB, KV, n, split,
                                                             Dh)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)                                          # [NB,KV,G,C,n]
    p = torch.exp2(s - m[..., None]) * mask
    l = p.sum(-1)
    o = torch.einsum("nkgcsj,nksjd->nkgcsd", p, vf)
    M = m.masked_fill(l == 0, NEG_INF).amax(-1, keepdim=True)
    f = torch.where(l > 0, torch.exp2(m - M), torch.zeros_like(m))
    L = (l * f).sum(-1)
    O = (o * f[..., None]).sum(-2)
    out = O / torch.where(L > 0, L, torch.ones_like(L))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(NB, C, H, Dh).to(q.dtype)


def chunk_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          offs: torch.Tensor, scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of kernel E: q [NB,C,H,Dh] (chunk nb's C
    queries), k/v [NB,KV,S,Dh] (the cache row each chunk reads; int8 with
    scales [NB,KV,S]), offs [NB]: chunk token c of chunk nb sees keys
    j <= offs[nb] + c. fp32 math; returns [NB,C,H,Dh] in q.dtype."""
    NB, C, H, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else Dh ** -0.5
    qg = q.float().reshape(NB, C, KV, G, Dh)
    s = torch.einsum("nckgd,nksd->nkgcs", qg, _dequant(k, k_scale)) * scale
    last = offs.to(q.device).long()[:, None] + torch.arange(C, device=q.device)
    mask = torch.arange(S, device=q.device)[None, None, :] <= last[..., None]
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("nkgcs,nksd->nckgd", p, _dequant(v, v_scale))
    return o.reshape(NB, C, H, Dh).to(q.dtype)


def _check_cache(q, k, v, k_scale, v_scale, layer, B_q: Optional[int]):
    """Device, dtype, layout and shape checks shared by kernels B and E.
    Returns (KV, S)."""
    dev = q.device
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError("k_scale and v_scale go together")
    want = torch.int8 if quant else torch.bfloat16
    for name, x, dt in (("q", q, torch.bfloat16), ("k", k, want),
                        ("v", v, want)):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError("k and v caches differ in shape")
    if quant:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (x.device != dev or x.dtype != torch.float32
                    or not x.is_contiguous()
                    or x.shape != k.shape[:-1]):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"{tuple(k.shape[:-1])} tensor on {dev}")
    H, Dh = q.shape[-2], q.shape[-1]
    KV, S = k.shape[-3], k.shape[-2]
    if k.shape[-1] != Dh or (B_q is not None and k.shape[-4] != B_q):
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if H % KV or H // KV not in (1, 2, 4, 8):
        raise ValueError(f"group size H/KV = {H}/{KV} unsupported "
                         f"(1, 2, 4, 8)")
    if Dh not in (64, 128):
        raise ValueError(f"head dim {Dh} unsupported by the kernel (64, 128)")
    if k.dim() == 5 and not 0 <= layer < k.shape[0]:
        raise ValueError(f"layer {layer} out of range for {k.shape[0]}")
    return KV, S


def _int32_vec(name: str, x: torch.Tensor, n: int, dev) -> None:
    if (x.device != dev or x.dtype != torch.int32 or x.shape != (n,)
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{n}] tensor "
                         f"on {dev}")


def _scale_args(k, k_scale, v_scale, layer):
    """Pointers, layer offset and strides of the scale planes."""
    return (k_scale.data_ptr(), v_scale.data_ptr(),
            layer * k_scale.stride(0) if k.dim() == 5 else 0,
            k_scale.stride(-3), k_scale.stride(-2))


def _launch_decode(q, k, v, lengths, starts, layer: Optional[int],
                   scale: float, k_scale, v_scale) -> torch.Tensor:
    B, H, Dh = q.shape
    dev = q.device
    KV, S = _check_cache(q, k, v, k_scale, v_scale, layer, B)
    _int32_vec("lengths", lengths, B, dev)
    if starts is not None:
        _int32_vec("starts", starts, B, dev)
    o = torch.empty((B, H, Dh), dtype=q.dtype, device=dev)
    layer_off = layer * k.stride(0) if k.dim() == 5 else 0
    st_ptr = None if starts is None else starts.data_ptr()
    split_len, n_split = decode_splits(S, B, KV, _sm_count(dev.index))
    ws, ctr = _scratch("decode", dev, B * H * n_split * (Dh + 2), B * KV)
    split = (split_len, n_split, ws.data_ptr(), ctr.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if k_scale is None:
            DECODE_ATTN.launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                st_ptr, lengths.data_ptr(), B, H, KV, S, Dh,
                layer_off, k.stride(-4), k.stride(-3), float(scale), *split,
                stream)
        else:
            ksp, vsp, sc_off, sc_sb, sc_sh = _scale_args(k, k_scale, v_scale,
                                                         layer)
            DECODE_ATTN_INT8.launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ksp, vsp,
                o.data_ptr(), st_ptr, lengths.data_ptr(), B, H, KV, S, Dh,
                layer_off, k.stride(-4), k.stride(-3), sc_off, sc_sb, sc_sh,
                float(scale), *split, stream)
    return o


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     starts: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     layer: Optional[int] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,H,Dh]; k/v [B,KV,S,Dh], or the stacked [L,B,KV,S,Dh] with
    `layer`; lengths [B] int32 (valid keys end, exclusive); starts [B]
    int32 (valid keys begin) or None. With k_scale/v_scale ([(L,) B,KV,S]
    fp32) the cache is int8. Returns [B,H,Dh] in q.dtype."""
    if (k.dim() == 5) != (layer is not None):
        raise ValueError("layer goes with a stacked [L,B,KV,S,Dh] cache")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if layer is not None:
            k, v = k[layer], v[layer]
            if k_scale is not None:
                k_scale, v_scale = k_scale[layer], v_scale[layer]
        return decode_attention_plain(q, k, v, lengths, starts, scale,
                                      k_scale, v_scale)
    return _launch_decode(q, k, v, lengths, starts, layer, scale, k_scale,
                          v_scale)


def _launch_chunk(q, k, v, rows, offs, layer: int, scale: float, k_scale,
                  v_scale, site: str) -> torch.Tensor:
    NB, C, H, Dh = q.shape
    dev = q.device
    if k.dim() != 5:
        raise ValueError("kernel E reads the stacked [L,B,KV,S,Dh] cache")
    KV, S = _check_cache(q, k, v, k_scale, v_scale, layer, None)
    _int32_vec("rows", rows, NB, dev)
    _int32_vec("offs", offs, NB, dev)
    o = torch.empty_like(q)
    layer_off = layer * k.stride(0)
    Bc, G = k.shape[1], H // KV
    split = (1, None, None)          # the fill kernel unsplit: no workspace
    form = "fill" if G * C > VERIFY_ROWS else "verify"
    if form == "fill":
        n_split = fill_splits(S, NB, C, G, KV, _sm_count(dev.index))
        if n_split > 1:
            tiles = NB * KV * math.ceil(G * C / FILL_ROWS)
            ws, ctr = _scratch("fill", dev, tiles * n_split * FILL_ROWS
                               * (Dh + 2), tiles)
            split = (n_split, ws.data_ptr(), ctr.data_ptr())
    else:
        n_split = verify_splits(S, NB, KV, _sm_count(dev.index))
        ws, ctr = _scratch("verify", dev, NB * KV * n_split * VERIFY_ROWS
                           * (Dh + 2), NB * KV)
        split = (n_split, ws.data_ptr(), ctr.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if k_scale is None:
            CHUNK_ATTN.launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                rows.data_ptr(), offs.data_ptr(), NB, C, H, KV, S, Dh, Bc,
                layer_off, k.stride(1), k.stride(2), float(scale), *split,
                stream, site=site, form=form)
        else:
            ksp, vsp, sc_off, sc_sb, sc_sh = _scale_args(k, k_scale, v_scale,
                                                         layer)
            CHUNK_ATTN_INT8.launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ksp, vsp,
                o.data_ptr(), rows.data_ptr(), offs.data_ptr(), NB, C, H, KV,
                S, Dh, Bc, layer_off, k.stride(1), k.stride(2), sc_off, sc_sb,
                sc_sh, float(scale), *split, stream, site=site, form=form)
    return o


def _chunk(q, k, v, rows, offs, layer, scale, k_scale, v_scale, site):
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        r = rows.long()
        ks = vs = None
        if k_scale is not None:
            ks, vs = k_scale[layer][r], v_scale[layer][r]
        return chunk_attention_plain(q, k[layer][r], v[layer][r], offs,
                                     scale, ks, vs)
    return _launch_chunk(q, k, v, rows, offs, layer, scale, k_scale, v_scale,
                         site)


def _as_int32(x: Union[int, torch.Tensor], dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(1)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    slot: Union[int, torch.Tensor],
                    chunk_off: Union[int, torch.Tensor], layer: int,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-fill attention (the JAX `chunk_attention`, Pallas K6):
    q [C,H,Dh], one prompt chunk of cache row `slot` whose first token sits
    at `chunk_off`, against the stacked cache [L,B,KV,S,Dh] at `layer`;
    token c reads keys j <= chunk_off + c. `slot` and `chunk_off` are ints
    or one-element int32 tensors on q's device. Returns [C,H,Dh]."""
    return _chunk(q[None], k, v, _as_int32(slot, q.device),
                  _as_int32(chunk_off, q.device), layer, scale, k_scale,
                  v_scale, "chunk_attention")[0]


def chunk_attention_batched(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, offs: torch.Tensor, layer: int,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None,
                            rows: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Batched chunk attention (the JAX `chunk_attention_batched`, Pallas
    K7): q [B,C,H,Dh], row b's chunk against ITS cache row at ITS offset
    offs[b] (int32 [B]); token c reads keys j <= offs[b] + c. Chunk b reads
    cache row `rows[b]` (int32 [B], which a caller that runs every layer
    builds once); None means the identity, cache row == batch row (the
    serving layout: unpadded rows). Returns [B,C,H,Dh]."""
    if rows is None:
        rows = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    return _chunk(q, k, v, rows, offs, layer, scale, k_scale, v_scale,
                  "chunk_attention_batched")
