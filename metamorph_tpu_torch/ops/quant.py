"""Int8 quantization for serving (counterpart of `metamorph_tpu/ops/quant.py`).

Two transforms, both symmetric int8 with fp32 scales, rounding half to
even (as `jnp.round`) and clipped to +-127:
  * weights, per output channel (`quantize_weight`, `quantize_llama_decode`):
    decode is bound by the bytes of the weights it reads, and int8 halves
    them. A quantized weight is a `QuantizedWeight` module holding the int8
    matrix as [D_out, D_in] (the port's layout: each output channel's D_in
    values contiguous, what kernel F reads 16 bytes at a time; the JAX
    package keeps [D_in, D_out], and `convert.py` transposes on the way)
    and one fp32 scale per output channel;
  * KV-cache entries, per (token, kv head) (`quantize_kv`), the granularity
    a decode-step write produces.

`quantized_matmul(x, w)` computes (x @ q) with fp32 sums, times the scale,
cast to x's dtype: the JAX function's order of operations. XLA:TPU fuses
the int8 -> bf16 convert into the dot there; here kernel F
(`csrc/w8_matmul.cu`) does the same on CUDA tensors, reading each int8
weight once and converting it on chip. CPU tensors take the plain
version (`quantized_matmul_plain`). A CUDA activation that is not bf16
raises; nothing on the card gives way to the plain version.

Training and prefill weights stay bf16 until `quantize_llama_decode` is
applied to a loaded model for serving.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
from torch import nn

from metamorph_tpu_torch.kernels._build import Kernel

QUANT_KEY = "int8_q"   # marks a quantized weight in a JAX parameter tree

_P, _I = ctypes.c_void_p, ctypes.c_int
W8_MATMUL = Kernel("mm_w8_matmul", [_P] * 4 + [_I] * 5 + [_P] * 3)
W8_QMAP = Kernel("mm_w8_qmap", [_P, _I, _I, _I, _P])
W8_RESIDENT = Kernel("mm_w8_resident", [_I, _I, _P])

GEMV_MAX_M = 64        # rows up to which kernel F runs its gemv form (at 48
                       # and 64 rows 1.6-4.5x faster than the tiled form,
                       # `kernels/bench_w8_designs.py` on an H100)
GEMV_BN = 128          # gemv: channels per tile
GEMV_BK = 128          # gemv: depth per unit (a tile's k block)
GEMV_MIN_UNITS = 2     # gemv: units (16 KB of weight each) per CTA, at least
GEMV_CTAS_PER_SM = 1   # gemv: CTAs per SM at most (more put more weight in
                       # flight than the memory serves well)
TILED_BM, TILED_BN = 256, 128   # tiled: the output tile, in column pairs


class QuantizedWeight(nn.Module):
    """A weight-only int8 dense weight: `q` int8 [D_out, D_in] and `scale`
    fp32 [D_out], with w[i, o] ~= q[o, i] * scale[o]. Buffers, not
    parameters: no optimizer ever sees them. `plans` keeps kernel F's
    launch arguments against this weight (`_plan`)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.plans = {}

    @property
    def shape(self) -> Tuple[int, int]:
        """(D_in, D_out), the shape of the weight it stands for."""
        return (self.q.shape[1], self.q.shape[0])


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Symmetric per-output-channel int8 of a dense weight w [D_in, D_out]:
    scale = max(amax over D_in, 1e-8) / 127 in fp32,
    q = clip(round_half_even(w / scale), -127, 127). Computed on w's
    device; the same int8 values and scales as the JAX function."""
    wf = w.detach().float()
    scale = wf.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedWeight(q.t().contiguous(), scale)


def dequantize_weight(w: QuantizedWeight,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The [D_in, D_out] weight a QuantizedWeight stands for, in dtype."""
    return (w.q.float() * w.scale[:, None]).t().to(dtype)


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedWeight)


def quantized_matmul_plain(x: torch.Tensor, w: QuantizedWeight
                           ) -> torch.Tensor:
    """Plain PyTorch version of kernel F: x [..., D_in] @ q with fp32 sums,
    times the scale, cast to x's dtype."""
    out = torch.matmul(x.float(), w.q.float().t()) * w.scale.float()
    return out.to(x.dtype)


def gemv_ng(M: int) -> int:
    """n8 tiles of x rows the gemv form's kernel is built for at M rows."""
    return 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8


@functools.lru_cache(maxsize=None)
def gemv_ctas(K: int, N: int, sm_count: int, resident: int) -> int:
    """Kernel F's gemv grid: one wave of at most GEMV_CTAS_PER_SM CTAs per
    SM (`resident`: the CTAs the card holds, from the kernel's registers
    and shared memory), or fewer where the weight has under GEMV_MIN_UNITS
    units of 128 channels x 128 deep for each, or a slightly smaller grid
    whose runs fit the tiles. A function of the shapes and the card only,
    never of the rows' contents."""
    kb = math.ceil(K / GEMV_BK)
    units = math.ceil(N / GEMV_BN) * kb
    wave = max(1, min(resident, sm_count * GEMV_CTAS_PER_SM,
                      units // GEMV_MIN_UNITS))
    # a grid within 7/8 of the wave whose runs split tiles evenly (or take
    # whole tiles) is preferred: no CTA stops mid-run to hand in a partial
    for ctas in range(wave, (7 * wave + 7) // 8 - 1, -1):
        run = units // ctas
        if units % ctas == 0 and (kb % run == 0 or run % kb == 0):
            return ctas
    return wave


def gemv_segments(K: int, N: int, ctas: int):
    """The gemv kernel's schedule, as it computes it: CTA c takes units
    [c * W / P, (c + 1) * W / P) of the W = tiles x k blocks units, tile by
    tile. Yields (cta, tile, k block lo, k block hi, partial slot), slot 0
    for the first tile of the CTA's run, 1 for its last."""
    kb = math.ceil(K / GEMV_BK)
    units = math.ceil(N / GEMV_BN) * kb
    for c in range(ctas):
        u, end = c * units // ctas, (c + 1) * units // ctas
        while u < end:
            t = u // kb
            hi = min(kb, end - t * kb)
            yield c, t, u - t * kb, hi, 0 if c * units // ctas // kb == t else 1
            u = t * kb + hi


def tiled_ctas(M: int, N: int, resident: int) -> int:
    """Kernel F's tiled grid: persistent clusters of two CTAs, one per
    pair of adjacent 256 x 128 output tiles, at most one wave."""
    pairs = math.ceil(M / TILED_BM) * math.ceil(math.ceil(N / TILED_BN) / 2)
    return 2 * max(1, min(pairs, resident // 2))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident(index: int, form: int, ng: int) -> int:
    """CTAs of kernel F's `form` (gemv at `ng` n8 tiles) card `index` holds
    at once, from the kernel's registers and shared memory; queried once
    per card and kernel."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        W8_RESIDENT.call(form, ng, ctypes.byref(n))
    if n.value <= 0:
        raise RuntimeError(f"kernel F's form {form} fits no CTA on the card")
    return n.value


def _qmap(q: torch.Tensor, form: int):
    """q's TMA descriptor for `form` in a host buffer of 128 bytes, built
    once per weight and form (the plan keeps the buffer alive)."""
    buf = ctypes.create_string_buffer(128)
    W8_QMAP.call(q.data_ptr(), q.shape[0], q.shape[1], form, buf)
    return buf


_SCRATCH = {}


def _scratch(dev, n_floats: int, n_counters: int):
    """The gemv form's fp32 partials and zeroed arrival counters, made once
    per (device, sizes) and shared by the plans that need those sizes:
    each launch overwrites the partials it reads and leaves the counters
    at zero."""
    key = (dev, n_floats, n_counters)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.empty(n_floats, dtype=torch.float32, device=dev),
            torch.zeros(n_counters, dtype=torch.int32, device=dev))
    return _SCRATCH[key]


def _plan(w: QuantizedWeight, M: int, K: int, dev):
    """Kernel F's launch arguments for an x of M rows against `w` on `dev`:
    the weight's checks, the form, q's TMA descriptor, the grid and the
    gemv form's scratch, worked out on the first such call and kept in
    `w.plans` under (M, K, device index, storage). Returns ((descriptor
    address, scale), (M, N, K, form, ctas, partials, counters), form name,
    descriptor buffer)."""
    N = w.q.shape[0]
    for name, t, dt in (("q", w.q, torch.int8), ("scale", w.scale,
                                                   torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}")
    if w.scale.shape != (N,):
        raise ValueError(f"scale {tuple(w.scale.shape)} does not match the "
                         f"int8 weight {tuple(w.q.shape)}")
    if w.q.shape[1] != K:
        raise ValueError(f"x [{M}, {K}] does not match the int8 weight "
                         f"{tuple(w.q.shape)}")
    if K % 16:
        raise ValueError(f"D_in = {K} must be a multiple of 16 for kernel F")
    if w.q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    ws = ctr = None
    if M <= GEMV_MAX_M:
        form, ng = 0, gemv_ng(M)
        ctas = gemv_ctas(K, N, _sm_count(dev.index),
                         _resident(dev.index, form, ng))
        ws_t, ctr_t = _scratch(dev, 2 * ctas * 8 * ng * GEMV_BN,
                               math.ceil(N / GEMV_BN))
        ws, ctr = ws_t.data_ptr(), ctr_t.data_ptr()
    else:
        form = 1
        ctas = tiled_ctas(M, N, _resident(dev.index, form, 0))
    qmap = _qmap(w.q, form)
    plan = ((ctypes.addressof(qmap), w.scale.data_ptr()),
            (M, N, K, form, ctas, ws, ctr),
            "gemv" if form == 0 else "tiled", qmap)
    w.plans[(M, K, dev.index, w.q.data_ptr(), w.scale.data_ptr())] = plan
    return plan


def _launch(index: int, args, tag: str) -> None:
    # the raw stream handle: `torch.cuda.current_stream` builds a Stream
    # object on every call, and decode calls kernel F ~225 times a step
    W8_MATMUL.launch(*args, torch._C._cuda_getCurrentRawStream(index),
                     form=tag)


def quantized_matmul(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """x [..., D_in] @ the int8 weight -> [..., D_out] in x's dtype (fp32
    sums, the per-channel scale on the output). Kernel F on a CUDA x (bf16
    only), the plain version on a CPU x. Decode is bound by the host's
    time per call, so the path after the first call with a row count is
    the x checks, a lookup of the launch plan, the output and the launch."""
    if x.is_cpu:
        return quantized_matmul_plain(x, w)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"kernel F takes bf16 activations, got {x.dtype}")
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    M, index = x2.shape[0], x2.get_device()
    q, scale = w.q, w.scale
    plan = w.plans.get((M, K, index, q.data_ptr(), scale.data_ptr()))
    if plan is None:
        plan = _plan(w, M, K, x2.device)
    (qm, sp), shape, tag, _ = plan
    if x2.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    out = x2.new_empty((M, shape[1]))
    args = (x2.data_ptr(), qm, sp, out.data_ptr(), *shape)
    if torch._C._cuda_getDevice() == index:
        _launch(index, args, tag)
    else:                    # launch on x's device, not the current one
        with torch.cuda.device(index):
            _launch(index, args, tag)
    return out.reshape(*x.shape[:-1], shape[1])


_DECODE_QUANT_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@torch.no_grad()
def quantize_llama_decode(llama, consume: bool = False):
    """A new `Llama` for serving with the decode-hot weights in int8: the
    seven decoder linears of every layer and the lm head (with tied
    embeddings the head stays the embedding table, as in JAX). The
    embedding, the norms and any LoRA factors are the same tensors as in
    `llama`, not copies. Quantizes one weight at a time on its device.
    The int8 model grows beside `llama`, so the peak is `llama`, the whole
    int8 model (half the bytes of its bf16 linears) and one weight's fp32
    temporaries (~2 GB each for the 8B lm head). With `consume=True` the
    caller gives `llama` up: each bf16 weight is dropped from it once
    quantized, so the peak stays near `llama` plus one weight's
    temporaries."""
    from metamorph_tpu_torch.models.llama import Llama, LlamaLayer

    cfg = llama.cfg
    cfg.require_gqa("int8 weights (quantize_llama_decode)")
    dtype = llama.embed.dtype
    out = Llama(cfg, dtype=dtype, device="meta")
    out.embed = llama.embed
    out.final_norm = llama.final_norm
    for l, src in enumerate(llama.layers):
        dst = LlamaLayer(cfg, dtype=dtype, device="meta")
        dst.input_norm = src.input_norm
        dst.post_attn_norm = src.post_attn_norm
        for name in _DECODE_QUANT_NAMES:
            delattr(dst, name)
            setattr(dst, name, quantize_weight(getattr(src, name)))
            if consume:
                setattr(src, name, None)
            for side in ("a", "b"):
                key = f"{name}_lora_{side}"
                setattr(dst, key, getattr(src, key))
        out.layers[l] = dst
    if llama.lm_head is not None:
        del out.lm_head
        out.lm_head = quantize_weight(llama.lm_head)
        if consume:
            llama.lm_head = None
    return out


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (int8 [..., Dh], scale fp32 [...]) with
    x ~= int8 * scale[..., None]; scale = max(amax, 1e-8) / 127, rounding
    half to even (as `jnp.round`), clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale
