"""Int8 KV-cache quantization (counterpart of `quantize_kv` in
`metamorph_tpu/ops/quant.py`).

Symmetric per-vector int8: one fp32 scale per (token, kv head), the
granularity a decode-step write produces. The int8 weights of the JAX
module (`quantize_weight`, `quantized_matmul`, `quantize_llama_decode`) are
not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (int8 [..., Dh], scale fp32 [...]) with
    x ~= int8 * scale[..., None]; scale = max(amax, 1e-8) / 127, rounding
    half to even (as `jnp.round`), clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale
