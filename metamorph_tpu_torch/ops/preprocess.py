"""Image resize + normalize on the device (counterpart of
`metamorph_tpu/ops/preprocess.py`).

The host ships raw uint8 frames; the bilinear resize to the SigLIP input
size and the (x/255 - mean)/std normalization run on the device of the
frames, before the patch embedding. The resize is two one-sided matrix
products with precomputed interpolation matrices (half-pixel centers,
align_corners=False, no antialias), the same matrices as the JAX package's,
so both give the host resize of `multimodal/mm_utils.resize_bilinear` up to
fp32 rounding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from metamorph_tpu_torch.multimodal.mm_utils import SIGLIP_MEAN, SIGLIP_STD


@functools.lru_cache(maxsize=32)
def _interp_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] bilinear interpolation matrix, half-pixel centers."""
    out = np.zeros((dst, src), np.float32)
    pos = (np.arange(dst) + 0.5) * src / dst - 0.5
    lo = np.floor(pos).astype(int)
    frac = pos - lo
    lo_c = np.clip(lo, 0, src - 1)
    hi_c = np.clip(lo + 1, 0, src - 1)
    out[np.arange(dst), lo_c] += 1.0 - frac
    out[np.arange(dst), hi_c] += frac
    out.setflags(write=False)      # the cache hands one array to every caller
    return out


def fused_resize_normalize(
    frames: torch.Tensor,          # [N, H, W, 3] uint8 (or float 0..255)
    out_size: int = 384,
    mean: Tuple[float, float, float] = tuple(SIGLIP_MEAN),
    std: Tuple[float, float, float] = tuple(SIGLIP_STD),
) -> torch.Tensor:
    """[N, S, S, 3] float32, SigLIP-normalized, on the frames' device."""
    N, H, W, C = frames.shape
    dev = frames.device
    ry = torch.from_numpy(_interp_matrix(H, out_size).copy()).to(dev)  # [S, H]
    rx = torch.from_numpy(_interp_matrix(W, out_size).copy()).to(dev)  # [S, W]
    x = frames.to(torch.float32)
    x = torch.einsum("sh,nhwc->nswc", ry, x)
    x = torch.einsum("tw,nswc->nstc", rx, x)
    x = x / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev)
    return (x - mean_t) / std_t


def preprocess_and_encode(model, siglip_cfg, mm_cfg,
                          frames_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> SigLIP features, preprocess and encode on the device
    of the frames. `model` is the `Siglip` module."""
    from metamorph_tpu_torch.models.siglip import vision_tower_forward

    px = fused_resize_normalize(frames_uint8, siglip_cfg.image_size)
    return vision_tower_forward(model, siglip_cfg, mm_cfg, px)
