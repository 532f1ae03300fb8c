"""SD-1.5 AutoencoderKL (counterpart of `metamorph_tpu/visualizer/vae.py`).

Encoder (down blocks + mid) -> 2x latent channels (mean, logvar); the
decoder is symmetric. Latents are scaled by scaling_factor 0.18215. The
weights are a `params.ParamTree` with the JAX tree's keys; activations are
NCHW inside, [B, H, W, C] at the API, with the UNet's cast points. The
mid attention (one head over every pixel) materializes its fp32 scores as
the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from metamorph_tpu_torch.convert import resolve_device
from metamorph_tpu_torch.visualizer.params import ParamTree
from metamorph_tpu_torch.visualizer.unet import (Init, attention_probs,
                                                 conv2d, group_norm, silu,
                                                 upsample_nearest)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                         norm_groups=8)


def _init_res(init: Init, cin, cout):
    p = {"norm1": init.norm(cin), "conv1": init.conv(3, 3, cin, cout),
         "norm2": init.norm(cout), "conv2": init.conv(3, 3, cout, cout)}
    if cin != cout:
        p["shortcut"] = init.conv(1, 1, cin, cout)
    return p


def _res(p, x, groups):
    h = conv2d(p["conv1"], silu(group_norm(p["norm1"], x, groups)))
    h = conv2d(p["conv2"], silu(group_norm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x, padding=0)
    return x + h


def _init_attn(init: Init, c):
    return {"norm": init.norm(c), "q": init.conv(1, 1, c, c),
            "k": init.conv(1, 1, c, c), "v": init.conv(1, 1, c, c),
            "out": init.conv(1, 1, c, c)}


def _attn(p, x, groups):
    B, C, H, W = x.shape
    h = group_norm(p["norm"], x, groups)

    def tokens(name):          # [B, H*W, C]
        return conv2d(p[name], h, padding=0).flatten(2).transpose(1, 2)

    o = attention_probs(tokens("q"), tokens("k"), x.dtype) @ tokens("v")
    o = o.transpose(1, 2).reshape(B, C, H, W)
    return x + conv2d(p["out"], o, padding=0)


def _mid(p, x, groups):
    x = _res(p["res1"], x, groups)
    x = _attn(p["attn"], x, groups)
    return _res(p["res2"], x, groups)


@torch.no_grad()
def init_vae_params(cfg: VAEConfig, seed: int = 0, device="cuda",
                    dtype: torch.dtype = torch.float32) -> ParamTree:
    """Random VAE weights at the JAX initializer's scales, drawn on
    `device` (the card unless the caller passes another) from `seed`."""
    init = Init(seed, resolve_device(device), dtype)
    ch = cfg.block_out_channels
    L = len(ch)
    lat = cfg.latent_channels

    enc = {"conv_in": init.conv(3, 3, cfg.in_channels, ch[0]),
           "down": [], "mid": {}, "norm_out": init.norm(ch[-1]),
           "conv_out": init.conv(3, 3, ch[-1], 2 * lat)}
    cin = ch[0]
    for lvl in range(L):
        blk = {"resnets": [_init_res(init, cin if i == 0 else ch[lvl], ch[lvl])
                           for i in range(cfg.layers_per_block)]}
        if lvl < L - 1:
            blk["downsample"] = init.conv(3, 3, ch[lvl], ch[lvl])
        enc["down"].append(blk)
        cin = ch[lvl]
    enc["mid"] = {"res1": _init_res(init, ch[-1], ch[-1]),
                  "attn": _init_attn(init, ch[-1]),
                  "res2": _init_res(init, ch[-1], ch[-1])}
    enc["quant_conv"] = init.conv(1, 1, 2 * lat, 2 * lat)

    dec = {"post_quant_conv": init.conv(1, 1, lat, lat),
           "conv_in": init.conv(3, 3, lat, ch[-1]),
           "mid": {"res1": _init_res(init, ch[-1], ch[-1]),
                   "attn": _init_attn(init, ch[-1]),
                   "res2": _init_res(init, ch[-1], ch[-1])},
           "up": [], "norm_out": init.norm(ch[0]),
           "conv_out": init.conv(3, 3, ch[0], cfg.in_channels)}
    rev = list(reversed(ch))
    cin = ch[-1]
    for lvl in range(L):
        blk = {"resnets": [
            _init_res(init, cin if i == 0 else rev[lvl], rev[lvl])
            for i in range(cfg.layers_per_block + 1)]}
        if lvl < L - 1:
            blk["upsample"] = init.conv(3, 3, rev[lvl], rev[lvl])
        dec["up"].append(blk)
        cin = rev[lvl]

    return ParamTree({"encoder": enc, "decoder": dec})


def latent_shape(cfg: VAEConfig, images_shape) -> Tuple[int, ...]:
    """The latents' shape [B, H/2^(L-1), W/2^(L-1), latent_channels] for
    images of `images_shape` [B, H, W, 3]."""
    B, H, W, _ = images_shape
    f = 2 ** (len(cfg.block_out_channels) - 1)
    return (B, H // f, W // f, cfg.latent_channels)


def vae_encode(params: ParamTree, cfg: VAEConfig, images: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """images [B,H,W,3] in [-1,1] -> latents [B,H/2^(L-1),W/..,4] scaled by
    scaling_factor: a sample of the posterior, mean + std * eps, with eps
    given (of `latent_shape`) or drawn from `generator`; the mean when
    neither is given."""
    g = cfg.norm_groups
    p = params["encoder"]
    x = conv2d(p["conv_in"], images.permute(0, 3, 1, 2))
    for blk in p["down"]:
        for res in blk["resnets"]:
            x = _res(res, x, g)
        if "downsample" in blk:
            # diffusers Downsample2D pads (0,1,0,1) asymmetrically, stride 2
            x = conv2d(blk["downsample"], F.pad(x, (0, 1, 0, 1)), stride=2,
                       padding=0)
    x = _mid(p["mid"], x, g)
    x = silu(group_norm(p["norm_out"], x, g))
    moments = conv2d(p["conv_out"], x)
    moments = conv2d(p["quant_conv"], moments, padding=0)
    mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
    if generator is not None and eps is None:
        eps = torch.randn(mean.shape, generator=generator,
                          device=generator.device, dtype=mean.dtype)
    if eps is not None:
        logvar = logvar.clamp(-30.0, 20.0)
        mean = mean + torch.exp(0.5 * logvar) * eps.to(mean.device,
                                                       mean.dtype)
    return mean * cfg.scaling_factor


def vae_decode(params: ParamTree, cfg: VAEConfig, latents: torch.Tensor
               ) -> torch.Tensor:
    """scaled latents [B,h,w,4] -> images [B,H,W,3] in [-1,1], in the
    dtype of latents (which must be the weights')."""
    g = cfg.norm_groups
    p = params["decoder"]
    x = latents.permute(0, 3, 1, 2) / cfg.scaling_factor
    x = conv2d(p["post_quant_conv"], x, padding=0)
    x = conv2d(p["conv_in"], x)
    x = _mid(p["mid"], x, g)
    for blk in p["up"]:
        for res in blk["resnets"]:
            x = _res(res, x, g)
        if "upsample" in blk:
            x = conv2d(blk["upsample"], upsample_nearest(x))
    x = silu(group_norm(p["norm_out"], x, g))
    return conv2d(p["conv_out"], x).permute(0, 2, 3, 1)
