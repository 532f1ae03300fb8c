"""diffusers-format (SD-1.5) weights for the visualizer's UNet and VAE
(counterpart of `metamorph_tpu/visualizer/hf_import.py`).

Maps diffusers' `UNet2DConditionModel` / `AutoencoderKL` state-dict names
to the port's trees and back, so published SD-1.5 weights drop in
(`load_diffusers`). A diffusers conv is [out, in, kh, kw], which is the
port's own layout; a diffusers linear is [out, in] where the port's dense
kernel is [in, out]; the VAE mid attention's to_q/k/v/to_out linears are
the port's 1x1 convs. Every name comes from one rule (`hf_name`) applied
to the port's keys, so import and export cannot disagree; the import walks
the tree `init_*_params` makes for the config on the "meta" device, which
gives every key and shape without drawing a weight.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

from metamorph_tpu_torch.convert import resolve_device
from metamorph_tpu_torch.utils.safetensors_io import SafetensorsFile
from metamorph_tpu_torch.visualizer.params import ParamTree, map_leaves
from metamorph_tpu_torch.visualizer.unet import UNetConfig, init_unet_params
from metamorph_tpu_torch.visualizer.vae import VAEConfig, init_vae_params

# one segment of a port key -> its diffusers name
_SEGMENTS = {
    "time_mlp": "time_embedding", "fc1": "linear_1", "fc2": "linear_2",
    "down": "down_blocks", "up": "up_blocks", "mid": "mid_block",
    "res1": "resnets.0", "res2": "resnets.1", "attn": "attentions.0",
    "attns": "attentions", "downsample": "downsamplers.0.conv",
    "upsample": "upsamplers.0.conv", "time_emb": "time_emb_proj",
    "shortcut": "conv_shortcut", "block": "transformer_blocks.0",
    "q": "to_q", "k": "to_k", "v": "to_v", "out": "to_out.0",
    "geglu": "ff.net.0.proj", "ff_out": "ff.net.2",
    "norm_out": "conv_norm_out", "scale": "weight", "kernel": "weight",
}
# the names of the VAE mid attention in older diffusers files
_DEPRECATED = {"to_q": "query", "to_k": "key", "to_v": "value",
               "to_out.0": "proj_attn"}


def _vae_attn_proj(path: str) -> bool:
    """A leaf of the VAE mid attention's q/k/v/out: 1x1 convs here,
    linears in diffusers."""
    parts = path.split("/")
    return parts[-3:-2] == ["attn"] and parts[-2] in ("q", "k", "v", "out")


def hf_name(path: str, vae: bool = False) -> str:
    """The diffusers name of the port's key `path` ("down/0/resnets/1/
    conv1/kernel" -> "down_blocks.0.resnets.1.conv1.weight")."""
    parts = path.split("/")
    if vae and parts[1] in ("quant_conv", "post_quant_conv"):
        parts = parts[1:]           # top-level in diffusers
    if vae and parts[-3:-1] == ["attn", "norm"]:
        parts[-2] = "group_norm"    # the VAE attention's GroupNorm
    return ".".join(_SEGMENTS.get(p, p) for p in parts)


def _to_hf(params: ParamTree, vae: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.state_dict().items():
        path = name.replace(".", "/")
        if vae and _vae_attn_proj(path) and t.ndim == 4:
            t = t[:, :, 0, 0]
        elif path.endswith("kernel") and t.ndim == 2:
            t = t.t()
        out[hf_name(path, vae)] = t
    return out


def _from_hf(sd: Mapping[str, torch.Tensor], skeleton: ParamTree, vae: bool,
             device, dtype: Optional[torch.dtype]) -> ParamTree:

    def leaf(path, like):
        name = hf_name(path, vae)
        if name not in sd and vae and _vae_attn_proj(path):
            for new, old in _DEPRECATED.items():
                name = name.replace(f".{new}.", f".{old}.")
        t = sd[name]
        if vae and _vae_attn_proj(path) and like.ndim == 4:
            t = t.reshape(t.shape[0], t.shape[1], 1, 1)
        elif path.endswith("kernel") and t.ndim == 2:
            t = t.t()
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the config "
                             f"wants {tuple(like.shape)}")
        to = dtype if dtype is not None and t.is_floating_point() else t.dtype
        return t.to(device=device, dtype=to, copy=True).contiguous()

    return ParamTree(map_leaves(skeleton.to_tree(), leaf))


def unet_params_to_hf(params: ParamTree, cfg: UNetConfig
                      ) -> Dict[str, torch.Tensor]:
    """UNet weights -> {diffusers name: tensor} (views, on the weights'
    device)."""
    return _to_hf(params, vae=False)


def unet_params_from_hf(sd: Mapping[str, torch.Tensor], cfg: UNetConfig,
                        device="cuda", dtype: Optional[torch.dtype] = None
                        ) -> ParamTree:
    """{diffusers name: tensor} -> UNet weights on `device` (the card
    unless the caller passes another), in `dtype` or the files' own."""
    device = resolve_device(device)
    return _from_hf(sd, init_unet_params(cfg, device="meta"), False, device,
                    dtype)


def vae_params_to_hf(params: ParamTree, cfg: VAEConfig
                     ) -> Dict[str, torch.Tensor]:
    return _to_hf(params, vae=True)


def vae_params_from_hf(sd: Mapping[str, torch.Tensor], cfg: VAEConfig,
                       device="cuda", dtype: Optional[torch.dtype] = None
                       ) -> ParamTree:
    device = resolve_device(device)
    return _from_hf(sd, init_vae_params(cfg, device="meta"), True, device,
                    dtype)


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def unet_config_from_hf(c: Mapping) -> UNetConfig:
    """A diffusers UNet config.json -> UNetConfig (SD-1.5's legacy
    `attention_head_dim` counts heads, as UNetConfig's does)."""
    d = UNetConfig()
    blocks = c.get("down_block_types")
    return UNetConfig(
        sample_channels=c.get("in_channels", d.sample_channels),
        out_channels=c.get("out_channels", d.out_channels),
        block_out_channels=tuple(c.get("block_out_channels",
                                       d.block_out_channels)),
        layers_per_block=c.get("layers_per_block", d.layers_per_block),
        cross_attention_dim=c.get("cross_attention_dim",
                                  d.cross_attention_dim),
        attention_head_dim=c.get("attention_head_dim", d.attention_head_dim),
        norm_groups=c.get("norm_num_groups", d.norm_groups),
        attn_levels=(tuple("CrossAttn" in b for b in blocks) if blocks
                     else d.attn_levels))


def vae_config_from_hf(c: Mapping) -> VAEConfig:
    d = VAEConfig()
    return VAEConfig(
        in_channels=c.get("in_channels", d.in_channels),
        latent_channels=c.get("latent_channels", d.latent_channels),
        block_out_channels=tuple(c.get("block_out_channels",
                                       d.block_out_channels)),
        layers_per_block=c.get("layers_per_block", d.layers_per_block),
        norm_groups=c.get("norm_num_groups", d.norm_groups),
        scaling_factor=c.get("scaling_factor", d.scaling_factor))


def load_diffusers(path: str, device="cuda",
                   dtype: Optional[torch.dtype] = None
                   ) -> Tuple[ParamTree, ParamTree, UNetConfig, VAEConfig]:
    """A diffusers pipeline directory (`unet/` and `vae/`, each with its
    config.json and diffusion_pytorch_model.safetensors, as a published
    SD-1.5 checkpoint is laid out) -> (unet, vae, unet_cfg, vae_cfg) on
    `device` (the card unless the caller passes another)."""
    device = resolve_device(device)
    ucfg = unet_config_from_hf(_read_json(os.path.join(path, "unet",
                                                       "config.json")))
    vcfg = vae_config_from_hf(_read_json(os.path.join(path, "vae",
                                                      "config.json")))
    weights = "diffusion_pytorch_model.safetensors"
    unet = unet_params_from_hf(SafetensorsFile(os.path.join(
        path, "unet", weights)), ucfg, device, dtype)
    vae = vae_params_from_hf(SafetensorsFile(os.path.join(
        path, "vae", weights)), vcfg, device, dtype)
    return unet, vae, ucfg, vcfg
