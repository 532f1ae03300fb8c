"""SigLIP-SO400M vision tower (counterpart of `metamorph_tpu/models/siglip.py`).

Pixels keep the JAX layout [N, H, W, 3] and the patch kernel its HWIO
layout [P, P, 3, D]. The patch embedding runs as one matrix product over
the flattened patches (the stride-P VALID convolution exactly), so it never
goes through cuDNN and its TF32 default. Attention is the plain
materialized path, as in the JAX package (729 tokens per image).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from metamorph_tpu_torch.config import MultimodalConfig, SiglipConfig
from metamorph_tpu_torch.models.llama import _param
from metamorph_tpu_torch.models.projector import Dense
from metamorph_tpu_torch.ops.attention import dot_product_attention


class SiglipLayer(nn.Module):
    def __init__(self, cfg: SiglipConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        D, Fd = cfg.hidden_size, cfg.intermediate_size
        kw = dict(dtype=dtype, device=device)
        self.ln1_scale, self.ln1_bias = _param(D, **kw), _param(D, **kw)
        self.wq, self.bq = _param(D, D, **kw), _param(D, **kw)
        self.wk, self.bk = _param(D, D, **kw), _param(D, **kw)
        self.wv, self.bv = _param(D, D, **kw), _param(D, **kw)
        self.wo, self.bo = _param(D, D, **kw), _param(D, **kw)
        self.ln2_scale, self.ln2_bias = _param(D, **kw), _param(D, **kw)
        self.fc1, self.fc1_bias = _param(D, Fd, **kw), _param(Fd, **kw)
        self.fc2, self.fc2_bias = _param(Fd, D, **kw), _param(D, **kw)

    def forward(self, cfg: SiglipConfig, x: torch.Tensor) -> torch.Tensor:
        """One ViT block (`_vit_block`), called as a module so that FSDP2
        gathers the layer's weights around it."""
        return _vit_block(cfg, x, self)


class Siglip(nn.Module):
    def __init__(self, cfg: SiglipConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.cfg = cfg
        P, D = cfg.patch_size, cfg.hidden_size
        kw = dict(dtype=dtype, device=device)
        self.patch_kernel = _param(P, P, 3, D, **kw)       # HWIO
        self.patch_bias = _param(D, **kw)
        self.pos_embed = _param(cfg.num_patches, D, **kw)
        self.layers = nn.ModuleList(SiglipLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln_scale = _param(D, **kw)
        self.final_ln_bias = _param(D, **kw)


class SiglipMixer(nn.Module):
    """The `mlpmixer` token reduction's weights: a token mixer
    [num_patches -> num_image_tokens] and a channel mixer [D -> D]."""

    def __init__(self, cfg: SiglipConfig, num_image_tokens: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        D = cfg.hidden_size
        self.token_mixer = Dense(cfg.num_patches, num_image_tokens, dtype,
                                 device)
        self.channel_mixer = Dense(D, D, dtype, device)


def layer_norm(x, scale, bias, eps):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


def _vit_block(cfg: SiglipConfig, x, p: SiglipLayer):
    B, T, D = x.shape
    H = cfg.num_heads
    Dh = D // H
    h = layer_norm(x, p.ln1_scale, p.ln1_bias, cfg.layer_norm_eps)
    q = (h @ p.wq + p.bq).reshape(B, T, H, Dh)
    k = (h @ p.wk + p.bk).reshape(B, T, H, Dh)
    v = (h @ p.wv + p.bv).reshape(B, T, H, Dh)
    x = x + (dot_product_attention(q, k, v).reshape(B, T, D) @ p.wo + p.bo)
    h = layer_norm(x, p.ln2_scale, p.ln2_bias, cfg.layer_norm_eps)
    h = h @ p.fc1 + p.fc1_bias
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return x + (h @ p.fc2 + p.fc2_bias)


def _patchify(pixels: torch.Tensor, P: int) -> torch.Tensor:
    """[N,H,W,3] -> [N, (H//P)*(W//P), P*P*3] in (row, col, channel) order,
    the order of the HWIO kernel flattened; the remainder past the last
    whole patch is dropped, as a VALID convolution drops it."""
    N, Hp, Wp = pixels.shape[0], pixels.shape[1] // P, pixels.shape[2] // P
    x = pixels[:, :Hp * P, :Wp * P]
    x = x.reshape(N, Hp, P, Wp, P, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(N, Hp * Wp, P * P * 3)


def siglip_encode(model: Siglip, cfg: SiglipConfig, pixels: torch.Tensor
                  ) -> torch.Tensor:
    """pixels [N,H,W,3] (SigLIP-normalized) -> features [N, num_patches, D]
    at hidden_states[select_layer] (-1 = last block output, pre-final-LN)."""
    dtype = model.pos_embed.dtype
    P = cfg.patch_size
    kernel = model.patch_kernel.reshape(P * P * 3, cfg.hidden_size)
    x = _patchify(pixels.to(dtype), P) @ kernel
    x = x + model.patch_bias + model.pos_embed[None]
    sel = cfg.select_layer
    n_run = cfg.num_layers + 1 + sel if sel < 0 else sel
    if not 0 <= n_run <= cfg.num_layers:
        raise ValueError(f"select_layer {sel} out of range")
    for layer in list(model.layers)[:n_run]:
        x = layer(cfg, x)
    # hidden_states[sel] is pre-final-LN: final_ln is NOT applied
    return x


def _resize_grid(features: torch.Tensor, side: int, out: int
                 ) -> torch.Tensor:
    """[N, side*side, D] -> [N, out, out, D] fp32: bilinear,
    align_corners=False, no antialias (the sampling of the JAX package's
    `jax.image.resize(..., "linear", antialias=False)`)."""
    N, _, D = features.shape
    grid = features.float().reshape(N, side, side, D).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(out, out), mode="bilinear",
                         align_corners=False, antialias=False)
    return grid.permute(0, 2, 3, 1)


def reduce_tokens(features: torch.Tensor, mm: MultimodalConfig,
                  mixer: Optional[SiglipMixer] = None) -> torch.Tensor:
    """num_patches -> num_image_tokens, by `mm.image_token_reduction`:
      * `interpolation`: bilinear resize of the patch grid;
      * `mlpmixer`: the token mixer across patches, then the channel mixer
        (the weights of `mixer`);
      * `concat_interpolation`: resize to twice the target side, then
        concatenate each 2x2 block's features: [N, K, 4*D];
      * `none`: the raw patch grid."""
    N, T, D = features.shape
    if T == mm.num_image_tokens or mm.image_token_reduction == "none":
        return features
    side = int(round(T ** 0.5))
    mode = mm.image_token_reduction
    if mode == "mlpmixer":
        tm, cm = mixer.token_mixer, mixer.channel_mixer
        x = (torch.einsum("ntd,tk->nkd", features, tm.kernel)
             + tm.bias[None, :, None])
        return x @ cm.kernel + cm.bias
    if mode not in ("interpolation", "concat_interpolation"):
        raise NotImplementedError(mode)
    tgt = int(round(mm.num_image_tokens ** 0.5))
    if mode == "interpolation":
        if tgt * tgt != mm.num_image_tokens:
            raise ValueError(
                f"num_image_tokens must be a perfect square for "
                f"interpolation reduction, got {mm.num_image_tokens}")
        out = _resize_grid(features, side, tgt)
        return out.reshape(N, tgt * tgt, D).to(features.dtype)
    grid = _resize_grid(features, side, 2 * tgt)
    # 2x2 spatial concat -> [N, tgt, tgt, 4D]
    grid = grid.reshape(N, tgt, 2, tgt, 2, D).permute(0, 1, 3, 2, 4, 5)
    return grid.reshape(N, tgt * tgt, 4 * D).to(features.dtype)


def vision_tower_forward(model: Siglip, cfg: SiglipConfig,
                         mm: MultimodalConfig, pixels: torch.Tensor,
                         mixer: Optional[SiglipMixer] = None
                         ) -> torch.Tensor:
    """ViT encode -> token reduction -> optional L2-normalize. Returns
    [N, num_image_tokens, D] in SigLIP feature space. With
    `mm.freeze_vision` the encoder output is detached before the token
    reduction, so the tower gets no gradient even when its weights are
    trainable (as `jax.lax.stop_gradient` does in the JAX package)."""
    feats = siglip_encode(model, cfg, pixels)
    if mm.freeze_vision:
        feats = feats.detach()
    feats = reduce_tokens(feats, mm, mixer)
    if mm.normalize_vision:
        f32 = feats.float()
        feats = (f32 / f32.norm(dim=-1, keepdim=True).clamp_min(1e-12)
                 ).to(feats.dtype)
    if mm.apply_softmax:
        feats = torch.softmax(feats.float() / 0.07, dim=-1).to(feats.dtype)
    return feats
