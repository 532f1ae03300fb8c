"""Plain reference of the vision side: the SigLIP-SO400M tower, the
reduction of its 27 x 27 patch grid to the configured image tokens, the
projector into the decoder's width, and the vision head that predicts
visual tokens, in float32 (TF32 off).

The tower follows the published SiglipVisionModel: a stride-14 patch
convolution, learned positions, pre-norm ViT blocks (tanh GELU), and the
hidden state of the last block without the final LayerNorm (`select_layer`
-1). The reduction resizes the grid bilinearly (half-pixel centres, no
antialias) and L2-normalises each token. The projector (`mlp2x_gelu`) and
the head (`mlp`) are dense stacks with exact-erf GELU between layers. The
weights come as a name -> tensor mapping (`benchmark/weights.py`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.precision import matmul, round_fp8
from benchmark.weights import head_dims, projector_dims

_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv", "bv",
               "wo", "bo", "ln2_scale", "ln2_bias", "fc1", "fc1_bias", "fc2",
               "fc2_bias")


def layer_norm(x, s, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * s + b


def _block(x, w, sc, mode):
    N, T, D = x.shape
    H = sc["num_heads"]
    Dh = D // H
    h = layer_norm(x, w["ln1_scale"], w["ln1_bias"], sc["layer_norm_eps"])

    def heads(t):
        return t.view(N, T, H, Dh).transpose(1, 2)

    q = heads(matmul(h, w["wq"], mode) + w["bq"])
    k = heads(matmul(h, w["wk"], mode) + w["bk"])
    v = heads(matmul(h, w["wv"], mode) + w["bv"])
    p = torch.softmax((q @ k.transpose(-1, -2)) * Dh ** -0.5, dim=-1)
    o = (p @ v).transpose(1, 2).reshape(N, T, D)
    x = x + matmul(o, w["wo"], mode) + w["bo"]
    h = layer_norm(x, w["ln2_scale"], w["ln2_bias"], sc["layer_norm_eps"])
    h = F.gelu(matmul(h, w["fc1"], mode) + w["fc1_bias"], approximate="tanh")
    return x + matmul(h, w["fc2"], mode) + w["fc2_bias"]


@torch.no_grad()
def tower(W: Dict[str, torch.Tensor], sc: dict, pixels: torch.Tensor,
          mode: str = "fp32") -> torch.Tensor:
    """pixels [N, H, W, 3] (normalised) -> [N, 729, 1152] features."""
    P = sc["patch_size"]
    kernel = W["siglip.patch_kernel"].float().permute(3, 2, 0, 1)  # OIHW
    x = pixels.float().permute(0, 3, 1, 2)
    if mode == "fp8":
        x, kernel = round_fp8(x), round_fp8(kernel)
    x = F.conv2d(x, kernel, W["siglip.patch_bias"].float(), stride=P)
    x = x.flatten(2).transpose(1, 2) + W["siglip.pos_embed"].float()[None]
    for i in range(sc["num_layers"]):
        w = {k: W[f"siglip.layers.{i}.{k}"].float() for k in _BLOCK_KEYS}
        x = _block(x, w, sc, mode)
    return x


def reduce_tokens(feats: torch.Tensor, k: int) -> torch.Tensor:
    """[N, side^2, D] -> [N, k, D]: the grid resized to sqrt(k) a side,
    then each token L2-normalised."""
    N, T, D = feats.shape
    side, tgt = int(round(T ** 0.5)), int(round(k ** 0.5))
    g = feats.reshape(N, side, side, D).permute(0, 3, 1, 2)
    g = F.interpolate(g, size=(tgt, tgt), mode="bilinear",
                      align_corners=False, antialias=False)
    out = g.permute(0, 2, 3, 1).reshape(N, k, D)
    return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def image_features(W, cfg: dict, pixels: torch.Tensor, mode: str = "fp32"
                   ) -> torch.Tensor:
    """pixels -> the normalised image tokens [N, K, 1152]."""
    return reduce_tokens(tower(W, cfg["siglip"], pixels, mode),
                         cfg["mm"]["num_image_tokens"])


def _weight(W, params, name):
    if params is not None and name in params:
        return params[name]
    return W[name].float()


def _stack(W, prefix, n, x, mode, params=None):
    for j in range(n):
        k = _weight(W, params, f"{prefix}.layers.{j}.kernel")
        b = _weight(W, params, f"{prefix}.layers.{j}.bias")
        x = matmul(x, k, mode) + b
        if j < n - 1:
            x = F.gelu(x)
    return x


def project(W, cfg: dict, feats: torch.Tensor, mode: str = "fp32",
            params=None) -> torch.Tensor:
    """Image tokens [.., 1152] -> the decoder's width. `params` may hold
    float32 leaves to use instead of W's (for gradients)."""
    n = len(projector_dims(cfg["mm"], cfg["siglip"]["hidden_size"],
                           cfg["llama"]["hidden_size"]))
    return _stack(W, "projector", n, feats, mode, params)


def vision_head(W, cfg: dict, h: torch.Tensor, mode: str = "fp32",
                params=None) -> torch.Tensor:
    """Hidden [.., D] -> the predicted visual token, L2-normalised."""
    n = len(head_dims(cfg["mm"], cfg["llama"]["hidden_size"],
                      cfg["siglip"]["hidden_size"]))
    pred = _stack(W, "vision_head", n, h, mode, params)
    return pred / pred.norm(dim=-1, keepdim=True).clamp_min(1e-12)
