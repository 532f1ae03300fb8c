"""SD-1.5 UNet2DCondition (counterpart of `metamorph_tpu/visualizer/unet.py`).

The SD-1.5 topology: conv_in -> [CrossAttnDown x3, Down] -> mid
(res-attn-res) -> [Up, CrossAttnUp x3] -> GroupNorm -> conv_out, with a
sinusoidal time embedding (cos first), GEGLU feed-forwards and 768-d
cross-attention conditioning; configurable so tests run a tiny instance.

The weights are a `params.ParamTree` with the JAX tree's keys. Inside,
activations are NCHW (a [B, H, W, C] input permuted to NCHW is
channels_last in memory, which the convolutions take as it is); at the
API, `unet_apply` takes and returns JAX's [B, H, W, C].

The cast points are the JAX package's, which decide the result in bf16:
a convolution's output is rounded to x's dtype before its bias is added;
GroupNorm and LayerNorm (population variance, eps 1e-5), SiLU and the
exact GELU run in fp32; attention scores and their softmax are fp32 (the
products of q and k taken in fp32, as JAX's `preferred_element_type`
does), and the probabilities are rounded to x's dtype before the product
with v. Attention materializes its scores with plain tensor ops, as the
JAX package does on purpose: SD-1.5's head dims (40/80/160) do not fit
the port's flash kernel (64 and 128 only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from metamorph_tpu_torch.convert import resolve_device
from metamorph_tpu_torch.visualizer.params import ParamTree


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8          # heads per attention (SD1.5: 8 heads)
    norm_groups: int = 32
    # which resolution levels carry cross-attention (SD1.5: all but the last)
    attn_levels: Tuple[bool, ...] = (True, True, True, False)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                          cross_attention_dim=16, attention_head_dim=4,
                          norm_groups=8, attn_levels=(True, False))


# ---------------------------------------------------------------------------
# init: JAX's scales (uniform +-fan_in**-0.5 for kernels and biases, ones
# and zeros for norms), drawn from one generator in tree order
# ---------------------------------------------------------------------------

class Init:
    """Draws a tree's tensors from one `torch.Generator` seeded with
    `seed` on `device`, in fp32, then cast to `dtype`. On the "meta"
    device it draws nothing: the tree's keys and shapes only."""

    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.device, self.dtype = torch.device(device), dtype
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(seed)

    def uniform(self, shape, bound: float) -> torch.Tensor:
        t = torch.empty(shape, device=self.device, dtype=torch.float32)
        return t.uniform_(-bound, bound, generator=self.gen).to(self.dtype)

    def normal(self, shape) -> torch.Tensor:
        t = torch.empty(shape, device=self.device, dtype=torch.float32)
        return t.normal_(generator=self.gen).to(self.dtype)

    def conv(self, kh: int, kw: int, cin: int, cout: int) -> Dict:
        bound = (kh * kw * cin) ** -0.5
        return {"kernel": self.uniform((cout, cin, kh, kw), bound),
                "bias": self.uniform((cout,), bound)}

    def dense(self, d_in: int, d_out: int) -> Dict:
        bound = d_in ** -0.5
        return {"kernel": self.uniform((d_in, d_out), bound),
                "bias": self.uniform((d_out,), bound)}

    def norm(self, c: int) -> Dict:
        return {"scale": torch.ones(c, device=self.device, dtype=self.dtype),
                "bias": torch.zeros(c, device=self.device, dtype=self.dtype)}


# ---------------------------------------------------------------------------
# primitives (NCHW activations)
# ---------------------------------------------------------------------------

def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 1
           ) -> torch.Tensor:
    return F.conv2d(x, p["kernel"], None, stride, padding) \
        + p["bias"][:, None, None]


def dense(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def group_norm(p, x: torch.Tensor, groups: int, eps: float = 1e-5
               ) -> torch.Tensor:
    return F.group_norm(x.float(), groups, p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers get_timestep_embedding(flip_sin_to_cos=True, shift=0)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsampling of NCHW x (JAX's
    `jax.image.resize(..., "nearest")` at exactly twice the size)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def attention_probs(q: torch.Tensor, k: torch.Tensor, dtype: torch.dtype
                    ) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) over the last axis, scores and softmax
    in fp32, returned in `dtype`. q [..., T, Dh], k [..., S, Dh]."""
    s = (q.float() @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    return torch.softmax(s, dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _init_resnet(init: Init, cin, cout, temb_dim):
    p = {
        "norm1": init.norm(cin),
        "conv1": init.conv(3, 3, cin, cout),
        "time_emb": init.dense(temb_dim, cout),
        "norm2": init.norm(cout),
        "conv2": init.conv(3, 3, cout, cout),
    }
    if cin != cout:
        p["shortcut"] = init.conv(1, 1, cin, cout)
    return p


def _resnet(p, x, temb, groups):
    h = silu(group_norm(p["norm1"], x, groups))
    h = conv2d(p["conv1"], h)
    t = dense(p["time_emb"], silu(temb))
    h = h + t[:, :, None, None]
    h = silu(group_norm(p["norm2"], h, groups))
    h = conv2d(p["conv2"], h)
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x, padding=0)
    return x + h


def _init_attention(init: Init, dim, ctx_dim, self_attn: bool):
    kv_dim = dim if self_attn else ctx_dim
    return {
        "q": {"kernel": init.dense(dim, dim)["kernel"]},
        "k": {"kernel": init.dense(kv_dim, dim)["kernel"]},
        "v": {"kernel": init.dense(kv_dim, dim)["kernel"]},
        "out": init.dense(dim, dim),
    }


def _attention(p, x, ctx, heads):
    """x: [B, T, D]; ctx: [B, S, Dc] (== x for self-attention). No q/k/v
    bias (diffusers CrossAttention)."""
    B, T, D = x.shape
    Dh = D // heads
    q = (x @ p["q"]["kernel"]).reshape(B, T, heads, Dh).transpose(1, 2)
    k = (ctx @ p["k"]["kernel"]).reshape(B, -1, heads, Dh).transpose(1, 2)
    v = (ctx @ p["v"]["kernel"]).reshape(B, -1, heads, Dh).transpose(1, 2)
    out = attention_probs(q, k, x.dtype) @ v            # [B, heads, T, Dh]
    return dense(p["out"], out.transpose(1, 2).reshape(B, T, D))


def _init_tblock(init: Init, dim, ctx_dim):
    return {
        "norm1": init.norm(dim),
        "attn1": _init_attention(init, dim, ctx_dim, self_attn=True),
        "norm2": init.norm(dim),
        "attn2": _init_attention(init, dim, ctx_dim, self_attn=False),
        "norm3": init.norm(dim),
        "geglu": init.dense(dim, 8 * dim),
        "ff_out": init.dense(4 * dim, dim),
    }


def _tblock(p, x, ctx, heads):
    n = layer_norm(p["norm1"], x)
    x = x + _attention(p["attn1"], n, n, heads)
    x = x + _attention(p["attn2"], layer_norm(p["norm2"], x), ctx, heads)
    h = dense(p["geglu"], layer_norm(p["norm3"], x))
    a, b = h.chunk(2, dim=-1)
    h = a * F.gelu(b.float()).to(x.dtype)
    return x + dense(p["ff_out"], h)


def _init_transformer2d(init: Init, dim, ctx_dim):
    return {
        "norm": init.norm(dim),
        "proj_in": init.conv(1, 1, dim, dim),
        "block": _init_tblock(init, dim, ctx_dim),
        "proj_out": init.conv(1, 1, dim, dim),
    }


def _transformer2d(p, x, ctx, heads, groups):
    B, C, H, W = x.shape
    h = group_norm(p["norm"], x, groups)
    h = conv2d(p["proj_in"], h, padding=0)
    h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
    h = _tblock(p["block"], h, ctx, heads)
    h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return conv2d(p["proj_out"], h, padding=0) + x


def _upsample(p, x):
    return conv2d(p, upsample_nearest(x))


# ---------------------------------------------------------------------------
# UNet init / apply
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_unet_params(cfg: UNetConfig, seed: int = 0, device="cuda",
                     dtype: torch.dtype = torch.float32) -> ParamTree:
    """Random UNet weights at the JAX initializer's scales, drawn on
    `device` (the card unless the caller passes another) from `seed`."""
    init = Init(seed, resolve_device(device), dtype)
    ch = cfg.block_out_channels
    L = len(ch)
    temb_dim = cfg.time_embed_dim
    ctx_dim = cfg.cross_attention_dim

    params: Dict[str, Any] = {
        "time_mlp": {
            "fc1": init.dense(ch[0], temb_dim),
            "fc2": init.dense(temb_dim, temb_dim),
        },
        "conv_in": init.conv(3, 3, cfg.sample_channels, ch[0]),
        "down": [],
        "mid": {},
        "up": [],
        "norm_out": init.norm(ch[0]),
        "conv_out": init.conv(3, 3, ch[0], cfg.out_channels),
    }

    cin = ch[0]
    for lvl in range(L):
        cout = ch[lvl]
        blk = {"resnets": [], "attns": [] if cfg.attn_levels[lvl] else None}
        for i in range(cfg.layers_per_block):
            blk["resnets"].append(_init_resnet(init, cin if i == 0 else cout,
                                               cout, temb_dim))
            if cfg.attn_levels[lvl]:
                blk["attns"].append(_init_transformer2d(init, cout, ctx_dim))
        if lvl < L - 1:
            blk["downsample"] = init.conv(3, 3, cout, cout)
        params["down"].append(blk)
        cin = cout

    params["mid"] = {
        "res1": _init_resnet(init, ch[-1], ch[-1], temb_dim),
        "attn": _init_transformer2d(init, ch[-1], ctx_dim),
        "res2": _init_resnet(init, ch[-1], ch[-1], temb_dim),
    }

    rev = list(reversed(ch))
    rev_attn = list(reversed(cfg.attn_levels))
    cin = ch[-1]
    for lvl in range(L):
        cout = rev[lvl]
        prev_out = rev[min(lvl + 1, L - 1)]
        blk = {"resnets": [], "attns": [] if rev_attn[lvl] else None}
        for i in range(cfg.layers_per_block + 1):
            # skips pop from the down stack: an up block's last skip has
            # the next level's channel count
            res_skip = cout if i < cfg.layers_per_block else prev_out
            blk["resnets"].append(_init_resnet(
                init, (cin if i == 0 else cout) + res_skip, cout, temb_dim))
            if rev_attn[lvl]:
                blk["attns"].append(_init_transformer2d(init, cout, ctx_dim))
        if lvl < L - 1:
            blk["upsample"] = init.conv(3, 3, cout, cout)
        params["up"].append(blk)
        cin = cout

    return ParamTree(params)


def unet_apply(params: ParamTree, cfg: UNetConfig, sample: torch.Tensor,
               t: torch.Tensor, encoder_hidden_states: torch.Tensor
               ) -> torch.Tensor:
    """sample [B,H,W,4], t [B] ints, encoder_hidden_states [B,77,768] ->
    predicted noise [B,H,W,4], in the dtype of sample (which must be the
    weights')."""
    heads = cfg.attention_head_dim
    groups = cfg.norm_groups
    ctx = encoder_hidden_states

    temb = timestep_embedding(t, cfg.block_out_channels[0])
    temb = dense(params["time_mlp"]["fc1"], temb.to(sample.dtype))
    temb = dense(params["time_mlp"]["fc2"], silu(temb))

    x = conv2d(params["conv_in"], sample.permute(0, 3, 1, 2))
    skips: List[torch.Tensor] = [x]

    for blk in params["down"]:
        attns = blk.get("attns")
        for i, res in enumerate(blk["resnets"]):
            x = _resnet(res, x, temb, groups)
            if attns is not None:
                x = _transformer2d(attns[i], x, ctx, heads, groups)
            skips.append(x)
        if "downsample" in blk:
            x = conv2d(blk["downsample"], x, stride=2)
            skips.append(x)

    x = _resnet(params["mid"]["res1"], x, temb, groups)
    x = _transformer2d(params["mid"]["attn"], x, ctx, heads, groups)
    x = _resnet(params["mid"]["res2"], x, temb, groups)

    for blk in params["up"]:
        attns = blk.get("attns")
        for i, res in enumerate(blk["resnets"]):
            x = torch.cat([x, skips.pop()], dim=1)
            x = _resnet(res, x, temb, groups)
            if attns is not None:
                x = _transformer2d(attns[i], x, ctx, heads, groups)
        if "upsample" in blk:
            x = _upsample(blk["upsample"], x)

    x = silu(group_norm(params["norm_out"], x, groups))
    return conv2d(params["conv_out"], x).permute(0, 2, 3, 1)
