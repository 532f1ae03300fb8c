"""SigLIP -> CLIP-text-space adapter (counterpart of
`metamorph_tpu/visualizer/adapter.py`), the diffusion conditioning
projector: 64 SigLIP tokens (1152-d) -> CLIP-space tokens (768-d), in one
of four modes:
  * mlp         per-token Linear + LN + ReLU stack (token count unchanged;
                the render pads 64 -> 77 with zeros);
  * xattn       77 learned query tokens cross-attending to the projected
                inputs (`num_heads` heads);
  * xattnffn    the same with a feed-forward after each block;
  * transformer an encoder-decoder with learned query embeddings; its
                attentions have 4 heads, whatever `num_heads` says, as in
                the JAX package.
The weights are a `params.ParamTree`; LayerNorm runs in fp32 (eps 1e-5),
attention scores and softmax in fp32.
"""

from __future__ import annotations

import torch

from metamorph_tpu_torch.convert import resolve_device
from metamorph_tpu_torch.visualizer.params import ParamTree
from metamorph_tpu_torch.visualizer.unet import (Init, attention_probs, dense,
                                                 layer_norm)


def _mha(p, q, kv, num_heads):
    """torch nn.MultiheadAttention equivalent (in_proj q/k/v + out_proj)."""
    B, Tq, D = q.shape
    Dh = D // num_heads
    qh = dense(p["q"], q).reshape(B, Tq, num_heads, Dh).transpose(1, 2)
    kh = dense(p["k"], kv).reshape(B, -1, num_heads, Dh).transpose(1, 2)
    vh = dense(p["v"], kv).reshape(B, -1, num_heads, Dh).transpose(1, 2)
    out = attention_probs(qh, kh, q.dtype) @ vh
    return dense(p["out"], out.transpose(1, 2).reshape(B, Tq, D))


def _ffn(p, x):
    return dense(p["fc2"], torch.relu(dense(p["fc1"], x)))


@torch.no_grad()
def init_adapter(mode: str = "mlp", input_dim: int = 1152,
                 hidden_dim: int = 4096, output_dim: int = 768,
                 num_tokens: int = 77, num_layers: int = 6,
                 num_heads: int = 8, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.float32) -> ParamTree:
    """Random adapter weights at the JAX initializer's scales (uniform
    +-fan_in**-0.5 for dense layers, N(0, 1) for learned tokens), drawn on
    `device` (the card unless the caller passes another) from `seed`."""
    init = Init(seed, resolve_device(device), dtype)

    def attn(d):
        return {n: init.dense(d, d) for n in ("q", "k", "v", "out")}

    def ffn(d):
        return {"fc1": init.dense(d, 4 * d), "fc2": init.dense(4 * d, d)}

    if mode == "mlp":
        dims = ([(input_dim, hidden_dim)]
                + [(hidden_dim, hidden_dim)] * (num_layers - 2)
                + [(hidden_dim, output_dim)])
        return ParamTree({"layers": [{"fc": init.dense(di, do),
                                      "ln": init.norm(do)}
                                     for di, do in dims]})
    if mode in ("xattn", "xattnffn"):
        blocks = []
        for _ in range(num_layers):
            blk = {"attn": attn(output_dim), "norm1": init.norm(output_dim)}
            if mode == "xattnffn":
                blk["ffn"] = ffn(output_dim)
                blk["norm2"] = init.norm(output_dim)
            blocks.append(blk)
        return ParamTree({
            "token_embeddings": init.normal((1, num_tokens, output_dim)),
            "proj": init.dense(input_dim, output_dim),
            "input_norm": init.norm(output_dim),
            "blocks": blocks,
        })
    if mode == "transformer":
        def tfm_layer(cross: bool):
            lay = {"self_attn": attn(hidden_dim),
                   "norm1": init.norm(hidden_dim),
                   "ffn": ffn(hidden_dim),
                   "norm_ffn": init.norm(hidden_dim)}
            if cross:
                lay["cross_attn"] = attn(hidden_dim)
                lay["norm2"] = init.norm(hidden_dim)
            return lay

        return ParamTree({
            "fc": init.dense(input_dim, hidden_dim),
            "encoder": [tfm_layer(False) for _ in range(num_layers)],
            "decoder": [tfm_layer(True) for _ in range(num_layers)],
            "enc_norm": init.norm(hidden_dim),
            "dec_norm": init.norm(hidden_dim),
            "out": init.dense(hidden_dim, output_dim),
            "query_embs": init.normal((1, num_tokens, hidden_dim)),
        })
    raise ValueError(f"Unsupported mode: {mode}")


def apply_adapter(params: ParamTree, x: torch.Tensor, mode: str = "mlp",
                  num_heads: int = 8) -> torch.Tensor:
    """x: [B, T_in, input_dim] -> [B, T_out, output_dim]."""
    if mode == "mlp":
        layers = params["layers"]
        for lay in layers[:-1]:
            x = torch.relu(layer_norm(lay["ln"], dense(lay["fc"], x)))
        last = layers[-1]
        return layer_norm(last["ln"], dense(last["fc"], x))
    if mode in ("xattn", "xattnffn"):
        B = x.shape[0]
        xp = layer_norm(params["input_norm"], dense(params["proj"], x))
        tokens = params["token_embeddings"].expand(B, -1, -1)
        for blk in params["blocks"]:
            attn = _mha(blk["attn"], tokens, xp, num_heads)
            tokens = layer_norm(blk["norm1"], tokens + attn)
            if "ffn" in blk:
                tokens = layer_norm(blk["norm2"],
                                    tokens + _ffn(blk["ffn"], tokens))
        return tokens
    if mode == "transformer":
        h = dense(params["fc"], x)
        # pre-norm encoder
        for lay in params["encoder"]:
            n = layer_norm(lay["norm1"], h)
            h = h + _mha(lay["self_attn"], n, n, 4)
            h = h + _ffn(lay["ffn"], layer_norm(lay["norm_ffn"], h))
        memory = layer_norm(params["enc_norm"], h)
        t = params["query_embs"].expand(x.shape[0], -1, -1)
        for lay in params["decoder"]:
            n = layer_norm(lay["norm1"], t)
            t = t + _mha(lay["self_attn"], n, n, 4)
            n = layer_norm(lay["norm2"], t)
            t = t + _mha(lay["cross_attn"], n, memory, 4)
            t = t + _ffn(lay["ffn"], layer_norm(lay["norm_ffn"], t))
        t = layer_norm(params["dec_norm"], t)
        return dense(params["out"], t)
    raise ValueError(mode)


def pad_tokens(x: torch.Tensor, num_tokens: int = 77) -> torch.Tensor:
    """Zero-pad [B, T, D] to num_tokens tokens (the demo's 64 -> 77),
    or keep the first num_tokens when T >= num_tokens."""
    B, T, D = x.shape
    if T >= num_tokens:
        return x[:, :num_tokens]
    return torch.cat([x, x.new_zeros(B, num_tokens - T, D)], dim=1)
