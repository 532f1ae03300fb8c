"""Weights into the port's modules.

`from_jax_params` carries a JAX parameter tree (nested dicts of arrays, as
`metamorph_tpu.models.metamorph.init_metamorph_params` or a checkpoint
gives it) across: the [L, ...]-stacked layer weights become per-layer
module parameters, with every dense weight kept [D_in, D_out]. LoRA
factors (`layers/<sub>/<w>_lora_a`, `_lora_b`) come across as the layers'
optional factor parameters. A weight-only int8 leaf (`{int8_q [L, D_in,
D_out], scale [L, 1, D_out]}`, what JAX's `quantize_llama_decode` makes)
becomes a `QuantizedWeight` per layer, its int8 matrix transposed to
[D_out, D_in] and both kept bit for bit. `llama_from_jax_params` does the
same for a bare LLaMA tree (`init_llama_params`, e.g. a drafter).

`to_jax_params` is the inverse: the module's weights (LoRA factors and
int8 leaves included) as the JAX tree of numpy arrays, so tests compare
parameters leaf by leaf.

`visualizer_from_jax_params` / `visualizer_to_jax_params` carry the
diffusion visualizer's three trees (adapter, UNet, VAE) across the same
way, conv kernels between JAX's HWIO and torch's [out, in, kh, kw];
`visualizer_train_state_from_jax` carries a whole visualizer train state
(the trees and both optax `adamw` states) into the port's.

`init_params` (and `init_llama`, for a bare LLaMA) makes random weights
on the device from a seed, at the scales the JAX initializers use
(normal * fan_in**-0.5 for the LLaMA and SigLIP
dense weights and the anyres `image_newline`, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for the projector, the vision head and the `mlpmixer`
mixers, ones for norm scales, zeros for SigLIP biases). It follows the
scales, not JAX's random bits.
"""

from __future__ import annotations

from typing import Any, Collection, Mapping, Optional

import numpy as np
import torch
from torch import nn

from metamorph_tpu_torch.config import LlamaConfig, MetaMorphConfig
from metamorph_tpu_torch.models.llama import Llama
from metamorph_tpu_torch.models.lora import LORA_TARGETS
from metamorph_tpu_torch.models.metamorph import MetaMorph
from metamorph_tpu_torch.ops.quant import QUANT_KEY, QuantizedWeight

# the parts `init_parts_` can fill, in the order it draws them
PARTS = ("llama", "siglip", "projector", "vision_head", "siglip_mixer",
         "image_newline")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another (`device="cpu"`). Raises when a CUDA device is named and none
    exists, rather than carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {device}: metamorph_tpu_torch runs on an "
            f"NVIDIA GPU; pass device='cpu' to run on the CPU")
    return device


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _is_int8(leaf) -> bool:
    return isinstance(leaf, Mapping) and QUANT_KEY in leaf


def _int8_weight(leaf, l: Optional[int], device) -> QuantizedWeight:
    """One [D_in, D_out] int8 leaf (layer l of a stacked one) as a
    QuantizedWeight on `device`, bit for bit."""
    q, scale = np.asarray(leaf[QUANT_KEY]), np.asarray(leaf["scale"])
    if l is not None:
        q, scale = q[l], scale[l]
    if q.dtype != np.int8 or scale.dtype != np.float32:
        raise ValueError(f"an int8 leaf holds int8_q {q.dtype} and scale "
                         f"{scale.dtype}, want int8 and float32")
    return QuantizedWeight(
        torch.from_numpy(np.ascontiguousarray(q.T)).to(device),
        torch.from_numpy(scale.reshape(-1).copy()).to(device))


def _put_dense(module: nn.Module, name: str, leaf, l: Optional[int],
               device) -> None:
    """A dense weight into `module.<name>`: values into the parameter, or
    an int8 leaf as a QuantizedWeight in its place."""
    if not _is_int8(leaf):
        _put(getattr(module, name), _np(leaf) if l is None else
             _np(leaf)[l])
        return
    w = _int8_weight(leaf, l, device)
    if w.shape != tuple(getattr(module, name).shape):
        raise ValueError(f"{name}: int8 shape {w.shape} != "
                         f"{tuple(getattr(module, name).shape)}")
    delattr(module, name)
    setattr(module, name, w)


def _put(param: torch.Tensor, value) -> None:
    v = torch.from_numpy(_np(value))
    if tuple(v.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(v.shape)} != {tuple(param.shape)}")
    param.copy_(v)


def _tree_dtype(llama_tree: Mapping[str, Any]) -> torch.dtype:
    """float32 for a float32 tree, bfloat16 otherwise."""
    emb = np.asarray(llama_tree["embed"]["embedding"])
    return torch.float32 if emb.dtype == np.float32 else torch.bfloat16


def _fill_llama(llama: Llama, lt: Mapping[str, Any], device, dtype) -> None:
    """A JAX LLaMA tree (`init_llama_params` layout) into `llama`'s
    parameters, LoRA factors included."""
    _put(llama.embed, lt["embed"]["embedding"])
    _put(llama.final_norm, lt["final_norm"]["scale"])
    if llama.lm_head is not None:
        _put_dense(llama, "lm_head", lt["lm_head"]["kernel"], None, device)
    la = lt["layers"]
    for l, layer in enumerate(llama.layers):
        for name in ("wq", "wk", "wv", "wo"):
            _put_dense(layer, name, la["attn"][name], l, device)
        for name in ("w_gate", "w_up", "w_down"):
            _put_dense(layer, name, la["mlp"][name], l, device)
        _put(layer.input_norm, _np(la["input_norm"]["scale"])[l])
        _put(layer.post_attn_norm, _np(la["post_attn_norm"]["scale"])[l])
    for sub, name in LORA_TARGETS:
        for key in (f"{name}_lora_a", f"{name}_lora_b"):
            if key in la[sub]:
                stacked = _np(la[sub][key])
                for l, layer in enumerate(llama.layers):
                    setattr(layer, key, nn.Parameter(
                        torch.from_numpy(stacked[l]).to(device, dtype)))


@torch.no_grad()
def llama_from_jax_params(tree: Mapping[str, Any], cfg: LlamaConfig,
                          device="cuda", dtype: Optional[torch.dtype] = None
                          ) -> Llama:
    """A bare JAX LLaMA tree (`init_llama_params`, e.g. a drafter) -> `Llama`
    module on `device` (the card unless the caller passes another); dtype
    as in `from_jax_params`."""
    device = resolve_device(device)
    dtype = dtype or _tree_dtype(tree)
    llama = Llama(cfg, dtype=dtype, device=device)
    _fill_llama(llama, tree, device, dtype)
    return llama


@torch.no_grad()
def from_jax_params(tree: Mapping[str, Any], cfg: MetaMorphConfig,
                    device="cuda", dtype: Optional[torch.dtype] = None
                    ) -> MetaMorph:
    """JAX parameter tree -> MetaMorph module on `device` (the card unless
    the caller passes another). `dtype` defaults to float32 for a float32
    tree and bfloat16 otherwise."""
    device = resolve_device(device)
    dtype = dtype or _tree_dtype(tree["llama"])
    model = MetaMorph(cfg, dtype=dtype, device=device)
    _fill_llama(model.llama, tree["llama"], device, dtype)

    st = tree["siglip"]
    sm = model.siglip
    _put(sm.patch_kernel, st["patch_embed"]["kernel"])
    _put(sm.patch_bias, st["patch_embed"]["bias"])
    _put(sm.pos_embed, st["pos_embed"])
    _put(sm.final_ln_scale, st["final_ln"]["scale"])
    _put(sm.final_ln_bias, st["final_ln"]["bias"])
    sl = st["layers"]
    for l, layer in enumerate(sm.layers):
        for ln in ("ln1", "ln2"):
            _put(getattr(layer, f"{ln}_scale"), _np(sl[ln]["scale"])[l])
            _put(getattr(layer, f"{ln}_bias"), _np(sl[ln]["bias"])[l])
        for name in ("wq", "wk", "wv", "wo"):
            _put(getattr(layer, name), _np(sl["attn"][name]["kernel"])[l])
            _put(getattr(layer, "b" + name[1]),
                 _np(sl["attn"][name]["bias"])[l])
        for name in ("fc1", "fc2"):
            _put(getattr(layer, name), _np(sl["mlp"][name]["kernel"])[l])
            _put(getattr(layer, f"{name}_bias"),
                 _np(sl["mlp"][name]["bias"])[l])

    for stack, sub in ((model.projector, tree["projector"]),
                       (model.vision_head, tree["vision_head"])):
        for i, dense in enumerate(stack.layers):
            _put(dense.kernel, sub[f"w{i}"]["kernel"])
            _put(dense.bias, sub[f"w{i}"]["bias"])
    for name in ("siglip_mixer", "image_newline"):
        if (getattr(model, name) is None) != (name not in tree):
            raise ValueError(f"the config and the tree disagree on {name!r}")
    if model.siglip_mixer is not None:
        for name in ("token_mixer", "channel_mixer"):
            dense = getattr(model.siglip_mixer, name)
            _put(dense.kernel, tree["siglip_mixer"][name]["kernel"])
            _put(dense.bias, tree["siglip_mixer"][name]["bias"])
    if model.image_newline is not None:
        _put(model.image_newline, tree["image_newline"])
    return model


@torch.no_grad()
def to_jax_params(model: MetaMorph) -> dict:
    """MetaMorph module -> JAX parameter tree of fp32 numpy arrays (int8
    weights as {int8_q, scale} int8 / fp32 leaves), with the per-layer
    weights stacked on a leading [L] axis."""

    def a(p: torch.Tensor) -> np.ndarray:
        return p.detach().float().cpu().numpy()

    def int8(w: QuantizedWeight) -> dict:
        return {QUANT_KEY: w.q.t().cpu().numpy(),
                "scale": w.scale.cpu().numpy()[None]}

    def stack(layers, name: str):
        ws = [getattr(layer, name) for layer in layers]
        if isinstance(ws[0], QuantizedWeight):
            per = [int8(w) for w in ws]
            return {k: np.stack([p[k] for p in per]) for k in per[0]}
        return np.stack([a(w) for w in ws])

    lm = model.llama
    ll = lm.layers
    llama = {
        "embed": {"embedding": a(lm.embed)},
        "layers": {
            "attn": {n: stack(ll, n) for n in ("wq", "wk", "wv", "wo")},
            "mlp": {n: stack(ll, n) for n in ("w_gate", "w_up", "w_down")},
            "input_norm": {"scale": stack(ll, "input_norm")},
            "post_attn_norm": {"scale": stack(ll, "post_attn_norm")},
        },
        "final_norm": {"scale": a(lm.final_norm)},
    }
    if lm.lm_head is not None:
        llama["lm_head"] = {"kernel": int8(lm.lm_head) if isinstance(
            lm.lm_head, QuantizedWeight) else a(lm.lm_head)}
    for sub, name in LORA_TARGETS:
        for key in (f"{name}_lora_a", f"{name}_lora_b"):
            if getattr(ll[0], key) is not None:
                llama["layers"][sub][key] = stack(ll, key)
    sm = model.siglip
    sl = sm.layers
    siglip = {
        "patch_embed": {"kernel": a(sm.patch_kernel),
                        "bias": a(sm.patch_bias)},
        "pos_embed": a(sm.pos_embed),
        "layers": {
            "ln1": {"scale": stack(sl, "ln1_scale"),
                    "bias": stack(sl, "ln1_bias")},
            "ln2": {"scale": stack(sl, "ln2_scale"),
                    "bias": stack(sl, "ln2_bias")},
            "attn": {n: {"kernel": stack(sl, n), "bias": stack(sl, "b" + n[1])}
                     for n in ("wq", "wk", "wv", "wo")},
            "mlp": {n: {"kernel": stack(sl, n), "bias": stack(sl, n + "_bias")}
                    for n in ("fc1", "fc2")},
        },
        "final_ln": {"scale": a(sm.final_ln_scale),
                     "bias": a(sm.final_ln_bias)},
    }

    def dense_stack(stack_mod) -> dict:
        return {f"w{i}": {"kernel": a(d.kernel), "bias": a(d.bias)}
                for i, d in enumerate(stack_mod.layers)}

    tree = {"llama": llama, "siglip": siglip,
            "projector": dense_stack(model.projector),
            "vision_head": dense_stack(model.vision_head)}
    if model.siglip_mixer is not None:
        tree["siglip_mixer"] = {
            name: {"kernel": a(d.kernel), "bias": a(d.bias)}
            for name, d in (("token_mixer", model.siglip_mixer.token_mixer),
                            ("channel_mixer",
                             model.siglip_mixer.channel_mixer))}
    if model.image_newline is not None:
        tree["image_newline"] = a(model.image_newline)
    return tree


def _init_llama_(llama: Llama, lc: LlamaConfig, normal) -> None:
    D, Fd = lc.hidden_size, lc.intermediate_size
    H, Dh = lc.num_heads, lc.head_dim
    normal(llama.embed, D)
    if llama.lm_head is not None:
        normal(llama.lm_head, D)
    llama.final_norm.fill_(1.0)
    for layer in llama.layers:
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            normal(getattr(layer, name), D)
        normal(layer.wo, H * Dh)
        normal(layer.w_down, Fd)
        layer.input_norm.fill_(1.0)
        layer.post_attn_norm.fill_(1.0)


@torch.no_grad()
def init_llama(cfg: LlamaConfig, seed: int = 0, device="cuda",
               dtype: torch.dtype = torch.bfloat16) -> Llama:
    """A bare random LLaMA (e.g. a drafter) made on `device` (the card
    unless the caller passes another) from `seed`, at `init_params`'s
    scales."""
    device = resolve_device(device)
    llama = Llama(cfg, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    _init_llama_(llama, cfg, lambda p, fan_in: p.normal_(
        0.0, fan_in ** -0.5, generator=gen))
    return llama


@torch.no_grad()
def init_params(cfg: MetaMorphConfig, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> MetaMorph:
    """Random MetaMorph weights made on `device` (the card unless the caller
    passes another) from `seed`."""
    device = resolve_device(device)
    model = MetaMorph(cfg, dtype=dtype, device=device)
    return init_parts_(model, cfg, seed)


@torch.no_grad()
def init_parts_(model: MetaMorph, cfg: MetaMorphConfig, seed: int = 0,
                parts: Collection[str] = PARTS) -> MetaMorph:
    """Fill the named parts of `model` (see PARTS) with random weights from
    `seed`, in place; the others are left as they are. With every part,
    the weights are those of `init_params`."""
    gen = torch.Generator(device=model.llama.embed.device)
    gen.manual_seed(seed)

    def normal(p: torch.Tensor, fan_in: int) -> None:
        p.normal_(0.0, fan_in ** -0.5, generator=gen)

    if "llama" in parts:
        _init_llama_(model.llama, cfg.llama, normal)

    sc = cfg.siglip
    sm = model.siglip
    if "siglip" in parts:
        normal(sm.patch_kernel, sc.patch_size * sc.patch_size * 3)
        sm.patch_bias.zero_()
        normal(sm.pos_embed, sc.hidden_size)
        sm.final_ln_scale.fill_(1.0)
        sm.final_ln_bias.zero_()
        for layer in sm.layers:
            for name in ("wq", "wk", "wv", "wo", "fc1"):
                normal(getattr(layer, name), sc.hidden_size)
            normal(layer.fc2, sc.intermediate_size)
            for name in ("bq", "bk", "bv", "bo", "fc1_bias", "fc2_bias",
                         "ln1_bias", "ln2_bias"):
                getattr(layer, name).zero_()
            layer.ln1_scale.fill_(1.0)
            layer.ln2_scale.fill_(1.0)

    mixers = ([model.siglip_mixer.token_mixer, model.siglip_mixer.channel_mixer]
              if model.siglip_mixer is not None and "siglip_mixer" in parts
              else [])
    stacks = [*(model.projector.layers if "projector" in parts else []),
              *(model.vision_head.layers if "vision_head" in parts else [])]
    for dense in [*stacks, *mixers]:
        bound = dense.kernel.shape[0] ** -0.5
        dense.kernel.uniform_(-bound, bound, generator=gen)
        dense.bias.uniform_(-bound, bound, generator=gen)
    if model.image_newline is not None and "image_newline" in parts:
        # randn(D) / sqrt(D), as the reference initialises it
        normal(model.image_newline, cfg.llama.hidden_size)
    return model


@torch.no_grad()
def visualizer_from_jax_params(adapter: Mapping[str, Any],
                               unet: Mapping[str, Any],
                               vae: Mapping[str, Any], device="cuda",
                               dtype: Optional[torch.dtype] = None):
    """The JAX visualizer's three trees (`init_adapter`,
    `init_unet_params`, `init_vae_params` or `load_visualization`) ->
    (adapter, unet, vae) `ParamTree`s on `device` (the card unless the
    caller passes another): HWIO conv kernels become [out, in, kh, kw],
    dense kernels stay [in, out], and `attns: None` stays None. Floating
    leaves are cast to `dtype` when given, else kept bit for bit."""
    from metamorph_tpu_torch.visualizer.params import tree_from_jax

    device = resolve_device(device)
    return tuple(tree_from_jax(t, device, dtype) for t in (adapter, unet, vae))


def visualizer_to_jax_params(adapter, unet, vae):
    """Inverse of `visualizer_from_jax_params`: three JAX trees of numpy
    arrays, bit for bit (bf16 weights as fp32 arrays)."""
    from metamorph_tpu_torch.visualizer.params import tree_to_jax

    return tuple(tree_to_jax(t) for t in (adapter, unet, vae))


def _adamw_state_from_jax(opt_state, device) -> dict:
    """An optax `adamw` chain state -> the port's {"count", "mu", "nu"},
    moments keyed like the module's parameters. The chain state is a
    tuple of named tuples: the one with `mu` and `nu` is scale_by_adam's,
    and every `count` field holds the step count."""
    from metamorph_tpu_torch.visualizer.params import tree_from_jax

    fields = [(s, getattr(s, "_fields", ())) for s in opt_state]
    counts = {int(np.asarray(s.count)) for s, f in fields if "count" in f}
    adam = [s for s, f in fields if "mu" in f and "nu" in f]
    if len(counts) != 1 or len(adam) != 1:
        raise ValueError(f"not an adamw state: counts {counts}, "
                         f"{len(adam)} moment states")

    def moments(tree):
        return {n: p.data for n, p in
                tree_from_jax(tree, device).named_parameters()}

    return {"count": counts.pop(), "mu": moments(adam[0].mu),
            "nu": moments(adam[0].nu)}


def visualizer_train_state_from_jax(state: Mapping[str, Any], device="cuda"
                                    ) -> dict:
    """JAX's visualizer train state ({adapter, unet, vae, opt_adapter,
    opt_unet}, from `make_visualizer_train_step`'s init or its steps) ->
    the port's, on `device` (the card unless the caller passes another):
    the trees through `visualizer_from_jax_params`, each adamw state's
    count and moments bit for bit."""
    device = resolve_device(device)
    trees = visualizer_from_jax_params(
        *(state[k] for k in ("adapter", "unet", "vae")), device=device)
    out = dict(zip(("adapter", "unet", "vae"), trees))
    for k in ("opt_adapter", "opt_unet"):
        out[k] = _adamw_state_from_jax(state[k], device)
    return out
