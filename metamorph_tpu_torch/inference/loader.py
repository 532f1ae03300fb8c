"""Model loading for inference (counterpart of
`metamorph_tpu/inference/loader.py`).

`load_pretrained_model` builds the MetaMorph module from a checkpoint
directory as `train/checkpoint.export_hf` writes it (HF config.json,
`metamorph_config.json`, model.safetensors and its index), or from a raw
HF LLaMA repo plus an HF SigLIP dir. The module is made empty on the
device (`torch.empty`) and filled tensor by tensor from the files; a part
the files do not hold (the `mlpmixer` mixers, the anyres newline, or a
tower that is neither in the file nor given) keeps the port's seed-0
random init (`convert.init_parts_`), as the JAX loader keeps its own.

`load_lora_model` adds a LoRA file's factors and merges them.
`load_visualization` and `save_visualizer` read and write the diffusion
visualizer's directory in the JAX package's format, so either package
loads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.convert import PARTS, init_parts_, resolve_device
from metamorph_tpu_torch.models.hf_import import (llama_params_from_hf,
                                                  load_safetensors_dir,
                                                  mlp_params_from_hf,
                                                  siglip_params_from_hf)
from metamorph_tpu_torch.models.lora import merge_lora
from metamorph_tpu_torch.models.metamorph import MetaMorph

TOWER_PREFIX = "model.vision_tower.vision_tower.vision_model."


def resolve_model_dir(path_or_repo: str) -> str:
    """A local directory passes through; anything else is taken as an HF
    hub repo id and fetched with `huggingface_hub` where that package is
    installed. Raises FileNotFoundError when it is absent or the hub is
    unreachable."""
    if os.path.isdir(path_or_repo):
        return path_or_repo
    try:
        from huggingface_hub import snapshot_download

        return snapshot_download(path_or_repo)
    except Exception as e:
        raise FileNotFoundError(
            f"'{path_or_repo}' is not a local directory and could not be "
            f"fetched from the HF hub ({type(e).__name__}: {e})") from e


def read_config(model_path: str) -> MetaMorphConfig:
    """A full export carries the typed config as `metamorph_config.json`
    (its config.json is HF-style); older exports wrote it as config.json."""
    path = os.path.join(model_path, "metamorph_config.json")
    if not os.path.exists(path):
        path = os.path.join(model_path, "config.json")
    with open(path) as f:
        return MetaMorphConfig.from_json(f.read())


@torch.no_grad()
def load_pretrained_model(model_path: str, dtype=torch.bfloat16,
                          hf_siglip_path: Optional[str] = None,
                          device="cuda") -> Tuple[MetaMorph, MetaMorphConfig]:
    """(MetaMorph, cfg) from an exported checkpoint dir (or hub repo id),
    on `device` (the card unless the caller passes another). The tower
    comes from `hf_siglip_path` when given, else from the checkpoint when
    it holds one."""
    device = resolve_device(device)
    model_path = resolve_model_dir(model_path)
    if hf_siglip_path:
        hf_siglip_path = resolve_model_dir(hf_siglip_path)
    cfg = read_config(model_path)
    tensors = load_safetensors_dir(model_path)
    model = MetaMorph(cfg, dtype=dtype, device=device)
    llama_params_from_hf(tensors, model.llama)
    loaded = {"llama"}
    if any(k.startswith("model.mm_projector") for k in tensors):
        mlp_params_from_hf(tensors, "model.mm_projector", model.projector)
        loaded.add("projector")
    if any(k.startswith("vision_head") for k in tensors):
        mlp_params_from_hf(tensors, "vision_head", model.vision_head)
        loaded.add("vision_head")
    if hf_siglip_path:
        siglip_params_from_hf(load_safetensors_dir(hf_siglip_path),
                              model.siglip)
        loaded.add("siglip")
    elif any(k.startswith(TOWER_PREFIX) for k in tensors):
        # a stage-2 full save embeds the tower
        siglip_params_from_hf(tensors, model.siglip, prefix=TOWER_PREFIX)
        loaded.add("siglip")
    init_parts_(model, cfg, seed=0,
                parts=[p for p in PARTS if p not in loaded])
    return model, cfg


def load_lora_model(model_path: str, lora_path: str, r: int, alpha: float,
                    dtype=None, hf_siglip_path: Optional[str] = None,
                    device="cuda") -> Tuple[MetaMorph, MetaMorphConfig]:
    """A base export plus a LoRA file's factors, merged into the weights
    (merge-and-unload)."""
    from metamorph_tpu_torch.train.checkpoint import load_lora

    model, cfg = load_pretrained_model(
        model_path, dtype=dtype or torch.bfloat16,
        hf_siglip_path=hf_siglip_path, device=device)
    load_lora(lora_path, model)
    merge_lora(model.llama, r=r, alpha=alpha)
    return model, cfg


# ---------------------------------------------------------------------------
# flat <-> nested helpers (lists encoded as numeric keys)
# ---------------------------------------------------------------------------

def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts/lists of tensors -> {"a/b/0/c": tensor}."""
    out: Dict[str, torch.Tensor] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_tree(flat: Dict[str, torch.Tensor], dtype=None) -> Any:
    """Inverse of `flatten_tree`; with `dtype`, floating leaves are cast."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = (val.to(dtype) if dtype is not None
                           and val.is_floating_point() else val)
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        return [_listify(node[str(i)]) for i in range(len(keys))]
    return {k: _listify(v) for k, v in node.items()}


def load_visualization(ckpt_dir: str, dtype=torch.float32, device="cuda"):
    """The visualizer (adapter, unet, vae, unet_cfg, vae_cfg, adapter_mode)
    on `device` (the card unless the caller passes another), from a
    directory as JAX's and the port's `save_visualizer` write it:
    `adapter`, `unet` and `vae.safetensors` holding JAX's `flatten_tree`
    keys and layouts (HWIO convs, [in, out] dense kernels), and
    `visualizer_config.json`."""
    from metamorph_tpu_torch.utils.safetensors_io import SafetensorsFile
    from metamorph_tpu_torch.visualizer.params import tree_from_jax
    from metamorph_tpu_torch.visualizer.unet import UNetConfig
    from metamorph_tpu_torch.visualizer.vae import VAEConfig

    device = resolve_device(device)
    ckpt_dir = resolve_model_dir(ckpt_dir)
    with open(os.path.join(ckpt_dir, "visualizer_config.json")) as f:
        meta = json.load(f)
    unet_cfg = UNetConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                             for k, v in meta["unet"].items()})
    vae_cfg = VAEConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in meta["vae"].items()})

    def load_tree(name):
        flat = SafetensorsFile(os.path.join(ckpt_dir, f"{name}.safetensors"))
        return tree_from_jax(unflatten_tree(dict(flat)), device, dtype)

    return (load_tree("adapter"), load_tree("unet"), load_tree("vae"),
            unet_cfg, vae_cfg, meta.get("adapter_mode", "mlp"))


def save_visualizer(ckpt_dir: str, adapter, unet, vae, unet_cfg, vae_cfg,
                    adapter_mode: str = "mlp") -> None:
    """Write the visualizer as JAX's `save_visualizer` does (see
    `load_visualization`), each tensor in its own dtype."""
    from metamorph_tpu_torch.utils.safetensors_io import save_file
    from metamorph_tpu_torch.visualizer.params import flat_to_jax

    os.makedirs(ckpt_dir, exist_ok=True)
    for name, tree in (("adapter", adapter), ("unet", unet), ("vae", vae)):
        save_file(flat_to_jax(tree),
                  os.path.join(ckpt_dir, f"{name}.safetensors"))
    with open(os.path.join(ckpt_dir, "visualizer_config.json"), "w") as f:
        json.dump({"unet": dataclasses.asdict(unet_cfg),
                   "vae": dataclasses.asdict(vae_cfg),
                   "adapter_mode": adapter_mode}, f, indent=2)
