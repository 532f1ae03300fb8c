"""Checkpoint / resume (counterpart of `metamorph_tpu/train/checkpoint.py`).

Same directory layout as the JAX package: `{ckpt_dir}/step_{n}/` holds the
state, `meta.json` ({"step", "data_state"}) and `config.json`; a step
directory counts once its `meta.json` exists. The state (model weights,
optimizer moments and count, step) goes through `torch.save` into
`state.pt`.

A sharded train state (`make_sharded_train_step`) saves in the same
format: every rank takes part in gathering each full tensor (FSDP2's
shards, then the tensor cut), one tensor at a time onto the host, and rank
0 alone writes the files; on restore every rank reads the whole file and
keeps its own shard of each tensor. So a sharded checkpoint restores on
one device and a one-device checkpoint restores onto a mesh.

The other saves are safetensors files in the JAX package's key layouts, so
each package reads the other's:
  * the stage-1 adapter (`save_adapter`/`load_adapter`): the projector
    under the reference's `model.mm_projector.*` names, plus the token
    embeddings (all rows, or only the two image-token rows);
  * LoRA factors (`save_lora`/`load_lora`): flat `llama/layers/<sub>/<w>_
    lora_{a,b}` keys, stacked over layers;
  * the full HF export (`export_hf`): the LLaMA backbone under HF names
    with an HF config.json, the projector and vision head, the tower both
    in the file and as a standalone `vision_tower/` dir, the typed config
    as `metamorph_config.json`, and the tokenizer files.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import torch
from torch import nn

from metamorph_tpu_torch.models import hf_import
from metamorph_tpu_torch.utils.safetensors_io import (SafetensorsFile,
                                                      nbytes, save_file)


def _sharded(state: dict) -> bool:
    return "tensor_cut" in state


def _full(p: torch.Tensor, t: torch.Tensor, cut: Dict[str, int],
          name: str, group) -> torch.Tensor:
    """The whole of tensor `t` (the local shard of parameter `p`, or a
    moment made from it) on the host: FSDP2's shards gathered over the
    (data, fsdp) mesh, then the tensor cut over the tensor group."""
    from torch.distributed.tensor import DTensor

    dev = p.to_local().device
    full = DTensor.from_local(t.to(dev), p.device_mesh, p.placements,
                              shape=p.shape, stride=p.stride()).full_tensor()
    if name in cut:
        parts = [torch.empty_like(full)
                 for _ in range(torch.distributed.get_world_size(group))]
        torch.distributed.all_gather(parts, full.contiguous(), group=group)
        full = torch.cat(parts, dim=cut[name])
    return full.cpu()


def _shard_of(p: torch.Tensor, full: torch.Tensor, cut: Dict[str, int],
              name: str, group) -> torch.Tensor:
    """This rank's shard of `full` as parameter `p` holds it: the tensor
    cut, then FSDP2's cut (no communication)."""
    from torch.distributed.tensor import distribute_tensor

    if name in cut:
        full = full.chunk(torch.distributed.get_world_size(group),
                          cut[name])[torch.distributed.get_rank(group)]
    return distribute_tensor(full.to(p.to_local().device), p.device_mesh,
                             p.placements, src_data_rank=None).to_local()


@torch.no_grad()
def full_train_state(state: dict) -> Optional[dict]:
    """The one-device form of a sharded train state ({"params": state
    dict, "opt_state", "step"}, host tensors) on rank 0, None on the other
    ranks; every rank must call it."""
    model, opt, cut = state["params"], state["opt_state"], state["tensor_cut"]
    group = state["tensor_group"]
    rank0 = torch.distributed.get_rank() == 0
    params, mu, nu = {}, {}, {}
    for name, p in model.named_parameters():
        for out, t in ((params, p.to_local()), (mu, opt["mu"].get(name)),
                       (nu, opt["nu"].get(name))):
            if t is not None:
                full = _full(p, t, cut, name, group)
                if rank0:
                    out[name] = full
    if not rank0:
        return None
    return {"params": params,
            "opt_state": {"count": opt["count"], "mu": mu, "nu": nu},
            "step": state["step"]}


def adapter_param(name: str) -> bool:
    """A parameter `save_adapter` writes."""
    return name.startswith("projector.") or name == "llama.embed"


def lora_param(name: str) -> bool:
    """A parameter `save_lora` writes."""
    return "_lora_" in name


@torch.no_grad()
def full_model(state: dict, keep: Callable[[str], bool]):
    """What `save_adapter` and `save_lora` read from a train state's model.
    A one-device state's model as it is. A sharded state's parameters whose
    names `keep` accepts, gathered whole onto the host (every rank must
    call) as attributes of nested objects laid out as the model, a layer
    index picking from a list: on rank 0, None on the other ranks."""
    if not _sharded(state):
        return state["params"]
    cut, group = state["tensor_cut"], state["tensor_group"]
    full = {n: _full(p, p.to_local(), cut, n, group)
            for n, p in state["params"].named_parameters() if keep(n)}
    if torch.distributed.get_rank() != 0:
        return None
    root: dict = {}
    for name, t in full.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [build(node[str(i)]) for i in range(len(node))]
        return SimpleNamespace(**{k: build(v) for k, v in node.items()})

    return build(root)


def save_train_state(ckpt_dir: str, step: int, state: dict,
                     config_json: Optional[str] = None,
                     data_state: Optional[Dict] = None) -> str:
    """Write the train state under {ckpt_dir}/step_{step}. A sharded state
    is gathered (every rank calls this) and written by rank 0."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    if _sharded(state):
        full = full_train_state(state)
        if full is not None:
            os.makedirs(path, exist_ok=True)
            torch.save(full, os.path.join(path, "state.pt"))
            _write_meta(path, step, config_json, data_state)
        torch.distributed.barrier()
        return path
    os.makedirs(path, exist_ok=True)
    torch.save({"params": state["params"].state_dict(),
                "opt_state": state["opt_state"], "step": state["step"]},
               os.path.join(path, "state.pt"))
    _write_meta(path, step, config_json, data_state)
    return path


def _write_meta(path: str, step: int, config_json: Optional[str],
                data_state: Optional[Dict]) -> None:
    # config first: a step directory counts once its meta.json exists
    if config_json is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(config_json)
    meta = {"step": step}
    if data_state is not None:
        meta["data_state"] = data_state
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)$", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            steps.append(int(m.group(1)))
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")


@torch.no_grad()
def restore_train_state(path: str, template: dict) -> dict:
    """Restore into the template state in place (its devices and dtypes:
    offloaded moments stay in their pinned host tensors) and return it.
    The file is mapped on the host and copied tensor by tensor."""
    model = template["params"]
    saved = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                       mmap=True, weights_only=True)
    opt = template["opt_state"]
    if _sharded(template):
        cut, group = template["tensor_cut"], template["tensor_group"]
        for name, p in model.named_parameters():
            p.to_local().copy_(_shard_of(p, saved["params"][name], cut,
                                         name, group))
            for key in ("mu", "nu"):
                if name in opt[key]:
                    opt[key][name].copy_(_shard_of(
                        p, saved["opt_state"][key][name], cut, name, group))
        opt["count"] = saved["opt_state"]["count"]
        template["step"] = saved["step"]
        return template
    model.load_state_dict(saved["params"])
    for key in ("mu", "nu"):
        for name, t in opt[key].items():
            t.copy_(saved["opt_state"][key][name])
    opt["count"] = saved["opt_state"]["count"]
    template["step"] = saved["step"]
    return template


def restore_meta(path: str) -> Dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def prune_checkpoints(ckpt_dir: str, keep: int = 1):
    """Keep the newest `keep` step directories (save_total_limit)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        (int(m.group(1)) for name in os.listdir(ckpt_dir)
         for m in [re.match(r"step_(\d+)$", name)] if m), reverse=True)
    for s in steps[keep:]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


# ---------------------------------------------------------------------------
# adapter-only (stage-1) saves: the reference's mm_projector.bin
# ---------------------------------------------------------------------------

def save_adapter(path: str, model: nn.Module) -> None:
    """The projector and the token embeddings as a safetensors file in the
    reference's key layout (`model`: the model, or `full_model` of a
    sharded train state)."""
    tensors = hf_import.mlp_params_to_hf(model.projector, "model.mm_projector")
    tensors["model.embed_tokens.weight"] = model.llama.embed.detach()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file(tensors, path)


@torch.no_grad()
def load_adapter(path: str, model: nn.Module) -> nn.Module:
    """A stage-1 adapter into `model`, in place (the pretrain_mm_mlp_adapter
    path): the projector, and the embeddings when the file has them, either
    the whole table or only its last two rows (the image tokens)."""
    tensors = SafetensorsFile(path)
    hf_import.mlp_params_from_hf(tensors, "model.mm_projector",
                                 model.projector)
    if "model.embed_tokens.weight" in tensors:
        emb = tensors["model.embed_tokens.weight"]
        cur = model.llama.embed
        if emb.shape == cur.shape:
            cur.copy_(emb.to(cur.device))
        elif emb.shape[0] == 2:      # only the two new token rows
            cur[-2:].copy_(emb.to(cur.device))
        else:
            raise ValueError(
                f"unexpected embed_tokens shape {tuple(emb.shape)}")
    return model


# ---------------------------------------------------------------------------
# HF-format full export
# ---------------------------------------------------------------------------

def export_siglip_hf(out_dir: str, siglip: nn.Module, siglip_cfg,
                     dtype: torch.dtype = torch.float32) -> int:
    """A standalone tower dir that `SiglipVisionModel.from_pretrained`
    loads (weights in `dtype` + config.json). Returns the bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    n = save_file(hf_import.siglip_params_to_hf(siglip),
                  os.path.join(out_dir, "model.safetensors"), dtype=dtype)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "architectures": ["SiglipVisionModel"],
            "model_type": "siglip_vision_model",
            "hidden_size": siglip_cfg.hidden_size,
            "intermediate_size": siglip_cfg.intermediate_size,
            "num_hidden_layers": siglip_cfg.num_layers,
            "num_attention_heads": siglip_cfg.num_heads,
            "image_size": siglip_cfg.image_size,
            "patch_size": siglip_cfg.patch_size,
            "layer_norm_eps": siglip_cfg.layer_norm_eps,
            "hidden_act": "gelu_pytorch_tanh",
            "num_channels": 3,
            "torch_dtype": ("float32" if dtype == torch.float32
                            else "bfloat16"),
        }, f, indent=1)
    return n


TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                   "special_tokens_map.json", "tokenizer.model",
                   "vocab.json", "merges.txt", "added_tokens.json")


def export_hf(out_dir: str, model: nn.Module, cfg,
              tokenizer_dir: Optional[str] = None) -> int:
    """Full-model export in the layout the reference's loader reads: the
    LLaMA backbone under HF names with an HF-style config.json (the
    reference's mm fields included) and its index, the projector and
    vision head under the reference's names, the tower in the file (under
    `model.vision_tower.vision_tower.vision_model.`) and as `vision_tower/`,
    the typed config as `metamorph_config.json`, and the tokenizer files
    when `tokenizer_dir` is given. Tensors keep their dtype (the tower dir
    is fp32). Returns the bytes of tensor data written."""
    os.makedirs(out_dir, exist_ok=True)
    tensors = hf_import.llama_params_to_hf(model.llama)
    tensors.update(hf_import.mlp_params_to_hf(model.projector,
                                              "model.mm_projector"))
    tensors.update(hf_import.mlp_params_to_hf(model.vision_head,
                                              "vision_head"))
    tensors.update(hf_import.siglip_params_to_hf(
        model.siglip, prefix="model.vision_tower.vision_tower.vision_model."))
    written = export_siglip_hf(os.path.join(out_dir, "vision_tower"),
                               model.siglip, cfg.siglip)
    written += save_file(tensors, os.path.join(out_dir, "model.safetensors"))
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({
            "metadata": {"total_size": sum(nbytes(v)
                                           for v in tensors.values())},
            "weight_map": {k: "model.safetensors" for k in tensors},
        }, f)

    hf_cfg = hf_import.llama_config_to_hf(cfg.llama)
    hf_cfg.update({
        # the reference persists these onto model.config so that a
        # checkpoint describes itself
        "mm_projector_type": cfg.mm.projector_type,
        "mm_vision_tower": "./vision_tower",
        "mm_use_im_start_end": cfg.mm.mm_use_im_start_end,
        "num_image_tokens": cfg.mm.num_image_tokens,
        "vision_head_type": cfg.mm.vision_head_type,
        "normalize_vision": cfg.mm.normalize_vision,
        "apply_softmax": cfg.mm.apply_softmax,
        "image_aspect_ratio": cfg.mm.image_aspect_ratio,
        "tokenizer_model_max_length": cfg.train.max_seq_len,
    })
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=1)
    with open(os.path.join(out_dir, "metamorph_config.json"), "w") as f:
        f.write(cfg.to_json())
    if tokenizer_dir:
        for name in TOKENIZER_FILES:
            src = os.path.join(tokenizer_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name))
    return written


# ---------------------------------------------------------------------------
# LoRA saves: the reference's LoRA-split final save
# ---------------------------------------------------------------------------

def save_lora(path: str, model: nn.Module) -> None:
    """Only the LoRA factors, as flat safetensors (`llama/layers/<sub>/
    <w>_lora_a` [L, D_in, r], ...); `model` as `save_adapter` takes it."""
    from metamorph_tpu_torch.inference.loader import flatten_tree
    from metamorph_tpu_torch.models.lora import split_lora_state

    lora = split_lora_state(model.llama)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_file(flatten_tree({"llama": lora}), path)


@torch.no_grad()
def load_lora(path: str, model: nn.Module) -> nn.Module:
    """A LoRA file's factors onto `model`'s layers, in place, in the file's
    dtype on the model's device."""
    from metamorph_tpu_torch.inference.loader import unflatten_tree

    flat = SafetensorsFile(path)
    lora = unflatten_tree({k: flat[k] for k in flat})["llama"]["layers"]
    layers = model.llama.layers
    device = model.llama.embed.device
    for tree in lora.values():
        for key, stacked in tree.items():
            if stacked.shape[0] != len(layers):
                raise ValueError(f"{key}: {stacked.shape[0]} layers in the "
                                 f"file, {len(layers)} in the model")
            for l, layer in enumerate(layers):
                setattr(layer, key, nn.Parameter(
                    stacked[l].to(device, copy=True)))
    return model


class PreemptionSaver:
    """Install a SIGTERM/SIGUSR1 handler that requests a synchronous save at
    the next step boundary."""

    def __init__(self):
        self.requested = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                signal.signal(sig, self._handler)
            except ValueError:
                pass  # not the main thread

    def _handler(self, signum, frame):
        self.requested.set()

    def should_save(self) -> bool:
        return self.requested.is_set()
