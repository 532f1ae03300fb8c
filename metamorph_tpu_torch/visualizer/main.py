"""Visualizer training CLI (counterpart of `metamorph_tpu/visualizer/main.py`).

    python -m metamorph_tpu_torch.visualizer.main --shards shards.json \\
        --siglip <hf-siglip-dir> [--sd <diffusers-sd15-dir>] \\
        --output-dir out/vis [--device cuda]

Frozen SigLIP-SO400M (HF weights) encodes each image to 64 L2-normalized
tokens; the adapter (and, with --unfreeze-unet, the UNet) trains on the
DDPM objective over a resampled stream of tar shards, corrupt images
skipped. Without --sd the UNet and VAE are random from the seed and the
UNet counts as trained from scratch (warmup-then-constant LR). Every 10
steps the loss and it/s go to stderr and `metrics.jsonl`; the visualizer
directory (`save_visualizer`, which `load_visualization` and the demo
read) is written every --save-steps steps and at the end.

Under torchrun (`torchrun --nproc_per_node N -m
metamorph_tpu_torch.visualizer.main ...`, WORLD_SIZE > 1) the step is
data-parallel over the ranks, one card each: --batch-size is the global
batch, each rank reads its own run of the sorted shards
(`iter_tar_shards(paths, rank, world)`) and takes batch-size / world rows
of every step; rank 0 alone logs and saves.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--shards", required=True,
                   help="JSON list of tar shard paths, or a glob pattern")
    p.add_argument("--siglip", required=True, help="HF SigLIP weights dir")
    p.add_argument("--sd", default=None,
                   help="diffusers SD-1.5 dir (model.safetensors per "
                        "submodel); omit for a from-scratch UNet")
    p.add_argument("--output-dir", default="./out/visualizer")
    p.add_argument("--adapter-mode", default="mlp",
                   choices=["mlp", "xattn", "xattnffn", "transformer"])
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--cfg-prob", type=float, default=0.1)
    p.add_argument("--noise-offset", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--unet-lr", type=float, default=1e-5)
    p.add_argument("--unfreeze-unet", action="store_true")
    p.add_argument("--total-steps", type=int, default=16000)
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--num-tokens", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from metamorph_tpu_torch.config import MultimodalConfig, SiglipConfig
    from metamorph_tpu_torch.convert import resolve_device
    from metamorph_tpu_torch.inference.loader import save_visualizer
    from metamorph_tpu_torch.models.hf_import import siglip_params_from_hf
    from metamorph_tpu_torch.models.siglip import Siglip, vision_tower_forward
    from metamorph_tpu_torch.utils.logging import MetricsLogger, rank0_print
    from metamorph_tpu_torch.utils.safetensors_io import load_safetensors_dir
    from metamorph_tpu_torch.visualizer.train import (
        VisualizerTrainConfig, decode_and_preprocess, iter_tar_shards,
        make_visualizer_train_step)
    from metamorph_tpu_torch.visualizer.unet import UNetConfig
    from metamorph_tpu_torch.visualizer.vae import VAEConfig

    device = resolve_device(args.device)
    rank, world, mesh = 0, 1, None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from metamorph_tpu_torch.parallel import mesh as mesh_lib
        from metamorph_tpu_torch.train.trainer import rank_device
        from torch.distributed.device_mesh import DeviceMesh

        device = rank_device(args.device)
        mesh_lib.init_distributed(device.type, device=device)
        rank = torch.distributed.get_rank()
        world = torch.distributed.get_world_size()
        mesh = DeviceMesh(device.type, torch.arange(world),
                          mesh_dim_names=("data",))
        if args.batch_size % world:
            raise ValueError(f"--batch-size {args.batch_size} does not "
                             f"split over {world} ranks")
    local_batch = args.batch_size // world
    if device.type == "cuda":
        # fp32 means fp32: no TF32 in the convolutions and GEMMs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.shards.endswith(".json"):
        with open(args.shards) as f:
            shards = json.load(f)
    else:
        shards = sorted(glob.glob(args.shards))
    if not shards:
        raise SystemExit("no shards found")

    sig_cfg = SiglipConfig()
    mm = MultimodalConfig(num_image_tokens=args.num_tokens,
                          normalize_vision=True)
    siglip = siglip_params_from_hf(
        load_safetensors_dir(args.siglip),
        Siglip(sig_cfg, dtype=torch.float32, device=device))
    siglip.requires_grad_(False)

    tc = VisualizerTrainConfig(
        adapter_mode=args.adapter_mode, num_tokens=args.num_tokens,
        cfg_prob=args.cfg_prob, noise_offset=args.noise_offset,
        learning_rate=args.lr, unet_lr=args.unet_lr,
        unfreeze_unet=args.unfreeze_unet,
        unet_from_scratch=args.sd is None, batch_size=args.batch_size,
        resolution=args.resolution, total_steps=args.total_steps)
    unet_cfg, vae_cfg = UNetConfig(), VAEConfig()

    step_fn, init_state = make_visualizer_train_step(tc, unet_cfg, vae_cfg,
                                                     mesh=mesh)
    state = init_state(tc.seed, device=device, dtype=torch.float32)
    if args.sd:
        from metamorph_tpu_torch.visualizer.hf_import import (
            unet_params_from_hf, vae_params_from_hf)

        state["unet"] = unet_params_from_hf(
            load_safetensors_dir(os.path.join(args.sd, "unet")), unet_cfg,
            device, torch.float32)
        state["vae"] = vae_params_from_hf(
            load_safetensors_dir(os.path.join(args.sd, "vae")), vae_cfg,
            device, torch.float32)

    os.makedirs(args.output_dir, exist_ok=True)
    metrics = MetricsLogger(os.path.join(args.output_dir, "metrics.jsonl")
                            if rank == 0 else None)

    def batches():
        sig_buf, vae_buf = [], []
        while True:  # resampled shards
            for raw in iter_tar_shards(shards, rank, world):
                try:
                    sig, vimg = decode_and_preprocess(
                        raw, sig_cfg.image_size, args.resolution)
                except (OSError, ValueError):
                    continue  # a corrupt image (PIL raises OSError) is skipped
                sig_buf.append(sig)
                vae_buf.append(vimg)
                if len(sig_buf) == local_batch:
                    yield np.stack(sig_buf), np.stack(vae_buf)
                    sig_buf, vae_buf = [], []

    step = 0
    t_last = time.time()
    try:
        for sig_px, vae_px in batches():
            with torch.no_grad():
                embeds = vision_tower_forward(
                    siglip, sig_cfg, mm, torch.from_numpy(sig_px).to(device))
            gen = torch.Generator(device=device)
            gen.manual_seed(step)
            state, loss = step_fn(state, embeds,
                                  torch.from_numpy(vae_px).to(device), gen)
            step += 1
            if step % 10 == 0:
                it_s = 10 / (time.time() - t_last)
                rank0_print(f"vis step {step}: loss={float(loss):.4f} "
                            f"({it_s:.2f} it/s)")
                metrics.log(step, {"loss": float(loss), "it_per_s": it_s})
                t_last = time.time()
            if rank == 0 and (step % args.save_steps == 0
                              or step >= args.total_steps):
                save_visualizer(args.output_dir, state["adapter"],
                                state["unet"], state["vae"], unet_cfg,
                                vae_cfg, args.adapter_mode)
            if step >= args.total_steps:
                break
    finally:
        metrics.close()


if __name__ == "__main__":
    main()
