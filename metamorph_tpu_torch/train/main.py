"""Training CLI (counterpart of `metamorph_tpu/train/main.py`): a config
JSON, a conversation JSONL and an HF tokenizer directory in, `train()` on
the card out.

    python -m metamorph_tpu_torch.train.main --config configs/stage2_finetune.json \
        --data-path data.jsonl --tokenizer <hf-tokenizer-dir> \
        --output-dir ./out [--device cuda]

The flags are the JAX CLI's, plus `--device` (default `cuda`; a run on the
CPU asks for `cpu`). `--hf-*` and `--pretrain-mm-mlp-adapter` go to
`train()`, which loads them. The tokenizer loads through `transformers`,
imported when `main` runs; `build` takes any `tokenize(str) -> list[int]`
callable, so a caller without `transformers` drives the same data path
through the API.

On several cards, one process per card:

    torchrun --nproc_per_node 8 -m metamorph_tpu_torch.train.main \
        --multihost --config configs/stage2_finetune.json ...

`--multihost` starts the process group from torchrun's environment, builds
the config's mesh and loads this rank's shard of every batch (its
data-parallel coordinate as process index and count, anyres included:
JAX's CLI loads anyres batches whole on every host, because its shards
would be re-based to one global table, while a rank of the port gathers
from its own views). A config that sets `sequence_parallel` splits each
row's positions over the fsdp axis, and attention is then the ring,
whatever `--attn-impl` says.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, List, Tuple

from metamorph_tpu_torch.constants import (DEFAULT_IM_END_TOKEN,
                                           DEFAULT_IM_START_TOKEN)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="MetaMorphConfig JSON file")
    p.add_argument("--data-path", required=True)
    p.add_argument("--tokenizer", required=True, help="HF tokenizer dir")
    p.add_argument("--output-dir", default="./out")
    p.add_argument("--hf-llama-path", default=None)
    p.add_argument("--hf-siglip-path", default=None)
    p.add_argument("--pretrain-mm-mlp-adapter", default=None)
    p.add_argument("--save-steps", type=int, default=500,
                   help="checkpoint interval; 0 writes no checkpoint")
    p.add_argument("--save-total-limit", type=int, default=1)
    p.add_argument("--logging-steps", type=int, default=1)
    p.add_argument("--image-aspect-ratio", default="square")
    p.add_argument("--group-by-modality-length", action="store_true")
    p.add_argument("--attn-impl", default="flash",
                   choices=["xla", "flash", "ring"],
                   help="JAX's flag, checked: the port runs flash "
                        "attention, and ring attention under sequence "
                        "parallelism, for each choice")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--use-wandb", action="store_true")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def load_tokenizer(path: str) -> Callable[[str], List[int]]:
    """An HF tokenizer directory -> tokenize(str) -> ids, with
    <image_start>/<image_end> added as special tokens (the reference's
    `initialize_vision_tokenizer`)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "the train CLI loads its tokenizer with transformers, which is "
            "not installed; install it, or call metamorph_tpu_torch.train."
            "main.build with your own tokenize callable") from e
    tok = AutoTokenizer.from_pretrained(path)
    tok.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
                   special_tokens=True)
    return lambda s: tok(s).input_ids


def build(args, cfg, tokenize: Callable[[str], List[int]],
          process_index: int = 0, process_count: int = 1) -> Tuple:
    """(data iterator, TrainerArgs) for `train()`: the dataset, collator and
    iterator the CLI flags and the config describe, over `tokenize`; the
    iterator yields shard `process_index` of `process_count` of each
    batch."""
    from metamorph_tpu_torch.train.data import (DataConfig, DataIterator,
                                                LazySupervisedDataset,
                                                PackedCollator)
    from metamorph_tpu_torch.train.trainer import TrainerArgs

    data_cfg = DataConfig(
        data_path=args.data_path,
        image_aspect_ratio=args.image_aspect_ratio,
        image_size=cfg.siglip.image_size,
        mm_use_im_start_end=cfg.mm.mm_use_im_start_end,
        model_max_length=cfg.train.max_seq_len,
        grid_pinpoints=cfg.mm.image_grid_pinpoints,
    )
    dataset = LazySupervisedDataset(args.data_path, tokenize, data_cfg,
                                    seed=cfg.train.seed)
    collator = PackedCollator(
        num_image_tokens=cfg.mm.num_image_tokens,
        max_seq_len=cfg.train.max_seq_len,
        num_image_slots=cfg.train.max_images_per_batch,
        image_size=cfg.siglip.image_size,
        image_aspect_ratio=args.image_aspect_ratio,
        grid_pinpoints=cfg.mm.image_grid_pinpoints,
        merge_type=cfg.mm.mm_patch_merge_type,
        patch_size=cfg.siglip.patch_size)
    data_iter = DataIterator(dataset, collator, cfg.train.batch_size,
                             seed=cfg.train.seed,
                             group_by_modality=args.group_by_modality_length,
                             accum_steps=cfg.train.grad_accum_steps,
                             process_index=process_index,
                             process_count=process_count)
    trainer_args = TrainerArgs(
        output_dir=args.output_dir,
        save_steps=args.save_steps,
        save_total_limit=args.save_total_limit,
        logging_steps=args.logging_steps,
        resume=not args.no_resume,
        pretrain_mm_mlp_adapter=args.pretrain_mm_mlp_adapter,
        hf_llama_path=args.hf_llama_path,
        hf_siglip_path=args.hf_siglip_path,
        use_wandb=args.use_wandb,
        attn_impl=args.attn_impl,
    )
    return data_iter, trainer_args


def main(argv=None):
    args = parse_args(argv)

    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.train.trainer import train

    with open(args.config) as f:
        cfg = MetaMorphConfig.from_json(f.read())
    p_idx, p_cnt = 0, 1
    device = args.device
    if args.multihost:
        # before the iterator: each rank loads its own shard
        from metamorph_tpu_torch.parallel import mesh as mesh_lib
        from metamorph_tpu_torch.train.trainer import rank_device

        device = rank_device(args.device)
        mesh_lib.init_distributed(device.type, device=device)
        p_idx, p_cnt = mesh_lib.dp_coordinate(
            mesh_lib.build_mesh(cfg.mesh, device.type),
            cfg.train.sequence_parallel)
    data_iter, trainer_args = build(args, cfg, load_tokenizer(args.tokenizer),
                                    p_idx, p_cnt)
    out = train(cfg, trainer_args, data_iter, multihost=args.multihost,
                device=device)
    print(json.dumps({"final_step": out["step"],
                      "metrics": {k: v for k, v in out["metrics"].items()
                                  if isinstance(v, (int, float))}}))
    return out


if __name__ == "__main__":
    main()
