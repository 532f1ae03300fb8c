"""Demo CLI (counterpart of `metamorph_tpu/inference/demo.py`): load an
image (or 1-FPS video frames), build the LLaMA-3 prompt with
<image_start><image><image_end>, decode, print the text.

    python -m metamorph_tpu_torch.inference.demo --model-path CKPT \
        --tokenizer HF_TOKENIZER_DIR --image cat.jpg \
        --prompt "What is in this image?" [--spec-k 4 [--draft-model DIR]] \
        [--device cuda] \
        [--visualizer VIS_DIR [--render-scheduler pndm|ddim|dpmpp]
         [--render-steps 50] [--out-dir ./demo_out]]

The flags are the JAX CLI's, plus `--device` (default `cuda`; a run on the
CPU asks for `cpu`). `main` loads the checkpoint
(`loader.load_pretrained_model`), the tokenizer (`transformers`, imported
there) and the drafter (`hf_import.load_hf_llama`, in the model's dtype);
the work is `run`, which takes a `tokenize(str) -> ids` and a
`decode(ids) -> str` callable and the BOS id, so a caller without HF files
drives the same pipeline. With `--visualizer`, every 64-token chunk of
generated visual embeddings is rendered by `render_chunks` (the
visualizer from `loader.load_visualization`, in fp32) at four guidance
scales into `OUT_DIR/gen_{chunk}_scale{i}.png`.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from metamorph_tpu_torch.constants import (DEFAULT_IM_END_TOKEN,
                                           DEFAULT_IM_START_TOKEN,
                                           DEFAULT_IMAGE_TOKEN)


def load_frames(path: str, max_frames: int = 8) -> List[np.ndarray]:
    """Image file -> [1 frame]; video -> 1-FPS samples (`demo.py:29-43`)."""
    from metamorph_tpu_torch.train.data import VIDEO_EXTS, decode_video_frames

    if any(path.endswith(e) for e in VIDEO_EXTS):
        frames, _ = decode_video_frames(path, cutoff=max_frames, interval_t=1)
        return frames
    from PIL import Image

    return [np.asarray(Image.open(path).convert("RGB"))]


def build_prompt(question: str, n_images: int) -> str:
    from metamorph_tpu_torch.multimodal.conversation import conv_llama_3

    conv = conv_llama_3.copy()
    tags = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
            + DEFAULT_IM_END_TOKEN) * n_images
    conv.append_message(conv.roles[0], tags + "\n" + question)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def load_hf_tokenizer(path: str, who: str):
    """An HF tokenizer directory -> the tokenizer, with <image_start> and
    <image_end> added as special tokens. `who` names the caller in the
    error raised when `transformers` is missing."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"{who} loads its tokenizer with transformers, which is not "
            f"installed; install it, or call the module's work function "
            f"with your own tokenize/decode callables") from e
    tok = AutoTokenizer.from_pretrained(path)
    tok.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
                   special_tokens=True)
    return tok


def prepare_inputs(cfg, ids: List[int], frames: List[np.ndarray],
                   image_aspect_ratio: str = "square"):
    """(batch arrays, pixels [N, S, S, 3]) for `decode.generate`: the
    sentinel-bearing prompt ids packed with the frames' image tokens, the
    frames preprocessed as square crops, padded squares or anyres views."""
    from metamorph_tpu_torch.multimodal.mm_utils import (SIGLIP_MEAN,
                                                         expand2square,
                                                         siglip_preprocess)
    from metamorph_tpu_torch.multimodal.packing import (batch_to_arrays,
                                                        pack_sequences)

    K = cfg.mm.num_image_tokens
    if image_aspect_ratio == "anyres":
        from metamorph_tpu_torch.multimodal.anyres import (build_batch_plan,
                                                           preprocess_anyres)

        S = cfg.siglip.image_size
        P = S // cfg.siglip.patch_size
        pins = list(cfg.mm.image_grid_pinpoints)
        views, sizes = zip(*[preprocess_anyres(f, pins, S) for f in frames])
        pixels = np.concatenate(views, axis=0)
        view_map, tokens_per_image = build_batch_plan(
            list(sizes), [v.shape[0] for v in views], pins, S, P,
            cfg.mm.mm_patch_merge_type,
            capacity=pixels.shape[0] * (P * P + P))
        packed = pack_sequences([ids], None, K,
                                len(ids) + sum(tokens_per_image),
                                len(frames),
                                tokens_per_image=tokens_per_image,
                                gather_capacity=view_map.shape[0])
        packed = dataclasses.replace(packed, view_map=view_map)
    else:
        if image_aspect_ratio == "pad":
            bg = tuple(int(x * 255) for x in SIGLIP_MEAN)
            frames = [expand2square(f, bg) for f in frames]
        pixels = np.stack([siglip_preprocess(f, cfg.siglip.image_size)
                           for f in frames])
        packed = pack_sequences([ids], None, K, len(ids) + len(frames) * K,
                                len(frames))
    return batch_to_arrays(packed), pixels


def run(model, cfg, tokenize: Callable[[str], List[int]],
        decode: Callable[[List[int]], str], bos_token_id: int,
        frames: List[np.ndarray], question: str,
        image_aspect_ratio: str = "square", max_new_tokens: int = 256,
        spec_k: int = 1, draft: Optional[tuple] = None) -> Dict:
    """The demo's work on the model's device: prompt, pack, `generate`,
    text. Returns {"text", "ids" (generated), "n_image_tokens",
    "image_embeds" [n, Dv]}."""
    from metamorph_tpu_torch.inference.decode import generate
    from metamorph_tpu_torch.multimodal.mm_utils import tokenizer_image_token

    prompt = build_prompt(question, len(frames))
    ids = tokenizer_image_token(prompt, tokenize, bos_token_id=bos_token_id)
    batch, pixels = prepare_inputs(cfg, ids, frames, image_aspect_ratio)
    out = generate(model, cfg, batch, pixels, max_new_tokens=max_new_tokens,
                   spec_k=spec_k, draft=draft)
    n, k = int(out["n_ids"]), int(out["n_image_tokens"])
    gen_ids = [int(x) for x in out["ids"][:n].tolist()]
    return {"text": decode([i for i in gen_ids if i < 128000]),
            "ids": gen_ids, "n_image_tokens": k,
            "image_embeds": out["image_embeds"][:k].float().cpu().numpy()}


GUIDANCE_SCALES = (6.0, 7.5, 10.0, 12.5)


def render_chunks(embeds, vis, out_dir: str, scheduler: str = "pndm",
                  steps: int = 50, K: int = 64, latent_size: int = 64
                  ) -> List:
    """Render each K-token chunk c of generated visual embeddings
    (`embeds` [n, Dv], numpy or a tensor) through `vis` (what
    `loader.load_visualization` returns) at GUIDANCE_SCALES, with noise
    seeded by c, and write `out_dir/gen_{c}_scale{gi}.png`. Returns the
    images, one [n_scales, H, W, 3] fp32 array in [0, 1] per chunk."""
    import os

    import torch
    from PIL import Image

    from metamorph_tpu_torch.visualizer.pipeline import render_multi_scale

    adapter, unet, vae, unet_cfg, vae_cfg, mode = vis
    embeds = torch.as_tensor(np.asarray(embeds, np.float32))
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for c in range(embeds.shape[0] // K):
        gen = torch.Generator()
        gen.manual_seed(c)
        imgs = render_multi_scale(adapter, unet, vae, unet_cfg, vae_cfg,
                                  embeds[None, c * K:(c + 1) * K], gen,
                                  guidance_scales=GUIDANCE_SCALES,
                                  adapter_mode=mode, scheduler=scheduler,
                                  num_inference_steps=steps,
                                  latent_size=latent_size)[0]
        imgs = imgs.cpu().numpy()
        for gi, img in enumerate(imgs):
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(out_dir, f"gen_{c}_scale{gi}.png"))
        out.append(imgs)
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--tokenizer", required=True,
                        help="HF tokenizer dir for LLaMA-3")
    parser.add_argument("--siglip", default=None, help="HF SigLIP weights dir")
    parser.add_argument("--visualizer", default=None,
                        help="visualizer checkpoint dir: render the "
                             "generated visual tokens to PNGs")
    parser.add_argument("--image", required=True)
    parser.add_argument("--image-aspect-ratio", default="square",
                        choices=["square", "pad", "anyres"])
    parser.add_argument("--prompt", default="What is in this image?")
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--spec-k", type=int, default=1,
                        help=">1 enables speculative decoding (prompt-lookup "
                             "drafts, exact verification; same output)")
    parser.add_argument("--draft-model", default=None,
                        help="HF dir of a small shared-vocab LLaMA: with "
                             "--spec-k > 1, drafts come from this model "
                             "instead of prompt-lookup (same output)")
    parser.add_argument("--render-scheduler", default="pndm",
                        choices=["pndm", "ddim", "dpmpp"],
                        help="dpmpp reaches pndm@50 quality at ~20 steps")
    parser.add_argument("--render-steps", type=int, default=50)
    parser.add_argument("--out-dir", default="./demo_out")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    return parser.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if args.draft_model and args.spec_k <= 1:
        raise SystemExit("--draft-model requires --spec-k >= 2")

    from metamorph_tpu_torch.convert import resolve_device
    from metamorph_tpu_torch.inference.loader import load_pretrained_model

    device = resolve_device(args.device)
    model, cfg = load_pretrained_model(args.model_path,
                                       hf_siglip_path=args.siglip,
                                       device=device)
    tok = load_hf_tokenizer(args.tokenizer, "the demo")
    draft = None
    if args.draft_model:
        from metamorph_tpu_torch.models.hf_import import load_hf_llama

        draft = load_hf_llama(args.draft_model, model.llama.embed.dtype,
                              device=device)
    res = run(model, cfg, lambda s: tok(s).input_ids,
              lambda ids: tok.decode(ids, skip_special_tokens=True),
              tok.bos_token_id, load_frames(args.image), args.prompt,
              args.image_aspect_ratio, args.max_new_tokens, args.spec_k,
              draft)
    print(res["text"])
    K = cfg.mm.num_image_tokens
    if res["n_image_tokens"] and args.visualizer:
        from metamorph_tpu_torch.inference.loader import load_visualization

        vis = load_visualization(args.visualizer, device=device)
        render_chunks(res["image_embeds"], vis, args.out_dir,
                      args.render_scheduler, args.render_steps, K)
        print(f"rendered {res['n_image_tokens'] // K} image(s) to "
              f"{args.out_dir}")
    return res


if __name__ == "__main__":
    main()
