"""Batch serving CLI (counterpart of `metamorph_tpu/inference/serve_cli.py`):
a JSONL of requests through the continuous-batching engine.

Each input row is {"prompt": str, "image": path|null, "max_new_tokens":
int?, "temperature": float?, "top_p": float?, "uid": any?}; the output is
one JSON line per completion, in submit order, with the decoded text, the
number of generated visual tokens and the step count.

    python -m metamorph_tpu_torch.inference.serve_cli --model-path CKPT \
        --tokenizer HF_TOKENIZER_DIR --requests reqs.jsonl \
        --out completions.jsonl [--n-slots 8] [--spec-k 4 [--draft-model
        DIR]] [--kv-int8] [--int8] [--device cuda]

The flags are the JAX CLI's, plus `--device` (default `cuda`). `main` loads
the checkpoint (with `--int8`, `ops/quant.quantize_llama_decode` makes its
decoder linears and lm head int8, run on kernel F), the tokenizer
(`transformers`, imported there) and the drafter (in the model's dtype);
the work is `run`, which takes the rows, a `tokenize(str) -> ids` and a
`decode(ids) -> str` callable and the BOS id.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List

import numpy as np
import torch

from metamorph_tpu_torch.constants import (IM_END_TOKEN_ID, IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX, LLAMA3_EOS_IDS)


@torch.no_grad()
def fuse_request(model, cfg, tokenize, bos_token_id, prompt_text: str,
                 frames: List[np.ndarray], bucket: int) -> dict:
    """One request's admission payload. Text-only prompts ship as token ids
    (the engine looks up their embeddings on the device); image prompts go
    through the host packer and the fusion (whose truncation and splice
    quirks match the reference) and ship fused embeddings [t0, D]."""
    from metamorph_tpu_torch.inference.decode import _fused_embeds
    from metamorph_tpu_torch.inference.demo import build_prompt
    from metamorph_tpu_torch.multimodal.mm_utils import (siglip_preprocess,
                                                         tokenizer_image_token)
    from metamorph_tpu_torch.multimodal.packing import (batch_to_arrays,
                                                        pack_sequences)

    prompt = build_prompt(prompt_text, len(frames))
    ids = tokenizer_image_token(prompt, tokenize, bos_token_id=bos_token_id)
    K = cfg.mm.num_image_tokens
    t0 = len(ids) + (K - 1) * sum(1 for i in ids if i == IMAGE_TOKEN_INDEX)
    if not frames:
        return {"prompt_ids": np.asarray(ids, np.int32)}
    packed = pack_sequences([ids], None, K, max(bucket, t0), len(frames))
    pixels = np.stack([siglip_preprocess(f, cfg.siglip.image_size)
                       for f in frames])
    embeds, _ = _fused_embeds(model, cfg, batch_to_arrays(packed), pixels)
    return {"prompt_embeds": embeds[0, :t0].float().cpu().numpy()}


def _load_draft(args, model):
    """(draft Llama, its config) from --draft-model, in the main model's
    dtype and on its device, or None."""
    if not getattr(args, "draft_model", None):
        return None
    if args.spec_k <= 1:
        raise SystemExit("--draft-model requires --spec-k >= 2")
    from metamorph_tpu_torch.models.hf_import import load_hf_llama

    return load_hf_llama(args.draft_model, model.llama.embed.dtype,
                         device=model.llama.embed.device)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--siglip", default=None, help="HF SigLIP weights dir")
    p.add_argument("--requests", required=True, help="JSONL of requests")
    p.add_argument("--out", required=True, help="completions JSONL")
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-cache-len", type=int, default=4096)
    p.add_argument("--max-new-tokens", type=int, default=256,
                   help="default per-request budget (rows may override)")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 decode (kernel F)")
    p.add_argument("--spec-k", type=int, default=0,
                   help=">1 enables speculative decoding for greedy rows "
                        "(prompt-lookup drafts, exact verification)")
    p.add_argument("--draft-model", default=None,
                   help="HF dir of a small shared-vocab LLaMA drafter "
                        "(with --spec-k > 1)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache (halves the cache's memory traffic)")
    p.add_argument("--fill-chunk", type=int, default=256,
                   help="chunked-prefill chunk size for long prompts "
                        "(0 disables; must divide --max-cache-len)")
    p.add_argument("--max-fills", type=int, default=2,
                   help="long-prompt admissions streaming concurrently "
                        "through the fused decode+chunk step")
    p.add_argument("--steps-per-sync", type=int, default=8,
                   help="decode steps per scheduler sync")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="default sampling temperature (0 = greedy; rows may "
                        "override with a 'temperature' field)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="default nucleus mass (rows may override)")
    p.add_argument("--seed", type=int, default=0,
                   help="engine sampling seed")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def run(model, cfg, rows: List[Dict], tokenize: Callable[[str], List[int]],
        decode: Callable[[List[int]], str], bos_token_id: int, args,
        draft=None, frames_of: Callable = None) -> List[Dict]:
    """Serve `rows` (the JSONL's dicts) on the model's device with the
    engine the CLI flags in `args` describe; returns one completion dict
    per row, in submit order. `frames_of(path)` loads a row's image
    (default `demo.load_frames`)."""
    from metamorph_tpu_torch.inference.demo import load_frames
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine

    frames_of = frames_of or load_frames
    eng = ServeEngine(model, cfg, n_slots=args.n_slots,
                      max_cache_len=args.max_cache_len,
                      max_new_tokens_cap=args.max_new_tokens,
                      fill_chunk=args.fill_chunk, max_fills=args.max_fills,
                      steps_per_sync=args.steps_per_sync, seed=args.seed,
                      kv_int8=args.kv_int8, spec_k=args.spec_k, draft=draft)
    submit_order = {}
    for i, row in enumerate(rows):
        frames = frames_of(row["image"]) if row.get("image") else []
        payload = fuse_request(model, cfg, tokenize, bos_token_id,
                               row["prompt"], frames,
                               bucket=eng.prefill_buckets[0])
        uid = row.get("uid", i)
        submit_order[uid] = i
        eng.submit(Request(**payload,
                           max_new_tokens=row.get("max_new_tokens",
                                                  args.max_new_tokens),
                           temperature=row.get("temperature",
                                               args.temperature),
                           top_p=row.get("top_p", args.top_p), uid=uid))
    done = eng.run()
    # drop pads and the ids the state machine treats specially; the
    # tokenizer's own special tokens go through its decode
    drop_ids = set(LLAMA3_EOS_IDS) | {IM_START_TOKEN_ID, IM_END_TOKEN_ID}
    out = []
    for c in sorted(done, key=lambda c: submit_order.get(c.uid, 0)):
        text_ids = [int(t) for t in c.ids if t >= 0 and int(t) not in drop_ids]
        out.append({"uid": c.uid, "text": decode(text_ids),
                    "n_image_tokens": int(c.image_embeds.shape[0]),
                    "steps": c.steps})
    return out


def load_model(args):
    """The checkpoint of `args.model_path` on `args.device`, its decoder
    linears and lm head made int8 with `--int8`. Returns (model, cfg)."""
    from metamorph_tpu_torch.convert import resolve_device
    from metamorph_tpu_torch.inference.loader import load_pretrained_model

    model, cfg = load_pretrained_model(args.model_path,
                                       hf_siglip_path=args.siglip,
                                       device=resolve_device(args.device))
    if args.int8:
        from metamorph_tpu_torch.ops.quant import quantize_llama_decode

        model.llama = quantize_llama_decode(model.llama, consume=True)
    return model, cfg


def main(argv=None):
    args = parse_args(argv)

    from metamorph_tpu_torch.inference.demo import load_hf_tokenizer

    model, cfg = load_model(args)
    tok = load_hf_tokenizer(args.tokenizer, "the serve CLI")
    rows = [json.loads(line) for line in open(args.requests) if line.strip()]
    done = run(model, cfg, rows, lambda s: tok(s).input_ids,
               lambda ids: tok.decode(ids, skip_special_tokens=True),
               tok.bos_token_id, args, draft=_load_draft(args, model))
    with open(args.out, "w") as f:
        for row in done:
            f.write(json.dumps(row) + "\n")
    print(f"served {len(done)} requests -> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
