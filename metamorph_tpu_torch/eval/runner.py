"""Task-level eval runner: benchmark JSONLs through the serving engine
(counterpart of `metamorph_tpu/eval/runner.py`).

Rows stream through `ServeEngine` (continuous batching, token-ids
admission, images projected by the tower and spliced on the device);
answers are decoded and scored with the standard task metrics, one JSON
per task.

Row schema (one JSON object per line):
    {"question": str,
     "answer": str | [str, ...],          # gold answer(s)
     "image": path | null,                # optional
     "max_new_tokens": int?, "uid": any?}

Metrics (pick per task with `metric=`):
  * "vqa":       VQA accuracy: with >= 4 annotator answers the VQAv2 rule
                 min(hits / 3, 1) per row, else normalized match;
  * "exact":     normalized exact match against any gold answer;
  * "substring": any normalized gold answer appears in the prediction.

    python -m metamorph_tpu_torch.eval.runner --model-path CKPT \
        --tokenizer TOK --task gqa=questions.jsonl \
        --task textvqa=tv.jsonl:substring --out results.json [--int8] \
        [--n-slots 8] [--spec-k 4 [--draft-model DIR]] [--device cuda]

The flags are the JAX runner's, plus `--device` (default `cuda`). `main`
loads the checkpoint and the tokenizer (`demo.load_hf_tokenizer`); the work
is `run_task`, which takes `tokenize(str) -> ids` and `detokenize(ids) ->
str` callables, so a caller without HF files drives the same path.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import string
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from metamorph_tpu_torch.constants import (IM_END_TOKEN_ID, IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX, LLAMA3_EOS_IDS)

METRICS = ("vqa", "exact", "substring")

_ARTICLES = re.compile(r"\b(a|an|the)\b")


def normalize_answer(s: str) -> str:
    """VQA-style normalization: lowercase, drop punctuation and articles,
    collapse whitespace (the JAX package's `eval/answer_parity.py`)."""
    s = s.lower()
    s = s.translate(str.maketrans("", "", string.punctuation))
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def score_answer(pred: str, golds: Sequence[str], metric: str) -> float:
    """Score one prediction against the row's gold answers, in [0, 1]."""
    p = normalize_answer(pred)
    gs = [normalize_answer(g) for g in golds]
    if metric == "vqa" and len(gs) >= 4:
        # VQAv2 accuracy: agreement with 3+ annotators = full credit
        return min(sum(g == p for g in gs) / 3.0, 1.0)
    if metric == "substring":
        return float(any(g and g in p for g in gs))
    return float(p in gs)            # "exact" / "vqa" with few golds


def _golds(row: Dict[str, Any]) -> List[str]:
    a = row.get("answer", row.get("answers", ""))
    return [str(x) for x in a] if isinstance(a, (list, tuple)) else [str(a)]


@torch.no_grad()
def build_request(model, cfg, tokenize: Callable[[str], List[int]],
                  question: str, frames: Sequence[np.ndarray],
                  max_new_tokens: int, uid: Any,
                  bos_token_id: Optional[int] = None):
    """One eval row -> a ServeEngine Request on the token-ids transport.
    Each image sentinel (-200) becomes K placeholder positions; the
    projected image tokens ride as `image_embeds` (on the model's device)
    and are spliced there."""
    from metamorph_tpu_torch.inference.demo import build_prompt
    from metamorph_tpu_torch.inference.serve import Request
    from metamorph_tpu_torch.models.metamorph import encode_images
    from metamorph_tpu_torch.multimodal.mm_utils import (siglip_preprocess,
                                                         tokenizer_image_token)

    prompt = build_prompt(question, len(frames))
    ids = tokenizer_image_token(prompt, tokenize, bos_token_id=bos_token_id)
    K = cfg.mm.num_image_tokens
    flat: List[int] = []
    positions: List[int] = []
    for t in ids:
        if t == IMAGE_TOKEN_INDEX:
            positions.append(len(flat))
            flat.extend([0] * K)     # placeholder ids under the splice
        else:
            flat.append(t)
    img_embeds = img_pos = None
    if frames:
        pixels = torch.as_tensor(np.stack([
            siglip_preprocess(f, cfg.siglip.image_size) for f in frames]),
            device=model.llama.embed.device)
        img_embeds, _ = encode_images(model, cfg, pixels)   # [n, K, D]
        img_pos = np.asarray(positions, np.int32)
    return Request(prompt_ids=np.asarray(flat, np.int32),
                   image_embeds=img_embeds, image_positions=img_pos,
                   max_new_tokens=max_new_tokens, uid=uid)


def run_task(model, cfg, tokenize, detokenize,
             rows: Sequence[Dict[str, Any]],
             load_frames: Optional[Callable[[Dict[str, Any]],
                                            List[np.ndarray]]] = None,
             metric: str = "vqa", n_slots: int = 8,
             max_cache_len: int = 2048, max_new_tokens: int = 64,
             bos_token_id: Optional[int] = None,
             engine_kwargs: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """Evaluate `rows` on the model's device and return {metric, accuracy,
    n, new_tokens_per_sec, predictions}; predictions come back in row
    order. `load_frames(row)` gives the row's image frames (default: no
    images)."""
    from metamorph_tpu_torch.inference.serve import ServeEngine

    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}")
    eng = ServeEngine(model, cfg, n_slots=n_slots,
                      max_cache_len=max_cache_len,
                      max_new_tokens_cap=max_new_tokens,
                      **(engine_kwargs or {}))
    for i, row in enumerate(rows):
        frames = load_frames(row) if load_frames else []
        eng.submit(build_request(
            model, cfg, tokenize, str(row["question"]), frames,
            int(row.get("max_new_tokens", max_new_tokens)), i,
            bos_token_id=bos_token_id))
    t0 = time.monotonic()
    done = eng.run()
    dt = time.monotonic() - t0
    drop = set(LLAMA3_EOS_IDS) | {IM_START_TOKEN_ID, IM_END_TOKEN_ID}
    preds: List[Dict[str, Any]] = [None] * len(rows)  # type: ignore
    total = 0.0
    new_tokens = 0
    for c in done:
        i = c.uid
        text_ids = [int(t) for t in c.ids if t >= 0 and int(t) not in drop]
        pred = detokenize(text_ids)
        s = score_answer(pred, _golds(rows[i]), metric)
        total += s
        new_tokens += int(c.steps)
        preds[i] = {"uid": rows[i].get("uid", i), "prediction": pred,
                    "score": s, "n_image_tokens": int(c.image_embeds.shape[0])}
    return {
        "metric": metric,
        "accuracy": total / max(len(rows), 1),
        "n": len(rows),
        "new_tokens_per_sec": round(new_tokens / max(dt, 1e-9), 1),
        "predictions": preds,
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--siglip", default=None)
    p.add_argument("--task", action="append", required=True,
                   help="name=rows.jsonl[:metric] (metric: vqa|exact|"
                        "substring; default vqa)")
    p.add_argument("--image-root", default=None,
                   help="prefix for relative image paths")
    p.add_argument("--out", required=True)
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-cache-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only the first N rows per task")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 decode (kernel F)")
    p.add_argument("--spec-k", type=int, default=0,
                   help=">1 enables speculative decoding in the engine "
                        "(exact for the greedy eval requests)")
    p.add_argument("--draft-model", default=None,
                   help="HF dir of a small shared-vocab LLaMA drafter "
                        "(with --spec-k > 1)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from metamorph_tpu_torch.inference.demo import (load_frames,
                                                    load_hf_tokenizer)
    from metamorph_tpu_torch.inference.serve_cli import _load_draft, load_model

    model, cfg = load_model(args)          # int8 weights with --int8
    draft = _load_draft(args, model)
    engine_kwargs = ({"spec_k": args.spec_k, "draft": draft} if args.spec_k
                     else None)
    tok = load_hf_tokenizer(args.tokenizer, "the eval runner")

    def frames_of(row):
        img = row.get("image")
        if not img:
            return []
        if args.image_root:
            img = os.path.join(args.image_root, img)
        return load_frames(img)

    results: Dict[str, Any] = {}
    for spec in args.task:
        name, _, rest = spec.partition("=")
        path, _, metric = rest.partition(":")
        metric = metric or "vqa"
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        if args.limit:
            rows = rows[:args.limit]
        res = run_task(
            model, cfg, lambda s: tok(s).input_ids, tok.decode, rows,
            load_frames=frames_of, metric=metric, n_slots=args.n_slots,
            max_cache_len=args.max_cache_len,
            max_new_tokens=args.max_new_tokens,
            bos_token_id=tok.bos_token_id, engine_kwargs=engine_kwargs)
        print(json.dumps({"task": name, "metric": metric,
                          "accuracy": res["accuracy"], "n": res["n"],
                          "new_tokens_per_sec": res["new_tokens_per_sec"]}))
        results[name] = res
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
