"""PyTorch port, the eval path (`metamorph_tpu_torch/eval/`), on the CPU with
fp32 weights (tiny LLaMA + SigLIP, K=4), held to the JAX package:
`evaluate` within 1e-4 relative of JAX's `evaluate` on the same packed
batches (fp32 forwards whose sums run in another order); `score_answer`'s
rules (tests/test_eval_runner.py); `run_task` with accuracy 1.0 against
gold answers from the port's single-request `greedy_decode`, and the same
predictions as JAX's `run_task`; `runner.main --int8` on a checkpoint
written from seeded weights, with the tokenizer stubbed as
tests/test_torch_frontends.py stubs it, giving JAX's results."""

import json

import jax
import numpy as np
import pytest
import torch

from metamorph_tpu.constants import (IGNORE_INDEX, IM_END_TOKEN_ID,
                                     IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX,
                                     LLAMA3_EOS_IDS)
from metamorph_tpu.eval import perplexity as jperplexity
from metamorph_tpu.eval import runner as jrunner
from metamorph_tpu.multimodal.packing import \
    pack_sequences as jpack_sequences
from metamorph_tpu_torch.convert import from_jax_params
from metamorph_tpu_torch.eval import runner
from metamorph_tpu_torch.eval.perplexity import evaluate
from metamorph_tpu_torch.inference import decode
from metamorph_tpu_torch.models import llama as L
from metamorph_tpu_torch.multimodal.packing import pack_sequences
from tests.test_torch_frontends import (CFG, JCFG,  # noqa: F401
                                        files, fp32_and_fake_tokenizer,
                                        jax_params)

DROP = set(LLAMA3_EOS_IDS) | {IM_START_TOKEN_ID, IM_END_TOKEN_ID}
ENGINE = {"prefill_buckets": (16, 32, 64), "steps_per_sync": 2,
          "max_images": 2}


@pytest.fixture(scope="module")
def model(jax_params):
    return from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                           device="cpu")


def _batches(pack, n, T=24):
    """Packed rows with a prompt, an answer image (AR targets) and text."""
    K = CFG.mm.num_image_tokens
    for i in range(n):
        ids = [[128000, 2 + i, 77, IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX,
                128257, 7 + i, 8, 9]]
        labs = [[IGNORE_INDEX, IGNORE_INDEX, IGNORE_INDEX, IM_START_TOKEN_ID,
                 0, 128257, 7 + i, 8, 9]]
        pixels = np.random.default_rng(i).normal(
            size=(1, 28, 28, 3)).astype(np.float32)
        yield pack(ids, labs, K, T, 1), pixels


@pytest.mark.parametrize("max_batches", [0, 2])
def test_evaluate_matches_jax(jax_params, model, max_batches):
    ref = jperplexity.evaluate(jax_params, JCFG, _batches(jpack_sequences, 3),
                               max_batches=max_batches)
    got = evaluate(model, CFG, _batches(pack_sequences, 3),
                   max_batches=max_batches)
    assert sorted(got) == sorted(ref)
    assert got["n_batches"] == (max_batches or 3)
    assert got["n_image_ar_tokens"] == ref["n_image_ar_tokens"] > 0
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_score_answer_rules():
    golds10 = ["cat"] * 3 + ["dog"] * 7
    assert runner.score_answer("Cat!", golds10, "vqa") == 1.0
    assert runner.score_answer("dog", golds10, "vqa") == 1.0
    assert runner.score_answer("bird", golds10, "vqa") == 0.0
    assert runner.score_answer("cat", ["cat", "cat", "dog", "dog"],
                               "vqa") == pytest.approx(2 / 3)
    assert runner.score_answer("The cat", ["cat"], "vqa") == 1.0
    assert runner.score_answer("a cat.", ["cat"], "exact") == 1.0
    assert runner.score_answer("cats", ["cat"], "exact") == 0.0
    assert runner.score_answer("it is clearly a cat indeed", ["cat"],
                               "substring") == 1.0
    assert runner.score_answer("nothing here", ["cat"], "substring") == 0.0
    for s in ("An Apple, the pie!", "  a  b  ", "THE end."):
        assert runner.normalize_answer(s) == \
            jrunner.normalize_answer(s)


def tokenize(s):
    return [10 + (hash(w) % 400) for w in s.split()]


def detokenize(ids):
    return " ".join(str(t) for t in ids)


def _gold_rows(model, questions, frames_by_row, max_new):
    """Gold answers from the port's single-request greedy decode of the
    request `run_task` builds (the image tokens spliced the same way)."""
    rows = []
    for i, (q, frames) in enumerate(zip(questions, frames_by_row)):
        req = runner.build_request(model, CFG, tokenize, q, frames, max_new,
                                   i)
        with torch.no_grad():
            pe = L.embed_tokens(model.llama, torch.from_numpy(
                req.prompt_ids))
            for j, p in enumerate(req.image_positions if frames else []):
                pe[p:p + CFG.mm.num_image_tokens] = req.image_embeds[j]
        out = decode.greedy_decode(model, CFG, pe[None],
                                   max_new_tokens=max_new, max_images=2)
        ids = out["ids"][:int(out["n_ids"])].tolist()
        rows.append({"question": q, "answer": detokenize(
            [t for t in ids if t not in DROP])})
    return rows


@pytest.mark.parametrize("with_image", [False, True])
def test_run_task_matches_single_request_and_jax(jax_params, model,
                                                 with_image):
    frame = np.random.default_rng(0).integers(0, 255, (20, 24, 3)).astype(
        np.uint8)
    questions = ["what color is sky", "how many dogs are there",
                 "is this real"]
    frames = [[frame] if with_image else [] for _ in questions]
    rows = _gold_rows(model, questions, frames, max_new=6)
    load = (lambda row: [frame]) if with_image else None
    kw = dict(load_frames=load, metric="exact", n_slots=2, max_cache_len=64,
              max_new_tokens=6, engine_kwargs=ENGINE)
    res = runner.run_task(model, CFG, tokenize, detokenize, rows, **kw)
    assert res["n"] == 3 and res["new_tokens_per_sec"] > 0
    assert res["accuracy"] == 1.0, res["predictions"]
    ref = jrunner.run_task(jax_params, JCFG, tokenize, detokenize, rows,
                           **kw)
    assert [p["prediction"] for p in res["predictions"]] == \
        [p["prediction"] for p in ref["predictions"]]
    assert [p["n_image_tokens"] for p in res["predictions"]] == \
        [p["n_image_tokens"] for p in ref["predictions"]]


def test_runner_main_int8_matches_jax(files, fp32_and_fake_tokenizer,
                                      tmp_path):
    rows = [{"question": "what is it", "answer": "x", "image": "cat.png"},
            {"question": "hello there", "answer": ["y", "z"],
             "max_new_tokens": 4},
            {"question": "a longer question about the weather", "answer": "w",
             "uid": "third"}]
    task = tmp_path / "task.jsonl"
    task.write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--model-path", str(files / "model"), "--tokenizer", "fake",
              "--task", f"t={task}:substring", "--image-root", str(files),
              "--n-slots", "2", "--max-cache-len", "128",
              "--max-new-tokens", "6", "--int8", "--limit", "3"]
    jout, out = tmp_path / "jax.json", tmp_path / "port.json"
    assert jrunner.main(common + ["--out", str(jout)]) == 0
    assert runner.main(common + ["--out", str(out), "--device", "cpu"]) == 0
    ref, got = json.loads(jout.read_text()), json.loads(out.read_text())
    assert got["t"]["n"] == 3 and got["t"]["metric"] == "substring"
    assert got["t"]["predictions"] == ref["t"]["predictions"]
    assert got["t"]["accuracy"] == ref["t"]["accuracy"]
