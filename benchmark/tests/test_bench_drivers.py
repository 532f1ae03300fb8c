"""Each driver end to end at a tiny size on the CPU (the port's plain
paths), judged as a run judges it, under the tiny size's limits
(`tiny.TINY_LIMITS`): a sound run is correct; a run with the timed path
broken underneath is not (a token altered where it is made; decode steps
that leave the cache unwritten; a train step that leaves its state
unchanged; half of each batch left out; the cells run on one card, so no
exchange between cards can be left out); and the control, the reference
one precision lower in the program's place, reads above a limit."""

import pytest
import torch

from benchmark.run import compare, run_cell
from benchmark.tests.tiny import tiny_ctx

INFO = dict(platform="cpu", kind="cpu", count=1)


def _line(workload, **kw):
    ctx, cell = tiny_ctx(workload, **kw)
    return run_cell(ctx, cell, INFO), ctx, cell


def _keys_ok(line):
    assert list(line)[-1] == "compared"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line


@pytest.mark.parametrize("workload", ["nemo12b-chat", "ministral8b-sft"])
def test_sound_run_is_correct(workload):
    line, _, cell = _line(workload)
    _keys_ok(line)
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in cell["end_to_end"]}
    assert set(line["metrics"]) == names
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["correct"], line["compared"]


def test_altered_token_is_caught(monkeypatch):
    """Every served token one id off the model's choice."""
    from metamorph_tpu_torch.inference import serve

    real = serve.llama_lib.lm_head

    def shifted(model, cfg, hidden):
        return torch.roll(real(model, cfg, hidden), 1, dims=-1)

    monkeypatch.setattr(serve.llama_lib, "lm_head", shifted)
    line, _, _ = _line("nemo12b-chat")
    assert not line["correct"], line["compared"]


def test_unwritten_cache_is_caught(monkeypatch):
    """Decode steps that leave the KV cache as it was (the serving state
    unchanged)."""
    from metamorph_tpu_torch.models import llama

    real = llama.decode_step

    def no_write(model, cfg, x, pos, cache, cache_idx):
        put = llama._put
        llama._put = lambda *a, **k: None
        try:
            return real(model, cfg, x, pos, cache, cache_idx)
        finally:
            llama._put = put

    monkeypatch.setattr(llama, "decode_step", no_write)
    line, _, _ = _line("nemo12b-chat")
    assert not line["correct"], line["compared"]


def test_unchanged_state_is_caught(monkeypatch):
    """A step that computes its gradients and leaves the weights and
    moments as they were."""
    from metamorph_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.AdamW, "update",
                        lambda self, model, state: self.global_norm(model))
    line, _, _ = _line("ministral8b-sft")
    assert not line["correct"], line["compared"]


def test_half_batch_is_caught(monkeypatch):
    """The step runs half of its microbatches and averages over them."""
    from metamorph_tpu_torch.train import train_step

    real = train_step.accum_train_step

    def half(state, batches, pixels, cfg, tx, shard=None):
        n = pixels.shape[0] // 2
        return real(state, {k: v[:n] for k, v in batches.items()},
                    pixels[:n], cfg, tx, shard)

    monkeypatch.setattr(train_step, "accum_train_step", half)
    line, _, _ = _line("ministral8b-sft")
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 5, 7])
def test_check_sample_always_holds_an_image_request(seed):
    """The sample judged holds the longest request and, where one
    finished, an image request, whatever the seed draws."""
    from types import SimpleNamespace

    from benchmark.drivers.serve_open_loop import pick_checked

    done = {i: SimpleNamespace(ids=[0] * (10 + i)) for i in range(40)}
    picks = pick_checked(list(done), done, seed, 8, images={3})
    assert len(picks) == len(set(picks)) == 8
    assert picks[:2] == [39, 3]
    assert pick_checked(list(done), done, seed, 8, images={39, 3})[0] == 39
    assert len(pick_checked(list(done), done, seed, 2, images={39, 3})) == 2
    assert pick_checked([5], done, seed, 8, images={5}) == [5]


@pytest.mark.parametrize("workload", ["nemo12b-chat", "ministral8b-sft"])
def test_control_reads_above_a_limit(workload):
    ctx, cell = tiny_ctx(workload)
    from benchmark import spec as spec_lib

    res = spec_lib.driver(cell["traffic"]["driver"]).run(ctx)
    r = res["judge"](("fp32", "fp8"))
    control = {k.replace("control_fp8_", "").replace("control_gap_max_fp8",
                                                     "logit_gap_max"): v
               for k, v in r.items() if k.startswith("control")}
    compared = compare(control, cell["limits"])
    assert any(c["value"] > c["limit"] for c in compared.values()), compared
