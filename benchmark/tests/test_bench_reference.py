"""The plain references against the port at a tiny size on the CPU, in
float32, with the decoder's width (64) unlike its heads' (4 x 32), as
Mistral-Nemo's 5,120 against 32 x 128."""

import pytest
import torch

from benchmark import traffic
from benchmark.reference import decoder as dec
from benchmark.reference import vision as vis
from benchmark.reference.train import RefTrainer, expand
from benchmark.tests.tiny import tiny_cell
from benchmark.weights import fill_model_, weights

SEED = 2 ** 35 + 17


@pytest.fixture(scope="module")
def port():
    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.models.metamorph import MetaMorph

    torch.manual_seed(0)
    cell = tiny_cell("ministral8b-sft")
    cfg = cell["config"]
    assert cfg["llama"]["hidden_size"] != (cfg["llama"]["num_heads"]
                                           * cfg["llama"]["head_dim"])
    mmcfg = MetaMorphConfig.from_dict(cfg)
    model = MetaMorph(mmcfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        fill_model_(model, cfg, SEED)
    W = weights(cfg, SEED, "cpu", torch.float32)
    return cell, cfg, mmcfg, model, W


def test_weights_reach_every_parameter_once(port):
    _, cfg, _, model, W = port
    named = dict(model.named_parameters())
    assert set(named) == set(W)
    for n, p in named.items():
        assert torch.equal(p, W[n]), n


def test_decoder_matches_the_port_at_d_unlike_heads(port):
    from metamorph_tpu_torch.models.llama import llama_forward

    _, cfg, mmcfg, model, W = port
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 37, cfg["llama"]["hidden_size"], generator=g)
    pos = torch.arange(37)[None]
    with torch.no_grad():
        ours = dec.final_hidden(W, cfg["llama"], [x[0]])[0]
        theirs = llama_forward(model.llama, mmcfg.llama, x, pos, None)[0]
    assert torch.allclose(ours, theirs, atol=2e-5, rtol=2e-5)


def test_vision_matches_the_port(port):
    from metamorph_tpu_torch.models.metamorph import (apply_vision_head,
                                                      encode_images)

    _, cfg, mmcfg, model, W = port
    g = torch.Generator().manual_seed(2)
    S = cfg["siglip"]["image_size"]
    px = torch.rand(2, S, S, 3, generator=g) * 2 - 1
    with torch.no_grad():
        projected, feats = encode_images(model, mmcfg, px)
        ref_feats = vis.image_features(W, cfg, px)
        ref_proj = vis.project(W, cfg, ref_feats)
        h = torch.randn(5, cfg["llama"]["hidden_size"], generator=g)
        head = apply_vision_head(model, mmcfg, h)
    assert torch.allclose(feats, ref_feats, atol=1e-5)
    assert torch.allclose(projected, ref_proj, atol=1e-5)
    assert torch.allclose(head, vis.vision_head(W, cfg, h), atol=1e-5)


def _samples(cfg, n, seed=SEED):
    mix = tiny_cell("ministral8b-sft")["traffic"]
    plan = traffic.train_plan(mix, 2)
    return [traffic.sample(row, seed, i, cfg["siglip"]["image_size"])
            for i, row in enumerate(plan[0][:n])]


def test_train_step_matches_the_port_in_float32(port):
    """One accumulated step of the port (float32 weights and moments)
    against the reference's, same samples: loss, leaf gradients and the
    updated weights."""
    from metamorph_tpu_torch.multimodal.packing import (batch_to_arrays,
                                                        pack_sequences)
    from metamorph_tpu_torch.train.optimizer import make_optimizer
    from metamorph_tpu_torch.train.train_step import (accum_train_step,
                                                       init_train_state)
    import numpy as np

    cell, cfg, mmcfg, model, _ = port
    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.models.metamorph import MetaMorph

    m = MetaMorph(mmcfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        fill_model_(m, cfg, SEED)
    smp = _samples(cfg, 4)
    T, K = cfg["train"]["max_seq_len"], cfg["mm"]["num_image_tokens"]
    N = cfg["train"]["max_images_per_batch"]
    arrays, pixels = [], []
    for s in smp:
        arrays.append(batch_to_arrays(pack_sequences(
            [s["input_ids"]], [s["labels"]], K, T, N)))
        px = np.zeros((N, 28, 28, 3), np.float32)
        if s["pixels"] is not None:
            px[0] = s["pixels"][0]
        pixels.append(px)
    batch = {k: torch.from_numpy(np.stack([a[k] for a in arrays]))
             for k in arrays[0]}
    state = init_train_state(m, mmcfg)
    tx = make_optimizer(mmcfg.train, m)
    for _ in range(2):      # step 1 has lr 0; step 2 moves the weights
        _, metrics = accum_train_step(state, batch,
                                      torch.from_numpy(np.stack(pixels)),
                                      mmcfg, tx)
    ref = RefTrainer(cfg, SEED, "cpu", dtype=torch.float32)
    ref.step(smp)
    out = ref.step(smp)
    assert out["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
    assert out["global_norm"] == pytest.approx(float(metrics["grad_norm"]),
                                               rel=1e-4)
    # an element whose gradient is near nought may take Adam's step of
    # about lr either way on either side; no element departs by more, and
    # each leaf's change agrees in norm
    lr = cfg["train"]["learning_rate"]
    from benchmark.reference.train import change_norms
    named = dict(m.named_parameters())
    ours = ref.change_norms(SEED)
    theirs = change_norms(cfg, SEED, named, "cpu", torch.float32)
    for n, c in ours.items():
        assert float((named[n] - ref.W[n]).abs().max()) <= 2.5 * lr, n
        assert theirs[n] == pytest.approx(c, rel=2e-3, abs=1e-9), n


def test_expand_marks_answer_images_and_shifts_targets():
    from benchmark.consts import IGNORE_INDEX, IM_END_ID, IM_START_ID

    s = dict(input_ids=[1, 7, IM_START_ID, -200, IM_END_ID],
             labels=[IGNORE_INDEX, IGNORE_INDEX, IM_START_ID, 0, IM_END_ID],
             pixels=None)
    row = expand(s, 2, 16)
    assert row["tokens"] == [1, 7, IM_START_ID, 0, 0, IM_END_ID]
    assert row["img"] == [-1, -1, -1, 0, 1, -1]
    assert row["labels"] == [IGNORE_INDEX, IM_START_ID, IGNORE_INDEX,
                             IGNORE_INDEX, IM_END_ID, IGNORE_INDEX]
    assert row["ar"] == [False, False, True, True, False, False]
    assert row["ar_img"] == [-1, -1, 0, 1, -1, -1]
