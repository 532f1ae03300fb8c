"""PyTorch port, `offload_optimizer` on the CPU: the AdamW moments kept off
the device and streamed chunk by chunk through staging buffers
(`train/optimizer._Offload`). The CPU runs the same streaming code as the
card, without streams; the card's cases (pinned memory, the copy stream,
peak memory, a failed pin) are in tests/test_torch_cuda.py.

The offloaded step must be bitwise the plain one: the same chunks go
through the same arithmetic. Against JAX the reference is its jitted
on-device `train_step`: JAX's own offload test (`tests/test_train.py`
`test_offload_optimizer_step`) skips on the CPU and holds the offloaded
step to the on-device one. Tolerances there are tests/test_torch_train.py's.
The refactored AdamW (one chunk update, `adamw_chunk_`, shared with the
plain AdamW) is held bitwise to the update it replaced, kept below."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu_torch.train import optimizer as opt_lib
from metamorph_tpu_torch.train import train_step as TS
from metamorph_tpu_torch.train.trainer import TrainerArgs, train
from tests.test_torch_train import (METRICS, FakeData, _assert_metrics,
                                    _assert_params_equal, _jax, _jax_steps,
                                    _port_model, _torch, jax_cfg, make_batch,
                                    port_cfg, trainer_cfg)
from tests.test_torch_train import jparams  # noqa: F401  (a fixture)


def _steps(model, cfg, batches, n):
    state = TS.init_train_state(model, cfg)
    tx = opt_lib.make_optimizer(cfg.train, model)
    out = []
    for i in range(n):
        state, m = TS.train_step(state, *batches[i % len(batches)], cfg, tx)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _assert_states_bitwise(a, b):
    for (n, p), (_, q) in zip(a["params"].named_parameters(),
                              b["params"].named_parameters()):
        assert torch.equal(p, q), n
    assert a["opt_state"]["count"] == b["opt_state"]["count"]
    for key in ("mu", "nu"):
        assert list(a["opt_state"][key]) == list(b["opt_state"][key])
        for n, t in a["opt_state"][key].items():
            assert torch.equal(t, b["opt_state"][key][n]), (key, n)


def test_offloaded_step_is_bitwise_the_plain_one_and_matches_jax(jparams):
    """Two steps (the first at lr 0) with the moments streamed: losses,
    parameters and moments bitwise those of the plain step, and the
    parameters at tests/test_torch_train.py's tolerance from JAX's jitted
    step."""
    arrays, pixels = make_batch()
    batches = [(_torch(arrays), torch.from_numpy(pixels))]
    jcfg = jax_cfg()
    plain_cfg = port_cfg(jcfg)
    off_cfg = port_cfg(jax_cfg(offload_optimizer=True))
    assert off_cfg.train.offload_optimizer and not \
        plain_cfg.train.offload_optimizer
    plain, pms = _steps(_port_model(jparams, plain_cfg), plain_cfg, batches,
                        2)
    off, oms = _steps(_port_model(jparams, off_cfg), off_cfg, batches, 2)
    assert pms == oms
    _assert_states_bitwise(plain, off)

    jstate, jms = _jax_steps(jparams, jcfg, [(_jax(arrays),
                                              jnp.asarray(pixels))], 2)
    for jm, tm in zip(jms, oms):
        _assert_metrics(jm, tm, METRICS + ("grad_norm",))
    _assert_params_equal(jstate["params"], off["params"])


def test_a_tensor_larger_than_a_chunk_streams_in_several(monkeypatch,
                                                         jparams):
    """CHUNK cut to 2**16 elements: the embedding and the head (8.2 M
    elements each) stream in 126 chunks each through the two staging
    slots, and the result stays bitwise that of the plain update at the
    same CHUNK (with the gradient clipped: max norm 0.05)."""
    chunk = 1 << 16
    monkeypatch.setattr(opt_lib, "CHUNK", chunk)
    calls = []
    run = opt_lib._Offload.run

    def counted(self, items, step):
        calls.append(len(items))
        return run(self, items, step)

    monkeypatch.setattr(opt_lib._Offload, "run", counted)
    arrays, pixels = make_batch(seed=4)
    batches = [(_torch(arrays), torch.from_numpy(pixels))]
    kw = dict(grad_clip_norm=0.05)
    plain_cfg = port_cfg(jax_cfg(**kw))
    off_cfg = port_cfg(jax_cfg(offload_optimizer=True, **kw))
    plain, pms = _steps(_port_model(jparams, plain_cfg), plain_cfg, batches,
                        3)
    model = _port_model(jparams, off_cfg)
    off, oms = _steps(model, off_cfg, batches, 3)
    assert pms == oms and pms[0]["grad_norm"] > 0.05
    _assert_states_bitwise(plain, off)
    n_params = len(off["opt_state"]["mu"])
    n_chunks = sum(-(-p.numel() // chunk) for n, p in model.named_parameters()
                   if n in off["opt_state"]["mu"])
    assert calls == [n_chunks] * 3 and n_chunks >= n_params + 2 * 125


class _OldAdamW(opt_lib.AdamW):
    """The update before `adamw_chunk_` was factored out, kept as the
    reference for the refactor."""

    @torch.no_grad()
    def update(self, model, state):
        cfg = self.cfg
        norm = self.global_norm(model)
        count = state["count"]
        b1, b2, eps, wd = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, \
            cfg.weight_decay
        bc1 = 1 - b1 ** (count + 1)
        bc2 = 1 - b2 ** (count + 1)
        max_norm = cfg.grad_clip_norm
        clip = norm >= max_norm
        for name, p in self.trainable(model):
            lr = self.schedules[self.labels[name]](count)
            mu, nu = state["mu"][name], state["nu"][name]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = p.grad.contiguous()
            for pc, mc, nc, gc in zip(opt_lib._chunks(p), opt_lib._chunks(mu),
                                      opt_lib._chunks(nu),
                                      opt_lib._chunks(g)):
                g32 = gc.float()
                g32 = torch.where(clip, g32 / norm * max_norm, g32)
                m32 = (1 - b1) * g32 + b1 * mc.float()
                v32 = (1 - b2) * g32 * g32 + b2 * nc.float()
                u = (m32 / bc1) / ((v32 / bc2).sqrt() + eps)
                p32 = pc.float()
                if wd:
                    u = u + wd * p32
                pc.copy_(p32 - lr * u)
                mc.copy_(m32)
                nc.copy_(v32)
        state["count"] = count + 1
        return norm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [1.0, 1e-3])
@pytest.mark.parametrize("offload", [False, True])
def test_refactored_adamw_is_bitwise_the_old_update(jparams, dtype, clip,
                                                    offload):
    """A fixed gradient set (seeded, one tower weight left without a
    gradient), 3 updates past the warmup (weight decay 0.1), with and
    without the clip, in fp32 and bf16, plain and offloaded."""
    cfg = port_cfg(jax_cfg(grad_clip_norm=clip, weight_decay=0.1,
                           warmup_ratio=0.05, offload_optimizer=offload))
    models = [_port_model(jparams, cfg).to(dtype) for _ in range(2)]
    g = torch.Generator().manual_seed(5)
    grads = {n: torch.randn(p.shape, generator=g).to(dtype)
             for n, p in models[0].named_parameters()}
    grads.pop("llama.final_norm")
    states = []
    for model, cls in zip(models, (opt_lib.AdamW, _OldAdamW)):
        tx = cls(cfg.train, model)
        state = tx.init(model)
        state["count"] = 4
        for _ in range(3):
            for n, p in model.named_parameters():
                p.grad = grads[n].clone() if n in grads else None
            tx.update(model, state)
        states.append({"params": model, "opt_state": state})
    _assert_states_bitwise(*states)


def test_train_accepts_offload_and_resumes_into_the_host_moments(
        tmp_path, monkeypatch):
    """train() with offload_optimizer: 3 steps straight against 2 steps,
    a save, and a resume to 3 — bitwise equal; the resumed moments are
    the template's host tensors, filled from the file."""
    cfg3 = trainer_cfg(3, offload_optimizer=True)
    straight = train(cfg3, TrainerArgs(output_dir=str(tmp_path / "a"),
                                       save_steps=0), FakeData(cfg3),
                     device="cpu")["state"]
    cfg2 = dataclasses.replace(cfg3, train=dataclasses.replace(
        cfg3.train, total_steps=2))
    args = TrainerArgs(output_dir=str(tmp_path / "b"), save_steps=2)
    train(cfg2, args, FakeData(cfg2), device="cpu")
    assert sorted(os.listdir(tmp_path / "b")) == ["metrics.jsonl", "step_2"]
    assert json.load(open(tmp_path / "b" / "step_2" / "config.json"))[
        "train"]["offload_optimizer"] is True

    seen = {}
    restore = opt_lib.AdamW.init

    def init(self, model):
        state = restore(self, model)
        seen.update({n: t.data_ptr() for n, t in state["mu"].items()})
        return state

    monkeypatch.setattr(opt_lib.AdamW, "init", init)
    resumed = train(cfg3, args, FakeData(cfg3), device="cpu")["state"]
    _assert_states_bitwise(straight, resumed)
    mu = resumed["opt_state"]["mu"]
    assert {n: t.data_ptr() for n, t in mu.items()} == seen
    assert all(t.device.type == "cpu" for t in mu.values())
    assert resumed["opt_state"]["count"] == 3


def test_offloaded_moments_are_views_of_one_host_buffer_per_dtype():
    params = [("a", torch.ones(3, 2)), ("b", torch.ones(5)),
              ("c", torch.ones(4, dtype=torch.bfloat16))]
    beside = opt_lib.zero_moments(params, False)
    off = opt_lib.zero_moments(params, True)
    for moments in (beside, off):
        assert list(moments) == ["a", "b", "c"]
        for n, p in params:
            m = moments[n]
            assert m.shape == p.shape and m.dtype == p.dtype
            assert m.device.type == "cpu" and not m.is_pinned()
            assert not m.any()
    assert off["a"].untyped_storage().data_ptr() == \
        off["b"].untyped_storage().data_ptr()
    assert beside["a"].untyped_storage().data_ptr() != \
        beside["b"].untyped_storage().data_ptr()
