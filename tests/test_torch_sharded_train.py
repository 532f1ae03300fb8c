"""PyTorch port, multi-GPU training on the CPU (gloo ranks, spawned as in
tests/test_torch_parallel.py), held to the JAX package:

  * the sharded step (`make_sharded_train_step`) over 4 ranks on
    (data 2, fsdp 2), (fsdp 2, tensor 2), (fsdp 4) with the sequence split
    and ring attention (also under remat), and (data 2, fsdp 2) with the
    sequence split;
    with activation checkpointing; with grad_accum_steps = 2; with the
    moments offloaded: two steps of each against JAX's one-device jitted
    step (or accumulating step) on the same global batch;
  * `train()` over 2 ranks with a save and a resume, against an unbroken
    run; rank 0 alone writes the checkpoint, which the one-device restore
    reads; the adapter file of a stage-1 run over fsdp 2 and the LoRA file
    of a run over tensor 2, gathered by both ranks, against the
    one-device saves;
  * the visualizer's data-parallel step over 2 ranks against JAX's step
    over a 2-device mesh, JAX's global draws in the port's `loss_draws`
    seam; the tar shards split by rank as JAX splits them.

The global batch has rows of uneven valid length, answer images in two of
its four rows and no image in the others, so the ranks hold different
numbers of text and AR tokens: a mean of per-rank means would differ from
the global normalizers.

Tolerances: losses and metrics 1e-5 relative (2e-4 with the sequence
split, as JAX's tests/test_train.py holds its own sequence-parallel
step), parameters after two steps JAX's 5e-3 (Adam's first update is near
lr * sign(g), which a low-bit difference of a near-zero gradient flips);
every gradient of the first step, gathered, within 1e-5 of its tensor's
max |g| of the port's one-device step (the tight check that Adam's sign
hides); the offloaded moments bitwise the on-device run. The visualizer:
the loss 1e-5 relative and the trees 2 * lr * steps + 1e-6, those of
tests/test_torch_visualizer_train.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metamorph_tpu_torch.config import (LlamaConfig, MeshConfig,
                                        MetaMorphConfig, MultimodalConfig,
                                        SiglipConfig, TrainConfig)
from metamorph_tpu_torch.constants import (IGNORE_INDEX, IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX)
from tests.test_torch_parallel import spawn_ranks

K, B, T, N = 4, 4, 24, 4
METRICS = ("loss", "loss_language", "loss_image_ar", "n_text_tokens",
           "n_image_ar_tokens")
# name -> (mesh, sequence_parallel, TrainConfig changes); with the
# sequence split the decoder's attention is the ring, whatever attention
# the trainer was asked for
CASES = {
    "dp2_fsdp2": ((2, 2, 1), False, {}),
    "fsdp2_tp2": ((1, 2, 2), False, {}),
    "fsdp4_sp_ring": ((1, 4, 1), True, {}),
    "dp2_fsdp2_sp_ring": ((2, 2, 1), True, {}),
    # configs/longctx_sp.json's form: the sequence split under remat, whose
    # recompute runs the ring's exchange again
    "fsdp4_sp_ring_remat": ((1, 4, 1), True, dict(remat=True)),
    "dp2_fsdp2_remat": ((2, 2, 1), False,
                        dict(remat=True, remat_policy="dots_no_batch")),
    "fsdp2_tp2_remat_save_attn": ((1, 2, 2), False,
                                  dict(remat=True,
                                       remat_policy="save_attn_only")),
    "dp2_fsdp2_accum2": ((2, 2, 1), False, dict(grad_accum_steps=2)),
    "dp2_fsdp2_offload": ((2, 2, 1), False, dict(offload_optimizer=True)),
}
# held to the port's one-device step only: LoRA factors (B seeded nonzero)
# trained under tensor parallelism, where the factor a product keeps whole
# gets its gradient all-reduced over the tensor group
LORA_CASE = ("fsdp2_tp2_lora", (1, 2, 2))
LORA_R = 4


def port_cfg(**train_kw) -> MetaMorphConfig:
    train_kw = {"total_steps": 20, "remat": False, **train_kw}
    return MetaMorphConfig(
        llama=LlamaConfig.tiny(vocab_size=128258),
        siglip=SiglipConfig.tiny(), mm=MultimodalConfig(num_image_tokens=K),
        train=TrainConfig(max_seq_len=T, batch_size=B,
                          max_images_per_batch=N, learning_rate=1e-3,
                          **train_kw))


def case_cfg(name: str) -> MetaMorphConfig:
    mesh, sp, kw = CASES[name]
    cfg = port_cfg(sequence_parallel=sp, **kw)
    return dataclasses.replace(cfg, mesh=MeshConfig(*mesh))


def lora_cfg(mesh=(1, 1, 1)) -> MetaMorphConfig:
    cfg = port_cfg(lora_enable=True)
    return dataclasses.replace(
        cfg, mesh=MeshConfig(*mesh), llama=dataclasses.replace(
            cfg.llama, lora_r=LORA_R, lora_alpha=8.0))


def lora_model(cfg):
    """The seed-1 model with LoRA factors on every target, B seeded
    N(0, 0.1^2) from numpy so that both factors get a gradient."""
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.models.lora import add_lora

    model = init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    add_lora(model.llama, r=LORA_R, seed=0)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("_lora_b"):
                p.copy_(torch.from_numpy(
                    0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    return model


def global_rows(seed: int):
    """Four rows: bos, 1-9 text tokens, then (rows 0 and 2) <image_start>,
    an answer image, <image_end>, and 1-3 text tokens; uneven lengths."""
    rng = np.random.default_rng(seed)
    ids, labs = [], []
    for b in range(B):
        n = int(rng.integers(1, 10))
        text = [int(x) for x in rng.integers(5, 1000, n)]
        ids.append([1] + text)
        labs.append([IGNORE_INDEX] + [IGNORE_INDEX] * (n // 2)
                    + text[n // 2:])
        if b % 2 == 0:
            tail = [int(x) for x in rng.integers(5, 1000,
                                                 int(rng.integers(1, 4)))]
            ids[-1] += [IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX, 128257] + tail
            labs[-1] += [IM_START_TOKEN_ID, 0, 128257] + tail
    pixels = rng.normal(size=(B, 28, 28, 3)).astype(np.float32)
    return ids, labs, pixels


def packed(ids, labs, n_slots):
    from metamorph_tpu_torch.multimodal.packing import (batch_to_arrays,
                                                        pack_sequences)

    return batch_to_arrays(pack_sequences(ids, labs, K, T, n_slots))


def rank_batch(seed: int, idx: int, count: int):
    """Rank coordinate idx of count: its rows and their images (each row
    takes one image slot, so its slot is its row)."""
    ids, labs, pixels = global_rows(seed)
    bl = B // count
    sl = slice(idx * bl, (idx + 1) * bl)
    return packed(ids[sl], labs[sl], N // count), pixels[sl]


def _torch(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


def _step_inputs(cfg, idx, count):
    """The step's local inputs: one batch (seed 0), or two microbatches
    (seeds 0 and 1) stacked."""
    if cfg.train.grad_accum_steps > 1:
        parts = [rank_batch(s, idx, count) for s in (0, 1)]
        return (_torch({k: np.stack([p[0][k] for p in parts])
                        for k in parts[0][0]}),
                torch.from_numpy(np.stack([p[1] for p in parts])))
    arrays, pixels = rank_batch(0, idx, count)
    return _torch(arrays), torch.from_numpy(pixels)


# ---------------------------------------------------------------------------
# the sharded step: workers (no JAX)
# ---------------------------------------------------------------------------

def _steps_worker(rank, world, out_dir):
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.parallel import context
    from metamorph_tpu_torch.parallel import mesh as M
    from metamorph_tpu_torch.train import checkpoint as ckpt
    from metamorph_tpu_torch.train.optimizer import local
    from metamorph_tpu_torch.train.train_step import make_sharded_train_step

    cases = [(name, case_cfg(name), sp) for name, (_, sp, _) in CASES.items()]
    cases.append((LORA_CASE[0], lora_cfg(LORA_CASE[1]), False))
    for name, cfg, sp in cases:
        mesh = M.build_mesh(cfg.mesh, "cpu")
        idx, count = M.dp_coordinate(mesh, sp)
        model = (lora_model(cfg) if name == LORA_CASE[0] else
                 init_params(cfg, seed=1, device="cpu", dtype=torch.float32))
        step, tx, state = make_sharded_train_step(cfg, mesh, model)
        batch, pixels = _step_inputs(cfg, idx, count)
        out = {}
        for i in range(2):
            state, m = step(state, batch, pixels)
            for k, v in m.items():
                out[f"m{i}_{k}"] = float(v)
            if i == 0:
                for n, p in state["params"].named_parameters():
                    if p.grad is not None:
                        out[f"g_{n}"] = ckpt._full(
                            p, local(p.grad), state["tensor_cut"], n,
                            state["tensor_group"]).numpy()
        full = ckpt.full_train_state(state)
        context.set_current_mesh(None)
        context.set_sequence_axis(None)
        if rank == 0:
            out.update({f"p_{n}": t.numpy()
                        for n, t in full["params"].items()})
            out.update({f"mu_{n}": t.numpy()
                        for n, t in full["opt_state"]["mu"].items()})
            np.savez(os.path.join(out_dir, f"{name}.npz"), **out)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    spawn_ranks(_steps_worker, 4, d, str(d))
    return {name: dict(np.load(d / f"{name}.npz"))
            for name in (*CASES, LORA_CASE[0])}


# ---------------------------------------------------------------------------
# the references: JAX's one-device step, the port's one-device gradients
# ---------------------------------------------------------------------------

def _jax_run(cfg: MetaMorphConfig):
    import functools

    import jax
    import jax.numpy as jnp

    from metamorph_tpu.config import MetaMorphConfig as JConfig
    from metamorph_tpu.train import train_step as JTS
    from metamorph_tpu.train.optimizer import make_optimizer
    from metamorph_tpu_torch.convert import init_params, to_jax_params

    jcfg = JConfig.from_json(dataclasses.replace(
        cfg, mesh=MeshConfig(), train=dataclasses.replace(
            cfg.train, sequence_parallel=False,
            offload_optimizer=False)).to_json())
    model = init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, to_jax_params(model))
    tx = make_optimizer(jcfg.train, jp)
    state = JTS.init_train_state(jp, jcfg)
    accum = cfg.train.grad_accum_steps > 1
    fn = JTS.accum_train_step if accum else JTS.train_step
    step = jax.jit(functools.partial(fn, cfg=jcfg, tx=tx, attn_impl="flash"))
    if accum:
        parts = [packed(*global_rows(s)[:2], N) for s in (0, 1)]
        batch = {k: jnp.asarray(np.stack([p[k] for p in parts]))
                 for k in parts[0]}
        pixels = jnp.asarray(np.stack([global_rows(s)[2] for s in (0, 1)]))
    else:
        batch = {k: jnp.asarray(v)
                 for k, v in packed(*global_rows(0)[:2], N).items()}
        pixels = jnp.asarray(global_rows(0)[2])
    ms = []
    for _ in range(2):
        state, m = step(state, batch, pixels)
        ms.append({k: float(v) for k, v in m.items()})
    return state["params"], ms


def _port_run(cfg: MetaMorphConfig, model=None):
    """The port's one-device step: its first gradients by parameter name,
    and the metrics of two steps."""
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.optimizer import make_optimizer

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, sequence_parallel=False, offload_optimizer=False))
    if model is None:
        model = init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    state = TS.init_train_state(model, cfg)
    tx = make_optimizer(cfg.train, model)
    batch, pixels = _step_inputs(cfg, 0, 1)
    fn = (TS.accum_train_step if cfg.train.grad_accum_steps > 1
          else TS.train_step)
    ms, grads = [], None
    for _ in range(2):
        state, m = fn(state, batch, pixels, cfg, tx)
        ms.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
    return grads, ms


@pytest.fixture(scope="module")
def references():
    out = {}
    for accum in (1, 2):
        cfg = port_cfg(grad_accum_steps=accum)
        out[accum] = (*_jax_run(cfg), _port_run(cfg)[0])
    out["lora"] = _port_run(lora_cfg(), lora_model(lora_cfg()))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax_one_device_step(sharded_runs, references,
                                                  name):
    import jax

    from metamorph_tpu_torch.convert import from_jax_params

    cfg = case_cfg(name)
    jparams, jms, grads = references[cfg.train.grad_accum_steps]
    got = sharded_runs[name]
    rtol = 2e-4 if cfg.train.sequence_parallel else 1e-5
    for i, jm in enumerate(jms):
        for k in METRICS + ("grad_norm",):
            np.testing.assert_allclose(got[f"m{i}_{k}"], jm[k], rtol=rtol,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    _assert_grads(got, grads)
    # the parameters after two steps, against JAX's
    ref = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                          device="cpu")
    for n, p in ref.named_parameters():
        np.testing.assert_allclose(got[f"p_{n}"], p.detach().numpy(),
                                   rtol=5e-3, atol=5e-3, err_msg=n)


def _assert_grads(got, grads):
    """The first step's gradients, gathered, against the port's one-device
    step: the same set of parameters, each within 1e-5 of its max |g|."""
    assert {k[2:] for k in got if k.startswith("g_")} == set(grads)
    for n, g in grads.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(got[f"g_{n}"], g, rtol=0,
                                   atol=1e-5 * scale, err_msg=n)


def test_lora_under_tensor_parallelism_matches_the_one_device_step(
        sharded_runs, references):
    """LoRA factors on a (fsdp 2, tensor 2) mesh: the metrics of two steps
    within 1e-5 and the first gradients (the factors' among them) within
    1e-5 of max |g| of the port's one-device LoRA step."""
    grads, ms = references["lora"]
    got = sharded_runs[LORA_CASE[0]]
    assert any(n.endswith("_lora_a") for n in grads)
    for i, m in enumerate(ms):
        for k in METRICS + ("grad_norm",):
            np.testing.assert_allclose(got[f"m{i}_{k}"], m[k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    _assert_grads(got, grads)


def test_offloaded_sharded_step_is_bitwise_the_on_device_one(sharded_runs):
    a, b = sharded_runs["dp2_fsdp2"], sharded_runs["dp2_fsdp2_offload"]
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# train() over two ranks: save, resume, rank 0 writes
# ---------------------------------------------------------------------------

class RankData:
    """This rank's rows of the seed-0 global batch, every step, with a
    resumable position."""

    def __init__(self, idx, count):
        self.idx, self.count = idx, count
        self.state = {"epoch": 0, "step_in_epoch": 0}

    def state_dict(self):
        return dict(self.state)

    def load_state_dict(self, s):
        self.state = dict(s)

    def __iter__(self):
        while True:
            self.state["step_in_epoch"] += 1
            yield rank_batch(self.state["step_in_epoch"] % 2, self.idx,
                             self.count)


def save_cfgs():
    """sub-directory -> (config, mesh over 2 ranks) of the one-step runs
    whose adapter or LoRA file is saved."""
    lr = dict(total_steps=1)
    lora = lora_cfg()
    return {"adapter": (port_cfg(tune_mm_mlp_adapter=True, **lr), (1, 2, 1)),
            "lora": (dataclasses.replace(lora, train=dataclasses.replace(
                lora.train, **lr)), (1, 1, 2))}


def _with_lora(build):
    """`trainer.build_params` that also gives the model LoRA factors when
    the config trains them (train() adds none itself)."""
    from metamorph_tpu_torch.models.lora import add_lora

    def build_params(cfg, args, seed=0, device="cuda"):
        model = build(cfg, args, seed, device)
        if cfg.train.lora_enable:
            add_lora(model.llama, r=LORA_R, seed=0)
        return model

    return build_params


def _trainer_worker(rank, world, out_dir):
    from metamorph_tpu_torch.train import checkpoint as ckpt
    from metamorph_tpu_torch.train import trainer as T
    from metamorph_tpu_torch.train.trainer import TrainerArgs, train

    T.build_params = _with_lora(T.build_params)

    def run(sub, total, save_steps):
        cfg = dataclasses.replace(port_cfg(total_steps=total),
                                  mesh=MeshConfig(1, 2, 1))
        args = TrainerArgs(output_dir=os.path.join(out_dir, sub),
                           save_steps=save_steps, save_total_limit=1,
                           resume=True)
        out = train(cfg, args, RankData(rank, world), multihost=True,
                    device="cpu")
        return ckpt.full_train_state(out["state"]), out

    whole, out = run("whole", 4, 0)
    run("resumed", 2, 2)
    listing = sorted(os.listdir(os.path.join(out_dir, "resumed")))
    dist.barrier()
    resumed, out2 = run("resumed", 4, 4)
    # one step and its save with the stage-1 adapter over fsdp 2, and with
    # LoRA factors cut over tensor 2: both ranks gather, rank 0 writes
    for sub, (cfg, mesh) in save_cfgs().items():
        train(dataclasses.replace(cfg, mesh=MeshConfig(*mesh)),
              TrainerArgs(output_dir=os.path.join(out_dir, sub),
                          save_steps=1, resume=False),
              RankData(rank, world) if mesh[1] > 1 else RankData(0, 1),
              multihost=True, device="cpu")
    if rank == 0:
        np.savez(os.path.join(out_dir, "trainer.npz"),
                 listing=np.array(listing), step=out2["step"],
                 # bf16 weights and moments (the trainer's param dtype),
                 # widened exactly to fp32
                 **{f"w_{n}": t.float().numpy()
                    for n, t in whole["params"].items()},
                 **{f"r_{n}": t.float().numpy()
                    for n, t in resumed["params"].items()},
                 **{f"wmu_{n}": t.float().numpy()
                    for n, t in whole["opt_state"]["mu"].items()},
                 **{f"rmu_{n}": t.float().numpy()
                    for n, t in resumed["opt_state"]["mu"].items()})


def test_train_over_two_ranks_resumes_like_an_unbroken_run(tmp_path,
                                                          monkeypatch):
    """train(multihost=True) on an existing 2-rank group with mesh (1, 2, 1):
    4 steps unbroken, and 2 steps saved then resumed to 4, give the same
    parameters and moments bitwise; the checkpoint directory holds what
    rank 0 wrote (one step directory, its metrics), and the one-device
    restore reads it into the state of the gathered step-2 weights. The
    adapter and LoRA saves of a sharded run (`_assert_saved_files`)."""
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.train import checkpoint as ckpt
    from metamorph_tpu_torch.train import train_step as TS

    spawn_ranks(_trainer_worker, 2, tmp_path, str(tmp_path))
    got = dict(np.load(tmp_path / "trainer.npz"))
    assert list(got["listing"]) == ["metrics.jsonl", "step_2"]
    assert sorted(os.listdir(tmp_path / "resumed")) == ["metrics.jsonl",
                                                        "step_4"]
    assert int(got["step"]) == 4
    for k in got:
        if k.startswith(("w_", "wmu_")):
            other = ("r_" + k[2:]) if k.startswith("w_") else "rmu_" + k[4:]
            assert np.array_equal(got[k], got[other]), k
    cfg = port_cfg(total_steps=2)
    state = TS.init_train_state(
        init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16), cfg)
    state = ckpt.restore_train_state(str(tmp_path / "resumed" / "step_4"),
                                     state)
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    for n, p in state["params"].named_parameters():
        assert np.array_equal(p.detach().float().numpy(), got[f"r_{n}"]), n
    rows = (tmp_path / "resumed" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 4
    # throughput counts each step's real tokens over both ranks' rows
    # (step k reads the seed k % 2 rows); the ranks' counts differ
    whole = [json.loads(r) for r in
             (tmp_path / "whole" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in whole] == [1, 2, 3, 4]
    real = {seed: [int(rank_batch(seed, i, 2)[0]["attn_mask"].sum())
                   for i in (0, 1)] for seed in (0, 1)}
    assert any(a != b for a, b in real.values())
    for prev, row in zip(whole, whole[1:]):
        assert row["tokens_per_sec_per_chip"] * 2 * (
            row["time"] - prev["time"]) == pytest.approx(
                sum(real[row["step"] % 2]), rel=1e-6), row["step"]
    _assert_saved_files(tmp_path, monkeypatch)


def _assert_saved_files(tmp_path, monkeypatch):
    """The adapter file of the fsdp-2 run and the LoRA file of the
    tensor-2 run: byte for byte what the one-device save writes from the
    model restored from the run's checkpoint, and within 2 * lr of the
    file a one-device train() writes (a step moves a weight by about
    lr * sign(g), which a near-zero gradient summed in another order can
    flip)."""
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.models.lora import add_lora
    from metamorph_tpu_torch.train import checkpoint as ckpt
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train import trainer as T
    from metamorph_tpu_torch.utils.safetensors_io import SafetensorsFile

    monkeypatch.setattr(T, "build_params", _with_lora(T.build_params))
    for sub, (cfg, _) in save_cfgs().items():
        name, save = (("mm_projector.safetensors", ckpt.save_adapter)
                      if sub == "adapter" else
                      ("lora.safetensors", ckpt.save_lora))
        got = tmp_path / sub / name
        model = init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
        if cfg.train.lora_enable:
            add_lora(model.llama, r=LORA_R)
        ckpt.restore_train_state(str(tmp_path / sub / "step_1"),
                                 TS.init_train_state(model, cfg))
        save(str(tmp_path / f"{sub}_restored.safetensors"), model)
        assert got.read_bytes() == (
            tmp_path / f"{sub}_restored.safetensors").read_bytes(), sub
        T.train(cfg, T.TrainerArgs(output_dir=str(tmp_path / f"{sub}_one"),
                                   save_steps=1, resume=False),
                RankData(0, 1), device="cpu")
        a, b = SafetensorsFile(str(got)), SafetensorsFile(
            str(tmp_path / f"{sub}_one" / name))
        assert sorted(a) == sorted(b) and len(a), sub
        for k in a:
            np.testing.assert_allclose(
                a[k].float().numpy(), b[k].float().numpy(), rtol=0,
                atol=2 * cfg.train.learning_rate, err_msg=f"{sub} {k}")


# ---------------------------------------------------------------------------
# the visualizer's data-parallel step
# ---------------------------------------------------------------------------

VIS_STEPS = 2
VIS_B = 4       # the global batch: 2 rows per rank


def _vis_worker(rank, world, out_dir, kw):
    from torch.distributed.device_mesh import DeviceMesh

    from metamorph_tpu_torch.visualizer import train as ttrain
    from metamorph_tpu_torch.visualizer.unet import UNetConfig
    from metamorph_tpu_torch.visualizer.vae import VAEConfig

    draws = dict(np.load(os.path.join(out_dir, "draws.npz")))

    def loss_draws(generator, latents, tc, num_train_timesteps):
        seed = generator.initial_seed()
        assert latents[0] == VIS_B
        return {k.split("_", 1)[1]: torch.from_numpy(v)
                for k, v in draws.items() if k.startswith(f"{seed}_")}

    ttrain.loss_draws = loss_draws
    state = torch.load(os.path.join(out_dir, "state.pt"), weights_only=False)
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    tc = ttrain.VisualizerTrainConfig(**kw)
    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
    step, _ = ttrain.make_visualizer_train_step(
        tc, UNetConfig.tiny(), VAEConfig.tiny(), mesh=mesh)
    bl = VIS_B // world
    sl = slice(rank * bl, (rank + 1) * bl)
    losses = []
    for i in range(VIS_STEPS):
        g = torch.Generator()
        g.manual_seed(20 + i)
        state, loss = step(state, torch.from_numpy(inputs["emb"][sl]),
                           torch.from_numpy(inputs["img"][sl]), g)
        losses.append(float(loss))
    if rank == 0:
        torch.save({"losses": losses, "adapter": state["adapter"],
                    "unet": state["unet"]},
                   os.path.join(out_dir, "result.pt"))


def test_visualizer_dp_step_matches_jax_mesh_step(tmp_path):
    """Two steps with the UNet unfrozen (both the adapter's and the UNet's
    gradients averaged over the ranks), from JAX's mid-run state of
    tests/test_torch_visualizer_train.py: the losses and both trees."""
    unfreeze = True
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from metamorph_tpu.visualizer import train as jtrain
    from metamorph_tpu_torch.convert import visualizer_train_state_from_jax
    from metamorph_tpu_torch.visualizer.params import tree_to_jax
    from tests import test_torch_visualizer_train as V

    (jucfg, jvcfg), (tucfg, tvcfg) = V._cfgs()
    adapter, unet, vae = V._trees(jucfg, jvcfg)
    import optax

    tx = optax.adamw(lambda count: 0.0, b1=0.9, b2=0.999, weight_decay=0.01)
    jstate = {"adapter": adapter, "unet": unet, "vae": vae,
              "opt_adapter": V._mid_run(tx.init(adapter), adapter, 5),
              "opt_unet": V._mid_run(tx.init(unet), unet, 6)}
    kw = dict(unfreeze_unet=unfreeze, **V.TC_KW)
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((VIS_B, 4, V.EMB)).astype(np.float32)
    img = rng.uniform(-1, 1, (VIS_B, V.RES, V.RES, 3)).astype(np.float32)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jstep, _ = jtrain.make_visualizer_train_step(
        jtrain.VisualizerTrainConfig(**kw), jucfg, jvcfg, mesh=mesh)
    torch.save(visualizer_train_state_from_jax(jstate, device="cpu"),
               tmp_path / "state.pt")
    # every leaf its own buffer (the two optimizer states share their
    # count), replicated; the batch split over the mesh, as JAX's own test
    # places them
    from jax.sharding import NamedSharding, PartitionSpec as P

    jstate = jax.device_put(
        jax.tree.map(lambda x: jnp.array(x, copy=True), jstate),
        NamedSharding(mesh, P()))
    bsh = NamedSharding(mesh, P("data"))
    jlosses = []
    for i in range(VIS_STEPS):
        jstate, loss = jstep(jstate, jax.device_put(emb, bsh),
                             jax.device_put(img, bsh),
                             jax.random.PRNGKey(20 + i))
        jlosses.append(float(loss))

    # JAX's draws of the global batch for each step's key, as
    # tests/test_torch_visualizer_train.py's seam makes them
    tc = jtrain.VisualizerTrainConfig(**kw)
    from metamorph_tpu_torch.visualizer.vae import latent_shape

    shape = latent_shape(tvcfg, img.shape)
    draws = {}
    for i in range(VIS_STEPS):
        key = jax.random.PRNGKey(20 + i)
        k_drop, k_noise, k_t, k_off, k_vae = jax.random.split(key, 5)
        d = {"drop": jax.random.uniform(k_drop, (VIS_B,)) < tc.cfg_prob,
             "noise": jax.random.normal(k_noise, shape),
             "t": jax.random.randint(k_t, (VIS_B,), 0, 1000),
             "eps": jax.random.normal(k_vae, shape),
             "offset": jax.random.normal(k_off, (VIS_B, 1, 1, shape[-1]))}
        draws.update({f"{20 + i}_{k}": np.asarray(v) for k, v in d.items()})
    np.savez(tmp_path / "draws.npz", **draws)
    np.savez(tmp_path / "inputs.npz", emb=emb, img=img)
    spawn_ranks(_vis_worker, 2, tmp_path, str(tmp_path), kw)
    got = torch.load(tmp_path / "result.pt", weights_only=False)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=V.LOSS_RTOL)
    for name, lr in (("adapter", kw["learning_rate"]),
                     ("unet", kw["unet_lr"])):
        V._assert_close_trees(jstate[name], tree_to_jax(got[name]),
                              2 * lr * VIS_STEPS + 1e-6)


def test_tar_shards_split_by_rank_as_jax(tmp_path):
    """iter_tar_shards(paths, rank, world): every rank's images, as JAX's
    split gives them, for 5 shards over 1-4 ranks."""
    import io
    import tarfile

    from metamorph_tpu.visualizer import train as jtrain
    from metamorph_tpu_torch.visualizer import train as ttrain

    paths = []
    for s in range(5):
        p = tmp_path / f"shard{s}.tar"
        with tarfile.open(p, "w") as tf:
            for j in range(2):
                data = f"{s}-{j}".encode()
                info = tarfile.TarInfo(f"{s}_{j}.png")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        paths.append(str(p))
    for world in (1, 2, 3, 4):
        seen = []
        for rank in range(world):
            mine = list(ttrain.iter_tar_shards(paths[::-1], rank, world))
            assert mine == list(jtrain.iter_tar_shards(paths[::-1], rank,
                                                       world))
            seen += mine
        assert sorted(seen) == sorted(f"{s}-{j}".encode() for s in range(5)
                                      for j in range(2))
