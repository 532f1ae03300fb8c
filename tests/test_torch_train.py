"""PyTorch port, training path: the dual-loss forward, the train step with
AdamW (plain, accumulated, stage 1), the remat policies, the SigLIP
freeze, and `train()` — each against the JAX package on the CPU.

Both sides run the same fp32 weights (`convert.from_jax_params`) on the
same numpy inputs; the JAX side runs its flash kernels in interpret mode
(`attn_impl="flash"`), the port its plain versions. Tolerances:
  * losses, metrics and grad_norm: 1e-5 relative (fp32 sums in another
    order; measured ~1e-6);
  * parameters after the steps: 1e-5 relative plus 2e-5 absolute. Adam's
    early steps move a weight by about lr * m / sqrt(v), close to +-lr =
    1e-3 for every gradient well above eps, so a gradient that differs in
    its low bits can move its weight's update by a few percent of one step
    (2e-5 of the 1e-3 step bounds it);
  * the remat policies: 1e-6, the same fp32 ops recomputed."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.config import LlamaConfig as JLlamaConfig
from metamorph_tpu.config import MetaMorphConfig as JConfig
from metamorph_tpu.config import MultimodalConfig as JMM
from metamorph_tpu.config import SiglipConfig as JSiglipConfig
from metamorph_tpu.config import TrainConfig as JTrainConfig
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu.train import train_step as JTS
from metamorph_tpu.train.optimizer import make_optimizer as jax_optimizer
from metamorph_tpu.train.optimizer import make_schedule as jax_schedule
from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                        MeshConfig, TrainConfig)
from metamorph_tpu_torch.constants import (IGNORE_INDEX, IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX)
from metamorph_tpu_torch.convert import from_jax_params, to_jax_params
from metamorph_tpu_torch.models import llama as L
from metamorph_tpu_torch.models import losses
from metamorph_tpu_torch.models import metamorph as M
from metamorph_tpu_torch.multimodal.packing import (batch_to_arrays,
                                                    pack_sequences)
from metamorph_tpu_torch.train import optimizer as opt_lib
from metamorph_tpu_torch.train import train_step as TS
from metamorph_tpu_torch.train.trainer import TrainerArgs, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=2e-5)
METRICS = ("loss", "loss_language", "loss_image_ar", "n_text_tokens",
           "n_image_ar_tokens")


def jax_cfg(mm=None, **train_kw):
    train_kw = {"total_steps": 20, **train_kw}
    return JConfig(
        llama=JLlamaConfig.tiny(vocab_size=128258),
        siglip=JSiglipConfig.tiny(),
        mm=mm or JMM(num_image_tokens=K),
        train=JTrainConfig(max_seq_len=24, batch_size=4,
                           max_images_per_batch=4, remat=False,
                           learning_rate=1e-3, **train_kw))


def port_cfg(jcfg) -> MetaMorphConfig:
    return MetaMorphConfig.from_dict(jcfg.to_dict())


def make_batch(B=4, seed=0, first=1):
    """The rows of tests/test_train.py: bos, a text token, <image_start>,
    an answer image, <image_end>, two text tokens."""
    ids, labs = [], []
    for b in range(B):
        ids.append([first, 2 + b, IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX,
                    128257, 7, 8])
        labs.append([IGNORE_INDEX, IGNORE_INDEX, IM_START_TOKEN_ID, 0,
                     128257, 7, 8])
    arrays = batch_to_arrays(pack_sequences(ids, labs, K, 24, B))
    pixels = np.random.default_rng(seed).normal(
        size=(B, 28, 28, 3)).astype(np.float32)
    return arrays, pixels


def _jax(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _torch(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


@pytest.fixture(scope="module")
def jparams():
    return JM.init_metamorph_params(jax.random.PRNGKey(0), jax_cfg(),
                                    dtype=jnp.float32)


def _port_model(jp, cfg):
    return from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _assert_params_equal(jax_tree, model, tol=PARAM_TOL):
    mine = to_jax_params(model)
    assert (jax.tree_util.tree_structure(jax.tree.map(np.asarray, jax_tree))
            == jax.tree_util.tree_structure(mine))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jax_tree),
                            jax.tree.leaves(mine)):
        np.testing.assert_allclose(b, np.asarray(a), err_msg=str(path), **tol)


def _assert_metrics(jm, tm, keys=METRICS):
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)


@pytest.mark.parametrize("normalize_vision,apply_softmax", [
    (True, False), (False, True), (False, False)],
    ids=["cosine", "softmax", "l1"])
def test_metamorph_forward_matches_jax(jparams, normalize_vision,
                                       apply_softmax):
    """Loss, both terms and the five metrics of the dual-loss forward."""
    jcfg = jax_cfg(mm=JMM(num_image_tokens=K,
                          normalize_vision=normalize_vision,
                          apply_softmax=apply_softmax))
    cfg = port_cfg(jcfg)
    arrays, pixels = make_batch()
    _, jm = jax.jit(lambda p, b, x: JM.metamorph_forward(
        p, jcfg, b, x, attn_impl="flash"))(jparams, _jax(arrays),
                                           jnp.asarray(pixels))
    model = _port_model(jparams, cfg)
    with torch.no_grad():
        total, tm = M.metamorph_forward(model, cfg, _torch(arrays),
                                        torch.from_numpy(pixels))
    _assert_metrics(jm, tm)
    assert float(total) == float(tm["loss"])
    assert float(tm["n_image_ar_tokens"]) == 4 * K


def _jax_steps(jp, jcfg, batches, n_steps, accum=False):
    tx = jax_optimizer(jcfg.train, jp)
    state = JTS.init_train_state(jp, jcfg)
    fn = JTS.accum_train_step if accum else JTS.train_step
    step = jax.jit(functools.partial(fn, cfg=jcfg, tx=tx, attn_impl="flash"))
    out = []
    for i in range(n_steps):
        state, m = step(state, *batches[i % len(batches)])
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def _port_steps(model, cfg, batches, n_steps, accum=False):
    state = TS.init_train_state(model, cfg)
    tx = opt_lib.make_optimizer(cfg.train, model)
    fn = TS.accum_train_step if accum else TS.train_step
    out = []
    for i in range(n_steps):
        state, m = fn(state, *batches[i % len(batches)], cfg, tx)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def test_train_step_matches_jax_three_steps(jparams):
    """Three steps of jax.jit(train_step) against the port's: the metrics,
    grad_norm included, every step, and the parameters after the steps.
    Step 1 runs at lr 0 and changes nothing, so the loss first moves at
    step 3."""
    jcfg = jax_cfg()
    cfg = port_cfg(jcfg)
    arrays, pixels = make_batch()
    jstate, jms = _jax_steps(jparams, jcfg,
                             [(_jax(arrays), jnp.asarray(pixels))], 3)
    model = _port_model(jparams, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TS.init_train_state(model, cfg)
    tx = opt_lib.make_optimizer(cfg.train, model)
    tms = []
    for i in range(3):
        state, m = TS.train_step(state, _torch(arrays),
                                 torch.from_numpy(pixels), cfg, tx)
        tms.append({k: float(v) for k, v in m.items()})
        if i == 0:
            for n, p in model.named_parameters():
                assert torch.equal(p, before[n]), n
    for jm, tm in zip(jms, tms):
        _assert_metrics(jm, tm, METRICS + ("grad_norm",))
    assert tms[1]["loss"] == tms[0]["loss"]
    assert tms[2]["loss"] < tms[0]["loss"]
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    _assert_params_equal(jstate["params"], model)


def test_stage1_adapter_step_matches_jax(jparams):
    """tune_mm_mlp_adapter: only the projector and the embeddings move, to
    the JAX values; the LLM layers, the vision head and the tower stay
    bitwise. grad_norm is the norm over the trainable gradients (the JAX
    metric also counts the frozen LLM's; see train_step.py)."""
    jcfg = jax_cfg(tune_mm_mlp_adapter=True)
    cfg = port_cfg(jcfg)
    arrays, pixels = make_batch()
    jb = (_jax(arrays), jnp.asarray(pixels))
    jstate, _ = _jax_steps(jparams, jcfg, [jb], 2)
    model = _port_model(jparams, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, tms = _port_steps(model, cfg, [(_torch(arrays),
                                           torch.from_numpy(pixels))], 2)
    _assert_params_equal(jstate["params"], model)
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])}
    assert moved == {"llama.embed", "projector.layers.0.kernel",
                     "projector.layers.0.bias", "projector.layers.1.kernel",
                     "projector.layers.1.bias"}
    assert set(state["opt_state"]["mu"]) == moved
    # the JAX gradients, masked to the trainable set, give the port's norm
    grads = jax.jit(jax.grad(
        lambda p: JTS.loss_fn(p, jcfg, *jb, "flash")[0]))(jparams)
    norm = np.sqrt(sum(float(jnp.sum(jnp.square(g))) for g in
                       jax.tree.leaves({"p": grads["projector"],
                                        "e": grads["llama"]["embed"]})))
    np.testing.assert_allclose(tms[0]["grad_norm"], norm, **METRIC_TOL)


def test_accum_train_step_matches_jax(jparams):
    """Two microbatches per step, two steps (the first at lr 0)."""
    jcfg = jax_cfg(grad_accum_steps=2)
    cfg = port_cfg(jcfg)
    (a0, p0), (a1, p1) = make_batch(seed=0), make_batch(seed=1, first=9)
    stacked = {k: np.stack([a0[k], a1[k]]) for k in a0}
    pixels = np.stack([p0, p1])
    jstate, jms = _jax_steps(jparams, jcfg,
                             [(_jax(stacked), jnp.asarray(pixels))], 2,
                             accum=True)
    model = _port_model(jparams, cfg)
    _, tms = _port_steps(model, cfg, [(_torch(stacked),
                                       torch.from_numpy(pixels))], 2,
                         accum=True)
    for jm, tm in zip(jms, tms):
        _assert_metrics(jm, tm, METRICS + ("grad_norm",))
    _assert_params_equal(jstate["params"], model)


@pytest.mark.parametrize("policy", L.REMAT_POLICIES)
def test_remat_policy_grads_match_no_remat(policy):
    """Each remat policy gives the gradients of remat=False (the shapes of
    tests/test_flash_attention.py:154-182)."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=2, num_kv_heads=1, head_dim=64,
                      rope_scaling=False)
    torch.manual_seed(0)
    model = L.Llama(cfg, dtype=torch.float32)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.05)
    emb = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 256, 128)).astype(np.float32))
    pos = torch.arange(256)[None]

    def grads(remat):
        model.zero_grad()
        h = L.llama_forward(model, cfg, emb, pos, None, remat=remat,
                            remat_policy=policy)
        (h * h).sum().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    g0, g1 = grads(False), grads(True)
    assert g0.keys() == g1.keys() and len(g0) == 1 + 9 * 2
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=n)


def test_freeze_vision_stops_tower_gradients(jparams):
    """With the tower trainable (vision_tower_lr set) and freeze_vision,
    the tower's gradients are exactly zero in both packages and two steps
    leave it bitwise unchanged; without freeze_vision they flow."""
    jcfg = jax_cfg(vision_tower_lr=1e-3)
    cfg = port_cfg(jcfg)
    assert cfg.mm.freeze_vision
    arrays, pixels = make_batch()
    jg = jax.jit(jax.grad(lambda p: JTS.loss_fn(
        p, jcfg, _jax(arrays), jnp.asarray(pixels), "flash")[0]))(jparams)
    assert all(np.all(np.asarray(g) == 0)
               for g in jax.tree.leaves(jg["siglip"]))
    model = _port_model(jparams, cfg)
    before = {n: p.detach().clone() for n, p in model.siglip.named_parameters()}
    state, _ = _port_steps(model, cfg, [(_torch(arrays),
                                         torch.from_numpy(pixels))], 2)
    tower = dict(model.siglip.named_parameters())
    assert all(p.requires_grad for p in tower.values())
    assert all(p.grad is None or torch.all(p.grad == 0)
               for p in tower.values())
    assert all(torch.equal(tower[n], before[n]) for n in tower)

    thawed = dataclasses.replace(
        cfg, mm=dataclasses.replace(cfg.mm, freeze_vision=False))
    model = _port_model(jparams, thawed)
    TS.init_train_state(model, thawed)
    total, _ = M.metamorph_forward(model, thawed, _torch(arrays),
                                   torch.from_numpy(pixels))
    total.backward()
    assert model.siglip.layers[0].wq.grad.abs().sum() > 0


def test_stage2_config_round_trip_keeps_train_and_mesh():
    text = open(os.path.join(ROOT, "configs", "stage2_finetune.json")).read()
    cfg = MetaMorphConfig.from_json(text)
    assert cfg.train.learning_rate == 6.93e-05 and cfg.train.batch_size == 1536
    assert cfg.train.remat and cfg.mesh == MeshConfig()
    assert MetaMorphConfig.from_json(cfg.to_json()) == cfg
    assert MetaMorphConfig.from_dict(json.loads(text)).to_dict() == \
        JConfig.from_json(text).to_dict()
    assert cfg.mesh.device_count(1) == 1
    assert MeshConfig(data=2, fsdp=2, tensor=2).device_count(8) == 8


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_optax(kind):
    jt = JTrainConfig(total_steps=50, warmup_ratio=0.1, lr_schedule=kind)
    mine = opt_lib.make_schedule(TrainConfig(**dataclasses.asdict(jt)), 2e-4)
    ref = jax_schedule(jt, 2e-4)
    # optax evaluates in fp32, where 1 + cos cancels near the end of the
    # decay: 1e-6 relative plus 1e-6 of the peak absolute
    for count in (0, 1, 4, 5, 6, 20, 49, 50, 60):
        np.testing.assert_allclose(mine(count), float(ref(count)),
                                   rtol=1e-6, atol=2e-10)


def test_losses_match_jax():
    from metamorph_tpu.models import losses as jl

    rng = np.random.default_rng(7)
    z, h = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    p = np.abs(rng.normal(size=(6, 16))).astype(np.float32)
    for name in ("l1_loss", "smooth_l1_loss", "cosine_loss", "soft_ce_loss",
                 "infonce_loss"):
        ref = float(getattr(jl, name)(jnp.asarray(z), jnp.asarray(
            p if name == "soft_ce_loss" else h)))
        out = float(getattr(losses, name)(torch.from_numpy(z), torch.from_numpy(
            p if name == "soft_ce_loss" else h)))
        np.testing.assert_allclose(out, ref, rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# train() with a fake iterator (as tests/test_trainer.py)
# ---------------------------------------------------------------------------

def trainer_cfg(total_steps, **kw):
    return port_cfg(jax_cfg(total_steps=total_steps, **kw))


class FakeData:
    def __init__(self, cfg, K_seq=(K,)):
        self.cfg = cfg
        self.K_seq = K_seq
        self.state = {"epoch": 0, "step_in_epoch": 0}

    def state_dict(self):
        return dict(self.state)

    def load_state_dict(self, s):
        self.state = dict(s)

    def __iter__(self):
        B = self.cfg.train.batch_size
        i = 0
        while True:
            k = self.K_seq[i % len(self.K_seq)]
            i += 1
            ids = [[1, 2 + b, IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX, 128257,
                    7, 8] for b in range(B)]
            labs = [[IGNORE_INDEX, IGNORE_INDEX, IM_START_TOKEN_ID, 0,
                     128257, 7, 8] for _ in range(B)]
            packed = pack_sequences(ids, labs, k, self.cfg.train.max_seq_len,
                                    B)
            pixels = np.random.default_rng(0).normal(
                size=(B, 28, 28, 3)).astype(np.float32)
            self.state["step_in_epoch"] += 1
            yield packed, pixels


def test_train_loop_save_prune_and_resume(tmp_path, capsys):
    cfg = trainer_cfg(3)
    args = TrainerArgs(output_dir=str(tmp_path), save_steps=2,
                       logging_steps=1, resume=True)
    out = train(cfg, args, FakeData(cfg), device="cpu")
    assert out["step"] == 3 and "loss" in out["metrics"]
    err = capsys.readouterr().err
    assert "step 1: loss=" in err and "step 3: loss=" in err
    # save_steps=2 wrote step_2; save_total_limit=1 pruned it at step_3
    assert sorted(os.listdir(tmp_path)) == ["metrics.jsonl", "step_3"]
    rows = [json.loads(l) for l in
            open(tmp_path / "metrics.jsonl").read().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert {"loss", "loss_language", "loss_image_ar", "grad_norm"} <= set(
        rows[-1])
    meta = json.load(open(tmp_path / "step_3" / "meta.json"))
    assert meta["step"] == 3 and meta["data_state"]["step_in_epoch"] >= 3
    assert MetaMorphConfig.from_json(
        open(tmp_path / "step_3" / "config.json").read()) == cfg

    cfg2 = trainer_cfg(5)
    out2 = train(cfg2, args, FakeData(cfg2), device="cpu")
    assert out2["step"] == 5
    assert "resuming from" in capsys.readouterr().err
    rows = [json.loads(l) for l in
            open(tmp_path / "metrics.jsonl").read().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    # the resumed run continues the loss curve: step 4 < step 3
    assert rows[3]["loss"] < rows[2]["loss"]


def test_train_grad_accum_and_multires(tmp_path):
    cfg = trainer_cfg(2, grad_accum_steps=2)
    out = train(cfg, TrainerArgs(output_dir=str(tmp_path / "a"),
                                 save_steps=10, resume=False),
                FakeData(cfg), device="cpu")
    assert out["step"] == 2 and np.isfinite(out["metrics"]["loss"])
    cfg = trainer_cfg(3)
    out = train(cfg, TrainerArgs(output_dir=str(tmp_path / "b"),
                                 save_steps=10, resume=False),
                FakeData(cfg, K_seq=(1, 4, 1)), device="cpu")
    assert out["step"] == 3 and np.isfinite(out["metrics"]["loss"])
    assert out["metrics"]["n_image_ar_tokens"] == 4 * 1


def test_train_rejects_mixed_K_and_unported_options(tmp_path):
    cfg = trainer_cfg(1, grad_accum_steps=2)
    args = TrainerArgs(output_dir=str(tmp_path), save_steps=100,
                       resume=False)
    with pytest.raises(ValueError, match="mixed num_image_tokens"):
        train(cfg, args, FakeData(cfg, K_seq=(1, 4)), device="cpu")
    # without a process group a mesh must cover the one device (JAX's
    # build_mesh error); ring attention without a sequence group is flash
    # attention, and an unknown impl is refused
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        train(dataclasses.replace(cfg, mesh=MeshConfig(data=2, fsdp=2,
                                                        tensor=2)),
              args, FakeData(cfg), device="cpu")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        train(cfg, dataclasses.replace(args, attn_impl="splash"),
              FakeData(cfg), device="cpu")
    one = trainer_cfg(1)
    out = train(one, dataclasses.replace(args, attn_impl="ring",
                                         save_steps=0), FakeData(one),
                device="cpu")
    assert out["step"] == 1 and np.isfinite(out["metrics"]["loss"])
