"""PyTorch port, the visualizer's training path on the CPU in fp32, held to
the JAX package: the LR schedules, the loss, its gradients, the train step
(adapter only and with the UNet unfrozen) from a mid-run state carried
across, the plain AdamW, the tar-shard data and the CLI.

Weights fill JAX's trees from numpy seeds (`seeded_tree`); the port's five
random draws (`train.loss_draws`) are replaced by JAX's own draws for the
key the generator was seeded with, so both losses see the same drop mask,
noise, t, offset and posterior eps. JAX's loss and step are jitted once per
config (module-scoped fixtures).

Tolerances: the schedules bitwise (both compute in float32, the port's log
being XLA's); the loss 1e-5 relative (fp32 sums in another order);
gradients 1e-4 of the tree's max |g|; the plain AdamW on equal gradients
1e-6; parameters after 3 steps atol = 2 * lr * steps + 1e-6, since Adam's
first updates are near lr * sign(m / sqrt(v)) and a gradient that differs
in its low bits can flip a near-zero entry's sign."""

import dataclasses
import functools
import io
import json
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metamorph_tpu.visualizer import adapter as jadapter
from metamorph_tpu.visualizer import train as jtrain
from metamorph_tpu.visualizer import unet as junet
from metamorph_tpu.visualizer import vae as jvae
from metamorph_tpu_torch.convert import (visualizer_from_jax_params,
                                         visualizer_train_state_from_jax)
from metamorph_tpu_torch.train.optimizer import PlainAdamW
from metamorph_tpu_torch.visualizer import adapter as tadapter
from metamorph_tpu_torch.visualizer import train as ttrain
from metamorph_tpu_torch.visualizer import unet as tunet
from metamorph_tpu_torch.visualizer import vae as tvae
from metamorph_tpu_torch.visualizer.params import (ParamTree, map_leaves,
                                                   tree_to_jax)
from metamorph_tpu_torch.visualizer.scheduler import DDPMScheduler
from tests.test_torch_visualizer import seeded_tree

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-6
B, RES, EMB = 2, 16, 12          # batch, image side, SigLIP width
STEPS = 3
UCFG_TINY, VCFG_TINY = tunet.UNetConfig.tiny(), tvae.VAEConfig.tiny()


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _cfgs():
    return ((junet.UNetConfig.tiny(), jvae.VAEConfig.tiny()),
            (UCFG_TINY, VCFG_TINY))


def _trees(ucfg, vcfg):
    return (seeded_tree(jadapter.init_adapter, mode="mlp", input_dim=EMB,
                        hidden_dim=16, output_dim=ucfg.cross_attention_dim,
                        num_layers=2, seed=2),
            seeded_tree(junet.init_unet_params, ucfg),
            seeded_tree(jvae.init_vae_params, vcfg, seed=1))


def _inputs(seed=3, res=RES):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 4, EMB)).astype(np.float32),
            rng.uniform(-1, 1, (B, res, res, 3)).astype(np.float32))


def jax_draws(monkeypatch):
    """The port's draws replaced by JAX's, made from PRNGKey(the
    generator's seed) as JAX's `visualizer_loss` splits and draws it."""

    def draws(generator, latents, tc, num_train_timesteps):
        key = jax.random.PRNGKey(generator.initial_seed())
        k_drop, k_noise, k_t, k_off, k_vae = jax.random.split(key, 5)
        n = latents[0]
        out = {"drop": jax.random.uniform(k_drop, (n,)) < tc.cfg_prob,
               "noise": jax.random.normal(k_noise, latents),
               "t": jax.random.randint(k_t, (n,), 0, num_train_timesteps),
               "eps": jax.random.normal(k_vae, latents)}
        if tc.noise_offset > 0:
            out["offset"] = jax.random.normal(k_off, (n, 1, 1, latents[-1]))
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    monkeypatch.setattr(ttrain, "loss_draws", draws)


def _named_to_jax(tree: ParamTree, named):
    """{parameter name: tensor} shaped like `tree`'s parameters (their
    gradients, their moments) as a JAX-layout tree."""
    return tree_to_jax(ParamTree(map_leaves(
        tree.to_tree(), lambda path, _: named[path.replace("/", ".")])))


def _grads_to_jax(tree: ParamTree):
    return _named_to_jax(tree, {n: p.grad for n, p in tree.named_parameters()})


def _assert_close_trees(ref, got, atol, rtol=0.0):
    none = lambda x: x is None  # noqa: E731
    assert (jax.tree.structure(ref, is_leaf=none)
            == jax.tree.structure(got, is_leaf=none))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol,
                                   rtol=rtol, err_msg=str(path))


# ---- configs and schedules --------------------------------------------------

def test_train_config_copy_matches_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(
        jtrain.VisualizerTrainConfig)]
        == [(f.name, f.default) for f in dataclasses.fields(
            ttrain.VisualizerTrainConfig)])


@pytest.mark.parametrize("base,target", [(1e-4, 16000), (1e-5, 16000),
                                         (3e-4, 40), (1e-4, 7)])
def test_lr_schedule_is_jaxs_bitwise(base, target):
    jf, tf = jtrain.lr_schedule(base, target), ttrain.lr_schedule(base,
                                                                  target)
    peak = target // 4
    for c in (0, 1, peak - 1, peak, peak + 1, target, target + 100):
        c = max(c, 0)
        assert np.float32(jf(c)) == np.float32(tf(c)), c
    # every count up to past the end, JAX vectorized
    counts = np.arange(target + 101)
    ref = np.asarray(jax.vmap(jf)(jnp.asarray(counts)))
    np.testing.assert_array_equal(
        ref, np.array([tf(int(c)) for c in counts], np.float32))
    assert tf(0) == 0.0 and tf(peak) == np.float32(base)


@pytest.mark.parametrize("base,warmup", [(1e-4, 10_000), (1e-5, 10_000),
                                         (2e-4, 3)])
def test_warmup_constant_schedule_is_jaxs_bitwise(base, warmup):
    jf = jtrain.lr_schedule_warmup_constant(base, warmup)
    tf = ttrain.lr_schedule_warmup_constant(base, warmup)
    counts = np.arange(warmup + 101)
    ref = np.asarray(jax.vmap(jf)(jnp.asarray(counts)))
    np.testing.assert_array_equal(
        ref, np.array([tf(int(c)) for c in counts], np.float32))
    for c in (0, 1, warmup - 1, warmup, warmup + 1, warmup + 100):
        assert np.float32(jf(c)) == np.float32(tf(c)), c


@pytest.mark.parametrize("scratch", [False, True])
def test_select_lr_schedules_swaps_both_for_a_scratch_unet(scratch):
    kw = dict(learning_rate=3e-4, unet_lr=2e-5, total_steps=400,
              unet_from_scratch=scratch)
    jsch = jtrain.select_lr_schedules(jtrain.VisualizerTrainConfig(**kw))
    tsch = ttrain.select_lr_schedules(ttrain.VisualizerTrainConfig(**kw))
    for jf, tf in zip(jsch, tsch):
        for c in (0, 1, 50, 99, 100, 399, 400, 10_000, 10_500):
            assert np.float32(jf(c)) == np.float32(tf(c)), c
    # warmup-then-constant reaches the base only at 10,000 steps; the
    # finetuning schedule peaks at total // 4 and decays to 0
    assert tsch[0](100) == (np.float32(np.float32(3e-4) * np.float32(0.01))
                            if scratch else np.float32(3e-4))
    assert (tsch[1](400) == 0.0) != scratch


# ---- the loss and its gradients ---------------------------------------------

@pytest.fixture(scope="module")
def tiny_trees():
    (jucfg, jvcfg), (tucfg, tvcfg) = _cfgs()
    return jucfg, jvcfg, tucfg, tvcfg, _trees(jucfg, jvcfg)


def _port_loss(monkeypatch, trees, cfgs, tc, emb, img, seed):
    jax_draws(monkeypatch)
    a, u, v = visualizer_from_jax_params(*trees, device="cpu")
    a.requires_grad_(True)
    u.requires_grad_(True)
    loss = ttrain.visualizer_loss(a, u, v, (tc, *cfgs, DDPMScheduler()),
                                  _t(emb), _t(img), _gen(seed))
    return loss, (a, u, v)


@pytest.mark.parametrize("cfg_prob,noise_offset", [
    (0.0, 0.0), (0.5, 0.0), (0.0, 0.05)])
def test_loss_matches_jax(monkeypatch, tiny_trees, cfg_prob, noise_offset):
    """The loss with JAX's five draws fed through the seam (the fourth
    case, both on, is in the gradient test below)."""
    jucfg, jvcfg, tucfg, tvcfg, trees = tiny_trees
    kw = dict(cfg_prob=cfg_prob, noise_offset=noise_offset)
    emb, img = _inputs()
    cfgs = (jtrain.VisualizerTrainConfig(**kw), jucfg, jvcfg,
            jtrain.DDPMScheduler())
    jloss = jax.jit(lambda *a: jtrain.visualizer_loss(*a[:3], cfgs, *a[3:]))(
        *trees, jnp.asarray(emb), jnp.asarray(img), jax.random.PRNGKey(12))
    loss, _ = _port_loss(monkeypatch, trees, (tucfg, tvcfg),
                         ttrain.VisualizerTrainConfig(**kw), emb, img, 12)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)


def test_loss_and_gradients_match_jax(monkeypatch, tiny_trees):
    """CFG dropout and the noise offset both on: the loss, and the adapter
    and UNet gradients (the UNet's: what `unfreeze_unet` trains on)."""
    jucfg, jvcfg, tucfg, tvcfg, trees = tiny_trees
    kw = dict(cfg_prob=0.5, noise_offset=0.05)
    emb, img = _inputs()
    # key 12 drops the first of the two rows at cfg_prob 0.5
    key = jax.random.PRNGKey(12)
    drop = jax.random.uniform(jax.random.split(key, 5)[0], (B,)) < 0.5
    assert np.asarray(drop).tolist() == [True, False]
    cfgs = (jtrain.VisualizerTrainConfig(**kw), jucfg, jvcfg,
            jtrain.DDPMScheduler())
    jloss, (ga, gu) = jax.jit(jax.value_and_grad(
        lambda *a: jtrain.visualizer_loss(*a[:3], cfgs, *a[3:]),
        argnums=(0, 1)))(*trees, jnp.asarray(emb), jnp.asarray(img), key)
    loss, (a, u, v) = _port_loss(monkeypatch, trees, (tucfg, tvcfg),
                                 ttrain.VisualizerTrainConfig(**kw), emb,
                                 img, 12)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    for ref, tree in ((ga, a), (gu, u)):
        scale = max(float(jnp.abs(x).max()) for x in jax.tree.leaves(ref))
        _assert_close_trees(ref, _grads_to_jax(tree), GRAD_TOL * scale)
    assert all(p.grad is None for p in v.parameters())


def test_loss_draws_shapes_and_generator():
    tc = ttrain.VisualizerTrainConfig(cfg_prob=0.5, noise_offset=0.1)
    d = ttrain.loss_draws(_gen(4), (3, 2, 2, 4), tc, 1000)
    assert d["drop"].dtype == torch.bool and d["drop"].shape == (3,)
    assert d["noise"].shape == d["eps"].shape == (3, 2, 2, 4)
    assert d["offset"].shape == (3, 1, 1, 4)
    assert 0 <= int(d["t"].min()) and int(d["t"].max()) < 1000
    again = ttrain.loss_draws(_gen(4), (3, 2, 2, 4), tc, 1000)
    assert all(torch.equal(d[k], again[k]) for k in d)
    assert "offset" not in ttrain.loss_draws(
        _gen(4), (3, 2, 2, 4), ttrain.VisualizerTrainConfig(), 1000)


# ---- the train step ---------------------------------------------------------

TC_KW = dict(cfg_prob=0.5, noise_offset=0.05, learning_rate=1e-3,
             unet_lr=5e-4, total_steps=40)
MID_COUNT = 5


def _mid_run(tx_state, tree, seed):
    """An adamw state as after MID_COUNT steps: seeded moments (nu > 0)."""
    rng = np.random.default_rng(seed)
    adam, empty, sched = tx_state
    mu = jax.tree.map(lambda x: jnp.asarray(
        1e-3 * rng.standard_normal(x.shape), jnp.float32), adam.mu)
    nu = jax.tree.map(lambda x: jnp.asarray(
        1e-6 * (1 + rng.uniform(size=x.shape)), jnp.float32), adam.nu)
    count = jnp.asarray(MID_COUNT, jnp.int32)
    return (adam._replace(count=count, mu=mu, nu=nu), empty,
            sched._replace(count=count))


@pytest.fixture(scope="module")
def tiny_state():
    """JAX's state mid-run: tiny trees, both adamw states with moments
    and a count of MID_COUNT."""
    (jucfg, jvcfg), _ = _cfgs()
    adapter, unet, vae = _trees(jucfg, jvcfg)
    tx = optax.adamw(lambda count: 0.0, b1=0.9, b2=0.999, weight_decay=0.01)
    return {"adapter": adapter, "unet": unet, "vae": vae,
            "opt_adapter": _mid_run(tx.init(adapter), adapter, 5),
            "opt_unet": _mid_run(tx.init(unet), unet, 6)}


def test_train_state_from_jax_is_bitwise(tiny_state):
    port = visualizer_train_state_from_jax(tiny_state, device="cpu")
    for k in ("opt_adapter", "opt_unet"):
        tree = port["adapter" if k == "opt_adapter" else "unet"]
        opt = port[k]
        assert opt["count"] == MID_COUNT
        assert list(opt["mu"]) == [n for n, _ in tree.named_parameters()]
        for key, ref in (("mu", tiny_state[k][0].mu),
                         ("nu", tiny_state[k][0].nu)):
            _assert_close_trees(ref, _named_to_jax(tree, opt[key]), 0.0)
    with pytest.raises(ValueError, match="not an adamw state"):
        visualizer_train_state_from_jax(
            {**tiny_state, "opt_unet": (tiny_state["opt_unet"][0],)
             + (tiny_state["opt_unet"][2]._replace(count=jnp.asarray(9)),)},
            device="cpu")


@pytest.mark.parametrize("unfreeze", [False, True],
                         ids=["adapter_only", "unfreeze_unet"])
def test_train_steps_match_jax(monkeypatch, tiny_state, unfreeze):
    """3 steps of JAX's jitted step and the port's from the same mid-run
    state: the losses each step, then every tree (the VAE, and the UNet
    when frozen, bitwise unchanged)."""
    (jucfg, jvcfg), (tucfg, tvcfg) = _cfgs()
    jstep, _ = jtrain.make_visualizer_train_step(
        jtrain.VisualizerTrainConfig(unfreeze_unet=unfreeze, **TC_KW),
        jucfg, jvcfg)
    emb, img = _inputs()
    state = visualizer_train_state_from_jax(tiny_state, device="cpu")
    vae0 = {n: p.clone() for n, p in state["vae"].named_parameters()}
    unet0 = {n: p.clone() for n, p in state["unet"].named_parameters()}
    jstate, jlosses = tiny_state, []
    for i in range(STEPS):
        jstate, loss = jstep(jstate, jnp.asarray(emb), jnp.asarray(img),
                             jax.random.PRNGKey(20 + i))
        jlosses.append(float(loss))

    jax_draws(monkeypatch)
    step, _ = ttrain.make_visualizer_train_step(
        ttrain.VisualizerTrainConfig(unfreeze_unet=unfreeze, **TC_KW),
        tucfg, tvcfg)
    losses = []
    for i in range(STEPS):
        state, loss = step(state, _t(emb), _t(img), _gen(20 + i))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert state["opt_adapter"]["count"] == MID_COUNT + STEPS
    assert state["opt_unet"]["count"] == MID_COUNT + (STEPS if unfreeze
                                                      else 0)
    for name, lr in (("adapter", TC_KW["learning_rate"]),
                     ("unet", TC_KW["unet_lr"])):
        _assert_close_trees(jstate[name], tree_to_jax(state[name]),
                            2 * lr * STEPS + 1e-6)
    assert all(torch.equal(p, vae0[n])
               for n, p in state["vae"].named_parameters())
    changed = [n for n, p in state["unet"].named_parameters()
               if not torch.equal(p, unet0[n])]
    assert bool(changed) == unfreeze
    assert all(p.grad is None for t in ("adapter", "unet", "vae")
               for p in state[t].parameters())


def test_plain_adamw_matches_optax_on_equal_gradients(tiny_state):
    """optax.adamw(schedule, b1=0.9, b2=0.999, weight_decay=0.01) from the
    mid-run state, 3 updates on the same gradients: parameters and
    moments at 1e-6."""
    sched = jtrain.lr_schedule(1e-3, 40)
    tx = optax.adamw(sched, b1=0.9, b2=0.999, weight_decay=0.01)
    params, opt = tiny_state["unet"], tiny_state["opt_unet"]
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), jnp.float32), params)
    update = jax.jit(tx.update)
    for _ in range(STEPS):
        upd, opt = update(grads, opt, params)
        params = optax.apply_updates(params, upd)

    port = visualizer_train_state_from_jax(tiny_state, device="cpu")
    tree, state = port["unet"], port["opt_unet"]
    tgrads = visualizer_from_jax_params({}, grads, {}, device="cpu")[1]
    for p, g in zip(tree.parameters(), tgrads.parameters()):
        p.grad = g.data
    ptx = PlainAdamW(ttrain.lr_schedule(1e-3, 40), b1=0.9, b2=0.999,
                     weight_decay=0.01)
    for _ in range(STEPS):
        ptx.update(tree, state)
    assert state["count"] == opt[0].count == MID_COUNT + STEPS
    _assert_close_trees(params, tree_to_jax(tree), ADAM_TOL, ADAM_TOL)
    for key in ("mu", "nu"):
        _assert_close_trees(getattr(opt[0], key),
                            _named_to_jax(tree, state[key]), ADAM_TOL,
                            ADAM_TOL)
    # step 1 of a fresh state runs at lr 0: nothing moves
    fresh = PlainAdamW.init(tree)
    before = [p.clone() for p in tree.parameters()]
    ptx.update(tree, fresh)
    assert all(torch.equal(a, b) for a, b in zip(before, tree.parameters()))


def test_step_needs_one_device_and_a_card_unless_told(monkeypatch):
    _, (tucfg, tvcfg) = _cfgs()
    tc = ttrain.VisualizerTrainConfig()
    # a mesh must span every rank of a process group (one rank here; the
    # data-parallel step itself is held to JAX's in
    # tests/test_torch_sharded_train.py)
    import torch.distributed as dist

    class TwoRanks:
        def size(self):
            return 2

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="must span every rank"):
            ttrain.make_visualizer_train_step(tc, tucfg, tvcfg,
                                              mesh=TwoRanks())
    finally:
        dist.destroy_process_group()
    _, init = ttrain.make_visualizer_train_step(tc, tucfg, tvcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualizer_train_state_from_jax({})
    state = init(device="cpu")
    assert set(state) == {"adapter", "unet", "vae", "opt_adapter",
                          "opt_unet"}
    assert state["opt_unet"]["count"] == 0
    assert not any(p.requires_grad for t in ("adapter", "unet", "vae")
                   for p in state[t].parameters())


# ---- the tar-shard data -----------------------------------------------------

def _png(rng, h, w):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _write_shards(d, n_shards=4, per=3, corrupt=False, sizes=((20, 30),)):
    rng = np.random.default_rng(8)
    paths = []
    for s in range(n_shards):
        path = os.path.join(d, f"shard_{s:02d}.tar")
        with tarfile.open(path, "w") as tf:
            members = [(f"{s}_{i}.png", _png(rng, *sizes[i % len(sizes)]))
                       for i in range(per)]
            members.append((f"{s}_caption.txt", b"not an image"))
            if corrupt and s == 0:
                members.insert(1, (f"{s}_bad.jpg", b"\xff\xd8 truncated"))
            for name, data in members:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        paths.append(path)
    return paths[::-1]          # unsorted: both sort


@pytest.mark.parametrize("count", [1, 3])
def test_iter_tar_shards_matches_jax(tmp_path, count):
    paths = _write_shards(str(tmp_path), n_shards=5, corrupt=True)
    seen = []
    for i in range(count):
        ref = list(jtrain.iter_tar_shards(paths, i, count))
        got = list(ttrain.iter_tar_shards(paths, i, count))
        assert got == ref and got
        seen += got
    # the processes split the shards between them, the last taking the rest
    assert seen == list(jtrain.iter_tar_shards(paths, 0, 1))
    assert len(seen) == 5 * 3 + 1


def test_decode_and_preprocess_matches_jax():
    rng = np.random.default_rng(9)
    for h, w in ((20, 30), (33, 17), (16, 16)):
        raw = _png(rng, h, w)
        ref = jtrain.decode_and_preprocess(raw, 14, 16)
        got = ttrain.decode_and_preprocess(raw, 14, 16)
        for r, g in zip(ref, got):
            assert g.dtype == np.float32 and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        assert got[0].shape == (14, 14, 3) and got[1].shape == (16, 16, 3)
        assert -1.0 <= got[1].min() and got[1].max() <= 1.0
    for fn in (jtrain.decode_and_preprocess, ttrain.decode_and_preprocess):
        with pytest.raises(OSError):
            fn(b"\xff\xd8 truncated", 14, 16)


# ---- the CLI ----------------------------------------------------------------

def _tiny_cli(monkeypatch, d):
    """The port's CLI at tiny widths: the tiny SigLIP (an HF directory
    the test writes), UNet and VAE, a 2-layer 16-wide mlp adapter."""
    from metamorph_tpu_torch import config as tconfig
    from metamorph_tpu_torch.models.hf_import import siglip_params_to_hf
    from metamorph_tpu_torch.models.siglip import Siglip
    from metamorph_tpu_torch.utils.safetensors_io import save_file

    sig_cfg = tconfig.SiglipConfig.tiny()
    siglip = Siglip(sig_cfg, dtype=torch.float32, device="cpu")
    g = _gen(12)
    with torch.no_grad():
        for p in siglip.parameters():
            p.normal_(0.0, 0.05, generator=g)
    os.makedirs(os.path.join(d, "siglip"))
    save_file(siglip_params_to_hf(siglip),
              os.path.join(d, "siglip", "model.safetensors"))
    for mod, cls in ((tconfig, tconfig.SiglipConfig),
                     (tunet, tunet.UNetConfig), (tvae, tvae.VAEConfig)):
        # the class with its tiny() values as the defaults
        monkeypatch.setattr(mod, cls.__name__, functools.partial(
            cls, **dataclasses.asdict(cls.tiny())))
    monkeypatch.setattr(ttrain, "init_adapter", functools.partial(
        tadapter.init_adapter, input_dim=sig_cfg.hidden_size, hidden_dim=16,
        num_layers=2))
    with open(os.path.join(d, "shards.json"), "w") as f:
        json.dump(_write_shards(d, n_shards=2, per=3, corrupt=True,
                                sizes=((20, 30), (28, 28))), f)
    return ["--shards", os.path.join(d, "shards.json"), "--siglip",
            os.path.join(d, "siglip"), "--batch-size", "2", "--resolution",
            "16", "--num-tokens", "4"]


def test_main_trains_and_writes_a_visualizer_jax_reads(tmp_path,
                                                       monkeypatch):
    from metamorph_tpu.inference import loader as jloader
    from metamorph_tpu_torch.inference import loader
    from metamorph_tpu_torch.visualizer import main as tmain

    d = str(tmp_path)
    argv = _tiny_cli(monkeypatch, d)
    out = os.path.join(d, "vis")
    tmain.main(argv + ["--output-dir", out, "--total-steps", "10",
                       "--save-steps", "4", "--device", "cpu"])
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [10]
    assert np.isfinite(rows[0]["loss"]) and rows[0]["it_per_s"] > 0
    a, u, v, ucfg, vcfg, mode = loader.load_visualization(out, device="cpu")
    assert (ucfg, vcfg, mode) == (UCFG_TINY, VCFG_TINY, "mlp")
    # the adapter trained; the frozen UNet and VAE are their seeds' init
    _, init = ttrain.make_visualizer_train_step(
        ttrain.VisualizerTrainConfig(num_tokens=4), ucfg, vcfg)
    s0 = init(0, device="cpu")
    assert not all(torch.equal(p, q) for p, q in zip(
        a.parameters(), s0["adapter"].parameters()))
    for tree, ref in ((u, s0["unet"]), (v, s0["vae"])):
        want = dict(ref.named_parameters())
        assert all(torch.equal(p, want[n]) for n, p in tree.named_parameters())
    # JAX's loader reads the directory, bit for bit
    ref = jloader.load_visualization(out)
    for port, jt in zip((a, u, v), ref[:3]):
        _assert_close_trees(jax.tree.map(np.asarray, jt), tree_to_jax(port),
                            0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tmain.main(argv + ["--output-dir", out, "--total-steps", "1"])


def test_jax_cli_reads_an_undefined_argument(tmp_path, monkeypatch):
    """JAX's CLI reads `args.unet_path` (`visualizer/main.py:78`), which
    its parser never defines: every run raises once SigLIP is loaded. The
    port reads `args.sd is None` (see the test above, which runs without
    --sd and trains)."""
    from metamorph_tpu.models import hf_import as jhf
    from metamorph_tpu.visualizer import main as jmain

    monkeypatch.setattr(jhf, "load_safetensors_dir", lambda path: {})
    monkeypatch.setattr(jhf, "siglip_params_from_hf", lambda *a, **k: {})
    shard = _write_shards(str(tmp_path), n_shards=1, per=1)[0]
    with pytest.raises(AttributeError, match="unet_path"):
        jmain.main(["--shards", shard, "--siglip", str(tmp_path)])
    assert "unet_path" not in vars(jmain.parse_args(
        ["--shards", shard, "--siglip", str(tmp_path)]))
