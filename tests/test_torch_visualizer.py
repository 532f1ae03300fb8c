"""PyTorch port, the visualizer's render path on the CPU in fp32, held to the
JAX package: the schedulers step by step, the adapter in all four modes,
the UNet, the VAE and `render` with each scheduler.

Weights fill the trees the JAX package's init makes (`jax.eval_shape`:
its keys, shapes and `attns: None`) from numpy seeds at JAX's scales
(`seeded_tree`; the norm scales and biases moved off one and zero), and
cross through `convert.visualizer_from_jax_params`; inputs come from
numpy seeds. Where
a run draws its starting noise, the port's `pipeline.initial_latents` is
replaced by JAX's own draw (`jax.random.normal(rng, shape)`, what JAX's
`render` makes), so both loops start equal.

Tolerances: 1e-5 relative on a scheduler step (the same float32 or
float64 coefficients, applied in another order); rtol = atol = 1e-4 on a
module's output (fp32 sums in another order through up to ~30 layers);
1e-3 on rendered images (a few UNet calls, each amplified by the
guidance scale, then the VAE)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.visualizer import adapter as jadapter
from metamorph_tpu.visualizer import pipeline as jpipeline
from metamorph_tpu.visualizer import scheduler as jsched
from metamorph_tpu.visualizer import unet as junet
from metamorph_tpu.visualizer import vae as jvae
from metamorph_tpu_torch.convert import (visualizer_from_jax_params,
                                         visualizer_to_jax_params)
from metamorph_tpu_torch.visualizer import adapter as tadapter
from metamorph_tpu_torch.visualizer import pipeline as tpipeline
from metamorph_tpu_torch.visualizer import scheduler as tsched
from metamorph_tpu_torch.visualizer import unet as tunet
from metamorph_tpu_torch.visualizer import vae as tvae

STEP_RTOL = 1e-5
MOD_TOL = 1e-4
IMG_TOL = 1e-3

# the 4-level UNet of tests/test_visualizer_hf.py (SD-1.5's topology)
SMALL4 = dict(block_out_channels=(8, 16, 24, 24), layers_per_block=2,
              cross_attention_dim=8, attention_head_dim=2, norm_groups=4,
              attn_levels=(True, True, True, False))
VAE4 = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
            norm_groups=4)


# JAX's UNet and VAE jitted: eagerly they dispatch op by op (~10 s for
# one tiny UNet call on the CPU); the render loops call them through
# `jax_jitted`. The functions under test are the same.
jit_unet = jax.jit(junet.unet_apply, static_argnums=1)
jit_vae_encode = jax.jit(jvae.vae_encode, static_argnums=1)
jit_vae_decode = jax.jit(jvae.vae_decode, static_argnums=1)


def seeded_tree(init_fn, *args, seed=0, **kw):
    """The tree JAX's `init_fn` makes (its keys, shapes and `attns: None`,
    from `jax.eval_shape`, which draws nothing) filled from a numpy seed:
    kernels uniform within +-fan_in**-0.5 as JAX draws them, norm scales
    1 + N(0, 0.1), other vectors U(-0.1, 0.1), learned tokens N(0, 1).
    JAX's own init, eager or jitted, costs 10-40 s per config on the
    CPU (one XLA compile per op shape)."""
    shapes = jax.eval_shape(lambda k: init_fn(k, *args, **kw),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if "scale" in name:
            x = 1 + 0.1 * rng.standard_normal(shape)
        elif "kernel" in name:
            x = rng.uniform(-1, 1, shape) * np.prod(shape[:-1]) ** -0.5
        elif len(shape) == 1:
            x = rng.uniform(-0.1, 0.1, shape)
        else:
            x = rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_jitted(monkeypatch):
    """JAX's render (and demo) loops call the jitted UNet and VAE."""
    monkeypatch.setattr(jpipeline, "unet_apply", jit_unet)
    monkeypatch.setattr(jpipeline, "vae_decode", jit_vae_decode)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _port(adapter, unet, vae):
    return visualizer_from_jax_params(
        *(jax.tree.map(np.asarray, t) for t in (adapter, unet, vae)),
        device="cpu")


def jax_latents(monkeypatch):
    """The port's starting noise replaced by JAX's draw for the key the
    generator was seeded with."""
    def draw(generator, shape):
        key = jax.random.PRNGKey(generator.initial_seed())
        return _t(jax.random.normal(key, shape, jnp.float32))

    monkeypatch.setattr(tpipeline, "initial_latents", draw)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# ---- configs -----------------------------------------------------------------

@pytest.mark.parametrize("pair", [
    (junet.UNetConfig, tunet.UNetConfig), (jvae.VAEConfig, tvae.VAEConfig),
    (jsched.SchedulerConfig, tsched.SchedulerConfig)])
def test_config_copies_match_jax(pair):
    j, t = pair
    assert ([(f.name, f.default) for f in dataclasses.fields(j)]
            == [(f.name, f.default) for f in dataclasses.fields(t)])
    if hasattr(j, "tiny"):
        assert dataclasses.asdict(j.tiny()) == dataclasses.asdict(t.tiny())
    if j is junet.UNetConfig:
        assert j().time_embed_dim == t().time_embed_dim == 1280


# ---- schedulers ----------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["scaled_linear", "linear"])
def test_scheduler_tables_match_jax(schedule):
    jc = jsched.SchedulerConfig(beta_schedule=schedule)
    tc = tsched.SchedulerConfig(beta_schedule=schedule)
    np.testing.assert_array_equal(jsched.make_betas(jc), tsched.make_betas(tc))
    jd, td = jsched.DDPMScheduler(jc), tsched.DDPMScheduler(tc)
    for name in ("alphas_cumprod", "betas", "alphas"):
        assert getattr(td, name).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(getattr(jd, name)),
                                      getattr(td, name))
    np.testing.assert_array_equal(
        np.asarray(jsched.DDIMScheduler(jc).alphas_cumprod),
        tsched.DDIMScheduler(tc).alphas_cumprod)
    jp, tp = jsched.PNDMScheduler(jc), tsched.PNDMScheduler(tc)
    assert tp.alphas_cumprod.dtype == np.float64
    np.testing.assert_array_equal(jp.alphas_cumprod, tp.alphas_cumprod)
    jm, tm = jsched.DPMSolverPlusPlusScheduler(jc), \
        tsched.DPMSolverPlusPlusScheduler(tc)
    for name in ("alpha", "sigma", "lam"):
        np.testing.assert_array_equal(getattr(jm, name), getattr(tm, name))
    for n in (1, 5, 20, 50):
        np.testing.assert_array_equal(jp.set_timesteps(n), tp.set_timesteps(n))
        np.testing.assert_array_equal(jsched.DDIMScheduler(jc).timesteps(n),
                                      tsched.DDIMScheduler(tc).timesteps(n))
        np.testing.assert_array_equal(jm.set_timesteps(n), tm.set_timesteps(n))
    assert list(tp.set_timesteps(50)[:4]) == [981, 961, 961, 941]


def test_ddpm_add_noise_and_step_match_jax():
    rng = np.random.default_rng(0)
    x0, noise, out = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
                      for _ in range(3))
    jd, td = jsched.DDPMScheduler(), tsched.DDPMScheduler()
    t = np.array([0, 500, 999])
    _close(jd.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)),
           td.add_noise(_t(x0), _t(noise), torch.from_numpy(t)), STEP_RTOL)
    for step in (0, 1, 500, 999):
        _close(jd.step(jnp.asarray(out), step, jnp.asarray(x0)),
               td.step(_t(out), step, _t(x0)), STEP_RTOL)
    # with a generator: the mean plus sqrt(var) times the generator's draw
    mean = td.step(_t(out), 500, _t(x0))
    noisy = td.step(_t(out), 500, _t(x0), generator=_gen(3))
    draw = torch.randn(x0.shape, generator=_gen(3))
    a, a1 = td.alphas_cumprod[500], td.alphas_cumprod[499]
    var = td.betas[500] * (1 - a1) / (1 - a)
    _close(noisy, mean + float(np.sqrt(var)) * draw, STEP_RTOL)
    assert torch.equal(td.step(_t(out), 0, _t(x0), generator=_gen(3)),
                       td.step(_t(out), 0, _t(x0)))


def _outputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("steps", [5, 1])
def test_pndm_step_by_step_matches_jax(steps):
    """Every call of a whole run, the repeated timestep and the first two
    calls' shared sample included; the scheduler's state after each."""
    jp, tp = jsched.PNDMScheduler(), tsched.PNDMScheduler()
    ts = jp.set_timesteps(steps)
    tp.set_timesteps(steps)
    x0 = _outputs(1, 7)[0]
    js, tsample = jnp.asarray(x0), _t(x0)
    for i, (t, eps) in enumerate(zip(ts, _outputs(len(ts)))):
        js = jp.step(jnp.asarray(eps), int(t), js)
        tsample = tp.step(_t(eps), int(t), tsample)
        _close(js, tsample, STEP_RTOL)
        assert tp.counter == jp.counter == i + 1
        assert len(tp.ets) == len(jp.ets)
        assert (tp.cur_sample is None) == (jp.cur_sample is None)
        if i == 0:       # the first call keeps its input for the second
            assert torch.equal(tp.cur_sample, _t(x0))


def test_ddim_step_by_step_matches_jax():
    jd, td = jsched.DDIMScheduler(), tsched.DDIMScheduler()
    ts = jd.timesteps(6)
    js = jnp.asarray(_outputs(1, 7)[0])
    tsample = _t(np.asarray(js))
    for i, (t, eps) in enumerate(zip(ts, _outputs(len(ts)))):
        t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
        js = jd.step(jnp.asarray(eps), int(t), t_prev, js)
        tsample = td.step(_t(eps), int(t), t_prev, tsample)
        _close(js, tsample, STEP_RTOL)


@pytest.mark.parametrize("grid", [None, [999, 700, 420, 200, 50, 3]])
def test_dpmpp_step_by_step_matches_jax(grid):
    """Uniform and custom grids to the last step, which returns x0."""
    jm, tm = jsched.DPMSolverPlusPlusScheduler(), \
        tsched.DPMSolverPlusPlusScheduler()
    if grid is None:
        ts = jm.set_timesteps(6)
        tm.set_timesteps(6)
    else:
        ts = jm.set_custom_timesteps(grid)
        tm.set_custom_timesteps(grid)
    js = jnp.asarray(_outputs(1, 7)[0])
    tsample = _t(np.asarray(js))
    for t, eps in zip(ts, _outputs(len(ts))):
        js = jm.step(jnp.asarray(eps), int(t), js)
        tsample = tm.step(_t(eps), int(t), tsample)
        _close(js, tsample, STEP_RTOL)
    assert tm._i == len(ts)


# ---- adapter -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mlp", "xattn", "xattnffn", "transformer"])
def test_adapter_modes_match_jax(mode):
    jp = seeded_tree(jadapter.init_adapter, mode=mode, input_dim=24,
                     hidden_dim=32, output_dim=16, num_tokens=11,
                     num_layers=3, num_heads=2)
    tp, _, _ = _port(jp, {}, {})
    x = np.random.default_rng(1).standard_normal((2, 5, 24)).astype(np.float32)
    ref = jadapter.apply_adapter(jp, jnp.asarray(x), mode=mode, num_heads=2)
    out = tadapter.apply_adapter(tp, _t(x), mode=mode, num_heads=2)
    assert out.shape == ref.shape == ((2, 5, 16) if mode == "mlp"
                                      else (2, 11, 16))
    _close(ref, out, MOD_TOL)


@pytest.mark.parametrize("T", [64, 77, 80])
def test_pad_tokens_matches_jax(T):
    x = np.random.default_rng(T).standard_normal((2, T, 8)).astype(np.float32)
    ref = jadapter.pad_tokens(jnp.asarray(x), 77)
    out = tadapter.pad_tokens(_t(x), 77)
    assert out.shape == (2, 77, 8)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_init_matches_jax_trees():
    """The port's init makes JAX's trees (keys, shapes, `attns: None`) at
    JAX's scales: kernels and biases within +-fan_in**-0.5, norms ones and
    zeros."""
    ucfg = tunet.UNetConfig(**SMALL4)
    trees = (tadapter.init_adapter("xattnffn", 24, 32, 16, 11, 2, 2,
                                   device="cpu"),
             tunet.init_unet_params(ucfg, device="cpu"),
             tvae.init_vae_params(tvae.VAEConfig(**VAE4), device="cpu"))
    refs = (seeded_tree(jadapter.init_adapter, "xattnffn", 24, 32, 16, 11, 2,
                        2),
            seeded_tree(junet.init_unet_params, junet.UNetConfig(**SMALL4)),
            seeded_tree(jvae.init_vae_params, jvae.VAEConfig(**VAE4)))
    for port, ref in zip(visualizer_to_jax_params(*trees), refs):
        assert (jax.tree.structure(port, is_leaf=lambda x: x is None)
                == jax.tree.structure(ref, is_leaf=lambda x: x is None))
        flat_p = jax.tree_util.tree_flatten_with_path(port)[0]
        flat_r = jax.tree.leaves(ref)
        for (path, p), r in zip(flat_p, flat_r):
            assert p.shape == r.shape
            name = jax.tree_util.keystr(path)
            if "scale" in name:
                assert (p == 1).all()
            elif "norm" in name and "bias" in name:
                assert (p == 0).all()
            elif "token_embeddings" not in name:
                fan_in = (np.prod(p.shape[:-1]) if "kernel" in name
                          else None)
                if fan_in is not None:
                    assert np.abs(p).max() <= fan_in ** -0.5
                    assert np.abs(p).max() > 0.5 * fan_in ** -0.5
    assert trees[1]["down"][3].get("attns") is None
    assert trees[1]["down"][0]["attns"] is not None


# ---- UNet, VAE -----------------------------------------------------------------

def test_upsample_matches_jax_resize():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method="nearest")
    out = tunet.upsample_nearest(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 481, 999])
    _close(junet.timestep_embedding(jnp.asarray(t), 32),
           tunet.timestep_embedding(torch.from_numpy(t), 32), MOD_TOL)


@pytest.mark.parametrize("cfg", [None, SMALL4], ids=["tiny", "small4"])
def test_unet_apply_matches_jax(cfg):
    jcfg = junet.UNetConfig(**cfg) if cfg else junet.UNetConfig.tiny()
    tcfg = tunet.UNetConfig(**cfg) if cfg else tunet.UNetConfig.tiny()
    jp = seeded_tree(junet.init_unet_params, jcfg)
    _, tp, _ = _port({}, jp, {})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, jcfg.cross_attention_dim)).astype(
        np.float32)
    t = np.array([3, 500])
    ref = jit_unet(jp, jcfg, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(ctx))
    out = tunet.unet_apply(tp, tcfg, _t(x), torch.from_numpy(t), _t(ctx))
    assert out.shape == x.shape
    _close(ref, out, MOD_TOL)


@pytest.mark.parametrize("cfg", [None, VAE4], ids=["tiny", "four_levels"])
def test_vae_encode_decode_match_jax(cfg):
    jcfg = jvae.VAEConfig(**cfg) if cfg else jvae.VAEConfig.tiny()
    tcfg = tvae.VAEConfig(**cfg) if cfg else tvae.VAEConfig.tiny()
    jp = seeded_tree(jvae.init_vae_params, jcfg)
    _, _, tp = _port({}, {}, jp)
    img = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    ref = jit_vae_encode(jp, jcfg, jnp.asarray(img))
    lat = tvae.vae_encode(tp, tcfg, _t(img))
    _close(ref, lat, MOD_TOL)
    _close(jit_vae_decode(jp, jcfg, ref), tvae.vae_decode(tp, tcfg, lat),
           MOD_TOL)
    # a posterior sample: the mean moved by the generator's draw
    drawn = tvae.vae_encode(tp, tcfg, _t(img), generator=_gen(0))
    assert drawn.shape == lat.shape and torch.isfinite(drawn).all()
    assert not torch.equal(drawn, lat)
    assert torch.equal(drawn, tvae.vae_encode(tp, tcfg, _t(img),
                                              generator=_gen(0)))


# ---- render ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vis():
    ucfg, vcfg = junet.UNetConfig.tiny(), jvae.VAEConfig.tiny()
    return (seeded_tree(jadapter.init_adapter, mode="mlp", input_dim=12,
                        hidden_dim=16, output_dim=ucfg.cross_attention_dim,
                        num_layers=2, seed=2),
            seeded_tree(junet.init_unet_params, ucfg),
            seeded_tree(jvae.init_vae_params, vcfg, seed=1))


@pytest.fixture(scope="module")
def embeds():
    return np.random.default_rng(3).standard_normal((1, 4, 12)).astype(
        np.float32)


@pytest.mark.parametrize("scheduler,steps", [("pndm", 5), ("ddim", 4),
                                             ("dpmpp", 4)])
def test_render_matches_jax(monkeypatch, jax_vis, embeds, scheduler, steps):
    jax_latents(monkeypatch)
    jax_jitted(monkeypatch)
    kw = dict(guidance_scale=7.5, num_inference_steps=steps, latent_size=8,
              scheduler=scheduler)
    ref = jpipeline.render(*jax_vis, junet.UNetConfig.tiny(),
                           jvae.VAEConfig.tiny(), jnp.asarray(embeds),
                           jax.random.PRNGKey(4), **kw)
    out = tpipeline.render(*_port(*jax_vis), tunet.UNetConfig.tiny(),
                           tvae.VAEConfig.tiny(), _t(embeds), _gen(4), **kw)
    assert out.shape == (1, 16, 16, 3) and out.dtype == torch.float32
    assert 0.0 <= out.min() and out.max() <= 1.0
    _close(ref, out, IMG_TOL)


def test_render_multi_scale_matches_jax(monkeypatch, jax_vis, embeds):
    port = _port(*jax_vis)
    cfgs = (tunet.UNetConfig.tiny(), tvae.VAEConfig.tiny())
    kw = dict(num_inference_steps=3, latent_size=8, scheduler="ddim")
    # every scale starts from the same noise: equal scales, equal images
    same = tpipeline.render_multi_scale(*port, *cfgs, _t(embeds), _gen(9),
                                        guidance_scales=(7.5, 7.5), **kw)
    assert torch.equal(same[:, 0], same[:, 1])
    jax_latents(monkeypatch)
    jax_jitted(monkeypatch)
    ref = jpipeline.render_multi_scale(
        *jax_vis, junet.UNetConfig.tiny(), jvae.VAEConfig.tiny(),
        jnp.asarray(embeds), jax.random.PRNGKey(5),
        guidance_scales=(1.0, 12.5), **kw)
    out = tpipeline.render_multi_scale(*port, *cfgs, _t(embeds), _gen(5),
                                       guidance_scales=(1.0, 12.5), **kw)
    assert out.shape == ref.shape == (1, 2, 16, 16, 3)
    _close(ref, out, IMG_TOL)


def test_render_rejects_unknown_scheduler(jax_vis, embeds):
    with pytest.raises(ValueError, match="unknown scheduler"):
        tpipeline.render(*_port(*jax_vis), tunet.UNetConfig.tiny(),
                         tvae.VAEConfig.tiny(), _t(embeds), _gen(0),
                         scheduler="euler")


def test_init_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tunet.init_unet_params(tunet.UNetConfig.tiny()),
                 lambda: tvae.init_vae_params(tvae.VAEConfig.tiny()),
                 lambda: tadapter.init_adapter(),
                 lambda: visualizer_from_jax_params({}, {}, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tunet.init_unet_params(tunet.UNetConfig.tiny(), device="cpu")[
        "conv_in"]["kernel"].device.type == "cpu"
