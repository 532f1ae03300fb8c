"""PyTorch port, the visualizer's weights and front end on the CPU, held to
the JAX package: `convert.visualizer_from_jax_params` and back, the
diffusers-format dicts (`visualizer/hf_import.py`) and a diffusers
directory, visualizer checkpoints written by either package and loaded by
the other, and the demo's `render_chunks` and `--visualizer`.

Trees are the JAX package's (`seeded_tree` of tests/test_torch_visualizer.py:
the keys and shapes of JAX's init, filled from numpy seeds). Weights and
dicts must cross bit for bit; forwards are held to rtol = atol = 1e-4 and
rendered images to 1e-3, as in tests/test_torch_visualizer.py."""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.inference import loader as jloader
from metamorph_tpu.visualizer import adapter as jadapter
from metamorph_tpu.visualizer import hf_import as jhf
from metamorph_tpu.visualizer import pipeline as jpipeline
from metamorph_tpu.visualizer import unet as junet
from metamorph_tpu.visualizer import vae as jvae
from metamorph_tpu_torch.convert import (visualizer_from_jax_params,
                                         visualizer_to_jax_params)
from metamorph_tpu_torch.inference import demo, loader
from metamorph_tpu_torch.visualizer import hf_import as thf
from metamorph_tpu_torch.visualizer.params import tree_to_jax
from metamorph_tpu_torch.visualizer import unet as tunet
from metamorph_tpu_torch.visualizer import vae as tvae
from tests.test_torch_visualizer import (IMG_TOL, MOD_TOL, SMALL4, VAE4,
                                         jax_jitted, jax_latents, jit_unet,
                                         jit_vae_encode, seeded_tree)

UCFGS = {"tiny": (junet.UNetConfig.tiny(), tunet.UNetConfig.tiny()),
         "small4": (junet.UNetConfig(**SMALL4), tunet.UNetConfig(**SMALL4))}
VCFGS = {"tiny": (jvae.VAEConfig.tiny(), tvae.VAEConfig.tiny()),
         "four_levels": (jvae.VAEConfig(**VAE4), tvae.VAEConfig(**VAE4))}


def _unet(name):
    return seeded_tree(junet.init_unet_params, UCFGS[name][0])


def _vae(name):
    return seeded_tree(jvae.init_vae_params, VCFGS[name][0], seed=1)


def _adapter(mode="mlp", out=16):
    return seeded_tree(jadapter.init_adapter, mode=mode, input_dim=12,
                       hidden_dim=16, output_dim=out, num_tokens=5,
                       num_layers=2, num_heads=2, seed=2)


def _port(*trees, **kw):
    return visualizer_from_jax_params(*trees, device="cpu", **kw)


def _assert_trees_equal(a, b):
    none = lambda x: x is None  # noqa: E731
    assert (jax.tree.structure(a, is_leaf=none)
            == jax.tree.structure(b, is_leaf=none))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _np_dict(sd):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items()}


def _torch_dict(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


# ---- convert -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mlp", "transformer"])
def test_convert_round_trip_is_bitwise(mode):
    trees = (_adapter(mode), _unet("small4"), _vae("four_levels"))
    port = _port(*trees)
    assert port[1]["down"][3]["attns"] is None
    # torch layouts inside: conv [out, in, kh, kw], dense [in, out]
    assert port[1]["conv_in"]["kernel"].shape == (8, 4, 3, 3)
    assert port[1]["time_mlp"]["fc1"]["kernel"].shape == (8, 32)
    for back, ref in zip(visualizer_to_jax_params(*port), trees):
        _assert_trees_equal(back, ref)
    # bf16 weights: the JAX trees rounded to bf16, then held as fp32
    half = _port(*trees, dtype=torch.bfloat16)
    assert half[1]["conv_in"]["kernel"].dtype == torch.bfloat16
    for back, ref in zip(visualizer_to_jax_params(*half), trees):
        _assert_trees_equal(back, jax.tree.map(
            lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
            ref))


# ---- diffusers format -------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "small4"])
def test_unet_hf_dicts_match_jax(name):
    jcfg, tcfg = UCFGS[name]
    jp = _unet(name)
    _, tp, _ = _port({}, jp, {})
    ref = jhf.unet_params_to_hf(jp, jcfg)
    out = _np_dict(thf.unet_params_to_hf(tp, tcfg))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    # JAX's dict in: JAX's tree (attns None included) and JAX's forward
    back = thf.unet_params_from_hf(_torch_dict(ref), tcfg, device="cpu")
    _assert_trees_equal(tree_to_jax(back), jp)
    if name == "tiny":
        rng = np.random.default_rng(1)
        x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
        ctx = rng.standard_normal((1, 7, 16)).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(jit_unet(jp, jcfg, jnp.asarray(x), jnp.asarray([10]),
                                jnp.asarray(ctx))),
            tunet.unet_apply(back, tcfg, torch.from_numpy(x),
                             torch.tensor([10]), torch.from_numpy(ctx)),
            rtol=MOD_TOL, atol=MOD_TOL)


@pytest.mark.parametrize("name", ["tiny", "four_levels"])
def test_vae_hf_dicts_match_jax(name):
    jcfg, tcfg = VCFGS[name]
    jp = _vae(name)
    _, _, tp = _port({}, {}, jp)
    ref = jhf.vae_params_to_hf(jp, jcfg)
    out = _np_dict(thf.vae_params_to_hf(tp, tcfg))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    back = thf.vae_params_from_hf(_torch_dict(ref), tcfg, device="cpu")
    _assert_trees_equal(tree_to_jax(back), jp)
    # older diffusers files name the mid attention query/key/value/proj_attn
    old = {k.replace(".to_q.", ".query.").replace(".to_k.", ".key.")
           .replace(".to_v.", ".value.").replace(".to_out.0.", ".proj_attn."):
           v for k, v in ref.items()}
    assert "decoder.mid_block.attentions.0.proj_attn.weight" in old
    back_old = thf.vae_params_from_hf(_torch_dict(old), tcfg, device="cpu")
    _assert_trees_equal(tree_to_jax(back_old), jp)
    if name == "tiny":
        img = np.random.default_rng(2).uniform(-1, 1, (1, 8, 8, 3)).astype(
            np.float32)
        np.testing.assert_allclose(
            np.asarray(jit_vae_encode(jp, jcfg, jnp.asarray(img))),
            tvae.vae_encode(back, tcfg, torch.from_numpy(img)),
            rtol=MOD_TOL, atol=MOD_TOL)


def test_from_hf_checks_shapes():
    jcfg, tcfg = UCFGS["tiny"]
    sd = _torch_dict(jhf.unet_params_to_hf(_unet("tiny"), jcfg))
    sd["conv_in.weight"] = sd["conv_in.weight"][:, :3]
    with pytest.raises(ValueError, match="conv_in.weight"):
        thf.unet_params_from_hf(sd, tcfg, device="cpu")


def test_load_diffusers_directory(tmp_path):
    """A diffusers pipeline directory (configs as diffusers writes them)
    loads with its configs read from config.json."""
    from safetensors.numpy import save_file

    jucfg, tucfg = UCFGS["small4"]
    jvcfg, tvcfg = VCFGS["four_levels"]
    ju, jv = _unet("small4"), _vae("four_levels")
    unet_json = {"_class_name": "UNet2DConditionModel", "in_channels": 4,
                 "out_channels": 4, "block_out_channels": [8, 16, 24, 24],
                 "layers_per_block": 2, "cross_attention_dim": 8,
                 "attention_head_dim": 2, "norm_num_groups": 4,
                 "down_block_types": ["CrossAttnDownBlock2D"] * 3
                 + ["DownBlock2D"]}
    vae_json = {"_class_name": "AutoencoderKL", "in_channels": 3,
                "latent_channels": 4, "block_out_channels": [8, 16, 16, 16],
                "layers_per_block": 1, "norm_num_groups": 4,
                "scaling_factor": 0.18215}
    for sub, sd, cfg in (("unet", jhf.unet_params_to_hf(ju, jucfg), unet_json),
                         ("vae", jhf.vae_params_to_hf(jv, jvcfg), vae_json)):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "config.json").write_text(json.dumps(cfg))
        save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
                  str(tmp_path / sub / "diffusion_pytorch_model.safetensors"))
    unet, vae, ucfg, vcfg = thf.load_diffusers(str(tmp_path), device="cpu")
    assert ucfg == tucfg and vcfg == tvcfg
    u, v = tree_to_jax(unet), tree_to_jax(vae)
    _assert_trees_equal(u, ju)
    _assert_trees_equal(v, jv)
    assert thf.unet_config_from_hf({}) == tunet.UNetConfig()
    assert thf.vae_config_from_hf({}) == tvae.VAEConfig()


# ---- visualizer checkpoints ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vis():
    return (_adapter("xattn"), _unet("small4"), _vae("four_levels"))


def test_checkpoint_from_jax_loads_bitwise(tmp_path, jax_vis):
    jucfg, tucfg = UCFGS["small4"]
    jvcfg, tvcfg = VCFGS["four_levels"]
    jloader.save_visualizer(str(tmp_path), *jax_vis, jucfg, jvcfg, "xattn")
    a, u, v, ucfg, vcfg, mode = loader.load_visualization(str(tmp_path),
                                                          device="cpu")
    assert (ucfg, vcfg, mode) == (tucfg, tvcfg, "xattn")
    assert u["down"][3].get("attns") is None
    ref = jloader.load_visualization(str(tmp_path))
    for port, jax_tree in zip(visualizer_to_jax_params(a, u, v), ref[:3]):
        _assert_trees_equal(port, jax.tree.map(np.asarray, jax_tree))


def test_checkpoint_to_jax_loads_bitwise(tmp_path, jax_vis):
    from safetensors.numpy import load_file

    jucfg, tucfg = UCFGS["small4"]
    jvcfg, tvcfg = VCFGS["four_levels"]
    port = _port(*jax_vis)
    loader.save_visualizer(str(tmp_path / "port"), *port, tucfg, tvcfg,
                           "xattn")
    jloader.save_visualizer(str(tmp_path / "jax"), *jax_vis, jucfg, jvcfg,
                            "xattn")
    for name in ("adapter", "unet", "vae"):   # the same keys and arrays
        ours = load_file(str(tmp_path / "port" / f"{name}.safetensors"))
        theirs = load_file(str(tmp_path / "jax" / f"{name}.safetensors"))
        assert sorted(ours) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert (json.loads((tmp_path / "port" / "visualizer_config.json")
                       .read_text())
            == json.loads((tmp_path / "jax" / "visualizer_config.json")
                          .read_text()))
    a, u, v, ucfg, vcfg, mode = jloader.load_visualization(
        str(tmp_path / "port"))
    assert (ucfg, vcfg, mode) == (jucfg, jvcfg, "xattn")
    for got, ref in zip((a, u, v), jax_vis):
        np.testing.assert_equal(jax.tree.map(np.asarray, got),
                                jloader.unflatten_tree(
                                    jloader.flatten_tree(ref)))


def test_load_visualization_needs_a_card_unless_told_cpu(tmp_path, monkeypatch,
                                                         jax_vis):
    jloader.save_visualizer(str(tmp_path), *jax_vis, UCFGS["small4"][0],
                            VCFGS["four_levels"][0], "xattn")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_visualization(str(tmp_path))
    a, u, v, *_ = loader.load_visualization(str(tmp_path),
                                            dtype=torch.bfloat16,
                                            device="cpu")
    assert {p.dtype for t in (a, u, v) for p in t.parameters()} == {
        torch.bfloat16}


# ---- the demo --------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_vis():
    """A tiny visualizer as JAX trees, with the 12-wide mlp adapter."""
    return (_adapter("mlp"), _unet("tiny"), _vae("tiny"))


def test_render_chunks_matches_jax_demo(tmp_path, monkeypatch, demo_vis):
    """Two 4-token chunks through the demo's work function against the JAX
    demo's loop (`metamorph_tpu/inference/demo.py`: `render_multi_scale`
    with `PRNGKey(c)` per chunk), written under the JAX demo's names."""
    jax_latents(monkeypatch)
    jax_jitted(monkeypatch)
    K = 4
    embeds = np.random.default_rng(5).standard_normal((2 * K, 12)).astype(
        np.float32)
    jucfg, tucfg = UCFGS["tiny"]
    jvcfg, tvcfg = VCFGS["tiny"]
    port = _port(*demo_vis)
    out = demo.render_chunks(embeds, (*port, tucfg, tvcfg, "mlp"),
                             str(tmp_path), "pndm", 2, K, latent_size=8)
    assert len(out) == 2
    for c in range(2):
        ref = jpipeline.render_multi_scale(
            *demo_vis, jucfg, jvcfg, jnp.asarray(embeds[None, c * K:(c + 1) * K]),
            jax.random.PRNGKey(c), adapter_mode="mlp", scheduler="pndm",
            num_inference_steps=2, latent_size=8)
        assert out[c].shape == (4, 16, 16, 3)
        np.testing.assert_allclose(out[c], np.asarray(ref[0]), rtol=IMG_TOL,
                                   atol=IMG_TOL)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"gen_{c}_scale{gi}.png" for c in range(2) for gi in range(4)]
    from PIL import Image

    png = np.asarray(Image.open(tmp_path / "gen_1_scale3.png"))
    np.testing.assert_array_equal(png, (out[1][3] * 255).astype(np.uint8))


def test_demo_main_renders_with_visualizer(tmp_path, monkeypatch, demo_vis):
    """`main --visualizer DIR` loads the visualizer and renders every
    generated chunk (the decode stubbed to give two chunks of K=4)."""
    from metamorph_tpu_torch.config import MetaMorphConfig

    jucfg, tucfg = UCFGS["tiny"]
    jvcfg, tvcfg = VCFGS["tiny"]
    loader.save_visualizer(str(tmp_path / "vis"), *_port(*demo_vis), tucfg,
                           tvcfg, "mlp")
    cfg = MetaMorphConfig()
    cfg = dataclasses.replace(cfg, mm=dataclasses.replace(cfg.mm,
                                                          num_image_tokens=4))
    embeds = np.random.default_rng(6).standard_normal((8, 12)).astype(
        np.float32)
    seen = {}
    monkeypatch.setattr(loader, "load_pretrained_model",
                        lambda *a, **k: (None, cfg))
    monkeypatch.setattr(demo, "load_hf_tokenizer",
                        lambda *a: types.SimpleNamespace(bos_token_id=1))
    monkeypatch.setattr(demo, "load_frames", lambda path: [])
    monkeypatch.setattr(demo, "run", lambda *a, **k: {
        "text": "", "ids": [], "n_image_tokens": 8, "image_embeds": embeds})
    render = demo.render_chunks

    def small(*a, **k):          # latents 8 x 8 instead of 64 x 64
        seen["args"] = a
        return render(*a, latent_size=8, **k)

    monkeypatch.setattr(demo, "render_chunks", small)
    common = ["--model-path", "m", "--tokenizer", "t", "--image", "x.png",
              "--visualizer", str(tmp_path / "vis"), "--render-scheduler",
              "ddim", "--render-steps", "2", "--out-dir",
              str(tmp_path / "out")]
    with pytest.raises(SystemExit):        # the scheduler is checked
        demo.main([("euler" if a == "ddim" else a) for a in common]
                  + ["--device", "cpu"])
    demo.main(common + ["--device", "cpu"])
    assert seen["args"][3:] == ("ddim", 2, 4)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        f"gen_{c}_scale{gi}.png" for c in range(2) for gi in range(4)]
