"""PyTorch port, anyres and the other token reductions: the merge plans,
the anyres dataset and collator, `reduce_tokens` in its `mlpmixer` and
`concat_interpolation` modes, the view_map image-token table with the
learned `image_newline`, the anyres training forward, and the conversion
of `siglip_mixer` and `image_newline` both ways, each against the JAX
package on the CPU.

The rows are tokenized by chip_smoke.py's word tokenizer, whose ids fit
the vocabulary. Tolerances: the host plans and batches are held to exact equality;
`reduce_tokens` to 1e-5 max abs in fp32; the image-token table and the
anyres forward's metrics to the tolerances of tests/test_torch_train.py
(1e-5 relative, 1e-6 absolute), on the same fp32 weights."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import word_tokenize
from metamorph_tpu.config import LlamaConfig as JLlamaConfig
from metamorph_tpu.config import MetaMorphConfig as JConfig
from metamorph_tpu.config import MultimodalConfig as JMM
from metamorph_tpu.config import SiglipConfig as JSiglipConfig
from metamorph_tpu.config import TrainConfig as JTrainConfig
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu.models import siglip as JS
from metamorph_tpu.multimodal import anyres as JA
from metamorph_tpu.multimodal import native as JN
from metamorph_tpu.train import data as JD
from metamorph_tpu_torch.config import MetaMorphConfig, MultimodalConfig
from metamorph_tpu_torch.convert import (from_jax_params, init_params,
                                         to_jax_params)
from metamorph_tpu_torch.models import metamorph as M
from metamorph_tpu_torch.models import siglip as S
from metamorph_tpu_torch.multimodal import anyres as A
from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
from metamorph_tpu_torch.train import data as D
from tests.test_torch_data import assert_packed_equal

# tiny geometry: crop 28, patch 14 -> 2x2 patches, 4 tokens per view
PINPOINTS = [(28, 56), (56, 28), (56, 56)]
CROP, P = 28, 2
TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = [(20, 50), (50, 20), (40, 40), (13, 77), (56, 28)]


@pytest.fixture(autouse=True)
def _jax_python_packer(monkeypatch):
    monkeypatch.setattr(JN, "_load", lambda: None)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def anyres_jcfg(**mm_kw):
    mm = dict(num_image_tokens=4, image_token_reduction="none",
              image_aspect_ratio="anyres", mm_patch_merge_type="spatial_unpad",
              image_grid_pinpoints=tuple(PINPOINTS))
    mm.update(mm_kw)
    return JConfig(llama=JLlamaConfig.tiny(vocab_size=128258),
                   siglip=JSiglipConfig.tiny(), mm=JMM(**mm),
                   train=JTrainConfig(max_seq_len=48, batch_size=2,
                                      max_images_per_batch=2, remat=False))


def port_cfg(jcfg) -> MetaMorphConfig:
    return MetaMorphConfig.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("merge_type", ["flat", "spatial", "spatial_unpad"])
def test_merge_plans_match_jax(merge_type):
    for size in SIZES:
        assert A.anyres_num_views(size, PINPOINTS, CROP) == \
            JA.anyres_num_views(size, PINPOINTS, CROP)
        a = A.anyres_merge_map(size, PINPOINTS, CROP, P, merge_type)
        b = JA.anyres_merge_map(size, PINPOINTS, CROP, P, merge_type)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sizes = [SIZES[0], None, SIZES[3], SIZES[1]]
    views = [A.anyres_num_views(s, PINPOINTS, CROP) if s else 1
             for s in sizes]
    for cap in (64, 200):
        a = A.build_batch_plan(sizes, views, PINPOINTS, CROP, P, merge_type,
                               cap)
        b = JA.build_batch_plan(sizes, views, PINPOINTS, CROP, P, merge_type,
                                cap)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    with pytest.raises(ValueError, match="capacity"):
        A.build_batch_plan(sizes, views, PINPOINTS, CROP, P, merge_type, 8)
    assert (A.NEWLINE_IDX, A.PAD_IDX) == (JA.NEWLINE_IDX, JA.PAD_IDX)


def test_preprocess_anyres_matches_jax():
    rng = np.random.default_rng(0)
    for h, w in SIZES:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        (va, sa), (vb, sb) = (A.preprocess_anyres(img, PINPOINTS, CROP),
                              JA.preprocess_anyres(img, PINPOINTS, CROP))
        assert sa == sb and va.dtype == vb.dtype and np.array_equal(va, vb)


@pytest.fixture(scope="module")
def anyres_jsonl(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("anyres")
    rng = np.random.default_rng(3)
    rows = []
    for i, hw in enumerate([(30, 60), (60, 30), None, (40, 40), (25, 70),
                            None]):
        row = {"id": f"r{i}", "image": None, "conversations": [
            {"from": "human", "value": ("<image>\n" if hw else "") + f"q {i}"},
            {"from": "gpt", "value": f"ans {i} more words"}]}
        if hw:
            path = d / f"im{i}.png"
            Image.fromarray(rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
                            ).save(path)
            row["image"] = str(path)
        rows.append(row)
    path = d / "d.jsonl"
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _anyres_iterators(path, merge_type="spatial_unpad", **it_kw):
    out = []
    for mod in (D, JD):
        cfg = mod.DataConfig(data_path=path, image_aspect_ratio="anyres",
                             image_size=CROP, grid_pinpoints=tuple(PINPOINTS))
        ds = mod.LazySupervisedDataset(path, word_tokenize, cfg)
        col = mod.PackedCollator(
            num_image_tokens=4, max_seq_len=48, num_image_slots=2,
            image_size=CROP, image_aspect_ratio="anyres",
            grid_pinpoints=PINPOINTS, merge_type=merge_type)
        out.append((ds, mod.DataIterator(ds, col, batch_size=2, seed=0,
                                         **it_kw)))
    return out


@pytest.mark.parametrize("merge_type", ["spatial", "spatial_unpad"])
def test_anyres_dataset_and_collator_match_jax(anyres_jsonl, merge_type):
    """Items (view stacks, original sizes), then every batch of two epochs:
    the packed planes with view_map, and the padded view-pixel stack."""
    (ds, mine), (jds, ref) = _anyres_iterators(anyres_jsonl, merge_type)
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert a["input_ids"] == b["input_ids"] and a["labels"] == b["labels"]
        assert a["image_sizes"] == b["image_sizes"]
        assert all(np.array_equal(x, y) for x, y in zip(a["pixels"],
                                                         b["pixels"]))
    gm, gr = iter(mine), iter(ref)
    for _ in range(6):
        (pm, xm), (pr, xr) = next(gm), next(gr)
        assert pm.view_map is not None
        assert_packed_equal(pm, pr)
        assert xm.shape == xr.shape and np.array_equal(xm, xr)


@pytest.mark.parametrize("mode", ["mlpmixer", "concat_interpolation"])
def test_reduce_tokens_matches_jax(mode):
    """729 patches -> 64 tokens at SO400M geometry (narrow channels)."""
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 729, 16)).astype(np.float32)
    mm = MultimodalConfig(num_image_tokens=64, image_token_reduction=mode)
    jmm = JMM(num_image_tokens=64, image_token_reduction=mode)
    mixer, jmixer = None, None
    if mode == "mlpmixer":
        jmixer = {"token_mixer": {
            "kernel": rng.normal(size=(729, 64)).astype(np.float32) * 0.04,
            "bias": rng.normal(size=(64,)).astype(np.float32)},
            "channel_mixer": {
            "kernel": rng.normal(size=(16, 16)).astype(np.float32) * 0.25,
            "bias": rng.normal(size=(16,)).astype(np.float32)}}
        mixer = S.SiglipMixer(
            dataclasses.replace(port_cfg(anyres_jcfg()).siglip,
                                image_size=378, hidden_size=16),
            64, dtype=torch.float32)
        with torch.no_grad():
            for name, dense in (("token_mixer", mixer.token_mixer),
                                ("channel_mixer", mixer.channel_mixer)):
                dense.kernel.copy_(_t(jmixer[name]["kernel"]))
                dense.bias.copy_(_t(jmixer[name]["bias"]))
    ref = np.asarray(JS.reduce_tokens(jnp.asarray(feats), jmm,
                                      jax.tree.map(jnp.asarray, jmixer)))
    with torch.no_grad():
        out = S.reduce_tokens(_t(feats), mm, mixer).numpy()
    assert out.shape == ref.shape == (2, 64, 16 * (4 if "concat" in mode
                                                  else 1))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["mlpmixer", "concat_interpolation"])
def test_encode_images_with_reductions_match_jax(mode):
    """The whole model built from one JAX tree (mixers included): the
    projected tokens of encode_images, and the trees round-trip."""
    jcfg = dataclasses.replace(anyres_jcfg(), mm=JMM(
        num_image_tokens=1, image_token_reduction=mode))
    cfg = port_cfg(jcfg)
    jp = JM.init_metamorph_params(jax.random.PRNGKey(2), jcfg,
                                  dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    pixels = np.random.default_rng(5).normal(size=(2, 28, 28, 3)).astype(
        np.float32)
    proj_ref, tgt_ref = JM.encode_images(jp, jcfg, jnp.asarray(pixels))
    with torch.no_grad():
        proj, tgt = M.encode_images(model, cfg, _t(pixels))
    np.testing.assert_allclose(proj.numpy(), np.asarray(proj_ref), **TOL)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(tgt_ref), **TOL)
    _assert_trees_equal(to_jax_params(model), jp)


def _assert_trees_equal(mine, jax_tree):
    ref = jax.tree.map(np.asarray, jax_tree)
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(mine)):
        assert np.array_equal(a, b), path


@pytest.fixture(scope="module")
def anyres_pair():
    jcfg = anyres_jcfg()
    jp = JM.init_metamorph_params(jax.random.PRNGKey(0), jcfg,
                                  dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, jp), port_cfg(jcfg),
                            device="cpu")
    return jcfg, jp, model


def _anyres_batch(path):
    (_, mine), _ = _anyres_iterators(path)
    packed, pixels = next(iter(mine))
    return batch_to_arrays(packed), pixels


def test_image_token_table_with_view_map_matches_jax(anyres_pair,
                                                     anyres_jsonl):
    """The gather through view_map: projected view tokens, the learned
    newline at -1 and zeros at -2; and the fused embeddings."""
    jcfg, jp, model = anyres_pair
    cfg = port_cfg(jcfg)
    arrays, pixels = _anyres_batch(anyres_jsonl)
    vm = arrays["view_map"]
    assert (vm == A.NEWLINE_IDX).any() and (vm == A.PAD_IDX).any()
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: _t(v) for k, v in arrays.items()}
    proj_ref, _ = JM.encode_images(jp, jcfg, jnp.asarray(pixels))
    table_ref = np.asarray(JM.image_token_table(jp, jcfg, jb, proj_ref))
    emb_ref = np.asarray(JM.fuse_embeddings(jp, jcfg, jb, proj_ref))
    with torch.no_grad():
        proj, _ = M.encode_images(model, cfg, _t(pixels))
        table = M.image_token_table(model, cfg, tb, proj).numpy()
        emb = M.fuse_embeddings(model, cfg, tb, proj).numpy()
    np.testing.assert_allclose(table, table_ref, **TOL)
    np.testing.assert_allclose(emb, emb_ref, **TOL)
    np.testing.assert_array_equal(table[vm == A.NEWLINE_IDX][0],
                                  model.image_newline.detach().numpy())
    assert not table[vm == A.PAD_IDX].any()
    reduced = dataclasses.replace(cfg, mm=dataclasses.replace(
        cfg.mm, image_token_reduction="interpolation"))
    with pytest.raises(ValueError, match="raw patch grid"):
        M.image_token_table(model, reduced, tb, proj[:, :1])


def test_anyres_forward_matches_jax(anyres_pair, anyres_jsonl):
    """The dual-loss forward on an anyres batch: every metric, zero AR
    tokens (anyres images are prompt images), and the gradient reaches the
    newline row."""
    from tests.test_torch_train import METRICS, _assert_metrics

    jcfg, jp, model = anyres_pair
    cfg = port_cfg(jcfg)
    arrays, pixels = _anyres_batch(anyres_jsonl)
    _, jm = jax.jit(lambda p, b, x: JM.metamorph_forward(
        p, jcfg, b, x, attn_impl="flash"))(
            jp, {k: jnp.asarray(v) for k, v in arrays.items()},
            jnp.asarray(pixels))
    model.zero_grad()
    total, tm = M.metamorph_forward(model, cfg,
                                    {k: _t(v) for k, v in arrays.items()},
                                    _t(pixels))
    _assert_metrics(jm, tm, METRICS)
    assert float(tm["n_image_ar_tokens"]) == 0.0
    total.backward()
    assert model.image_newline.grad.abs().sum() > 0


def test_anyres_rank_shards_match_jax_and_fuse_to_the_global_batch(
        anyres_pair, anyres_jsonl):
    """P = 2 over two epochs: rank r's shard equals JAX's
    DataIterator(process_index=r, process_count=2) shard with JAX's
    re-basing to the global tables (`shift_packed_anyres_shard`) undone,
    since a rank of the port gathers from its own views; and the ranks'
    fused embeddings, each from its own shard and views, concatenated,
    equal the one-process batch's."""
    jcfg, _, model = anyres_pair
    cfg = port_cfg(jcfg)
    shards = [_anyres_iterators(anyres_jsonl, process_index=r,
                                process_count=2) for r in range(2)]
    P_side, vc, tc = shards[0][0][1].collator._anyres_caps(1)

    def fused(packed, pixels):
        b = {k: _t(v) for k, v in batch_to_arrays(packed).items()}
        with torch.no_grad():
            proj, _ = M.encode_images(model, cfg, _t(pixels))
            return M.fuse_embeddings(model, cfg, b, proj).numpy()

    (_, whole), _ = _anyres_iterators(anyres_jsonl)
    its = [(iter(m), iter(j)) for (_, m), (_, j) in shards]
    for g in (b for _, b in zip(range(6), iter(whole))):
        parts = []
        for r, (mine, ref) in enumerate(its):
            (pm, xm), (pr, xr) = next(mine), next(ref)
            vm = np.asarray(pr.view_map)
            pr = dataclasses.replace(
                pr, img_gather_idx=np.where(pr.is_image, pr.img_gather_idx
                                            - r * tc, tc).astype(np.int32),
                view_map=np.where(vm >= 0, vm - r * vc * P_side ** 2,
                                  vm).astype(np.int32))
            assert_packed_equal(pm, pr)
            assert np.array_equal(xm, xr)
            parts.append(fused(pm, xm))
        np.testing.assert_allclose(np.concatenate(parts), fused(*g), **TOL)


def test_conversion_carries_mixer_and_newline_both_ways():
    """to_jax_params(from_jax_params(tree)) is the tree, with siglip_mixer
    and image_newline; a tree without them is refused for a config that
    needs them; init_params makes them at the JAX scales."""
    jcfg = anyres_jcfg(image_token_reduction="mlpmixer", num_image_tokens=2)
    cfg = port_cfg(jcfg)
    jp = JM.init_metamorph_params(jax.random.PRNGKey(1), jcfg,
                                  dtype=jnp.float32)
    assert {"siglip_mixer", "image_newline"} <= set(jp)
    tree = jax.tree.map(np.asarray, jp)
    model = from_jax_params(tree, cfg, device="cpu")
    _assert_trees_equal(to_jax_params(model), jp)
    partial = {k: v for k, v in tree.items() if k != "image_newline"}
    with pytest.raises(ValueError, match="image_newline"):
        from_jax_params(partial, cfg, device="cpu")
    plain = port_cfg(anyres_jcfg(mm_patch_merge_type="flat",
                                 image_token_reduction="mlpmixer",
                                 num_image_tokens=2))
    with pytest.raises(ValueError, match="image_newline"):
        from_jax_params(tree, plain, device="cpu")

    big = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, hidden_size=1024))
    rand = init_params(big, seed=0, device="cpu", dtype=torch.float32)
    nl = rand.image_newline.detach()
    assert nl.shape == (1024,)
    assert abs(float(nl.std()) - 1024 ** -0.5) < 0.2 * 1024 ** -0.5
    tm = rand.siglip_mixer.token_mixer.kernel.detach()
    assert tm.shape == (4, 2) and float(tm.abs().max()) <= 4 ** -0.5
    names = set(to_jax_params(rand))
    assert names == set(jp)
