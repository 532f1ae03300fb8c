"""PyTorch port, the weights slice: safetensors reading and writing, the
HF-layout import and export, the stage-1 adapter, LoRA files, the model
loader, `train()` from checkpoint files and `consolidate` — against the
`safetensors` package, the JAX package and HF transformers on the CPU.

Tolerances:
  * files crossing between the packages: bitwise (the same bytes; fp32
    and bf16 values move without arithmetic);
  * the fp32 forward of a loaded model against the JAX forward: 1e-4, as
    `tests/test_torch_models.py` holds the LLaMA forward;
  * HF parity: rtol = atol = 2e-4, as `tests/test_hf_parity.py` holds the
    JAX package;
  * `train()` from files against the JAX step: the losses within 1e-5
    relative, as `tests/test_torch_train.py` holds the train step.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save_file as st_save_file

from metamorph_tpu.config import LlamaConfig as JLlamaConfig
from metamorph_tpu.config import MetaMorphConfig as JConfig
from metamorph_tpu.config import MultimodalConfig as JMM
from metamorph_tpu.config import SiglipConfig as JSiglipConfig
from metamorph_tpu.config import TrainConfig as JTrainConfig
from metamorph_tpu.inference import loader as JLoader
from metamorph_tpu.models import llama as JL
from metamorph_tpu.models import lora as JLora
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu.multimodal.packing import batch_to_arrays as J_batch_to_arrays
from metamorph_tpu.train import checkpoint as JC
from metamorph_tpu.train import train_step as JTS
from metamorph_tpu.train import trainer as JTrainer
from metamorph_tpu.train.optimizer import make_optimizer as jax_optimizer
from metamorph_tpu_torch import consolidate
from metamorph_tpu_torch import convert
from metamorph_tpu_torch.config import MetaMorphConfig, SiglipConfig
from metamorph_tpu_torch.constants import (IGNORE_INDEX, IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX)
from metamorph_tpu_torch.convert import from_jax_params, to_jax_params
from metamorph_tpu_torch.inference import loader
from metamorph_tpu_torch.models import hf_import
from metamorph_tpu_torch.models import llama as L
from metamorph_tpu_torch.models import projector as P
from metamorph_tpu_torch.models import siglip as S
from metamorph_tpu_torch.models.lora import add_lora
from metamorph_tpu_torch.multimodal.packing import pack_sequences
from metamorph_tpu_torch.train import checkpoint as C
from metamorph_tpu_torch.train import trainer
from metamorph_tpu_torch.utils import safetensors_io as io

K = 4
LLM_TOL = dict(rtol=1e-4, atol=1e-4)
HF_TOL = dict(rtol=2e-4, atol=2e-4)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def jax_cfg(vocab_size=1024, **train_kw):
    return JConfig(llama=JLlamaConfig.tiny(vocab_size=vocab_size),
                   siglip=JSiglipConfig.tiny(),
                   mm=JMM(num_image_tokens=K),
                   train=JTrainConfig(max_seq_len=24, **train_kw))


JCFG = jax_cfg()
CFG = MetaMorphConfig.from_dict(JCFG.to_dict())
# train() runs the image-token ids (128256, 128257), so its vocabulary is
# LLaMA-3's plus the two
JCFG_TRAIN = jax_cfg(vocab_size=128258, batch_size=4, max_images_per_batch=4,
                     total_steps=20, remat=False, learning_rate=1e-3,
                     param_dtype="float32")
CFG_TRAIN = MetaMorphConfig.from_dict(JCFG_TRAIN.to_dict())


def jax_tree(seed, dtype="float32", cfg=JCFG):
    return JM.init_metamorph_params(jax.random.PRNGKey(seed), cfg,
                                    dtype=JDTYPES[dtype])


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_modules_equal(a, b, parts=None):
    """Every parameter (of the named top-level parts) equal, bitwise and
    in dtype."""
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sorted(pa) == sorted(pb)
    for n in pa:
        if parts is None or n.split(".")[0] in parts:
            assert pa[n].dtype == pb[n].dtype, n
            assert torch.equal(pa[n], pb[n]), n


def assert_trees_equal(ref, got):
    """JAX tree against a tree of numpy arrays, bitwise after fp32."""
    assert (jax.tree_util.tree_structure(np_tree(ref))
            == jax.tree_util.tree_structure(got))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(got)):
        np.testing.assert_array_equal(
            np.asarray(b, np.float32), np.asarray(a).astype(np.float32),
            err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# safetensors I/O
# ---------------------------------------------------------------------------

def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "bf16": rng.normal(size=(5, 3)).astype(ml_dtypes.bfloat16),
        "f16": rng.normal(size=(4,)).astype(np.float16),
        "f32": rng.normal(size=(2, 3, 4)).astype(np.float32),
        "i64": rng.integers(-9, 9, (7,)).astype(np.int64),
        "scalar": np.asarray(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }


def _torch_of(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_same(a: np.ndarray, t: torch.Tensor):
    assert tuple(t.shape) == a.shape
    if a.dtype == ml_dtypes.bfloat16:
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("direction", ["port_writes", "package_writes",
                                       "sharded_index"])
def test_safetensors_io_matches_the_safetensors_package(tmp_path, direction):
    """The port's writer gives files `safetensors.numpy` reads equal; its
    reader reads the package's files equal, and a sharded index dir."""
    arrays = _arrays(0)
    path = str(tmp_path / "model.safetensors")
    if direction == "port_writes":
        # a transposed view is written as the transposed values
        tensors = {k: _torch_of(v) for k, v in arrays.items()}
        tensors["f32_t"] = tensors["f32"][0].T
        arrays["f32_t"] = np.ascontiguousarray(arrays["f32"][0].T)
        io.save_file(tensors, path, metadata={"format": "pt"})
        got = st_load_file(path)
        assert sorted(got) == sorted(arrays)
        for k, a in arrays.items():
            _assert_same(a, _torch_of(got[k]))
        assert io.SafetensorsFile(path).metadata == {"format": "pt"}
        return
    if direction == "package_writes":
        st_save_file(arrays, path, metadata={"who": "numpy"})
        got = io.load_safetensors_dir(path)
        assert got.metadata == {"who": "numpy"}
    else:
        other = _arrays(1)
        st_save_file(arrays, str(tmp_path / "model-00001-of-00002.safetensors"))
        st_save_file({f"b.{k}": v for k, v in other.items()},
                     str(tmp_path / "model-00002-of-00002.safetensors"))
        weight_map = {**{k: "model-00001-of-00002.safetensors"
                         for k in arrays},
                      **{f"b.{k}": "model-00002-of-00002.safetensors"
                         for k in other}}
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
        arrays.update({f"b.{k}": v for k, v in other.items()})
        got = io.load_safetensors_dir(str(tmp_path))
    assert sorted(got) == sorted(arrays)
    for k, a in arrays.items():
        _assert_same(a, got[k])


# ---------------------------------------------------------------------------
# checkpoint files across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_hf_crosses_between_packages(tmp_path, dtype):
    """A JAX export_hf dir loads in the port bitwise equal to
    from_jax_params of the same tree; the port's export_hf dir loads in the
    JAX loader bitwise equal. Both carry the tower in the file, the
    standalone tower dir, the HF config.json and the typed config."""
    tree = jax_tree(1, dtype)
    JC.export_hf(str(tmp_path / "jax"), tree, JCFG)
    model, cfg = loader.load_pretrained_model(
        str(tmp_path / "jax"), dtype=TDTYPES[dtype], device="cpu")
    assert cfg == CFG
    assert_modules_equal(model, from_jax_params(np_tree(tree), CFG,
                                                device="cpu",
                                                dtype=TDTYPES[dtype]))
    # the tower again, from the standalone HF dir the export wrote
    model2, _ = loader.load_pretrained_model(
        str(tmp_path / "jax"), dtype=TDTYPES[dtype], device="cpu",
        hf_siglip_path=str(tmp_path / "jax" / "vision_tower"))
    assert_modules_equal(model2, model)

    port_model = convert.init_params(CFG, seed=2, device="cpu",
                                     dtype=TDTYPES[dtype])
    C.export_hf(str(tmp_path / "port"), port_model, CFG)
    for name in ("config.json", "metamorph_config.json",
                 "model.safetensors.index.json", "vision_tower/config.json"):
        a = json.load(open(tmp_path / "jax" / name))
        b = json.load(open(tmp_path / "port" / name))
        if name == "model.safetensors.index.json":
            a, b = sorted(a["weight_map"]), sorted(b["weight_map"])
        assert a == b, name
    jparams, jcfg = JLoader.load_pretrained_model(str(tmp_path / "port"),
                                                  dtype=JDTYPES[dtype])
    assert jcfg == JCFG
    assert_trees_equal(jparams, to_jax_params(port_model))
    # the port reads its own export back
    back, _ = loader.load_pretrained_model(str(tmp_path / "port"),
                                           dtype=TDTYPES[dtype], device="cpu")
    assert_modules_equal(back, port_model)


def test_loaded_model_forward_matches_jax(tmp_path):
    """The fp32 forward + lm head of a model the port loaded from a JAX
    export equals the JAX forward of the exported tree."""
    tree = jax_tree(3)
    JC.export_hf(str(tmp_path), tree, JCFG)
    model, cfg = loader.load_pretrained_model(str(tmp_path),
                                              dtype=torch.float32,
                                              device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(10, 1000, (2, 16)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    mask = np.ones((2, 16), np.int32)
    h_ref = JL.llama_forward(tree["llama"], JCFG.llama,
                             JL.embed_tokens(tree["llama"], jnp.asarray(ids)),
                             jnp.asarray(pos), jnp.asarray(mask),
                             attn_impl="xla")
    ref = np.asarray(JL.lm_head(tree["llama"], JCFG.llama, h_ref))
    with torch.no_grad():
        h = L.llama_forward(model.llama, cfg.llama,
                            L.embed_tokens(model.llama, torch.from_numpy(ids)),
                            torch.from_numpy(pos.copy()),
                            torch.from_numpy(mask))
        got = L.lm_head(model.llama, cfg.llama, h).numpy()
    np.testing.assert_allclose(got, ref, **LLM_TOL)


@pytest.mark.parametrize("embed_rows", ["all", "two"])
def test_adapter_crosses_between_packages(tmp_path, embed_rows):
    """save_adapter/load_adapter both ways: the projector and the
    embeddings, or only the two image-token rows spliced over the last
    two rows of the table."""
    src, dst = jax_tree(4), jax_tree(5)
    path = str(tmp_path / "jax_adapter.safetensors")
    JC.save_adapter(path, src)
    if embed_rows == "two":
        tensors = st_load_file(path)
        tensors["model.embed_tokens.weight"] = \
            tensors["model.embed_tokens.weight"][-2:].copy()
        st_save_file(tensors, path)
    want = JC.load_adapter(path, dst)
    model = from_jax_params(np_tree(dst), CFG, device="cpu")
    C.load_adapter(path, model)
    assert_trees_equal(want, to_jax_params(model))
    if embed_rows == "two":
        emb = np.asarray(want["llama"]["embed"]["embedding"])
        np.testing.assert_array_equal(
            emb[:-2], np.asarray(dst["llama"]["embed"]["embedding"])[:-2])

    # the port's adapter file, read by the JAX package
    port_src = from_jax_params(np_tree(src), CFG, device="cpu")
    path2 = str(tmp_path / "port_adapter.safetensors")
    C.save_adapter(path2, port_src)
    assert sorted(st_load_file(path2)) == sorted(st_load_file(
        str(tmp_path / "jax_adapter.safetensors")))
    got = JC.load_adapter(path2, dst)
    assert_trees_equal(got["projector"], np_tree(src["projector"]))
    assert_trees_equal(got["llama"]["embed"], np_tree(src["llama"]["embed"]))


def test_lora_file_crosses_between_packages(tmp_path):
    """save_lora/load_lora both ways, with the same flat
    `llama/layers/<sub>/<w>_lora_{a,b}` keys."""
    tree = jax_tree(6)
    lora = JLora.add_lora(tree["llama"], jax.random.PRNGKey(1), r=4)
    key = jax.random.PRNGKey(2)
    for sub in lora["layers"]:
        for name in list(lora["layers"][sub]):
            if name.endswith("_lora_b"):
                key, k = jax.random.split(key)
                lora["layers"][sub][name] = 0.05 * jax.random.normal(
                    k, lora["layers"][sub][name].shape, jnp.float32)
    path = str(tmp_path / "jax_lora.safetensors")
    JC.save_lora(path, {**tree, "llama": lora})
    model = from_jax_params(np_tree(tree), CFG, device="cpu")
    C.load_lora(path, model)
    assert_trees_equal({**tree, "llama": lora}, to_jax_params(model))

    path2 = str(tmp_path / "port_lora.safetensors")
    C.save_lora(path2, model)
    assert sorted(st_load_file(path2)) == sorted(st_load_file(path))
    got = JC.load_lora(path2, tree)
    assert_trees_equal(got["llama"], np_tree(lora))


# ---------------------------------------------------------------------------
# HF transformers parity
# ---------------------------------------------------------------------------

def test_hf_llama_and_siglip_checkpoints_match_transformers(tmp_path):
    """Tiny LlamaForCausalLM (llama3 rope scaling, saved sharded) and
    SiglipVisionModel checkpoints, as transformers writes them, load into
    the port: logits and features match HF's."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=256, rms_norm_eps=1e-5,
        rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32},
        attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf_llama = transformers.LlamaForCausalLM(hf_cfg).eval()
    hf_llama.save_pretrained(str(tmp_path / "llama"), max_shard_size="40KB")
    assert (tmp_path / "llama" / "model.safetensors.index.json").exists()
    llama, cfg = hf_import.load_hf_llama(str(tmp_path / "llama"),
                                         dtype=torch.float32, device="cpu")
    assert cfg.rope_scaling and cfg.rope_original_max_position == 32
    ids = np.random.default_rng(1).integers(0, 256, (2, 48))
    pos = torch.arange(48)[None].expand(2, 48)
    with torch.no_grad():
        ref = hf_llama(torch.from_numpy(ids)).logits.numpy()
        h = L.llama_forward(llama, cfg, L.embed_tokens(llama,
                                                       torch.from_numpy(ids)),
                            pos, None)
        got = L.lm_head(llama, cfg, h).numpy()
    np.testing.assert_allclose(got, ref, **HF_TOL)
    # export back under HF names: the same state dict
    sd = hf_llama.state_dict()
    for k, v in hf_import.llama_params_to_hf(llama).items():
        assert torch.equal(v, sd[k]), k

    sig_hf_cfg = transformers.SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=28, patch_size=14,
        layer_norm_eps=1e-6)
    torch.manual_seed(3)
    hf_sig = transformers.SiglipVisionModel(sig_hf_cfg).eval()
    hf_sig.save_pretrained(str(tmp_path / "siglip"))
    scfg = SiglipConfig(image_size=28, patch_size=14, hidden_size=32,
                        intermediate_size=64, num_layers=2, num_heads=4,
                        select_layer=-1)
    sig = S.Siglip(scfg, dtype=torch.float32, device="cpu")
    hf_import.siglip_params_from_hf(
        hf_import.load_safetensors_dir(str(tmp_path / "siglip")), sig)
    px = np.random.default_rng(4).normal(size=(2, 28, 28, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = hf_sig(torch.from_numpy(px.transpose(0, 3, 1, 2)),
                     output_hidden_states=True).hidden_states[-1].numpy()
        got = S.siglip_encode(sig, scfg, torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, ref, **HF_TOL)
    sd = hf_sig.state_dict()
    for k, v in hf_import.siglip_params_to_hf(sig).items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("layout", ["sequential", "single_linear"])
def test_projector_layouts_match_torch_modules(tmp_path, layout):
    """A torch Sequential (Linear, GELU, Linear) keyed 0/2, or one Linear
    keyed by the prefix alone, loads into a DenseStack that computes what
    the torch module does, and writes back the same keys."""
    torch.manual_seed(5)
    if layout == "sequential":
        mod = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(),
                                  torch.nn.Linear(16, 16))
        dims, acts = [(8, 16), (16, 16)], ["gelu", None]
    else:
        mod = torch.nn.Linear(8, 16)
        dims, acts = [(8, 16)], [None]
    path = str(tmp_path / "proj.safetensors")
    io.save_file({f"mm_projector.{k}": v for k, v in mod.state_dict().items()},
                 path)
    stack = P.DenseStack(dims, dtype=torch.float32, device="cpu")
    hf_import.mlp_params_from_hf(io.load_safetensors_dir(path),
                                 "mm_projector", stack)
    x = torch.randn(3, 8)
    with torch.no_grad():
        np.testing.assert_allclose(P.apply_stack(stack, acts, x).numpy(),
                                   mod(x).numpy(), rtol=1e-6, atol=1e-6)
    out = hf_import.mlp_params_to_hf(stack, "mm_projector")
    sd = mod.state_dict()
    assert sorted(out) == sorted(f"mm_projector.{k}" for k in sd)
    for k, v in sd.items():
        assert torch.equal(out[f"mm_projector.{k}"], v)
    with pytest.raises(ValueError, match="linear layers"):
        hf_import.mlp_params_from_hf(
            io.load_safetensors_dir(path), "mm_projector",
            P.DenseStack([(8, 16)] * 3, dtype=torch.float32, device="cpu"))


# ---------------------------------------------------------------------------
# train() from checkpoint files, consolidate
# ---------------------------------------------------------------------------

def _batch(cfg, B=4):
    ids = [[1, 2 + b, IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX, 128257, 7, 8]
           for b in range(B)]
    labs = [[IGNORE_INDEX, IGNORE_INDEX, IM_START_TOKEN_ID, 0, 128257, 7, 8]
            for _ in range(B)]
    packed = pack_sequences(ids, labs, K, cfg.train.max_seq_len, B)
    pixels = np.random.default_rng(0).normal(size=(B, 28, 28, 3)).astype(
        np.float32)
    return packed, pixels


class RepeatData:
    def __init__(self, cfg):
        self.item = _batch(cfg)

    def __iter__(self):
        while True:
            yield self.item


def with_train(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **kw))


def test_train_from_hf_files_matches_jax(tmp_path, monkeypatch):
    """train() with hf_llama_path, hf_siglip_path and pretrain_mm_mlp_adapter
    (a JAX export dir, its tower dir and a JAX adapter file of one tree)
    starts from the files' weights and gives the JAX package's losses (its
    build_params over the same files, then its jitted train step; 3 steps,
    as step 1 runs at lr 0). The random part that both build_params start
    from (the vision head here) is JAX's seed-0 init on both sides, so that
    only the files decide the rest."""
    jcfg, cfg = JCFG_TRAIN, CFG_TRAIN
    src = jax_tree(8, cfg=jcfg)
    JC.export_hf(str(tmp_path / "export"), src, jcfg)
    JC.save_adapter(str(tmp_path / "adapter.safetensors"), src)
    files = dict(hf_llama_path=str(tmp_path / "export"),
                 hf_siglip_path=str(tmp_path / "export" / "vision_tower"),
                 pretrain_mm_mlp_adapter=str(tmp_path /
                                             "adapter.safetensors"))
    jp = JTrainer.build_params(jcfg, JTrainer.TrainerArgs(**files))
    for part in ("llama", "siglip", "projector"):
        assert_trees_equal(jp[part], np_tree(src[part]))

    seed0 = np_tree(jax_tree(0, cfg=jcfg))
    monkeypatch.setattr(trainer, "init_params", lambda *a, **kw:
                        from_jax_params(seed0, cfg, device="cpu"))
    built = trainer.build_params(cfg, trainer.TrainerArgs(**files),
                                 device="cpu")
    assert_trees_equal(jp, to_jax_params(built))

    packed, pixels = _batch(cfg)
    arrays = {k: jnp.asarray(v) for k, v in J_batch_to_arrays(packed).items()}
    tx = jax_optimizer(jcfg.train, jp)
    state = JTS.init_train_state(jp, jcfg)
    step = jax.jit(lambda s, b, x: JTS.train_step(s, b, x, cfg=jcfg, tx=tx,
                                                  attn_impl="xla"))
    jlosses = []
    for _ in range(3):
        state, m = step(state, arrays, jnp.asarray(pixels))
        jlosses.append(float(m["loss"]))

    out_dir = str(tmp_path / "out")
    out = trainer.train(with_train(cfg, total_steps=3),
                        trainer.TrainerArgs(output_dir=out_dir, save_steps=0,
                                            **files),
                        RepeatData(cfg), device="cpu")
    assert out["step"] == 3
    rows = [json.loads(line) for line in
            open(os.path.join(out_dir, "metrics.jsonl"))]
    np.testing.assert_allclose([r["loss"] for r in rows], jlosses,
                               **METRIC_TOL)
    assert jlosses[1] == jlosses[0] and jlosses[2] < jlosses[0]


def test_consolidate_and_the_trainer_saves(tmp_path, monkeypatch):
    """train() saves step_2, consolidate exports it, and
    load_pretrained_model reads back the checkpoint's weights (bf16, as the
    JAX consolidate restores). A stage-1 run writes the adapter file and a
    lora_enable run the LoRA factors its model carries, each equal to the
    trained weights."""
    cfg = with_train(CFG_TRAIN, total_steps=2, param_dtype="bfloat16")
    out_dir = str(tmp_path / "out")
    trainer.train(cfg, trainer.TrainerArgs(output_dir=out_dir, save_steps=1),
                  RepeatData(cfg), device="cpu")
    assert sorted(os.listdir(out_dir)) == ["metrics.jsonl", "step_2"]
    consolidate.main(["--src", out_dir, "--dst", str(tmp_path / "export"),
                      "--device", "cpu"])
    model, cfg2 = loader.load_pretrained_model(str(tmp_path / "export"),
                                               device="cpu")
    assert cfg2 == cfg
    saved = torch.load(os.path.join(out_dir, "step_2", "state.pt"),
                       weights_only=True)["params"]
    for n, p in model.named_parameters():
        assert saved[n].dtype == p.dtype and torch.equal(p, saved[n]), n

    cfg1 = with_train(cfg, tune_mm_mlp_adapter=True, total_steps=2)
    out = trainer.train(cfg1, trainer.TrainerArgs(
        output_dir=str(tmp_path / "s1"), save_steps=1), RepeatData(cfg),
        device="cpu")
    adapter = io.SafetensorsFile(str(tmp_path / "s1" /
                                     "mm_projector.safetensors"))
    trained = out["state"]["params"]
    assert torch.equal(adapter["model.mm_projector.0.weight"],
                       trained.projector.layers[0].kernel.T)
    assert torch.equal(adapter["model.embed_tokens.weight"],
                       trained.llama.embed)

    init, base_wq = trainer.init_params, []

    def with_lora(*a, **kw):
        model = init(*a, **kw)
        add_lora(model.llama, r=2, seed=1)
        base_wq.append(model.llama.layers[0].wq.detach().clone())
        return model

    monkeypatch.setattr(trainer, "init_params", with_lora)
    cfgl = dataclasses.replace(
        with_train(cfg, lora_enable=True, total_steps=2),
        llama=dataclasses.replace(cfg.llama, lora_r=2, lora_alpha=4.0))
    out = trainer.train(cfgl, trainer.TrainerArgs(
        output_dir=str(tmp_path / "lora"), save_steps=1), RepeatData(cfg),
        device="cpu")
    lora = io.SafetensorsFile(str(tmp_path / "lora" / "lora.safetensors"))
    layers = out["state"]["params"].llama.layers
    assert len(lora) == 14
    for key in lora:
        sub, name = key.split("/")[-2:]
        want = torch.stack([getattr(layer, name).detach()
                            for layer in layers])
        assert torch.equal(lora[key], want), key
    # the B factors trained (step 2 runs at lr > 0); the base did not move
    assert layers[0].wq_lora_b.abs().sum() > 0
    assert torch.equal(layers[0].wq, base_wq[0])


def test_resolve_model_dir_and_entry_points_need_a_card(tmp_path,
                                                        monkeypatch):
    """A local dir passes through; a name that is not one raises
    FileNotFoundError when huggingface_hub is absent or cannot fetch it
    (both simulated, so no network is touched). The new entry points,
    the visualizer's loader among them, raise without a card unless the
    caller passes device="cpu"."""
    import sys
    import types

    assert loader.resolve_model_dir(str(tmp_path)) == str(tmp_path)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        loader.resolve_model_dir(str(tmp_path / "missing"))

    def unreachable(repo_id):
        raise OSError("hub unreachable")

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        snapshot_download=unreachable))
    with pytest.raises(FileNotFoundError, match="hub unreachable"):
        loader.resolve_model_dir("no-such-org/no-such-repo")

    model = convert.init_params(CFG, device="cpu")
    C.export_hf(str(tmp_path / "export"), model, CFG)
    add_lora(model.llama, r=2)
    C.save_lora(str(tmp_path / "lora.safetensors"), model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: loader.load_pretrained_model(str(tmp_path / "export")),
            lambda: loader.load_lora_model(str(tmp_path / "export"),
                                           str(tmp_path / "lora.safetensors"),
                                           r=2, alpha=4.0),
            lambda: hf_import.load_hf_llama(str(tmp_path / "export")),
            lambda: consolidate.main(["--src", str(tmp_path),
                                      "--dst", str(tmp_path / "x")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "x").exists()
    m2, _ = loader.load_lora_model(str(tmp_path / "export"),
                                   str(tmp_path / "lora.safetensors"),
                                   r=2, alpha=4.0, device="cpu")
    assert m2.llama.embed.device.type == "cpu"
    assert all("_lora_" not in n for n, _ in m2.named_parameters())
    # the visualizer's loader: no card raises, device="cpu" loads
    from metamorph_tpu_torch.visualizer import adapter, unet, vae

    ucfg, vcfg = unet.UNetConfig.tiny(), vae.VAEConfig.tiny()
    vis = (adapter.init_adapter(input_dim=8, hidden_dim=8, output_dim=16,
                                num_layers=2, device="cpu"),
           unet.init_unet_params(ucfg, device="cpu"),
           vae.init_vae_params(vcfg, device="cpu"))
    loader.save_visualizer(str(tmp_path / "vis"), *vis, ucfg, vcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_visualization(str(tmp_path / "vis"))
    got = loader.load_visualization(str(tmp_path / "vis"), device="cpu")
    assert got[3:] == (ucfg, vcfg, "mlp")
    for a, b in zip(got[:3], vis):
        want = dict(b.named_parameters())
        assert sorted(n for n, _ in a.named_parameters()) == sorted(want)
        for n, p in a.named_parameters():
            assert p.device.type == "cpu" and torch.equal(p, want[n]), n
