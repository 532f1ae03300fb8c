"""PyTorch port, host-data slice: conversation templates, mm_utils, round
masking, the native packer, the dataset and iterator, the device resize and
the train CLI, each against the JAX package on the CPU; and one JSONL
through both packages' data paths into their train steps.

Tolerances: host code is held to exact equality (the same lists, the same
arrays bit for bit); the device resize `fused_resize_normalize` to 1e-5 max
abs in fp32 (another matmul order); the train-step losses to the
tolerances of tests/test_torch_train.py.

The JAX dataset and collator would load the untracked `native/libmmpack.so`;
an autouse fixture makes the JAX package's native packer unavailable, so the
JAX side runs its Python packer and indexer, and the port's native packer
is held against those."""

import base64
import dataclasses
import io
import json
import os
import random
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.multimodal import conversation as JC
from metamorph_tpu.multimodal import mm_utils as JU
from metamorph_tpu.multimodal import native as JN
from metamorph_tpu.multimodal import packing as JP
from metamorph_tpu.ops import preprocess as JPre
from metamorph_tpu.train import data as JD
from metamorph_tpu.train import masking as JMask
from metamorph_tpu_torch.constants import (IGNORE_INDEX, IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX)
from metamorph_tpu_torch.multimodal import conversation as C
from metamorph_tpu_torch.multimodal import mm_utils as U
from metamorph_tpu_torch.multimodal import native as N
from metamorph_tpu_torch.multimodal.packing import PackedBatch
from metamorph_tpu_torch.ops import preprocess as Pre
from metamorph_tpu_torch.train import data as D
from metamorph_tpu_torch.train import masking as Mask
from tests.test_masking import fake_tokenize

WORDS = ["cat", "dog", "a", "the", "red", "blue", "sky", "is", "what", "why",
         "picture", "shows", "near", "far", "tree", "two", "three", "x1"]


@pytest.fixture(autouse=True)
def _jax_python_packer(monkeypatch):
    monkeypatch.setattr(JN, "_load", lambda: None)


def _text(rng, lo=1, hi=8):
    return " ".join(rng.choice(WORDS) for _ in range(rng.randint(lo, hi)))


def assert_packed_equal(a, b):
    for f in dataclasses.fields(PackedBatch):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name


# ---------------------------------------------------------------------------
# conversation templates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JC.conv_templates))
def test_templates_render_as_jax(name):
    """get_prompt over seeded conversations (closed and open last turns,
    an image tuple in the first message), dict() and copy()."""
    assert name in C.conv_templates
    assert C.default_conversation.version == JC.default_conversation.version
    rng = random.Random(name)
    for trial in range(12):
        mine, ref = C.conv_templates[name].copy(), JC.conv_templates[name].copy()
        n = rng.randint(1, 6)
        for j in range(n):
            if j == n - 1 and trial % 3 == 0:
                msg = None
            elif j == 0 and trial % 4 == 1:
                msg = ("<image>\n" + _text(rng),
                       np.zeros((4, 4, 3), np.uint8), "Default")
            else:
                msg = _text(rng)
            for conv in (mine, ref):
                conv.append_message(conv.roles[j % 2], msg)
        assert mine.get_prompt() == ref.get_prompt()
        assert mine.dict() == ref.dict()
        assert mine.copy().get_prompt() == ref.get_prompt()


def test_serving_image_helpers_match_jax():
    img = np.random.default_rng(0).integers(0, 256, (30, 50, 3)).astype(
        np.uint8)
    big = np.random.default_rng(1).integers(0, 256, (20, 1500, 3)).astype(
        np.uint8)
    for mode in ("Pad", "Default", "Crop", "Resize"):
        for im in (img, big):
            a = C.conv_llama_3.copy().process_image(im, mode, return_pil=True)
            b = JC.conv_llama_3.copy().process_image(im, mode, return_pil=True)
            assert np.array_equal(a, b), mode
    mine, ref = C.conv_llama_3.copy(), JC.conv_llama_3.copy()
    for conv in (mine, ref):
        conv.append_message(conv.roles[0], ("<image>\nwhat", img, "Pad"))
        conv.append_message(conv.roles[1], "a cat")
    assert all(np.array_equal(a, b) for a, b in
               zip(mine.get_images(return_pil=True),
                   ref.get_images(return_pil=True)))
    assert mine.to_gradio_chatbot() == ref.to_gradio_chatbot()


# ---------------------------------------------------------------------------
# mm_utils
# ---------------------------------------------------------------------------

PINPOINTS = [(28, 56), (56, 28), (56, 56), (84, 28)]


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((20, 50), (50, 20), (33, 33), (17, 61), (28, 28))]


def _eq(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
        return True
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
        return True
    assert a == b
    return True


@pytest.mark.parametrize("fn", [
    "expand2square", "resize_bilinear", "siglip_preprocess",
    "select_best_resolution", "resize_and_pad_image", "divide_to_patches",
    "get_anyres_image_grid_shape", "process_anyres_image", "process_images",
    "unpad_image", "merge_anyres_features"])
def test_mm_utils_match_jax(fn):
    """Every image function on seeded images, bit for bit."""
    for seed in range(2):
        for img in _images(seed):
            h, w = img.shape[:2]
            calls = {
                "expand2square": [(img, (122, 116, 104)),
                                  (img.astype(np.float32), (0, 0, 0))],
                "resize_bilinear": [(img, (28, 28)), (img, (13, 40)),
                                    (img, (h, w))],
                "siglip_preprocess": [(img, 28), (img, 14)],
                "select_best_resolution": [((w, h), PINPOINTS)],
                "resize_and_pad_image": [(img, (56, 28)), (img, (28, 56))],
                "divide_to_patches": [(img, 14), (img, 9)],
                "get_anyres_image_grid_shape": [((w, h), PINPOINTS, 28),
                                                ((w, h), str(PINPOINTS), 28)],
                "process_anyres_image": [(img, PINPOINTS, 28, 28),
                                         (img.astype(np.float32) / 255.0,
                                          PINPOINTS, 28, 28)],
                "process_images": [([img, img[::-1]], "pad", 28),
                                   # the global view is resized to the
                                   # default 384 whatever the crop size
                                   ([img], "anyres", 384,
                                    [(384, 768), (768, 384)]),
                                   ([img, img[:, ::-1]], None, 28)],
                "unpad_image": [(np.arange(8 * 8 * 3).reshape(8, 8, 3),
                                 (w, h))],
                "merge_anyres_features": [],
            }[fn]
            if fn == "merge_anyres_features":
                n_views = JU.get_anyres_image_grid_shape(
                    (w, h), PINPOINTS, 28)
                n_views = 1 + n_views[0] * n_views[1]
                feats = np.random.default_rng(seed).normal(
                    size=(n_views, 4, 5))
                nl = np.ones((5,))
                calls = [(feats, (w, h), PINPOINTS, 28, 2, mt, nl)
                         for mt in ("spatial", "spatial_unpad")]
            for args in calls:
                _eq(getattr(U, fn)(*args), getattr(JU, fn)(*args))


def test_tokenizer_image_token_and_helpers_match_jax():
    rng = random.Random(0)
    for _ in range(30):
        parts = [_text(rng, 0, 5) for _ in range(rng.randint(1, 4))]
        prompt = "<image>".join(parts)
        if rng.random() < 0.3:
            prompt = "<image>" + prompt
        for bos in (128000, None):
            assert U.tokenizer_image_token(prompt, fake_tokenize,
                                           bos_token_id=bos) == \
                JU.tokenizer_image_token(prompt, fake_tokenize,
                                         bos_token_id=bos)
    from PIL import Image

    img = np.arange(20 * 30 * 3, dtype=np.uint8).reshape(20, 30, 3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    _eq(U.load_image_from_base64(b64), JU.load_image_from_base64(b64))
    _eq(U._to_array(Image.fromarray(img)), JU._to_array(Image.fromarray(img)))
    for path in ("a/b/checkpoint-100", "/x/model/", "m"):
        assert U.get_model_name_from_path(path) == \
            JU.get_model_name_from_path(path)
    _eq(U.SIGLIP_MEAN, JU.SIGLIP_MEAN)
    _eq(U.SIGLIP_STD, JU.SIGLIP_STD)


# ---------------------------------------------------------------------------
# round masking
# ---------------------------------------------------------------------------

def _sources(rng, has_image, version):
    n_rounds = 1 if version == "plain" else rng.randint(1, 3)
    conv = []
    if version != "plain" and rng.random() < 0.2:
        conv.append({"from": "gpt", "value": _text(rng)})   # dropped
    for r in range(n_rounds):
        q = _text(rng)
        if has_image and r == 0:
            q = "<image>\n" + q
        a = _text(rng)
        if has_image and rng.random() < 0.3:
            a = a + " <image> " + _text(rng)
        conv += [{"from": "human", "value": q}, {"from": "gpt", "value": a}]
    return [conv]


@pytest.mark.parametrize("version", ["llama3", "llama_2", "v1", "plain"])
def test_preprocess_matches_jax(version):
    """Ids and labels of every template's masking, with and without images,
    im_start/end wrapping, and a model_max_length that truncates the round
    arithmetic; the same warnings on a round-length mismatch."""
    rng = random.Random(version)
    for trial in range(24):
        has_image = trial % 2 == 0
        src = _sources(rng, has_image, version)
        mm = trial % 4 == 0
        max_len = 4096 if trial % 3 else 12
        outs = []
        for mask in (Mask, JMask):
            s = mask.preprocess_multimodal(json.loads(json.dumps(src)), mm) \
                if has_image else json.loads(json.dumps(src))
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                out = mask.preprocess(s, fake_tokenize, has_image=has_image,
                                      conv_version=version,
                                      model_max_length=max_len)
            outs.append((out, s, [str(x.message) for x in w]))
        assert outs[0] == outs[1]
    with pytest.raises(NotImplementedError):
        Mask.preprocess(src, fake_tokenize, conv_version="mpt")


# ---------------------------------------------------------------------------
# the native packer
# ---------------------------------------------------------------------------

def random_rows(rng, B):
    """Rows of bos, text, prompt and answer images (the pattern of
    tests/test_native.py) and some rows with no image."""
    ids, labs, n_slots = [], [], 0
    for _ in range(B):
        row_ids, row_labs = [128000], [IGNORE_INDEX]
        n_img = rng.randint(0, 3)
        n_slots += max(n_img, 1)
        for _ in range(n_img):
            for _ in range(rng.randint(0, 6)):
                t = rng.randint(10, 1000)
                row_ids.append(t)
                row_labs.append(t if rng.random() < 0.5 else IGNORE_INDEX)
            answer = rng.random() < 0.5
            if answer:
                row_ids.append(IM_START_TOKEN_ID)
                row_labs.append(IM_START_TOKEN_ID)
            row_ids.append(IMAGE_TOKEN_INDEX)
            row_labs.append(0 if answer else IGNORE_INDEX)
        for _ in range(rng.randint(1, 8)):
            t = rng.randint(10, 1000)
            row_ids.append(t)
            row_labs.append(t)
        ids.append(row_ids)
        labs.append(row_labs)
    return ids, labs, n_slots


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tokens", ["uniform", "per_image"])
@pytest.mark.parametrize("side", ["right", "left"])
def test_native_packer_matches_jax_pack_sequences(seed, tokens, side):
    """The port's C++ packer against the JAX package's Python packer, every
    PackedBatch field bit for bit, with a uniform K or per-image token
    counts (anyres), including rows that the max length truncates."""
    assert N.native_available(), N.NATIVE.error
    rng = random.Random(seed * 7 + (tokens == "uniform"))
    for _ in range(4):
        K, T = rng.choice([(3, 24), (4, 20), (2, 64), (5, 12)])
        ids, labs, n_slots = random_rows(rng, rng.randint(1, 5))
        slots = n_slots + rng.randint(0, 2)
        kw = {}
        if tokens == "per_image":
            tpi = [rng.randint(1, 6) for _ in range(slots)]
            kw = dict(tokens_per_image=tpi,
                      gather_capacity=sum(tpi) + rng.randint(0, 3))
        use_labels = rng.random() < 0.8
        args = (ids, labs if use_labels else None, K, T, slots, side)
        assert_packed_equal(N.pack_sequences_native(*args, **kw),
                            JP.pack_sequences(*args, **kw))


def test_native_packer_refuses_what_jax_refuses():
    ids = [[1, IMAGE_TOKEN_INDEX, 2], [3, IMAGE_TOKEN_INDEX, 4]]
    for args, kw in (((ids, None, 2, 16, 1), {}),
                     ((ids, None, 2, 16, 2), dict(tokens_per_image=[3]))):
        with pytest.raises(ValueError):
            JP.pack_sequences(*args, **kw)
        with pytest.raises(ValueError):
            N.pack_sequences_native(*args, **kw)


def test_pack_counts_which_packer_ran(monkeypatch):
    ids, labs = [[1, IMAGE_TOKEN_INDEX, 2]], [[IGNORE_INDEX] * 3]
    before = dict(N.PACKS)
    N.pack(ids, labs, 2, 8, 1)
    assert N.PACKS["native"] == before.get("native", 0) + 1
    monkeypatch.setattr(N, "NATIVE", N._Native())
    monkeypatch.setattr(N, "build", lambda: (_ for _ in ()).throw(
        RuntimeError("no C++ compiler (g++) for the native packer")))
    assert not N.native_available() and "g++" in N.NATIVE.error
    assert_packed_equal(N.pack(ids, labs, 2, 8, 1),
                        JP.pack_sequences(ids, labs, 2, 8, 1))
    assert N.PACKS["python"] == before.get("python", 0) + 1
    with pytest.raises(RuntimeError, match="unavailable"):
        N.pack_sequences_native(ids, labs, 2, 8, 1)


def test_native_build_is_keyed_by_source_and_portable(tmp_path, monkeypatch):
    """The library lands in the build directory under a name hashed over
    the source; an edited source gets another name; the flags carry no
    -march=native (a copied build directory may meet another CPU)."""
    src = tmp_path / "packer.cpp"
    src.write_bytes(N.SOURCE.read_bytes())
    monkeypatch.setattr(N, "SOURCE", src)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    assert not any("march" in f for f in N.CXX_FLAGS)
    first = N.library_path()
    assert first.parent == tmp_path / "build" and first.suffix == ".so"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert N.library_path() != first
    out = N.build()
    assert out == N.library_path() and out.exists()
    assert N.build() == out     # reused, not rebuilt
    assert [p.name for p in (tmp_path / "build").iterdir()] == [out.name]


@pytest.fixture()
def tricky_jsonl(tmp_path):
    rows = [
        {"image": "a.png", "conversations": [
            {"from": "human", "value": "<image>\nwhat   is\tthis?"},
            {"from": "gpt", "value": "a cat"}]},
        {"image": None, "conversations": [{"value": "hello world three"}]},
        {"conversations": [{"value": ""}, {"value": "  "}]},
        {"image": ["x.png", "y.png"], "conversations": [{"value": "multi"}]},
        {"image": "z.png"},
        {"image": "u.png", "conversations": [{"value": "café naïve 😀"}]},
    ]
    rng = random.Random(1)
    for i in range(40):
        rows.append({"image": f"i{i}.png" if rng.random() < 0.5 else None,
                     "conversations": [{"value": _text(rng, 0, 12)}]})
    path = tmp_path / "tricky.jsonl"
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=rng.random() < 0.5) + "\n")
    return str(path)


def test_jsonl_index_and_modality_lengths_match_jax(tricky_jsonl):
    """The native one-pass scans against the JAX package's Python scans
    (its native library is made unavailable here), and the sidecar cache:
    what one package writes, the other reads."""
    offsets = JD.LazySupervisedDataset(
        tricky_jsonl, fake_tokenize, JD.DataConfig())._index_file()
    assert N.jsonl_index_native(tricky_jsonl).tolist() == offsets
    ref = JD.LazySupervisedDataset(tricky_jsonl, fake_tokenize,
                                   JD.DataConfig())._scan_modality_lengths()
    assert N.modality_lengths_native(tricky_jsonl).tolist() == ref
    ds = D.LazySupervisedDataset(tricky_jsonl, fake_tokenize, D.DataConfig())
    assert ds.line_offsets == offsets
    assert ds.modality_lengths == ref               # writes the sidecar
    assert os.path.exists(tricky_jsonl + ".modlen.npy")
    jds = JD.LazySupervisedDataset(tricky_jsonl, fake_tokenize,
                                   JD.DataConfig())
    jds._scan_modality_lengths = None               # must read the cache
    assert jds.modality_lengths == ref


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows_dir(tmp_path_factory):
    """One JSONL per sample kind, and the images and video they name."""
    import cv2
    from PIL import Image

    d = tmp_path_factory.mktemp("rows")
    rng = np.random.default_rng(5)
    paths = {}
    for name, hw in (("a", (40, 60)), ("b", (50, 30)), ("c", (33, 47))):
        p = d / f"{name}.png"
        Image.fromarray(rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
                        ).save(p)
        paths[name] = str(p)
    cot = d / "visual_cot_img.png"
    Image.fromarray(rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
                    ).save(cot)
    video = str(d / "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 5.0,
                             (32, 24))
    for i in range(20):
        writer.write(np.full((24, 32, 3), i * 12, np.uint8))
    writer.release()

    def conv(q, a, *more):
        out = [{"from": "human", "value": q}, {"from": "gpt", "value": a}]
        return out + [{"from": f, "value": v} for f, v in more]

    kinds = {
        "image": {"id": "i", "image": paths["a"],
                  "conversations": conv("<image>\nwhat is it", "a thing")},
        "answer_image": {"id": "g", "image": [paths["a"], paths["b"]],
                         "conversations": conv("<image>\ndraw a cat",
                                               "here <image> done")},
        "multi_image": {"id": "m", "image": [paths["a"], paths["b"],
                                             paths["c"]],
                        "conversations": conv("<image><image>\ncompare",
                                              "same", ("human",
                                                       "<image> and this"),
                                              ("gpt", "also same"))},
        "vstar": {"id": "vstar_3", "image": paths["c"],
                  "target_instances": [{"name": "cat", "bbox": [3, 4, 10, 8]},
                                       {"name": "dog",
                                        "bbox": [20, 5, 40, 30]}],
                  "conversations": conv(
                      "<image>\nAdditional visual information to focus on: "
                      "<object>; <object>.\nwhere is the cat", "left")},
        "visual_cot": {"id": "v", "image": [str(cot),
                                            "bbox###[5, 6, 30, 40]"],
                       "conversations": conv(
                           "<image>\nwhat color is it? Please provide the "
                           "bounding box coordinate of the region",
                           "[5, 6, 30, 40]", ("human", "<image>"),
                           ("gpt", "red"))},
        "metaclip": {"id": "mc", "image": rng.integers(
            0, 256, (2, 18, 22, 3)).tolist(),
            "conversations": conv("<image> and <image>\ncaption", "birds")},
        "text_only": {"id": "t", "image": None,
                      "conversations": conv("hello there", "hi again",
                                            ("human", "more"),
                                            ("gpt", "sure thing"))},
        "video": {"id": "vid", "image": video,
                  "conversations": conv("<video>", "ignored")},
        "video_k700": {"id": "k700_1", "image": video,
                       "conversations": conv("what happens", "it fades")},
        "bad": {"id": "bad", "image": str(d / "missing.png"),
                "conversations": conv("<image>\nx", "y")},
    }
    files = {}
    for kind, row in kinds.items():
        name = "metacliptar.jsonl" if kind == "metaclip" else f"{kind}.jsonl"
        p = d / kind
        p.mkdir()
        rows = [row, kinds["image"]] if kind == "bad" else [row]
        with open(p / name, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        files[kind] = str(p / name)
    return files


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        _eq(a[k], b[k])


@pytest.mark.parametrize("aspect", ["square", "pad"])
@pytest.mark.parametrize("kind", ["image", "answer_image", "multi_image",
                                  "vstar", "visual_cot", "metaclip",
                                  "text_only", "video", "video_k700", "bad"])
def test_dataset_items_match_jax(rows_dir, kind, aspect):
    """__getitem__ of each sample kind: ids, labels, pixels and the
    modality length, bit for bit, with the same seeded rewriting. The
    tokenizer is chip_smoke.py's, with the LLaMA-3 special ids."""
    from chip_smoke import word_tokenize

    path = rows_dir[kind]
    for seed in (0, 3):
        items = []
        for mod in (D, JD):
            cfg = mod.DataConfig(data_path=path, image_size=28,
                                 image_aspect_ratio=aspect)
            ds = mod.LazySupervisedDataset(path, word_tokenize, cfg,
                                           seed=seed)
            items.append([ds[i] for i in range(len(ds))])
        for a, b in zip(*items):
            _assert_items_equal(a, b)
    row = items[0][0]
    assert row["pixels"] is not None and np.isfinite(row["pixels"]).all()
    if kind == "answer_image":
        assert IM_START_TOKEN_ID in row["labels"]


# ---------------------------------------------------------------------------
# the collator and the iterator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_jsonl(tmp_path_factory):
    """10 image rows (some with an answer image) and 8 text-only rows of
    varying lengths."""
    from PIL import Image

    d = tmp_path_factory.mktemp("mixed")
    rng = random.Random(2)
    img = d / "m.png"
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (30, 44, 3)).astype(np.uint8)).save(img)
    rows = []
    for i in range(10):
        answer = " <image> " if i % 3 == 0 else " "
        rows.append({"id": f"img{i}",
                     "image": [str(img)] * (2 if answer.strip() else 1),
                     "conversations": [
                         {"from": "human",
                          "value": "<image>\n" + _text(rng, 1, 12)},
                         {"from": "gpt",
                          "value": _text(rng, 1, 9) + answer + "ok"}]})
    for i in range(8):
        rows.append({"id": f"txt{i}", "image": None, "conversations": [
            {"from": "human", "value": _text(rng, 2, 14)},
            {"from": "gpt", "value": _text(rng, 1, 10)}]})
    random.Random(3).shuffle(rows)
    path = d / "mixed.jsonl"
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _iterators(path, tokenize=fake_tokenize, **it_kw):
    out = []
    for mod in (D, JD):
        cfg = mod.DataConfig(data_path=path, image_size=28)
        ds = mod.LazySupervisedDataset(path, tokenize, cfg, seed=1)
        col = mod.PackedCollator(num_image_tokens=4, max_seq_len=48,
                                 num_image_slots=6, image_size=28)
        out.append(mod.DataIterator(ds, col, **it_kw))
    return out


@pytest.mark.parametrize("mode", ["shuffle", "group_by_modality",
                                  "token_buckets"])
def test_iterator_batches_match_jax_over_two_epochs(mixed_jsonl, mode):
    """Every batch of two epochs (packed planes and pixels), the state at
    each batch, and a resume from a mid-epoch state."""
    kw = {"shuffle": dict(batch_size=3, seed=4),
          "group_by_modality": dict(batch_size=2, seed=5,
                                    group_by_modality=True),
          "token_buckets": dict(batch_size=2, seed=6, token_buckets=(1, 2, 4),
                                accum_steps=2)}[mode]
    mine, ref = _iterators(mixed_jsonl, **kw)
    n = 2 * (18 // kw["batch_size"])
    gm, gr = iter(mine), iter(ref)
    states = []
    for i in range(n + 1):
        (pm, xm), (pr, xr) = next(gm), next(gr)
        assert_packed_equal(pm, pr)
        assert np.array_equal(xm, xr)
        assert mine.state_dict() == ref.state_dict()
        states.append(mine.state_dict())
    assert states[-1]["epoch"] == 2
    if mode == "token_buckets":
        ks = [mine._bucket_for(0, b) for b in range(8)]
        assert ks[0::2] == ks[1::2] and len(set(ks)) > 1
    resumed, _ = _iterators(mixed_jsonl, **kw)
    resumed.load_state_dict(states[4])
    mine2, _ = _iterators(mixed_jsonl, **kw)
    g2 = iter(mine2)
    for _ in range(5):
        next(g2)
    for a, b in zip(iter(resumed), g2):
        assert_packed_equal(a[0], b[0])
        assert resumed.state_dict() == mine2.state_dict()
        if resumed.state_dict() == states[9]:
            break


def test_iterator_refuses_process_shards(mixed_jsonl):
    """Shards that do not split the batch or its image slots evenly are
    refused with JAX's errors (6 slots; batch 3 over 2 ranks, batch 4 over
    4 ranks); an even split is taken."""
    mine, ref = _iterators(mixed_jsonl, batch_size=2)
    for batch_size, count, match in ((3, 2, "batch_size must divide"),
                                     (4, 4, "num_image_slots must divide")):
        for it in (mine, ref):
            with pytest.raises(ValueError, match=match):
                type(it)(it.dataset, it.collator, batch_size,
                         process_index=0, process_count=count)
    shard = D.DataIterator(mine.dataset, mine.collator, 2, process_index=1,
                           process_count=2)
    packed, pixels = next(iter(shard))
    assert packed.tokens.shape[0] == 1 and pixels.shape[0] == 3


def test_collator_packs_natively_and_counts(mixed_jsonl):
    mine, _ = _iterators(mixed_jsonl, batch_size=2)
    before = N.PACKS["native"]
    next(iter(mine))
    assert N.PACKS["native"] == before + 1


# ---------------------------------------------------------------------------
# the device resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_fused_resize_normalize_matches_jax(dtype):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 50, 70, 3)).astype(dtype)
    for size in (32, 64):
        ref = np.asarray(JPre.fused_resize_normalize(jnp.asarray(frames),
                                                     out_size=size))
        out = Pre.fused_resize_normalize(torch.from_numpy(frames),
                                         out_size=size)
        assert out.dtype == torch.float32 and out.device.type == "cpu"
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    _eq(Pre._interp_matrix(50, 32), JPre._interp_matrix(50, 32))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

def _write_tokenizer(d):
    """A word-level HF tokenizer that prepends <|begin_of_text|>, written
    through `tokenizers`, loadable by AutoTokenizer."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    specials = ["<unk>", "<|begin_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>"]
    vocab = {w: i for i, w in enumerate(specials + ["user", "assistant"]
                                        + WORDS)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(specials)
    tok.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A",
        special_tokens=[("<|begin_of_text|>", 1)])
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<|begin_of_text|>",
                   "unk_token": "<unk>"}, f)
    return str(d)


def test_train_cli_trains_on_the_cpu(mixed_jsonl, tmp_path, capsys,
                                    monkeypatch):
    from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                            MultimodalConfig, SiglipConfig,
                                            TrainConfig)
    from metamorph_tpu_torch.train import main as cli

    cfg = MetaMorphConfig(
        llama=LlamaConfig.tiny(vocab_size=64), siglip=SiglipConfig.tiny(),
        mm=MultimodalConfig(num_image_tokens=4),
        train=TrainConfig(max_seq_len=48, batch_size=2,
                          max_images_per_batch=6, total_steps=2, remat=False))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    out_dir = tmp_path / "out"
    argv = ["--config", str(cfg_path), "--data-path", mixed_jsonl,
            "--tokenizer", _write_tokenizer(tmp_path / "tok"),
            "--output-dir", str(out_dir), "--save-steps", "1",
            "--group-by-modality-length"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)                      # the card by default
    from metamorph_tpu_torch.train import trainer

    real = []                               # each step's real tokens
    to_arrays = trainer.batch_to_arrays

    def counting(packed):
        arrays = to_arrays(packed)
        real.append(int(arrays["attn_mask"].sum()))
        return arrays

    monkeypatch.setattr(trainer, "batch_to_arrays", counting)
    packs = N.PACKS["native"]
    out = cli.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(trainer, "batch_to_arrays", to_arrays)
    assert out["step"] == 2
    # the batches are packed in the loader's worker process, which reports
    # its packs with each batch
    assert N.PACKS["native"] == packs + 2
    rows = [json.loads(l) for l in (out_dir / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["n_text_tokens"] > 0
               and r["data_wait_s"] >= 0 and r["step_s"] > 0 for r in rows)
    # throughput counts the step's real tokens, not batch x max_seq_len
    assert len(real) == 2 and 0 < real[1] < 2 * 48
    assert rows[1]["tokens_per_sec_per_chip"] * (
        rows[1]["time"] - rows[0]["time"]) == pytest.approx(real[1],
                                                           rel=1e-6)
    meta = json.loads((out_dir / "step_2" / "meta.json").read_text())
    assert meta["data_state"]["step_in_epoch"] >= 2
    assert (out_dir / "step_2" / "state.pt").exists()
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "final_step"] == 2
    # --multihost reads torchrun's environment, which this process lacks;
    # ring attention without a sequence group runs as flash attention
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(argv + ["--device", "cpu", "--no-resume", "--multihost"])
    ring = cli.main(argv + ["--device", "cpu", "--no-resume", "--attn-impl",
                            "ring", "--save-steps", "0", "--output-dir",
                            str(out_dir) + "_ring"])
    assert ring["step"] == 2
    # the weight flags reach train(), which reads the files they name
    for flag in (["--hf-llama-path", "/nowhere"],
                 ["--hf-siglip-path", "/nowhere"],
                 ["--pretrain-mm-mlp-adapter", "/nowhere"]):
        with pytest.raises(FileNotFoundError, match="nowhere"):
            cli.main(argv + ["--device", "cpu", "--no-resume"] + flag)
    quiet = tmp_path / "no_saves"
    out = cli.main(argv + ["--device", "cpu", "--save-steps", "0",
                           "--output-dir", str(quiet)])
    assert out["step"] == 2 and os.listdir(quiet) == ["metrics.jsonl"]


def test_train_cli_names_missing_transformers(monkeypatch):
    import sys

    from metamorph_tpu_torch.train import main as cli

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        cli.load_tokenizer("/nowhere")


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_jsonl_to_train_steps_matches_jax(mixed_jsonl):
    """One JSONL through both packages' dataset, collator and iterator into
    the JAX train step (jitted, flash kernels in interpret mode) and the
    port's train_step: equal batches, and equal metrics for three steps.
    The tokenizer is chip_smoke.py's, whose ids fit the vocabulary and put
    <image_start> at 128256, so the answer images get AR targets."""
    from chip_smoke import word_tokenize
    from metamorph_tpu.models import metamorph as JM
    from metamorph_tpu.train import train_step as JTS
    from metamorph_tpu.train.optimizer import make_optimizer as jax_optimizer
    from metamorph_tpu_torch.convert import from_jax_params
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.train import optimizer as opt_lib
    from metamorph_tpu_torch.train import train_step as TS
    from tests.test_torch_train import (METRICS, _assert_metrics, jax_cfg,
                                        port_cfg)

    jcfg = jax_cfg(total_steps=20)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, max_seq_len=48, batch_size=3, max_images_per_batch=6))
    cfg = port_cfg(jcfg)
    mine, ref = _iterators(mixed_jsonl, word_tokenize, batch_size=3, seed=8,
                           group_by_modality=True)
    batches = []
    for (pm, xm), (pr, xr) in zip(iter(mine), iter(ref)):
        assert_packed_equal(pm, pr)
        assert np.array_equal(xm, xr)
        batches.append((batch_to_arrays(pm), xm))
        if len(batches) == 3:
            break
    assert sum(b["image_ar_mask"].sum() for b, _ in batches) > 0

    jp = JM.init_metamorph_params(jax.random.PRNGKey(1), jcfg,
                                  dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tx = jax_optimizer(jcfg.train, jp)
    jstate = JTS.init_train_state(jp, jcfg)
    jstep = jax.jit(lambda s, b, x: JTS.train_step(s, b, x, jcfg, tx,
                                                   attn_impl="flash"))
    state = TS.init_train_state(model, cfg)
    ttx = opt_lib.make_optimizer(cfg.train, model)
    for arrays, pixels in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    arrays.items()}, jnp.asarray(pixels))
        state, tm = TS.train_step(
            state, {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in arrays.items()},
            torch.from_numpy(pixels), cfg, ttx)
        _assert_metrics(jm, tm, METRICS + ("grad_norm",))
