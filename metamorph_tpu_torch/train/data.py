"""Training data pipeline: lazy JSONL dataset -> packed batches. A copy of
`metamorph_tpu/train/data.py` (that package imports JAX on import): for the
same JSONL, tokenizer and seed, both packages give the same ids, labels and
pixels, bit for bit, and visit the samples in the same order.

Host-side (CPU) equivalent of the reference's `LazySupervisedDataset` +
`DataCollatorForSupervisedDataset` (`metamorph/train/train.py:663-1296`),
re-targeted at the static-shape packer:

  * JSONL byte-offset lazy index (`train.py:849-863`);
  * per-sample dispatch in `__getitem__` (`train.py:1037-1248`):
      - visual-CoT bbox-crop 2-image rewriting (`:1068-1113`),
      - video decode + frame sampling, 1 FPS for VideoQA ids (`:1119-1146`,
        `processVideo` `:1005-1033`), through OpenCV, imported when a video
        is decoded,
      - 7 templated video-prediction task families (forward / split / reverse /
        alternating / rearrange / interval / next-X, `:870-999`),
      - V* visual-search rewriting + bbox drawing (`:687-752`, `:1147-1176`),
      - pre-loaded image arrays for metaclip data (no decoder needed),
      - plain image (`:1179`), decoded by PIL, imported when a file is read;
  * pad-or-square preprocess (`:1191-1207`);
  * sentinel-count consistency check + 70-image cap + exception -> next index
    (`:1224-1248`);
  * collation: instead of pad_sequence + runtime splice, the collator packs
    into the fixed-shape gather plan, with the native packer where it built
    (`multimodal/native.py` counts which packer ran).

The iterator is deterministic (seeded per epoch) and resumable (skip count).
With `process_count` > 1 each rank packs only its shard of every global
batch (multi-GPU training).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from metamorph_tpu_torch.constants import IMAGE_TOKEN_INDEX
from metamorph_tpu_torch.multimodal import native
from metamorph_tpu_torch.multimodal.mm_utils import (SIGLIP_MEAN,
                                                     expand2square,
                                                     siglip_preprocess)
from metamorph_tpu_torch.multimodal.packing import PackedBatch
from metamorph_tpu_torch.train.masking import preprocess, preprocess_multimodal

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".wmv", ".flv", ".webm")


# ---------------------------------------------------------------------------
# video decoding (OpenCV in place of decord)
# ---------------------------------------------------------------------------

def decode_video_frames(video_path: str, cutoff: int = 45,
                        interval_t: Optional[float] = None,
                        rng: Optional[random.Random] = None
                        ) -> Tuple[List[np.ndarray], float]:
    """Sample frames every `interval_t` seconds (random interval when None),
    capped at `cutoff` frames — semantics of `processVideo` (`train.py:1005-1033`)."""
    import cv2

    rng = rng or random
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 0
    num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    video_length = num_frames / fps if fps > 0 else 0
    if video_length == 0:
        cap.release()
        raise ValueError("unable to determine video length")

    if interval_t is None:
        min_interval = max(2 / fps, 0.1)
        max_interval = min(10, max(video_length / 2, min_interval))
        interval_t = round(rng.uniform(min_interval, max_interval), 1)
    else:
        interval_t = round(interval_t, 1)

    frames = []
    current_time = 0.0
    while current_time < video_length and len(frames) < cutoff:
        idx = min(int(current_time * fps), num_frames - 1)
        cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        current_time += interval_t
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return frames, interval_t


# ---------------------------------------------------------------------------
# video-prediction task templates (same 7 task families as train.py:870-999)
# ---------------------------------------------------------------------------

_TWO_FRAME_TEMPLATES = [
    ("{f0} Predict visually what this scene looks like {t} seconds later.",
     "{f1}"),
    ("Here is a frame: {f0}. Jump ahead {t} seconds — what would we see?",
     "Here is the frame {t} seconds later: {f1}"),
    ("{f0} How do you expect this scene to evolve over the next {t} seconds?",
     "My visual prediction: {f1}"),
    ("Starting from {f0}, forecast the frame {t} seconds in the future.",
     "Forecast: {f1}"),
    ("{f0} Please predict the next state:",
     "This is my answer: {f1}"),
]


def video_task_description(n_frames: int, interval_t: float, rng: random.Random):
    """Returns (question, answer, reorder_fn) with <image> tags; reorder_fn
    maps the raw frame list to the order the tags reference."""
    tags = ["<image>"] * n_frames
    if n_frames == 2:
        q, a = rng.choice(_TWO_FRAME_TEMPLATES)
        return (q.format(f0=tags[0], t=interval_t),
                a.format(f1=tags[1], t=interval_t), None)

    start = rng.randint(0, n_frames - 2)
    end = rng.randint(start + 1, n_frames - 1)
    sel = tags[start:end + 1]
    n = len(sel)

    candidates = []
    # 1. forward prediction
    candidates.append((
        f"A video starts with this frame: {sel[0]}. Predict the next {n-1} "
        f"frames, each {interval_t} seconds apart.",
        f"Here are my predicted next {n-1} frames, {interval_t} seconds apart: "
        + " ".join(sel[1:]),
        lambda ims: ims[start:end + 1]))
    # 2. split prediction
    split = rng.randint(1, n - 1)
    candidates.append((
        f"These are the first {split} frame(s) of a {n}-frame clip "
        f"({interval_t}s apart): {''.join(sel[:split])}. What happens in the "
        f"remaining {n-split} frame(s)?",
        f"My prediction for the remaining {n-split} frame(s): {''.join(sel[split:])}",
        lambda ims: ims[start:end + 1]))
    # 3. reverse prediction
    candidates.append((
        f"This is the final frame of a {n}-frame video ({interval_t}s apart): "
        f"{sel[-1]}. Work backwards and predict the previous {n-1} frames.",
        f"Working backwards, the previous frames were: {''.join(sel[-2::-1])}",
        lambda ims: ims[start:end + 1][::-1]))
    # 4. alternating frames
    candidates.append((
        f"I can only see every other frame of a {n}-frame clip "
        f"({interval_t}s apart): {' '.join(sel[::2])}. Predict the "
        f"{len(sel[1::2])} missing frames.",
        f"The missing frames should look like: {''.join(sel[1::2])}",
        lambda ims: ims[start:end + 1][::2] + ims[start:end + 1][1::2]))
    # 5. rearrange frames
    order = list(range(n))
    rng.shuffle(order)
    shuffled = [sel[i] for i in order]
    candidates.append((
        f"These {n} frames ({interval_t}s apart) are shuffled: "
        f"{' '.join(shuffled)}. Put them in the right order.",
        f"In the correct order the frames are: {' '.join(sel)}",
        lambda ims: ([ims[start:end + 1][i] for i in order] + ims[start:end + 1])))
    # 6. time-interval estimation
    candidates.append((
        f"Here are {n} consecutive video frames: {' '.join(sel)}. How much "
        f"time passes between frames?",
        f"Comparing the {n} frames, roughly {interval_t} seconds pass between "
        f"each frame.",
        lambda ims: ims[start:end + 1]))
    # 7. predict next X
    predict_count = rng.randint(1, min(3, n_frames - end))
    candidates.append((
        f"Given this sequence: {' '.join(sel)}. Predict the next "
        f"{predict_count} image(s).",
        f"My prediction for the next {predict_count} image(s): "
        + " ".join(tags[end + 1:end + 1 + predict_count]),
        lambda ims: ims[start:end + 1 + predict_count]))

    return rng.choice(candidates)


# ---------------------------------------------------------------------------
# V* visual-search rewriting (train.py:687-752)
# ---------------------------------------------------------------------------

_VSTAR_ENCOURAGEMENTS = [
    "Ok, let's focus on the important part:",
    "Let's start by visualizing this:",
    "Let's consider this visually:",
    "Visualize the key area:",
    "Let's think about this visually:",
    "Here's the visual perspective:",
]

COT_HUMAN_PREFIXES = [
    "Imagine the important part visually:",
    "Visualize the critical area,",
    "Picture the relevant detail:",
    "Focus on the key visual element:",
    "Think about this visually,",
    "",
]

COT_GPT_PREFIXES = list(_VSTAR_ENCOURAGEMENTS) + [""]


def process_vstar_question(q: str, rng: random.Random) -> str:
    q = (q.replace("Additional visual information to focus on: ", "")
          .replace("<object>; <object>.\n", "").replace("<object>.", ""))
    return f"{rng.choice(_VSTAR_ENCOURAGEMENTS)} {q}"


def process_vstar_answer(a: str, target_instances) -> str:
    out = "I will identify the key visual elements and answer the question. The key elements are "
    names = [e["name"] for e in (target_instances or [])]
    if len(names) > 1:
        out += ", ".join(names[:-1]) + ", and " + names[-1] + "."
    elif names:
        out += names[0] + "."
    else:
        out = out.rstrip() + "."
    out += (" Then I will identify these elements with bounding boxes <image>. "
            f"Based on these highlighted areas, here's my response to the question: {a}")
    return out


def draw_bounding_boxes(arr: np.ndarray, bboxes) -> np.ndarray:
    """Red rectangles (width 5) on a numpy RGB image."""
    out = arr.copy()
    h, w = out.shape[:2]
    for e in bboxes:
        x, y, bw, bh = (int(v) for v in e["bbox"])
        x2, y2 = min(x + bw, w - 1), min(y + bh, h - 1)
        x, y = max(x, 0), max(y, 0)
        for t in range(5):
            if y + t < h:
                out[y + t, x:x2 + 1] = (255, 0, 0)
            if y2 - t >= 0:
                out[y2 - t, x:x2 + 1] = (255, 0, 0)
            if x + t < w:
                out[y:y2 + 1, x + t] = (255, 0, 0)
            if x2 - t >= 0:
                out[y:y2 + 1, x2 - t] = (255, 0, 0)
    return out


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

@dataclass
class DataConfig:
    data_path: str = ""
    image_aspect_ratio: str = "square"   # square | pad | anyres
    image_size: int = 384
    is_multimodal: bool = True
    mm_use_im_start_end: bool = True
    conv_version: str = "llama3"
    model_max_length: int = 4096
    max_images_per_sample: int = 70      # reference cap (`train.py:1229-1230`)
    lazy_preprocess: bool = True
    # anyres tiling candidates, (w, h) canvases (`mm_utils.py:125-151`)
    grid_pinpoints: Tuple[Tuple[int, int], ...] = (
        (384, 768), (768, 384), (768, 768), (1152, 384), (384, 1152))


class LazySupervisedDataset:
    """JSONL-backed lazy dataset. Each line: {"id", "image" (path | [paths] |
    video path | null), "conversations": [{"from","value"},...]}."""

    def __init__(self, data_path: str, tokenize: Callable[[str], List[int]],
                 cfg: DataConfig, seed: int = 42):
        self.data_path = data_path
        self.tokenize = tokenize
        self.cfg = cfg
        self.rng = random.Random(seed)
        # metaclip datasets carry pre-loaded image arrays in the sample dict
        # instead of file paths (`train.py:776-784,1061`); add_prompts is set
        # but never consumed by the reference — kept as documented vestige.
        self.use_metaclip = "metacliptar" in data_path
        self.add_prompts = "metaclip" in data_path
        self.line_offsets = self._index_file()
        self._modality_lengths: Optional[List[int]] = None

    def _index_file(self) -> List[int]:
        if native.native_available():
            try:
                return native.jsonl_index_native(self.data_path).tolist()
            except OSError:
                pass
        offsets = [0]
        with open(self.data_path, "rb") as f:
            while f.readline():
                offsets.append(f.tell())
        return offsets[:-1]

    def __len__(self):
        return len(self.line_offsets)

    @property
    def modality_lengths(self) -> List[int]:
        """Per-sample word-count length, sign-coded by modality (positive =
        multimodal, negative = text-only) — the attribute the reference's
        `LengthGroupedSampler` expects (`metamorph_trainer.py:66-91`; LLaVA
        defines it as conversation word counts). Resolution order: sidecar
        cache beside the JSONL -> one native C++ pass (no per-line
        json.loads; minutes -> O(file read) on multi-million-row mixes) ->
        Python fallback scan. The result is cached to `<path>.modlen.npy`
        (best effort) keyed on the JSONL's size+mtime."""
        if self._modality_lengths is not None:
            return self._modality_lengths
        st = os.stat(self.data_path)
        cache = self.data_path + ".modlen.npy"
        key = np.asarray([st.st_size, int(st.st_mtime_ns)], np.int64)
        try:
            blob = np.load(cache, allow_pickle=False)
            if blob.shape[0] >= 2 and (blob[:2] == key).all():
                lengths = blob[2:].astype(int).tolist()
                if self.use_metaclip:
                    lengths = [abs(n) for n in lengths]
                self._modality_lengths = lengths
                return lengths
        except Exception:
            pass
        lengths = self._scan_modality_lengths()
        try:
            np.save(cache, np.concatenate(
                [key, np.asarray(lengths, np.int64)]))
        except Exception:
            pass  # read-only dataset dir: recompute next run
        if self.use_metaclip:  # metaclip rows are all image-bearing
            lengths = [abs(n) for n in lengths]
        self._modality_lengths = lengths
        return lengths

    def _scan_modality_lengths(self) -> List[int]:
        if native.native_available():
            try:
                return native.modality_lengths_native(self.data_path).tolist()
            except (OSError, ValueError):
                pass
        lengths = []
        with open(self.data_path, "r") as f:
            for line in f:
                dat = json.loads(line)
                n = sum(len(str(c.get("value", "")).split())
                        for c in dat.get("conversations", []))
                n = max(n, 1)
                lengths.append(n if dat.get("image") is not None else -n)
        return lengths

    def _load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))

    def _preprocess_pixels(self, arr: np.ndarray) -> np.ndarray:
        if self.cfg.image_aspect_ratio == "pad":
            bg = tuple(int(x * 255) for x in SIGLIP_MEAN)
            arr = expand2square(arr, bg)
        return siglip_preprocess(arr, self.cfg.image_size)

    def __getitem__(self, i: int, _depth: int = 0) -> Dict[str, Any]:
        if _depth > len(self):
            raise RuntimeError("all samples failed to load")
        try:
            return self._get_one(i)
        except Exception as e:  # bad sample -> next index (`train.py:1246-1248`)
            if _depth == 0:
                print(f"data: bug at {i}: {e}; skipping")
            return self.__getitem__((i + 1) % len(self), _depth + 1)

    def _get_one(self, i: int) -> Dict[str, Any]:
        with open(self.data_path, "r") as f:
            f.seek(self.line_offsets[i])
            dat = json.loads(f.readline().strip())
        sources = [dat]
        rng = self.rng
        images: List[np.ndarray] = []

        has_image = self.use_metaclip or dat.get("image") is not None
        if has_image:
            image_file = dat["image"]
            if self.use_metaclip:
                # pre-loaded image data (tar-backed), not paths (`train.py:1061-1063`);
                # a single image arrives as one HxWx3 array, multiple as a stack
                arr = np.asarray(image_file, np.uint8)
                images = list(arr) if arr.ndim == 4 else [arr]
            elif isinstance(image_file, list):
                if image_file and "visual_cot" in str(image_file[0]):
                    # visual-CoT: full image + bbox crop, rewritten 2-turn convo
                    image_path, bbox_str = image_file[0], image_file[1]
                    coords = [int(c.strip()) for c in
                              bbox_str.split("###")[1].strip("[]").split(",")]
                    arr = self._load_image(image_path)
                    x0, y0, x1, y1 = coords
                    images = [arr, arr[y0:y1, x0:x1]]
                    human = dat["conversations"][0]["value"]
                    gpt = dat["conversations"][3]["value"]
                    human = human.split(
                        "Please provide the bounding box coordinate of")[0].strip()
                    human = f"{rng.choice(COT_HUMAN_PREFIXES)} {human}"
                    gpt = f"{rng.choice(COT_GPT_PREFIXES)} <image> {gpt}"
                    sources[0]["conversations"] = [
                        {"from": "human", "value": human},
                        {"from": "gpt", "value": gpt},
                    ]
                else:
                    images = [self._load_image(p) for p in image_file]
            elif any(ext in str(image_file) for ext in VIDEO_EXTS):
                if "k700" in str(dat.get("id", "NA")):
                    # VideoQA at fixed 1 FPS, tags prepended (`train.py:1120-1125`)
                    frames, _ = decode_video_frames(image_file, interval_t=1, rng=rng)
                    images = frames
                    tags = "".join("<image>" for _ in frames)
                    sources[0]["conversations"][0]["value"] = (
                        tags + sources[0]["conversations"][0]["value"])
                else:
                    frames, interval = decode_video_frames(image_file, rng=rng)
                    if len(frames) < 2:
                        raise ValueError("video produced <2 frames")
                    q, a, reorder = video_task_description(len(frames), interval, rng)
                    images = reorder(frames) if reorder is not None else frames
                    sources[0]["conversations"] = [
                        {"from": "human", "value": q},
                        {"from": "gpt", "value": a},
                    ]
            elif "vstar" in str(dat.get("id", "NA")):
                q = process_vstar_question(dat["conversations"][0]["value"], rng)
                a = process_vstar_answer(dat["conversations"][1]["value"],
                                         dat.get("target_instances"))
                sources[0]["conversations"] = [
                    {"from": "human", "value": q},
                    {"from": "gpt", "value": a},
                ]
                arr = self._load_image(dat["image"])
                images = [arr, draw_bounding_boxes(arr, dat["target_instances"])]
            else:
                images = [self._load_image(image_file)]

            if self.cfg.image_aspect_ratio == "anyres":
                from metamorph_tpu_torch.multimodal.anyres import preprocess_anyres

                views, sizes = [], []
                for im in images:
                    v, s = preprocess_anyres(im, list(self.cfg.grid_pinpoints),
                                             self.cfg.image_size)
                    views.append(v)
                    sizes.append(s)
                pixels, image_sizes = views, sizes
            else:
                pixels = np.stack([self._preprocess_pixels(im) for im in images])
                image_sizes = None
            convs = preprocess_multimodal(
                copy.deepcopy([e["conversations"] for e in sources]),
                self.cfg.mm_use_im_start_end)
        else:
            pixels = None
            image_sizes = None
            convs = copy.deepcopy([e["conversations"] for e in sources])

        out = preprocess(convs, self.tokenize, has_image=has_image,
                         conv_version=self.cfg.conv_version,
                         model_max_length=self.cfg.model_max_length)
        ids, labels = out["input_ids"][0], out["labels"][0]

        count = sum(1 for t in ids if t == IMAGE_TOKEN_INDEX)
        n_imgs = 0 if pixels is None else len(pixels)
        if count != n_imgs:
            raise ValueError(f"sentinel/image mismatch {count} vs {n_imgs}")
        if count > self.cfg.max_images_per_sample:
            raise ValueError(f"too many images: {count}")

        if pixels is None and self.cfg.is_multimodal:
            # text-only sample still carries one dummy image (`train.py:1239-1242`)
            S = self.cfg.image_size
            if self.cfg.image_aspect_ratio == "anyres":
                pixels, image_sizes = [np.zeros((1, S, S, 3), np.float32)], [None]
            else:
                pixels = np.zeros((1, S, S, 3), np.float32)

        return {"input_ids": ids, "labels": labels, "pixels": pixels,
                "image_sizes": image_sizes,
                "modality_length": (len(ids) if has_image else -len(ids))}


# ---------------------------------------------------------------------------
# collator + batching
# ---------------------------------------------------------------------------

@dataclass
class PackedCollator:
    """Collate N samples into one fixed-shape PackedBatch + pixel stack.

    `num_image_tokens` may be overridden per call (multi-res bucket training,
    the reference's image_token_len==0 path bucketed to static shapes).

    `image_aspect_ratio="anyres"`: instances carry per-image view stacks +
    original sizes; the collator builds the batch view_map / tokens_per_image
    plan (static capacities) and a padded view-pixel stack.

    `num_image_slots` may be overridden per call too: one rank's shard of
    a global batch packs against its share of the slots (and, for anyres,
    of the view and token capacities)."""

    num_image_tokens: int
    max_seq_len: int
    num_image_slots: int
    image_size: int = 384
    image_aspect_ratio: str = "square"
    grid_pinpoints: Sequence[Tuple[int, int]] = ()
    merge_type: str = "spatial_unpad"
    patch_size: int = 14
    view_capacity: int = 0    # 0 -> derived from pinpoints * slots
    token_capacity: int = 0   # 0 -> derived (view_capacity * (P^2 + P))

    def _anyres_caps(self, num_image_slots: Optional[int] = None
                     ) -> Tuple[int, int, int]:
        """(patches per side P, view capacity, token capacity); for a
        shard's `num_image_slots`, the global capacities scaled by its
        share of the slots, which must divide them."""
        S, p = self.image_size, self.patch_size
        P = S // p
        max_tiles = max((w // S) * (h // S) for w, h in self.grid_pinpoints)
        vc = self.view_capacity or self.num_image_slots * (1 + max_tiles)
        tc = self.token_capacity or vc * (P * P + P)
        if num_image_slots is not None \
                and num_image_slots != self.num_image_slots:
            if (vc * num_image_slots) % self.num_image_slots \
                    or (tc * num_image_slots) % self.num_image_slots:
                raise ValueError(
                    "anyres capacities must divide evenly across hosts")
            vc = vc * num_image_slots // self.num_image_slots
            tc = tc * num_image_slots // self.num_image_slots
        return P, vc, tc

    def _collate_anyres(self, instances,
                        num_image_slots: Optional[int] = None
                        ) -> Tuple[PackedBatch, np.ndarray]:
        from metamorph_tpu_torch.multimodal.anyres import build_batch_plan

        P, vc, tc = self._anyres_caps(num_image_slots)
        S = self.image_size
        views, sizes, n_views = [], [], []
        for inst in instances:
            for v, sz in zip(inst["pixels"], inst["image_sizes"]):
                views.append(v)
                sizes.append(sz)
                n_views.append(v.shape[0])
        view_map, tokens_per_image = build_batch_plan(
            sizes, n_views, list(self.grid_pinpoints), S, P,
            self.merge_type, tc)
        packed = native.pack(
            [inst["input_ids"] for inst in instances],
            [inst["labels"] for inst in instances],
            self.num_image_tokens, self.max_seq_len,
            num_image_slots or self.num_image_slots,
            tokens_per_image=tokens_per_image, gather_capacity=tc)
        packed = dataclasses.replace(packed, view_map=view_map)
        total_views = sum(n_views)
        if total_views > vc:
            raise ValueError(f"batch has {total_views} anyres views > "
                             f"capacity {vc}")
        pixels = np.zeros((vc, S, S, 3), np.float32)
        off = 0
        for v in views:
            pixels[off:off + v.shape[0]] = v
            off += v.shape[0]
        return packed, pixels

    def __call__(self, instances: Sequence[Dict[str, Any]],
                 num_image_tokens: Optional[int] = None,
                 num_image_slots: Optional[int] = None
                 ) -> Tuple[PackedBatch, np.ndarray]:
        if self.image_aspect_ratio == "anyres":
            return self._collate_anyres(instances, num_image_slots)
        K = num_image_tokens or self.num_image_tokens
        N = num_image_slots or self.num_image_slots
        ids = [inst["input_ids"] for inst in instances]
        labels = [inst["labels"] for inst in instances]
        packed = native.pack(ids, labels, K, self.max_seq_len, N)
        pixel_list = []
        for inst in instances:
            if inst["pixels"] is not None:
                pixel_list.extend(inst["pixels"])
        S = self.image_size
        pixels = np.zeros((N, S, S, 3), np.float32)
        for j, px in enumerate(pixel_list[:N]):
            pixels[j] = px
        return packed, pixels


def modality_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                                    rng: random.Random) -> List[int]:
    """Group samples so each batch is single-modality and length-homogeneous —
    the reference's LengthGroupedSampler semantics
    (`metamorph_trainer.py:44-136`): positive length = multimodal, negative =
    text-only."""
    mm = [i for i, l in enumerate(lengths) if l > 0]
    lang = [i for i, l in enumerate(lengths) if l <= 0]
    out = []
    for group in (mm, lang):
        idx = list(group)
        rng.shuffle(idx)
        # megabatch sort by |length| then chunk
        mega = 50 * batch_size
        for s in range(0, len(idx), mega):
            chunk = sorted(idx[s:s + mega], key=lambda i: abs(lengths[i]),
                           reverse=True)
            out.extend(chunk)
    batches = [out[s:s + batch_size] for s in range(0, len(out), batch_size)]
    rng.shuffle(batches)
    return [i for b in batches for i in b]


class DataIterator:
    """Deterministic, resumable epoch iterator: the checkpoint stores
    (epoch, step_in_epoch) and a resume fast-forwards to it. The order per
    epoch and the token bucket per optimizer step come from
    `random.Random` seeded with the hash of an int tuple, as in the JAX
    package, so both packages visit the same samples in the same order.

    With `process_count` P > 1 each rank loads and packs only its shard of
    every global batch: rows b*B + i*B/P .. against N/P image slots (and,
    for anyres, its share of the view and token capacities), where i is
    the rank's `process_index`, its data-parallel coordinate
    (`parallel/mesh.dp_coordinate`); ranks that share a coordinate load the
    same shard. Every rank walks the same order, so the shards are
    disjoint and cover the batch. JAX re-bases each shard's gather
    indices to one global image table (`shift_packed_shard`), since GSPMD
    joins the shards into one global array; a rank of the port gathers
    from its own images only, so its shard keeps local numbering."""

    def __init__(self, dataset: LazySupervisedDataset, collator: PackedCollator,
                 batch_size: int, seed: int = 42, group_by_modality: bool = False,
                 token_buckets: Sequence[int] = (), accum_steps: int = 1,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.seed = seed
        self.group_by_modality = group_by_modality
        self.token_buckets = tuple(token_buckets)
        # all microbatches inside one optimizer step must share a token bucket
        # (the trainer stacks them; mixed K would change the packed shapes)
        self.accum_steps = max(int(accum_steps), 1)
        self.process_index = process_index
        self.process_count = max(int(process_count), 1)
        if self.process_count > 1:
            if batch_size % self.process_count:
                raise ValueError("batch_size must divide by process_count")
            if collator.num_image_slots % self.process_count:
                raise ValueError("num_image_slots must divide by process_count")
            if collator.image_aspect_ratio == "anyres":
                # shard budgets must split evenly (raises early if not)
                collator._anyres_caps(collator.num_image_slots
                                      // self.process_count)
        self.epoch = 0
        self.step_in_epoch = 0

    def _bucket_for(self, epoch: int, batch_idx: int) -> Optional[int]:
        """Deterministic per-optimizer-step token-count choice (stable across
        resume; constant within a grad-accum group)."""
        if not self.token_buckets:
            return None
        opt_step = batch_idx // self.accum_steps
        h = random.Random((self.seed, epoch, opt_step).__hash__()).randrange(
            len(self.token_buckets))
        return self.token_buckets[h]

    def _order(self) -> List[int]:
        rng = random.Random((self.seed, self.epoch).__hash__())
        if self.group_by_modality:
            # reference LengthGroupedSampler(group_by_modality=True) semantics
            # (`metamorph_trainer.py:105-136`): single-modality, length-sorted
            # megabatch chunks, shuffled at batch granularity
            return modality_length_grouped_indices(
                self.dataset.modality_lengths, self.batch_size, rng)
        idx = list(range(len(self.dataset)))
        rng.shuffle(idx)
        return idx

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch,
                "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]):
        self.epoch = state["epoch"]
        self.step_in_epoch = state["step_in_epoch"]
        self.seed = state.get("seed", self.seed)

    def __iter__(self):
        P = self.process_count
        B_local = self.batch_size // P
        N_local = self.collator.num_image_slots // P
        while True:
            order = self._order()
            n_batches = len(order) // self.batch_size
            for b in range(self.step_in_epoch, n_batches):
                self.step_in_epoch = b + 1
                K = self._bucket_for(self.epoch, b)
                lo = b * self.batch_size + self.process_index * B_local
                rows = [self.dataset[order[lo + k]] for k in range(B_local)]
                yield self.collator(
                    rows, num_image_tokens=K,
                    num_image_slots=N_local if P > 1 else None)
            self.epoch += 1
            self.step_in_epoch = 0
