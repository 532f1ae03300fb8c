"""Host-side multimodal utilities: image preprocessing and sentinel
tokenization. A copy of `metamorph_tpu/multimodal/mm_utils.py` (that package
imports JAX on import); every function gives the same result, bit for bit.

Parity with `metamorph/mm_utils.py`:
  * `expand2square` square-pad (`mm_utils.py:158-169`);
  * anyres helpers — `select_best_resolution` (:18-45), `resize_and_pad_image`
    (:48-80), `divide_to_patches` (:83-102), `get_anyres_image_grid_shape`
    (:105-122), `process_anyres_image` (:125-151);
  * `process_images` batch entry (:172-188);
  * `tokenizer_image_token` "<image>" -> -200 sentinel splicing (:191-214).

Numpy only (no torch); PIL images are accepted and converted, and PIL is
imported only where a file or base64 string is decoded. The device-side
counterpart of the resize + normalize is `ops/preprocess.py`.
"""

from __future__ import annotations

import ast
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from metamorph_tpu_torch.constants import IMAGE_TOKEN_INDEX

# SigLIP image_processor normalization (mean=std=0.5 for siglip-so400m)
SIGLIP_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
SIGLIP_STD = np.array([0.5, 0.5, 0.5], np.float32)


# ---------------------------------------------------------------------------
# PIL-free image ops (accept HxWx3 uint8/float arrays; PIL accepted and
# converted when available)
# ---------------------------------------------------------------------------

def _to_array(image) -> np.ndarray:
    if isinstance(image, np.ndarray):
        return image
    return np.asarray(image.convert("RGB"))  # PIL path


def expand2square(image, background_color: Tuple[int, int, int]) -> np.ndarray:
    """Pad to square with the given background, centering the short side."""
    arr = _to_array(image)
    h, w = arr.shape[:2]
    if h == w:
        return arr
    side = max(h, w)
    out = np.empty((side, side, 3), arr.dtype)
    out[...] = np.asarray(background_color, arr.dtype)
    if w > h:
        top = (side - h) // 2
        out[top:top + h, :, :] = arr
    else:
        left = (side - w) // 2
        out[:, left:left + w, :] = arr
    return out


def resize_bilinear(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize (half-pixel centers, matching PIL/torch antialias-off
    semantics closely enough for training data)."""
    th, tw = size
    h, w = arr.shape[:2]
    if (h, w) == (th, tw):
        return arr.astype(np.float32)
    ys = (np.arange(th) + 0.5) * h / th - 0.5
    xs = (np.arange(tw) + 0.5) * w / tw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = arr[np.ix_(y0, x0)].astype(np.float32)
    b = arr[np.ix_(y0, x1)].astype(np.float32)
    c = arr[np.ix_(y1, x0)].astype(np.float32)
    d = arr[np.ix_(y1, x1)].astype(np.float32)
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def siglip_preprocess(image, image_size: int = 384) -> np.ndarray:
    """Resize to (S,S) + scale to [0,1] + normalize((x-.5)/.5). Returns
    [S,S,3] float32, channels-last as the SigLIP tower takes it."""
    arr = _to_array(image)
    arr = resize_bilinear(arr, (image_size, image_size))
    arr = arr / 255.0
    return ((arr - SIGLIP_MEAN) / SIGLIP_STD).astype(np.float32)


# ---------------------------------------------------------------------------
# anyres tiling
# ---------------------------------------------------------------------------

def select_best_resolution(original_size, possible_resolutions):
    ow, oh = original_size
    best_fit, max_eff, min_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best_fit = eff, waste, (w, h)
    return best_fit


def resize_and_pad_image(arr: np.ndarray, target_resolution) -> np.ndarray:
    h, w = arr.shape[:2]
    tw, th = target_resolution
    scale_w, scale_h = tw / w, th / h
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(h * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(w * scale_h), tw)
    resized = resize_bilinear(arr, (nh, nw))
    out = np.zeros((th, tw, 3), np.float32)
    py, px = (th - nh) // 2, (tw - nw) // 2
    out[py:py + nh, px:px + nw] = resized
    return out


def divide_to_patches(arr: np.ndarray, patch_size: int) -> List[np.ndarray]:
    patches = []
    h, w = arr.shape[:2]
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(arr[i:i + patch_size, j:j + patch_size])
    return patches


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size):
    res = grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(grid_pinpoints)
    w, h = select_best_resolution(image_size, res)
    return w // patch_size, h // patch_size


def process_anyres_image(image, grid_pinpoints, crop_size: int = 384,
                         shortest_edge: int = 384) -> np.ndarray:
    """[1+n_patches, S, S, 3] float32 stack: global resize + tiled crops."""
    arr = _to_array(image)
    res = grid_pinpoints if isinstance(grid_pinpoints, list) else ast.literal_eval(grid_pinpoints)
    h, w = arr.shape[:2]
    best = select_best_resolution((w, h), res)
    padded = resize_and_pad_image(arr, best)
    patches = divide_to_patches(padded, crop_size)
    glob = resize_bilinear(arr, (shortest_edge, shortest_edge))
    stack = [glob] + patches
    out = []
    for p in stack:
        x = p / 255.0 if p.max() > 2.0 else p
        out.append(((x - SIGLIP_MEAN) / SIGLIP_STD).astype(np.float32))
    return np.stack(out)


def process_images(images: Sequence, image_aspect_ratio: Optional[str] = None,
                   image_size: int = 384,
                   grid_pinpoints=None) -> np.ndarray:
    """Batch entry mirroring `process_images` (`mm_utils.py:172-188`)."""
    out = []
    for image in images:
        if image_aspect_ratio == "pad":
            bg = tuple(int(x * 255) for x in SIGLIP_MEAN)
            arr = expand2square(image, bg)
            out.append(siglip_preprocess(arr, image_size))
        elif image_aspect_ratio == "anyres":
            out.append(process_anyres_image(image, grid_pinpoints, image_size))
        else:
            out.append(siglip_preprocess(image, image_size))
    if all(o.shape == out[0].shape for o in out):
        return np.stack(out)
    return out


# ---------------------------------------------------------------------------
# sentinel tokenization
# ---------------------------------------------------------------------------

def tokenizer_image_token(prompt: str, tokenize,
                          image_token_index: int = IMAGE_TOKEN_INDEX,
                          bos_token_id: Optional[int] = 128000) -> List[int]:
    """Split the prompt on '<image>' and join the tokenized chunks with the
    -200 sentinel, de-duplicating a leading bos on inner chunks
    (`mm_utils.py:191-214`). `tokenize` maps str -> list[int]."""
    chunks = [tokenize(c) for c in prompt.split("<image>")]

    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and bos_token_id is not None and chunks[0][0] == bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    joined: List[List[int]] = []
    for i, c in enumerate(chunks):
        joined.append(c)
        if i < len(chunks) - 1:
            joined.append(sep)
    for x in joined:
        input_ids.extend(x[offset:])
    return input_ids


def load_image_from_base64(image: str) -> np.ndarray:
    """base64 string -> RGB numpy array (`mm_utils.py:154-155`; serving-UI
    counterpart of `Conversation.process_image`'s b64 output)."""
    import base64
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(image)))
                      .convert("RGB"))


def get_model_name_from_path(model_path: str) -> str:
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


def unpad_image(tensor: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
    """Remove letterbox padding from a [H, W, C] feature map given the original
    (width, height) — parity with `metamorph_arch.py:99-127` (CHW there)."""
    ow, oh = original_size
    ch, cw = tensor.shape[:2]
    orig_ar, cur_ar = ow / oh, cw / ch
    if orig_ar > cur_ar:
        scale = cw / ow
        nh = int(oh * scale)
        pad = (ch - nh) // 2
        return tensor[pad:ch - pad, :, :]
    scale = ch / oh
    nw = int(ow * scale)
    pad = (cw - nw) // 2
    return tensor[:, pad:cw - pad, :]


def merge_anyres_features(features: np.ndarray, image_size: Tuple[int, int],
                          grid_pinpoints, patch_size: int,
                          num_patches_per_side: int,
                          merge_type: str = "spatial",
                          image_newline: Optional[np.ndarray] = None) -> np.ndarray:
    """Merge anyres tile features into one token sequence — the
    `mm_patch_merge_type='spatial[_unpad]'` path (`metamorph_arch.py:203-237`).
    features: [1 + n_tiles, P*P, D] (global view first)."""
    base = features[0]
    tiles = features[1:]
    s = num_patches_per_side
    d = features.shape[-1]
    npw, nph = get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size)
    grid = tiles.reshape(nph, npw, s, s, d)
    if "unpad" in merge_type:
        # [H_feat, W_feat, D] spatial map, unpad, optional newline column
        spatial = grid.transpose(0, 2, 1, 3, 4).reshape(nph * s, npw * s, d)
        spatial = unpad_image(spatial, image_size)
        if image_newline is not None:
            col = np.broadcast_to(image_newline, (spatial.shape[0], 1, d))
            spatial = np.concatenate([spatial, col], axis=1)
        merged = spatial.reshape(-1, d)
    else:
        merged = grid.transpose(0, 2, 1, 3, 4).reshape(-1, d)
    return np.concatenate([base, merged], axis=0)
