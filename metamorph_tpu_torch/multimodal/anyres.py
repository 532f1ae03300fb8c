"""Anyres tiling: host-side merge plans for the static device merge. A copy
of `metamorph_tpu/multimodal/anyres.py` (that package imports JAX on
import); the plans are the same, entry for entry.

Each image becomes [1 global view + n tiles] crops; after the tower and the
projector, tile features are re-stitched spatially (optionally unpadded to
the original aspect ratio, with a learned newline column appended per row)
and concatenated after the global view: a variable number of tokens per
image.

Instead of dynamic shapes on the device, the host computes a per-image
merge map: an int32 index vector over the flattened per-view token table
(view*P*P + patch), with -1 marking newline positions. The device then
builds the image-token table with one gather and a select
(`models/metamorph.py:image_token_table`):

    flat   = projected.reshape(V*P*P, D)          # all views, all images
    table  = where(map == -1, newline, flat[max(map, 0)])

The map is produced by running `merge_anyres_features` (the host reference
of the merge semantics) over an index array, so map and feature merges can
never diverge.

As in the JAX package, anyres images are prompt (understanding) images
only: the reference's anyres branch produces no AR target features, so AR
targets under anyres are zeros.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from metamorph_tpu_torch.multimodal.mm_utils import (
    get_anyres_image_grid_shape, merge_anyres_features, process_anyres_image)

NEWLINE_IDX = -1   # merge-map entry: learned image_newline param
PAD_IDX = -2       # merge-map entry: zero row (unused capacity)


def anyres_num_views(image_size: Tuple[int, int], grid_pinpoints,
                     crop_size: int) -> int:
    """1 global view + tiles for the best-fit canvas. image_size = (w, h)."""
    npw, nph = get_anyres_image_grid_shape(image_size, grid_pinpoints, crop_size)
    return 1 + npw * nph


def anyres_merge_map(image_size: Tuple[int, int], grid_pinpoints,
                     crop_size: int, patch_side: int,
                     merge_type: str = "spatial_unpad") -> np.ndarray:
    """Per-image merge map (view-relative indices; NEWLINE_IDX for the learned
    newline). Length = this image's merged token count."""
    n_views = anyres_num_views(image_size, grid_pinpoints, crop_size)
    p2 = patch_side * patch_side
    if merge_type == "flat":
        return np.arange(n_views * p2, dtype=np.int32)
    idx = np.arange(n_views * p2, dtype=np.float64).reshape(n_views, p2, 1)
    newline = np.array([float(NEWLINE_IDX)])
    merged = merge_anyres_features(
        idx, image_size, grid_pinpoints, crop_size, patch_side,
        merge_type=merge_type,
        image_newline=newline if "unpad" in merge_type else None)
    return merged[:, 0].astype(np.int32)


def build_batch_plan(image_sizes: Sequence[Optional[Tuple[int, int]]],
                     n_views: Sequence[int], grid_pinpoints, crop_size: int,
                     patch_side: int, merge_type: str, capacity: int
                     ) -> Tuple[np.ndarray, List[int]]:
    """Concatenate per-image merge maps into one [capacity] view_map.

    image_sizes[i] is the original (w, h) of image i, or None for a
    placeholder (text-only dummy) whose views occupy the view table but whose
    tokens are never gathered. Returns (view_map, tokens_per_image) where
    view_map entries are global flat indices into [sum(n_views)*P*P], with
    NEWLINE_IDX / PAD_IDX sentinels, and tokens_per_image[i] gives each
    image's merged token count (0 for placeholders)."""
    p2 = patch_side * patch_side
    view_map = np.full((capacity,), PAD_IDX, np.int32)
    tokens_per_image: List[int] = []
    v_off = 0
    c_off = 0
    for size, nv in zip(image_sizes, n_views):
        if size is None:
            tokens_per_image.append(0)
        else:
            m = anyres_merge_map(size, grid_pinpoints, crop_size, patch_side,
                                 merge_type)
            if c_off + len(m) > capacity:
                raise ValueError(
                    f"anyres batch needs {c_off + len(m)} image-token slots "
                    f"but capacity is {capacity}")
            g = np.where(m >= 0, m + v_off * p2, m)
            view_map[c_off:c_off + len(m)] = g
            c_off += len(m)
            tokens_per_image.append(len(m))
        v_off += nv
    return view_map, tokens_per_image


def preprocess_anyres(image: np.ndarray, grid_pinpoints, crop_size: int
                      ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """-> (views [1+tiles, S, S, 3] float32, original (w, h))."""
    h, w = np.asarray(image).shape[:2]
    views = process_anyres_image(image, grid_pinpoints, crop_size, crop_size)
    return views.astype(np.float32), (w, h)
