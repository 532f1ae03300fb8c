"""Static-shape multimodal sequence packing (numpy only): a copy of
`PackedBatch`, `pack_sequences` and `batch_to_arrays` from
`metamorph_tpu/multimodal/packing.py`, which imports JAX through its
package. The trainer and the tests build batches with it.

The host packer turns sentinel-bearing token sequences into fixed-shape
index maps; the device step is one gather and one select:

    text_emb = embed_tokens(tokens)                       # [B,T,D]
    img_flat = projector(tower(images)).reshape(N*K, D)   # [N*K, D] (+dummy row)
    embeds   = where(is_image, img_flat[img_gather_idx], text_emb)

The reference quirks stay as they are:
  * a sample with no sentinel still consumes one image slot, routed to the
    placeholder set (excluded from AR targets);
  * answer-image detection: the label of the token right before the
    sentinel equals 128256 (<image_start>);
  * max-length stop: if splicing the next image would exceed max_len, stop
    appending text chunks but keep checking later images against the same
    length;
  * image positions get IGNORE_INDEX labels; placeholder and non-answer
    images are excluded from AR targets;
  * right or left re-padding.

JAX's per-host shard helpers (`shift_packed_shard`,
`shift_packed_anyres_shard`) are not ported, by design: they re-base a
shard's gather indices to one global image table, which GSPMD needs and a
torch rank, gathering from its own images, does not
(`train/data.py`'s `DataIterator`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from metamorph_tpu_torch.constants import (IGNORE_INDEX, IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX)


@dataclasses.dataclass
class PackedBatch:
    """Fixed-shape device-ready batch. B=batch, T=seq len, N=image slots,
    K=tokens per image, A=N*K (max answer-image tokens)."""

    tokens: np.ndarray          # [B,T] int32 — text ids; 0 at image/pad positions
    labels: np.ndarray          # [B,T] int32 — IGNORE_INDEX at image/pad/masked
    attn_mask: np.ndarray       # [B,T] int32 — 1 = real token
    position_ids: np.ndarray    # [B,T] int32 — arange per sample (0 at pads)
    img_gather_idx: np.ndarray  # [B,T] int32 — index into [N*K (+1 dummy), D]
    is_image: np.ndarray        # [B,T] bool  — image-token position
    image_ar_mask: np.ndarray   # [B,T] int32 — 1 = answer-image token (AR loss)
    # AR-loss gather plan: for each potential answer-image token
    ar_batch_idx: np.ndarray    # [A] int32 — b of the token to predict
    ar_pred_pos: np.ndarray     # [A] int32 — hidden position t-1 used to predict it
    ar_target_idx: np.ndarray   # [A] int32 — index into flattened targets [N*K, Dv]
    ar_valid: np.ndarray        # [A] float32 — 1 = real answer-image token
    image_slot_used: np.ndarray # [N] float32 — 1 = slot holds a real image
    # anyres only: [A] index into the flattened per-view token table
    # (view*P*P + patch); -1 = learned newline row, -2 = unused capacity
    view_map: Optional[np.ndarray] = None

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]


def pack_sequences(
    input_ids: Sequence[Sequence[int]],
    labels: Optional[Sequence[Sequence[int]]],
    num_image_tokens: int,
    max_seq_len: int,
    num_image_slots: int,
    padding_side: str = "right",
    tokens_per_image: Optional[Sequence[int]] = None,
    gather_capacity: Optional[int] = None,
) -> PackedBatch:
    """Pack a batch of sentinel-bearing token sequences into static shapes.

    input_ids[i] may contain IMAGE_TOKEN_INDEX (-200) sentinels. Images are
    numbered left-to-right across the batch (sample 0's images first), matching
    the reference collator's flattened image stacking (`train.py:1258-1284`).
    A sample with zero sentinels still consumes one slot (reference quirk).

    `tokens_per_image` (anyres) gives each slot a variable token count; slot
    base offsets in the flat image-token table become cumulative sums and the
    table capacity is `gather_capacity` (the dummy row sits at that index).
    The uniform path is tokens_per_image=None: slot i starts at i*K.
    """
    B = len(input_ids)
    K = num_image_tokens
    T = max_seq_len
    N = num_image_slots
    if tokens_per_image is not None:
        offsets = [0]
        for n in tokens_per_image:
            offsets.append(offsets[-1] + n)
        A = gather_capacity if gather_capacity is not None else offsets[-1]
    else:
        offsets = None
        A = N * K

    tokens = np.zeros((B, T), np.int32)
    out_labels = np.full((B, T), IGNORE_INDEX, np.int32)
    attn = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    gather = np.full((B, T), A, np.int32)  # dummy row index
    is_img = np.zeros((B, T), bool)
    ar_mask = np.zeros((B, T), np.int32)

    ar_b = np.zeros((A,), np.int32)
    ar_p = np.zeros((A,), np.int32)
    ar_t = np.zeros((A,), np.int32)
    ar_v = np.zeros((A,), np.float32)
    slot_used = np.zeros((N,), np.float32)
    n_ar = 0

    cur_image_idx = 0
    for b in range(B):
        ids = list(input_ids[b])
        labs = list(labels[b]) if labels is not None else [IGNORE_INDEX] * len(ids)
        assert len(ids) == len(labs), "input_ids/labels length mismatch"

        # per-token stream for this sample: (token_id, label, img_idx or -1, tok_in_img, answer?)
        seq_tok: List[int] = []
        seq_lab: List[int] = []
        seq_img: List[int] = []   # image slot id or -1
        seq_j: List[int] = []     # token index within image
        seq_ans: List[bool] = []

        sentinel_positions = [i for i, t in enumerate(ids) if t == IMAGE_TOKEN_INDEX]
        if not sentinel_positions:
            # text-only sample consumes one (placeholder) image slot
            cur_image_idx += 1
            for t, l in zip(ids, labs):
                seq_tok.append(t); seq_lab.append(l)
                seq_img.append(-1); seq_j.append(0); seq_ans.append(False)
        else:
            # split into text chunks around sentinels (reference :286-299)
            bounds = [-1] + sentinel_positions + [len(ids)]
            chunks = [
                (ids[bounds[i] + 1: bounds[i + 1]], labs[bounds[i] + 1: bounds[i + 1]])
                for i in range(len(bounds) - 1)
            ]
            need_to_stop = False
            for i, (ctok, clab) in enumerate(chunks):
                if not need_to_stop:
                    for t, l in zip(ctok, clab):
                        seq_tok.append(t); seq_lab.append(l)
                        seq_img.append(-1); seq_j.append(0); seq_ans.append(False)
                if i < len(sentinel_positions):
                    # answer image iff label right before the sentinel is <image_start>
                    answer = bool(clab) and clab[-1] == IM_START_TOKEN_ID
                    if offsets is not None:
                        if cur_image_idx >= len(offsets) - 1:
                            raise ValueError(
                                f"batch consumes image {cur_image_idx} but "
                                f"tokens_per_image has {len(offsets) - 1} entries")
                        Ki = offsets[cur_image_idx + 1] - offsets[cur_image_idx]
                    else:
                        Ki = K
                    if len(seq_tok) + Ki > T:
                        need_to_stop = True  # image -> placeholder (ref :324-326)
                    else:
                        slot = cur_image_idx
                        for j in range(Ki):
                            seq_tok.append(0); seq_lab.append(IGNORE_INDEX)
                            seq_img.append(slot); seq_j.append(j); seq_ans.append(answer)
                    cur_image_idx += 1

        # truncate at T (ref :355-358) then pad to T
        L = min(len(seq_tok), T)
        offset = T - L if padding_side == "left" else 0
        for s in range(L):
            t = offset + s
            img = seq_img[s]
            attn[b, t] = 1
            pos[b, t] = s
            if img >= 0:
                if img >= N:
                    raise ValueError(
                        f"batch needs image slot {img} but only {N} allotted")
                is_img[b, t] = True
                base = offsets[img] if offsets is not None else img * K
                gather[b, t] = base + seq_j[s]
                slot_used[img] = 1.0
                out_labels[b, t] = IGNORE_INDEX
                if seq_ans[s]:
                    ar_mask[b, t] = 1
                    # predict token t from hidden at t-1 (teacher forcing,
                    # metamorph_llama.py:384-390); t==0 can't happen since an
                    # image never starts a packed sequence (bos precedes it)
                    if s > 0 and n_ar < A:
                        ar_b[n_ar] = b
                        ar_p[n_ar] = t - 1
                        ar_t[n_ar] = base + seq_j[s]
                        ar_v[n_ar] = 1.0
                        n_ar += 1
            else:
                tokens[b, t] = seq_tok[s]
                out_labels[b, t] = seq_lab[s]

    if cur_image_idx > N:
        raise ValueError(f"batch consumed {cur_image_idx} image slots > budget {N}")

    return PackedBatch(
        tokens=tokens, labels=out_labels, attn_mask=attn, position_ids=pos,
        img_gather_idx=gather, is_image=is_img, image_ar_mask=ar_mask,
        ar_batch_idx=ar_b, ar_pred_pos=ar_p, ar_target_idx=ar_t, ar_valid=ar_v,
        image_slot_used=slot_used,
    )


# host-side-only fields: the AR gather plan is superseded by the mask-based
# AR loss (the [B,T] image_ar_mask + img_gather_idx); kept on PackedBatch for
# packer tests and the trainer's K detection, but never shipped to the device
_HOST_ONLY_FIELDS = ("ar_batch_idx", "ar_pred_pos", "ar_target_idx", "ar_valid",
                     "image_slot_used")


def batch_to_arrays(batch: PackedBatch) -> dict:
    """Dict of arrays for feeding the jitted step (pytree-friendly; absent
    optional fields and host-side-only plan vectors are dropped)."""
    out = {}
    for f in dataclasses.fields(PackedBatch):
        v = getattr(batch, f.name)
        if v is not None and f.name not in _HOST_ONLY_FIELDS:
            out[f.name] = v
    return out
