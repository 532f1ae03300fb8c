"""The MetaMorph model (counterpart of `metamorph_tpu/models/metamorph.py`):
the modules of the four parts, image encoding, the vision head, the
image-token splice, and the training forward with its dual loss.

Loss semantics (those of the JAX `metamorph_forward`):
  * text CE on shifted labels, mean over non-IGNORE positions, over
    sequence chunks whose fp32 logits are recomputed in the backward;
  * image-AR loss on answer-image positions only, teacher-forced (hidden at
    t-1 predicts image token t), pred = vision_head(hidden) [+ L2-normalize
    or softmax/0.07], target = detached vision-tower features;
  * total = CE + vision_coef * AR; the AR term is 0 when the batch has no
    answer-image token (guarded mean).

Both one-position shifts (the labels, and the AR pairing of position t's
hidden with token t + 1's target) are taken on the targets: position t is
scored against `labels[t + 1]` and, where token t + 1 is an answer-image
token, against its vision feature. The same sums as JAX's
`hidden[:, :-1]` / `labels[:, 1:]` and `h_prev` forms, with every term
local to its position, so a rank that holds a slice of the sequence
(sequence parallelism) needs no neighbour's hidden state.

In a sharded step (`shard`, a `parallel/context.BatchShard`) each rank
sums its own terms and divides them by the token counts of the GLOBAL
batch, all-reduced over the shard's group (JAX's `n_valid` and `n_ar` of
the global batch), so the ranks' losses add up to the global loss and
their gradients sum to its gradient; the metrics are all-reduced too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.constants import IGNORE_INDEX
from metamorph_tpu_torch.models import llama as llama_lib
from metamorph_tpu_torch.models.llama import _param
from metamorph_tpu_torch.models import projector as proj_lib
from metamorph_tpu_torch.models import siglip as siglip_lib
from metamorph_tpu_torch.parallel.context import BatchShard


def _d_vis(cfg: MetaMorphConfig) -> int:
    d = cfg.siglip.hidden_size
    return 4 * d if cfg.mm.image_token_reduction == "concat_interpolation" else d


def _proj_dims_acts(cfg: MetaMorphConfig):
    return proj_lib.projector_spec(cfg.mm.projector_type, _d_vis(cfg),
                                   cfg.llama.hidden_size, cfg.llama.hidden_size)


def _head_dims_acts(cfg: MetaMorphConfig):
    return proj_lib.head_spec(cfg.mm.vision_head_type, cfg.llama.hidden_size,
                              cfg.siglip.hidden_size)


def _proj_acts(cfg: MetaMorphConfig):
    return _proj_dims_acts(cfg)[1]


def _head_acts(cfg: MetaMorphConfig):
    return _head_dims_acts(cfg)[1]


class MetaMorph(nn.Module):
    """LLaMA decoder, SigLIP tower, mm projector and vision head, plus the
    `mlpmixer` reduction's mixers (`siglip_mixer`) and the anyres
    `spatial_unpad` merge's learned newline row (`image_newline`, [D]) when
    the config uses them, as the JAX parameter tree has them. Weights are
    uninitialized (`torch.empty`); fill them with `convert.from_jax_params`
    or `convert.init_params`."""

    def __init__(self, cfg: MetaMorphConfig, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.llama = llama_lib.Llama(cfg.llama, dtype, device)
        self.siglip = siglip_lib.Siglip(cfg.siglip, dtype, device)
        self.projector = proj_lib.DenseStack(_proj_dims_acts(cfg)[0], dtype,
                                             device)
        self.vision_head = proj_lib.DenseStack(_head_dims_acts(cfg)[0], dtype,
                                               device)
        self.siglip_mixer = (
            siglip_lib.SiglipMixer(cfg.siglip, cfg.mm.num_image_tokens, dtype,
                                   device)
            if cfg.mm.image_token_reduction == "mlpmixer" else None)
        self.image_newline = (
            _param(cfg.llama.hidden_size, dtype=dtype, device=device)
            if "unpad" in cfg.mm.mm_patch_merge_type else None)

    def forward(self, cfg: MetaMorphConfig, batch: Dict[str, torch.Tensor],
                pixels: torch.Tensor, **kw):
        """`metamorph_forward` as a module call (FSDP2 gathers the root's
        weights around it)."""
        return metamorph_forward(self, cfg, batch, pixels, **kw)


def encode_images(model: MetaMorph, cfg: MetaMorphConfig,
                  pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pixels [N,H,W,3] -> (projected [N,K,D_llm] with grad to the
    projector, targets [N,K,D_vis] detached)."""
    feats = siglip_lib.vision_tower_forward(model.siglip, cfg.siglip, cfg.mm,
                                            pixels, model.siglip_mixer)
    projected = proj_lib.apply_stack(model.projector, _proj_acts(cfg), feats)
    return projected, feats.detach()


def apply_vision_head(model: MetaMorph, cfg: MetaMorphConfig,
                      h: torch.Tensor) -> torch.Tensor:
    """hidden -> predicted visual embedding (1152-d, fp32), with the
    configured normalization."""
    pred = proj_lib.apply_stack(model.vision_head, _head_acts(cfg), h).float()
    if cfg.mm.normalize_vision:
        return pred / pred.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    if cfg.mm.apply_softmax:
        return torch.softmax(pred / 0.07, dim=-1)
    return pred


def image_token_table(model: MetaMorph, cfg: MetaMorphConfig,
                      batch: Dict[str, torch.Tensor],
                      projected: torch.Tensor) -> torch.Tensor:
    """Flat [A, D] image-token table the packer's img_gather_idx indexes
    into. Uniform path: slot-major reshape of [N, K, D]. Anyres path (the
    batch carries `view_map`): one gather over the flattened per-view
    tokens, with the learned `image_newline` at NEWLINE_IDX (-1) entries
    (zeros when the model has none) and zeros at PAD_IDX (-2), the
    static-shape form of the reference's spatial merge."""
    if "view_map" in batch:
        D = projected.shape[-1]
        if projected.shape[1] != cfg.siglip.num_patches:
            raise ValueError("anyres merge needs the raw patch grid; set "
                             "mm.image_token_reduction='none'")
        flat = projected.reshape(-1, D)
        vm = batch["view_map"].long()
        safe = flat[vm.clamp_min(0)]
        newline = model.image_newline
        if newline is None:
            newline = projected.new_zeros((D,))
        return torch.where((vm == -1)[:, None], newline.to(projected.dtype),
                           torch.where((vm >= 0)[:, None], safe,
                                       safe.new_zeros(())))
    N, K, D = projected.shape
    return projected.reshape(N * K, D)


def fuse_embeddings(model: MetaMorph, cfg: MetaMorphConfig,
                    batch: Dict[str, torch.Tensor],
                    projected: torch.Tensor) -> torch.Tensor:
    """Gather the projected image tokens into the text embeddings at the
    packer's image positions (`is_image`, `img_gather_idx`)."""
    text_emb = llama_lib.embed_tokens(model.llama, batch["tokens"])
    table = image_token_table(model, cfg, batch, projected)
    img_flat = torch.cat([table, table.new_zeros((1, table.shape[-1]))])
    gathered = img_flat[batch["img_gather_idx"].long()]
    return torch.where(batch["is_image"].bool()[..., None],
                       gathered.to(text_emb.dtype), text_emb)


def _ce_chunk(llama: llama_lib.Llama, cfg: MetaMorphConfig, h, labels):
    logits = llama_lib.lm_head(llama, cfg.llama, h)            # fp32
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    tok = logp.gather(-1, safe[..., None])[..., 0]
    return -(tok * valid).sum(), valid.sum()


def _chunked_ce(model: MetaMorph, cfg: MetaMorphConfig, hidden: torch.Tensor,
                labels: torch.Tensor, chunk: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed CE over the non-IGNORE labels, their count), a loop over
    sequence chunks of `chunk` rows, each checkpointed: the backward
    recomputes one [B, chunk, V] fp32 logits block at a time, so the whole
    fp32 logits tensor never exists."""
    T = hidden.shape[1]
    chunk = min(chunk, T)
    total = hidden.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for s in range(0, T, chunk):
        t, c = checkpoint(_ce_chunk, model.llama, cfg, hidden[:, s:s + chunk],
                          labels[:, s:s + chunk], use_reentrant=False)
        total = total + t
        count = count + c
    return total, count


def _next_targets(batch: Dict[str, torch.Tensor]):
    """Position t's targets are token t + 1's: (labels, AR gather index,
    AR mask) shifted left by one, the last position IGNORE / unmasked."""
    labels = batch["labels"]
    idx = batch["img_gather_idx"].long()
    w = batch["image_ar_mask"].float()
    return (torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                      IGNORE_INDEX)], 1),
            torch.cat([idx[:, 1:], idx[:, -1:]], 1),
            torch.cat([w[:, 1:], torch.zeros_like(w[:, :1])], 1))


_SEQ_KEYS = ("tokens", "position_ids", "img_gather_idx", "is_image",
             "attn_mask")


def metamorph_forward(model: MetaMorph, cfg: MetaMorphConfig,
                      batch: Dict[str, torch.Tensor], pixels: torch.Tensor,
                      remat: bool = False,
                      remat_policy: str = "dots_no_batch",
                      shard: Optional[BatchShard] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: fused multimodal sequence -> (total_loss, metrics).
    `batch` holds the packer's [B,T] tensors (`batch_to_arrays`) on the
    model's device; pixels [N,H,W,3]. With `shard` the batch and pixels are
    this rank's (under sequence parallelism, the whole rows and images of
    its data group, of which it runs slice `seq_index`), the returned loss
    is this rank's part of the global loss and the metrics are global."""
    projected, targets = encode_images(model, cfg, pixels)
    labels, ar_idx, w = _next_targets(batch)
    if shard is not None and shard.seq_count > 1:
        T = labels.shape[1]
        if T % shard.seq_count:
            raise ValueError(f"sequence length {T} does not split into "
                             f"{shard.seq_count} equal slices")
        n = T // shard.seq_count
        sl = slice(shard.seq_index * n, (shard.seq_index + 1) * n)
        batch = {k: (v[:, sl] if k in _SEQ_KEYS else v)
                 for k, v in batch.items()}
        labels, ar_idx, w = labels[:, sl], ar_idx[:, sl], w[:, sl]
    embeds = fuse_embeddings(model, cfg, batch, projected)
    # no key mask: right padding sits after every valid query, so causality
    # alone keeps it out (the JAX flash path passes none either); the
    # positions are global ones, so RoPE needs no offset under sequence
    # parallelism
    hidden = llama_lib.llama_forward(
        model.llama, cfg.llama, embeds, batch["position_ids"], None,
        remat=remat, remat_policy=remat_policy)

    ce_sum, n_text = _chunked_ce(model, cfg, hidden, labels,
                                 chunk=cfg.train.ce_chunk)

    # image-AR loss on the [B,T] layout: targets gathered with the fusion's
    # plan, the vision head run on every position and weighted by the
    # answer-image mask
    N, K, Dv = targets.shape
    if "view_map" in batch:
        # anyres images are prompt images only (the reference's anyres
        # branch makes no AR targets): the mask is all zero and the target
        # table inert
        tgt_flat = targets.new_zeros((batch["view_map"].shape[0] + 1, Dv),
                                     dtype=torch.float32)
    else:
        tgt_flat = torch.cat([targets.reshape(N * K, Dv).float(),
                              targets.new_zeros((1, Dv), dtype=torch.float32)])
    tgt = tgt_flat[ar_idx]                                        # [B,T,Dv]
    # teacher forcing: hidden at t predicts image token t + 1
    pred = apply_vision_head(model, cfg, hidden)                  # fp32
    counts = torch.stack([n_text.float(), w.sum()]).detach()
    if shard is not None and shard.group is not None:
        dist.all_reduce(counts, group=shard.group)
    n_valid = counts[0].clamp_min(1.0)
    n_ar = counts[1].clamp_min(1.0)
    if cfg.mm.apply_softmax:
        per_tok = -(tgt * torch.log(pred + 1e-10)).sum(-1)
    elif cfg.mm.normalize_vision:
        tgt_n = tgt / tgt.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        per_tok = -(pred * tgt_n).sum(-1)      # pred is already unit-norm
    else:
        per_tok = (tgt - pred).abs().mean(-1)
    loss_image_ar = (per_tok * w).sum() / n_ar
    loss_language = ce_sum / n_valid

    total = loss_language
    if cfg.mm.use_vision_ar:
        total = total + cfg.mm.vision_coef * loss_image_ar
    losses = torch.stack([total, loss_language, loss_image_ar]).detach()
    if shard is not None and shard.group is not None:
        dist.all_reduce(losses, group=shard.group)
    metrics = {
        "loss": losses[0],
        "loss_language": losses[1],
        "loss_image_ar": losses[2],
        "n_text_tokens": n_valid,
        "n_image_ar_tokens": counts[1],
    }
    return total, metrics
