"""Configuration dataclasses of the PyTorch package.

Copies of `metamorph_tpu/config.py` (LLaMA decoder, SigLIP tower,
multimodal connector, mesh, training, and the top-level tree), with the
dtype table mapped to torch dtypes. They are copied rather than imported because
importing anything under `metamorph_tpu` imports JAX, which the PyTorch
package must not need. Field names and defaults are the same, so a config
JSON written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

_DTYPE_NAMES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPE_NAMES[name]


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA-3-style decoder config. Defaults = LLaMA-3.1-8B."""

    vocab_size: int = 128258  # 128256 + <image_start> + <image_end>
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    # LLaMA-3.1 rope scaling ("llama3" style NTK-by-parts); disabled for 3.0.
    rope_scaling: bool = True
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    tie_word_embeddings: bool = False
    lora_r: int = 0
    lora_alpha: float = 16.0
    # Multi-head latent attention (DeepSeek-V3's MLA), on when kv_lora_rank
    # is positive: keys and values come from a kv_lora_rank-wide latent
    # (normed) plus a shared qk_rope_head_dim-wide rotary key, and the
    # cache holds those per token in place of per-head K/V. Query and key
    # heads are qk_nope_head_dim + qk_rope_head_dim wide, values
    # v_head_dim; the queries take no low-rank path (q_lora_rank null).
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # Routed experts (DeepSeekMoE), on when n_routed_experts is positive:
    # layers from first_k_dense_replace on replace the intermediate_size
    # FFN by num_experts_per_tok of n_routed_experts SwiGLU experts of
    # width moe_intermediate_size, chosen on sigmoid scores plus a
    # correction bias, weighted by the unbiased scores (normalised with
    # norm_topk_prob) times routed_scaling_factor, plus one shared SwiGLU
    # of width n_shared_experts * moe_intermediate_size.
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    n_shared_experts: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True

    @property
    def attention_kind(self) -> str:
        """"mla" (latent attention) or "gqa" (grouped-query)."""
        return "mla" if self.kv_lora_rank > 0 else "gqa"

    def require_gqa(self, what: str) -> None:
        """Refuse `what`, an option that only the grouped-query decoder
        has, for a latent-attention one."""
        if self.attention_kind != "gqa":
            raise ValueError(
                f"{what} is not ported to attention kind "
                f"{self.attention_kind!r} (multi-head latent attention with "
                f"routed experts); it runs on the grouped-query decoder only")

    def is_moe_layer(self, l: int) -> bool:
        return self.n_routed_experts > 0 and l >= self.first_k_dense_replace

    @staticmethod
    def tiny(vocab_size: int = 128258) -> "LlamaConfig":
        """A tiny config for tests: same vocab/token semantics, small compute."""
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            rope_scaling=False,
            max_position_embeddings=512,
        )


_LATENT_AND_EXPERT_KEYS = (
    "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
    "n_routed_experts", "num_experts_per_tok", "moe_intermediate_size",
    "n_shared_experts", "first_k_dense_replace", "routed_scaling_factor",
    "norm_topk_prob")


@dataclass(frozen=True)
class SiglipConfig:
    """SigLIP-SO400M-patch14-384 vision tower config."""

    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    layer_norm_eps: float = 1e-6
    # Which hidden_states entry to read: -1 = last block output (pre-final-LN).
    select_layer: int = -1

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2

    @staticmethod
    def tiny() -> "SiglipConfig":
        return SiglipConfig(
            image_size=28,
            patch_size=14,
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=4,
        )


@dataclass(frozen=True)
class MultimodalConfig:
    """Connector / fusion / vision-head config."""

    projector_type: str = "mlp2x_gelu"   # linear | mlpNx_gelu | mlpsoftmax | identity
    vision_head_type: str = "mlp"        # linear | mlp | mlp2x_gelu | none(->linear 1152)
    num_image_tokens: int = 64           # 729 -> 64 via bilinear interpolation
    num_image_tokens_buckets: Tuple[int, ...] = ()
    image_token_reduction: str = "interpolation"  # interpolation | mlpmixer | concat_interpolation | none
    normalize_vision: bool = True        # L2-normalize SigLIP features + head output
    apply_softmax: bool = False          # softmax/0.07 variant
    vision_coef: float = 1.0
    use_vision_ar: bool = True
    freeze_vision: bool = True
    image_aspect_ratio: str = "square"   # square | pad | anyres
    mm_use_im_start_end: bool = True
    mm_patch_merge_type: str = "flat"
    image_grid_pinpoints: Tuple[Tuple[int, int], ...] = (
        (384, 768), (768, 384), (768, 768), (1152, 384), (384, 1152))


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes. fsdp ~ ZeRO-3, pure data ~ DDP, tensor = megatron-style
    TP (`parallel/mesh.build_mesh` lays them over the ranks of a process
    group; without one, `device_count` must resolve to 1)."""

    data: int = 1
    fsdp: int = -1   # -1: all remaining devices
    tensor: int = 1
    axis_names: Tuple[str, str, str] = ("data", "fsdp", "tensor")

    def device_count(self, available: int) -> int:
        """Devices this mesh spans on `available` devices (an axis of -1
        absorbs the rest), as `metamorph_tpu/parallel/mesh.py:build_mesh`
        resolves it."""
        sizes = [self.data, self.fsdp, self.tensor]
        fixed = 1
        for s in sizes:
            if s != -1:
                fixed *= s
        if sizes.count(-1) > 1:
            raise ValueError("at most one mesh axis may be -1")
        return fixed * (available // fixed if -1 in sizes else 1)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    mm_projector_lr: Optional[float] = None   # per-group LR
    vision_tower_lr: Optional[float] = None
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"
    total_steps: int = 1000
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1
    seed: int = 42
    batch_size: int = 8             # global batch
    max_seq_len: int = 4096
    max_images_per_batch: int = 8   # static image-slot budget per global batch
    remat: bool = True              # gradient checkpointing on decoder blocks
    # what a checkpointed block keeps: see models/llama.py llama_forward
    remat_policy: str = "dots_no_batch"
    # sequence-chunk width of the checkpointed cross-entropy loop (the fp32
    # [B, chunk, 128k] logits block is the live-memory knob)
    ce_chunk: int = 512
    # trainable sets of the 2-stage recipe: stage 1 (connector pretrain)
    # tune_mm_mlp_adapter=True; stage 2 everything but (optionally) the tower
    tune_mm_mlp_adapter: bool = False
    freeze_backbone: bool = False
    lora_enable: bool = False
    offload_optimizer: bool = False
    sequence_parallel: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class MetaMorphConfig:
    """Top-level config: model sections, mesh and training."""

    llama: LlamaConfig = field(default_factory=LlamaConfig)
    siglip: SiglipConfig = field(default_factory=SiglipConfig)
    mm: MultimodalConfig = field(default_factory=MultimodalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @staticmethod
    def tiny() -> "MetaMorphConfig":
        return MetaMorphConfig(
            llama=LlamaConfig.tiny(),
            siglip=SiglipConfig.tiny(),
            mm=MultimodalConfig(num_image_tokens=4),
            train=TrainConfig(max_seq_len=128, batch_size=2,
                              max_images_per_batch=4),
        )

    def to_dict(self) -> dict:
        """The tree as plain data. A grouped-query decoder leaves out the
        latent-attention and expert keys, which then hold their defaults,
        so that its JSON stays the one the JAX package reads."""
        d = dataclasses.asdict(self)
        if self.llama.attention_kind == "gqa" \
                and not self.llama.n_routed_experts:
            for f in dataclasses.fields(LlamaConfig):
                if f.name in _LATENT_AND_EXPERT_KEYS:
                    del d["llama"][f.name]
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def with_num_image_tokens(self, k: int) -> "MetaMorphConfig":
        """Config variant with another per-image token count (multi-res
        buckets; the weights do not depend on it)."""
        return dataclasses.replace(
            self, mm=dataclasses.replace(self.mm, num_image_tokens=k))

    @staticmethod
    def from_dict(d: dict) -> "MetaMorphConfig":
        def detuple(v):
            # JSON has no tuples; restore them recursively so configs stay
            # hashable (nested lists like image_grid_pinpoints)
            if isinstance(v, list):
                return tuple(detuple(x) for x in v)
            return v

        return MetaMorphConfig(
            llama=LlamaConfig(**d.get("llama", {})),
            siglip=SiglipConfig(**d.get("siglip", {})),
            mm=MultimodalConfig(**{k: detuple(v)
                                   for k, v in d.get("mm", {}).items()}),
            mesh=MeshConfig(**{k: detuple(v)
                               for k, v in d.get("mesh", {}).items()}),
            train=TrainConfig(**d.get("train", {})),
        )

    @staticmethod
    def from_json(s: str) -> "MetaMorphConfig":
        return MetaMorphConfig.from_dict(json.loads(s))
