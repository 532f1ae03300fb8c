"""The visualizer's training step (counterpart of
`metamorph_tpu/visualizer/train.py`): SigLIP-conditioned SD-1.5.

  * frozen VAE, trainable adapter (+ optionally the UNet, under its own
    AdamW and schedule); the SigLIP embeddings come from the caller;
  * per step: adapter -> pad 64 -> 77 -> CFG dropout (whole rows of the
    padded conditioning zeroed with probability `cfg_prob`) -> VAE encode
    (a posterior sample, no gradient) -> add_noise (t ~ U[0, 1000),
    optional per-channel noise offset) -> UNet -> fp32 MSE against the
    noise;
  * log-warmup + linear-decay LR (`lr_schedule`), or linear warmup then
    constant for a UNet trained from scratch (`select_lr_schedules`);
  * the tar-shard image stream, split by global process.

The step's five random draws (the drop mask, the noise, t, the noise
offset and the posterior's eps) all come from `loss_draws`, from one
explicit `torch.Generator`; replacing that function replaces every draw.
The step updates the state's trees in place.

With a `mesh` the step is data-parallel over its ranks, as JAX's is over
its devices: every rank keeps the whole state, takes its own rows of the
global batch, draws the GLOBAL batch's random numbers from the same
generator and keeps its own rows of them (so its noise is the rows of the
one-device step's), and averages the trained trees' gradients and the
loss over the ranks: the global batch's mean.
"""

from __future__ import annotations

import dataclasses
import io
import math
import tarfile
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from metamorph_tpu_torch.convert import resolve_device
from metamorph_tpu_torch.parallel.mesh import check_backend
from metamorph_tpu_torch.train.optimizer import PlainAdamW
from metamorph_tpu_torch.visualizer.adapter import (apply_adapter,
                                                    init_adapter, pad_tokens)
from metamorph_tpu_torch.visualizer.params import ParamTree
from metamorph_tpu_torch.visualizer.scheduler import DDPMScheduler
from metamorph_tpu_torch.visualizer.unet import (UNetConfig, init_unet_params,
                                                 unet_apply)
from metamorph_tpu_torch.visualizer.vae import (VAEConfig, init_vae_params,
                                                latent_shape, vae_encode)


@dataclasses.dataclass
class VisualizerTrainConfig:
    adapter_mode: str = "mlp"
    num_tokens: int = 64
    cfg_prob: float = 0.1          # conditioning DROP probability
    noise_offset: float = 0.0
    learning_rate: float = 1e-4
    unet_lr: float = 1e-5
    unfreeze_unet: bool = False
    # a from-scratch UNet trains with linear-warmup-then-constant LR
    # instead of the warmup + decay used for finetuning
    unet_from_scratch: bool = False
    batch_size: int = 24
    resolution: int = 512
    total_steps: int = 16000
    save_steps: int = 1000
    seed: int = 0


# ---------------------------------------------------------------------------
# LR schedules: float32 as JAX computes them
# ---------------------------------------------------------------------------

_F32 = np.float32
# Cephes' log polynomial, as XLA's CPU backend evaluates jnp.log in float32
_LOG_P = [_F32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]


def _fma(a, b, c) -> np.float32:
    # a * b is exact in float64; the sum rounds once there, then to float32
    return _F32(np.float64(a) * np.float64(b) + np.float64(c))


def log_f32(x: float) -> np.float32:
    """log(x) for x >= 1 in float32, bit for bit the value jnp.log gives on
    the CPU (XLA's Cephes polynomial with fused multiply-adds), so the
    schedules below equal JAX's at every step."""
    m, e = np.frexp(_F32(x))
    m, e = _F32(m), _F32(e)
    if m < _F32(0.707106781186547524):        # m in [sqrt(1/2), sqrt(2))
        e, m = e - _F32(1), m - _F32(1) + m
    else:
        m = m - _F32(1)
    x2 = _F32(m * m)
    x3 = _F32(x2 * m)
    p = _LOG_P
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _F32(e * _F32(-2.12194440e-4)))
    m = _F32(_F32(m - _F32(x2 * _F32(0.5))) + y)
    return _fma(e, _F32(0.693359375), m)


def lr_schedule(base_lr: float, target: int = 16000
                ) -> Callable[[int], float]:
    """Log warmup to target // 4, then linear decay to 0 at `target`."""
    peak = target // 4

    def fn(step: int) -> float:
        step = _F32(step)
        if step < _F32(peak):
            mult = _F32(log_f32(step + _F32(1.0)) / _F32(math.log(peak + 1)))
        else:
            decay = _F32(_F32(1.0) - _F32(step - _F32(peak))
                         / _F32(target - peak))
            mult = min(max(decay, _F32(0.0)), _F32(1.0))
        return float(_F32(_F32(base_lr) * mult))

    return fn


def lr_schedule_warmup_constant(base_lr: float, warmup: int = 10_000
                                ) -> Callable[[int], float]:
    """Linear warmup over `warmup` steps, then constant."""

    def fn(step: int) -> float:
        frac = min(_F32(_F32(step) / _F32(warmup)), _F32(1.0))
        return float(_F32(_F32(base_lr) * frac))

    return fn


def select_lr_schedules(tc: VisualizerTrainConfig
                        ) -> Tuple[Callable[[int], float],
                                   Callable[[int], float]]:
    """(adapter schedule, UNet schedule). A from-scratch UNet switches BOTH
    to warmup-then-constant."""
    if tc.unet_from_scratch:
        return (lr_schedule_warmup_constant(tc.learning_rate),
                lr_schedule_warmup_constant(tc.unet_lr))
    return (lr_schedule(tc.learning_rate, tc.total_steps),
            lr_schedule(tc.unet_lr, tc.total_steps))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def loss_draws(generator: torch.Generator, latents: Tuple[int, ...],
               tc: VisualizerTrainConfig, num_train_timesteps: int
               ) -> Dict[str, torch.Tensor]:
    """The step's random draws, from `generator` on its device, fp32:
    `drop` [B] bool (CFG dropout), `noise` and `eps` (the posterior's)
    shaped like the latents, `t` [B] ints in [0, num_train_timesteps),
    `offset` [B, 1, 1, C] (drawn only when tc.noise_offset > 0)."""
    B, C = latents[0], latents[-1]
    kw = dict(generator=generator, device=generator.device)
    out = {"drop": torch.rand(B, **kw) < tc.cfg_prob,
           "noise": torch.randn(latents, **kw),
           "t": torch.randint(0, num_train_timesteps, (B,), **kw),
           "eps": torch.randn(latents, **kw)}
    if tc.noise_offset > 0:
        out["offset"] = torch.randn((B, 1, 1, C), **kw)
    return out


def visualizer_loss(adapter_params: ParamTree, unet_params: ParamTree,
                    vae_params: ParamTree, cfgs, siglip_embeds: torch.Tensor,
                    images: torch.Tensor, generator: torch.Generator,
                    rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """One training step's loss. cfgs = (train_cfg, unet_cfg, vae_cfg,
    sched); siglip_embeds [B, 64, 1152], images [B, R, R, 3] in [-1, 1].
    rows = (i, n): the batch is the i-th of n equal shares of a global
    batch, whose draws are made and cut to this share's rows."""
    tc, unet_cfg, vae_cfg, sched = cfgs
    dev = images.device
    i, n = rows
    B = images.shape[0]
    shape = latent_shape(vae_cfg, (B * n, *images.shape[1:]))
    draws = {k: v[i * B:(i + 1) * B].to(dev) for k, v in loss_draws(
        generator, shape, tc, sched.cfg.num_train_timesteps).items()}

    cond = apply_adapter(adapter_params, siglip_embeds, mode=tc.adapter_mode)
    cond = pad_tokens(cond, 77)
    cond = torch.where(draws["drop"][:, None, None], 0.0, cond)

    with torch.no_grad():
        latents = vae_encode(vae_params, vae_cfg, images, eps=draws["eps"])

    noise = draws["noise"].to(latents.dtype)
    if tc.noise_offset > 0:
        noise = noise + tc.noise_offset * draws["offset"].to(latents.dtype)
    t = draws["t"]
    noisy = sched.add_noise(latents, noise, t)

    pred = unet_apply(unet_params, unet_cfg, noisy, t, cond)
    return ((pred.float() - noise.float()) ** 2).mean()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _zero_grads(tree: ParamTree) -> None:
    for p in tree.parameters():
        p.grad = None


def make_visualizer_train_step(tc: VisualizerTrainConfig, unet_cfg: UNetConfig,
                               vae_cfg: VAEConfig,
                               sched: Optional[DDPMScheduler] = None,
                               mesh=None):
    """Returns (step_fn, init_state). step_fn(state, siglip_embeds, images,
    generator) -> (state, loss) updates the state in place; state =
    {adapter, unet, vae, opt_adapter, opt_unet}. The adapter trains, and
    with `tc.unfreeze_unet` the UNet too, each under its own AdamW
    (optax's adamw, b1 0.9, b2 0.999, weight decay 0.01) and schedule; the
    VAE never does. The frozen UNet still carries the gradient from its
    output back to the conditioning. With `mesh` (a DeviceMesh over every
    rank of the process group) siglip_embeds and images are this rank's
    rows, the generator is seeded alike on every rank, and the loss is the
    global batch's."""
    rows = (0, 1)
    if mesh is not None:
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the visualizer's mesh must span every rank "
                             f"({mesh.size()} of {dist.get_world_size()})")
        rows = (dist.get_rank(), dist.get_world_size())
    sched = sched or DDPMScheduler()
    cfgs = (tc, unet_cfg, vae_cfg, sched)
    adapter_sched, unet_sched = select_lr_schedules(tc)
    tx_adapter = PlainAdamW(adapter_sched, b1=0.9, b2=0.999,
                            weight_decay=0.01)
    tx_unet = PlainAdamW(unet_sched, b1=0.9, b2=0.999, weight_decay=0.01)
    trained = ("adapter", "unet") if tc.unfreeze_unet else ("adapter",)

    def step(state, siglip_embeds: torch.Tensor, images: torch.Tensor,
             generator: torch.Generator):
        for name in ("adapter", "unet", "vae"):
            state[name].requires_grad_(name in trained)
            _zero_grads(state[name])
        if mesh is not None:
            check_backend(images.device)
        loss = visualizer_loss(state["adapter"], state["unet"], state["vae"],
                               cfgs, siglip_embeds, images, generator, rows)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            # the global batch's mean: each rank's mean over its equal
            # share, averaged
            for name in trained:
                for p in state[name].parameters():
                    if p.grad is not None:
                        dist.all_reduce(p.grad)
                        p.grad.div_(rows[1])
            dist.all_reduce(loss)
            loss.div_(rows[1])
        tx_adapter.update(state["adapter"], state["opt_adapter"])
        if tc.unfreeze_unet:
            tx_unet.update(state["unet"], state["opt_unet"])
        for name in trained:
            _zero_grads(state[name])
        return state, loss

    def init_state(seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32) -> dict:
        """Random adapter, UNet and VAE (seeds seed, seed + 1, seed + 2) on
        `device` (the card unless the caller passes another), and zero
        optimizer states."""
        device = resolve_device(device)
        adapter = init_adapter(tc.adapter_mode,
                               output_dim=unet_cfg.cross_attention_dim,
                               num_tokens=tc.num_tokens, seed=seed,
                               device=device, dtype=dtype)
        unet = init_unet_params(unet_cfg, seed + 1, device, dtype)
        vae = init_vae_params(vae_cfg, seed + 2, device, dtype)
        return {"adapter": adapter, "unet": unet, "vae": vae,
                "opt_adapter": tx_adapter.init(adapter),
                "opt_unet": tx_unet.init(unet)}

    return step, init_state


# ---------------------------------------------------------------------------
# tar-shard dataset (WebDataset-style)
# ---------------------------------------------------------------------------

def iter_tar_shards(shard_paths: List[str], process_index: int,
                    process_count: int) -> Iterator[bytes]:
    """Yield raw image bytes from the tar shards assigned to this *global*
    process (the sorted shards split into equal runs, the last process
    taking the rest)."""
    shards = sorted(shard_paths)
    per = len(shards) // max(process_count, 1)
    start = process_index * per
    end = len(shards) if process_index == process_count - 1 else start + per
    for path in shards[start:end]:
        with tarfile.open(path, "r") as tf:
            for member in tf:
                if member.name.endswith((".jpg", ".jpeg", ".png")):
                    f = tf.extractfile(member)
                    if f is not None:
                        yield f.read()


def decode_and_preprocess(img_bytes: bytes, siglip_size: int, vae_size: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (siglip_pixels [S,S,3], vae_image [R,R,3] in [-1,1]); a corrupt
    image raises (the caller skips it)."""
    from PIL import Image

    from metamorph_tpu_torch.multimodal.mm_utils import (resize_bilinear,
                                                         siglip_preprocess)

    img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
    arr = np.asarray(img)
    sig = siglip_preprocess(arr, siglip_size)
    # resize the short side, then center crop
    h, w = arr.shape[:2]
    scale = vae_size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_bilinear(arr, (nh, nw))
    top, left = (nh - vae_size) // 2, (nw - vae_size) // 2
    crop = resized[top:top + vae_size, left:left + vae_size]
    vae_img = (crop / 255.0 - 0.5) / 0.5
    return sig.astype(np.float32), vae_img.astype(np.float32)
