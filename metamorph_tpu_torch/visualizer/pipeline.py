"""The render path (counterpart of `metamorph_tpu/visualizer/pipeline.py`):
predicted SigLIP embeddings -> pixels.

Per 64-token chunk of generated visual embeddings: adapter -> pad to 77
tokens -> classifier-free-guidance denoising loop -> VAE decode. The
default sampler is PNDM at 50 steps, the SD-1.5 pipeline's default;
`scheduler="ddim"` and `"dpmpp"` (DPM-Solver++ 2M) are the others. The
null conditioning is the all-zeros 77 x 768 tensor, as training drops it
in.

Everything runs on the device and in the dtype of the modules' weights;
the scheduler's latents are fp32, cast to the UNet's dtype for each call
and its prediction cast back. The initial latents are drawn from the
caller's `torch.Generator` (`initial_latents`), on the generator's own
device, so one CPU generator gives the same noise on every device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from metamorph_tpu_torch.visualizer.adapter import apply_adapter, pad_tokens
from metamorph_tpu_torch.visualizer.params import ParamTree
from metamorph_tpu_torch.visualizer.scheduler import (
    DDIMScheduler, DPMSolverPlusPlusScheduler, PNDMScheduler, SchedulerConfig)
from metamorph_tpu_torch.visualizer.unet import UNetConfig, unet_apply
from metamorph_tpu_torch.visualizer.vae import VAEConfig, vae_decode


def _weights(tree: ParamTree) -> torch.Tensor:
    return next(tree.parameters())


def initial_latents(generator: torch.Generator, shape) -> torch.Tensor:
    """The render's starting noise: N(0, 1) in fp32 from `generator`, on
    the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


@torch.no_grad()
def render(
    adapter_params: ParamTree,
    unet_params: ParamTree,
    vae_params: ParamTree,
    unet_cfg: UNetConfig,
    vae_cfg: VAEConfig,
    siglip_embeds: torch.Tensor,     # [B, 64, 1152]
    generator: torch.Generator,
    adapter_mode: str = "mlp",
    guidance_scale: float = 7.5,
    num_inference_steps: int = 50,
    latent_size: int = 64,
    scheduler: str = "pndm",         # pndm (the SD-1.5 default) | ddim
                                     #   | dpmpp (2M: ~50-step quality at 20)
    scheduler_cfg: SchedulerConfig = SchedulerConfig(),
) -> torch.Tensor:
    """Returns images [B, H, W, 3] in [0, 1], fp32, on the UNet's device."""
    if scheduler not in ("pndm", "dpmpp", "ddim"):
        raise ValueError(f"unknown scheduler {scheduler}")
    w = _weights(unet_params)
    a = _weights(adapter_params)
    B = siglip_embeds.shape[0]

    cond = pad_tokens(apply_adapter(adapter_params,
                                    siglip_embeds.to(a.device, a.dtype),
                                    mode=adapter_mode), 77)
    ctx = torch.cat([torch.zeros_like(cond), cond]).to(w.dtype)  # [2B, 77, D]

    latents = initial_latents(generator, (
        B, latent_size, latent_size, unet_cfg.sample_channels)).to(w.device)

    def eps_fn(latents, t):
        lat2 = torch.cat([latents, latents]).to(w.dtype)
        tt = torch.full((2 * B,), int(t), dtype=torch.int32, device=w.device)
        eps_u, eps_c = unet_apply(unet_params, unet_cfg, lat2, tt,
                                  ctx).float().chunk(2)
        return eps_u + guidance_scale * (eps_c - eps_u)

    if scheduler == "ddim":
        sched = DDIMScheduler(scheduler_cfg)
        ts = sched.timesteps(num_inference_steps)
        for i, t in enumerate(ts):
            t_prev = ts[i + 1] if i + 1 < len(ts) else -1
            latents = sched.step(eps_fn(latents, t), int(t), int(t_prev),
                                 latents)
    else:
        sched = (PNDMScheduler if scheduler == "pndm"
                 else DPMSolverPlusPlusScheduler)(scheduler_cfg)
        for t in sched.set_timesteps(num_inference_steps):
            latents = sched.step(eps_fn(latents, t), int(t), latents)

    v = _weights(vae_params)
    images = vae_decode(vae_params, vae_cfg,
                        latents.to(v.device, v.dtype)).float()
    return (images / 2.0 + 0.5).clamp(0.0, 1.0)


def render_multi_scale(adapter_params, unet_params, vae_params, unet_cfg,
                       vae_cfg, siglip_embeds, generator: torch.Generator,
                       guidance_scales: Sequence[float] = (6.0, 7.5, 10.0,
                                                           12.5),
                       **kw) -> torch.Tensor:
    """The demo renders each image at several guidance scales, every one
    from the same initial latents: the generator is set back to its
    state at the call before each scale. Returns [B, n_scales, H, W, 3]."""
    state = generator.get_state()
    outs = []
    for g in guidance_scales:
        generator.set_state(state)
        outs.append(render(adapter_params, unet_params, vae_params, unet_cfg,
                           vae_cfg, siglip_embeds, generator,
                           guidance_scale=g, **kw))
    return torch.stack(outs, dim=1)
