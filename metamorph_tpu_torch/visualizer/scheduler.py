"""Diffusion noise schedulers (counterpart of
`metamorph_tpu/visualizer/scheduler.py`): DDPM (training), PNDM (the
SD-1.5 pipeline's default, which the demo renders with), DDIM and
DPM-Solver++ (2M).

SD-1.5's schedule: scaled_linear betas 0.00085 -> 0.012 over 1000 steps,
epsilon prediction. PNDM is PLMS with skip_prk_steps, steps_offset=1 and
set_alpha_to_one=False, as diffusers configures it for SD-1.5.

Each class keeps the JAX package's precision: PNDM and DPM++ take their
coefficients from float64 numpy tables, DDPM and DDIM from float32 tables.
Timesteps stay numpy arrays and python ints on the host; only the samples
are tensors, on whatever device the caller keeps them. A coefficient is
always a python float when it meets a tensor, so the product is the
tensor's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps,
                           dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_timesteps, dtype=np.float64) ** 2
    raise ValueError(cfg.beta_schedule)


class DDPMScheduler:
    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        betas = make_betas(cfg)
        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas).astype(np.float32)
        self.betas = betas.astype(np.float32)
        self.alphas = alphas.astype(np.float32)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t) -> torch.Tensor:
        """q(x_t | x_0): sqrt(a_t) x0 + sqrt(1-a_t) eps. t: [B] ints."""
        a = torch.from_numpy(self.alphas_cumprod).to(x0.device)[
            torch.as_tensor(t, device=x0.device).long()]
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return (torch.sqrt(a).reshape(shape) * x0
                + torch.sqrt(1.0 - a).reshape(shape) * noise)

    def step(self, model_out: torch.Tensor, t: int, sample: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One ancestral DDPM step x_t -> x_{t-1} (epsilon parametrization);
        the noise is drawn from `generator` (none: the mean)."""
        t = int(t)
        one = np.float32(1.0)
        a_t = self.alphas_cumprod[t]
        a_prev = self.alphas_cumprod[t - 1] if t > 0 else one
        beta_t = self.betas[t]
        x0 = (sample - float(np.sqrt(one - a_t)) * model_out) / float(
            np.sqrt(a_t))
        x0 = x0.clamp(-1000.0, 1000.0)
        coef_x0 = np.sqrt(a_prev) * beta_t / (one - a_t)
        coef_xt = np.sqrt(self.alphas[t]) * (one - a_prev) / (one - a_t)
        mean = float(coef_x0) * x0 + float(coef_xt) * sample
        if generator is None or t == 0:
            return mean
        var = beta_t * (one - a_prev) / (one - a_t)
        noise = torch.randn(sample.shape, generator=generator,
                            device=generator.device,
                            dtype=sample.dtype).to(sample.device)
        return mean + float(np.sqrt(max(var, np.float32(1e-20)))) * noise


class PNDMScheduler:
    """PLMS sampler matching diffusers' PNDMScheduler as configured by
    SD-1.5 (skip_prk_steps=True, steps_offset=1, set_alpha_to_one=False):
    the first step is a plain (DDIM-form) step with an eps average on the
    repeated timestep, then 2nd/3rd/4th-order linear multistep on the eps
    history. Stateful across `step` calls: call `set_timesteps` per
    sampling run."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(),
                 steps_offset: int = 1):
        self.cfg = cfg
        self.steps_offset = steps_offset
        betas = make_betas(cfg)
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.final_alpha_cumprod = self.alphas_cumprod[0]  # set_alpha_to_one=False
        self._reset()

    def _reset(self):
        self.ets: list = []
        self.counter = 0
        self.cur_sample = None

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        self._reset()
        self.step_ratio = self.cfg.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * self.step_ratio).round()
        ts = ts + self.steps_offset
        # skip_prk_steps: plms timesteps repeat the second-to-last ascending
        # entry once (diffusers pndm.set_timesteps)
        plms = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
        self.timesteps = plms.astype(np.int64)
        return self.timesteps

    def _prev_sample(self, sample, t: int, t_prev: int, eps):
        a_t = self.alphas_cumprod[t]
        a_prev = (self.alphas_cumprod[t_prev] if t_prev >= 0
                  else self.final_alpha_cumprod)
        sample_coeff = (a_prev / a_t) ** 0.5
        denom = a_t * (1 - a_prev) ** 0.5 + (a_t * (1 - a_t) * a_prev) ** 0.5
        return (float(sample_coeff) * sample
                - float(a_prev - a_t) * eps / float(denom))

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor
             ) -> torch.Tensor:
        """One PLMS step (diffusers step_plms semantics)."""
        t = int(t)
        t_prev = t - self.step_ratio
        if self.counter != 1:
            self.ets = self.ets[-3:] + [model_output]
        else:
            t_prev = t
            t = t + self.step_ratio

        if len(self.ets) == 1 and self.counter == 0:
            eps = model_output
            self.cur_sample = sample
        elif len(self.ets) == 1 and self.counter == 1:
            eps = (model_output + self.ets[-1]) / 2
            sample = self.cur_sample
            self.cur_sample = None
        elif len(self.ets) == 2:
            eps = (3 * self.ets[-1] - self.ets[-2]) / 2
        elif len(self.ets) == 3:
            eps = (23 * self.ets[-1] - 16 * self.ets[-2] + 5 * self.ets[-3]) / 12
        else:
            eps = (55 * self.ets[-1] - 59 * self.ets[-2] + 37 * self.ets[-3]
                   - 9 * self.ets[-4]) / 24

        self.counter += 1
        return self._prev_sample(sample, t, t_prev, eps)


class DDIMScheduler:
    """Deterministic DDIM sampler over a strided subset of timesteps."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        betas = make_betas(cfg)
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        step = self.cfg.num_train_timesteps // num_inference_steps
        return (np.arange(num_inference_steps) * step).round()[::-1].astype(np.int32)

    def step(self, model_out: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor, eta: float = 0.0) -> torch.Tensor:
        one = np.float32(1.0)
        a_t = self.alphas_cumprod[int(t)]
        a_prev = self.alphas_cumprod[int(t_prev)] if t_prev >= 0 else one
        x0 = (sample - float(np.sqrt(one - a_t)) * model_out) / float(
            np.sqrt(a_t))
        dir_xt = float(np.sqrt(one - a_prev)) * model_out
        return float(np.sqrt(a_prev)) * x0 + dir_xt


class DPMSolverPlusPlusScheduler:
    """DPM-Solver++ (2M): second-order linear-multistep ODE solver in the
    data-prediction parametrization (diffusers'
    DPMSolverMultistepScheduler(algorithm_type='dpmsolver++',
    solver_order=2)); PNDM-at-50-steps quality in ~20 steps. Stateful
    across `step` calls: call `set_timesteps` per sampling run."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        ac = np.cumprod(1.0 - make_betas(cfg))
        self.alpha = np.sqrt(ac)
        self.sigma = np.sqrt(1.0 - ac)
        self.lam = np.log(self.alpha) - np.log(self.sigma)
        self._reset()

    def _reset(self):
        self._m1 = None     # previous x0 prediction
        self._t1 = None     # its timestep
        self._i = 0         # position in self.timesteps

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        step = self.cfg.num_train_timesteps // num_inference_steps
        return self.set_custom_timesteps(
            (np.arange(num_inference_steps) * step).round()[::-1])

    def set_custom_timesteps(self, ts) -> np.ndarray:
        """Arbitrary descending timestep grid (non-uniform grids included)."""
        self._reset()
        self.timesteps = np.asarray(ts, np.int32)
        return self.timesteps

    def step(self, model_out: torch.Tensor, t: int, sample: torch.Tensor
             ) -> torch.Tensor:
        """One 2M step to the next grid timestep (epsilon model output)."""
        t = int(t)
        t_prev = (int(self.timesteps[self._i + 1])
                  if self._i + 1 < len(self.timesteps) else -1)
        self._i += 1
        x0 = (sample - float(self.sigma[t]) * model_out) / float(self.alpha[t])
        if t_prev < 0:
            # exact limit: sigma_prev -> 0 collapses the update to x0
            out = x0
        else:
            h = self.lam[t_prev] - self.lam[t]          # > 0 (descending t)
            phi = float(np.expm1(-h))
            ratio = float(self.sigma[t_prev] / self.sigma[t])
            a_prev = float(self.alpha[t_prev])
            if self._m1 is None:
                out = ratio * sample - a_prev * phi * x0      # 1st order
            else:
                h0 = self.lam[t] - self.lam[self._t1]
                d1 = (x0 - self._m1) * float(h / h0)          # (D0-m1)/r0
                out = (ratio * sample - a_prev * phi * x0
                       - 0.5 * a_prev * phi * d1)
        self._m1, self._t1 = x0, t
        return out
