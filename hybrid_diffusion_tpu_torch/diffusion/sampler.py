"""Reverse-diffusion sampling: guided ε, full-T ancestral DDPM and DDIM.

Counterpart of `hybrid_diffusion_tpu/diffusion/sampler.py` (`_guided_eps`,
`ddpm_sample`, `ddim_sample`), as Python loops over the steps.

The ancestral step's noise comes from the caller's `torch.Generator`, which
cannot give the numbers of JAX's per-step keys: for a comparison with the
JAX sampler, `ddpm_sample` takes the whole noise sequence (`step_noise`)
from outside instead.

Denoiser contract, as in the JAX package:
    denoise_fn(x6: (B, H, W, 6) f32, t: (B,) int, context_zero=...)
        -> eps (B, H, W, 3) f32
with x6 = concat([cond_image, y_t], -1), both in [-1, 1].

Per-step scalars are float32 values (as the JAX scan's are), applied to
float32 tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .process import ddim_coefficients
from .schedule import DiffusionSchedule

DenoiseFn = Callable[..., torch.Tensor]


def _guided_eps(denoise_fn: DenoiseFn, x6: torch.Tensor, t: torch.Tensor,
                guidance_scale: float) -> torch.Tensor:
    """ε with classifier-free guidance.

    At guidance 1.0 one call with the denoiser's own context default;
    otherwise conditional and unconditional run as ONE 2B call with a
    per-example context_zero mask, mixed as ε_u + w·(ε_c − ε_u).
    """
    if guidance_scale == 1.0:
        return denoise_fn(x6, t)
    B = x6.shape[0]
    context_zero = torch.cat([torch.zeros(B, dtype=torch.bool),
                              torch.ones(B, dtype=torch.bool)]).to(x6.device)
    eps_both = denoise_fn(torch.cat([x6, x6]), torch.cat([t, t]),
                          context_zero=context_zero)
    eps_c, eps_u = eps_both.chunk(2)
    return eps_u + guidance_scale * (eps_c - eps_u)


class RowNoise:
    """A generator's normal draws for a global batch of `batch` rows, of
    which this rank keeps `rows` (the sharded sampler's: every rank draws
    what one process draws and keeps its part)."""

    def __init__(self, generator: Optional[torch.Generator], batch: int,
                 rows: slice):
        self.generator, self.batch, self.rows = generator, batch, rows

    def randn(self, shape: tuple, device) -> torch.Tensor:
        full = torch.randn((self.batch,) + tuple(shape[1:]),
                           generator=self.generator, device=device,
                           dtype=torch.float32)
        return full[self.rows]


def initial_noise(cond_image: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    if isinstance(generator, RowNoise):
        return generator.randn(tuple(cond_image.shape), cond_image.device)
    return torch.randn(cond_image.shape, generator=generator,
                       device=cond_image.device, dtype=torch.float32)


def ddpm_step(schedule: DiffusionSchedule, x_t: torch.Tensor, t: int,
              eps: torch.Tensor, z: Optional[torch.Tensor]) -> torch.Tensor:
    """One ancestral step at timestep t (one int for the whole batch):
    µ_{t-1} + sqrt(var_t)·z, with µ and var as `ddpm_posterior_mean` and
    `ddpm_sampling_variance` give them; at t = 0 the mean alone (z is not
    read)."""
    mean = float(schedule.coeff1[t]) * x_t - float(schedule.coeff2[t]) * eps
    if t == 0:
        return mean
    return mean + float(np.sqrt(schedule.sampling_var[t])) * z


@torch.no_grad()
def ddpm_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                cond_image: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                guidance_scale: float = 1.0,
                init_noise: Optional[torch.Tensor] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """Full-T ancestral DDPM, t = T−1 … 0. cond_image: (B, H, W, 3) in
    [-1, 1]. Returns images in [-1, 1].

    The noise of step i (timestep T−1−i) is `step_noise[i]` when given,
    else a draw from `generator`; the last step (t = 0) adds none.
    """
    T = schedule.num_steps
    B = cond_image.shape[0]
    y = initial_noise(cond_image, generator) if init_noise is None else init_noise
    for i, t_int in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), t_int, dtype=torch.long, device=cond_image.device)
        eps = _guided_eps(denoise_fn, torch.cat([cond_image, y], dim=-1), t,
                          guidance_scale)
        z = None
        if t_int > 0:
            z = (initial_noise(y, generator) if step_noise is None
                 else step_noise[i])
        y = ddpm_step(schedule, y, t_int, eps, z)
    return y.clamp(-1.0, 1.0)


@torch.no_grad()
def ddim_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                cond_image: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ddim_steps: int = 100, eta: float = 0.0,
                guidance_scale: float = 1.0,
                init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM over a T//ddim_steps-strided grid; η = 0 is deterministic given
    init_noise. cond_image: (B, H, W, 3) in [-1, 1]. Returns [-1, 1]."""
    B = cond_image.shape[0]
    c = ddim_coefficients(schedule, ddim_steps, eta)
    y = initial_noise(cond_image, generator) if init_noise is None else init_noise
    for i in range(ddim_steps):
        t = torch.full((B,), int(c["t"][i]), dtype=torch.long,
                       device=cond_image.device)
        eps = _guided_eps(denoise_fn, torch.cat([cond_image, y], dim=-1), t,
                          guidance_scale)
        x0 = (y - eps * float(c["sqrt_one_minus_at"][i])) / float(c["sqrt_at"][i])
        y_prev = float(c["sqrt_at_prev"][i]) * x0
        if c["c1"][i] != 0:
            y_prev = y_prev + float(c["c1"][i]) * initial_noise(y, generator)
        y = y_prev + float(c["c2"][i]) * eps
    return y.clamp(-1.0, 1.0)
