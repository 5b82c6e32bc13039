"""Reverse-diffusion sampling: guided ε and DDIM.

Counterpart of `hybrid_diffusion_tpu/diffusion/sampler.py::_guided_eps` and
`ddim_sample`, as a Python loop over the steps. (`ddpm_sample` waits: its
random stream cannot match JAX's.)

Denoiser contract, as in the JAX package:
    denoise_fn(x6: (B, H, W, 6) f32, t: (B,) int, context_zero=...)
        -> eps (B, H, W, 3) f32
with x6 = concat([cond_image, y_t], -1), both in [-1, 1].

Per-step scalars are float32 values (as the JAX scan's are), applied to
float32 tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

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


def initial_noise(cond_image: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(cond_image.shape, generator=generator,
                       device=cond_image.device, dtype=torch.float32)


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
