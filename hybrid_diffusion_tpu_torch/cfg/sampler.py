"""Label-conditioned ancestral DDPM with classifier-free guidance.

Counterpart of `hybrid_diffusion_tpu/cfg/sampler.py` (`_guided_eps`,
`cfg_ddpm_sample`), as a Python loop over the full T-step chain:

  - the guidance mix ε ← (1+w)·ε_cond − w·ε_uncond, the conditional and
    unconditional branches batched into ONE model call of 2B on
    [labels, 0]; w = 0 makes one call of B on the labels as given;
  - the ancestral step of `diffusion/sampler.py::ddpm_step` (the posterior
    mean and the `sampling_var` table the hybrid sampler uses);
  - a final clip to [-1, 1].

The per-step noise comes from the caller's `torch.Generator` (JAX's per-step
keys cannot be matched); `step_noise` hands in the whole sequence instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..diffusion.sampler import ddpm_step
from ..diffusion.schedule import DiffusionSchedule

# denoise_fn(x: (B, H, W, 3), t: (B,) int, labels: (B,) int) -> eps (B, H, W, 3)
LabelDenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                          torch.Tensor]


def _guided_eps(denoise_fn: LabelDenoiseFn, x_t: torch.Tensor,
                t: torch.Tensor, labels: torch.Tensor,
                w: float) -> torch.Tensor:
    """Guided ε. The JAX package's one-call path applies to a concrete
    w = 0 only; here w is always a Python number, so w = 0 is one call."""
    if w == 0.0:
        return denoise_fn(x_t, t, labels)
    eps_c, eps_u = denoise_fn(torch.cat([x_t, x_t]), torch.cat([t, t]),
                              torch.cat([labels, torch.zeros_like(labels)])
                              ).chunk(2)
    return (1.0 + w) * eps_c - w * eps_u


@torch.no_grad()
def cfg_ddpm_sample(denoise_fn: LabelDenoiseFn, schedule: DiffusionSchedule,
                    labels: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    image_size: int = 32, w: float = 1.8,
                    init_noise: Optional[torch.Tensor] = None,
                    step_noise: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """One image per label (labels: (B,) int, 0 = unconditional), on
    labels' device. Returns (B, image_size, image_size, 3) in [-1, 1].

    The noise of step i (timestep T−1−i) is `step_noise[i]` when given,
    else a draw from `generator`; the last step (t = 0) adds none.
    """
    T = schedule.num_steps
    B = labels.shape[0]
    shape = (B, image_size, image_size, 3)
    device = labels.device
    x = (torch.randn(shape, generator=generator, device=device)
         if init_noise is None else init_noise)
    for i, t_int in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), t_int, dtype=torch.long, device=device)
        eps = _guided_eps(denoise_fn, x, t, labels, w)
        z = None
        if t_int > 0:
            z = (torch.randn(shape, generator=generator, device=device)
                 if step_noise is None else step_noise[i])
        x = ddpm_step(schedule, x, t_int, eps, z)
    return x.clamp(-1.0, 1.0)
