"""DPM-Solver++(2M): deterministic 2nd-order multistep sampling.

Counterpart of `hybrid_diffusion_tpu/diffusion/dpm_solver.py`, as a Python
loop over the steps. Update rule (data prediction):
    λ_t = log(α_t/σ_t),   α_t = sqrt(ᾱ_t),  σ_t = sqrt(1-ᾱ_t)
    h_i = λ_{t_i} − λ_{t_{i-1}}
    D_i = (1 + 1/(2r_i))·x0_i − (1/(2r_i))·x0_{i-1},  r_i = h_{i-1}/h_i
          (first step: D_1 = x0_1)
    x_{t_i} = (σ_{t_i}/σ_{t_{i-1}})·x_{t_{i-1}} − α_{t_i}·(e^{−h_i}−1)·D_i
The terminal step (σ = 0) returns D, with h set to 1 there, as in the JAX
scan. The scalar arithmetic is float32, as the scan's is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .process import ddim_time_grid
from .sampler import DenoiseFn, _guided_eps, initial_noise
from .schedule import DiffusionSchedule
from ..utils.profiling import span


def dpm_solver_coefficients(schedule: DiffusionSchedule,
                            steps: int) -> dict[str, np.ndarray]:
    """Per-step scalars over the uniform DDIM grid (float32 numpy)."""
    seq, seq_prev = ddim_time_grid(schedule.num_steps, steps)
    ab = np.asarray(schedule.alphas_bar, np.float64)
    a_cur = np.sqrt(ab[seq])
    s_cur = np.sqrt(1.0 - ab[seq])
    ab_next = np.where(seq_prev >= 0, ab[np.maximum(seq_prev, 0)], 1.0)
    a_next = np.sqrt(ab_next)
    s_next = np.sqrt(1.0 - ab_next)

    lam_cur = np.log(a_cur / s_cur)
    with np.errstate(divide="ignore"):
        lam_next = np.where(s_next > 0,
                            np.log(a_next / np.maximum(s_next, 1e-300)), 0.0)
    is_last = (seq_prev < 0).astype(np.float64)
    h = np.where(is_last > 0, 1.0, lam_next - lam_cur)
    sigma_ratio = np.where(s_cur > 0, s_next / s_cur, 0.0)
    phi = np.expm1(-h)

    f32 = lambda x: np.asarray(x, np.float32)
    return {
        "t": seq.astype(np.int64),
        "a_cur": f32(a_cur), "s_cur": f32(s_cur),
        "a_next": f32(a_next),
        "sigma_ratio": f32(sigma_ratio),
        "phi": f32(phi),
        "h": f32(h),
        "is_last": f32(is_last),
    }


@torch.no_grad()
def dpm_solver_pp_2m_sample(denoise_fn: DenoiseFn, schedule: DiffusionSchedule,
                            cond_image: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            steps: int = 20, guidance_scale: float = 1.0,
                            init_noise: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Deterministic DPM-Solver++(2M) conditioned on cond_image
    ((B, H, W, 3) in [-1, 1]); returns images in [-1, 1]."""
    B = cond_image.shape[0]
    c = dpm_solver_coefficients(schedule, steps)
    x = initial_noise(cond_image, generator) if init_noise is None else init_noise
    x0_prev = None
    h_prev = np.float32(1.0)
    for i in range(steps):
        t_int = int(c["t"][i])
        with span("sampler/step", device=True, t=t_int):
            t = torch.full((B,), t_int, dtype=torch.long,
                           device=cond_image.device)
            eps = _guided_eps(denoise_fn, torch.cat([cond_image, x], dim=-1),
                              t, guidance_scale)
            x0 = (x - float(c["s_cur"][i]) * eps) / float(c["a_cur"][i])
            if x0_prev is None:
                d = x0
            else:
                half_inv_r = np.float32(1.0) / (np.float32(2.0)
                                                * (h_prev / c["h"][i]))
                d = (float(np.float32(1.0) + half_inv_r) * x0
                     - float(half_inv_r) * x0_prev)
            if c["is_last"][i] > 0:
                x = d
            else:
                x = (float(c["sigma_ratio"][i]) * x
                     - float(c["a_next"][i] * c["phi"][i]) * d)
            x0_prev, h_prev = x0, c["h"][i]
    return x.clamp(-1.0, 1.0)
