"""Diffusion arithmetic, plainly: the linear-β schedule, DPM-Solver++(2M)
over the uniform DDIM grid, and the guided ancestral DDPM chain of the
classifier-free-guidance model (Lu et al. 2022, arXiv:2211.01095; Ho &
Salimans 2022, arXiv:2207.12598). Tables in float64, cast to float32 where
the published samplers keep float32 scalars.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def linear_schedule(beta_1: float, beta_T: float, T: int) -> dict:
    """float64 tables of a linear β schedule."""
    betas = np.linspace(beta_1, beta_T, T, dtype=np.float64)
    alphas = 1.0 - betas
    ab = np.cumprod(alphas)
    ab_prev = np.concatenate([[1.0], ab[:-1]])
    posterior_var = betas * (1.0 - ab_prev) / (1.0 - ab)
    return {"betas": betas, "alphas": alphas, "alphas_bar": ab,
            "coeff1": np.sqrt(1.0 / alphas),
            "coeff2": np.sqrt(1.0 / alphas) * betas / np.sqrt(1.0 - ab),
            "sampling_var": np.concatenate([posterior_var[1:2], betas[1:]])}


def dpm_solver_pp_2m(eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                     sched: dict, x: torch.Tensor, steps: int) -> torch.Tensor:
    """DPM-Solver++(2M) from the initial noise x over `steps` uniform
    timesteps t_i = (steps − 1 − i)·T/steps; eps_fn(x, t) is the model's ε.
    Data prediction x0 = (x − σ ε)/α, λ = log(α/σ), the second-order
    multistep update, and at the last step (σ' = 0) the corrected x0.
    Returns x clipped to [-1, 1]."""
    T = len(sched["betas"])
    stride = T // steps
    ts = (np.arange(steps) * stride)[::-1]
    ab = sched["alphas_bar"]
    f32 = np.float32
    x0_prev, h_prev = None, None
    for i, t in enumerate(ts):
        a, s = np.sqrt(ab[t]), np.sqrt(1.0 - ab[t])
        last = i == steps - 1
        ab_next = 1.0 if last else ab[ts[i + 1]]
        a_next, s_next = np.sqrt(ab_next), np.sqrt(1.0 - ab_next)
        h = 1.0 if last else np.log(a_next / s_next) - np.log(a / s)
        eps = eps_fn(x, int(t))
        x0 = (x - float(f32(s)) * eps) / float(f32(a))
        if x0_prev is None:
            d = x0
        else:
            r = f32(h_prev) / f32(h)
            half_inv_r = f32(1.0) / (f32(2.0) * r)
            d = float(f32(1.0) + half_inv_r) * x0 - float(half_inv_r) * x0_prev
        if last:
            x = d
        else:
            x = (float(f32(s_next / s)) * x
                 - float(f32(a_next) * f32(np.expm1(-h))) * d)
        x0_prev, h_prev = x0, h
    return x.clamp(-1.0, 1.0)


def cfg_ddpm_chain(eps_fn: Callable[[torch.Tensor, int, torch.Tensor],
                                    torch.Tensor],
                   sched: dict, labels: torch.Tensor, w: float,
                   x: torch.Tensor, step_noise: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    """The full ancestral chain t = T−1 … 0 with classifier-free guidance:
    ε = (1 + w)·ε(x, t, labels) − w·ε(x, t, null), then
    x ← coeff1·x − coeff2·ε + sqrt(var)·z_i (no noise at t = 0).
    step_noise[i] is the noise of step i (timestep T−1−i)."""
    T = len(sched["betas"])
    null = torch.zeros_like(labels)
    for i, t in enumerate(range(T - 1, -1, -1)):
        eps_c = eps_fn(x, t, labels)
        eps_u = eps_fn(x, t, null)
        eps = (1.0 + w) * eps_c - w * eps_u
        x = (float(np.float32(sched["coeff1"][t])) * x
             - float(np.float32(sched["coeff2"][t])) * eps)
        if t > 0:
            x = x + float(np.float32(np.sqrt(np.float32(
                sched["sampling_var"][t])))) * step_noise[i]
    return x.clamp(-1.0, 1.0)
