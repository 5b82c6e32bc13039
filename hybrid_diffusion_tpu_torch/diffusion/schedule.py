"""Diffusion noise schedule: coefficient tables of a linear-β diffusion.

Counterpart of `hybrid_diffusion_tpu/diffusion/schedule.py`. The tables are
computed in float64 numpy and cast to float32 once; they stay numpy arrays,
because the samplers derive their per-step scalars from them on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """float32 tables of shape (T,)."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_bar: np.ndarray
    alphas_bar_prev: np.ndarray          # ᾱ_{t-1}, with ᾱ_{-1} := 1
    sqrt_alphas_bar: np.ndarray
    sqrt_one_minus_alphas_bar: np.ndarray
    coeff1: np.ndarray                   # 1/sqrt(α_t)
    coeff2: np.ndarray                   # coeff1 * β_t / sqrt(1-ᾱ_t)
    posterior_var: np.ndarray            # β_t (1-ᾱ_{t-1}) / (1-ᾱ_t)
    sampling_var: np.ndarray             # cat([posterior_var[1:2], betas[1:]])

    @property
    def num_steps(self) -> int:
        return int(self.betas.shape[0])


def linear_beta_schedule(beta_1: float, beta_T: float, T: int) -> DiffusionSchedule:
    """Linear β from β₁ to β_T over T steps, every derived table included."""
    betas = np.linspace(beta_1, beta_T, T, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_bar = np.cumprod(alphas)
    alphas_bar_prev = np.concatenate([[1.0], alphas_bar[:-1]])
    coeff1 = np.sqrt(1.0 / alphas)
    coeff2 = coeff1 * (1.0 - alphas) / np.sqrt(1.0 - alphas_bar)
    posterior_var = betas * (1.0 - alphas_bar_prev) / (1.0 - alphas_bar)
    sampling_var = np.concatenate([posterior_var[1:2], betas[1:]])

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DiffusionSchedule(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_bar=f32(alphas_bar),
        alphas_bar_prev=f32(alphas_bar_prev),
        sqrt_alphas_bar=f32(np.sqrt(alphas_bar)),
        sqrt_one_minus_alphas_bar=f32(np.sqrt(1.0 - alphas_bar)),
        coeff1=f32(coeff1),
        coeff2=f32(coeff2),
        posterior_var=f32(posterior_var),
        sampling_var=f32(sampling_var),
    )
