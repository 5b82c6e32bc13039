"""Forward diffusion, x₀ reconstruction, DDIM time grid and coefficients.

Counterpart of `hybrid_diffusion_tpu/diffusion/process.py`: `q_sample`,
`predict_x0_from_eps` (the training step's), the ancestral step's
`ddpm_posterior_mean` and `ddpm_sampling_variance`, `ddim_time_grid` and
`ddim_coefficients`. The DDIM coefficients are float32 numpy arrays, one
entry per step in sampling order.
"""

from __future__ import annotations

import numpy as np
import torch

from .schedule import DiffusionSchedule


def _gather(table: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients of `table` at t, shaped (B, 1, ..., 1)."""
    out = torch.as_tensor(table, device=t.device)[t.long()]
    return out.reshape(t.shape[0], *([1] * (ndim - 1)))


def q_sample(schedule: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion: x_t = sqrt(ᾱ_t)·x₀ + sqrt(1−ᾱ_t)·ε."""
    a = _gather(schedule.sqrt_alphas_bar, t, x0.ndim)
    b = _gather(schedule.sqrt_one_minus_alphas_bar, t, x0.ndim)
    return a * x0 + b * noise


def predict_x0_from_eps(schedule: DiffusionSchedule, x_t: torch.Tensor,
                        t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """x₀ = (x_t − sqrt(1−ᾱ_t)·ε) / sqrt(ᾱ_t)."""
    a = _gather(schedule.sqrt_alphas_bar, t, x_t.ndim)
    b = _gather(schedule.sqrt_one_minus_alphas_bar, t, x_t.ndim)
    return (x_t - b * eps) / a


def ddpm_posterior_mean(schedule: DiffusionSchedule, x_t: torch.Tensor,
                        t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """µ_{t-1} = coeff1_t·x_t − coeff2_t·ε."""
    c1 = _gather(schedule.coeff1, t, x_t.ndim)
    c2 = _gather(schedule.coeff2, t, x_t.ndim)
    return c1 * x_t - c2 * eps


def ddpm_sampling_variance(schedule: DiffusionSchedule, t: torch.Tensor,
                           ndim: int) -> torch.Tensor:
    """The ancestral loop's variance at t, shaped (B, 1, ..., 1): the table
    cat([posterior_var[1:2], betas[1:]]) (the posterior's at t = 0)."""
    return _gather(schedule.sampling_var, t, ndim)


def ddim_time_grid(T: int, ddim_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """Uniform subsequence (seq) and its predecessors (seq_prev, -1 at the
    terminal step), both ordered from high t to low t."""
    if not 1 <= ddim_steps <= T:
        raise ValueError(f"ddim_steps must be in [1, {T}], got {ddim_steps}")
    stride = T // ddim_steps
    seq = np.arange(0, ddim_steps) * stride
    seq_prev = np.concatenate([[-1], seq[:-1]])
    return seq[::-1].copy(), seq_prev[::-1].copy()


def ddim_coefficients(schedule: DiffusionSchedule, ddim_steps: int,
                      eta: float = 0.0) -> dict[str, np.ndarray]:
    """Per-step DDIM scalars (ᾱ indexed at t, ᾱ_{-1} := 1):
        x₀ = (x_t − sqrt(1−ᾱ_t)·ε) / sqrt(ᾱ_t)
        c1 = η·sqrt((1 − ᾱ_t/ᾱ_prev)(1 − ᾱ_prev)/(1 − ᾱ_t))
        c2 = sqrt((1 − ᾱ_prev) − c1²)
        x_prev = sqrt(ᾱ_prev)·x₀ + c1·z + c2·ε
    """
    seq, seq_prev = ddim_time_grid(schedule.num_steps, ddim_steps)
    alphas_bar = np.asarray(schedule.alphas_bar, dtype=np.float64)
    at = alphas_bar[seq]
    at_prev = np.where(seq_prev >= 0, alphas_bar[np.maximum(seq_prev, 0)], 1.0)

    c1 = eta * np.sqrt((1.0 - at / at_prev) * (1.0 - at_prev) / (1.0 - at))
    c2 = np.sqrt(np.maximum((1.0 - at_prev) - c1**2, 0.0))

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return {
        "t": seq.astype(np.int64),
        "sqrt_at": f32(np.sqrt(at)),
        "sqrt_one_minus_at": f32(np.sqrt(1.0 - at)),
        "sqrt_at_prev": f32(np.sqrt(at_prev)),
        "c1": f32(c1),
        "c2": f32(c2),
    }
