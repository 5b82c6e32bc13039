"""Model construction and the sampler of the enhancement path.

Counterpart of `hybrid_diffusion_tpu/train/loop.py::build_model` (:67-77) and
`make_sampler` (:723-778). (Training, evaluation and checkpoints come with
later slices.)
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import Config
from ..diffusion import ddim_sample, dpm_solver_pp_2m_sample, linear_beta_schedule
from ..models import DynamicUNet
from .step import normalize_uint8


def resolve_device(device="cuda") -> torch.device:
    """The card unless the caller asks for the CPU; raises without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def build_model(config: Config) -> DynamicUNet:
    """The DynamicUNet of `config`, bf16 compute when `config.bf16`."""
    return DynamicUNet(
        T=config.T,
        ch=config.channel,
        ch_mult=tuple(config.channel_mult),
        num_res_blocks=config.num_res_blocks,
        dtype=torch.bfloat16 if config.bf16 else torch.float32,
    )


def make_sampler(config: Config, model: DynamicUNet,
                 quantize_uint8: bool = False) -> Callable[..., torch.Tensor]:
    """sample_fn(cond_u8, generator=None, init_noise=None) over the [-1, 1]
    pipeline: uint8 NHWC in, [0, 1] float (or, with quantize_uint8,
    clip(x·255, 0, 255) as uint8) NHWC out, on cond_u8's device.

    The model samples the way it was trained: without use_conditioning the
    condition embedding stays zeroed (guidance 1.0 uses that default).
    """
    schedule = linear_beta_schedule(config.beta_1, config.beta_T, config.T)
    uncond_default = not config.use_conditioning
    guidance = config.unconditional_guidance_scale

    def denoise(x6, t, context_zero=None):
        if context_zero is None:
            context_zero = uncond_default
        return model(x6, t, context_zero=context_zero)

    @torch.no_grad()
    def sample_fn(cond_u8: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        cond = normalize_uint8(cond_u8)
        if config.sampler == "dpm++2m":
            out = dpm_solver_pp_2m_sample(denoise, schedule, cond, generator,
                                          steps=config.ddim_step,
                                          guidance_scale=guidance,
                                          init_noise=init_noise)
        elif config.ddim:
            out = ddim_sample(denoise, schedule, cond, generator,
                              ddim_steps=config.ddim_step,
                              guidance_scale=guidance, init_noise=init_noise)
        else:
            raise NotImplementedError(
                "ddpm_sample is not ported yet (ROADMAP.md, queue 1)")
        out01 = (out + 1.0) / 2.0
        if quantize_uint8:
            return (out01 * 255.0).clamp(0, 255).to(torch.uint8)
        return out01

    return sample_fn
