"""Model construction, the training step's set-up, and the sampler.

Counterpart of `hybrid_diffusion_tpu/train/loop.py::build_model` (:67-77),
`init_params` (:80-91), `_make_dino` (:124-132), the train state of
`train` (:498-507) and `make_sampler` (:723-778). (The `train()` loop with
its loaders, checkpoints and SIGTERM handling, and evaluation, come with
later slices.)
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import Config
from ..diffusion import ddim_sample, dpm_solver_pp_2m_sample, linear_beta_schedule
from ..losses import DinoPerceptualLoss
from ..models import DynamicUNet
from ..weights import load_npz_state_dict
from .step import normalize_uint8
from .train_state import TrainState


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
        dropout=config.dropout,
        remat=config.remat,
    )


def init_params(config: Config, device="cuda") -> DynamicUNet:
    """The model of `config` on `device`, its parameters initialized: from
    `config.init_from_npz` when set (a warm start), else with the JAX
    model's init drawn from `config.seed` (the global generator's state is
    left as it was)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = build_model(config)
    if config.init_from_npz:
        model.load_state_dict(load_npz_state_dict(config.init_from_npz),
                              strict=True)
    return model.to(device)


def create_train_state(config: Config, model: DynamicUNet,
                       steps_per_epoch: int,
                       total_epochs: Optional[int] = None) -> TrainState:
    """A fresh optimizer over `model` with the configuration's lr, decay,
    clip, warmup-cosine over `total_epochs` (default epochs_stage_1) and
    EMA, as the JAX `train` makes one per stage."""
    return TrainState(
        model, lr=config.lr, weight_decay=config.weight_decay,
        grad_clip=config.grad_clip,
        total_epochs=total_epochs or config.epochs_stage_1,
        steps_per_epoch=steps_per_epoch, multiplier=config.multiplier,
        ema_decay=config.ema_decay, grad_accum=config.grad_accum)


def make_dino(config: Config, device="cuda") -> Optional[DinoPerceptualLoss]:
    """The DINO extractor when the loss uses it (random init from seed 1,
    or HDT_DINO_WEIGHTS), computing in bf16 when `config.bf16`."""
    if not config.dino_weight:
        return None
    return DinoPerceptualLoss(
        seed=1, dtype=torch.bfloat16 if config.bf16 else torch.float32,
        device=resolve_device(device))


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
