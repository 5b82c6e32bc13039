"""Run configuration of the serving path and the training step.

Counterpart of `hybrid_diffusion_tpu/config.py::Config`, cut to the fields
that the enhancement path and the training step read, with the same names
and defaults. It has no command line yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class Config:
    # model
    T: int = 1000
    channel: int = 128
    channel_mult: Sequence[int] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    dropout: float = 0.15
    img_size: int = 256
    bf16: bool = True
    remat: bool = False                 # recompute ResBlocks in the backward
    # noise schedule
    beta_1: float = 1e-4
    beta_T: float = 0.02
    # optimization
    lr: float = 5e-5
    multiplier: float = 2.0
    grad_clip: float = 1.0
    weight_decay: float = 1e-4
    batch_size: int = 16
    ema_decay: float = 0.0              # >0: keep EMA params
    grad_accum: int = 1                 # >1 is not ported (ROADMAP.md)
    epochs_stage_1: int = 1000
    # losses
    dino_weight: float = 0.5
    ms_ssim_weight: float = 0.0045
    color_weight: float = 1.0
    charbonnier_weight: float = 0.0
    vgg_weight: float = 0.0
    aux_snr_weight: bool = False
    p_uncond: float = 0.02
    domain_routing: bool = True
    # warm start: a flat params npz to initialize the model from
    init_from_npz: str = ""
    # sampling: sampler "dpm++2m" selects DPM-Solver++(2M); "" lets `ddim`
    # pick DDIM (ddpm waits for a later slice)
    sampler: str = ""
    ddim: bool = True
    ddim_step: int = 100
    unconditional_guidance_scale: float = 1.0
    use_conditioning: bool = False
    seed: int = 0

    @property
    def loss_config(self):
        from .losses import CompositeLossConfig

        return CompositeLossConfig(
            dino_weight=self.dino_weight,
            ms_ssim_weight=self.ms_ssim_weight,
            color_weight=self.color_weight,
            charbonnier_weight=self.charbonnier_weight,
            vgg_weight=self.vgg_weight,
            aux_snr_weight=self.aux_snr_weight,
        )


def flagship_config(**overrides) -> Config:
    """The flagship operating point: 256², ch 128, mult (1,2,2,2), 2 res
    blocks, T 1000, bf16, DPM++2M with 5 steps, guidance 1.0
    (flagship256_r5_dpm5_eval.json)."""
    return dataclasses.replace(Config(sampler="dpm++2m", ddim_step=5),
                               **overrides)
