"""Run configuration of the serving path.

Counterpart of `hybrid_diffusion_tpu/config.py::Config`, cut to the fields
that the enhancement path reads, with the same names and defaults. It has no
command line yet.
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
    img_size: int = 256
    bf16: bool = True
    # noise schedule
    beta_1: float = 1e-4
    beta_T: float = 0.02
    # sampling: sampler "dpm++2m" selects DPM-Solver++(2M); "" lets `ddim`
    # pick DDIM (ddpm waits for a later slice)
    sampler: str = ""
    ddim: bool = True
    ddim_step: int = 100
    unconditional_guidance_scale: float = 1.0
    use_conditioning: bool = False
    seed: int = 0


def flagship_config(**overrides) -> Config:
    """The flagship operating point: 256², ch 128, mult (1,2,2,2), 2 res
    blocks, T 1000, bf16, DPM++2M with 5 steps, guidance 1.0
    (flagship256_r5_dpm5_eval.json)."""
    return dataclasses.replace(Config(sampler="dpm++2m", ddim_step=5),
                               **overrides)
