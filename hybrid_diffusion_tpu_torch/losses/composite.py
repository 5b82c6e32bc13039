"""The trainer's composite objective. Counterpart of
`hybrid_diffusion_tpu/losses/composite.py`.

MSE on the noise, plus image-space terms on the reconstructed x₀ (clipped
to [−1, 1]): DINO perceptual, MS-SSIM and angular colour (both on (x+1)/2),
Charbonnier and VGG perceptual, with the JAX package's names and default
weights. With `aux_weights` (the step passes ᾱ_t when `aux_snr_weight` is
set) each image-space term becomes Σwᵢlᵢ / (Σwᵢ + 1e-8) over per-example
values.

With a process `group` (the mesh's "data" group) the loss is the global
batch's: Σwᵢlᵢ and Σwᵢ are summed over the group (the numerator through
`group_sum`, whose backward sums the gradient too), MS-SSIM takes its
per-scale means over the group, and the plain means (MSE, colour, DINO,
Charbonnier, VGG) stay per rank: equal per-rank batches average to the
global mean under the data-parallel gradient average.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..parallel.collectives import all_reduce_, group_sum
from .charbonnier import charbonnier_loss
from .color import angular_color_loss
from .ms_ssim import ms_ssim_loss


@dataclasses.dataclass(frozen=True)
class CompositeLossConfig:
    mse_weight: float = 1.0
    dino_weight: float = 0.5
    ms_ssim_weight: float = 0.0045
    color_weight: float = 1.0
    charbonnier_weight: float = 0.0
    vgg_weight: float = 0.0
    aux_snr_weight: bool = False


def composite_enhancement_loss(
    noise_pred: torch.Tensor,
    noise: torch.Tensor,
    x0_pred: torch.Tensor,
    gt: torch.Tensor,
    config: CompositeLossConfig = CompositeLossConfig(),
    dino_loss_fn: Optional[Callable] = None,
    vgg_loss_fn: Optional[Callable] = None,
    aux_weights: Optional[torch.Tensor] = None,
    group=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """All inputs NHWC; gt and x0_pred in [−1, 1]. Returns (loss, parts),
    parts holding each unweighted term and the total. A perceptual term
    whose loss function is None is left out, as in the JAX package."""
    parts: dict[str, torch.Tensor] = {}
    mse = torch.mean((noise_pred - noise) ** 2)
    parts["mse"] = mse
    loss = config.mse_weight * mse

    if aux_weights is not None:
        w = aux_weights.float()
        w_sum = all_reduce_(w.sum(), group)

        def reduce(fn, a, b):
            return (group_sum(torch.sum(w * fn(a, b, per_example=True)),
                              group) / (w_sum + 1e-8))
    else:
        def reduce(fn, a, b):
            return fn(a, b)

    x0_c = torch.clamp(x0_pred, -1.0, 1.0)
    if config.dino_weight and dino_loss_fn is not None:
        parts["dino"] = reduce(dino_loss_fn, x0_c, gt)
        loss = loss + config.dino_weight * parts["dino"]
    if config.ms_ssim_weight:
        a, b = (x0_c + 1) / 2, (gt + 1) / 2
        parts["ms_ssim"] = (ms_ssim_loss(a, b, group=group)
                            if aux_weights is None
                            else reduce(ms_ssim_loss, a, b))
        loss = loss + config.ms_ssim_weight * parts["ms_ssim"]
    if config.color_weight:
        parts["color"] = reduce(angular_color_loss, (x0_c + 1) / 2,
                                (gt + 1) / 2)
        loss = loss + config.color_weight * parts["color"]
    if config.charbonnier_weight:
        parts["charbonnier"] = reduce(charbonnier_loss, x0_c, gt)
        loss = loss + config.charbonnier_weight * parts["charbonnier"]
    if config.vgg_weight and vgg_loss_fn is not None:
        parts["vgg"] = reduce(vgg_loss_fn, x0_c, gt)
        loss = loss + config.vgg_weight * parts["vgg"]

    parts["total"] = loss
    return loss, parts
