"""Inputs made from the seed, handed alike to the program and to the
reference: weights and data.

Weights are drawn on the device in one call (`seeded_state`): one uniform
draw over every parameter, scaled per leaf by one vector, so that the
number of launches does not grow with the number of leaves. A matrix or a
kernel gets variance 1/fan_in (so activations stay of order one through
the residual blocks), a bias ±0.1, a norm's scale 1 ± 0.1, a table or a
position embedding ±1. The leaves are views of one flat tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT3 = math.sqrt(3.0)


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on `device` for the stream `salt` of a run's seed."""
    mixed = np.random.SeedSequence([seed % 2**63, salt]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(mixed % 2**63))


def _leaf_rule(name: str, shape: tuple) -> tuple[float, float]:
    """(half-width, centre) of a leaf's uniform draw."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2 and leaf in ("weight", "k3", "k5", "kt"):
        fan_in = math.prod(shape[1:])
        return SQRT3 / math.sqrt(fan_in), 0.0
    if len(shape) >= 2:                       # tables, position embeddings
        return 1.0, 0.0
    if leaf in ("weight", "gamma_1", "gamma_2"):  # norm and layer scales
        return 0.1, 1.0
    return 0.1, 0.0                           # biases


def seeded_state(spec: dict[str, tuple], seed: int, salt: int,
                 device) -> dict[str, torch.Tensor]:
    """{name: fp32 tensor} for a {name: shape} spec, drawn from the seed."""
    names = list(spec)
    sizes = [math.prod(spec[n]) for n in names]
    rules = [_leaf_rule(n, tuple(spec[n])) for n in names]
    counts = torch.tensor(sizes, device=device)
    half = torch.repeat_interleave(
        torch.tensor([r[0] for r in rules], device=device), counts)
    centre = torch.repeat_interleave(
        torch.tensor([r[1] for r in rules], device=device), counts)
    u = torch.rand(sum(sizes), generator=generator(seed, salt, device),
                   device=device)
    flat = (u * 2.0 - 1.0) * half + centre
    out, at = {}, 0
    for n, size in zip(names, sizes):
        out[n] = flat[at: at + size].view(spec[n])
        at += size
    return out


def param_spec(module: torch.nn.Module) -> dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


def smooth_images(gen: torch.Generator, n: int, h: int, w: int, device,
                  cell: int = 16) -> torch.Tensor:
    """(n, h, w, 3) uint8 images: a coarse random field bilinearly
    upsampled, plus fine noise; image-like content at any size."""
    coarse = torch.rand((n, 3, h // cell + 2, w // cell + 2), generator=gen,
                        device=device)
    field = torch.nn.functional.interpolate(coarse, size=(h, w),
                                            mode="bilinear",
                                            align_corners=False)
    fine = torch.rand((n, 3, h, w), generator=gen, device=device)
    img = (0.85 * field + 0.15 * fine) * 255.0
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
