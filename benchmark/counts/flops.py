"""Model FLOPs per item, from `torch.utils.flop_counter.FlopCounterMode`
run over the plain reference on the meta device (shapes only, nothing
computed): a U-Net forward per image ("sample"), or the training step's
forward and backward per image ("train": the U-Net's forward and
backward, and the loss terms', DINO's forward on both images and its
backward to its input)."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import layers, unet


def model_inputs(model_cfg: dict, batch: int, device="meta") -> tuple:
    """(x, t, conditioning) of one forward at `batch`."""
    size = model_cfg["img_size"]
    t = torch.zeros(batch, dtype=torch.long, device=device)
    if model_cfg["kind"] == "DynamicUNet":
        return (torch.zeros(batch, size, size, 6, device=device), t, True)
    return (torch.zeros(batch, size, size, 3, device=device), t,
            torch.ones(batch, dtype=torch.long, device=device))


def count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@functools.lru_cache(maxsize=None)
def _per_item(config_json: str, kind: str) -> float:
    config = json.loads(config_json)
    model = unet.build(config["model"], layers.FP32, "meta")
    batch = 2
    if kind == "sample":
        return count(lambda: model(*model_inputs(config["model"], batch))) / batch
    if kind == "train":
        from benchmark.reference import training

        return count(lambda: training.meta_step(config, model, batch)) / batch
    raise ValueError(f"unknown kind of work {kind!r}")


def per_item(config: dict, kind: str) -> float:
    """FLOPs per image of one model call of `kind`."""
    return _per_item(json.dumps(config, sort_keys=True), kind)


def window_flops(config: dict, work: dict) -> float:
    """FLOPs of a window's work: model calls × batch × per image."""
    return work["model_calls"] * work["batch"] * per_item(config, work["kind"])
