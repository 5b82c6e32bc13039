"""Tiny cells for the CPU tests: each real cell's configuration and mix
cut to a size a CPU runs in seconds, in fp32 (so that a sound run reads
round-off against the reference), with the real cell's limits."""

from __future__ import annotations

import copy

import torch

from benchmark import harness, inputs
from benchmark.reference import layers, unet

TINY_MODEL = {"channel": 32, "channel_mult": [1, 2], "num_res_blocks": 1}


def cell(name: str, tmp_path=None) -> harness.Cell:
    real = harness.find_cell(name)
    config, mix = copy.deepcopy(real.config), copy.deepcopy(real.mix)
    config["precision"] = "fp32"
    config["model"].update(TINY_MODEL)
    driver = mix["driver"]
    if driver == "enhance":
        config["model"]["img_size"] = 32
        mix.update(side_min=24, side_max=48, pool_requests=3,
                   check_requests=2)
        config["serving_weights"] = str(_tiny_npz(config, tmp_path))
    elif driver == "cfg_sample":
        config["model"].update(img_size=8, T=12)
        mix.update(labels=2, per_label=2, check_steps=3)
    elif driver == "train":
        config["model"]["img_size"] = 32
        mix.update(batch=2, bank=4)
    return harness.Cell(name, real.workload, config, mix, real.end_to_end,
                        real.per_layer)


def _tiny_npz(config: dict, tmp_path):
    """A serving npz in the published flax layout, seeded weights with the
    head convolution at 1/32 (so a 5-step chain on random weights stays
    well-conditioned)."""
    from hybrid_diffusion_tpu_torch.weights import save_npz_state_dict

    meta = unet.build(config["model"], layers.FP32, "meta")
    state = inputs.seeded_state(inputs.param_spec(meta), 5, 9, "cpu")
    state["head.weight"] = state["head.weight"] / 32
    path = tmp_path / "tiny_enhancer.npz"
    save_npz_state_dict(path, {k: v.clone() for k, v in state.items()},
                        dtype="float32")
    return path


def run(name: str, tmp_path=None, seconds: float = 1.0,
        trace: bool = False, seed: int = 2**31 + 11) -> harness.Run:
    torch.manual_seed(0)
    return harness.Run(cell(name, tmp_path), seed, seconds, trace,
                       device="cpu")
