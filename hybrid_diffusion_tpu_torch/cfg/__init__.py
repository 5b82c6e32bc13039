"""Classifier-free-guidance CIFAR-10 subsystem on one card.

Counterpart of `hybrid_diffusion_tpu/cfg/`: the label-conditioned CFGUNet
(models/cfg_unet.py) trained as a DDPM with label dropout, and sampled
through the full T-step chain with the guidance mix.
"""

from .data import CIFAR10Dataset, SyntheticLabeledDataset, make_labeled_dataset
from .sampler import cfg_ddpm_sample
from .train import (
    CFGConfig,
    build_cfg_model,
    cfg_train_step,
    evaluate_cfg,
    make_cfg_train_step,
    train_cfg,
)

__all__ = [
    "CFGConfig",
    "CIFAR10Dataset",
    "SyntheticLabeledDataset",
    "build_cfg_model",
    "cfg_ddpm_sample",
    "cfg_train_step",
    "evaluate_cfg",
    "make_cfg_train_step",
    "make_labeled_dataset",
    "train_cfg",
]
