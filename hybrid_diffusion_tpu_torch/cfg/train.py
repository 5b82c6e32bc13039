"""CFG CIFAR-10 training and evaluation.

Counterpart of `hybrid_diffusion_tpu/cfg/train.py`:

  - labels are shifted +1 (0 is the null slot) and dropped to 0 with
    probability `p_uncond`; `unconditional=True` pins every label to 0;
  - the loss is mean-MSE on the noise; `sum_div_b2=True` gives the
    reference's sum / B² instead;
  - the optimizer is the port's TrainState (clip, AdamW on a warmup-cosine
    at `multiplier`), and its EMA update, which is a no-op at the JAX
    defaults' decay 0;
  - `evaluate_cfg` samples an nrow-per-class label grid through the full
    T-step CFG chain and writes a PNG grid.

Every random draw of a step (t, ε, the label drop, the dropout masks) comes
from the caller's `torch.Generator`, in that order; for parity tests the
step also takes `t`, `noise` and `drop`, which replace the first three.
Every entry point runs on `config.device` ("cuda" unless the caller asks for
"cpu"); an fp32 configuration (`bf16=False`) runs with TF32 off
(utils/precision.py).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..data.pipeline import BatchLoader
from ..data.registry import save_image
from ..diffusion.process import q_sample
from ..diffusion.schedule import DiffusionSchedule, linear_beta_schedule
from ..models.cfg_unet import CFGUNet
from ..train.checkpoint import restore_params, save_checkpoint
from ..train.train_state import TrainState
from ..utils.device import resolve_device
from ..utils.precision import precision_for
from .data import make_labeled_dataset
from .sampler import cfg_ddpm_sample


@dataclasses.dataclass
class CFGConfig:
    """The reference's operating point, and the device to run on."""

    state: str = "train"
    epochs: int = 70
    batch_size: int = 80
    T: int = 500
    channel: int = 128
    channel_mult: tuple = (1, 2, 2, 2)
    num_res_blocks: int = 2
    dropout: float = 0.15
    lr: float = 1e-4
    multiplier: float = 2.5
    beta_1: float = 1e-4
    beta_T: float = 0.028
    img_size: int = 32
    grad_clip: float = 1.0
    w: float = 1.8
    p_uncond: float = 0.1
    num_labels: int = 10
    nrow: int = 8
    unconditional: bool = False          # all labels pinned to the null slot
    sum_div_b2: bool = False             # the reference's loss scaling
    save_dir: str = "./CheckpointsCondition/"
    sampled_dir: str = "./SampledImgs/"
    data_root: Optional[str] = None      # local CIFAR-10; None → synthetic
    synthetic_length: int = 256
    bf16: bool = True
    seed: int = 0
    save_every: int = 1                  # epochs between checkpoints
    device: str = "cuda"


def normalize_cifar(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return x.to(torch.float32) / 255.0 * 2.0 - 1.0


def cfg_train_step(state: TrainState, batch: Mapping, generator: torch.Generator,
                   schedule: DiffusionSchedule, p_uncond: float = 0.1,
                   unconditional: bool = False, sum_div_b2: bool = False,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None
                   ) -> tuple[TrainState, dict]:
    """One CFG diffusion step, in place on `state`.

    batch: {"image": (B, H, W, 3) uint8, "label": (B,) int in [0, 10)},
    tensors or numpy arrays; the step runs on the model's device. `drop`
    ((B,) bool) marks the labels dropped to the null slot. Returns (state,
    {"loss": device scalar}).
    """
    device = next(iter(state.params.values())).device
    x0 = normalize_cifar(torch.as_tensor(batch["image"]).to(device))
    B = x0.shape[0]
    labels = torch.as_tensor(batch["label"]).to(device).long() + 1
    if t is None:
        t = torch.randint(0, schedule.num_steps, (B,), device=device,
                          generator=generator)
    t = t.to(device)
    if noise is None:
        noise = torch.randn(x0.shape, device=device, generator=generator)
    noise = noise.to(device)
    if unconditional:
        labels = torch.zeros_like(labels)
    else:
        if drop is None:
            drop = torch.rand((B,), device=device,
                              generator=generator) < p_uncond
        labels = torch.where(drop.to(device), 0, labels)
    x_t = q_sample(schedule, x0, t, noise)

    state.optimizer.zero_grad(set_to_none=True)
    eps = state.model(x_t, t, labels, train=True, generator=generator)
    sq = (eps.float() - noise) ** 2
    loss = sq.sum() / (B ** 2) if sum_div_b2 else sq.mean()
    loss.backward()
    state.apply_gradients()
    state.update_ema()
    return state, {"loss": loss.detach()}


def make_cfg_train_step(schedule: DiffusionSchedule, p_uncond: float = 0.1,
                        unconditional: bool = False,
                        sum_div_b2: bool = False) -> Callable:
    """step(state, batch, generator, t=None, noise=None, drop=None) ->
    (state, metrics), closed over the static configuration. The schedule's
    tables are copied to the model's device at the first call; an fp32
    model's step runs with TF32 off."""
    tables = None

    def step(state, batch, generator, t=None, noise=None, drop=None):
        nonlocal tables
        if tables is None:
            device = next(iter(state.params.values())).device
            tables = DiffusionSchedule(**{
                f.name: torch.as_tensor(getattr(schedule, f.name),
                                        device=device)
                for f in dataclasses.fields(schedule)})
        with precision_for(state.model.dtype != torch.float32):
            return cfg_train_step(state, batch, generator, tables, p_uncond,
                                  unconditional, sum_div_b2, t=t,
                                  noise=noise, drop=drop)

    return step


def build_cfg_model(config: CFGConfig) -> CFGUNet:
    """The CFGUNet of `config`, bf16 compute when `config.bf16`."""
    return CFGUNet(T=config.T, num_labels=config.num_labels,
                   ch=config.channel, ch_mult=tuple(config.channel_mult),
                   num_res_blocks=config.num_res_blocks,
                   dropout=config.dropout,
                   dtype=torch.bfloat16 if config.bf16 else torch.float32)


def init_cfg_model(config: CFGConfig, device) -> CFGUNet:
    """The model of `config` on `device`, initialized from `config.seed`
    (the global generator's state is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = build_cfg_model(config)
    return model.to(device)


def train_cfg(config: CFGConfig, max_steps: Optional[int] = None) -> dict:
    """The epoch loop; returns {"steps", "losses" (the last step's loss of
    each epoch), "params" (a state_dict), "checkpoints" (their paths)}."""
    device = resolve_device(config.device)
    ds = make_labeled_dataset(config.data_root, train=True,
                              synthetic_length=config.synthetic_length,
                              image_size=config.img_size)
    loader = BatchLoader(ds, config.batch_size, shuffle=True,
                         seed=config.seed)
    schedule = linear_beta_schedule(config.beta_1, config.beta_T, config.T)
    model = init_cfg_model(config, device)
    state = TrainState(model, lr=config.lr, weight_decay=1e-4,
                       grad_clip=config.grad_clip, total_epochs=config.epochs,
                       steps_per_epoch=max(len(loader), 1),
                       multiplier=config.multiplier)
    step_fn = make_cfg_train_step(schedule, config.p_uncond,
                                  config.unconditional,
                                  sum_div_b2=config.sum_div_b2)
    generator = torch.Generator(device).manual_seed(config.seed)
    summary: dict = {"steps": 0, "losses": [], "checkpoints": []}
    for epoch in range(config.epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        metrics = None
        for batch in loader:
            arrays = {"image": torch.from_numpy(batch["image"]).to(device),
                      "label": torch.from_numpy(batch["label"]).to(device)}
            state, metrics = step_fn(state, arrays, generator)
            summary["steps"] += 1
            if max_steps and summary["steps"] >= max_steps:
                break
        loss = float(metrics["loss"]) if metrics is not None else float("nan")
        summary["losses"].append(loss)
        print(f"[cfg] epoch {epoch + 1}/{config.epochs} loss={loss:.4f} "
              f"{time.time() - t0:.1f}s")
        if (epoch + 1) % config.save_every == 0:
            summary["checkpoints"].append(save_checkpoint(
                config.save_dir, epoch + 1,
                "Uncond" if config.unconditional else "CFG", "CIFAR10", state,
                generator=generator))
        if max_steps and summary["steps"] >= max_steps:
            break
    summary["params"] = {n: p.detach() for n, p in state.params.items()}
    return summary


@torch.no_grad()
def evaluate_cfg(config: CFGConfig,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 checkpoint_path: Optional[str] = None,
                 save_png: bool = True) -> np.ndarray:
    """Sample an nrow-per-class label grid through the full T-step CFG
    chain at guidance `config.w` (0 when unconditional).

    The weights: `params` (a state_dict, e.g. train_cfg's "params"), else a
    checkpoint or params npz at `checkpoint_path`, else the seeded init.
    The noise comes from a generator seeded with config.seed + 1. Returns
    the (num_labels·nrow, H, W, 3) uint8 samples;
    writes `SampledGuidenceImgs.png` under config.sampled_dir.
    """
    device = resolve_device(config.device)
    model = init_cfg_model(dataclasses.replace(config, dropout=0.0), device)
    if params is not None:
        model.load_state_dict(dict(params), strict=True)
    elif checkpoint_path:
        restore_params(checkpoint_path, model)
    model.eval()
    schedule = linear_beta_schedule(config.beta_1, config.beta_T, config.T)
    # nrow samples of each class 1..num_labels (labels are +1-shifted).
    labels = torch.arange(1, config.num_labels + 1,
                          device=device).repeat_interleave(config.nrow)
    if config.unconditional:
        labels = torch.zeros_like(labels)
    generator = torch.Generator(device).manual_seed(config.seed + 1)
    with precision_for(config.bf16):
        out = cfg_ddpm_sample(model, schedule, labels, generator,
                              image_size=config.img_size,
                              w=0.0 if config.unconditional else config.w)
    imgs = ((out + 1.0) / 2.0 * 255.0).clamp(0, 255).to(torch.uint8)
    imgs = imgs.cpu().numpy()
    if save_png:
        os.makedirs(config.sampled_dir, exist_ok=True)
        path = os.path.join(config.sampled_dir, "SampledGuidenceImgs.png")
        _write_png(path, _image_grid(imgs, config.nrow))
        print(f"[cfg] wrote {path}")
    return imgs


def _image_grid(imgs: np.ndarray, nrow: int) -> np.ndarray:
    """(n, h, w, c) -> one (rows·h, nrow·w, c) image, zero-padded."""
    n, h, w, c = imgs.shape
    rows = (n + nrow - 1) // nrow
    pad = rows * nrow - n
    if pad:
        imgs = np.concatenate([imgs, np.zeros((pad, h, w, c), imgs.dtype)])
    return (imgs.reshape(rows, nrow, h, w, c)
                .transpose(0, 2, 1, 3, 4)
                .reshape(rows * h, nrow * w, c))


def _write_png(path: str, img: np.ndarray) -> None:
    """cv2, else PIL, else the standard library's PNG writer
    (data/registry.py::save_image)."""
    save_image(path, img)
