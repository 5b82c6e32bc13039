"""Run configuration: one dataclass and its command line.

Counterpart of `hybrid_diffusion_tpu/config.py` (:23-225), with the same
fields, names and defaults, and `parse_config` building the same flags.
State names mean what they say: `eval` evaluates the val split, `test` the
test split, and `inference` is an alias for `test`.

The port adds one field, `device` ("cuda" unless the caller asks for
"cpu"). Fields that only the TPU package acts on:

  - `use_pallas_attention` and `compilation_cache` have no effect: the
    port's attention on the card is always its CUDA kernel, and it compiles
    no XLA programs to cache;
  - `mesh_data` or `mesh_model` beyond 1, and `zero1`, raise
    NotImplementedError: the port runs on one card (ROADMAP.md, queue 1,
    item 7).
"""

from __future__ import annotations

import argparse
import dataclasses
import pprint as _pprint
from typing import Optional, Sequence


@dataclasses.dataclass
class Config:
    # dispatch
    state: str = "train"                      # train | eval | test | enhance
    # data
    underwater_data_name: str = "HICRD"
    atmospheric_data_name: str = "LoLI"
    dataset_path: str = "./data/"
    supervised: bool = True
    synthetic_data: bool = False              # the synthetic paired corpus
    synthetic_length: int = 64
    # model
    T: int = 1000
    channel: int = 128
    channel_mult: Sequence[int] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    dropout: float = 0.15
    img_size: int = 256
    # optimization
    lr: float = 5e-5
    multiplier: float = 2.0
    beta_1: float = 1e-4
    beta_T: float = 0.02
    grad_clip: float = 1.0
    weight_decay: float = 1e-4
    batch_size: int = 16
    ema_decay: float = 0.0                    # >0: keep EMA params
    grad_accum: int = 1                       # micro-batches per update
    # staged training: atmospheric stage, then underwater stage
    epochs_stage_1: int = 1000
    epochs_stage_2: int = 1000
    # one stage interleaving both domains' loaders (epochs_stage_1 epochs)
    joint_training: bool = False
    save_checkpoint: int = 200                # checkpoint cadence in epochs
    # sampling: "dpm++2m" selects DPM-Solver++(2M); "" lets `ddim` pick
    sampler: str = ""
    ddim: bool = True
    ddim_step: int = 100
    unconditional_guidance_scale: float = 1.0
    # losses
    dino_weight: float = 0.5
    ms_ssim_weight: float = 0.0045
    color_weight: float = 1.0
    charbonnier_weight: float = 0.0
    vgg_weight: float = 0.0
    vgg_model: str = "vgg16"
    aux_snr_weight: bool = False
    # per-stage loss weight overrides, "name=weight,..." ("" = the above)
    stage1_losses: str = ""
    stage2_losses: str = ""
    use_conditioning: bool = False
    p_uncond: float = 0.02
    domain_routing: bool = True
    # fraction of stage-2 steps that train on the stage-1 domain instead
    stage2_replay: float = 0.0
    # paths / io
    pretrained_path: Optional[str] = None
    resume_from: Optional[str] = None         # a checkpoint, or "auto"
    init_from_npz: str = ""                   # warm start from a params npz
    export_npz: str = ""                      # npz + sidecar at every save
    output_path: str = "./results/"
    checkpoint_dir: str = "./output/ckpt/"
    inference_image: str = ""
    # observability
    wandb: bool = False
    wandb_name: str = "HybridDiffusion_TPU"
    log_every: int = 0                        # per-term log every N steps
    eval_every: int = 0                       # val PSNR probe every N epochs
    eval_probe_steps: int = 15
    eval_probe_batches: int = 1
    # execution
    bf16: bool = True
    use_pallas_attention: bool = False        # no effect in the port
    remat: bool = False                       # recompute ResBlocks
    mesh_data: Optional[int] = None           # >1 raises: one card
    mesh_model: int = 1                       # >1 raises: one card
    zero1: bool = False                       # raises: one card
    async_checkpoint: bool = False            # periodic saves in background
    epoch: int = 2000                         # eval-time checkpoint selector
    seed: int = 0
    num_workers: int = 4
    device_data: bool = False                 # train corpus on the card
    compilation_cache: str = ".jax_cache"     # no effect in the port
    device: str = "cuda"                      # "cpu" only when asked for

    def __post_init__(self):
        if (self.mesh_data or 1) > 1 or self.mesh_model > 1 or self.zero1:
            raise NotImplementedError(
                "mesh_data/mesh_model beyond 1 and zero1 need the parallel "
                "slice, which the port does not have yet (ROADMAP.md, queue "
                "1, item 7)")

    def pprint(self) -> None:
        print("\nFinal configuration:")
        _pprint.pprint(dataclasses.asdict(self))

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

    def stage_loss_config(self, stage_index: int):
        """Loss weights for stage `stage_index` (0-based): the shared
        weights overlaid with that stage's --stageN_losses overrides."""
        base = self.loss_config
        spec = (self.stage1_losses, self.stage2_losses)[min(stage_index, 1)]
        if not spec:
            return base
        return dataclasses.replace(base, **{
            f"{name}_weight": w
            for name, w in parse_loss_overrides(spec).items()})


_LOSS_NAMES = ("mse", "dino", "ms_ssim", "color", "charbonnier", "vgg")


def parse_loss_overrides(spec: str) -> dict:
    """Parse 'name=weight,name=weight' into {name: float}.

    Valid names: mse, dino, ms_ssim, color, charbonnier, vgg.
    """
    out = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, sep, value = item.partition("=")
        name = name.strip()
        if not sep or name not in _LOSS_NAMES:
            raise ValueError(
                f"bad loss override {item!r}: expected name=weight with "
                f"name in {_LOSS_NAMES}")
        out[name] = float(value)
    return out


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    """A Config from command-line flags: --<field> for every field, and
    --<flag>/--no-<flag> for the booleans."""
    defaults = Config()
    p = argparse.ArgumentParser(
        description="Hybrid two-domain diffusion enhancement (PyTorch port)")
    for f in dataclasses.fields(Config):
        name = f.name
        default = getattr(defaults, name)
        if isinstance(default, bool):
            p.add_argument(f"--{name}", dest=name,
                           action=argparse.BooleanOptionalAction,
                           default=default)
        elif name == "channel_mult":
            p.add_argument("--channel_mult", type=int, nargs="+",
                           default=list(default))
        elif default is None:
            p.add_argument(f"--{name}", default=None,
                           type=int if name == "mesh_data" else str)
        else:
            p.add_argument(f"--{name}", type=type(default), default=default)
    args = p.parse_args(argv)
    cfg = Config(**{f.name: getattr(args, f.name)
                    for f in dataclasses.fields(Config)})
    if cfg.state == "inference":
        cfg.state = "test"
    return cfg


def flagship_config(**overrides) -> Config:
    """The flagship operating point: 256², ch 128, mult (1,2,2,2), 2 res
    blocks, T 1000, bf16, DPM++2M with 5 steps, guidance 1.0
    (flagship256_r5_dpm5_eval.json)."""
    return dataclasses.replace(Config(sampler="dpm++2m", ddim_step=5),
                               **overrides)
