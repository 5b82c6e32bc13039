"""Driver of the enhancer's training: optimizer steps of the step that
`train.step.make_train_step` returns, at the configuration's loss weights
(MSE, DINO, MS-SSIM, colour), domain routing, clip and AdamW, on the
program's DynamicUNet and DINO ViT-S/14, both with weights made from the
seed. Batches are paired (degraded input, clean target) uint8 images made
on the card from the seed, `bank` of them of `batch` images, the domains
alternating: an underwater batch is tinted blue-green (its mean blue above
its mean red), an atmospheric one dark and warm. End-to-end and check as
trainrun.py says.
"""

from __future__ import annotations

import torch

from benchmark import harness, inputs, trainrun
from benchmark.reference import dino, layers, unet

SALT_WEIGHTS, SALT_DINO, SALT_DATA = 7, 8, 9
# Per-channel (R, G, B) gain and offset of each domain's degraded input.
DOMAINS = {"underwater": ((0.45, 0.8, 1.0), (0.0, 10.0, 35.0)),
           "atmospheric": ((0.35, 0.3, 0.25), (0.0, 0.0, 0.0))}


def batches(run: harness.Run) -> list[dict]:
    size = run.config["model"]["img_size"]
    B = run.mix["batch"]
    gen = inputs.generator(run.seed, SALT_DATA, run.device)
    out = []
    for k in range(run.mix["bank"]):
        gt = inputs.smooth_images(gen, B, size, size, run.device)
        gain, offset = DOMAINS["underwater" if k % 2 == 0 else "atmospheric"]
        gain = torch.tensor(gain, device=run.device)
        offset = torch.tensor(offset, device=run.device)
        inp = (gt.float() * gain + offset).clamp(0, 255).to(torch.uint8)
        out.append({"input": inp, "gt": gt})
    return out


def program_model(run: harness.Run, weights: dict):
    from hybrid_diffusion_tpu_torch.models.unet import DynamicUNet

    m = run.config["model"]
    dtype = torch.bfloat16 if run.config["precision"] == "bf16" else \
        torch.float32
    with torch.device("meta"):
        model = DynamicUNet(T=m["T"], ch=m["channel"],
                            ch_mult=tuple(m["channel_mult"]),
                            num_res_blocks=m["num_res_blocks"],
                            num_heads=m["num_heads"], dtype=dtype,
                            dropout=m["dropout"])
    model = model.to_empty(device=run.device)
    model.load_state_dict(weights, strict=True)
    return model.train()


def setup(run: harness.Run) -> dict:
    from hybrid_diffusion_tpu_torch.diffusion.schedule import \
        linear_beta_schedule
    from hybrid_diffusion_tpu_torch.losses.composite import \
        CompositeLossConfig
    from hybrid_diffusion_tpu_torch.losses.perceptual import \
        DinoPerceptualLoss
    from hybrid_diffusion_tpu_torch.train.step import make_train_step
    from hybrid_diffusion_tpu_torch.train.train_state import TrainState

    m, d, tr = (run.config[k] for k in ("model", "diffusion", "training"))
    bf16 = run.config["precision"] == "bf16"
    weights = inputs.seeded_state(
        inputs.param_spec(unet.build(m, layers.FP32, "meta")), run.seed,
        SALT_WEIGHTS, run.device)
    dino_weights = inputs.seeded_state(
        inputs.param_spec(dino.build(tr["dino"], layers.FP32, "meta")),
        run.seed, SALT_DINO, run.device)
    model = program_model(run, weights)
    extractor = DinoPerceptualLoss(
        seed=1, dtype=torch.bfloat16 if bf16 else torch.float32,
        device=run.device)
    extractor.model.load_state_dict(dino_weights, strict=True)
    w = tr["loss"]
    loss_config = CompositeLossConfig(
        mse_weight=w["mse"], dino_weight=w["dino"],
        ms_ssim_weight=w["ms_ssim"], color_weight=w["color"],
        charbonnier_weight=0.0, vgg_weight=0.0)
    ts = TrainState(model, lr=tr["lr"], weight_decay=tr["weight_decay"],
                    grad_clip=tr["grad_clip"], total_epochs=tr["epochs"],
                    steps_per_epoch=tr["steps_per_epoch"],
                    multiplier=tr["multiplier"])
    step = make_train_step(
        linear_beta_schedule(d["beta_1"], d["beta_T"], m["T"]), loss_config,
        dino_loss_fn=extractor, use_conditioning=False,
        domain_routing=tr["domain_routing"])
    state = {"train_state": ts, "step": step, "extra": extractor,
             "weights": weights, "dino_weights": dino_weights,
             "batches": batches(run),
             "generator": trainrun.step_generator(run)}
    trainrun.first_steps(run, state)
    return state


def window(run: harness.Run, state: dict) -> harness.Window:
    return trainrun.window(run, state)


def _reference(run: harness.Run, state: dict):
    def build(op):
        model = unet.build(run.config["model"], op, run.device)
        model.load_state_dict(state["weights"], strict=True)
        vit = dino.build(run.config["training"]["dino"], op, run.device)
        vit.load_state_dict(state["dino_weights"], strict=True)
        vit.requires_grad_(False)
        return model, vit
    return build


def check(run: harness.Run, state: dict) -> list[harness.Check]:
    trainrun.free_program(run, state)
    state["program"] = {"first": state["program"],
                        "window": trainrun.window_step(state)}
    state["reference"] = trainrun.follow(run, state, _reference(run, state),
                                         layers.FP32)
    return trainrun.checks(run, state, trainrun.readings(
        state["program"], state["reference"]))


def control(run: harness.Run, state: dict) -> dict:
    """The control's readings (fp8 products in the program's place), the
    program's worst leaves, and a TF32 twin's readings (a witness of how
    far rounding alone moves each number)."""
    low = trainrun.follow(run, state, _reference(run, state), layers.FP8)
    out = trainrun.readings(low, state["reference"], worst=3)
    prog = trainrun.readings(state["program"], state["reference"], worst=3)
    out["program_grad1_worst"] = prog["grad1_worst"]
    out["program_change_worst"] = prog["change_worst"]
    twin = trainrun.follow(run, state, _reference(run, state), layers.TF32)
    out["tf32_witness"] = {k: v for k, v in trainrun.readings(
        twin, state["reference"]).items() if isinstance(v, float)}
    return out
