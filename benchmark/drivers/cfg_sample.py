"""Driver of guided sampling: back-to-back label-grid requests through the
full T-step classifier-free-guidance chain, `cfg.sampler.cfg_ddpm_sample`,
on the program's CFGUNet with weights made from the seed.

Mix parameters: `labels` (the grid's classes) × `per_label` images a
request; `check_steps`, the number of steps of each finished chain the
check draws from the seed (the chain's last step is always among them).
Each request's initial and per-step noise is made on the card from the
seed (one draw a request) and handed in as `init_noise` and `step_noise`.

End-to-end: `cfg_sample_images_per_s`, images × (denoising steps completed
in the window) ÷ T ÷ the window. A CUDA event recorded after each call
into the model (no synchronisation) dates each step; steps that end after
the window are not counted, so a chain cut at the window's end counts the
steps it completed. The host stops starting steps one second after the
window (the card then has every step of the window queued).

Check, step by step: the chain is 500 steps long and the model's weights
are random, on which a trajectory amplifies round-off, so the reference
follows the program from the program's own state. At each sampled step s
it takes the program's x_s (the model's input at that step), computes the
guided ε in fp32 and the ancestral step with the same noise, and compares
with the program's x_{s+1} (the next step's input, or the chain's output
at the last step, clipped): `step_eps_rel` is ‖x_{s+1} − x_{s+1}^ref‖
over ‖coeff2·ε^ref‖, summed in squares over every sampled step and image,
the error of the step's model term relative to that term (the largest
single step's and image's are read but not compared: they swing from
seed to seed). The start is checked by itself:
`start_gap` is the largest |x_0 − init_noise|, which must be 0.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.reference import layers, sampling, unet

SALT_WEIGHTS, SALT_NOISE = 2, 3
RESUME_S = 1.0   # how long past the window the host keeps starting steps
HEAD_SCALE = 32.0


class _Stop(Exception):
    pass


def reference_model(run: harness.Run, state_dict: dict, op=layers.FP32):
    model = unet.build(run.config["model"], op, run.device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def seeded_weights(run: harness.Run) -> dict:
    """Weights from the seed, the head convolution's at 1/HEAD_SCALE: with
    random weights the chain's states grow to an RMS of tens (a trained
    model keeps them near 1), and with the head at the usual scale such
    inputs saturate the attention's softmax, where any rounding changes
    the output wholly (bf16 and fp8 then both read errors of order one)."""
    meta = unet.build(run.config["model"], layers.FP32, "meta")
    state = inputs.seeded_state(inputs.param_spec(meta), run.seed,
                                SALT_WEIGHTS, run.device)
    state["head.weight"] = state["head.weight"] / HEAD_SCALE
    return state


def program_model(run: harness.Run, state_dict: dict):
    from hybrid_diffusion_tpu_torch.models.cfg_unet import CFGUNet

    m = run.config["model"]
    dtype = torch.bfloat16 if run.config["precision"] == "bf16" else \
        torch.float32
    with torch.device("meta"):
        model = CFGUNet(T=m["T"], num_labels=m["num_labels"],
                        ch=m["channel"], ch_mult=tuple(m["channel_mult"]),
                        num_res_blocks=m["num_res_blocks"],
                        dropout=m["dropout"], num_heads=m["num_heads"],
                        dtype=dtype)
    model = model.to_empty(device=run.device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def labels(run: harness.Run) -> torch.Tensor:
    """The grid's labels, +1-shifted (0 is the null label)."""
    mix = run.mix
    return torch.arange(1, mix["labels"] + 1, device=run.device
                        ).repeat_interleave(mix["per_label"])


def chain_noise(run: harness.Run, chain: int) -> torch.Tensor:
    """(T + 1, B, S, S, 3): the initial noise, then step i's at [i + 1]."""
    m = run.config["model"]
    B = run.mix["labels"] * run.mix["per_label"]
    gen = inputs.generator(run.seed, SALT_NOISE * 1000003 + chain, run.device)
    return torch.randn((m["T"] + 1, B, m["img_size"], m["img_size"], 3),
                       generator=gen, device=run.device)


def capture_steps(run: harness.Run, chain: int) -> list[int]:
    """Steps s of a chain whose pair (x_s, x_{s+1}) is kept."""
    T = run.config["model"]["T"]
    rng = np.random.default_rng([run.seed % 2**63, 11, chain])
    picks = rng.choice(T - 1, size=max(run.mix["check_steps"] - 1, 0),
                       replace=False)
    return sorted(int(s) for s in picks) + [T - 1]


def setup(run: harness.Run) -> dict:
    from hybrid_diffusion_tpu_torch.diffusion.schedule import \
        linear_beta_schedule

    m, d = run.config["model"], run.config["diffusion"]
    weights = seeded_weights(run)
    model = program_model(run, weights)
    state = {"model": model, "weights": weights, "labels": labels(run),
             "schedule": linear_beta_schedule(d["beta_1"], d["beta_T"],
                                              m["T"])}
    # Warm-up: the window's own call path for a few steps.
    calls = [0]

    def warm(x, t, lab):
        calls[0] += 1
        if calls[0] > 3:
            raise _Stop
        return model(x, t, lab)

    sample_chain(run, state, warm, chain_noise(run, -1))
    return state


def sample_chain(run: harness.Run, state: dict, denoise, noise: torch.Tensor):
    """One request through the program's chain; None when cut short."""
    from hybrid_diffusion_tpu_torch.cfg.sampler import cfg_ddpm_sample
    from hybrid_diffusion_tpu_torch.utils.precision import precision_for

    m = run.config["model"]
    try:
        with precision_for(run.config["precision"] == "bf16"):
            return cfg_ddpm_sample(denoise, state["schedule"], state["labels"],
                                   image_size=m["img_size"],
                                   w=run.config["diffusion"]["w"],
                                   init_noise=noise[0], step_noise=noise[1:])
    except _Stop:
        return None


def window(run: harness.Run, state: dict) -> harness.Window:
    model, T = state["model"], run.config["model"]["T"]
    B = state["labels"].shape[0]
    cuda = run.device != "cpu"
    events, kept, outputs = [], {}, {}
    chain, step = [0], [0]
    stop_at = [None]

    def denoise(x, t, lab):
        if time.perf_counter() >= stop_at[0]:
            raise _Stop
        s = step[0]
        if s in watch or s - 1 in watch:
            kept[(chain[0], s)] = x[:B].clone()
        out = model(x, t, lab)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            events.append(time.perf_counter())
        step[0] += 1
        return out

    start = None
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    start_ns = time.time_ns()
    t0 = time.perf_counter()
    stop_at[0] = t0 + run.seconds + RESUME_S
    chains = 0
    while time.perf_counter() < t0 + run.seconds:
        chain[0], step[0] = chains, 0
        watch = set(capture_steps(run, chains)) | {0}
        noise = chain_noise(run, chains)
        state.setdefault("noise0", {})[chains] = noise[0].clone()
        out = sample_chain(run, state, denoise, noise)
        if out is not None:
            outputs[chains] = out
        chains += 1
    if cuda:
        torch.cuda.synchronize()
        ends = [start.elapsed_time(ev) / 1e3 for ev in events]
    else:
        ends = [e - t0 for e in events]
    completed = sum(1 for e in ends if e <= run.seconds)
    state.update(kept=kept, outputs=outputs)
    return harness.Window(
        metrics={"cfg_sample_images_per_s":
                 B * completed / T / run.seconds},
        work={"kind": "sample", "model_calls": completed, "batch": 2 * B},
        start_ns=start_ns, end_ns=start_ns + int(run.seconds * 1e9),
        attempted=chains)


def reference_step(run: harness.Run, model, sched: dict, x: torch.Tensor,
                   step: int, labels: torch.Tensor,
                   z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_{s+1}, coeff2·ε) of the reference's guided step s from x."""
    T, w = run.config["model"]["T"], run.config["diffusion"]["w"]
    t = T - 1 - step
    tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
    with torch.no_grad(), layers.fp32_products():
        eps_c = model(x, tt, labels)
        eps_u = model(x, tt, torch.zeros_like(labels))
    eps = (1.0 + w) * eps_c - w * eps_u
    term = float(np.float32(sched["coeff2"][t])) * eps
    nxt = float(np.float32(sched["coeff1"][t])) * x - term
    if t > 0:
        nxt = nxt + float(np.float32(np.sqrt(np.float32(
            sched["sampling_var"][t])))) * z
    else:
        nxt = nxt.clamp(-1.0, 1.0)
    return nxt, term


def _pairs(run: harness.Run, state: dict) -> list[tuple]:
    """(chain, step, x_s, program's x_{s+1}) of every kept pair."""
    T = run.config["model"]["T"]
    out = []
    for (c, s), x in sorted(state["kept"].items()):
        if s == T - 1:
            if c in state["outputs"]:
                out.append((c, s, x, state["outputs"][c]))
        elif (c, s + 1) in state["kept"] and s in capture_steps(run, c):
            out.append((c, s, x, state["kept"][(c, s + 1)]))
    return out


def step_gaps(run: harness.Run, state: dict, model, other=None) -> dict:
    """Over the kept pairs, the steps computed by `other` (default: the
    program's x_{s+1}) against the reference `model`'s: `step_eps_rel` is
    √(Σ‖Δx_{s+1}‖² / Σ‖coeff2·ε^ref‖²) over every sampled step and image,
    the model term's error relative to that term; `step_eps_max_rel` the
    largest single step's, `step_eps_img_rel` the worst single image's
    (both read, not compared: they swing from seed to seed)."""
    d = run.config["diffusion"]
    sched = sampling.linear_schedule(d["beta_1"], d["beta_T"],
                                     run.config["model"]["T"])
    err = size = step = image = 0.0
    for c, s, x, nxt in _pairs(run, state):
        z = chain_noise(run, c)[s + 1]
        ref, term = reference_step(run, model, sched, x, s, state["labels"], z)
        if other is not None:
            nxt, _ = reference_step(run, other, sched, x, s, state["labels"], z)
        diff = nxt - ref
        err += float(diff.norm()) ** 2
        size += float(term.norm()) ** 2
        step = max(step, float(diff.norm() / term.norm()))
        image = max(image, float((diff.flatten(1).norm(dim=1)
                                  / term.flatten(1).norm(dim=1)).max()))
    return {"step_eps_rel": (err / size) ** 0.5, "step_eps_max_rel": step,
            "step_eps_img_rel": image}


def check(run: harness.Run, state: dict) -> list[harness.Check]:
    state.pop("model")
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()
    limits = harness.limits(run)
    start = max(float((state["kept"][(c, 0)] - n0).abs().max())
                for c, n0 in state["noise0"].items() if (c, 0) in state["kept"])
    model = reference_model(run, state["weights"])
    state["readings"] = {**step_gaps(run, state, model), "start_gap": start}
    return [harness.Check(k, state["readings"][k], v)
            for k, v in limits.items()]


def control(run: harness.Run, state: dict) -> dict:
    """The reference with fp8 products in the program's place: its steps
    from the same states, measured against the fp32 reference's."""
    low = reference_model(run, state["weights"], layers.FP8)
    ref = reference_model(run, state["weights"])
    return step_gaps(run, state, ref, low)
