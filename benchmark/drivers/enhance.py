"""Driver of serving traffic: one client enhancing a folder through
`serve.Enhancer.enhance`, closed loop (each request waits for its reply).

Mix parameters: `images_per_request`, `max_batch`, the image sides drawn
uniformly from [`side_min`, `side_max`], `pool_requests` distinct requests
whose sizes come from `size_seed` (the same for every run seed) and whose
pixels and order come from the run's seed, and `check_requests`, the
number of finished requests the check draws from the seed (the largest
finished request is always among them).

End-to-end: `enhance_images_per_s`, images returned in the window over
the window, and `enhance_p90_ms`, the 90th percentile of every request's
latency from the call to `enhance` to its return. The window starts with
the first request and ends with the return of the last one, which began
before `seconds` had passed.

Check: for each sampled request the reference redoes the whole request
from its input images: the bilinear resize in, the uint8 scaling, the
device call's initial noise (drawn, as the Enhancer draws it, from a
generator seeded with the run's seed, one draw per device call in order),
DPM-Solver++(2M) over the fp32 U-Net loaded from the same npz, the uint8
quantization and the resize back. `img_mad_levels` is the worst sampled
image's mean absolute difference from the program's output, in uint8
levels.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.reference import image, layers, sampling, unet, weights

SALT_PIXELS = 1


def program_config(run: harness.Run):
    from hybrid_diffusion_tpu_torch.config import Config

    m, d = run.config["model"], run.config["diffusion"]
    return Config(T=m["T"], channel=m["channel"],
                  channel_mult=tuple(m["channel_mult"]),
                  num_res_blocks=m["num_res_blocks"], dropout=m["dropout"],
                  img_size=m["img_size"], beta_1=d["beta_1"],
                  beta_T=d["beta_T"], sampler=d["sampler"],
                  ddim_step=d["steps"],
                  unconditional_guidance_scale=d["guidance"],
                  bf16=run.config["precision"] == "bf16", seed=run.seed,
                  device=run.device)


def request_pool(run: harness.Run) -> list[list[np.ndarray]]:
    """`pool_requests` requests of `images_per_request` uint8 HWC images:
    sizes from the mix's size_seed, pixels from the run's seed."""
    mix = run.mix
    sizes = np.random.default_rng(mix["size_seed"]).integers(
        mix["side_min"], mix["side_max"] + 1,
        (mix["pool_requests"], mix["images_per_request"], 2))
    gen = inputs.generator(run.seed, SALT_PIXELS, run.device)
    return [[inputs.smooth_images(gen, 1, int(h), int(w), run.device)[0]
             .cpu().numpy() for h, w in req] for req in sizes]


def setup(run: harness.Run) -> dict:
    from hybrid_diffusion_tpu_torch.serve import Enhancer

    weights_path = run.root / run.config["serving_weights"]
    enh = Enhancer(program_config(run), weights_path,
                   max_batch=run.mix["max_batch"], device=run.device)
    pool = request_pool(run)
    order = np.random.default_rng(run.seed).permutation(len(pool))
    for i in range(min(2, len(pool))):     # the host resizes, both ways
        enh.enhance(pool[order[i]])
    return {"enhancer": enh, "pool": pool, "order": order,
            "weights": weights_path}


def window(run: harness.Run, state: dict) -> harness.Window:
    enh, pool, order = state["enhancer"], state["pool"], state["order"]
    steps = run.config["diffusion"]["steps"]
    done, latencies = [], []
    calls0 = enh.device_calls
    start_ns = time.time_ns()
    t0 = time.perf_counter()
    while True:
        req = int(order[len(done) % len(order)])
        call = enh.device_calls
        ts = time.perf_counter()
        out = enh.enhance(pool[req])
        te = time.perf_counter()
        latencies.append(te - ts)
        done.append((req, call, out))
        if te - t0 >= run.seconds:
            break
    end_ns = time.time_ns()
    images = sum(len(out) for _, _, out in done)
    state["done"] = done
    calls = enh.device_calls - calls0
    return harness.Window(
        metrics={"enhance_images_per_s": images / (te - t0),
                 "enhance_p90_ms": harness.percentile(latencies, 90) * 1e3},
        work={"kind": "sample", "model_calls": calls * steps,
              "batch": run.mix["max_batch"]},
        start_ns=start_ns, end_ns=end_ns, attempted=len(done))


def sample_requests(run: harness.Run, done: list) -> list[int]:
    """Indices of finished requests to check: `check_requests` drawn from
    the seed, the one with the most pixels among them."""
    pixels = [sum(im.size for im in out) for _, _, out in done]
    largest = int(np.argmax(pixels))
    rng = np.random.default_rng([run.seed % 2**63, 7])
    others = [int(i) for i in rng.permutation(len(done))
              if i != largest][: max(run.mix["check_requests"] - 1, 0)]
    return [largest] + others


def initial_noise(run: harness.Run, call: int) -> torch.Tensor:
    """The initial noise of the Enhancer's device call number `call`."""
    size = run.config["model"]["img_size"]
    shape = (run.mix["max_batch"], size, size, 3)
    gen = torch.Generator(run.device).manual_seed(run.seed)
    for _ in range(call):
        torch.randn(shape, generator=gen, device=run.device)
    return torch.randn(shape, generator=gen, device=run.device)


def reference_request(run: harness.Run, model, sched: dict,
                      images: list[np.ndarray], call: int,
                      op=layers.FP32) -> list[np.ndarray]:
    """The reference's reply to one request (model built with `op`)."""
    size = run.config["model"]["img_size"]
    n = len(images)
    cond = image.to_unit(torch.from_numpy(np.stack(
        [image.bilinear_resize(im, size, size) for im in images])).to(
            run.device))
    noise = initial_noise(run, call)[:n]

    def eps(x, t):
        tt = torch.full((n,), t, dtype=torch.long, device=run.device)
        return model(torch.cat([cond, x], -1), tt, True)

    with torch.no_grad(), layers.fp32_products():
        x = sampling.dpm_solver_pp_2m(eps, sched, noise,
                                      run.config["diffusion"]["steps"])
    out = image.quantize(x).cpu().numpy()
    return [image.bilinear_resize(o, im.shape[0], im.shape[1])
            for o, im in zip(out, images)]


def reference_model(run: harness.Run, npz_path, op=layers.FP32):
    model = unet.build(run.config["model"], op, run.device)
    model.load_state_dict(weights.state_dict_from_npz(npz_path, run.device),
                          strict=True)
    return model.eval()


def mad_levels(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())


def check(run: harness.Run, state: dict) -> list[harness.Check]:
    done, pool = state["done"], state["pool"]
    picked = sample_requests(run, done)
    state.pop("enhancer")
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()
    model = reference_model(run, state["weights"])
    d = run.config["diffusion"]
    sched = sampling.linear_schedule(d["beta_1"], d["beta_T"],
                                     run.config["model"]["T"])
    worst, state["reference"] = 0.0, {}
    for i in picked:
        req, call, out = done[i]
        ref = reference_request(run, model, sched, pool[req], call)
        state["reference"][i] = ref
        worst = max([worst] + [mad_levels(a, b) for a, b in zip(out, ref)])
    state["readings"] = {"img_mad_levels": worst}
    limits = harness.limits(run)
    return [harness.Check("img_mad_levels", worst, limits["img_mad_levels"])]


def control(run: harness.Run, state: dict) -> dict:
    """The control's readings: the reference with fp8 products put in the
    program's place, on the requests that `check` compared, measured as
    the program's outputs are."""
    model = reference_model(run, state["weights"], layers.FP8)
    d = run.config["diffusion"]
    sched = sampling.linear_schedule(d["beta_1"], d["beta_T"],
                                     run.config["model"]["T"])
    worst = 0.0
    for i, ref in state["reference"].items():
        req, call, _ = state["done"][i]
        low = reference_request(run, model, sched, state["pool"][req], call)
        worst = max([worst] + [mad_levels(a, b) for a, b in zip(low, ref)])
    return {"img_mad_levels": worst}
