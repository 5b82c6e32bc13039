"""The port's training step against the JAX package's `diffusion_train_step`,
in fp32 on the CPU: the same weights (numpy-seeded, carried across), the
same batch and the same t and noise (the JAX step draws them from its key;
the test hands the same draws to the port's step). Dropout 0, the default
loss config with the DINO term (a random-init ViT-S, its weights carried
across), domain routing on, EMA on. One step from the same state on an
underwater batch and on an atmospheric one, so both gate patterns run.

Measures, for each parameter, rel = ‖port − jax‖ / ‖jax‖, and κ, the change
of JAX's own result when every weight moves by one ulp (×(1 ± 2⁻²³)), which
is what fp32 rounding alone can do to it. The middle blocks' attention
replaces h, and a near-uniform softmax leaves it almost constant over the
tokens, so the next GroupNorm divides by a small spread: on some random
weights one ulp moves gradients by more than the bound (seed 11's
underwater step: κ up to 2.8e-3, the port within 2 κ of JAX everywhere),
and there a comparison measures rounding, not the port. The weights are
seed 12's, where κ ≤ 1.7e-4, and the test requires κ ≤ KAPPA_MAX (a
quarter of the gradient bound) of every leaf it compares. Bounds:
  - the loss and its terms, |port − jax| ≤ 1e-5 × max(|jax|, 1) (the
    colour and MS-SSIM terms are 1 − x, where one ulp of 1 is 1.2e-7);
  - every gradient (AdamW's first moment after one update is 0.1 × the
    gated, clipped gradient): rel ≤ 1e-3; measured here ≤ 2.8e-4.
    A few biases feed a GroupNorm of one channel a group, which removes
    them: their gradient is zero but for rounding (≤ 1e-6 of the largest),
    and both sides must stay below 1e-5 of the largest;
  - AdamW's second moment (0.001 × the gradient squared): rel ≤ 2e-3;
    measured ≤ 5.8e-4;
  - the gated-off middle blocks: parameters and moments exactly as before.
The update itself (parameters, moments and EMA over three updates, gates
open and closed) is held against optax on identical gradients in
test_torch_optim.py: after one update AdamW moves each parameter by about
±lr whatever the size of its gradient, so the sign of a near-zero gradient,
which rounding decides, would dominate a comparison here.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    TINY, batch, jax_leaves, one_torch_thread, tiny_pair)
from hybrid_diffusion_tpu.diffusion import linear_beta_schedule as jax_schedule
from hybrid_diffusion_tpu.losses import CompositeLossConfig as JaxLossConfig
from hybrid_diffusion_tpu.losses import DinoPerceptualLoss as JaxDino
from hybrid_diffusion_tpu.train.step import make_train_step as jax_make_step
from hybrid_diffusion_tpu.train.train_state import (
    create_train_state as jax_create_state,
)
from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
from hybrid_diffusion_tpu_torch.losses import (
    CompositeLossConfig,
    DinoPerceptualLoss,
)
from hybrid_diffusion_tpu_torch.train.step import make_train_step, middle_block
from hybrid_diffusion_tpu_torch.train.train_state import TrainState

HYPER = dict(lr=1e-3, weight_decay=1e-2, grad_clip=1.0, total_epochs=4,
             steps_per_epoch=1, multiplier=2.0, ema_decay=0.9)
ZERO_GRAD = 1e-6          # of the largest gradient: a removed bias
KAPPA_MAX = 2.5e-4        # JAX's own one-ulp change, of every leaf compared


def one_ulp(params, seed=1):
    """Every weight times (1 ± 2⁻²³), the signs drawn with numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + 2.0**-23 * rng.choice(
            [-1.0, 1.0], np.shape(a)))).astype(np.float32), params)


def norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_draws(rng, B, size, T):
    """The t and noise that JAX's step draws from `rng`."""
    t_rng, noise_rng, _, _ = jax.random.split(rng, 4)
    t = jax.random.randint(t_rng, (B,), 0, T)
    noise = jax.random.normal(noise_rng, (B, size, size, 3), np.float32)
    return np.array(t), np.array(noise)


@pytest.fixture(scope="module")
def steps():
    """{blue: record} of one step of each from the same start."""
    jm, params, _ = tiny_pair(seed=12)
    jdino = JaxDino(jax.random.PRNGKey(3), image_size=32)
    tdino = DinoPerceptualLoss(device="cpu")
    tdino.model.load_state_dict(jax_leaves(jdino.params["params"]),
                                strict=True)
    jstep = jax_make_step(jax_schedule(1e-4, 0.02, TINY["T"]),
                          JaxLossConfig(), dino_loss_fn=jdino, donate=False)
    tstep = make_train_step(linear_beta_schedule(1e-4, 0.02, TINY["T"]),
                            CompositeLossConfig(), dino_loss_fn=tdino)
    # One JAX state's static fields for every run, so that jit traces once.
    start = jax_create_state(params, jm.apply, **HYPER)
    nudged_start = start.replace(params=one_ulp(params),
                                 ema_params=one_ulp(params))
    records = {}
    for i, blue in enumerate((True, False)):
        _, _, tm = tiny_pair(seed=12)
        tstate = TrainState(tm, **HYPER)
        b = batch(20 + i, blue=blue)
        rng = jax.random.PRNGKey(100 + i)
        t, noise = jax_draws(rng, 2, 32, TINY["T"])
        before = {n: p.detach().clone() for n, p in tstate.params.items()}
        jstate, jmetrics = jstep(start, b, rng)
        nudged, _ = jstep(nudged_start, b, rng)
        tstate, tmetrics = tstep(
            tstate, {k: torch.from_numpy(v) for k, v in b.items()},
            torch.Generator().manual_seed(0), t=torch.from_numpy(t),
            noise=torch.from_numpy(noise))
        adam = jstate.opt_state[1][0]
        records[blue] = dict(
            jax=dict(metrics={k: float(v) for k, v in jmetrics.items()},
                     params=jax_leaves(jstate.params["params"]),
                     mu=jax_leaves(adam.mu["params"]),
                     nu=jax_leaves(adam.nu["params"]),
                     ema=jax_leaves(jstate.ema_params["params"]),
                     mu_nudged=jax_leaves(nudged.opt_state[1][0].mu["params"])),
            port=dict(metrics={k: float(v) for k, v in tmetrics.items()},
                      params={n: p.detach().clone()
                              for n, p in tstate.params.items()},
                      mu={n: tstate.moments(n)["exp_avg"].clone()
                          for n in tstate.params},
                      nu={n: tstate.moments(n)["exp_avg_sq"].clone()
                          for n in tstate.params},
                      ema=dict(tstate.ema_params)),
            before=before)
    return records


def removed(record):
    """Names whose JAX gradient is zero but for rounding (not exactly zero:
    those are compared exactly), and the largest gradient."""
    mu = record["jax"]["mu"]
    top = max(float(v.abs().max()) for v in mu.values())
    return {n for n, v in mu.items()
            if 0 < float(v.abs().max()) <= ZERO_GRAD * top}, top


@pytest.mark.parametrize("blue", [True, False], ids=["underwater", "atmos"])
def test_step_loss_and_grad_norm_match_jax(steps, blue):
    r = steps[blue]
    jm_, tm_ = r["jax"]["metrics"], r["port"]["metrics"]
    assert set(jm_) == set(tm_)
    for k in ("total", "mse", "dino", "ms_ssim", "color"):
        assert abs(tm_[k] - jm_[k]) <= 1e-5 * max(abs(jm_[k]), 1.0), k
    assert tm_["underwater_gate"] == jm_["underwater_gate"] == float(blue)
    assert abs(tm_["grad_norm"] - jm_["grad_norm"]) <= 1e-4 * jm_["grad_norm"]
    assert jm_["grad_norm"] > 1.0     # the clip is active


@pytest.mark.parametrize("blue", [True, False], ids=["underwater", "atmos"])
@pytest.mark.parametrize("what", ["mu", "nu"])
def test_step_grads_match_jax(steps, blue, what):
    """Every gated, clipped gradient, through AdamW's moments."""
    r = steps[blue]
    zero, top = removed(r)
    assert len(zero) <= 12
    rtol = 1e-3 if what == "mu" else 2e-3
    compared = 0
    for name, ref in r["jax"][what].items():
        got = r["port"][what][name]
        if not ref.any():                       # gated off, or no gradient
            assert not got.any(), name
        elif name in zero:
            if what == "mu":
                assert float(got.abs().max()) <= 1e-5 * top, name
        else:
            kappa = norm_rel(r["jax"]["mu_nudged"][name], r["jax"]["mu"][name])
            assert kappa <= KAPPA_MAX, (name, kappa)
            err = norm_rel(got, ref)
            assert err <= rtol, (name, err, kappa)
            compared += 1
    assert compared > 60


@pytest.mark.parametrize("blue", [True, False], ids=["underwater", "atmos"])
def test_gated_blocks_are_bit_frozen(steps, blue):
    """The gated-off middle blocks keep their parameters and AdamW moments
    (zero before the first update) bit for bit; the open ones move."""
    r = steps[blue]
    closed = (1, 3) if blue else (0, 2)
    moved = set()
    for name, new in r["port"]["params"].items():
        m = middle_block(name)
        if m is None:
            continue
        if m in closed:
            assert torch.equal(new, r["before"][name]), name
            assert not r["port"]["mu"][name].any(), name
            assert not r["port"]["nu"][name].any(), name
        elif not torch.equal(new, r["before"][name]):
            moved.add(m)
    assert moved == {0, 1, 2, 3} - set(closed)
