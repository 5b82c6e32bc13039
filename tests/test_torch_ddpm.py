"""Full-T ancestral DDPM: the port against the JAX package in fp32 on the
CPU.

The JAX sampler draws its initial and per-step noise from keys split off
the caller's key; a `torch.Generator` cannot give those numbers. So the test
draws them with JAX exactly as `ddpm_sample` does (split, then one key a
step) and hands the sequence to the port's `ddpm_sample` (`init_noise`,
`step_noise`): the two chains then see the same noise, and the whole chain
is compared element-wise. The model is DynamicUNet at ch 32, mult (1, 2),
1 res block, T 10, 16², on the same numpy-seeded weights.

Bounds: the posterior mean and the variance table are the same float32
products, rel ≤ 1e-6; one step on injected noise, rel ≤ 1e-6; a 10-step
chain through the U-Net, rel ≤ 1e-5 (measured 8.3e-7 at guidance 1 and
1.6e-6 at guidance 2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, random_params, rel_err  # noqa: F401
from hybrid_diffusion_tpu.diffusion import ddpm_sample as jax_ddpm_sample
from hybrid_diffusion_tpu.diffusion import linear_beta_schedule as jax_schedule
from hybrid_diffusion_tpu.diffusion.process import (
    ddpm_posterior_mean as jax_posterior_mean,
    ddpm_sampling_variance as jax_sampling_variance,
)
from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.diffusion import (
    ddpm_posterior_mean,
    ddpm_sample,
    ddpm_sampling_variance,
    ddpm_step,
    linear_beta_schedule,
)
from hybrid_diffusion_tpu_torch.models import DynamicUNet
from hybrid_diffusion_tpu_torch.train.loop import make_sampler
from hybrid_diffusion_tpu_torch.utils.params_io import flatten_params
from hybrid_diffusion_tpu_torch.weights import state_dict_from_flat

SMALL = dict(T=10, ch=32, ch_mult=(1, 2), num_res_blocks=1)
SIZE = 16


def jax_chain_noise(key, shape, T):
    """(initial noise, [noise of step i]) as JAX's ddpm_sample and
    cfg_ddpm_sample draw them from `key`."""
    key, noise_key = jax.random.split(key)
    init = jax.random.normal(noise_key, shape, jnp.float32)
    steps = [np.array(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(key, T)]
    return np.array(init), steps


@pytest.fixture(scope="module")
def pair():
    jm = JaxUNet(**SMALL, dropout=0.0)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, SIZE, SIZE, 6)),
                              jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map(jnp.asarray, random_params(template, 5))
    tm = DynamicUNet(**SMALL)
    tm.load_state_dict(state_dict_from_flat(flatten_params(
        jax.tree_util.tree_map(np.asarray, params["params"]))), strict=True)
    return jm, params, tm.eval()


def test_posterior_mean_and_variance_match_jax():
    js, ts = jax_schedule(1e-4, 0.02, 50), linear_beta_schedule(1e-4, 0.02, 50)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    eps = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    t = np.array([0, 1, 25, 49])
    jm = np.asarray(jax_posterior_mean(js, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(eps)))
    tm = ddpm_posterior_mean(ts, torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(eps)).numpy()
    assert rel_err(tm, jm) <= 1e-6
    jv = np.asarray(jax_sampling_variance(js, jnp.asarray(t), 4))
    tv = ddpm_sampling_variance(ts, torch.from_numpy(t), 4).numpy()
    assert tv.shape == jv.shape == (4, 1, 1, 1)
    assert rel_err(tv, jv) <= 1e-6
    # The table is cat([posterior_var[1:2], betas[1:]]).
    np.testing.assert_array_equal(
        ts.sampling_var, np.concatenate([ts.posterior_var[1:2], ts.betas[1:]]))


@pytest.mark.parametrize("t", [0, 1, 37])
def test_one_ancestral_step_on_injected_noise(t):
    """ddpm_step against JAX's mean + sqrt(var)·z on the same z; t = 0
    adds no noise (z is not read)."""
    js, ts = jax_schedule(1e-4, 0.02, 50), linear_beta_schedule(1e-4, 0.02, 50)
    rng = np.random.default_rng(t)
    x, eps, z = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
                 for _ in range(3))
    tt = jnp.full((2,), t, jnp.int32)
    want = (jax_posterior_mean(js, jnp.asarray(x), tt, jnp.asarray(eps))
            + jnp.sqrt(jax_sampling_variance(js, tt, 4))
            * jnp.where(t > 0, jnp.asarray(z), 0.0))
    got = ddpm_step(ts, torch.from_numpy(x), t, torch.from_numpy(eps),
                    torch.from_numpy(z) if t else None)
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-6


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_ddpm_chain_matches_jax_on_supplied_noise(pair, guidance):
    """The whole T-step chain (guidance 1: one call a step; 2: one 2B call
    with a per-example context mask) against JAX's ddpm_sample itself."""
    jm, params, tm = pair
    T = SMALL["T"]
    rng = np.random.default_rng(1)
    cond = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    init, steps = jax_chain_noise(key, cond.shape, T)

    def jax_denoise(x6, t, context_zero=True):
        return jm.apply(params, x6, t, context_zero=context_zero)

    want = jax_ddpm_sample(jax_denoise, jax_schedule(1e-4, 0.02, T),
                           jnp.asarray(cond), key, guidance_scale=guidance)
    got = ddpm_sample(
        lambda x6, t, context_zero=True: tm(x6, t, context_zero=context_zero),
        linear_beta_schedule(1e-4, 0.02, T), torch.from_numpy(cond),
        guidance_scale=guidance, init_noise=torch.from_numpy(init),
        step_noise=[torch.from_numpy(z) for z in steps])
    assert got.shape == (2, SIZE, SIZE, 3)
    assert float(got.abs().max()) <= 1.0
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-5


def test_make_sampler_ddpm_branch(pair):
    """`--ddim False` with no DPM sampler runs ddpm_sample from the
    caller's generator: the same draws give the same uint8 bytes, and the
    last step adds no noise."""
    _, _, tm = pair
    config = dataclasses.replace(
        Config(T=SMALL["T"], channel=32, channel_mult=(1, 2),
               num_res_blocks=1, img_size=SIZE, bf16=False),
        ddim=False, sampler="")
    sample = make_sampler(config, tm, quantize_uint8=True)
    cond = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
    out = sample(cond, torch.Generator().manual_seed(3))
    assert out.dtype == torch.uint8 and out.shape == (2, SIZE, SIZE, 3)
    gen = torch.Generator().manual_seed(3)
    direct = ddpm_sample(
        lambda x6, t, context_zero=True: tm(x6, t, context_zero=context_zero),
        linear_beta_schedule(config.beta_1, config.beta_T, config.T),
        cond.float() / 255.0 * 2.0 - 1.0, gen)
    assert torch.equal(out, ((direct + 1) / 2 * 255).clamp(0, 255).to(
        torch.uint8))
    # One initial draw and T − 1 step draws: the generator moved that far.
    probe = torch.Generator().manual_seed(3)
    for _ in range(SMALL["T"]):
        torch.randn((2, SIZE, SIZE, 3), generator=probe)
    assert torch.equal(torch.randn(3, generator=gen),
                       torch.randn(3, generator=probe))
