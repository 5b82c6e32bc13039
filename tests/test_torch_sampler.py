"""The port's samplers against the JAX package: the whole slice at a small
size, in fp32 on the CPU.

The model is DynamicUNet at ch 32, mult (1, 2), 1 res block, T 100, 16²,
with the same numpy-seeded weights in both packages. DPM-Solver++(2M) and
DDIM with η = 0 are deterministic given the initial noise, so both packages
get the same numpy noise and are compared element-wise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from hybrid_diffusion_tpu.config import Config as JaxConfig
from hybrid_diffusion_tpu.diffusion import (
    ddim_coefficients as jax_ddim_coefficients,
    ddim_sample as jax_ddim_sample,
    dpm_solver_coefficients as jax_dpm_coefficients,
    dpm_solver_pp_2m_sample as jax_dpm_sample,
    linear_beta_schedule as jax_schedule,
)
from hybrid_diffusion_tpu.train.loop import (
    build_model as jax_build_model,
    make_sampler as jax_make_sampler,
)
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.diffusion import (
    ddim_coefficients,
    ddim_sample,
    dpm_solver_coefficients,
    dpm_solver_pp_2m_sample,
    linear_beta_schedule,
)
from hybrid_diffusion_tpu_torch.train.loop import build_model, make_sampler
from hybrid_diffusion_tpu_torch.utils.params_io import flatten_params
from hybrid_diffusion_tpu_torch.weights import state_dict_from_flat

SMALL = dict(T=100, channel=32, channel_mult=(1, 2), num_res_blocks=1,
             img_size=16, bf16=False)


def random_params(template, seed):
    """Numpy-seeded weights at unit-gain scale (see test_torch_unet.py)."""
    rng = np.random.default_rng(seed)

    def leaf(path, t):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(t.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if len(t.shape) == 4 or (name == "kernel" and len(t.shape) == 2):
            return n / np.sqrt(np.prod(t.shape[:-1]))
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(leaf, template)


@pytest.fixture(scope="module")
def pair():
    jcfg = JaxConfig(**SMALL, dropout=0.0)
    jm = jax_build_model(jcfg)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 6)),
                              jnp.zeros((1,), jnp.int32))
    params = random_params(template, seed=11)
    tm = build_model(Config(**SMALL))
    tm.load_state_dict(state_dict_from_flat(flatten_params(params["params"])),
                       strict=True)
    return jcfg, jm, params, tm.eval()


def inputs(seed):
    rng = np.random.default_rng(seed)
    cond = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    return cond, noise


def jax_denoiser(jm, params):
    def denoise(x6, t, context_zero=True):
        return jm.apply(params, x6, t, context_zero=context_zero)
    return denoise


def torch_denoiser(tm):
    def denoise(x6, t, context_zero=True):
        return tm(x6, t, context_zero=context_zero)
    return denoise


def test_schedule_and_step_coefficients_equal_jax():
    """Tables and per-step scalars: the same float64 numpy math cast to
    float32 once, so equal exactly."""
    js, ts = jax_schedule(1e-4, 0.02, 1000), linear_beta_schedule(1e-4, 0.02, 1000)
    for name in ("betas", "alphas_bar", "sqrt_alphas_bar",
                 "sqrt_one_minus_alphas_bar", "coeff1", "coeff2",
                 "posterior_var", "sampling_var"):
        np.testing.assert_array_equal(getattr(ts, name),
                                      np.asarray(getattr(js, name)))
    for steps in (5, 10, 100):
        for ours, ref in ((ddim_coefficients(ts, steps, 0.5),
                           jax_ddim_coefficients(js, steps, 0.5)),
                          (dpm_solver_coefficients(ts, steps),
                           jax_dpm_coefficients(js, steps))):
            assert ours.keys() == ref.keys()
            for key in ours:
                np.testing.assert_array_equal(ours[key], np.asarray(ref[key]))


@pytest.mark.parametrize("guidance", [1.0, 2.0], ids=["w1", "cfg_w2"])
def test_dpm_solver_pp_2m_5_matches_jax(pair, guidance):
    """DPM++2M-5 on shared init noise (atol 1e-4 on [-1, 1] images: five
    chained fp32 U-Net calls; measured ≤ 6e-6). Guidance 2 runs the batched
    2B classifier-free-guidance call."""
    _, jm, params, tm = pair
    cond, noise = inputs(12)
    ref = np.asarray(jax_dpm_sample(
        jax_denoiser(jm, params), jax_schedule(1e-4, 0.02, 100),
        jnp.asarray(cond), jax.random.PRNGKey(0), steps=5,
        guidance_scale=guidance, init_noise=jnp.asarray(noise)))
    ours = dpm_solver_pp_2m_sample(
        torch_denoiser(tm), linear_beta_schedule(1e-4, 0.02, 100),
        torch.from_numpy(cond), steps=5, guidance_scale=guidance,
        init_noise=torch.from_numpy(noise)).numpy()
    assert ours.shape == ref.shape == (2, 16, 16, 3)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_ddim_10_matches_jax(pair):
    """DDIM-10, η = 0, on shared init noise (atol 1e-4, as above)."""
    _, jm, params, tm = pair
    cond, noise = inputs(13)
    ref = np.asarray(jax_ddim_sample(
        jax_denoiser(jm, params), jax_schedule(1e-4, 0.02, 100),
        jnp.asarray(cond), jax.random.PRNGKey(0), ddim_steps=10,
        init_noise=jnp.asarray(noise)))
    ours = ddim_sample(
        torch_denoiser(tm), linear_beta_schedule(1e-4, 0.02, 100),
        torch.from_numpy(cond), ddim_steps=10,
        init_noise=torch.from_numpy(noise)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_make_sampler_uint8_matches_jax_elementwise(pair):
    """make_sampler(quantize_uint8=True), DPM++2M-5, uint8 in and out.

    JAX's make_sampler draws its own initial noise from its key and takes no
    init_noise, so this test draws that noise the way the JAX sampler does
    and hands it to the port. The uint8 outputs must agree element-wise:
    equal, except where the fp32 value sits within rounding of an integer
    step, which may move one pixel value by 1 (at most 0.1% of them).
    """
    jcfg, jm, params, tm = pair
    jcfg = dataclasses.replace(jcfg, sampler="dpm++2m", ddim_step=5)
    rng = np.random.default_rng(14)
    cond_u8 = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    _, noise_key = jax.random.split(key)
    noise = np.array(jax.random.normal(noise_key, cond_u8.shape, jnp.float32))
    ref = np.asarray(jax_make_sampler(jcfg, jm, params, quantize_uint8=True)(
        jnp.asarray(cond_u8), key))
    cfg = Config(**SMALL, sampler="dpm++2m", ddim_step=5)
    ours = make_sampler(cfg, tm, quantize_uint8=True)(
        torch.from_numpy(cond_u8), init_noise=torch.from_numpy(noise)).numpy()
    assert ours.dtype == ref.dtype == np.uint8
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert len(np.unique(ours)) > 1
