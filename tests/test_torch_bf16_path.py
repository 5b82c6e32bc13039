"""The port's bf16 main path against the fp32 reference, on the CPU.

The flagship weights (docs/assets/flagship256_r5_fp16.npz) at 32², batch 2,
through DPM++2M-5 with guidance 1.0, on one numpy-seeded condition image and
initial noise: the port in bf16 and in fp32, the JAX package in fp32 (the
reference) and in bf16. bf16 rounds at other places in the two frameworks,
so the port's bf16 output is not held to JAX's bf16 output but to the
reference, within 3 dB of JAX's own bf16 output's distance from it.

Measured (PSNR on [0, 1] images against JAX fp32): port bf16 44.09 dB, JAX
bf16 43.62 dB (at 64² the same comparison gave 42.99 and 42.34 dB), so the
bound (40.62 dB) leaves the port 3.47 dB; port fp32 116.80 dB (max |diff|
7.6e-6). The port's bf16 output must also stay below 80 dB: a bf16 path
that silently ran in fp32 would score about 117 dB and pass the first bound.
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from hybrid_diffusion_tpu.config import Config as JaxConfig
from hybrid_diffusion_tpu.diffusion import (
    dpm_solver_pp_2m_sample as jax_dpm_sample,
    linear_beta_schedule as jax_schedule,
)
from hybrid_diffusion_tpu.train.loop import build_model as jax_build_model
from hybrid_diffusion_tpu.train.step import normalize_uint8 as jax_normalize
from hybrid_diffusion_tpu.utils.params_io import load_params_npz
from hybrid_diffusion_tpu_torch.config import flagship_config
from hybrid_diffusion_tpu_torch.train.loop import build_model, make_sampler
from hybrid_diffusion_tpu_torch.weights import load_npz_state_dict

NPZ = (Path(__file__).resolve().parent.parent / "docs" / "assets"
       / "flagship256_r5_fp16.npz")
SIZE, BATCH = 32, 2


def psnr(a, b):
    mse = float(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
                .mean())
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    cond = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    noise = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return cond, noise


def jax_sample(inputs, bf16):
    """JAX's DPM++2M-5 in [0, 1], as its make_sampler runs it, on `noise`."""
    cond_u8, noise = inputs
    cfg = flagship_config(img_size=SIZE)
    jcfg = dataclasses.replace(
        JaxConfig(), T=cfg.T, channel=cfg.channel,
        channel_mult=tuple(cfg.channel_mult),
        num_res_blocks=cfg.num_res_blocks, img_size=SIZE, bf16=bf16,
        dropout=0.0)
    model = jax_build_model(jcfg)
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, SIZE, SIZE, 6)),
                              jnp.zeros((1,), jnp.int32))
    params = load_params_npz(str(NPZ), template)

    def denoise(x6, t, context_zero=True):  # use_conditioning is off
        return model.apply(params, x6, t, context_zero=context_zero)

    out = jax_dpm_sample(denoise, jax_schedule(cfg.beta_1, cfg.beta_T, cfg.T),
                         jax_normalize(jnp.asarray(cond_u8)),
                         jax.random.PRNGKey(0), steps=cfg.ddim_step,
                         init_noise=jnp.asarray(noise))
    return (np.asarray(out, np.float64) + 1.0) / 2.0


def port_sample(inputs, bf16):
    cond_u8, noise = inputs
    cfg = flagship_config(img_size=SIZE, bf16=bf16)
    model = build_model(cfg)
    model.load_state_dict(load_npz_state_dict(NPZ), strict=True)
    out = make_sampler(cfg, model.eval())(torch.from_numpy(cond_u8),
                                          init_noise=torch.from_numpy(noise))
    return out.float().numpy().astype(np.float64)


@pytest.fixture(scope="module")
def reference(inputs):
    return jax_sample(inputs, bf16=False)


def test_port_bf16_is_as_close_to_the_fp32_reference_as_jax_bf16(
        inputs, reference):
    ours = port_sample(inputs, bf16=True)
    theirs = jax_sample(inputs, bf16=True)
    assert ours.shape == reference.shape == (BATCH, SIZE, SIZE, 3)
    assert np.isfinite(ours).all() and ours.std() > 0.05
    ours_db, theirs_db = psnr(ours, reference), psnr(theirs, reference)
    assert ours_db >= theirs_db - 3.0, (ours_db, theirs_db)
    assert ours_db < 80.0, ours_db  # bf16 really rounds


def test_port_fp32_matches_the_fp32_reference(inputs, reference):
    """The same path in fp32: the same arithmetic summed in another order
    (five chained U-Net calls)."""
    ours = port_sample(inputs, bf16=False)
    assert psnr(ours, reference) >= 90.0
    np.testing.assert_allclose(ours, reference, rtol=0, atol=1e-4)
