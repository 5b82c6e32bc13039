"""The port's losses and diffusion-process functions against the JAX
package, in fp32 on the CPU, on the same numpy-made inputs.

Tolerances (rel = max|port − jax| / max|jax|): values rel ≤ 1e-5 and
gradients rel ≤ 1e-4 (fp32 summed in another order); a loss of the form
1 − x is compared to 1e-5 of 1 (one ulp of 1 is 1.2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, rel_err  # noqa: F401 (autouse)
from hybrid_diffusion_tpu.diffusion import linear_beta_schedule as jax_schedule
from hybrid_diffusion_tpu.diffusion.process import (
    predict_x0_from_eps as jax_predict_x0,
    q_sample as jax_q_sample,
)
from hybrid_diffusion_tpu.losses.charbonnier import (
    charbonnier_loss as jax_charbonnier,
)
from hybrid_diffusion_tpu.losses.color import angular_color_loss as jax_color
from hybrid_diffusion_tpu.losses.composite import (
    CompositeLossConfig as JaxLossConfig,
    composite_enhancement_loss as jax_composite,
)
from hybrid_diffusion_tpu.losses.ms_ssim import ms_ssim_loss as jax_ms_ssim
from hybrid_diffusion_tpu_torch.diffusion import (
    linear_beta_schedule,
    predict_x0_from_eps,
    q_sample,
)
from hybrid_diffusion_tpu_torch.losses import (
    CompositeLossConfig,
    angular_color_loss,
    charbonnier_loss,
    composite_enhancement_loss,
    ms_ssim_loss,
)
from hybrid_diffusion_tpu_torch.losses.ms_ssim import _gaussian_kernel1d

LOSSES = {"color": (angular_color_loss, jax_color),
          "charbonnier": (charbonnier_loss, jax_charbonnier),
          "ms_ssim": (ms_ssim_loss, jax_ms_ssim)}


def images(seed, shape, dark=False):
    """A prediction and a target in [0, 1], the target with dark pixels (the
    colour loss's singular case) when asked."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    target = np.clip(pred + 0.2 * rng.standard_normal(shape), 0, 1)
    if dark:
        target[:, ::3, ::2] = 0.0
    return pred, target.astype(np.float32)


def port_value_and_grad(fn, pred, target, **kw):
    p = torch.from_numpy(pred).requires_grad_()
    value = fn(p, torch.from_numpy(target), **kw)
    value.sum().backward()
    return value.detach().numpy(), p.grad.numpy()


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_grad_match_jax(name):
    """At 32² (MS-SSIM: two scales)."""
    ours_fn, jax_fn = LOSSES[name]
    pred, target = images(32, (2, 32, 32, 3), dark=name == "color")
    ref, ref_grad = jax.value_and_grad(jax_fn)(jnp.asarray(pred),
                                               jnp.asarray(target))
    value, grad = port_value_and_grad(ours_fn, pred, target)
    assert abs(float(value) - float(ref)) <= 1e-5 * max(abs(float(ref)), 1.0)
    assert rel_err(grad, ref_grad) <= 1e-4
    assert np.isfinite(grad).all()


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_per_example_values_match_jax_vmap(name):
    """Each loss per image, as the composite reduces with aux_weights."""
    ours_fn, jax_fn = LOSSES[name]
    pred, target = images(5, (3, 32, 32, 3), dark=True)
    ref = np.asarray(jax.vmap(lambda a, b: jax_fn(a[None], b[None]))(
        jnp.asarray(pred), jnp.asarray(target)))
    ours = ours_fn(torch.from_numpy(pred), torch.from_numpy(target),
                   per_example=True).numpy()
    assert ours.shape == (3,)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_ms_ssim_scale_count_adapts():
    """The scales in use follow the size: two at 32², three at 64², all five
    from 176², each short count with the renormalized weight prefix."""
    pred, target = images(8, (2, 176, 176, 3))
    for size in (32, 64, 176):
        ref = float(jax_ms_ssim(jnp.asarray(pred[:, :size, :size]),
                                jnp.asarray(target[:, :size, :size])))
        ours = float(ms_ssim_loss(torch.from_numpy(pred[:, :size, :size]),
                                  torch.from_numpy(target[:, :size, :size])))
        assert abs(ours - ref) <= 1e-5


def test_gaussian_window_is_the_jax_one():
    from hybrid_diffusion_tpu.losses.ms_ssim import _gaussian_kernel1d as ref

    np.testing.assert_array_equal(_gaussian_kernel1d(11, 1.5), ref(11, 1.5))


@pytest.mark.parametrize("aux", [False, True], ids=["plain", "aux_weights"])
def test_composite_matches_jax(aux):
    """The default weights plus Charbonnier, x0 clipped to [−1, 1], with and
    without per-example ᾱ_t weights; loss and its gradient wrt noise_pred
    and x0_pred. (The DINO term is held in test_torch_dino.py.)"""
    rng = np.random.default_rng(6)
    shape = (3, 32, 32, 3)
    noise_pred, noise = (rng.standard_normal(shape).astype(np.float32)
                         for _ in range(2))
    x0 = (1.3 * rng.uniform(-1, 1, shape)).astype(np.float32)  # some clipped
    gt = rng.uniform(-1, 1, shape).astype(np.float32)
    w = np.array([0.9, 0.1, 0.5], np.float32) if aux else None
    jcfg = JaxLossConfig(dino_weight=0.0, charbonnier_weight=0.3)
    tcfg = CompositeLossConfig(dino_weight=0.0, charbonnier_weight=0.3)

    def jloss(a, b):
        return jax_composite(a, jnp.asarray(noise), b, jnp.asarray(gt), jcfg,
                             aux_weights=None if w is None else jnp.asarray(w))
    (ref, ref_parts), (g_np, g_x0) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(noise_pred),
                                             jnp.asarray(x0))
    a = torch.from_numpy(noise_pred).requires_grad_()
    b = torch.from_numpy(x0).requires_grad_()
    loss, parts = composite_enhancement_loss(
        a, torch.from_numpy(noise), b, torch.from_numpy(gt), tcfg,
        aux_weights=None if w is None else torch.from_numpy(w))
    loss.backward()
    assert set(parts) == set(ref_parts)
    for k in parts:
        assert abs(parts[k].item() - float(ref_parts[k])) <= 1e-5 * max(
            abs(float(ref_parts[k])), 1.0), k
    assert rel_err(a.grad.numpy(), g_np) <= 1e-5
    assert rel_err(b.grad.numpy(), g_x0) <= 1e-4
    assert not b.grad.numpy()[np.abs(x0) > 1].any()    # the clip


@pytest.mark.parametrize("fn", ["q_sample", "predict_x0_from_eps"])
def test_process_matches_jax(fn):
    """Gathered at t, shaped (B, 1, 1, 1) (rel ≤ 1e-6)."""
    sched, jsched = linear_beta_schedule(1e-4, 0.02, 1000), jax_schedule(
        1e-4, 0.02, 1000)
    rng = np.random.default_rng(7)
    x, eps = (rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
              for _ in range(2))
    t = np.array([0, 499, 999], np.int32)
    ours_fn = q_sample if fn == "q_sample" else predict_x0_from_eps
    ref_fn = jax_q_sample if fn == "q_sample" else jax_predict_x0
    ref = np.asarray(ref_fn(jsched, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(eps)))
    ours = ours_fn(sched, torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(eps)).numpy()
    assert rel_err(ours, ref) <= 1e-6
