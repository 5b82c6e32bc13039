"""The VGG, alex and squeeze perceptual taps: the port against the JAX
package's `VGGPerceptualLoss` in fp32 on the CPU, on numpy-seeded params
carried across (`weights.state_dict_from_flat`, the flat flax names).

vgg16, vgg16_bn and squeeze run at 32²; alex at 64², the least size at
which its last default tap (slot 12, the third 3×3 stride-2 pool) is not
empty. The BN variances are drawn positive. Bounds: every tapped feature
and the loss, rel ≤ 1e-5 (fp32 convolutions summed in another order;
measured ≤ 2e-6). The composite step with the run-book's stage-1 loss set
(vgg 1, charbonnier 1, the rest 0) is held as test_torch_train_step.py
holds the default one: the loss terms within 1e-5 × max(|jax|, 1), the
gradients (AdamW's first moment after one update) rel ≤ 1e-3, and a bias
that a GroupNorm of one channel a group removes (JAX's gradient ≤ 1e-6 of
the largest) below 1e-5 of the largest on the port's side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    TINY, batch, jax_leaves, one_torch_thread, random_params, rel_err,
    tiny_pair)
from hybrid_diffusion_tpu.diffusion import linear_beta_schedule as jax_schedule
from hybrid_diffusion_tpu.losses import CompositeLossConfig as JaxLossConfig
from hybrid_diffusion_tpu.losses.perceptual import VGGPerceptualLoss as JaxVGG
from hybrid_diffusion_tpu.train.step import make_train_step as jax_make_step
from hybrid_diffusion_tpu.train.train_state import (
    create_train_state as jax_create_state,
)
from hybrid_diffusion_tpu_torch.config import parse_config
from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
from hybrid_diffusion_tpu_torch.losses import (
    CompositeLossConfig,
    VGGPerceptualLoss,
)
from hybrid_diffusion_tpu_torch.losses.perceptual import vgg_backbones
from hybrid_diffusion_tpu_torch.train.loop import _make_vgg
from hybrid_diffusion_tpu_torch.train.step import make_train_step
from hybrid_diffusion_tpu_torch.train.train_state import TrainState
from hybrid_diffusion_tpu_torch.utils.params_io import (
    flatten_params,
    save_params_npz,
)

STAGE1 = dict(mse_weight=1.0, vgg_weight=1.0, charbonnier_weight=1.0,
              dino_weight=0.0, ms_ssim_weight=0.0, color_weight=0.0)
HYPER = dict(lr=1e-3, weight_decay=1e-2, grad_clip=1.0, total_epochs=4,
             steps_per_epoch=1, multiplier=2.0, ema_decay=0.9)


def jax_loss(model, seed=1, layer_indices=None):
    """A JAX VGGPerceptualLoss with numpy-seeded params (BN variances > 0)."""
    loss = JaxVGG(jax.random.PRNGKey(0), model=model,
                  layer_indices=layer_indices)

    def fix(path, x):
        if str(path[-1].key).endswith("_var"):
            return jnp.abs(jnp.asarray(x)) + 0.5
        return jnp.asarray(x)

    loss.params = jax.tree_util.tree_map_with_path(
        fix, random_params(loss.params, seed))
    return loss


def port_loss(jloss, model, layer_indices=None):
    loss = VGGPerceptualLoss(model=model, layer_indices=layer_indices,
                             device="cpu")
    loss.model.load_state_dict(jax_leaves(jloss.params["params"]),
                               strict=True)
    return loss


def images(seed, size):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("model,size", [("vgg16", 32), ("vgg16_bn", 32),
                                        ("alex", 64), ("squeeze", 32)])
def test_taps_and_loss_match_jax(model, size):
    jl = jax_loss(model)
    tl = port_loss(jl, model)
    a, b = images(0, size)
    jfeats = jax.jit(jl.model.apply)(jl.params, jnp.asarray((a + 1) / 2))
    with torch.no_grad():
        tfeats = tl.features(torch.from_numpy(a))
    assert len(tfeats) == len(jfeats) == len(tl.taps)
    for t, j in zip(tfeats, jfeats):
        assert t.shape[1:] == (j.shape[3], j.shape[1], j.shape[2])
        assert rel_err(t.permute(0, 2, 3, 1).numpy(), np.asarray(j)) <= 1e-5
    want = float(jl(jnp.asarray(a), jnp.asarray(b)))
    got = float(tl(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_layer_indices_count_torchvision_slots():
    """Slots count conv, BN, ReLU and pool one each: vgg11's default taps
    [3, 8, 15, 22] give 3 features (22 lies past its 21 slots), vgg16_bn at
    [1, 2, 4] taps conv_0's BN and ReLU and conv_1's BN output."""
    assert VGGPerceptualLoss(model="vgg11", device="cpu").taps == (3, 8, 15, 22)
    for model, taps, n in (("vgg11", None, 3), ("vgg16_bn", [1, 2, 4], 3)):
        jl = jax_loss(model, seed=2, layer_indices=taps)
        tl = port_loss(jl, model, layer_indices=taps)
        a, _ = images(1, 32)
        jfeats = jl.model.apply(jl.params, jnp.asarray((a + 1) / 2))
        with torch.no_grad():
            tfeats = tl.features(torch.from_numpy(a))
        assert len(tfeats) == len(jfeats) == n
        for t, j in zip(tfeats, jfeats):
            assert rel_err(t.permute(0, 2, 3, 1).numpy(), np.asarray(j)) <= 1e-5
    with pytest.raises(ValueError, match="Unsupported perceptual model"):
        VGGPerceptualLoss(model="resnet", device="cpu")
    assert len(vgg_backbones()) == 10


def test_strict_npz_load(tmp_path, monkeypatch):
    """A flat flax-named npz loads (also through HDT_VGG_WEIGHTS); an array
    that matches no parameter raises, and so does a shape mismatch, as
    JAX's `_load_npz_params` does."""
    jl = jax_loss("squeeze", seed=3)
    flat = flatten_params({"params": jax.tree_util.tree_map(
        np.asarray, jl.params["params"])})
    good = tmp_path / "good.npz"
    save_params_npz(good, flat, dtype="float32")
    monkeypatch.setenv("HDT_VGG_WEIGHTS", str(good))
    tl = VGGPerceptualLoss(model="squeeze", device="cpu")
    assert tl.pretrained
    a, b = images(2, 32)
    want = float(jl(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(tl(torch.from_numpy(a), torch.from_numpy(b))) - want) \
        <= 1e-5 * abs(want)
    monkeypatch.delenv("HDT_VGG_WEIGHTS")

    extra = tmp_path / "extra.npz"
    save_params_npz(extra, {**flat, "params/conv_9/kernel": np.zeros(3)},
                    dtype="float32")
    with pytest.raises(ValueError, match="match no model parameter"):
        VGGPerceptualLoss(model="squeeze", weights_path=str(extra),
                          device="cpu")
    with pytest.raises(ValueError, match="match no model parameter"):
        JaxVGG(model="squeeze", weights_path=str(extra))
    bad = tmp_path / "bad.npz"
    save_params_npz(bad, {**flat, "params/conv_0/bias": np.zeros(7)},
                    dtype="float32")
    with pytest.raises(ValueError, match="shape mismatch at params/conv_0/bias"):
        VGGPerceptualLoss(model="squeeze", weights_path=str(bad),
                          device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        JaxVGG(model="squeeze", weights_path=str(bad))


def test_frozen_and_gradient_reaches_only_the_prediction():
    tl = VGGPerceptualLoss(model="vgg16", device="cpu")
    assert not any(p.requires_grad for p in tl.parameters())
    a, b = (torch.from_numpy(x).requires_grad_() for x in images(3, 32))
    tl(a, b).backward()
    assert a.grad is not None and float(a.grad.abs().max()) > 0
    assert b.grad is None
    per = tl(a.detach(), b.detach(), per_example=True)
    assert per.shape == (2,)


def test_stage1_composite_step_matches_jax():
    """One train step under --stage1_losses "vgg=1.0,charbonnier=1.0,
    dino=0,ms_ssim=0,color=0" against JAX's step, both with vgg16 on the
    same carried params (random init in the port from seed 2 otherwise)."""
    config = parse_config(["--stage1_losses",
                           "vgg=1.0,charbonnier=1.0,dino=0,ms_ssim=0,color=0"])
    loss_cfg = config.stage_loss_config(0)
    assert loss_cfg == CompositeLossConfig(**STAGE1)
    assert _make_vgg(config, [loss_cfg], "cpu") is not None
    jm, params, tm = tiny_pair(seed=12)
    jl = jax_loss("vgg16", seed=4)
    tl = port_loss(jl, "vgg16")
    jstep = jax_make_step(jax_schedule(1e-4, 0.02, TINY["T"]),
                          JaxLossConfig(**STAGE1), vgg_loss_fn=jl,
                          donate=False)
    tstep = make_train_step(linear_beta_schedule(1e-4, 0.02, TINY["T"]),
                            CompositeLossConfig(**STAGE1), vgg_loss_fn=tl)
    b = batch(30, blue=True)
    key = jax.random.PRNGKey(5)
    t_key, noise_key, _, _ = jax.random.split(key, 4)
    t = np.array(jax.random.randint(t_key, (2,), 0, TINY["T"]))
    noise = np.array(jax.random.normal(noise_key, (2, 32, 32, 3), np.float32))
    jstate, jmetrics = jstep(jax_create_state(params, jm.apply, **HYPER), b,
                             key)
    tstate, tmetrics = tstep(
        TrainState(tm, **HYPER), {k: torch.from_numpy(v) for k, v in b.items()},
        torch.Generator().manual_seed(0), t=torch.from_numpy(t),
        noise=torch.from_numpy(noise))
    assert set(jmetrics) <= set(tmetrics)
    assert {"vgg", "charbonnier"} <= set(tmetrics) and "dino" not in tmetrics
    for k in ("mse", "vgg", "charbonnier", "total"):
        want = float(jmetrics[k])
        assert abs(float(tmetrics[k]) - want) <= 1e-5 * max(abs(want), 1.0), k
    mu = jax_leaves(jstate.opt_state[1][0].mu["params"])
    top = max(float(v.abs().max()) for v in mu.values())
    for name, want in mu.items():
        got = tstate.moments(name)["exp_avg"]
        if float(want.abs().max()) <= 1e-6 * top:
            # A bias that a one-channel GroupNorm removes: zero but for
            # rounding on both sides.
            assert float(got.abs().max()) <= 1e-5 * top, name
            continue
        assert float((got - want).norm() / want.norm()) <= 1e-3, name
