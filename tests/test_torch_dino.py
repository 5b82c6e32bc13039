"""The port's DINO perceptual loss against the JAX package's, in fp32 on the
CPU: the ViT-S/14 weights are the JAX extractor's random init (seeded),
carried across by `weights.py`; the images are made with numpy.

  - the position table's resize: `jax.image.resize(..., "cubic")` (Keys
    a = −0.5, antialiased when it shrinks), 37 → 18 at the flagship's 252²
    crop and 37 → 2 at the tests' 28² (rel ≤ 1e-6);
  - the loss and its gradient wrt the prediction at a 32² image (a 28²
    crop): rel ≤ 1e-5 and ≤ 1e-4 (fp32 in another order through 12 blocks);
  - the weights map both ways, through the npz hook too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    jax_leaves, one_torch_thread, rel_err)
from hybrid_diffusion_tpu.losses.perceptual import (
    DinoPerceptualLoss as JaxDino,
    _interpolate_pos_embed as jax_interpolate,
    center_crop_to_multiple as jax_crop,
)
from hybrid_diffusion_tpu.utils.params_io import flatten_params as jax_flatten
from hybrid_diffusion_tpu_torch.losses import DinoPerceptualLoss
from hybrid_diffusion_tpu_torch.losses.perceptual import (
    _interpolate_pos_embed,
    center_crop_to_multiple,
)
from hybrid_diffusion_tpu_torch.weights import flat_from_state_dict


@pytest.fixture(scope="module")
def pair():
    jdino = JaxDino(jax.random.PRNGKey(3), image_size=32)
    tdino = DinoPerceptualLoss(device="cpu")
    tdino.model.load_state_dict(jax_leaves(jdino.params["params"]),
                                strict=True)
    return jdino, tdino


@pytest.mark.parametrize("grid", [18, 2, 40], ids=["37to18_flagship",
                                                   "37to2", "37to40_up"])
def test_pos_embed_resize_matches_jax_cubic(grid):
    rng = np.random.default_rng(grid)
    pos = (0.02 * rng.standard_normal((1, 1370, 16))).astype(np.float32)
    ref = np.asarray(jax_interpolate(jnp.asarray(pos), grid, grid))
    ours = _interpolate_pos_embed(torch.from_numpy(pos), grid, grid).numpy()
    assert ours.shape == ref.shape == (1, grid * grid + 1, 16)
    assert rel_err(ours, ref) <= 1e-6
    # Not torch's bicubic (a = −0.75, no antialias): that misses by far more.
    other = torch.nn.functional.interpolate(
        torch.from_numpy(pos[:, 1:].reshape(1, 37, 37, 16)).permute(0, 3, 1, 2),
        size=(grid, grid), mode="bicubic", align_corners=False)
    other = other.permute(0, 2, 3, 1).reshape(1, grid * grid, 16).numpy()
    assert rel_err(other, ref[:, 1:]) > 100 * rel_err(ours, ref)


def test_center_crop_matches_jax():
    x = np.arange(2 * 256 * 256 * 3, dtype=np.float32).reshape(2, 256, 256, 3)
    ref = np.asarray(jax_crop(jnp.asarray(x), 14))
    ours = center_crop_to_multiple(torch.from_numpy(x), 14).numpy()
    assert ours.shape == (2, 252, 252, 3)
    np.testing.assert_array_equal(ours, ref)


def _images(seed):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    target = np.clip(pred + 0.3 * rng.standard_normal(pred.shape),
                     -1, 1).astype(np.float32)
    return pred, target


@pytest.fixture(scope="module")
def jax_results(pair):
    """JAX's loss, its gradient wrt the prediction, the per-example losses
    and the prediction's 13 features, from one compiled function."""
    jdino, _ = pair
    pred, target = _images(0)

    def all_of(p, t):
        value, grad = jax.value_and_grad(jdino)(p, t)
        per_example = jax.vmap(lambda a, b: jdino(a[None], b[None]))(p, t)
        return value, grad, per_example, jdino.features(p)

    out = jax.jit(all_of)(jnp.asarray(pred), jnp.asarray(target))
    return (pred, target), jax.tree_util.tree_map(np.asarray, out)


def test_dino_loss_and_grad_match_jax(pair, jax_results):
    _, tdino = pair
    (pred, target), (ref, ref_grad, _, _) = jax_results
    p = torch.from_numpy(pred).requires_grad_()
    value = tdino(p, torch.from_numpy(target))
    value.backward()
    assert abs(value.item() - float(ref)) <= 1e-5 * float(ref)
    assert rel_err(p.grad.numpy(), ref_grad) <= 1e-4
    assert float(ref) > 0.1               # the features differ


def test_dino_features_match_jax(pair, jax_results):
    """All 13 features (the 12 blocks' outputs and the final norm)."""
    _, tdino = pair
    (pred, _), (_, _, _, ref) = jax_results
    with torch.no_grad():
        ours = tdino.features(torch.from_numpy(pred))
    assert len(ours) == len(ref) == 13
    for a, b in zip(ours, ref):
        assert a.shape == (2, 5, 384)
        assert rel_err(a.numpy(), b) <= 1e-5


def test_dino_per_example_matches_jax_vmap(pair, jax_results):
    _, tdino = pair
    (pred, target), (_, _, ref, _) = jax_results
    with torch.no_grad():
        ours = tdino(torch.from_numpy(pred), torch.from_numpy(target),
                     per_example=True).numpy()
    assert rel_err(ours, ref) <= 1e-5


def test_vit_weights_map_both_ways_and_load_through_the_hook(pair, tmp_path):
    """flax → port → flax is exact, and a flat npz of flax names (as JAX's
    `_load_npz_params` reads it) loads through `weights_path`."""
    jdino, tdino = pair
    flat = jax_flatten(jdino.params)
    back = flat_from_state_dict(tdino.model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    path = tmp_path / "dino.npz"
    np.savez(path, **flat)
    hooked = DinoPerceptualLoss(weights_path=str(path), device="cpu")
    assert hooked.pretrained
    pred, target = map(torch.from_numpy, _images(3))
    with torch.no_grad():
        assert torch.equal(hooked(pred, target), tdino(pred, target))


def test_random_init_follows_flax_distributions(pair):
    """The port's own random init (no weights file) has flax's
    distributions: lecun-normal kernels truncated at 2σ, zero biases,
    LayerScale 1, cls 0, pos N(0, 0.02); std within 10% of flax's sample."""
    jdino, _ = pair
    ours = DinoPerceptualLoss(seed=1, device="cpu").model.state_dict()
    ref = jax_leaves(jdino.params["params"])
    assert set(ours) == set(ref)
    for name, r in ref.items():
        o = ours[name]
        if not r.any() or (r == 1).all():
            assert torch.equal(o, r), name
            continue
        assert float(o.std()) == pytest.approx(float(r.std()), rel=0.1), name
        if name != "pos_embed":           # truncated: the same ±2σ' edge
            assert float(o.abs().max()) <= 1.01 * float(r.abs().max()), name
