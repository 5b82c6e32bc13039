"""The port's metrics suite against the JAX package's (CPU).

Tolerances:
  - the numpy metrics (PSNR, SSIM, the UIQM family, rgb2lab) and the
    Fréchet distance are the same float64 numpy arithmetic in both
    packages: equal to 1e-12 relative;
  - InceptionV3Features on the JAX FID's own (He-rescaled) parameters and
    batch statistics, carried over by `weights.inception_state_dict_from_
    flat`, at 75², batch 2: the 2048-d features within 1e-4 of their
    largest magnitude (fp32 through ~100 convolutions summed in another
    order; measured 1.6e-6);
  - FID end to end (both upsample 32² inputs to 75², then features, then
    the distance): within 1e-3 relative (measured 3.3e-6).
"""

import jax
import numpy as np
import pytest
import torch

from hybrid_diffusion_tpu import metrics as jm
from hybrid_diffusion_tpu_torch import metrics as tm
from hybrid_diffusion_tpu_torch.metrics.__main__ import evaluate_folders
from hybrid_diffusion_tpu_torch.data.registry import save_image
from hybrid_diffusion_tpu_torch.utils.params_io import flatten_params
from hybrid_diffusion_tpu_torch.weights import inception_state_dict_from_flat

from _torch_parity import one_torch_thread  # noqa: F401


def _images(seed, n=3, size=32):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    noisy = np.clip(base.astype(int) + rng.integers(-40, 40, base.shape),
                    0, 255).astype(np.uint8)
    return base, noisy


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_metrics_equal_jax(seed):
    gts, preds = _images(seed)
    for gt, img in zip(gts, preds):
        for fn in ("psnr", "ssim_index"):
            a = getattr(tm, fn)(gt, img, data_range=255)
            b = getattr(jm, fn)(gt, img, data_range=255)
            assert a == pytest.approx(b, rel=1e-12)
        np.testing.assert_allclose(tm.nmetrics(img), jm.nmetrics(img),
                                   rtol=1e-12)
        for fn in ("getUIQM", "uciqe"):
            assert getattr(tm, fn)(img) == pytest.approx(
                getattr(jm, fn)(img), rel=1e-12)
        np.testing.assert_allclose(tm.rgb2lab(img), jm.rgb2lab(img),
                                   rtol=1e-12, atol=1e-12)
        # The [0, 1] float form lands on the same domain as uint8.
        np.testing.assert_allclose(tm.nmetrics(img / 255.0),
                                   jm.nmetrics(img / 255.0), rtol=1e-12)


def test_frechet_distance_equal_jax():
    rng = np.random.default_rng(3)
    f1 = rng.standard_normal((12, 40))
    f2 = 0.5 + 1.3 * rng.standard_normal((9, 40))
    mu1, s1 = tm.FID._stats(f1)
    mu2, s2 = tm.FID._stats(f2)
    assert tm.FID.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(
        jm.FID.frechet_distance(mu1, s1, mu2, s2), rel=1e-12)
    assert tm.FID.frechet_from_features(f1, f2) == pytest.approx(
        jm.FID.frechet_from_features(f1, f2), rel=1e-12)
    big1, big2 = rng.standard_normal((50, 6)), rng.standard_normal((60, 6))
    assert tm.FID.frechet_from_features(big1, big2) == pytest.approx(
        jm.FID.frechet_from_features(big1, big2), rel=1e-12)


@pytest.fixture(scope="module")
def fids():
    """(JAX FID, the port's FID on the same parameters) at 75²."""
    jfid = jm.FID(image_size=75)
    tfid = tm.FID(image_size=75, device="cpu")
    tfid.model.load_state_dict(inception_state_dict_from_flat(flatten_params(
        jax.tree_util.tree_map(np.asarray, jfid.params))), strict=True)
    return jfid, tfid


def test_inception_features_on_carried_flax_params(fids):
    jfid, tfid = fids
    x = np.random.default_rng(4).random((2, 75, 75, 3)).astype(np.float32)
    ref = np.asarray(jfid.model.apply(jfid.params, x))
    with torch.no_grad():
        got = tfid.model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-4, err
    with pytest.raises(ValueError, match="75px"):
        tfid.model(torch.zeros(1, 74, 80, 3))


def test_fid_end_to_end_he_rescaled(fids):
    jfid, tfid = fids
    real, fake = _images(5, n=4)
    a = tfid.compute_fid(real, fake)
    b = jfid.compute_fid(real, fake)
    assert np.isfinite(a) and a > 0
    assert a == pytest.approx(b, rel=1e-3)
    s = tm.StreamingFID(tfid)
    s.update(real[:2], fake[:2])
    s.update(real[2:], fake[2:])
    assert s.compute() == pytest.approx(a, rel=1e-9)
    # The port's own random init is He-rescaled too: discriminative.
    own = tm.FID(image_size=32, device="cpu")
    assert own.feature_mode == "random_he" and not own.pretrained
    feats = own.extract_features(real)
    assert feats.shape == (4, 2048) and np.abs(feats).mean() > 1e-3


def test_metrics_folder_cli_equal_jax(tmp_path):
    gts, preds = _images(6, n=2)
    for d, imgs in (("res", preds), ("gt", gts)):
        (tmp_path / d).mkdir()
        for i, im in enumerate(imgs):
            save_image(str(tmp_path / d / f"im{i}.png"), im)
    from hybrid_diffusion_tpu.metrics.__main__ import (
        evaluate_folders as jax_evaluate_folders)

    ours = evaluate_folders(str(tmp_path / "res"), str(tmp_path / "gt"))
    theirs = jax_evaluate_folders(str(tmp_path / "res"), str(tmp_path / "gt"))
    assert ours.keys() == theirs.keys() and ours["n"] == 2
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], rel=1e-12)
