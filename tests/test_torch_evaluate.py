"""The whole slice: the port's evaluate() against the JAX package's (CPU).

Both evaluate the committed r5 flagship npz (ch 128, mult (1,2,2,2), 2 res
blocks, T 1000) at 32² on the synthetic corpus's test split (2 pairs a
domain, batch 2), DPM++2M-5, fp32, FID off, from the same initial noise:
JAX's, drawn from its evaluate's keys as its sampler draws it, handed to
the port's sampler. Both quantize to uint8 before the metrics.

Tolerances: the two fp32 samplers differ by float rounding, so an output
byte may move by one: every byte within 1 of JAX's, and at most 0.1% of
them moved. PSNR and SSIM (means over 2·32² pixels) within 1e-3 of JAX's,
relative. The UIQM family within 2e-2, relative: its EME terms take the
log of each 8×8 block's max/min, so one byte moved at a block's extreme
moves a 32² image's UISM by up to ~1%. Measured (one torch thread): 4 of
12288 bytes moved by 1, all in the atmospheric images; PSNR 2.1e-6, SSIM
2.5e-6, UIQM 2.6e-3, UISM 1.5e-3, UCIQE 2.0e-4 (underwater: 0).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from hybrid_diffusion_tpu.config import Config as JaxConfig
from hybrid_diffusion_tpu.train.loop import evaluate as jax_evaluate
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.train import loop

NPZ = Path(__file__).resolve().parent.parent / "docs" / "assets" / \
    "flagship256_r5_fp16.npz"
SETTINGS = dict(synthetic_data=True, synthetic_length=7, batch_size=2,
                img_size=32, bf16=False, sampler="dpm++2m", ddim_step=5,
                pretrained_path=str(NPZ), seed=0)
METRICS = ("psnr", "ssim", "uiqm", "uciqe", "uism", "uicm", "uiconm",
           "uiqm_nd")


def jax_noise(seed, n_batches, shape):
    """The initial noise of JAX evaluate's batches: rng, sub = split(rng)
    per batch, and its DPM++2M sampler draws normal(split(sub)[1])."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n_batches):
        rng, sub = jax.random.split(rng)
        _, noise_rng = jax.random.split(sub)
        out.append(np.array(jax.random.normal(noise_rng, shape,
                                                jnp.float32)))
    return out


def test_evaluate_matches_jax_on_the_r5_npz(tmp_path, monkeypatch):
    import torch

    from hybrid_diffusion_tpu_torch.data.registry import load_image

    ref = jax_evaluate(
        JaxConfig(**SETTINGS, output_path=str(tmp_path / "jax"),
                  checkpoint_dir=str(tmp_path), compilation_cache="",
                  num_workers=1),
        split="test", compute_fid=False, save_images=True)
    # One batch a domain, and JAX's keys restart for each domain: the same
    # initial noise for both.
    noise = torch.from_numpy(jax_noise(0, 1, (2, 32, 32, 3))[0])
    real = loop.make_sampler

    def with_jax_noise(*args, **kwargs):
        sample = real(*args, **kwargs)
        return lambda cond_u8, generator=None: sample(cond_u8, generator,
                                                      noise)

    monkeypatch.setattr(loop, "make_sampler", with_jax_noise)
    ours = loop.evaluate(
        Config(**SETTINGS, output_path=str(tmp_path / "port"),
               checkpoint_dir=str(tmp_path), num_workers=1, device="cpu"),
        split="test", compute_fid=False, save_images=True)
    flipped = 0
    for path in sorted((tmp_path / "jax" / "result").rglob("*.png")):
        a = load_image(str(path)).astype(int)
        b = load_image(str(path).replace("/jax/", "/port/")).astype(int)
        assert np.abs(a - b).max() <= 1, path.name
        flipped += int((a != b).sum())
    assert flipped <= 0.001 * 4 * 32 * 32 * 3, flipped
    for domain in ("underwater", "atmospheric"):
        a, b = ours[domain], ref[domain]
        assert a["n_images"] == b["n_images"] == 2
        for k in METRICS:
            assert np.isfinite(a[k]), (domain, k)
            rel = 1e-3 if k in ("psnr", "ssim") else 2e-2
            assert a[k] == pytest.approx(b[k], rel=rel), (domain, k)
