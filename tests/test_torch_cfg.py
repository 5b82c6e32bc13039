"""The classifier-free-guidance subsystem: the port against the JAX package
in fp32 on the CPU, at CFGUNet ch 32, mult (1, 2), 1 res block, T 10, 16²,
on numpy-seeded weights carried across (`weights.state_dict_from_flat`).

JAX's random draws (the step's t, noise and label drop; the sampler's
initial and per-step noise) are made with JAX from the key exactly as the
JAX functions split it, and handed to the port. Bounds:
  - LabelEmbedding and the CFGUNet forward: rel ≤ 1e-5 (fp32 summed in
    another order; measured ≤ 6e-6);
  - the train step's loss, |port − jax| ≤ 1e-5 × |jax|; its gradients (as
    AdamW's first moment after one update, 0.1 × the clipped gradient),
    ‖port − jax‖ / ‖jax‖ ≤ 1e-3 for every parameter that JAX's gradient
    reaches. The table's row 0 and unused label rows get exactly zero on
    both sides. What a level-0 block adds uniformly over space before a
    GroupNorm of one channel a group (32 channels, 32 groups) is removed by
    it (the biases, temb_proj and cemb_proj, the attention's out_proj
    bias): their gradient is zero but for rounding (at most 1.4e-6 of the
    largest on JAX's side, every other leaf at least 6e-3), so below
    ZERO_GRAD of the largest on JAX's side the port's must stay below ten
    times that;
  - the guided ε: rel ≤ (1 + 2w)·1e-5, since the mix (1+w)·ε_c − w·ε_u
    scales each call's own error by up to 1 + 2w (measured 2.4e-5 at
    w 1.8); the whole 10-step CFG chain at w 1.8: rel ≤ 1e-4 (measured
    1.9e-5).
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, random_params, rel_err  # noqa: F401
from hybrid_diffusion_tpu.cfg import (
    CIFAR10Dataset as JaxCIFAR,
    SyntheticLabeledDataset as JaxSynthetic,
    cfg_ddpm_sample as jax_cfg_sample,
    make_cfg_train_step as jax_make_cfg_step,
)
from hybrid_diffusion_tpu.cfg.cli import parse_cfg_config as jax_parse
from hybrid_diffusion_tpu.cfg.sampler import _guided_eps as jax_guided_eps
from hybrid_diffusion_tpu.diffusion import linear_beta_schedule as jax_schedule
from hybrid_diffusion_tpu.models.cfg_unet import CFGUNet as JaxCFGUNet
from hybrid_diffusion_tpu.models.embeddings import LabelEmbedding as JaxLabel
from hybrid_diffusion_tpu.train.train_state import (
    create_train_state as jax_create_state,
)
from hybrid_diffusion_tpu_torch.cfg import (
    CFGConfig,
    CIFAR10Dataset,
    SyntheticLabeledDataset,
    cfg_ddpm_sample,
    evaluate_cfg,
    make_cfg_train_step,
    make_labeled_dataset,
    train_cfg,
)
from hybrid_diffusion_tpu_torch.cfg.cli import main, parse_cfg_config
from hybrid_diffusion_tpu_torch.cfg.sampler import _guided_eps
from hybrid_diffusion_tpu_torch.data.registry import _png_decode
from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
from hybrid_diffusion_tpu_torch.models import CFGUNet
from hybrid_diffusion_tpu_torch.models.embeddings import LabelEmbedding
from hybrid_diffusion_tpu_torch.train.train_state import TrainState
from hybrid_diffusion_tpu_torch.utils.params_io import flatten_params
from hybrid_diffusion_tpu_torch.weights import (
    flat_from_state_dict,
    state_dict_from_flat,
)

TINY = dict(T=10, num_labels=10, ch=32, ch_mult=(1, 2), num_res_blocks=1,
            dropout=0.0)
SIZE = 16
HYPER = dict(lr=1e-3, weight_decay=1e-4, grad_clip=1.0, total_epochs=4,
             steps_per_epoch=1, multiplier=2.5)
ZERO_GRAD = 1e-5          # of the largest gradient: a removed term


def to_port(params):
    return state_dict_from_flat(flatten_params(
        jax.tree_util.tree_map(np.asarray, params["params"])))


def cfg_pair(seed=3):
    """(JAX CFGUNet, its params, the port's CFGUNet with the same weights)."""
    jm = JaxCFGUNet(**TINY)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, SIZE, SIZE, 3)),
                              jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map(jnp.asarray, random_params(template, seed))
    tm = CFGUNet(**TINY)
    tm.load_state_dict(to_port(params), strict=True)
    return jm, params, tm


def tiny_config(tmp_path, **overrides) -> CFGConfig:
    overrides.setdefault("epochs", 1)
    return CFGConfig(batch_size=8, T=8, channel=32,
                     channel_mult=(1, 2), num_res_blocks=1, dropout=0.0,
                     img_size=16, nrow=2, synthetic_length=16, bf16=False,
                     save_every=1, save_dir=str(tmp_path / "ck"),
                     sampled_dir=str(tmp_path / "out"), device="cpu",
                     **overrides)


def test_label_embedding_pins_row_zero():
    """A table loaded with a non-zero row 0 still embeds label 0 as zero
    (before the MLP), as JAX's `table.at[0].set(0.0)` at every forward; no
    gradient reaches row 0."""
    jm = JaxLabel(num_labels=10, d_model=32, dim=64)
    labels = np.array([0, 3, 10, 0, 7])
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map(jnp.asarray, random_params(template, 1))
    params["params"]["table"] = params["params"]["table"].at[0].set(5.0)
    tm = LabelEmbedding(10, 32, 64)
    tm.load_state_dict(to_port(params), strict=True)
    assert float(tm.table.detach()[0].abs().min()) == 5.0
    out = tm(torch.from_numpy(labels))
    want = jm.apply(params, jnp.asarray(labels))
    assert rel_err(out.detach().numpy(), np.asarray(want)) <= 1e-5
    # Whatever row 0 holds, label 0 embeds the same (a zero row).
    with torch.no_grad():
        tm.table[0] = -7.0
        again = tm(torch.from_numpy(labels))
        tm.table[0] = 5.0
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)

    g = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))
    jgrad = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(labels))
                                       * g))(params)["params"]["table"]
    assert float(tm.table.grad[0].abs().max()) == 0.0
    assert rel_err(tm.table.grad.numpy(), np.asarray(jgrad)) <= 1e-5


def test_cfg_unet_matches_jax():
    """The forward on carried weights; the weights carry back to the flax
    tree's names and layouts unchanged (weights.flat_from_state_dict)."""
    jm, params, tm = cfg_pair()
    back = flat_from_state_dict(tm.state_dict())
    flat = flatten_params({"params": jax.tree_util.tree_map(
        np.asarray, params["params"])})
    assert back.keys() == flat.keys()
    for key, array in flat.items():
        np.testing.assert_array_equal(back[key], array, err_msg=key)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([0, 5, 9])
    labels = np.array([0, 3, 10])
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                             jnp.asarray(labels, jnp.int32))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(labels))
    assert got.shape == (3, SIZE, SIZE, 3) and got.dtype == torch.float32
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-5


def jax_step_draws(key, B, T, p_uncond):
    """The t, noise and label drop that JAX's cfg_train_step draws."""
    t_key, noise_key, drop_key, _ = jax.random.split(key, 4)
    return (np.array(jax.random.randint(t_key, (B,), 0, T)),
            np.array(jax.random.normal(noise_key, (B, SIZE, SIZE, 3),
                                       jnp.float32)),
            np.array(jax.random.bernoulli(drop_key, p_uncond, (B,))))


@pytest.mark.parametrize("mode", ["mean", "sum_div_b2", "unconditional"])
def test_cfg_train_step_matches_jax(mode):
    jm, params, tm = cfg_pair(seed=4)
    kw = dict(p_uncond=0.5, unconditional=mode == "unconditional",
              sum_div_b2=mode == "sum_div_b2")
    rng = np.random.default_rng(5)
    batch = {"image": rng.integers(0, 256, (4, SIZE, SIZE, 3), np.uint8),
             "label": rng.integers(0, 10, (4,)).astype(np.int32)}
    key = jax.random.PRNGKey(11)
    t, noise, drop = jax_step_draws(key, 4, TINY["T"], kw["p_uncond"])
    assert drop.any() and not drop.all()    # both label paths run
    jstep = jax_make_cfg_step(jax_schedule(1e-4, 0.028, TINY["T"]), **kw)
    jstate, jmetrics = jstep(jax_create_state(params, jm.apply, **HYPER),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             key)
    tstate = TrainState(tm, **HYPER)
    tstep = make_cfg_train_step(linear_beta_schedule(1e-4, 0.028, TINY["T"]),
                                **kw)
    tstate, tmetrics = tstep(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0), t=torch.from_numpy(t),
        noise=torch.from_numpy(noise), drop=torch.from_numpy(drop))
    jloss, tloss = float(jmetrics["loss"]), float(tmetrics["loss"])
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    mu = state_dict_from_flat(flatten_params(jax.tree_util.tree_map(
        np.asarray, jstate.opt_state[1][0].mu["params"])))
    top = max(float(v.abs().max()) for v in mu.values())
    for name, want in mu.items():
        want = want.numpy()
        got = tstate.moments(name)["exp_avg"].numpy()
        if not np.any(want):
            assert not np.any(got), name
        elif np.abs(want).max() <= ZERO_GRAD * top:
            # A term that a one-channel GroupNorm group removes.
            assert np.abs(got).max() <= 10 * ZERO_GRAD * top, name
        else:
            assert (np.linalg.norm(got - want) / np.linalg.norm(want)
                    <= 1e-3), name


def test_guided_eps_calls():
    """w = 0: one call of B on the labels as given; w > 0: one call of 2B on
    [labels, 0], mixed as (1+w)·ε_c − w·ε_u; both as JAX's."""
    jm, params, tm = cfg_pair()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    t, labels = np.array([4, 4]), np.array([2, 9])
    calls = []

    def denoise(x_, t_, l_):
        calls.append(l_.tolist())
        return tm(x_, t_, l_)

    apply = jax.jit(jm.apply)

    def jdenoise(x_, t_, l_):
        return apply(params, x_, t_, l_)

    for w in (0.0, 1.8):
        calls.clear()
        with torch.no_grad():
            got = _guided_eps(denoise, torch.from_numpy(x),
                              torch.from_numpy(t), torch.from_numpy(labels), w)
        want = jax_guided_eps(jdenoise, jnp.asarray(x),
                              jnp.asarray(t, jnp.int32),
                              jnp.asarray(labels, jnp.int32), w)
        assert calls == ([[2, 9]] if w == 0 else [[2, 9, 0, 0]])
        assert rel_err(got.numpy(), np.asarray(want)) <= (1 + 2 * w) * 1e-5


def test_cfg_chain_matches_jax_on_supplied_noise():
    """The whole T-step CFG chain at w 1.8 against JAX's cfg_ddpm_sample,
    the noise drawn with JAX as it draws it; every step is the ancestral
    step of JAX's ddpm_posterior_mean and ddpm_sampling_variance."""
    jm, params, tm = cfg_pair(seed=8)
    T = TINY["T"]
    labels = np.array([1, 5, 0])
    key = jax.random.PRNGKey(3)
    shape = (3, SIZE, SIZE, 3)
    sub, noise_key = jax.random.split(key)
    init = np.array(jax.random.normal(noise_key, shape, jnp.float32))
    steps = [torch.from_numpy(np.array(jax.random.normal(k, shape,
                                                        jnp.float32)))
             for k in jax.random.split(sub, T)]
    want = jax_cfg_sample(lambda x, t, l: jm.apply(params, x, t, l),
                          jax_schedule(1e-4, 0.028, T),
                          jnp.asarray(labels, jnp.int32), key,
                          image_size=SIZE, w=1.8)
    got = cfg_ddpm_sample(tm, linear_beta_schedule(1e-4, 0.028, T),
                          torch.from_numpy(labels), image_size=SIZE, w=1.8,
                          init_noise=torch.from_numpy(init), step_noise=steps)
    assert got.shape == shape and float(got.abs().max()) <= 1.0
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-4


def test_synthetic_labeled_dataset_bit_equal():
    ours, theirs = (SyntheticLabeledDataset(length=23, image_size=16, seed=3),
                    JaxSynthetic(length=23, image_size=16, seed=3))
    assert len(ours) == len(theirs) == 23
    for i in range(23):
        a, b = ours[i], theirs[i]
        assert a["label"] == b["label"] == i % 10
        np.testing.assert_array_equal(a["image"], b["image"])
    fallback = make_labeled_dataset("/nonexistent", synthetic_length=5,
                                    image_size=8)
    assert isinstance(fallback, SyntheticLabeledDataset) and len(fallback) == 5


def test_cifar10_dataset_reads_pickled_batches(tmp_path):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(9)
    for name, n in [(f"data_batch_{i}", 2) for i in range(1, 6)] + [
            ("test_batch", 3)]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)
    for train in (True, False):
        ours, theirs = (CIFAR10Dataset(str(tmp_path), train=train),
                        JaxCIFAR(str(tmp_path), train=train))
        assert len(ours) == len(theirs) == (10 if train else 3)
        np.testing.assert_array_equal(ours.images, theirs.images)
        np.testing.assert_array_equal(ours.labels, theirs.labels)
        assert ours[1]["image"].shape == (32, 32, 3)
    os.remove(base / "test_batch")
    with pytest.raises(FileNotFoundError) as ours_err:
        CIFAR10Dataset(str(tmp_path), train=False)
    with pytest.raises(FileNotFoundError) as theirs_err:
        JaxCIFAR(str(tmp_path), train=False)
    assert str(ours_err.value) == str(theirs_err.value)


def test_train_and_evaluate_end_to_end(tmp_path):
    """train_cfg (2 epochs, a checkpoint each), then evaluate_cfg from the
    last checkpoint and from the returned params: the same uint8 samples,
    and the PNG grid on disk."""
    config = tiny_config(tmp_path, epochs=2)
    summary = train_cfg(config)
    assert summary["steps"] == 4 and len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
    assert [os.path.basename(p) for p in summary["checkpoints"]] == [
        "ckpt_1_CFG_CIFAR10", "ckpt_2_CFG_CIFAR10"]
    from_params = evaluate_cfg(config, params=summary["params"],
                               save_png=False)
    from_ckpt = evaluate_cfg(config,
                             checkpoint_path=summary["checkpoints"][-1])
    assert from_ckpt.shape == (20, 16, 16, 3) and from_ckpt.dtype == np.uint8
    np.testing.assert_array_equal(from_params, from_ckpt)
    png = tmp_path / "out" / "SampledGuidenceImgs.png"
    grid = _png_decode(png.read_bytes())
    assert grid is not None and grid.shape == (160, 32, 3)
    np.testing.assert_array_equal(grid[:16, 16:], from_ckpt[1])


def test_cli_parse_matches_jax_and_runs(tmp_path):
    argv = ["--state", "eval", "--epochs", "3", "--channel_mult", "1", "2",
            "--no-bf16", "--unconditional", "--w", "0.5",
            "--data_root", "/data"]
    ours = dataclasses.asdict(parse_cfg_config(argv))
    theirs = dataclasses.asdict(jax_parse(argv))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert dataclasses.asdict(parse_cfg_config([])) == {
        **dataclasses.asdict(CFGConfig()), "channel_mult": [1, 2, 2, 2]}
    run = ["--device", "cpu", "--T", "4", "--channel", "32",
           "--channel_mult", "1", "--num_res_blocks", "1", "--img_size", "8",
           "--batch_size", "4", "--synthetic_length", "8", "--epochs", "1",
           "--nrow", "1", "--no-bf16", "--save_dir", str(tmp_path / "ck"),
           "--sampled_dir", str(tmp_path / "out")]
    assert main(["--state", "train"] + run) == 0
    assert (tmp_path / "ck" / "ckpt_1_CFG_CIFAR10").is_dir()
    assert main(["--state", "eval"] + run) == 0
    assert (tmp_path / "out" / "SampledGuidenceImgs.png").is_file()
    assert main(["--state", "bogus"] + run) == 2


def test_smoke_cfg_shapes_are_the_models():
    """chip_smoke.py's CFG_SHAPES are the attention shapes that CFGConfig()'s
    model hands the kernel, with their launches a call (21 in all)."""
    import collections

    import chip_smoke
    from hybrid_diffusion_tpu_torch.cfg.train import build_cfg_model
    from hybrid_diffusion_tpu_torch.models import blocks
    from hybrid_diffusion_tpu_torch.ops.attention import attention_reference

    seen = collections.Counter()

    def record(q, k, v):
        B, N, h, d = q.shape
        seen[N, d] += 1
        assert h == 8
        return attention_reference(q, k, v)

    config = CFGConfig(bf16=False, dropout=0.0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_cfg_model(config).eval()
    mp = pytest.MonkeyPatch()
    mp.setattr(blocks, "fused_spatial_attention", record)
    try:
        with torch.no_grad():
            model(torch.zeros(1, 32, 32, 3), torch.zeros(1, dtype=torch.long),
                  torch.zeros(1, dtype=torch.long))
    finally:
        mp.undo()
    assert dict(seen) == chip_smoke.CFG_SHAPES
    assert sum(seen.values()) == 21
    assert chip_smoke.CFG_BATCH == 2 * config.num_labels * config.nrow


def test_smoke_cfg_tolerance_covers_the_kernel_error_with_margin():
    """chip_smoke.py holds the bf16 kernel at the CFG shapes within
    CFG_RTOL of max|out|: at least 4 times the error of the kernel's CPU
    emulation (tests/test_torch_attention_tiled.py) at those shapes, on
    random inputs at a small batch (measured at most 3.4e-3)."""
    import chip_smoke
    from hybrid_diffusion_tpu_torch.ops.attention import attention_reference
    from test_torch_attention_tiled import tiled_attention

    rng = np.random.default_rng(0)
    for B, N, h, d, dname, inputs in chip_smoke.CFG_CASES:
        assert (dname, inputs) == ("bfloat16", "randn")
        packed = rng.standard_normal((1 if N > 256 else 4, N, 3, h, d))
        q, k, v = torch.from_numpy(packed.astype(np.float32)).to(
            torch.bfloat16).unbind(2)
        ref = attention_reference(q.float(), k.float(), v.float())
        err = (tiled_attention(q, k, v).float() - ref).abs().max().item()
        assert 4 * err <= chip_smoke.CFG_RTOL * ref.abs().max().item(), (N, d)
