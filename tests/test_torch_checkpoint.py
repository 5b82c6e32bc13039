"""The port's checkpoints: decisions against the JAX package's, and the
save/restore round trip (CPU).

Tolerances: the decisions (names, subtree choice, EMA init mass) are
compared for equality with the JAX functions' results over a grid of
inputs; the round trip is bit-exact (torch.equal) for parameters, AdamW
moments and count, step, running mean, EMA and the generator's state.
"""

import itertools
import os
import time

import numpy as np
import pytest
import torch

from hybrid_diffusion_tpu.train import checkpoint as jck
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.train import checkpoint as tck
from hybrid_diffusion_tpu_torch.train import loop

from _torch_parity import one_torch_thread  # noqa: F401

TINY = dict(T=8, channel=32, channel_mult=(1, 2), num_res_blocks=1,
            img_size=16, bf16=False, dropout=0.0, dino_weight=0.0,
            ms_ssim_weight=0.0, color_weight=0.0)


def test_names_and_subtree_decisions_equal_jax():
    for epoch, stage, tag in itertools.product(
            (0, 7, 200), ("Atmospheric", "Underwater_final_0101"),
            ("HICRDLoLI", "")):
        assert (tck.checkpoint_name(epoch, stage, tag)
                == jck.checkpoint_name(epoch, stage, tag))
    probes = (None, {}, {"step": 5, "psnr": 10.0},
              {"step": 5, "psnr": 10.0, "psnr_ema": 9.5},
              {"step": 5, "psnr": 10.0, "psnr_ema": 10.0})
    for has_ema, step, decay, probe in itertools.product(
            (False, True), (None, 0, 10, 5000), (None, 0.0, 0.9, 0.9999),
            probes):
        assert (tck.choose_subtree_from_evidence(has_ema, step, decay, probe)
                == jck.choose_subtree_from_evidence(has_ema, step, decay,
                                                    probe))
        meta = {"step": step, "ema_decay": decay}
        assert tck.ema_init_mass(meta) == jck.ema_init_mass(meta)
    assert tck.EMA_INIT_MASS_THRESHOLD == jck.EMA_INIT_MASS_THRESHOLD


def _trained_state(grad_accum=1, steps=3):
    cfg = Config(**TINY, ema_decay=0.9, grad_accum=grad_accum, device="cpu")
    model = loop.init_params(cfg, "cpu")
    state = loop.create_train_state(cfg, model, steps_per_epoch=2)
    step = loop.make_train_step(
        loop.linear_beta_schedule(cfg.beta_1, cfg.beta_T, cfg.T),
        cfg.loss_config)
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        batch = {k: rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
                 for k in ("input", "gt")}
        state, _ = step(state, batch, gen)
    return cfg, state, gen


def _assert_same_state(a, b):
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.moments(n)[k], b.moments(n)[k]), (n, k)
        assert torch.equal(a.optimizer.state[a.params[n]]["step"],
                           b.optimizer.state[b.params[n]]["step"])
        assert torch.equal(a.ema_params[n], b.ema_params[n]), n
        if a.acc_grads is not None:
            assert torch.equal(a.acc_grads[n], b.acc_grads[n]), n
    assert (a.step, a.mini_step) == (b.step, b.mini_step)


@pytest.mark.parametrize("grad_accum,block", [(1, True), (2, False)])
def test_full_state_round_trip_bit_exact(tmp_path, grad_accum, block):
    """params, AdamW moments and count, step, EMA, the running mean
    (grad_accum 2, stopped between updates) and the generator, with the
    blocking and the background save."""
    cfg, state, gen = _trained_state(grad_accum, steps=3)
    path = tck.save_checkpoint(str(tmp_path), 1, "Atmospheric", "HL", state,
                               metadata={"stage": "Atmospheric"},
                               block=block, generator=gen)
    tck.wait_for_checkpoints()
    assert os.path.basename(path) == "ckpt_1_Atmospheric_HL"
    meta = tck.load_metadata(path)
    assert meta["has_ema"] and meta["step"] == state.step
    assert meta["ema_decay"] == 0.9 and meta["stage"] == "Atmospheric"
    assert tck.checkpoint_has_ema(path)
    draw = torch.randn(5, generator=gen)

    fresh = loop.create_train_state(cfg, loop.init_params(
        Config(**{**TINY, "seed": 9}, device="cpu"), "cpu"), steps_per_epoch=2)
    fresh_gen = torch.Generator()
    tck.restore_state(path, fresh, fresh_gen)
    _assert_same_state(state, fresh)
    assert torch.equal(torch.randn(5, generator=fresh_gen), draw)

    # Parameters only: the subtree by evidence (EMA after 3 steps at 0.9 is
    # immature: raw), and a partial restore of both subtrees.
    model = loop.build_model(cfg)
    tck.restore_params(path, model)
    for n, p in model.named_parameters():
        assert torch.equal(p, state.params[n]), n
    part = tck.restore_partial(path, ("params", "ema_params", "nothing"))
    assert set(part) == {"params", "ema_params"}
    for n, e in state.ema_params.items():
        assert torch.equal(part["ema_params"][n], e)


def test_never_clobber_and_uncommitted_saves_skipped(tmp_path):
    _, state, _ = _trained_state(steps=1)
    a = tck.save_checkpoint(str(tmp_path), 3, "Joint", "D", state)
    time.sleep(0.01)
    b = tck.save_checkpoint(str(tmp_path), 3, "Joint", "D", state)
    assert b == a + "-2" and os.path.isdir(a) and os.path.isdir(b)
    assert tck.find_checkpoint(str(tmp_path), 3) == b
    assert tck.find_checkpoint(str(tmp_path), 4) is None
    time.sleep(0.01)
    # A save killed before its rename: newest, but never picked.
    (tmp_path / f"ckpt_4_Joint_D{tck._TMP_MARK}123").mkdir()
    assert tck.find_latest_checkpoint(str(tmp_path)) == b
    assert tck.find_checkpoint(str(tmp_path), 4) is None
    assert tck.find_latest_checkpoint(str(tmp_path / "none")) is None


def test_restore_params_prefers_mature_or_probed_ema(tmp_path):
    cfg, state, _ = _trained_state(steps=1)
    with torch.no_grad():
        for e in state.ema_params.values():
            e.add_(1.0)
    path = tck.save_checkpoint(str(tmp_path), 1, "S", "D", state,
                               metadata={"probe": {"step": 1, "psnr": 5.0,
                                                   "psnr_ema": 6.0}})
    assert tck.choose_restore_subtree(path)[0] == "ema_params"
    model = tck.restore_params(path, loop.build_model(cfg))
    for n, p in model.named_parameters():
        assert torch.equal(p, state.ema_params[n]), n
