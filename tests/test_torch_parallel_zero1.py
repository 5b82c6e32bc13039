"""ZeRO-1 on two ranks against the JAX package's ZeRO-1 on a 2-device mesh
(tests/test_parallel.py::test_zero1_optimizer_sharding and
::test_zero1_checkpoint_roundtrip), and train() / evaluate() through the
entry points at world 2 against one process.

The port's side runs as two gloo ranks spawned once for the file
(tests/_torch_dist.py::zero1_worker), while the test process computes the
JAX side:
  - one ZeRO-1 step with EMA (decay 0.5) at 2×1 from numpy-seeded weights
    (seed 12, as tests/test_torch_train_step.py), the same global batch, t
    and noise as JAX's (the draws of its key), the default loss weights
    without DINO (a second step would compare rounding: AdamW's first
    update moves a parameter by ±lr whatever the size of its gradient, and
    rounding decides the sign of the near-zero ones, as
    tests/test_torch_train_step.py sets out; grad_clip 1e-3 binds, which
    keeps most gradients clear of AdamW's ε): parameters, AdamW's moments
    and the EMA within
    ‖port − jax‖ ≤ 1e-3 ‖jax‖ per tensor (2e-3 for the second moment),
    the loss within rel 1e-5; tensors whose gradient is zero but for
    rounding (biases a one-channel GroupNorm removes) are bounded apart,
    as in tests/test_torch_parallel_step.py;
  - each rank keeps the moments and the EMA of the whole tensors it owns,
    the two ranks' sets disjoint and covering every parameter;
  - the checkpoint written at world 2 (rank 0 writes the gathered state)
    restores into a fresh ZeRO-1 state at world 2 and into a one-process
    state, both to the saved values exactly;
  - train() at world 2 (2×1, ZeRO-1, EMA, both stages with a save each,
    the export) takes the one-process run's steps on the same batches:
    each stage's last loss within rel 1e-5 of the one-process run's
    (dropout 0), its parameters within 2·lr an update (AdamW's rounding-
    decided moves of weights whose gradient is near zero); evaluate() of
    one npz at world 2 (the sharded sampler, a ragged last batch padded)
    gives the one-process metrics within 1e-6. The one-process run is a
    third spawned process, in no group, so that it runs beside the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    fast_compile, one_torch_thread, random_params, to_port)
from hybrid_diffusion_tpu.diffusion import linear_beta_schedule
from hybrid_diffusion_tpu.losses import CompositeLossConfig
from hybrid_diffusion_tpu.parallel import (
    make_mesh, make_sharded_train_step, shard_batch, shard_params,
    shard_state, state_shardings)
from hybrid_diffusion_tpu.train.step import make_train_step
from hybrid_diffusion_tpu.train.train_state import create_train_state
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.models import DynamicUNet
from hybrid_diffusion_tpu_torch.train.checkpoint import restore_state
from hybrid_diffusion_tpu_torch.train.train_state import TrainState
from hybrid_diffusion_tpu_torch.weights import save_npz_state_dict
from test_torch_parallel_step import (
    B, SIZE, TINY, ZERO_GRAD, jax_draws, jax_template, leaves, norm_rel)

HYPER = dict(lr=1e-3, weight_decay=1e-2, grad_clip=1e-3, total_epochs=4,
             steps_per_epoch=2, ema_decay=0.5)
LOOP_MODEL = dict(T=8, ch=32, ch_mult=(1, 2), num_res_blocks=1)
LOOP = dict(synthetic_data=True, synthetic_length=8, batch_size=4,
            img_size=16, channel=32, channel_mult=(1, 2), num_res_blocks=1,
            T=8, dino_weight=0.0, bf16=False, num_workers=1, device="cpu",
            dropout=0.0, ema_decay=0.5, zero1=True, epochs_stage_1=1,
            epochs_stage_2=1, save_checkpoint=1, sampler="dpm++2m",
            ddim_step=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, template = jax_template()
    params = random_params(template, 12)
    batches = [td.batch_arrays(50, B, SIZE, B // 2)]
    rngs = [jax.random.PRNGKey(60)]
    for b, rng in zip(batches, rngs):
        b["t"], b["noise"] = jax_draws(rng)
    work = tmp_path_factory.mktemp("zero1")
    # The evaluations' weights: the tiny U-Net's init at 16², as an npz.
    npz = str(work / "eval.npz")
    save_npz_state_dict(npz, DynamicUNet(**LOOP_MODEL).state_dict())

    def loop_spec(tag):
        return dict(config={**LOOP, "checkpoint_dir": str(work / tag / "ck"),
                            "output_path": str(work / tag / "out"),
                            "export_npz": str(work / tag / "w.npz")},
                    max_steps=4, evaluate_npz=npz)

    spec = dict(model={**TINY, "dropout": 0.0},
                params={k: v.numpy() for k, v in to_port(params).items()},
                batches=batches, hyper=HYPER, loss={},
                loop=loop_spec("world2"), one=loop_spec("one"))
    ranks = td.spawn_in_background(td.zero1_worker, 3, work, spec)

    # JAX's ZeRO-1 on the 2×1 mesh, pinned shardings.
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    copy = jax.tree_util.tree_map(jnp.array, params)
    state = shard_state(mesh, create_train_state(
        shard_params(mesh, copy), jm.apply, **HYPER), zero1=True)
    step = make_sharded_train_step(mesh, make_train_step(
        linear_beta_schedule(1e-4, 0.02, TINY["T"]), CompositeLossConfig(),
        domain_routing=True, jit=False),
        state_shardings=state_shardings(mesh, state, zero1=True))
    metrics = []
    for b, rng in zip(batches, rngs):
        state, m = fast_compile(step, state, shard_batch(mesh, {
            k: jnp.asarray(b[k]) for k in ("input", "gt")}), rng)
        metrics.append({k: float(v) for k, v in m.items()})
    adam = state.opt_state[1][0]
    jax_rec = dict(metrics=metrics, params=leaves(state.params["params"]),
                   mu=leaves(adam.mu["params"]), nu=leaves(adam.nu["params"]),
                   ema=leaves(state.ema_params["params"]))
    out = ranks.result()
    return dict(jax=jax_rec, ranks=out[:2], one=out[2]["one"])


def test_zero1_steps_equal_jax(runs):
    jx, pt = runs["jax"], runs["ranks"][0]["zero1"]
    for jm, pm in zip(jx["metrics"], pt["metrics"]):
        assert jm["underwater_gate"] == pm["underwater_gate"] == 1.0
        assert abs(pm["total"] - jm["total"]) <= 1e-5 * abs(jm["total"])
    largest = max(np.abs(v).max() for v in jx["mu"].values())
    compared = 0
    for name, mu in jx["mu"].items():
        if np.abs(mu).max() < ZERO_GRAD * largest:
            assert np.abs(pt["mu"][name]).max() < 10 * ZERO_GRAD * largest
            continue
        compared += 1
        assert norm_rel(pt["mu"][name], mu) <= 1e-3, name
        assert norm_rel(pt["nu"][name], jx["nu"][name]) <= 2e-3, name
        assert norm_rel(pt["params"][name], jx["params"][name]) <= 1e-3
        assert norm_rel(pt["ema"][name], jx["ema"][name]) <= 1e-3, name
    assert compared > 30


def test_zero1_partitions_moments_and_ema_by_whole_tensors(runs):
    r0, r1 = (r["zero1"] for r in runs["ranks"])
    names = set(r0["params"])
    assert set(r0["owned"]) | set(r1["owned"]) == names
    assert not set(r0["owned"]) & set(r1["owned"])
    for r in (r0, r1):
        assert r["with_moments"] == r["owned"] == r["ema_local"]
        assert r["local_shapes"] == r0["local_shapes"]   # params replicated


def _assert_same_state(a, b):
    for key in ("params", "mu", "nu", "ema"):
        assert a[key].keys() == b[key].keys(), key
        for n in a[key]:
            np.testing.assert_array_equal(a[key][n], b[key][n], err_msg=n)


def test_zero1_checkpoint_roundtrip_at_world_2(runs):
    rec = runs["ranks"][0]["zero1"]
    assert rec["restored_step"] == 1
    _assert_same_state(rec["restored"], rec)


def test_zero1_checkpoint_written_at_world_2_loads_at_world_1(runs):
    rec = runs["ranks"][0]["zero1"]
    state = TrainState(DynamicUNet(**TINY, dropout=0.0), **HYPER)
    restore_state(rec["path"], state, torch.Generator())
    assert state.step == 1
    loaded = td.numpy_tree(dict(
        params=dict(state.model.state_dict()),
        mu={n: state.moments(n)["exp_avg"] for n in state.params},
        nu={n: state.moments(n)["exp_avg_sq"] for n in state.params},
        ema=state.ema_params))
    _assert_same_state(loaded, rec)


def test_train_and_evaluate_at_world_2_equal_one_process(runs):
    world2, one = runs["ranks"][0]["loop"], runs["one"]
    assert world2["steps"] == one["steps"] == 4
    assert world2["stages"] == one["stages"] == ["Atmospheric", "Underwater"]
    for a, b in zip(world2["last_losses"], one["last_losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    # AdamW moves a weight by about lr an update whatever its gradient's
    # size, the sign of a near-zero one decided by rounding: two runs that
    # sum in other orders stay within 2·lr a step of each other.
    bound = 2 * Config().lr * world2["steps"]
    for name, p in one["params"].items():
        np.testing.assert_allclose(world2["params"][name], p, rtol=0,
                                   atol=bound, err_msg=name)
    assert runs["ranks"][1]["loop"]["results"] == {}     # rank 0 scores
    want = one["results"]
    assert world2["results"].keys() == want.keys() and want
    for domain, res in want.items():
        for k in ("psnr", "ssim", "uiqm", "n_images"):
            assert world2["results"][domain][k] == pytest.approx(
                res[k], rel=1e-6, abs=1e-6), (domain, k)
