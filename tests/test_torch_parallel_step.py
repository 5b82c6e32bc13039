"""The port's sharded train step at W ranks against the JAX package's
`make_sharded_train_step` on a W-device mesh, at the same global batch,
and the batch-sharded sampler against `make_sharded_sampler`.

The JAX side runs on tests/conftest.py's virtual CPU devices; the port's
as gloo ranks spawned on the CPU (tests/_torch_dist.py), once for the file:
ranks 0-1 take a DP step on a 2×1 mesh and run the sampler, then all four
a TP+DP step on a 2×2 mesh (the attention head-sharded over "model").

The cases are built so that a port that reduced over its own rows alone
fails:
  - the batch's first half (rank 0's rows) is strongly blue, the second
    (rank 1's) mildly red, and the whole batch blue: per-rank domain gates
    would train other middle blocks on rank 1;
  - grad_clip 1e-3 binds (the global norm is about 0.2): a clip by a
    per-rank norm (under TP, one that left out the other rank's heads)
    would scale the gradients otherwise;
  - the default loss weights (without the DINO term: no extractor is
    passed, as JAX's dryrun does) at 32², where MS-SSIM has two scales, so
    its product of per-scale batch means is not linear in them, and rank
    1's clean images are smooth ramps against rank 0's noise, so the two
    halves' means differ; the DP case takes the default reduce (MS-SSIM's
    means over the batch), the TP+DP case `aux_snr_weight` (Σwᵢlᵢ / Σwᵢ
    over the batch).
A copy of the port with each of these reductions made per rank (the
gates, the TP clip's norm, MS-SSIM's means, the aux-SNR reduce) fails at
least one test here.

Both sides start from the same numpy-seeded weights (seed 12 of
tests/_torch_parity.py::random_params, as tests/test_torch_train_step.py)
and take the same global t and noise (the draws of JAX's key). Bounds, as
for the one-process step (tests/test_torch_train_step.py):
  - the loss: rel 1e-5;
  - AdamW's first moment after one update (0.1 × the gated, clipped
    gradient), its second moment, and the parameters: ‖port − jax‖ ≤ 1e-3
    ‖jax‖ per tensor (2e-3 for the second moment). A few biases feed a
    GroupNorm of one channel a group, which removes them: their gradient
    is zero but for rounding, and both sides stay below ZERO_GRAD of the
    largest;
  - the gates and the underwater flag: exactly.
The sampler (DPM++2M-5, 4 images at 32², fp32, T 20) on JAX's initial
noise: within 1e-5.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as td
from _torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    fast_compile, jax_leaves, one_torch_thread, random_params, to_port)
from hybrid_diffusion_tpu.config import Config as JaxConfig
from hybrid_diffusion_tpu.diffusion import linear_beta_schedule
from hybrid_diffusion_tpu.losses import CompositeLossConfig
from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu.parallel import (
    make_mesh, make_sharded_train_step, shard_batch, shard_params,
    shard_state)
from hybrid_diffusion_tpu.train import loop as jloop
from hybrid_diffusion_tpu.train.step import make_train_step
from hybrid_diffusion_tpu.train.train_state import create_train_state

TINY = dict(T=20, ch=32, ch_mult=(1, 2), num_res_blocks=1)
B, SIZE = 4, 32
HYPER = dict(lr=1e-3, weight_decay=1e-2, grad_clip=1e-3, total_epochs=4,
             steps_per_epoch=1, ema_decay=0.9)
LOSSES = {"dp": dict(aux_snr_weight=False), "tpdp": dict(aux_snr_weight=True)}
MESHES = {"dp": (2, 1), "tpdp": (2, 2)}
ZERO_GRAD = 1e-6
SAMPLER = dict(T=20, channel=32, channel_mult=(1, 2), num_res_blocks=1,
               bf16=False, sampler="dpm++2m", ddim_step=5, dropout=0.0)


def jax_draws(rng):
    """The global t and noise that JAX's step draws from `rng`."""
    t_rng, noise_rng, _, _ = jax.random.split(rng, 4)
    return (np.array(jax.random.randint(t_rng, (B,), 0, TINY["T"])),
            np.array(jax.random.normal(noise_rng, (B, SIZE, SIZE, 3))))


def leaves(tree) -> dict:
    """A flax param subtree as numpy arrays under the port's names."""
    return {k: v.numpy() for k, v in jax_leaves(tree).items()}


def jax_template():
    jm = JaxUNet(**TINY, dropout=0.0)
    return jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, SIZE, SIZE, 6)),
                              jnp.zeros((1,), jnp.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, template = jax_template()
    params = random_params(template, 12)
    batch = td.batch_arrays(30, B, SIZE, B // 2)
    rng = jax.random.PRNGKey(40)
    t, noise = jax_draws(rng)
    cond = batch["input"]
    srng = jax.random.PRNGKey(41)
    init_noise = np.array(jax.random.normal(jax.random.split(srng)[1],
                                            cond.shape, jnp.float32))
    port_params = {k: v.numpy() for k, v in to_port(params).items()}
    spec = dict(
        model={**TINY, "dropout": 0.0}, params=port_params,
        batches=[{**batch, "t": t, "noise": noise}], hyper=HYPER,
        sampler=dict(config={**SAMPLER, "device": "cpu"}, cond=cond,
                     init_noise=init_noise))
    # One spawn of 4 ranks, running while the JAX side computes: the dp
    # case on ranks 0-1 (and the sampler), then tpdp on all four.
    spec["loss_by_case"] = LOSSES
    ranks = td.spawn_in_background(td.step_worker, 4,
                                   tmp_path_factory.mktemp("step"), spec)

    def jax_case(case):
        data, model = MESHES[case]
        mesh = make_mesh(data, model, devices=jax.devices()[:data * model])
        copy = jax.tree_util.tree_map(jnp.array, params)
        state = shard_state(mesh, create_train_state(
            shard_params(mesh, copy), jm.apply, **HYPER))
        step = make_sharded_train_step(mesh, make_train_step(
            linear_beta_schedule(1e-4, 0.02, TINY["T"]),
            CompositeLossConfig(**LOSSES[case]), domain_routing=True,
            jit=False))
        state, metrics = fast_compile(step, state, shard_batch(mesh, {
            k: jnp.asarray(v) for k, v in batch.items()}), rng)
        adam = state.opt_state[1][0]
        return dict(metrics={k: float(v) for k, v in metrics.items()},
                    params=leaves(state.params["params"]),
                    mu=leaves(adam.mu["params"]),
                    nu=leaves(adam.nu["params"]))

    # The two JAX references compile side by side (XLA releases the GIL).
    with ThreadPoolExecutor(2) as pool:
        records = {case: {"jax": rec} for case, rec in
                   zip(MESHES, pool.map(jax_case, MESHES))}
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    sample = jloop.make_sampler(JaxConfig(**SAMPLER), jm, params, mesh=mesh)
    jax_images = np.asarray(sample(jnp.asarray(cond), srng))
    port = ranks.result()[0]
    for case in MESHES:
        records[case]["port"] = port[case]
    records["sampler"] = dict(jax=jax_images, port=port["dp"]["sample"])
    return records


def norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", ["dp", "tpdp"])
def test_sharded_step_loss_and_gates_equal_jax(runs, case):
    jm, pm = runs[case]["jax"]["metrics"], runs[case]["port"]["metrics"][0]
    assert jm["underwater_gate"] == pm["underwater_gate"] == 1.0
    for k in ("total", "mse", "ms_ssim", "color"):
        assert abs(pm[k] - jm[k]) <= 1e-5 * max(abs(jm[k]), 1.0), (k, pm, jm)
    assert abs(pm["grad_norm"] - jm["grad_norm"]) <= 1e-4 * jm["grad_norm"]


@pytest.mark.parametrize("case", ["dp", "tpdp"])
def test_sharded_step_gradients_and_moments_equal_jax(runs, case):
    jx, pt = runs[case]["jax"], runs[case]["port"]
    largest = max(np.abs(v).max() for v in jx["mu"].values())
    worst = {}
    for name, mu in jx["mu"].items():
        if np.abs(mu).max() < ZERO_GRAD * largest:
            assert np.abs(pt["mu"][name]).max() < 10 * ZERO_GRAD * largest
            continue
        worst[name] = (norm_rel(pt["mu"][name], mu),
                       norm_rel(pt["nu"][name], jx["nu"][name]))
    assert len(worst) > 30
    assert max(w[0] for w in worst.values()) <= 1e-3, worst
    assert max(w[1] for w in worst.values()) <= 2e-3, worst


@pytest.mark.parametrize("case", ["dp", "tpdp"])
def test_sharded_step_parameters_equal_jax(runs, case):
    jx, pt = runs[case]["jax"], runs[case]["port"]
    for name, p in jx["params"].items():
        assert norm_rel(pt["params"][name], p) <= 1e-3, name


def test_tp_shards_the_attention_by_head(runs):
    """Under 2×2 each rank holds half the heads of every attention block:
    in_proj (3C/2, C) and out_proj (C, C/2); the rest whole."""
    shapes = runs["tpdp"]["port"]["local_shapes"]
    full = runs["dp"]["port"]["local_shapes"]
    for name, shape in shapes.items():
        if ".attn.in_proj" in name:
            assert shape[0] * 2 == full[name][0]
        elif name.endswith(".attn.out_proj.weight"):
            assert shape == (full[name][0], full[name][1] // 2)
        else:
            assert shape == full[name], name


def test_sharded_sampler_equals_jax(runs):
    jx, pt = runs["sampler"]["jax"], runs["sampler"]["port"]
    assert pt.shape == jx.shape == (B, SIZE, SIZE, 3)
    np.testing.assert_allclose(pt, jx, atol=1e-5, rtol=0)
