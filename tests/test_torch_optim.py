"""The port's optimizer, schedule, domain gates and remat against the JAX
package, on the CPU in fp32.

  - `warmup_cosine_schedule` equals the JAX schedule at every step of three
    epochs and beyond, to two float32 ulps of the peak lr (both compute in
    float32; their cos differ by an ulp);
  - three updates of `TrainState` + the step's gated update against optax's
    chain (clip_by_global_norm, adamw) with the JAX step's
    `apply_domain_gates`, `blend_by_gates` and `update_ema`, fed identical
    gradients, gates open and closed: AdamW's moments rel ≤ 1e-5 per
    parameter (fp32 arithmetic in another order), the parameters and the EMA
    within 1e-5 of their change plus 4 ulps of the parameter per update;
  - remat on and off give the same gradients at dropout 0.3 (rel ≤ 1e-6):
    the dropout masks are drawn before the recomputed region.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from _torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    SIZE, jax_leaves, one_torch_thread, rel_err, tiny_pair)
from hybrid_diffusion_tpu.models.unet import (
    domain_gates_from_batch as jax_domain_gates,
)
from hybrid_diffusion_tpu.train.schedule import (
    warmup_cosine_schedule as jax_warmup_cosine,
)
from hybrid_diffusion_tpu.train.step import (
    apply_domain_gates as jax_apply_gates,
    blend_by_gates as jax_blend,
)
from hybrid_diffusion_tpu.train.train_state import (
    create_train_state as jax_create_state,
)
from hybrid_diffusion_tpu_torch.models.unet import domain_gates_from_batch
from hybrid_diffusion_tpu_torch.train.schedule import warmup_cosine_schedule
from hybrid_diffusion_tpu_torch.train.step import gated_update
from hybrid_diffusion_tpu_torch.train.train_state import TrainState


@pytest.mark.parametrize("total,per_epoch,mult,warm",
                         [(3, 4, 2.0, None), (30, 2, 2.0, None),
                          (3, 5, 1.5, 1), (10, 3, 2.0, 4)])
def test_warmup_cosine_matches_jax(total, per_epoch, mult, warm):
    ours = warmup_cosine_schedule(5e-5, total, per_epoch, mult, warm)
    ref = jax_warmup_cosine(5e-5, total, per_epoch, mult, warm)
    for step in range((total + 2) * per_epoch):
        want = float(ref(step))
        # Two float32 ulps of the peak lr: numpy's and XLA's cos differ by
        # an ulp, which 1 + cos magnifies near the end of the cosine.
        assert abs(ours(step) - want) <= 2.4e-7 * 5e-5 * mult, step


class Toy(nn.Module):
    """Four middle blocks and two other layers, named as the U-Net's."""

    def __init__(self):
        super().__init__()
        for i in range(4):
            self.add_module(f"middle_{i}", nn.Linear(5, 4))
        self.head = nn.Linear(3, 5)
        self.tail = nn.Linear(4, 2)


def toy_tree(model):
    """The toy's parameters as a flax tree (Dense kernels are (in, out))."""
    return {"params": {name: {"kernel": jnp.array(m.weight.detach().numpy().T),
                              "bias": jnp.array(m.bias.detach().numpy())}
                       for name, m in model.named_children()}}


HYPER = dict(lr=1e-2, weight_decay=1e-2, grad_clip=1.0, total_epochs=3,
             steps_per_epoch=1, multiplier=2.0, ema_decay=0.9)
# Per update: the gates (None: routing off) and the gradients' scale, so
# that the clip acts on some updates and not on others.
UPDATES = [([1.0, 0.0, 1.0, 0.0], 3.0), ([0.0, 1.0, 0.0, 1.0], 0.05),
           (None, 1.0), ([1.0, 0.0, 1.0, 0.0], 0.2)]


@pytest.fixture(scope="module")
def updates():
    torch.manual_seed(0)
    model = Toy()
    state = TrainState(model, **HYPER)
    jstate = jax_create_state(toy_tree(model), None, **HYPER)
    rng = np.random.default_rng(0)
    records = []
    for gates, scale in UPDATES:
        before = {n: p.detach().clone() for n, p in state.params.items()}
        grads = {n: (scale * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in state.params.items()}
        for n, p in state.params.items():
            p.grad = torch.from_numpy(grads[n].copy())
        g = None if gates is None else torch.tensor(gates)
        norm = float(gated_update(state, g))
        jgrads = {"params": {c: {"kernel": jnp.asarray(grads[f"{c}.weight"].T),
                                 "bias": jnp.asarray(grads[f"{c}.bias"])}
                             for c in dict(model.named_children())}}
        old = jstate
        if gates is not None:
            jgrads = jax_apply_gates(jgrads, jnp.asarray(gates))
        jstate = jstate.apply_gradients(jgrads)
        if gates is not None:
            jg = jnp.asarray(gates)
            jstate = jstate.replace(
                params=jax_blend(jstate.params, old.params, jg),
                opt_state=jax_blend(jstate.opt_state, old.opt_state, jg))
        jstate = jstate.update_ema()
        adam = jstate.opt_state[1][0]
        records.append(dict(
            gates=gates, before=before, norm=norm,
            jnorm=float(jnp.sqrt(sum(jnp.sum(x ** 2) for x in
                                     jax.tree_util.tree_leaves(jgrads)))),
            port=dict(params={n: p.detach().clone()
                              for n, p in state.params.items()},
                      mu={n: state.moments(n)["exp_avg"].clone()
                          for n in state.params},
                      nu={n: state.moments(n)["exp_avg_sq"].clone()
                          for n in state.params},
                      ema={n: e.clone() for n, e in state.ema_params.items()}),
            jax=dict(params=jax_leaves(jstate.params["params"]),
                     mu=jax_leaves(adam.mu["params"]),
                     nu=jax_leaves(adam.nu["params"]),
                     ema=jax_leaves(jstate.ema_params["params"]))))
    return records


@pytest.mark.parametrize("i", range(len(UPDATES)))
@pytest.mark.parametrize("what", ["params", "mu", "nu", "ema"])
def test_updates_match_optax(updates, i, what):
    r = updates[i]
    assert abs(r["norm"] - r["jnorm"]) <= 1e-6 * r["jnorm"]
    for name, ref in r["jax"][what].items():
        got, ref = r["port"][what][name].numpy(), ref.numpy()
        if what in ("params", "ema"):
            # torch's AdamW decays p, then adds the step; optax adds one
            # update: each update rounds p once more on one side, so the
            # change may also differ by an ulp of p per update.
            base = r["before"][name].numpy()
            ulps = 4 * (i + 1) * float(np.spacing(np.abs(base).max()))
            assert np.abs(got - ref).max() <= (
                1e-5 * np.abs(ref - base).max() + ulps), name
        else:
            assert rel_err(got, ref) <= 1e-5, name


@pytest.mark.parametrize("i", [0, 1, 3])
def test_gated_updates_freeze_blocks(updates, i):
    r = updates[i]
    for m, gate in enumerate(r["gates"]):
        for leaf in ("weight", "bias"):
            name = f"middle_{m}.{leaf}"
            new, old = r["port"]["params"][name], r["before"][name]
            assert torch.equal(new, old) == (gate == 0.0), name


def test_clip_is_optax_form_without_epsilon():
    """At a global norm of 2e-6 and a max_norm of 1e-6 optax halves the
    gradients; torch's clip_grad_norm_ (÷ (‖g‖ + 1e-6)) would take a third."""
    model = nn.Linear(2, 1, bias=False)
    state = TrainState(model, **{**HYPER, "grad_clip": 1e-6})
    model.weight.grad = torch.tensor([[1.2e-6, 1.6e-6]])
    norm = float(state.clip_by_global_norm())
    assert norm == pytest.approx(2e-6, rel=1e-6)
    assert float(model.weight.grad.norm()) == pytest.approx(1e-6, rel=1e-6)


def test_grad_accum_is_not_ported():
    """The name is historical: grad_accum > 1 raised NotImplementedError
    here until it was ported (optax.MultiSteps, held against optax in
    tests/test_torch_loop.py). The test now checks that the state keeps a
    running mean of the gradients and starts at micro-step 0."""
    state = TrainState(nn.Linear(2, 2), grad_accum=2)
    assert state.grad_accum == 2 and state.mini_step == 0
    assert set(state.acc_grads) == set(state.params)


@pytest.mark.parametrize("blue", [True, False])
def test_domain_gates_match_jax(blue):
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    img[..., 2 if blue else 0] += 0.5
    ref = np.asarray(jax_domain_gates(jnp.asarray(img)))
    ours = domain_gates_from_batch(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.tolist() == ([1, 0, 1, 0] if blue else [0, 1, 0, 1])


def _dropout_grads(remat: bool, seed: int):
    _, _, model = tiny_pair(seed=5, dropout=0.3, remat=remat)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, SIZE, SIZE, 6)).astype(np.float32))
    t = torch.tensor([3, 17])
    global_state = torch.get_rng_state()
    out = model(x, t, train=True, generator=torch.Generator().manual_seed(seed))
    (out ** 2).mean().backward()
    assert torch.equal(torch.get_rng_state(), global_state)  # no global draws
    return out.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_remat_keeps_dropout_masks_and_grads():
    """Remat on and off, the same generator seed: the same output and the
    same gradients (rel ≤ 1e-6). A mask redrawn in the recomputation would
    change the gradients by O(1)."""
    out, plain = _dropout_grads(remat=False, seed=9)
    out_r, remat = _dropout_grads(remat=True, seed=9)
    torch.testing.assert_close(out_r, out, rtol=0, atol=0)
    for name, g in plain.items():
        assert rel_err(remat[name].numpy(), g.numpy()) <= 1e-6, name


def test_dropout_draws_from_the_generator_only_in_train_mode():
    _, _, model = tiny_pair(seed=5, dropout=0.3)
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (1, SIZE, SIZE, 6)).astype(np.float32))
    t = torch.tensor([3])
    run = lambda seed, train=True: model(
        x, t, train=train, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        assert torch.equal(run(1), run(1))
        assert not torch.equal(run(1), run(2))
        assert torch.equal(run(1, train=False), run(2, train=False))
        assert not torch.equal(run(1), run(1, train=False))
        with pytest.raises(ValueError, match="generator"):
            model(x, t, train=True)
