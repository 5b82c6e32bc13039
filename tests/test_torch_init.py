"""The port's U-Net init against the JAX model's (`models/torch_init.py`,
without it the flagship's training collapsed, PARITY.md's §2.9 stability
note), the torch → npz → JAX round trip of the
weights, and the training entry points' set-up.

Init: both models' samples against the rule the JAX code states for each
parameter (torch's default U(±1/√fan_in) kernels and biases; xavier-uniform
head and attention in_proj; xavier with gain 1e-5 for the tail; zero biases
for head, tail and both attention projections; GroupNorm scale 1, bias 0;
the sinusoid table). Each sample stays within its bound, and a parameter of
at least 1000 values has a std within 10% of the bound/√3 of a uniform
(a sample of 1000 misses it by ~2%).
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    SIZE, TINY, jax_leaves, one_torch_thread, tiny_pair)
from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from hybrid_diffusion_tpu_torch.config import Config
from hybrid_diffusion_tpu_torch.models.embeddings import sinusoidal_table
from hybrid_diffusion_tpu_torch.train import loop
from hybrid_diffusion_tpu_torch.weights import (
    flat_from_state_dict,
    load_npz_state_dict,
    save_npz_state_dict,
)

TINY_CONFIG = dict(T=TINY["T"], channel=TINY["ch"],
                   channel_mult=TINY["ch_mult"],
                   num_res_blocks=TINY["num_res_blocks"], img_size=SIZE,
                   bf16=False)


def fan_in(state, name):
    """The fan-in of the weight a parameter belongs to (OIHW or (out, in))."""
    prefix, leaf = name.rsplit(".", 1)
    weight = {"bias": "weight", "b3": "k3", "b5": "k5", "bt": "kt"}.get(leaf, leaf)
    w = state[f"{prefix}.{weight}"]
    return int(np.prod(w.shape[1:]))


def rule(state, name):
    """('zeros' | 'ones' | 'table' | bound) for a parameter, per the JAX code."""
    leaf = name.rsplit(".", 1)[1]
    if name.endswith("norm1.weight") or name.endswith("norm2.weight") \
            or name == "tail_norm.weight":
        return "ones"
    if name.endswith("norm1.bias") or name.endswith("norm2.bias") \
            or name == "tail_norm.bias":
        return "zeros"
    if name == "time_embedding.table":
        return "table"
    if name in ("head.bias", "tail_conv.bias") or name.endswith(
            ("attn.in_proj.bias", "attn.out_proj.bias")):
        return "zeros"
    if name in ("head.weight", "tail_conv.weight") or name.endswith(
            "attn.in_proj.weight"):
        w = state[name]
        receptive = int(np.prod(w.shape[2:])) if w.dim() == 4 else 1
        bound = math.sqrt(6.0 / (w.shape[0] * receptive + w.shape[1] * receptive))
        return bound * (1e-5 if name == "tail_conv.weight" else 1.0)
    return 1.0 / math.sqrt(fan_in(state, name))


@pytest.fixture(scope="module")
def inits():
    jm = JaxUNet(**TINY, dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 6)),
                              jnp.zeros((1,), jnp.int32))
    port = loop.init_params(Config(**TINY_CONFIG), device="cpu")
    return jax_leaves(params["params"]), port.state_dict()


@pytest.mark.parametrize("side", ["port", "jax"])
def test_init_follows_the_jax_rules(inits, side):
    ref, port = inits
    assert set(ref) == set(port)
    sample = port if side == "port" else ref
    table = torch.from_numpy(sinusoidal_table(TINY["T"], TINY["ch"]))
    checked = 0
    for name, x in sample.items():
        r = rule(port, name)
        if r == "zeros":
            assert not x.any(), name
        elif r == "ones":
            assert (x == 1).all(), name
        elif r == "table":
            torch.testing.assert_close(x, table, rtol=0, atol=0)
        else:
            assert float(x.abs().max()) <= r, (name, float(x.abs().max()), r)
            if x.numel() >= 50:
                assert float(x.abs().max()) >= 0.9 * r, name
            if x.numel() >= 1000:
                assert float(x.std()) == pytest.approx(r / math.sqrt(3),
                                                       rel=0.1), name
                checked += 1
    assert checked >= 20


def test_init_is_seeded_and_leaves_the_global_generator():
    state = torch.get_rng_state()
    a = loop.init_params(Config(**TINY_CONFIG, seed=3), device="cpu")
    b = loop.init_params(Config(**TINY_CONFIG, seed=3), device="cpu")
    assert torch.equal(torch.get_rng_state(), state)
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("dtype", ["float16", "float32"])
def test_torch_to_npz_to_jax_round_trip(tmp_path, dtype):
    """A port state_dict written as a flat npz loads into JAX's
    `load_params_npz` against the JAX model's template, every array the
    port's (rounded to fp16 when stored so), and back into the port."""
    jm, params, tm = tiny_pair(seed=4)
    path = tmp_path / "w.npz"
    save_npz_state_dict(path, tm.state_dict(), dtype=dtype)
    loaded = jax_load_npz(str(path), template=params)
    jax_flat = jax_leaves(loaded["params"])
    for name, x in tm.state_dict().items():
        want = x.numpy().astype(dtype).astype(np.float32)
        np.testing.assert_array_equal(jax_flat[name].numpy(), want)
    back = load_npz_state_dict(path)
    for name, x in tm.state_dict().items():
        np.testing.assert_array_equal(back[name].numpy(),
                                      x.numpy().astype(dtype).astype(np.float32))
    assert set(flat_from_state_dict(tm.state_dict())) == {
        "params/" + p for p in _flax_paths(params["params"])}


def _flax_paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out += _flax_paths(v, p) if isinstance(v, dict) else [p]
    return out


def test_init_params_warm_starts_from_npz(tmp_path):
    _, _, tm = tiny_pair(seed=4)
    path = tmp_path / "w.npz"
    save_npz_state_dict(path, tm.state_dict(), dtype="float32")
    model = loop.init_params(Config(**TINY_CONFIG, init_from_npz=str(path)),
                             device="cpu")
    for name, x in tm.state_dict().items():
        assert torch.equal(model.state_dict()[name], x), name


def test_training_entry_points_default_to_cuda_and_raise_without_a_card(
        monkeypatch):
    for fn in (loop.init_params, loop.make_dino):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**TINY_CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.make_dino(cfg)


def test_train_state_from_config():
    cfg = Config(**TINY_CONFIG, lr=2e-4, ema_decay=0.5, epochs_stage_1=10)
    model = loop.init_params(cfg, device="cpu")
    state = loop.create_train_state(cfg, model, steps_per_epoch=3)
    assert state.schedule(0) == pytest.approx(2e-4)
    assert state.schedule(3) == pytest.approx(4e-4)     # warmup ×2 over 1 epoch
    assert state.ema_params is not None and state.step == 0
    assert loop.make_dino(Config(**TINY_CONFIG, dino_weight=0.0),
                          device="cpu") is None
