"""Helpers shared by the training-slice parity tests (port vs JAX on the
CPU): weights made with numpy from a seed, carried to the port through
`weights.state_dict_from_flat`, and the error measure the tests bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu_torch.models import DynamicUNet
from hybrid_diffusion_tpu_torch.utils.params_io import flatten_params
from hybrid_diffusion_tpu_torch.weights import state_dict_from_flat

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests' tensors are tiny; torch's default of one thread a core,
    in each of the suite's parallel workers, only makes the threads spin
    against each other and against XLA's compiles. Restored after the
    module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The tiny U-Net of tests/test_train.py's tiny_setup, at 32².
TINY = dict(T=20, ch=32, ch_mult=(1, 2), num_res_blocks=1)
SIZE = 32


def rel_err(a, b) -> float:
    """max|a − b| / max|b| (b the JAX value); |a − b| when b is all zero."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / (scale if scale > 0 else 1.0))


def random_params(template, seed):
    """Numpy-seeded weights of a flax param template at unit-gain scale
    (flax's own init shrinks the tail to ~1e-5, which would hide most of
    the network from the comparison)."""
    rng = np.random.default_rng(seed)

    def leaf(path, t):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(t.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if len(t.shape) == 4 or (name == "kernel" and len(t.shape) == 2):
            return n / np.float32(np.sqrt(np.prod(t.shape[:-1])))
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(leaf, template)


def tiny_pair(seed=7, dropout=0.0, remat=False):
    """(JAX model, its params, the port's model with the same weights)."""
    jm = JaxUNet(**TINY, dropout=dropout)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, SIZE, SIZE, 6)),
                              jnp.zeros((1,), jnp.int32))
    params = random_params(template, seed)
    tm = DynamicUNet(**TINY, dropout=dropout, remat=remat)
    tm.load_state_dict(to_port(params), strict=True)
    return jm, params, tm


def to_port(params):
    """A flax variables dict -> the port's state_dict."""
    return state_dict_from_flat(flatten_params(
        jax.tree_util.tree_map(np.asarray, params["params"])))


def jax_leaves(tree):
    """{"a.b.c": np.ndarray} of a flax param subtree, keyed as the port's
    state_dict is (the leaf names mapped by `weights.py`)."""
    return state_dict_from_flat(flatten_params(
        jax.tree_util.tree_map(np.asarray, tree)))


def batch(seed, B=2, blue=True, size=SIZE):
    """A uint8 pair batch, blue-heavy (underwater) or red-heavy."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    img[..., 2 if blue else 0] = np.maximum(img[..., 2 if blue else 0], 200)
    return {"input": img, "gt": gt}


def fast_compile(jitted, *args):
    """jitted(*args), compiled at XLA:CPU's backend optimization level 0:
    the JAX references of the parallel tests (sharded train steps) compile
    in about 60% of the default's time, with the same numbers to fp32
    rounding (their bounds are 1e-5 and 1e-3)."""
    return jitted.lower(*args).compile(
        {"xla_backend_optimization_level": "0"})(*args)
