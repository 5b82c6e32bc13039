"""The port's model pieces and DynamicUNet against the JAX package, in fp32
on the CPU, on the same weights and inputs (made with numpy from a seed).

Tolerances: the two frameworks sum convolutions in different orders, so an
fp32 result differs by a few ulps of its largest partial sums. Each check
states its bound as max|port − jax| / max|jax| (rel) or absolute (atol).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu.models.embeddings import (
    ImageConditionEmbedding as JaxCondEmb,
    TimeEmbedding as JaxTimeEmb,
    sinusoidal_table as jax_sinusoidal_table,
)
from hybrid_diffusion_tpu.ops.fast_conv import (
    conv_transpose_5x5_s2 as jax_conv_transpose,
    fused_dual_downsample as jax_dual_downsample,
)
from hybrid_diffusion_tpu.ops.resize import nearest_resize as jax_nearest_resize
from hybrid_diffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from hybrid_diffusion_tpu_torch.models import DynamicUNet
from hybrid_diffusion_tpu_torch.models.embeddings import (
    ImageConditionEmbedding,
    TimeEmbedding,
    sinusoidal_table,
)
from hybrid_diffusion_tpu_torch.models.layers import same_pad
from hybrid_diffusion_tpu_torch.ops.fast_conv import (
    conv_transpose_5x5_s2,
    fused_dual_downsample,
)
from hybrid_diffusion_tpu_torch.ops.resize import nearest_resize
from hybrid_diffusion_tpu_torch.utils.params_io import flatten_params
from hybrid_diffusion_tpu_torch.weights import (
    load_npz_state_dict,
    state_dict_from_flat,
)

REPO = Path(__file__).resolve().parent.parent
R5_NPZ = REPO / "docs" / "assets" / "flagship256_r5_fp16.npz"


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def random_params(template, seed):
    """Numpy-seeded weights of a flax param template, at unit-gain scale
    (flax's own init zeroes biases and shrinks the tail to ~1e-5, which
    would hide most of the network from the comparison)."""
    rng = np.random.default_rng(seed)

    def leaf(path, t):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(t.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if len(t.shape) == 4 or (name == "kernel" and len(t.shape) == 2):
            return n / np.sqrt(np.prod(t.shape[:-1]))
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(leaf, template)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("shape,cout", [((2, 4, 4, 8), 8), ((1, 5, 3, 4), 6)])
def test_conv_transpose_matches_both_jax_forms(shape, cout):
    """The 4-phase conv transpose == the JAX 4-phase form and
    lax.conv_transpose SAME (rel ≤ 1e-5: fp32, different sum orders)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    kt = rng.standard_normal((5, 5, shape[-1], cout)).astype(np.float32)
    fast = np.asarray(jax_conv_transpose(jnp.asarray(x), jnp.asarray(kt)))
    lax_t = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(kt), strides=(2, 2), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    ours = conv_transpose_5x5_s2(nhwc_to_nchw(x), hwio_to_oihw(kt))
    ours = ours.permute(0, 2, 3, 1).numpy()
    assert ours.shape == fast.shape == lax_t.shape
    assert rel_err(ours, fast) <= 1e-5
    assert rel_err(ours, lax_t) <= 1e-5


def test_fused_dual_downsample_matches_jax():
    """One fused 5×5 stride-2 conv == the JAX fused form (rel ≤ 1e-5)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    k3 = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    k5 = rng.standard_normal((5, 5, 4, 6)).astype(np.float32)
    b3 = rng.standard_normal(6).astype(np.float32)
    b5 = rng.standard_normal(6).astype(np.float32)
    ref = np.asarray(jax_dual_downsample(*map(jnp.asarray, (x, k3, b3, k5, b5))))
    ours = fused_dual_downsample(nhwc_to_nchw(x), hwio_to_oihw(k3),
                                 torch.from_numpy(b3), hwio_to_oihw(k5),
                                 torch.from_numpy(b5))
    ours = ours.permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape == (2, 4, 4, 6)
    assert rel_err(ours, ref) <= 1e-5


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((4, 4), (4, 4)),
                                     ((4, 6), (7, 5)), ((8, 8), (3, 5))])
def test_nearest_resize_matches_jax(src, dst):
    """Nearest resize is exact: same source pixels (atol 0)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, *src, 3)).astype(np.float32)
    ref = np.asarray(jax_nearest_resize(jnp.asarray(x), *dst))
    ours = nearest_resize(nhwc_to_nchw(x), *dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size", [8, 7, 32])
def test_same_pad_matches_xla_same_stride2(size):
    """same_pad + an unpadded stride-2 conv == lax SAME stride 2, on even and
    odd sizes (rel ≤ 1e-5)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    ours = torch.nn.functional.conv2d(same_pad(nhwc_to_nchw(x), 3, 2),
                                      hwio_to_oihw(k), stride=2)
    ours = ours.permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape
    assert rel_err(ours, ref) <= 1e-5


def test_image_condition_embedding_matches_jax():
    """Its three stride-2 SAME convs pad (0, 1) on even sizes (rel ≤ 1e-5)."""
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jm = JaxCondEmb(d_model=64, dim=32)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(img)), seed=5)
    ref = np.asarray(jm.apply(params, jnp.asarray(img)))
    tm = ImageConditionEmbedding(64, 32)
    sd = state_dict_from_flat(flatten_params(params["params"]))
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        ours = tm(nhwc_to_nchw(img)).numpy()
    assert rel_err(ours, ref) <= 1e-5


def test_time_embedding_matches_jax():
    """Table lookup → Dense → SiLU → Dense (rel ≤ 1e-5); the table starts as
    the same sinusoids (atol 0)."""
    np.testing.assert_array_equal(sinusoidal_table(50, 16),
                                  jax_sinusoidal_table(50, 16))
    t = np.array([0, 7, 49], np.int32)
    jm = JaxTimeEmb(T=50, d_model=16, dim=32)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                          jnp.asarray(t)), seed=6)
    ref = np.asarray(jm.apply(params, jnp.asarray(t)))
    tm = TimeEmbedding(50, 16, 32)
    tm.load_state_dict(state_dict_from_flat(flatten_params(params["params"])),
                       strict=True)
    with torch.no_grad():
        ours = tm(torch.from_numpy(t)).numpy()
    assert rel_err(ours, ref) <= 1e-5


# ---------------------------------------------------------------- UNet


@pytest.fixture(scope="module")
def small_pair():
    """JAX and port DynamicUNet at ch 32, mult (1, 2), 1 res block, with the
    same numpy-seeded weights."""
    jm = JaxUNet(T=100, ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 6)),
                              jnp.zeros((1,), jnp.int32))
    params = random_params(template, seed=7)
    tm = DynamicUNet(T=100, ch=32, ch_mult=(1, 2), num_res_blocks=1)
    tm.load_state_dict(state_dict_from_flat(flatten_params(params["params"])),
                       strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("context_zero", [True, [True, False]],
                         ids=["all_zero", "per_example"])
def test_small_unet_forward_matches_jax(small_pair, context_zero):
    """32² forward, fp32 (rel ≤ 1e-4: ~20 chained convs and GroupNorms, each
    summed in another order; the measured gap is ~1.1e-5)."""
    jm, params, tm = small_pair
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 32, 32, 6)).astype(np.float32)
    t = np.array([3, 91], np.int32)
    cz = np.asarray(context_zero)
    ref = np.asarray(jax.jit(
        lambda p, x, t, cz: jm.apply(p, x, t, context_zero=cz))(params, x, t, cz))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), torch.from_numpy(t),
                  context_zero=torch.from_numpy(cz)).numpy()
    assert ours.shape == ref.shape == (2, 32, 32, 3)
    assert np.abs(ref).max() > 0.1   # the weights reach the output
    assert rel_err(ours, ref) <= 1e-4


def test_flagship_r5_forward_at_64_matches_jax():
    """The committed r5 flagship weights, one forward at 64², batch 1, fp32
    (rel ≤ 1e-4: the full 4-level network; the measured gap is ~2e-6)."""
    flat = jax_load_npz(str(R5_NPZ))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), flat)
    jm = JaxUNet(T=1000, ch=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2,
                 dropout=0.0)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (1, 64, 64, 6)).astype(np.float32)
    t = np.array([800], np.int32)
    ref = np.asarray(jax.jit(jm.apply)(params, x, t))
    tm = DynamicUNet()
    tm.load_state_dict(load_npz_state_dict(R5_NPZ), strict=True)
    with torch.no_grad():
        ours = tm.eval()(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert ours.shape == (1, 64, 64, 3)
    assert rel_err(ours, ref) <= 1e-4
