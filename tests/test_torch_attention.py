"""The port's attention against the JAX package, and the kernel wrapper.

On the CPU the wrapper runs the plain version, which is held against
`_xla_attention` and against the Pallas kernel run in interpret mode, in
fp32 (rel = max|port − jax| / max|jax| ≤ 1e-5: the same fp32 arithmetic,
summed in another order). The CUDA kernel itself runs only on a card:
chip_smoke.py holds it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (autouse)
from hybrid_diffusion_tpu.ops.attention import _pallas_attention, _xla_attention
from hybrid_diffusion_tpu_torch.ops import attention as port_attention
from hybrid_diffusion_tpu_torch.ops.attention import (
    attention_reference,
    fused_spatial_attention,
)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def qkv(seed, B, N, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("N", [16, 256])
@pytest.mark.parametrize("d", [16, 32])
def test_plain_attention_matches_xla_and_pallas(N, d):
    q, k, v = qkv(N + d, B=2, N=N, h=4, d=d)
    xla = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v))))
    pallas = np.asarray(_pallas_attention(*map(jnp.asarray, (q, k, v)),
                                          interpret=True))
    ours = attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    assert ours.shape == xla.shape == (2, N, 4, d)
    assert rel_err(ours, xla) <= 1e-5
    assert rel_err(ours, pallas) <= 1e-5


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    q, k, v = map(torch.from_numpy, qkv(0, B=1, N=64, h=2, d=16))
    before = port_attention.launch_count
    out = fused_spatial_attention(q, k, v)
    assert port_attention.launch_count == before
    torch.testing.assert_close(out, attention_reference(q, k, v), rtol=0,
                               atol=0)


def test_wrapper_reads_strided_qkv_views():
    """The model hands the wrapper strided views of the packed projection."""
    rng = np.random.default_rng(1)
    qkv_packed = torch.from_numpy(
        rng.standard_normal((2, 32, 3, 4, 16)).astype(np.float32))
    q, k, v = qkv_packed.unbind(2)
    assert not q.is_contiguous() and q.stride(-1) == 1
    out = fused_spatial_attention(q, k, v)
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _bad_inputs():
    q, k, v = map(torch.from_numpy, qkv(2, B=1, N=8, h=2, d=16))
    yield "dtype", (q.double(), k.double(), v.double()), TypeError
    yield "mixed dtype", (q, k.half(), v), TypeError
    q24, k24, v24 = map(torch.from_numpy, qkv(3, B=1, N=8, h=2, d=24))
    yield "head_dim", (q24, k24, v24), ValueError
    yield "shape", (q, k[:, :4], v), ValueError
    yield "last-axis stride", (q.transpose(2, 3), k.transpose(2, 3),
                               v.transpose(2, 3)), ValueError
    yield "rank", (q[0], k[0], v[0]), ValueError
    # Inputs that require grad are taken (the backward recomputes through
    # the plain version) and checked like any other.
    yield "grad", (q.double().requires_grad_(), k.double(), v.double()), \
        TypeError
    # The bf16/fp16 (tensor-core) kernel copies 16-byte chunks: it refuses a
    # misaligned pointer or a stride that is not a multiple of 8 elements.
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[-1]
        flat = torch.zeros(1 * 8 * 2 * 16 + 1, dtype=dtype)
        shifted = flat[1:].view(1, 8, 2, 16)
        yield f"{name} address", (shifted, shifted, shifted), ValueError
        wide = torch.zeros(1, 8, 2, 20, dtype=dtype)[..., :16]
        yield f"{name} stride", (wide, wide, wide), ValueError
    # So does the fp32 kernel, with strides in multiples of 4 elements: a
    # pointer 8 bytes off, a head stride of 18 and a token stride of 66.
    flat = torch.zeros(1 * 8 * 2 * 16 + 2)
    shifted = flat[2:].view(1, 8, 2, 16)
    yield "float32 address", (shifted, shifted, shifted), ValueError
    wide = torch.zeros(1, 8, 2, 18)[..., :16]
    yield "float32 head stride", (wide, wide, wide), ValueError
    rows = torch.zeros(1, 8, 66)[..., :32].view(1, 8, 2, 16)
    yield "float32 token stride", (rows, rows, rows), ValueError


@pytest.mark.parametrize("case", list(_bad_inputs()), ids=lambda c: c[0])
def test_kernel_input_checks_raise(case):
    """What the CUDA path refuses, checked before any launch."""
    _, args, exc = case
    with pytest.raises(exc):
        port_attention._check_cuda_inputs(*args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_packed_qkv_views_meet_the_tensor_core_preconditions(d, dtype):
    """The model's strided q|k|v views of one packed projection (ragged N
    included) pass the 16-byte checks at every head_dim."""
    packed = torch.zeros(2, 1000, 3, 8, d, dtype=dtype)
    q, k, v = packed.unbind(2)
    port_attention._check_cuda_inputs(q, k, v)
