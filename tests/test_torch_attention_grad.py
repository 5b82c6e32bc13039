"""The attention's reverse mode: `KernelBackwardAttention` against
`jax.vjp(_xla_attention)`, the backward of the JAX package's
`_pallas_attention_diff`, on the CPU.

The Function takes its forward and backward as arguments; here those are
the kernels' plain twins (on the card they are the CUDA kernels, in fp32
as in bf16 and fp16: the recomputed fp32 backward is gone). q, k and v are
strided views of one packed (B, N, 3, h, d) projection, as the model hands
them over, and the gradient arrives on the packed tensor. fp32: rel ≤ 1e-5
(the same fp32 arithmetic in another order); bf16 against JAX's bf16 vjp:
rel ≤ 2e-2 (the two round P and the products at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, rel_err  # noqa: F401 (autouse)
from hybrid_diffusion_tpu.ops.attention import _xla_attention
from hybrid_diffusion_tpu_torch.ops import attention as port_attention
from hybrid_diffusion_tpu_torch.ops.attention import (
    KernelBackwardAttention,
    attention_backward_reference,
    attention_forward_lse_reference,
    attention_reference,
    fused_spatial_attention,
)


def packed(seed, B, N, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, 3, h, d)).astype(np.float32),
            rng.standard_normal((B, N, h, d)).astype(np.float32))


def jax_grads(qkv, g, dtype):
    q, k, v = (jnp.asarray(qkv[:, :, i], dtype) for i in range(3))
    _, vjp = jax.vjp(_xla_attention, q, k, v)
    return np.stack([np.asarray(x, np.float32)
                     for x in vjp(jnp.asarray(g, dtype))], axis=2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 8, 32), (1, 100, 4, 16)],
                         ids=["path_shape", "ragged"])
def test_function_backward_matches_jax_vjp(shape, dtype, tol):
    qkv_np, g_np = packed(sum(shape), *shape)
    qkv = torch.from_numpy(qkv_np).to(dtype).requires_grad_()
    calls = []

    def forward(q, k, v):
        calls.append(q.shape)
        return attention_forward_lse_reference(q, k, v)

    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = KernelBackwardAttention.apply(q, k, v, forward,
                                        attention_backward_reference)
    out.backward(torch.from_numpy(g_np).to(dtype))
    assert len(calls) == 1                # one forward; the backward reuses its lse
    assert qkv.grad.shape == qkv.shape
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_grads(qkv_np, g_np, jdtype)
    assert rel_err(qkv.grad.float().numpy(), ref) <= tol


def test_function_equals_plain_autograd():
    """The Function's fp32 grads with the twins are the plain version's
    autograd grads but for fp32 rounding: the twin's FA2 algebra (D =
    rowsum(dO∘O) for rowsum(P∘dP)) sums in another order."""
    qkv_np, g_np = packed(5, 2, 32, 4, 16)
    grads = []
    for through_function in (True, False):
        qkv = torch.from_numpy(qkv_np).requires_grad_()
        q, k, v = qkv.unbind(2)
        out = (KernelBackwardAttention.apply(
                   q, k, v, attention_forward_lse_reference,
                   attention_backward_reference)
               if through_function else attention_reference(q, k, v))
        out.backward(torch.from_numpy(g_np))
        grads.append(qkv.grad)
    assert rel_err(grads[0].numpy(), grads[1].numpy()) <= 1e-6


def test_cpu_wrapper_differentiates_the_plain_version_without_launches():
    qkv_np, g_np = packed(6, 1, 16, 2, 16)
    qkv = torch.from_numpy(qkv_np).requires_grad_()
    before = port_attention.launch_count
    out = fused_spatial_attention(*qkv.unbind(2))
    out.backward(torch.from_numpy(g_np))
    assert port_attention.launch_count == before
    assert rel_err(qkv.grad.numpy(), jax_grads(qkv_np, g_np, jnp.float32)) <= 1e-5
