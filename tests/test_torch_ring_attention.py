"""Ring attention (ops/ring_attention.py) at world 2 and 4 against the JAX
package's `ring_spatial_attention` on 2 and 4 virtual devices and against
dense attention: the output and the gradients of Σ out·g with respect to
q, k and v, in fp32.

The port's side runs as gloo ranks on the CPU (tests/_torch_dist.py::
ring_worker), spawned once for the file: ranks 0-1 form the 2-rank ring,
then all four the 4-rank one; each rank holds the replicated q, k, v and
returns the whole output and input gradients. Bound: within 2e-6 of the
largest value of each (fp32 sums in another order; measured about 3e-7,
as JAX's own dryrun bounds its ring by 2e-5). N not divisible by the
ring's size raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import one_torch_thread  # noqa: F401
from hybrid_diffusion_tpu.ops.ring_attention import (
    ring_spatial_attention as jax_ring)
from hybrid_diffusion_tpu.parallel import make_mesh
from hybrid_diffusion_tpu_torch.ops.attention import attention_reference

SHAPE = (2, 16, 2, 8)          # (B, N, heads, head_dim); N splits 2 and 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    spec = {x: rng.standard_normal(SHAPE).astype(np.float32)
            for x in ("q", "k", "v", "g")}
    ranks = td.spawn_in_background(td.ring_worker, 4,
                                   tmp_path_factory.mktemp("ring"), spec)
    jax_out = {}
    for n in (2, 4):
        mesh = make_mesh(n, 1, devices=jax.devices()[:n])

        def loss(q, k, v):
            return jnp.sum(jax_ring(q, k, v, mesh, "data") * spec["g"])

        q, k, v = (jnp.asarray(spec[x]) for x in "qkv")
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        jax_out[n] = dict(out=np.asarray(jax_ring(q, k, v, mesh, "data")),
                          **{f"d{x}": np.asarray(g)
                             for x, g in zip("qkv", grads)})
    q, k, v = (torch.from_numpy(spec[x]).requires_grad_() for x in "qkv")
    out = attention_reference(q, k, v)
    (out * torch.from_numpy(spec["g"])).sum().backward()
    dense = td.numpy_tree(dict(out=out, dq=q.grad, dk=k.grad, dv=v.grad))
    return dict(port=ranks.result()[0], jax=jax_out, dense=dense)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("key", ["out", "dq", "dk", "dv"])
def test_ring_attention_equals_jax_and_dense(runs, n, key):
    port = runs["port"][n][key]
    for want in (runs["jax"][n][key], runs["dense"][key]):
        assert port.shape == want.shape == SHAPE
        np.testing.assert_allclose(port, want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_rejects_indivisible_tokens(runs, n):
    assert "not divisible by mesh axis 'data'" in runs["port"][n]["error"]
    mesh = make_mesh(n, 1, devices=jax.devices()[:n])
    bad = jnp.zeros((1, n + 1, 1, 8))
    with pytest.raises(ValueError, match="not divisible"):
        jax_ring(bad, bad, bad, mesh, "data")
