"""The parallel layer's rules without spawning ranks: the mesh's shapes and
errors, the head-sharding rule, the head-wise slice and its gather, the
rows of `shard_batch`, and the sharded loader.

One process stands in for rank r of a world of 8 through torch's "fake"
process-group backend (a store and groups with no transport): enough to
build the DeviceMesh and read its coordinates, never to communicate. The
JAX rules they mirror run on tests/conftest.py's 8 virtual CPU devices.
Everything here is compared exactly.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from _torch_parity import one_torch_thread  # noqa: F401
from hybrid_diffusion_tpu.data import pipeline as jpipe
from hybrid_diffusion_tpu.models import DynamicUNet as JaxUNet
from hybrid_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from hybrid_diffusion_tpu.parallel import param_shardings as jax_shardings
from hybrid_diffusion_tpu_torch.data import pipeline as tpipe
from hybrid_diffusion_tpu_torch.data.datasets import make_dataset
from hybrid_diffusion_tpu_torch.models import DynamicUNet
from hybrid_diffusion_tpu_torch.parallel import (
    make_mesh, param_shardings, process_info, shard_batch, shard_params)
from hybrid_diffusion_tpu_torch.parallel.mesh import (
    axis_rank, axis_size, mesh_shape)
from hybrid_diffusion_tpu_torch.parallel.sharding import (
    HeadShard, place_piece, shard_tensor, zero1_owners)
from hybrid_diffusion_tpu_torch.utils.params_io import flatten_params
from hybrid_diffusion_tpu_torch.weights import state_dict_from_flat

TINY = dict(T=20, ch=32, ch_mult=(1, 2), num_res_blocks=1)


@contextlib.contextmanager
def fake_world(rank: int, world: int = 8):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_shapes():
    """As tests/test_parallel.py::test_make_mesh_shapes, on 8 ranks."""
    with fake_world(0):
        mesh = make_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (8, 1)
        assert tuple(make_mesh(model=2).shape) == (4, 2)
        for bad in (dict(data=3, model=2), dict(model=3)):
            with pytest.raises(ValueError):
                make_mesh(**bad)
            with pytest.raises(ValueError):
                jax_make_mesh(**bad)
        assert process_info() == {"process_index": 0, "process_count": 8,
                                  "local_devices": 1, "global_devices": 8}
    assert dict(jax_make_mesh(model=2).shape) == {"data": 4, "model": 2}
    assert mesh_shape(1) == (1, 1)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        mesh_shape(1, None, 2)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


@pytest.mark.parametrize("rank", [0, 5])
def test_mesh_coordinates(rank):
    """Rank r of a 4×2 mesh sits at (r // 2, r % 2)."""
    with fake_world(rank):
        mesh = make_mesh(model=2)
        assert (axis_rank(mesh, "data"), axis_rank(mesh, "model")) == (
            rank // 2, rank % 2)
        assert (axis_size(mesh, "data"), axis_size(mesh, "model")) == (4, 2)


def test_param_shardings_tp_rules():
    """As test_param_shardings_tp_rules: the attention projections of every
    middle block sharded over "model", the rest replicated; the port's
    leaves are the JAX sharded ones (weights.py's name map)."""
    jm = JaxUNet(**TINY)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 6)),
                            jnp.zeros((1,), jnp.int32))
    with fake_world(0):
        specs = param_shardings(make_mesh(model=2), DynamicUNet(**TINY))
        replicated = param_shardings(make_mesh(), DynamicUNet(**TINY))
    assert specs["middle_0.attn.in_proj.weight"] == HeadShard(0, 3)
    assert specs["middle_0.attn.in_proj.bias"] == HeadShard(0, 3)
    assert specs["middle_0.attn.out_proj.weight"] == HeadShard(1)
    assert specs["middle_0.attn.out_proj.bias"] is None
    assert specs["head.weight"] is None
    assert not any(replicated.values())

    # JAX's sharded leaves under the port's names: each leaf full-shaped,
    # 0 where sharded and 1 where replicated, through weights.py's map.
    jsh = jax_shardings(jax_make_mesh(model=2), params)
    flat = jax.tree_util.tree_map(
        lambda leaf, sh: np.full(leaf.shape, float(sh.spec == P())),
        params["params"], jsh["params"])
    port = state_dict_from_flat(flatten_params(flat))
    assert {n for n, v in port.items() if not v.any()} == {
        n for n, s in specs.items() if s is not None}


@pytest.mark.parametrize("spec,shape", [(HeadShard(0, 3), (96, 32)),
                                        (HeadShard(0, 3), (96,)),
                                        (HeadShard(1), (32, 32))])
def test_head_slice_and_gather_round_trip(spec, shape):
    """Rank m's piece holds heads [m·h/M, (m+1)·h/M) of each q|k|v block;
    the pieces put back in place give the full tensor."""
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    M = 4
    pieces = [shard_tensor(full, spec, m, M) for m in range(M)]
    rebuilt = sum(place_piece(p, spec, m, M) for m, p in enumerate(pieces))
    assert torch.equal(rebuilt, full)
    C = full.shape[spec.dim] // spec.blocks
    rows = torch.arange(full.shape[spec.dim]).view(spec.blocks, C)
    for m, p in enumerate(pieces):
        want = rows[:, m * C // M:(m + 1) * C // M].flatten()
        assert torch.equal(p, full.index_select(spec.dim, want))


def test_sharded_attention_heads_sum_to_the_block():
    """The block's output is the sum over ranks of each rank's head-sharded
    out-projection partial, plus the out bias once (the all-reduce)."""
    torch.manual_seed(0)
    model = DynamicUNet(**TINY)
    block = model.middle_0.attn
    with torch.no_grad():
        block.out_proj.bias.normal_()
    x = torch.randn(2, block.in_proj.weight.shape[1], 4, 4)
    want = block(x)
    partial = 0
    for m in range(2):
        clone = DynamicUNet(**TINY)
        clone.load_state_dict(model.state_dict())
        piece = clone.middle_0.attn
        piece.shard_heads(m, 2, None)
        assert piece.local_heads == 4
        assert piece.in_proj.weight.shape == (96, 64)
        with torch.no_grad():
            piece.out_proj.bias.zero_()
        partial = partial + piece(x)
    bias = block.out_proj.bias[None, :, None, None]
    torch.testing.assert_close(partial + bias, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rank", [0, 3, 6])
def test_shard_batch_rows(rank):
    """Data coordinate d of D keeps rows [d·B/D, (d+1)·B/D): the
    single-process batch order (ranks of one data row share them)."""
    batch = {"input": np.arange(8 * 2).reshape(8, 2),
             "name": [f"f{i}" for i in range(8)], "tag": "x"}
    with fake_world(rank):
        mesh = make_mesh(model=2)
        d = rank // 2
        out = shard_batch(mesh, batch)
        np.testing.assert_array_equal(out["input"],
                                      batch["input"][2 * d:2 * d + 2])
        assert out["name"] == batch["name"][2 * d:2 * d + 2]
        assert out["tag"] == "x"
        with pytest.raises(ValueError, match="does not split"):
            shard_batch(mesh, {"input": np.zeros((6, 1))})
    shard_params(None, DynamicUNet(**TINY))     # one process: nothing


def test_shard_for_host_and_sharded_loader():
    """shard_for_host is the JAX function; BatchLoader(shard_hosts=(i, n))
    yields rank i's rows of every batch, so the ranks' rows concatenated
    are the one-process (and the JAX loader's) batches, a ragged one
    dropped."""
    idx = np.arange(10)
    for rank in range(3):
        np.testing.assert_array_equal(tpipe.shard_for_host(idx, rank, 3),
                                      jpipe.shard_for_host(idx, rank, 3))
    ds = make_dataset("synthetic-underwater", task="train", image_size=16,
                      synthetic_length=10)
    whole = list(jpipe.BatchLoader(ds, 4, shuffle=True, seed=3,
                                   num_workers=1, drop_last=True))
    parts = [list(tpipe.BatchLoader(ds, 4, shuffle=True, seed=3,
                                    num_workers=1, drop_last=False,
                                    shard_hosts=(i, 2)))
             for i in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 2
    for b, (p0, p1) in zip(whole, zip(*parts)):
        for k in ("input", "gt"):
            np.testing.assert_array_equal(
                np.concatenate([p0[k], p1[k]]), np.asarray(b[k]))
        assert p0["name"] + p1["name"] == list(b["name"])
    with pytest.raises(ValueError, match="does not split"):
        tpipe.BatchLoader(ds, 3, shard_hosts=(0, 2))
    with fake_world(0, 2), pytest.raises(NotImplementedError,
                                         match="single-process"):
        tpipe.DeviceBatchLoader(ds, 4, "cpu")


def test_zero1_partition_is_whole_tensors_and_balanced():
    numels = {f"p{i}": n for i, n in enumerate([100, 60, 50, 40, 10, 1])}
    owners = zero1_owners(numels, 2)
    assert owners == {"p0": 0, "p1": 1, "p2": 1, "p3": 0, "p4": 1, "p5": 1}
    assert zero1_owners(numels, 1) == dict.fromkeys(numels, 0)
