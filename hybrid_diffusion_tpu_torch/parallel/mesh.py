"""The ("data", "model") device mesh.

Counterpart of `hybrid_diffusion_tpu/parallel/mesh.py` (:19-37): the 2-D
`jax.sharding.Mesh` becomes a `torch.distributed.device_mesh.DeviceMesh`
over the world's ranks with mesh_dim_names ("data", "model"): rank
r = d·model + m sits at (d, m). "data" splits the batch (gradients
averaged over it), "model" the attention heads of the bottleneck.

`mesh=None` stands for one process (a 1×1 mesh) everywhere in the port:
the helpers below then give size 1, rank 0 and no group, so that a single
process calls no collective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")


def local_device_count() -> int:
    """The cards this process sees (1 on a CPU-only host)."""
    return torch.cuda.device_count() or 1


def mesh_shape(world: int, data: Optional[int] = None,
               model: int = 1) -> tuple[int, int]:
    """(data, model) for `world` ranks; data=None means world / model.
    Raises the JAX function's ValueErrors."""
    if data is None:
        if world % model:
            raise ValueError(f"{world} devices not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}×{model} != {world} devices")
    return data, model


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ("data", "model") DeviceMesh over every rank of the initialized
    default process group. device_type: "cuda" when this rank has a card
    (the default), else "cpu"."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.maybe_initialize); one process runs "
                           "with mesh=None")
    data, model = mesh_shape(dist.get_world_size(), data, model)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group along `axis`, or None when the axis has one rank
    (nothing to communicate)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)
