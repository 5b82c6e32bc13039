"""The parallel layer: process groups, the ("data", "model") mesh, the
sharding rules and the sharded train step and sampler. Counterpart of
`hybrid_diffusion_tpu/parallel/`."""

from .distributed import maybe_initialize, process_info
from .mesh import local_device_count, make_mesh
from .sharding import (
    gather_params,
    make_sharded_sampler,
    make_sharded_train_step,
    param_shardings,
    shard_batch,
    shard_params,
    shard_state,
    state_shardings,
)
