"""Sharding rules and the sharded train step and sampler.

Counterpart of `hybrid_diffusion_tpu/parallel/sharding.py` (:26-186). JAX
annotates one global program and lets GSPMD insert the collectives; here
each rank runs its own part and the collectives are explicit:

  - "data": each rank takes its rows of the global batch (`shard_batch`,
    in the single-process batch order); DistributedDataParallel over the
    "data" group averages the gradients; the statistics that are not plain
    means over the batch (the domain gates' channel means, MS-SSIM's
    per-scale means, the aux-SNR weighted reduce) are summed over the group
    inside the loss (parallel/collectives.py::group_sum), so the loss is the
    global batch's.
  - "model": the bottleneck attention is head-sharded (`shard_params`;
    models/blocks.py::SpatialSelfAttention.shard_heads): rank m keeps heads
    [m·h/M, (m+1)·h/M), rows [q_m; k_m; v_m] of the packed in_proj and the
    matching columns of out_proj, and runs the attention kernel on h/M
    heads. Everything else is replicated.
  - ZeRO-1 (`shard_state(..., zero1=True)`): AdamW's moments and the EMA
    are partitioned over "data" by whole tensors; each rank updates the
    tensors it owns and broadcasts them. AdamW is elementwise, so this
    gives the numbers of JAX's largest-dim split.

A rank's parameters are whole tensors or head shards; `gather_params` and
`full_state_payload` assemble the full ones (checkpoints, the npz export),
`localize_state_payload` cuts a full one down to a rank's.

Deliberate difference: JAX's spec P(None, "model") on the flax (C, 3C)
in_proj kernel splits the packed q|k|v columns contiguously, not by head,
and GSPMD repairs the layout with collectives; the port slices by head, so
that a rank's attention needs no communication. The numbers are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch
import torch.distributed as dist

from .collectives import all_gather_rows, all_reduce_
from .mesh import axis_group, axis_rank, axis_size


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """Split over "model" by attention head: axis `dim` holds `blocks` equal
    blocks (q|k|v: 3), each cut into `size` contiguous pieces; rank m keeps
    piece m of every block."""

    dim: int
    blocks: int = 1


# The head-sharded leaves of an attention block (torch Linear weights are
# (out, in): in_proj's rows are its q|k|v outputs, out_proj's columns its
# head-major inputs). out_proj's bias is replicated and added once.
HEAD_SHARDS = {"in_proj.weight": HeadShard(0, 3),
               "in_proj.bias": HeadShard(0, 3),
               "out_proj.weight": HeadShard(1)}


def _pieces(t: torch.Tensor, spec: HeadShard, size: int) -> torch.Tensor:
    """View of `t` with its axis `dim` split as (blocks, size, piece)."""
    n = t.shape[spec.dim]
    return t.unflatten(spec.dim, (spec.blocks, size,
                                  n // (spec.blocks * size)))


def shard_tensor(full: torch.Tensor, spec: Optional[HeadShard], rank: int,
                 size: int) -> torch.Tensor:
    """Rank `rank`'s piece of a full tensor (a contiguous copy); `full`
    itself when replicated."""
    if spec is None or size == 1:
        return full
    piece = _pieces(full, spec, size).select(spec.dim + 1, rank)
    return piece.flatten(spec.dim, spec.dim + 1).contiguous()


def place_piece(local: torch.Tensor, spec: HeadShard, rank: int,
                size: int) -> torch.Tensor:
    """A full-shaped tensor of zeros holding rank `rank`'s piece in its
    place (the inverse of `shard_tensor`, summed over the ranks)."""
    shape = list(local.shape)
    shape[spec.dim] *= size
    full = local.new_zeros(shape)
    blocks = local.unflatten(spec.dim, (spec.blocks,
                                        local.shape[spec.dim] // spec.blocks))
    _pieces(full, spec, size).select(spec.dim + 1, rank).copy_(blocks)
    return full


@torch.no_grad()
def gather_tensor(local: torch.Tensor, spec: Optional[HeadShard],
                  group) -> torch.Tensor:
    """The full tensor from every model rank's piece (on every rank): the
    placed pieces summed by an all-reduce."""
    size = 1 if group is None else dist.get_world_size(group)
    if spec is None or size == 1:
        return local
    return all_reduce_(place_piece(local, spec, dist.get_rank(group), size),
                       group)


def _attention_blocks(model: torch.nn.Module, model_size: int):
    """(name, block) of each attention block that splits into whole heads
    over `model_size` ranks."""
    from ..models.blocks import SpatialSelfAttention

    for name, mod in model.named_modules():
        if (isinstance(mod, SpatialSelfAttention) and model_size > 1
                and mod.num_heads % model_size == 0):
            yield name, mod


def param_shardings(mesh, model: torch.nn.Module
                    ) -> dict[str, Optional[HeadShard]]:
    """{parameter name: HeadShard or None (replicated)} of a DynamicUNet or
    CFGUNet: the attention in_proj and out_proj weights (and in_proj's
    bias) head-sharded when the "model" axis has more than one rank and the
    heads divide over it, everything else replicated (the JAX rule, by
    head instead of by contiguous column)."""
    specs: dict[str, Optional[HeadShard]] = {}
    for name, _ in _attention_blocks(model, axis_size(mesh, "model")):
        for leaf, spec in HEAD_SHARDS.items():
            specs[f"{name}.{leaf}"] = spec
    return {n: specs.get(n) for n, _ in model.named_parameters()}


def shard_params(mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Head-shard the model's attention blocks over "model", in place (the
    model holds full parameters, equal on every rank); returns it."""
    size = axis_size(mesh, "model")
    for _, block in _attention_blocks(model, size):
        block.shard_heads(axis_rank(mesh, "model"), size,
                          axis_group(mesh, "model"))
    return model


def gather_named(mesh, specs: Mapping[str, Optional[HeadShard]],
                 tensors: Mapping[str, torch.Tensor]) -> dict:
    """Full tensors from a rank's pieces, by name (collective over
    "model")."""
    group = axis_group(mesh, "model")
    return {n: gather_tensor(t, specs.get(n), group)
            for n, t in tensors.items()}


def localize_named(mesh, specs: Mapping[str, Optional[HeadShard]],
                   tensors: Mapping[str, torch.Tensor]) -> dict:
    """This rank's pieces of full tensors, by name."""
    rank, size = axis_rank(mesh, "model"), axis_size(mesh, "model")
    return {n: shard_tensor(t, specs.get(n), rank, size)
            for n, t in tensors.items()}


def gather_params(mesh, model: torch.nn.Module) -> dict:
    """The model's full state_dict (collective over "model"; every rank
    gets it)."""
    return gather_named(mesh, param_shardings(mesh, model),
                        model.state_dict())


def shard_batch(mesh, batch: Mapping) -> dict:
    """This rank's rows of a global batch (tensors or arrays, leading batch
    axis): rows [d·B/D, (d+1)·B/D) for data coordinate d of D; lists (file
    names) are sliced alike, other values kept."""
    size, d = axis_size(mesh, "data"), axis_rank(mesh, "data")
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") or isinstance(v, list):
            n = len(v)
            if n % size:
                raise ValueError(f"batch of {n} does not split over "
                                 f"{size} data ranks")
            per = n // size
            v = v[d * per:(d + 1) * per]
        out[k] = v
    return out


def zero1_owners(named_numels: Mapping[str, int], size: int) -> dict:
    """{name: owning data rank}: whole tensors, largest first, each to the
    least loaded rank (ties to the lower rank); the same on every rank."""
    load = [0] * size
    owners = {}
    for name in sorted(named_numels, key=lambda n: (-named_numels[n], n)):
        r = min(range(size), key=lambda i: (load[i], i))
        owners[name] = r
        load[r] += named_numels[name]
    return owners


def state_shardings(mesh, state, zero1: bool = False) -> dict:
    """{"params": {name: HeadShard or None}, "owners": {name: data rank}
    under ZeRO-1 with more than one data rank, else None}."""
    owners = None
    if zero1 and axis_size(mesh, "data") > 1:
        owners = zero1_owners({n: p.numel() for n, p in state.params.items()},
                              axis_size(mesh, "data"))
    return {"params": param_shardings(mesh, state.model), "owners": owners}


def shard_state(mesh, state, zero1: bool = False, data_parallel=None):
    """Attach the mesh to a TrainState whose model `shard_params` placed:
    the head-sharded names (the clip sums their squares over "model"), the
    ZeRO-1 partition of AdamW's moments and the EMA over "data" when
    `zero1`, and DistributedDataParallel over the "data" group when it has
    more than one rank (`data_parallel`, an existing wrapper of the same
    model, is reused: a run keeps one across its stages). Returns state."""
    sh = state_shardings(mesh, state, zero1=zero1)
    group = axis_group(mesh, "data")
    if group is not None and data_parallel is None:
        data_parallel = torch.nn.parallel.DistributedDataParallel(
            state.model, process_group=group, broadcast_buffers=False)
    state.parallelize(mesh, sh["params"], sh["owners"], data_parallel)
    return state


@torch.no_grad()
def full_state_payload(state) -> dict:
    """The train state as one process holds it (collective over the whole
    mesh; every rank gets it): full parameters, the single-process AdamW
    state_dict with full moments, the full EMA and gradient running mean.
    So a checkpoint is the same file at every world size."""
    mesh, specs = state.mesh, state.param_specs
    names = list(state.params)
    group = axis_group(mesh, "model")
    device = next(iter(state.params.values())).device

    def owned_moments(n):
        """[step (−1 before the first update), exp_avg, exp_avg_sq] of one
        parameter as one flat tensor."""
        st = state.optimizer.state.get(state.params[n])
        step = torch.tensor([float(st["step"]) if st else -1.0],
                            device=device)
        m = state.moments(n)
        return torch.cat([step, m["exp_avg"].flatten(),
                          m["exp_avg_sq"].flatten()])

    if state.owners is not None:
        flat = state.from_owners(owned_moments, lambda n: torch.empty(
            1 + 2 * state.params[n].numel(), device=device))
    else:
        flat = {n: owned_moments(n) for n in names}
    opt_state = {}
    for i, n in enumerate(names):
        step, rest = float(flat[n][0]), flat[n][1:]
        if step < 0:
            continue
        m1, m2 = (t.view_as(state.params[n]) for t in rest.chunk(2))
        opt_state[i] = {"step": torch.tensor(step),
                        "exp_avg": gather_tensor(m1, specs.get(n), group),
                        "exp_avg_sq": gather_tensor(m2, specs.get(n), group)}
    payload = {
        "params": gather_params(mesh, state.model),
        "optimizer": {"state": opt_state,
                      "param_groups": state.optimizer.state_dict()[
                          "param_groups"]},
        "step": state.step,
        "mini_step": state.mini_step,
    }
    if state.acc_grads is not None:
        payload["acc_grads"] = gather_named(mesh, specs, state.acc_grads)
    ema = state.gathered_ema()
    if ema is not None:
        payload["ema_params"] = gather_named(mesh, specs, ema)
    return payload


def localize_state_payload(state, payload: dict) -> dict:
    """A full payload (`full_state_payload`, or a one-process checkpoint)
    cut down to this rank's pieces: head shards over "model", and under
    ZeRO-1 only the owned tensors' moments and EMA."""
    mesh, specs = state.mesh, state.param_specs
    names = list(state.params)
    out = dict(payload)
    out["params"] = localize_named(mesh, specs, payload["params"])
    opt = payload["optimizer"]
    local_state = {}
    for i, st in opt["state"].items():
        n = names[int(i)]
        if state.owners is not None and state.owners[n] != state.data_rank:
            continue
        local_state[i] = {k: (shard_tensor(v, specs.get(n),
                                           axis_rank(mesh, "model"),
                                           axis_size(mesh, "model"))
                              if k != "step" else v)
                          for k, v in st.items()}
    out["optimizer"] = {"state": local_state,
                        "param_groups": opt["param_groups"]}
    for key in ("acc_grads", "ema_params"):
        if key in payload:
            out[key] = localize_named(mesh, specs, payload[key])
    return out


def make_sharded_train_step(mesh, schedule, *args, **kwargs) -> Callable:
    """The train step (train/step.py::make_train_step) on `mesh`: each rank
    passes its rows of the batch (`shard_batch`, or the loader's
    shard_hosts); t, ε and the p_uncond drop are drawn for the global batch
    from the generator (equal on every rank) and sliced; the loss and its
    gradients are the global batch's; the metrics are averaged over
    "data". `t` and `noise`, when given, cover the global batch."""
    from ..train.step import make_train_step

    return make_train_step(schedule, *args, mesh=mesh, **kwargs)


def make_sharded_sampler(mesh, sample_fn: Callable) -> Callable:
    """Batch-shard a sampler over "data": sample(cond_u8, generator=None,
    init_noise=None) takes the global batch; each rank draws the global
    initial noise (and DDPM's per-step noise) from the caller's generator,
    keeps its rows, samples them with `sample_fn` and gathers every rank's
    images, so that every rank (rank 0 included) returns what one process
    returns. Params are replicated: no communication inside the chain."""
    from ..diffusion.sampler import RowNoise

    size, d = axis_size(mesh, "data"), axis_rank(mesh, "data")
    group = axis_group(mesh, "data")

    def sample(cond_u8: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if size == 1:
            return sample_fn(cond_u8, generator, init_noise)
        B = cond_u8.shape[0]
        if B % size:
            raise ValueError(f"batch of {B} does not split over {size} "
                             f"data ranks")
        rows = slice(d * (B // size), (d + 1) * (B // size))
        noise = RowNoise(generator, B, rows)
        if init_noise is None:
            init_noise = noise.randn(tuple(cond_u8.shape), cond_u8.device)
        else:
            init_noise = init_noise[rows]
        out = sample_fn(cond_u8[rows], noise, init_noise)
        return all_gather_rows(out, group)

    return sample
