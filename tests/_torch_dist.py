"""Spawned gloo ranks for the parallel layer's tests.

The ranks are processes started with multiprocessing's "spawn": each
imports this module, which imports torch, numpy and the port only (never
JAX: the JAX side of every comparison runs in the test process, on
tests/conftest.py's 8 virtual CPU devices). Each rank runs torch on one
thread and meets the others through a file under the test's tmp_path (no
TCP port to race for between the suite's workers). A worker
`fn(rank, world, workdir, *args)` returns a picklable value; `spawn`
returns every rank's, or raises with the ranks' tracebacks when one fails
or the time runs out.

A spawn can hold several process groups in turn (`session`): the first
`n` ranks join a group of their own, the others skip it. So one spawn of
four ranks runs the 2-rank and the 4-rank cases of a file.
"""

from __future__ import annotations

import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 240.0


def spawn(fn, world: int, workdir, *args, timeout: float = TIMEOUT_S):
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, workdir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        errors = []
        for r in range(world):
            path = os.path.join(workdir, f"error.{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        raise RuntimeError(f"ranks exited with {codes}"
                           + (" (timed out)" if hung else "") + "\n"
                           + "\n".join(errors))
    return [torch.load(os.path.join(workdir, f"result.{r}.pt"),
                       weights_only=False) for r in range(world)]


def spawn_in_background(fn, world: int, workdir, *args):
    """`spawn` on a thread, so that the test process computes the JAX side
    meanwhile; returns a Future of its result."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(spawn, fn, world, workdir, *args)
    pool.shutdown(wait=False)
    return future


def _entry(fn, rank, world, workdir, args):
    torch.set_num_threads(1)
    try:
        out = fn(rank, world, workdir, *args)
    except BaseException:
        with open(os.path.join(workdir, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(out, os.path.join(workdir, f"result.{rank}.pt"))


def session(rank: int, n: int, workdir: str, name: str, fn):
    """fn() inside a gloo group of ranks [0, n) (None for the others)."""
    if rank >= n:
        return None
    dist.init_process_group("gloo", init_method=f"file://{workdir}/{name}",
                            rank=rank, world_size=n)
    try:
        return fn()
    finally:
        dist.destroy_process_group()


def numpy_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    return x


# ---------------------------------------------------------------- train step

def _train_run(spec: dict, mesh_shape, zero1=False, steps=1):
    """`steps` steps of the port's sharded step from spec's weights on a
    (data, model) mesh; returns (state, [metrics], mesh)."""
    from hybrid_diffusion_tpu_torch.diffusion import linear_beta_schedule
    from hybrid_diffusion_tpu_torch.losses import CompositeLossConfig
    from hybrid_diffusion_tpu_torch.models import DynamicUNet
    from hybrid_diffusion_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, shard_batch, shard_params,
        shard_state)
    from hybrid_diffusion_tpu_torch.train.train_state import TrainState

    mesh = make_mesh(*mesh_shape, device_type="cpu")
    model = DynamicUNet(**spec["model"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["params"].items()}, strict=True)
    shard_params(mesh, model)
    state = shard_state(mesh, TrainState(model, **spec["hyper"]),
                        zero1=zero1)
    step = make_sharded_train_step(
        mesh, linear_beta_schedule(1e-4, 0.02, spec["model"]["T"]),
        CompositeLossConfig(**spec["loss"]), domain_routing=True)
    metrics = []
    for i in range(steps):
        b = spec["batches"][i]
        local = shard_batch(mesh, {k: torch.from_numpy(b[k])
                                   for k in ("input", "gt")})
        state, m = step(state, local, torch.Generator().manual_seed(0),
                        t=torch.from_numpy(b["t"]),
                        noise=torch.from_numpy(b["noise"]))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, mesh


def _record(state, metrics) -> dict:
    """The full state after the steps, by parameter name (a collective)."""
    from hybrid_diffusion_tpu_torch.parallel.sharding import (
        full_state_payload)

    payload = full_state_payload(state)
    names = list(state.params)
    opt = payload["optimizer"]["state"]
    return numpy_tree(dict(
        metrics=metrics, params=payload["params"],
        mu={names[i]: s["exp_avg"] for i, s in opt.items()},
        nu={names[i]: s["exp_avg_sq"] for i, s in opt.items()},
        ema=payload.get("ema_params"),
        local_shapes={n: tuple(p.shape) for n, p in state.params.items()}))


def step_worker(rank, world, workdir, spec):
    """The parallel step file's cases: a DP step at 2×1 and the sharded
    sampler on ranks 0-1, then a TP+DP step at 2×2 on all four; each with
    its loss weights from spec["loss_by_case"]."""
    out = {}

    def case(name, mesh_shape):
        def run():
            state, metrics, mesh = _train_run(
                {**spec, "loss": spec["loss_by_case"][name]}, mesh_shape)
            rec = _record(state, metrics)
            if name == "dp":
                rec["sample"] = _sample(spec, mesh)
            return rec
        return run

    out["dp"] = session(rank, 2, workdir, "pg_dp", case("dp", (2, 1)))
    out["tpdp"] = session(rank, 4, workdir, "pg_tpdp", case("tpdp", (2, 2)))
    return out if rank == 0 else None


def _sample(spec, mesh):
    """make_sampler(mesh=...) of spec's weights on spec's sampler inputs."""
    from hybrid_diffusion_tpu_torch.config import Config
    from hybrid_diffusion_tpu_torch.models import DynamicUNet
    from hybrid_diffusion_tpu_torch.train.loop import make_sampler

    s = spec["sampler"]
    model = DynamicUNet(**spec["model"]).eval()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["params"].items()}, strict=True)
    cfg = Config(**s["config"])
    sample = make_sampler(cfg, model, mesh=mesh)
    out = sample(torch.from_numpy(s["cond"]), None,
                 torch.from_numpy(s["init_noise"]))
    return out.numpy()


# ---------------------------------------------------------------- ZeRO-1

def zero1_worker(rank, world, workdir, spec):
    """The ZeRO-1 file's cases on three processes. Ranks 0-1: one ZeRO-1
    step with EMA at 2×1, a checkpoint written at world 2 and restored into
    a fresh ZeRO-1 state; then train() and evaluate() through the entry
    points at world 2 (`loop_run`). Rank 2, meanwhile and in no group: the
    same train() and evaluate() in one process, in directories of its
    own."""
    from hybrid_diffusion_tpu_torch.models import DynamicUNet
    from hybrid_diffusion_tpu_torch.parallel import shard_state
    from hybrid_diffusion_tpu_torch.train.checkpoint import (
        restore_state, save_checkpoint)
    from hybrid_diffusion_tpu_torch.train.train_state import TrainState

    if rank == 2:
        return {"one": loop_run(spec["one"])}

    def run():
        state, metrics, mesh = _train_run(spec, (2, 1), zero1=True,
                                          steps=len(spec["batches"]))
        rec = _record(state, metrics)
        rec.update(owned=sorted(n for n in state.params if state.owned(n)),
                   with_moments=sorted(n for n, p in state.params.items()
                                       if p in state.optimizer.state),
                   ema_local=sorted(state.ema_params))
        path = save_checkpoint(os.path.join(workdir, "ck"), 1, "Z1", "SYN",
                               state)
        fresh = shard_state(mesh, TrainState(DynamicUNet(**spec["model"]),
                                             **spec["hyper"]), zero1=True)
        restore_state(path, fresh)
        rec.update(path=path, restored=_record(fresh, []),
                   restored_step=fresh.step)
        return rec

    out = {"zero1": session(rank, 2, workdir, "pg_z1", run)}
    out["loop"] = session(rank, 2, workdir, "pg_loop",
                          lambda: loop_run(spec["loop"]))
    return out


def loop_run(spec) -> dict:
    """train() with a budget from spec["config"], then evaluate() of the
    npz spec["evaluate_npz"]: the trained parameters, the stages and their
    last losses, and the metrics (rank 0's; {} on the others)."""
    import dataclasses

    from hybrid_diffusion_tpu_torch.config import Config
    from hybrid_diffusion_tpu_torch.parallel.sharding import gather_params
    from hybrid_diffusion_tpu_torch.train import loop

    cfg = Config(**spec["config"])
    summary = loop.train(cfg, max_steps=spec["max_steps"])
    state = summary["state"]
    params = numpy_tree(gather_params(state.mesh, state.model))
    results = loop.evaluate(dataclasses.replace(
        cfg, state="test", pretrained_path=spec["evaluate_npz"]),
        compute_fid=False, save_images=False)
    return dict(steps=summary["steps"], params=params, results=results,
                stages=[s["stage"] for s in summary["stages"]],
                last_losses=[s["last_loss"] for s in summary["stages"]])


# ---------------------------------------------------------------- ring

def ring_worker(rank, world, workdir, spec):
    """Ring attention's output and input gradients at world 2 (ranks 0-1)
    and 4, on replicated q, k, v; and the error on an indivisible N."""
    from hybrid_diffusion_tpu_torch.ops.ring_attention import (
        ring_spatial_attention)
    from hybrid_diffusion_tpu_torch.parallel import make_mesh

    def run(n):
        mesh = make_mesh(n, 1, device_type="cpu")
        q, k, v = (torch.from_numpy(spec[x]).requires_grad_()
                   for x in "qkv")
        out = ring_spatial_attention(q, k, v, mesh, axis="data")
        (out * torch.from_numpy(spec["g"])).sum().backward()
        rec = numpy_tree(dict(out=out, dq=q.grad, dk=k.grad, dv=v.grad))
        try:
            bad = torch.zeros(1, n + 1, 1, 8)
            ring_spatial_attention(bad, bad, bad, mesh)
            rec["error"] = None
        except ValueError as e:
            rec["error"] = str(e)
        return rec

    out = {n: session(rank, n, workdir, f"pg_ring{n}", lambda n=n: run(n))
           for n in (2, 4)}
    return out if rank == 0 else None


def batch_arrays(seed: int, B: int, size: int, blue_rows: int):
    """A uint8 pair batch whose first `blue_rows` rows are strongly
    blue-heavy and the rest mildly red-heavy: the whole batch is blue over
    red while the red rows alone are red over blue. The red rows' clean
    images are smooth ramps, the others noise, so that the two groups'
    SSIM statistics differ at every scale (per-group MS-SSIM means then
    give another loss than the batch's)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    gt = rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    img[:blue_rows, ..., 2] = np.maximum(img[:blue_rows, ..., 2], 230)
    img[blue_rows:, ..., 0] = np.maximum(img[blue_rows:, ..., 0], 150)
    ramp = np.linspace(0, 127, size, dtype=np.float32)
    gt[blue_rows:] = (ramp[:, None, None] + ramp[None, :, None]).astype(
        np.uint8)
    return {"input": img, "gt": gt}
