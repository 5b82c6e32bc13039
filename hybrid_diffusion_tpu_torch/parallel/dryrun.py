"""Dry run of the parallel layer on W ranks.

    python -m hybrid_diffusion_tpu_torch.parallel.dryrun [--world 4]

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`
(:32-207). It spawns W ranks on the CPU over gloo (a file rendezvous in a
temporary directory), builds a (data × model) mesh, model 2 when W is even
and at least 4, and runs on a tiny DynamicUNet (ch 32, mult (1, 2), one
res block, 32², T 16, dropout 0.1):

  1. one full train step (the composite loss without DINO, Charbonnier on,
     domain routing, conditioning) on the mesh: DDP over "data", the
     attention head-sharded over "model";
  2. the same step with ZeRO-1;
  3. ring attention over "data" against dense attention;
  4. the batch-sharded DDIM sampler against one process.

Every rank checks its part; the parent checks the ranks' exit codes and
prints one line, `dryrun ok: ...`, or exits non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TINY = dict(T=16, ch=32, ch_mult=(1, 2), num_res_blocks=1)
SIZE = 32
# A rank that waits longer than this in a collective raises; the parent
# kills ranks still alive after TIMEOUT_S.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
TIMEOUT_S = 300.0


def _rank_main(rank: int, world: int, workdir: str) -> None:
    from ..diffusion import ddim_sample, linear_beta_schedule
    from ..losses import CompositeLossConfig
    from ..models import DynamicUNet
    from ..ops.attention import attention_reference
    from ..ops.ring_attention import ring_spatial_attention
    from ..train.step import normalize_uint8
    from ..train.train_state import TrainState
    from .mesh import axis_size, make_mesh
    from .sharding import (make_sharded_sampler, make_sharded_train_step,
                           shard_batch, shard_params, shard_state)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg",
                            rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        t0 = time.perf_counter()
        model_axis = 2 if world % 2 == 0 and world >= 4 else 1
        mesh = make_mesh(world // model_axis, model_axis, device_type="cpu")
        B = max(axis_size(mesh, "data"), 4)
        schedule = linear_beta_schedule(1e-4, 0.02, TINY["T"])
        loss = CompositeLossConfig(dino_weight=0.0, charbonnier_weight=1.0)
        rng = np.random.RandomState(0)
        batch = {"input": rng.randint(0, 255, (B, SIZE, SIZE, 3), np.uint8),
                 "gt": rng.randint(0, 255, (B, SIZE, SIZE, 3), np.uint8)}
        local = shard_batch(mesh, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})

        def fresh_state(zero1: bool) -> TrainState:
            torch.manual_seed(0)            # the same weights on every rank
            model = shard_params(mesh, DynamicUNet(**TINY, dropout=0.1))
            return shard_state(mesh, TrainState(model, total_epochs=4,
                                                steps_per_epoch=2),
                               zero1=zero1)

        losses = {}
        for zero1 in (False, True):
            state = fresh_state(zero1)
            step = make_sharded_train_step(mesh, schedule, loss,
                                           use_conditioning=True,
                                           domain_routing=True)
            gen = torch.Generator().manual_seed(1 + zero1)
            state, metrics = step(state, local, gen)
            total = float(metrics["total"])
            if not np.isfinite(total):
                raise FloatingPointError(f"non-finite loss (zero1={zero1})")
            losses[zero1] = total

        # Ring attention over "data" (the token axis split over it).
        qkv = torch.from_numpy(np.random.RandomState(3).standard_normal(
            (3, 2, 8 * axis_size(mesh, "data"), 4, 8)).astype(np.float32))
        ring = ring_spatial_attention(*qkv, mesh, axis="data")
        ring_err = float((ring - attention_reference(*qkv)).abs().max())
        if ring_err > 2e-5:
            raise AssertionError(f"ring attention differs by {ring_err}")

        # The batch-sharded sampler against one process, with the trained
        # (head-sharded) weights.
        model = state.model.eval()

        def sample_fn(cond_u8, generator=None, init_noise=None):
            with torch.no_grad():
                return ddim_sample(
                    lambda x6, t, context_zero=True: model(
                        x6, t, context_zero=context_zero),
                    schedule, normalize_uint8(cond_u8), generator,
                    ddim_steps=4, init_noise=init_noise)

        cond = torch.from_numpy(np.random.RandomState(5).randint(
            0, 255, (B, SIZE, SIZE, 3), np.uint8))
        plain = sample_fn(cond, torch.Generator().manual_seed(7))
        sharded = make_sharded_sampler(mesh, sample_fn)(
            cond, torch.Generator().manual_seed(7))
        sample_err = float((plain - sharded).abs().max())
        if sample_err > 2e-5:
            raise AssertionError(f"sharded sampler differs by {sample_err}")
        if rank == 0:
            with open(os.path.join(workdir, "result.json"), "w") as f:
                json.dump({"mesh": list(mesh.shape), "loss": losses[False],
                           "zero1_loss": losses[True], "ring_err": ring_err,
                           "sample_err": sample_err,
                           "rank_s": time.perf_counter() - t0}, f)
    finally:
        dist.destroy_process_group()


def dryrun(world: int = 4) -> str:
    """Run the four phases on `world` spawned ranks; returns the ok line
    (raises when a rank fails)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hdt_dryrun_") as workdir:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(r, world, workdir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"dryrun: ranks exited with {codes}")
        with open(os.path.join(workdir, "result.json")) as f:
            res = json.load(f)
    return (f"dryrun ok: world={world} mesh={res['mesh'][0]}x{res['mesh'][1]} "
            f"loss={res['loss']:.4f} zero1_loss={res['zero1_loss']:.4f} "
            f"ring_attn=ok (max err {res['ring_err']:.2e}) "
            f"sharded_sampler=ok (max err {res['sample_err']:.2e}) "
            f"wall={time.perf_counter() - t0:.1f}s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=4)
    args = p.parse_args(argv)
    print(dryrun(args.world), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
