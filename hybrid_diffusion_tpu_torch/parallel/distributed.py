"""Process-group start-up, one process per rank.

Counterpart of `hybrid_diffusion_tpu/parallel/distributed.py` (:22-51).
A JAX process drives every local chip; PyTorch's idiom is one process per
card (torchrun), so a JAX device maps to a torch rank here.

`maybe_initialize` starts the default process group from torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or
when HDT_MULTIHOST=1, or when forced, and sets the rank's card. The
backend "cpu:gloo,cuda:nccl" sends CPU tensors through gloo and CUDA
tensors through NCCL (gloo alone where torch has no CUDA). Without any of
these it does nothing: a single process is unchanged and calls no
collective.
"""

from __future__ import annotations

import os
import torch
import torch.distributed as dist

DEFAULT_BACKEND = "cpu:gloo,cuda:nccl"


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def rank_device(device="cuda") -> torch.device:
    """The card this rank runs on: `device` as given when it names an index
    or the CPU; else cuda:LOCAL_RANK (cuda:0 without torchrun)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def maybe_initialize(force: bool = False, device=None) -> bool:
    """Start the default process group when running several ranks;
    idempotent. Returns True when a group is initialized (now or earlier).

    Triggers on torchrun's RANK and WORLD_SIZE, on HDT_MULTIHOST=1, or on
    `force` (then the env:// rendezvous must still find MASTER_ADDR and
    MASTER_PORT). `device` (default: cuda:LOCAL_RANK when a card is
    present) becomes the rank's current CUDA device before the group
    starts, so that NCCL binds to it.
    """
    if is_initialized():
        return True
    want = (force or os.environ.get("HDT_MULTIHOST") == "1"
            or ("RANK" in os.environ and "WORLD_SIZE" in os.environ))
    if not want:
        return False
    if device is None and torch.cuda.is_available():
        device = rank_device("cuda")
    if (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_available()):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(DEFAULT_BACKEND if torch.cuda.is_available()
                            else "gloo")
    return True


def process_info() -> dict:
    """Rank topology for logs and checkpoint gating (the JAX function's
    keys): this process's index, the process count, the cards this process
    sees, and the devices in the world (one a rank)."""
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": torch.cuda.device_count() or 1,
        "global_devices": world_size(),
    }
