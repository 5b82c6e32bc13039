"""The device an entry point runs on, and the one-process rule.

Every entry point of the port takes `device="cuda"` by default and raises
without a card unless the caller asks for the CPU. The port runs in one
process on one card: data and model parallelism are not ported
(ROADMAP.md, queue 1, item 7), so `train()` and `evaluate()` refuse to run
under an initialized `torch.distributed` process group rather than train
unsynchronised replicas.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The card unless the caller asks for the CPU; raises without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def require_single_process() -> None:
    """Raise when a torch.distributed process group is initialized."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        raise NotImplementedError(
            "the port runs in one process on one card; several ranks (data "
            "or model parallelism) are not ported yet (ROADMAP.md, queue 1, "
            "item 7)")
