"""The device an entry point runs on.

Every entry point of the port takes `device="cuda"` by default and raises
without a card unless the caller asks for the CPU. Under several ranks
each rank runs on its own card (parallel/distributed.py::rank_device).
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
