"""Carry flax parameters across to the port's modules.

The port names its modules after the flax ones, so a flax path maps onto a
`state_dict` key by joining the segments with "." and renaming the leaf:

  - a conv kernel (HWIO, 4-d `kernel`, and DownSample/UpSample's `k3`, `k5`,
    `kt`) becomes OIHW;
  - a dense kernel (in, out) becomes `weight` (out, in); the packed
    attention `in_proj` is (C, 3C) with q|k|v in that order, and keeps it;
  - a GroupNorm `scale` becomes `weight`; every `bias` stays `bias`;
  - `time_embedding/table` is a parameter and keeps its name.

Stored fp16 becomes fp32 master weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .utils.params_io import load_params_npz

_CONV_KERNELS = ("k3", "k5", "kt")


def _convert(path: str, array: np.ndarray) -> tuple[str, np.ndarray]:
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    if leaf == "kernel" and array.ndim == 4 or leaf in _CONV_KERNELS:
        array = array.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    elif leaf == "kernel" and array.ndim == 2:
        array = array.T                              # (in, out) -> (out, in)
    elif leaf not in ("bias", "scale", "table", "b3", "b5", "bt"):
        raise KeyError(f"no mapping for parameter {path!r} of shape "
                       f"{array.shape}")
    if leaf in ("kernel", "scale"):
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), array


def state_dict_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{flax path: array} -> the port's state_dict, in fp32. `flat` is a
    params npz as read by `load_params_npz`, or a JAX param tree flattened
    by `utils.params_io.flatten_params`."""
    out: Dict[str, torch.Tensor] = {}
    for path, array in flat.items():
        key, array = _convert(path, np.asarray(array))
        out[key] = torch.from_numpy(np.array(array, np.float32, order="C"))
    return out


def load_npz_state_dict(path) -> Dict[str, torch.Tensor]:
    """A flat params npz file -> the port's state_dict, in fp32."""
    return state_dict_from_flat(load_params_npz(path))
