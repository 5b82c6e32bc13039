"""Carry flax parameters across to the port's modules, and back.

The port names its modules after the flax ones, so a flax path maps onto a
`state_dict` key by joining the segments with "." and renaming the leaf:

  - a conv kernel (HWIO, 4-d `kernel`, and DownSample/UpSample's `k3`, `k5`,
    `kt`) becomes OIHW;
  - a dense kernel (in, out) becomes `weight` (out, in); the packed
    attention `in_proj` is (C, 3C) with q|k|v in that order, and keeps it;
  - the ViT's flax `DenseGeneral` kernels: `query`, `key`, `value` (D, h, d)
    and `out` (h, d, D) become (D, D) weights, their (h, d) biases (D,);
  - a GroupNorm or LayerNorm `scale` becomes `weight`; every `bias` stays
    `bias`;
  - `time_embedding/table` and the CFG model's `cond_embedding/table`, the
    ViT's `cls_token`, `pos_embed` and LayerScale `gamma_1`, `gamma_2`, and
    the VGG towers' BatchNorm arrays (`bn_{i}_scale`, `_bias`, `_mean`,
    `_var`, all flax params) are parameters and keep their names.

Stored fp16 becomes fp32 master weights. `inception_state_dict_from_flat`
also carries the JAX FID's Inception variables, BatchNorm statistics
(`batch_stats/.../mean`, `var`) included. `flat_from_state_dict` is the
inverse: a state_dict becomes the flat `params/...` arrays that the JAX
package's `load_params_npz` reads, and `save_npz_state_dict` writes them as
its `save_params_npz` does (fp16 by default).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .utils.params_io import load_params_npz, save_params_npz

_CONV_KERNELS = ("k3", "k5", "kt")
_KEPT = ("bias", "scale", "table", "b3", "b5", "bt", "gamma_1", "gamma_2",
         "cls_token", "pos_embed")
_DENSE_GENERAL_IN = ("query", "key", "value")
_VGG_BN = re.compile(r"bn_\d+_(scale|bias|mean|var)")


def _kept(leaf: str) -> bool:
    return leaf in _KEPT or _VGG_BN.fullmatch(leaf) is not None


def _convert(path: str, array: np.ndarray) -> tuple[str, np.ndarray]:
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    if leaf == "kernel" and array.ndim == 4 or leaf in _CONV_KERNELS:
        array = array.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    elif leaf == "kernel" and array.ndim == 2:
        array = array.T                              # (in, out) -> (out, in)
    elif leaf == "kernel" and array.ndim == 3 and parent in _DENSE_GENERAL_IN:
        array = array.reshape(array.shape[0], -1).T  # (D, h, d) -> (h·d, D)
    elif leaf == "kernel" and array.ndim == 3 and parent == "out":
        array = array.reshape(-1, array.shape[-1]).T  # (h, d, D) -> (D, h·d)
    elif leaf == "bias" and array.ndim == 2 and parent in _DENSE_GENERAL_IN:
        array = array.reshape(-1)                    # (h, d) -> (h·d,)
    elif not _kept(leaf):
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


def flat_from_state_dict(state: Mapping[str, torch.Tensor],
                         num_heads: int = 6) -> Dict[str, np.ndarray]:
    """The port's state_dict -> {"params/...": fp32 array} in flax's layout
    (the inverse of `state_dict_from_flat`). `num_heads` splits the ViT's
    query/key/value/out weights into flax's (D, h, d) and (h, d, D)."""
    flat: Dict[str, np.ndarray] = {}
    for key, tensor in state.items():
        array = tensor.detach().float().cpu().numpy()
        parts = key.split(".")
        leaf = parts[-1]
        parent = parts[-2] if len(parts) > 1 else ""
        if leaf == "weight" and array.ndim == 1:
            leaf = "scale"
        elif leaf == "weight" and array.ndim == 4:
            leaf, array = "kernel", array.transpose(2, 3, 1, 0)   # -> HWIO
        elif leaf in _CONV_KERNELS:
            array = array.transpose(2, 3, 1, 0)
        elif leaf == "weight" and parent in _DENSE_GENERAL_IN:
            leaf, array = "kernel", array.T.reshape(array.shape[1], num_heads, -1)
        elif leaf == "weight" and parent == "out":
            leaf, array = "kernel", array.T.reshape(num_heads, -1, array.shape[0])
        elif leaf == "weight" and array.ndim == 2:
            leaf, array = "kernel", array.T
        elif leaf == "bias" and parent in _DENSE_GENERAL_IN:
            array = array.reshape(num_heads, -1)
        elif not _kept(leaf):
            raise KeyError(f"no mapping for state_dict key {key!r} of shape "
                           f"{array.shape}")
        flat["/".join(["params", *parts[:-1], leaf])] = np.ascontiguousarray(array)
    return flat


def save_npz_state_dict(path, state: Mapping[str, torch.Tensor],
                        dtype: str = "float16", num_heads: int = 6) -> None:
    """Write a state_dict as the flat npz that the JAX package's
    `load_params_npz` reads (fp16 by default, as its `save_params_npz`)."""
    save_params_npz(path, flat_from_state_dict(state, num_heads), dtype)


_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def inception_state_dict_from_flat(flat: Dict[str, np.ndarray]
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX `InceptionV3Features` variables as a flat {path: array}
    ("params/.../conv/kernel", "params/.../bn/scale" and "bias",
    "batch_stats/.../bn/mean" and "var") -> the port's state_dict (conv
    kernels OIHW, BatchNorm weight, bias, running_mean, running_var), in
    fp32."""
    params, out = {}, {}
    for path, array in flat.items():
        parts = path.split("/")
        if parts[0] == "batch_stats":
            key = ".".join(parts[1:-1] + [_BN_STATS[parts[-1]]])
            out[key] = torch.from_numpy(np.array(array, np.float32, order="C"))
        else:
            params[path] = array
    out.update(state_dict_from_flat(params))
    return out

