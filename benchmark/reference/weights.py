"""A published flat params npz (flax layout, "/"-joined paths) as the
reference's state_dict: conv kernels HWIO → OIHW, dense kernels
(in, out) → (out, in), norm scales → weights, in fp32."""

from __future__ import annotations

import numpy as np
import torch


def state_dict_from_npz(path, device) -> dict[str, torch.Tensor]:
    out = {}
    with np.load(path) as z:
        for key in z.files:
            a = np.asarray(z[key], np.float32)
            parts = key.split("/")[1:] if key.startswith("params/") else key.split("/")
            leaf = parts[-1]
            if a.ndim == 4:                       # kernel, k3, k5, kt
                a = a.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and a.ndim == 2:
                a = a.T
            if leaf in ("kernel", "scale"):
                leaf = "weight"
            out[".".join(parts[:-1] + [leaf])] = torch.from_numpy(
                np.ascontiguousarray(a)).to(device)
    return out
