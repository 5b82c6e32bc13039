"""Flat-npz parameter files, read with numpy alone.

Counterpart of `hybrid_diffusion_tpu/utils/params_io.py:26-83`. The file is a
flat npz of the flax parameter tree, with path segments joined by "/" (for
example `params/middle_0/attn/in_proj/kernel`). Mapping those arrays onto the
port's modules and back is `weights.py`'s job.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a/b/c": np.ndarray}."""
    if not isinstance(params, Mapping):
        return {prefix: np.asarray(params)}
    flat: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        flat.update(flatten_params(value, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def load_params_npz(path) -> Dict[str, np.ndarray]:
    """Read a flat params npz into {path: array}, in its stored dtype."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_params_npz(path, flat: Dict[str, np.ndarray],
                    dtype: str = "float16") -> None:
    """Write {path: array} as a compressed flat npz, floating arrays cast to
    `dtype` (fp16 by default: lossless for the bf16 compute path, half the
    size)."""
    cast = np.dtype(dtype)
    np.savez_compressed(path, **{
        k: v.astype(cast) if np.issubdtype(v.dtype, np.floating) else v
        for k, v in flat.items()})
