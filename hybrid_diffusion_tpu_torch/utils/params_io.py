"""Flat-npz parameter files, read with numpy alone.

Counterpart of `hybrid_diffusion_tpu/utils/params_io.py:26-83`. The file is a
flat npz of the flax parameter tree, with path segments joined by "/" (for
example `params/middle_0/attn/in_proj/kernel`). Mapping those arrays onto the
port's modules is `weights.py`'s job.
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
