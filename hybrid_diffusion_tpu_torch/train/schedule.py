"""Learning-rate schedule: linear warmup ×multiplier, then cosine annealing.

Counterpart of `hybrid_diffusion_tpu/train/schedule.py`. A function of the
optimizer-step index, with epoch = step // steps_per_epoch:

    epoch e ≤ W:  lr = base · ((multiplier − 1) · e / W + 1)
    epoch e > W:  lr = base · multiplier · ½(1 + cos(π · clip((e − W) / T, 0, 1)))

computed in float32 as the JAX schedule is. Like optax, the train state
evaluates it at the count of updates made BEFORE the current one, so the
first update uses schedule(0).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def warmup_cosine_schedule(base_lr: float, total_epochs: int,
                           steps_per_epoch: int, multiplier: float = 2.0,
                           warm_epochs: int | None = None
                           ) -> Callable[[int], float]:
    """Returns schedule(step) -> lr."""
    if warm_epochs is None:
        warm_epochs = max(total_epochs // 10, 1)
    warm_epochs = max(warm_epochs, 1)
    f32 = np.float32

    def schedule(step: int) -> float:
        e = f32(step // steps_per_epoch)
        if e <= warm_epochs:
            return float(f32(base_lr) * ((f32(multiplier - 1.0) * e
                                          / f32(warm_epochs)) + f32(1.0)))
        prog = np.clip((e - f32(warm_epochs)) / f32(total_epochs), f32(0.0),
                       f32(1.0))
        return float(f32(base_lr * multiplier * 0.5)
                     * (f32(1.0) + np.cos(f32(np.pi) * prog)))

    return schedule
