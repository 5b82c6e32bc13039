"""Dataset preview: a grid of (degraded, GT) pairs saved to a file.

Counterpart of `hybrid_diffusion_tpu/data/visualize.py`: draws the first
batch of a BatchLoader with matplotlib (Agg, no window), rows alternating
degraded and GT so that each column is one aligned pair.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_batch_grid(loader, num_images: int = 8,
                    out_path: str = "dataset_preview.png",
                    cols: int = 4) -> Optional[str]:
    """Save a preview grid of the first batch; returns the path, or None
    (with a message) when matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[visualize] matplotlib unavailable; skipping preview")
        return None

    batch = next(iter(loader))
    inputs = np.asarray(batch["input"])[:num_images]
    gts = np.asarray(batch["gt"])[:num_images]
    n = inputs.shape[0]
    rows = 2 * ((n + cols - 1) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 1.5 * rows))
    axes = np.atleast_1d(axes).flatten()
    for i in range(n):
        block = (i // cols) * 2 * cols + (i % cols)
        for ax, img, tag in ((axes[block], inputs[i], "in"),
                             (axes[block + cols], gts[i], "gt")):
            ax.imshow(np.clip(img, 0, 255).astype(np.uint8))
            ax.set_title(f"{tag} {i}", fontsize=7)
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return out_path
