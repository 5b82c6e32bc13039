"""Time and condition embeddings.

Counterpart of `hybrid_diffusion_tpu/models/embeddings.py`:
`sinusoidal_table`, `TimeEmbedding`, `ImageConditionEmbedding` and the
classifier-free-guidance model's `LabelEmbedding`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense, StridedConv


def sinusoidal_table(T: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos position table of shape (T, d_model), columns
    sin0, cos0, sin1, cos1, ... with frequencies exp(-log(10000)·2i/d)."""
    if d_model % 2:
        raise ValueError(f"d_model must be even, got {d_model}")
    freqs = np.exp(-np.arange(0, d_model, 2) / d_model * np.log(10000.0))
    args = np.arange(T, dtype=np.float64)[:, None] * freqs[None, :]
    table = np.stack([np.sin(args), np.cos(args)], axis=-1).reshape(T, d_model)
    return table.astype(np.float32)


class TimeEmbedding(nn.Module):
    """Trainable sinusoidal-init timestep table -> Dense -> SiLU -> Dense."""

    def __init__(self, T: int, d_model: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.table = nn.Parameter(torch.from_numpy(sinusoidal_table(T, d_model)))
        self.dense1 = Dense(d_model, dim, dtype)
        self.dense2 = Dense(dim, dim, dtype)
        self.dtype = dtype

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = self.table[t.long()].to(self.dtype)
        return self.dense2(F.silu(self.dense1(emb)))


class ImageConditionEmbedding(nn.Module):
    """Three stride-2 SAME 3×3 convs (no nonlinearity between them), global
    average pool, Dense -> SiLU -> Dense. Input NCHW."""

    def __init__(self, d_model: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = d_model // 16
        self.conv1 = StridedConv(3, ch, 3, dtype)
        self.conv2 = StridedConv(ch, ch * 2, 3, dtype)
        self.conv3 = StridedConv(ch * 2, ch * 4, 3, dtype)
        self.dense1 = Dense(ch * 4, dim, dtype)
        self.dense2 = Dense(dim, dim, dtype)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = self.conv3(self.conv2(self.conv1(image)))
        x = x.mean(dim=(2, 3))
        return self.dense2(F.silu(self.dense1(x)))


class LabelEmbedding(nn.Module):
    """Integer labels -> a (num_labels + 1, d_model) table -> Dense -> SiLU
    -> Dense. Label 0 is the null (unconditional) slot.

    Row 0 is replaced by zeros at every forward, as the JAX module's
    `table.at[0].set(0.0)` does: a table loaded with a non-zero row 0 still
    embeds label 0 as zero, and no gradient reaches row 0.
    (`nn.Embedding(padding_idx=0)` zeroes the row only at init.) The table
    is N(0, 1) at init, the Dense layers torch's default.
    """

    def __init__(self, num_labels: int, d_model: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.table = nn.Parameter(torch.randn(num_labels + 1, d_model))
        self.dense1 = Dense(d_model, dim, dtype)
        self.dense2 = Dense(dim, dim, dtype)
        self.dtype = dtype

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        table = torch.cat([torch.zeros_like(self.table[:1]), self.table[1:]])
        emb = table[labels.long()].to(self.dtype)
        return self.dense2(F.silu(self.dense1(emb)))
