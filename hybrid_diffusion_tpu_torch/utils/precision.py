"""The fp32 mode's precision, set per call.

PyTorch's defaults leave `torch.backends.cudnn.allow_tf32` on, so an fp32
convolution on the card runs in TF32 (10-bit mantissa products) unless the
caller turns the flag off. The JAX reference computes fp32 in fp32. So every
entry point of the port that runs in fp32 (`Config(bf16=False)`) wraps its
device work in `precision_for(bf16)`: TF32 off for cuDNN and for matmuls
inside the call, the caller's flags restored after it. The bf16 path is left
as the caller set it.

The flags are process-wide, so a call from another thread while this one
runs sees them off too; nothing here changes them outside a call.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """TF32 off for cuDNN and cuBLAS inside the block; the flags as they
    were after it, also when the block raises."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def precision_for(bf16: bool) -> contextlib.AbstractContextManager:
    """The precision of a call of the mode: the caller's flags for bf16,
    `full_fp32()` for fp32."""
    return contextlib.nullcontext() if bf16 else full_fp32()
