"""PyTorch/CUDA port of hybrid_diffusion_tpu for an NVIDIA H100.

It imports torch and numpy, never JAX or the JAX package. Entry points run
on the card unless the caller passes device="cpu".
"""

from .config import Config, flagship_config
