"""PyTorch/CUDA port of hybrid_diffusion_tpu for an NVIDIA H100.

It imports torch and numpy, never JAX or the JAX package. Entry points run
on the card unless the caller passes device="cpu". Importing the package
registers the attention kernel's custom op (`hdt::attention_fwd`), which a
program saved by `serve.export_enhancer` calls.
"""

from . import ops
from .config import Config, flagship_config
