"""Fused spatial self-attention for the U-Net bottleneck.

Counterpart of `hybrid_diffusion_tpu/ops/attention.py`:

  - `attention_reference`: the plain PyTorch version, the einsum/softmax
    form of the JAX `_xla_attention` (fp32 scores and softmax). The CPU path
    and the tests use it.
  - `fused_spatial_attention`: the wrapper. A CPU tensor goes to
    `attention_reference`; a CUDA tensor goes to a hand-written CUDA kernel
    in `csrc/attention.cu` (which replaces the TPU's `_pallas_attention`) or
    the call raises. Both kernels run on the tensor cores: bf16 and fp16
    take `attention_fwd` (16-bit products), fp32 takes `attention_fwd_fp32`
    (each product as three TF32 products, fp32-accurate). There is no
    fallback from the card to the plain version or from one kernel to the
    other.
  - `attention_fwd`, the custom op `hdt::attention_fwd` (torch.library):
    its CUDA implementation launches the kernel, its CPU implementation is
    the plain version, and its fake implementation gives the output's
    shape, so that `torch.export` traces through the op (it cannot trace
    the ctypes call) and an exported program launches the same kernel.
    Importing this module (or the package) registers it.
  - `RecomputedBackwardAttention`: reverse mode, as the JAX package's
    `_pallas_attention_diff`: the forward is the kernel, the backward
    differentiates `attention_reference` at the saved q, k, v (there is no
    backward kernel; the JAX package has none either). CUDA tensors that
    require grad go through it.

Tensors are (B, N, heads, head_dim), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
import re

import torch

from ..utils import cuda_build

SOURCE = "attention.cu"
HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
KERNEL_BY_DTYPE = {torch.bfloat16: "attention_fwd",
                   torch.float16: "attention_fwd",
                   torch.float32: "attention_fwd_fp32"}

# Launches of the CUDA kernels in this process, one per launch and nowhere
# else: in all, and by kernel.
launch_count = 0
launch_counts = dict.fromkeys(KERNEL_BY_DTYPE.values(), 0)
_library: cuda_build.BuiltLibrary | None = None


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0
    for name in launch_counts:
        launch_counts[name] = 0


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, N, h, d) -> (B, N, h, d). Scores and softmax in fp32.

    Mirrors `_xla_attention`: the probabilities are cast to the input dtype
    before the product with v, which accumulates in fp32.
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def bind(lib: ctypes.CDLL):
    """The library's `hd_attention_fwd`, with its C signature set."""
    fn = lib.hd_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def load_kernel() -> cuda_build.BuiltLibrary:
    """Build (at first use) and load the CUDA attention library."""
    global _library
    if _library is None:
        built = cuda_build.build(SOURCE)
        bind(built.lib)
        _library = built
    return _library


# attention_fwd_mma_kernel<T, D> (bf16, fp16) and
# attention_fwd_tf32_kernel<D, M16 tiles a warp> (fp32), mangled.
_SYMBOL = re.compile(r"(attention_fwd_mma_kernel)I(13__nv_bfloat16|6__half)Li(\d+)E"
                     r"|(attention_fwd_tf32_kernel)ILi(\d+)ELi(\d+)E")
_MANGLED_DTYPES = {"13__nv_bfloat16": torch.bfloat16, "6__half": torch.float16}


def kernel_instance(symbol: str) -> tuple[str, torch.dtype, int] | None:
    """(kernel, dtype, head_dim) of a mangled kernel symbol of this
    library, or None for another symbol. The fp32 kernel's name carries its
    m16 tiles a warp: `attention_fwd_tf32_kernel/m2`."""
    m = _SYMBOL.search(symbol)
    if m is None:
        return None
    if m.group(1):
        return m.group(1), _MANGLED_DTYPES[m.group(2)], int(m.group(3))
    return f"{m.group(4)}/m{m.group(6)}", torch.float32, int(m.group(5))


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"attention: {name} has shape {tuple(t.shape)}, "
                             f"q has {tuple(q.shape)}")
        if t.dim() != 4:
            raise ValueError(f"attention: {name} must be (B, N, h, d), got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"attention: {name} must be contiguous in its "
                             f"last (head_dim) axis, strides {t.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel takes float32, float16 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    # Both kernels copy 16-byte chunks of each row: 8 elements of bf16 or
    # fp16, 4 of fp32.
    per_chunk = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(s % per_chunk for s in strides):
            raise ValueError(
                f"attention kernel ({q.dtype}) needs {name} 16-byte aligned "
                f"with strides in multiples of {per_chunk} elements, got "
                f"address {t.data_ptr():#x} and strides {t.stride()}")


def call_library(fn, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """One call of a library's `hd_attention_fwd` (`fn`, as `bind` gives
    it) on checked CUDA tensors; counts nothing."""
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, N, H, D, _DTYPE_CODES[q.dtype],
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err} "
                           f"(B={B}, N={N}, h={H}, d={D}, {q.dtype})")
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launch_count
    _check_cuda_inputs(q, k, v)
    out = call_library(load_kernel().lib.hd_attention_fwd, q, k, v)
    if out.numel() == 0:
        return out
    launch_count += 1
    launch_counts[KERNEL_BY_DTYPE[q.dtype]] += 1
    return out


@torch.library.custom_op("hdt::attention_fwd", mutates_args=(),
                         device_types="cuda")
def attention_fwd(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v as one op: the CUDA kernel on the card (checked,
    counted; it raises where the kernel does not take the inputs)."""
    return _launch(q, k, v)


@attention_fwd.register_kernel("cpu")
def _attention_fwd_cpu(q, k, v):
    return attention_reference(q, k, v).contiguous()


@attention_fwd.register_fake
def _attention_fwd_fake(q, k, v):
    return q.new_empty(q.shape)


class RecomputedBackwardAttention(torch.autograd.Function):
    """`forward_fn(q, k, v)` forward; the backward recomputes through
    `attention_reference` at the saved inputs and returns its grads (the
    design of the JAX package's `_pallas_attention_bwd`).

    The grads are contiguous (B, N, h, d) tensors: autograd carries them back
    through the strided views of the packed projection they came from.
    """

    @staticmethod
    def forward(ctx, q, k, v, forward_fn):
        ctx.save_for_backward(q, k, v)
        return forward_fn(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_reference(q, k, v)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad_out)
        return dq, dk, dv, None


def fused_spatial_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Scaled-dot-product attention over (B, N, heads, head_dim) tensors.

    Without grad, the op `attention_fwd`: the CUDA kernel on the card, the
    plain version on the CPU. With grad, CUDA tensors take the op inside
    `RecomputedBackwardAttention`, CPU tensors autograd of the plain version.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.device.type == "cpu":
            return attention_reference(q, k, v)
        return RecomputedBackwardAttention.apply(q, k, v, attention_fwd)
    return attention_fwd(q, k, v)
