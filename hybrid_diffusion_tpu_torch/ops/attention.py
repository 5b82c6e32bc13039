"""Fused spatial self-attention for the U-Net bottleneck.

Counterpart of `hybrid_diffusion_tpu/ops/attention.py`:

  - `attention_reference`: the plain PyTorch version, the einsum/softmax
    form of the JAX `_xla_attention` (fp32 scores and softmax). The CPU path
    and the tests use it.
  - `fused_spatial_attention`: the wrapper. A CPU tensor goes to
    `attention_reference`; a CUDA tensor goes to a hand-written CUDA kernel
    in `csrc/attention.cu` (which replaces the TPU's `_pallas_attention`) or
    the call raises. Both kernels run on the tensor cores: bf16 and fp16
    take `attention_fwd` (16-bit products: Hopper's wgmma fed by TMA at d 32
    from N 257 and at d 64, mma.sync elsewhere, as the C dispatch chooses;
    `kernel_route` names the kernel), fp32 takes `attention_fwd_fp32` (each
    product as three TF32 products, fp32-accurate, on mma.sync). There is
    no fallback from the card to the plain version or from one kernel to
    the other.
  - `attention_fwd`, the custom op `hdt::attention_fwd` (torch.library):
    its CUDA implementation launches the kernel, its CPU implementation is
    the plain version, and its fake implementation gives the output's
    shape, so that `torch.export` traces through the op (it cannot trace
    the ctypes call) and an exported program launches the same kernel.
    Importing this module (or the package) registers it.
  - `KernelBackwardAttention`: reverse mode of CUDA tensors that require
    grad, the counterpart of the JAX package's `_pallas_attention_diff`.
    Its forward is the kernel that also writes each query row's
    log-sum-exp (`attention_forward_lse`), its backward a hand-written
    kernel (`attention_backward`, `hd_attention_bwd` in
    `csrc/attention.cu`: bf16 on wgmma and TMA at d 32 from N 257, bf16
    and fp16 on mma.sync elsewhere, fp32 as 3xTF32 on mma.sync), which
    computes what the JAX backward `_pallas_attention_bwd` (the vjp of
    `_xla_attention`) does. Their plain twins,
    `attention_forward_lse_reference` and `attention_backward_reference`,
    take CPU tensors.

Tensors are (B, N, heads, head_dim), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
import re

import torch

from ..utils import cuda_build

SOURCE = "attention.cu"
ROUTE_HEADER = "attention_route.h"  # the C dispatch's routes, plain C++
HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
KERNEL_BY_DTYPE = {torch.bfloat16: "attention_fwd",
                   torch.float16: "attention_fwd",
                   torch.float32: "attention_fwd_fp32"}
# The backward kernels' names (the 16-bit one's first), and the dtypes they
# take.
BACKWARD_KERNEL = "attention_bwd"
BACKWARD_KERNEL_BY_DTYPE = {torch.bfloat16: BACKWARD_KERNEL,
                            torch.float16: BACKWARD_KERNEL,
                            torch.float32: "attention_bwd_fp32"}
BACKWARD_DTYPES = tuple(BACKWARD_KERNEL_BY_DTYPE)

# Launches of the CUDA kernels in this process, one per launch and nowhere
# else: in all, and by kernel. A backward counts once, though it runs two or
# three kernels (a pre-pass, the main kernel and, in bf16 and fp16, dQ's
# conversion).
launch_count = 0
launch_counts = dict.fromkeys([*KERNEL_BY_DTYPE.values(),
                               *BACKWARD_KERNEL_BY_DTYPE.values()], 0)
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


def attention_forward_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): `attention_reference`'s output and each query row's
    log-sum-exp of the scores in the exp2 domain, log2 Σ_k exp2(s·c) with
    c = log2(e)/√d, as a contiguous fp32 (B, h, N) tensor: the plain twin
    of `attention_forward_lse`. P = exp2(s·c − lse)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    lse = torch.logsumexp(scores * (1.0 / math.sqrt(d)), dim=-1) * math.log2(math.e)
    return attention_reference(q, k, v), lse.contiguous()


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, dout: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(dq, dk, dv) of out = attention_reference(q, k, v) for the incoming
    gradient `dout`, by FlashAttention-2's algebra from the forward's output
    and lse: the plain twin of `attention_backward`. fp32 inside, outputs
    contiguous (B, N, h, d) in the input dtype. P is rounded to the input
    dtype for dV and dP = dO·Vᵀ after its product, where the vjp of
    `_xla_attention` rounds them; D = rowsum(dO∘O) stands in for
    rowsum(P∘dP), which it equals in exact arithmetic."""
    dt, d = q.dtype, q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.exp2(scores * (scale * math.log2(math.e)) - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf).to(dt).float()
    delta = (gf * of).sum(-1).transpose(1, 2)[..., None]  # (B, h, N, 1)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return tuple(x.to(dt).contiguous() for x in (dq, dk, dv))


# The backward kernel's tolerance against the fp32 plain version's autograd,
# in `grad_rel_err`, by (dtype, inputs): the card checks (chip_smoke.py) hold
# it on random normal inputs and on mask-trap ones (every score about −30,
# where dQ is a near-cancellation, measured against the largest of the three
# gradients). The kernel's CPU emulation (tests/test_torch_attention_bwd.py)
# errs by at most 6.3e-3 (bf16), 3.7e-4 (fp16) and 2.8e-2 (fp16, mask trap)
# at the card checks' shapes cut to B·h = 2: P, dP and dS are rounded to the
# input type, and D is rowsum(dO∘O) of the rounded output. Each tolerance is
# 4.7, 4.7 and 4.5 times that error. fp32 (3xTF32, nothing rounded to 16
# bits; tests/test_torch_attention_bwd_tf32.py): the emulation errs by at
# most 4.05e-6 (N 1000, d 64), sums of up to N products in fp32 against the
# plain autograd's own fp32 sums; 2e-5 is 4.9 times that. dQ's atomics
# reorder at most N/64 fp32 additions of each value.
BWD_RTOL = {("bfloat16", "randn"): 3e-2, ("float16", "randn"): 1.75e-3,
            ("float16", "mask trap"): 0.125, ("float32", "randn"): 2e-5}


# One H100 SXM's peaks (NVIDIA's data sheet, dense): FLOP/s of the products
# by input type (fp32 on the TF32 tensor cores) and bytes/s of device memory.
H100_PEAKS = {"flops": {"bfloat16": 989e12, "float16": 989e12,
                        "float32": 495e12},
              "bytes": 3.35e12}


def bound_ms(flops: float, nbytes: float, dname: str) -> tuple[float, str]:
    """(ms, what binds it): the least time an H100 could take for work of
    `flops` products of type `dname` and `nbytes` moved, the larger of the
    two times at H100_PEAKS."""
    times = {"operations": flops / H100_PEAKS["flops"][dname],
             "bytes": nbytes / H100_PEAKS["bytes"]}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def grad_rel_err(ours, ref, common_scale: bool = False) -> float:
    """The largest, over the gradients (dq, dk, dv), of max|ours − ref| /
    max|ref|: each gradient against its own scale, or with `common_scale`
    against the largest of the three."""
    ours, ref = [a.float() for a in ours], [b.float() for b in ref]
    scales = [b.abs().max() for b in ref]
    if common_scale:
        scales = [max(scales)] * len(ref)
    return max(float((a - b).abs().max() / c)
               for a, b, c in zip(ours, ref, scales))


def bind(lib: ctypes.CDLL):
    """The library's `hd_attention_fwd`, with its C signature set, and the
    signatures of `hd_attention_fwd_lse`, `hd_attention_bwd` and
    `hd_attention_route`."""
    fn = lib.hd_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.hd_attention_fwd_lse.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 9
        + [ctypes.c_void_p])
    lib.hd_attention_fwd_lse.restype = ctypes.c_int
    lib.hd_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 15
        + [ctypes.c_void_p])
    lib.hd_attention_bwd.restype = ctypes.c_int
    lib.hd_attention_route.argtypes = [ctypes.c_int] * 4
    lib.hd_attention_route.restype = ctypes.c_char_p
    return fn


def load_kernel() -> cuda_build.BuiltLibrary:
    """Build (at first use) and load the CUDA attention library."""
    global _library
    if _library is None:
        built = cuda_build.build(SOURCE)
        bind(built.lib)
        _library = built
    return _library


# The tensor-core kernels, mangled: attention_fwd_wgmma_kernel<T, D, LSE>
# and attention_bwd_wgmma_kernel<T, D> (bf16, fp16 on wgmma), their mma.sync
# counterparts attention_fwd_mma_kernel<T, D, LSE> and
# attention_bwd_mma_kernel<T, D>; fp32: attention_fwd_tf32_kernel<D, M16
# tiles a warp, LSE> and attention_bwd_tf32_kernel<D>. The backward's
# pre-pass and dQ conversion run no product and are not matched.
_SYMBOL = re.compile(r"(attention_(?:fwd|bwd)_(?:mma|wgmma)_kernel)"
                     r"I(13__nv_bfloat16|6__half)Li(\d+)E(?:Lb([01])E)?"
                     r"|(attention_fwd_tf32_kernel)ILi(\d+)ELi(\d+)ELb([01])E"
                     r"|(attention_bwd_tf32_kernel)ILi(\d+)E")
_MANGLED_DTYPES = {"13__nv_bfloat16": torch.bfloat16, "6__half": torch.float16}


def kernel_instance(symbol: str) -> tuple[str, torch.dtype, int] | None:
    """(kernel, dtype, head_dim) of a mangled tensor-core kernel symbol of
    this library, or None for another symbol. A forward that writes the
    log-sum-exp ends in `/lse` (`attention_fwd_mma_kernel/lse`); the fp32
    forward's name carries its m16 tiles a warp:
    `attention_fwd_tf32_kernel/m2`, `attention_fwd_tf32_kernel/m1/lse`."""
    m = _SYMBOL.search(symbol)
    if m is None:
        return None
    if m.group(1):
        name = m.group(1) + ("/lse" if m.group(4) == "1" else "")
        return name, _MANGLED_DTYPES[m.group(2)], int(m.group(3))
    if m.group(5):
        name = f"{m.group(5)}/m{m.group(7)}" + ("/lse" if m.group(8) == "1"
                                                 else "")
        return name, torch.float32, int(m.group(6))
    return m.group(9), torch.float32, int(m.group(10))


def kernel_route(dtype: torch.dtype, n: int, head_dim: int,
                 backward: bool = False, lib: ctypes.CDLL | None = None) -> str:
    """The kernel that the library launches for a forward (or backward) of
    this dtype, sequence length and head_dim, as its C dispatch chooses
    (`hd_attention_route`, csrc/attention_route.h): a wgmma kernel or an
    mma.sync one. Asks `lib`, by default the library, built at first use (on
    the card's machine)."""
    lib = lib or load_kernel().lib
    lib.hd_attention_route.argtypes = [ctypes.c_int] * 4
    lib.hd_attention_route.restype = ctypes.c_char_p
    return lib.hd_attention_route(int(backward), _DTYPE_CODES[dtype], n,
                                  head_dim).decode()


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _chunk_aligned(t):
            per_chunk = 16 // q.element_size()
            raise ValueError(
                f"attention kernel ({q.dtype}) needs {name} 16-byte aligned "
                f"with strides in multiples of {per_chunk} elements, got "
                f"address {t.data_ptr():#x} and strides {t.stride()}")


def _chunk_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels can read (B, N, h, d) `t` in 16-byte chunks: d
    contiguous, the address 16-byte aligned, and every stride of an axis
    longer than 1 a multiple of 16 bytes."""
    per_chunk = 16 // t.element_size()
    strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and not any(s % per_chunk for s in strides))


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


def call_library_lse(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) from one call of a library's `hd_attention_fwd_lse` (the
    library as `bind` set it up) on CUDA tensors it checks; counts
    nothing."""
    _check_cuda_inputs(q, k, v)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hd_attention_fwd_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, N, H, D, _DTYPE_CODES[q.dtype],
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel (lse) launch failed: cudaError "
                           f"{err} (B={B}, N={N}, h={H}, d={D}, {q.dtype})")
    return out, lse


def _require_cuda(q: torch.Tensor) -> None:
    """The kernels' launchers take CUDA tensors only: the CPU's plain twins
    are `attention_forward_lse_reference` and `attention_backward_reference`."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel takes CUDA tensors, got {q.device}")


def attention_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of CUDA (B, N, h, d) q, k, v: the forward
    kernel's instance that also writes the log-sum-exp (checked, counted as
    the forward; it raises where the kernel does not take the inputs)."""
    global launch_count
    _require_cuda(q)
    out, lse = call_library_lse(load_kernel().lib, q, k, v)
    if out.numel():
        launch_count += 1
        launch_counts[KERNEL_BY_DTYPE[q.dtype]] += 1
    return out, lse


def call_library_bwd(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                     dout: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from one call of a library's `hd_attention_bwd` (the
    library as `bind` set it up) on CUDA tensors it checks; counts
    nothing."""
    _check_cuda_inputs(q, k, v)
    B, N, H, D = q.shape
    for name, t, dtype, shape in (("out", out, q.dtype, q.shape),
                                  ("dout", dout, q.dtype, q.shape),
                                  ("lse", lse, torch.float32, (B, H, N))):
        if t.device != q.device or t.dtype != dtype or t.shape != shape:
            raise ValueError(f"attention backward: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {tuple(shape)} on {q.device}")
    # Autograd may hand over a gradient that the kernel cannot read in
    # 16-byte chunks (an expanded or misaligned view): copied, only then.
    out, dout = (t if _chunk_aligned(t) else t.contiguous() for t in (out, dout))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    # fp32 sums dQ into dq itself; bf16 and fp16 into an fp32 scratch.
    dq_acc = dq if q.dtype == torch.float32 else torch.empty(
        (B, N, H, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hd_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, N, H, D, _DTYPE_CODES[q.dtype],
            *(t.stride(i) for t in (q, k, v, out, dout) for i in range(3)),
            stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: "
                           f"cudaError {err} (B={B}, N={N}, h={H}, d={D}, "
                           f"{q.dtype})")
    return dq, dk, dv


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), contiguous (B, N, h, d), of CUDA tensors: the backward
    kernel (checked, counted; it raises where the kernel does not take the
    inputs)."""
    global launch_count
    _require_cuda(q)
    grads = call_library_bwd(load_kernel().lib, q, k, v, out, lse, dout)
    if grads[0].numel():
        launch_count += 1
        launch_counts[BACKWARD_KERNEL_BY_DTYPE[q.dtype]] += 1
    return grads


class KernelBackwardAttention(torch.autograd.Function):
    """`forward_fn(q, k, v) -> (out, lse)` forward, which saves q, k, v, out
    and lse; `backward_fn(q, k, v, out, lse, grad_out) -> (dq, dk, dv)`
    backward. On the card these are the kernels `attention_forward_lse` and
    `attention_backward`; the CPU tests inject their plain twins.

    The grads are contiguous (B, N, h, d) tensors: autograd carries them back
    through the strided views of the packed projection they came from.
    """

    @staticmethod
    def forward(ctx, q, k, v, forward_fn, backward_fn):
        out, lse = forward_fn(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.backward_fn = backward_fn
        return out

    @staticmethod
    def backward(ctx, grad_out):
        dq, dk, dv = ctx.backward_fn(*ctx.saved_tensors, grad_out)
        return dq, dk, dv, None, None


def fused_spatial_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Scaled-dot-product attention over (B, N, heads, head_dim) tensors.

    Without grad, the op `attention_fwd`: the CUDA kernel on the card, the
    plain version on the CPU. With grad, CPU tensors take autograd of the
    plain version, CUDA tensors `KernelBackwardAttention` with the forward
    and backward kernels. There is no fallback: a kernel that cannot take
    the inputs raises.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.device.type == "cpu":
            return attention_reference(q, k, v)
        return KernelBackwardAttention.apply(
            q, k, v, attention_forward_lse, attention_backward)
    return attention_fwd(q, k, v)
