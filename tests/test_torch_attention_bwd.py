"""The attention's backward kernel, its plain twins and its autograd
Function, on the CPU.

`csrc/attention.cu`'s backward kernels run only on a card. `tiled_backward`
below follows the order of work of `attention_bwd_wgmma_kernel` in
PyTorch: blocks of BWD_BLOCK_N (128) keys, two consumers of WG_KEYS (64)
each, zero-filled past N and given P = 0 there; query steps of BWD_BLOCK_M
(64), whose lse (from the emulated forward, test_torch_attention_tiled.py's
`tiled_attention`) is +inf past N, so that P is 0 there; D = rowsum(dO∘O)
from the rounded output; Pᵀ = exp2(s·c − lse) in fp32; dP rounded to the
input type after its product; dS = P∘(dP − D)/√d rounded to the input type
for dK and dQ, P rounded for dV; dK and dV summed over query steps in fp32
and rounded once; dQ summed in fp32 as one partial a (consumer's 64 keys,
query step), added into the fp32 scratch (the kernel's TMA reduce-adds) and
rounded once. The mma.sync kernel (d 16, d 64, d 32 below N 257, and fp16
at every N) has blocks of 64 keys: the same partials.

Measured (this file's inputs), max over dq, dk, dv of max|Δ|/max|ref|
(ops/attention.py's grad_rel_err):
  - emulation against `jax.vjp(_xla_attention)` at d 16/32/64, N 16, 100
    and 256: ≤ 7.6e-3 in bf16 and ≤ 8.9e-4 in fp16, about one unit in the
    last place of the gradients (2^-7 and 2^-10 of their largest value):
    the two differ in D (rowsum(dO∘O) against rowsum(P∘dP)) and in dS,
    which the kernel rounds and JAX keeps in fp32. Bounds REL_TOL: 1.5e-2
    and 2e-3.
  - emulation against the fp32 plain autograd at chip_smoke.py's gradient
    shapes cut to B·h = 2: ≤ 6.3e-3 in bf16 (N 1024, d 16), 3.7e-4 in fp16
    (N 1000, d 32), and 2.8e-2 in fp16 on the mask trap, there against the
    largest of the three gradients (dQ alone errs by 1.65 of its own
    largest value, as the plain twin does: chip_smoke.py says why). The
    card's tolerance BWD_RTOL (ops/attention.py), 3e-2, 1.75e-3 and 0.125,
    is 4.7, 4.7 and 4.5 times that.
  - the twins against `jax.vjp(_xla_attention)`: ≤ 6.7e-7 in fp32 (bound
    1e-5) and ≤ 3.7e-3 in bf16 (bound 8e-3).
Without the key mask the smoke's fp16 mask-trap case gives non-finite
gradients (a padded key's P is about 2^33, past fp16's range).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from _torch_parity import fast_compile, one_torch_thread  # noqa: F401
from hybrid_diffusion_tpu.ops.attention import _xla_attention
from hybrid_diffusion_tpu_torch.ops import attention as port_attention
from hybrid_diffusion_tpu_torch.ops.attention import (
    BACKWARD_DTYPES,
    BWD_RTOL,
    KernelBackwardAttention,
    attention_backward,
    attention_backward_reference,
    attention_forward_lse,
    attention_forward_lse_reference,
    attention_reference,
    fused_spatial_attention,
    grad_rel_err,
    kernel_instance,
)
from test_torch_attention_tiled import tiled_attention

BWD_BLOCK_N = 128  # keys per block: the wgmma kernel's WGB_BLOCK_N
WG_KEYS = 64      # keys a consumer warpgroup: one dQ partial a query step
BWD_BLOCK_M = 64  # queries per step: the kernel's WGB_BLOCK_M
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}
REL_TOL = {torch.bfloat16: 1.5e-2, torch.float16: 2e-3}
TWIN_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def tiled_backward(q, k, v, out, lse, dout, mask=True):
    """(dq, dk, dv) of bf16/fp16 (B, N, h, d) inputs in the kernel's order of
    work (the module docstring). Without `mask`, padded keys keep their P."""
    B, N, H, D = q.shape
    dt = q.dtype
    scale = 1.0 / torch.tensor(float(D)).sqrt()
    c = torch.tensor(1.4426950408889634, dtype=torch.float32) * scale

    def rounded(x):
        return x.to(dt).float()

    qf, kf, vf, of, gf = (t.float().permute(0, 2, 1, 3)
                          for t in (q, k, v, out, dout))
    delta = (gf * of).sum(-1)                        # (B, h, N)
    pad_n, pad_m = -N % WG_KEYS, -N % BWD_BLOCK_M
    kf, vf = (F.pad(t, (0, 0, 0, pad_n)) for t in (kf, vf))
    qf, gf = (F.pad(t, (0, 0, 0, pad_m)) for t in (qf, gf))
    lse = F.pad(lse, (0, pad_m), value=math.inf)
    delta = F.pad(delta, (0, pad_m))
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for n0 in range(0, N, BWD_BLOCK_N):
        for k0 in range(n0, min(n0 + BWD_BLOCK_N, N), WG_KEYS):  # a consumer
            keys = slice(k0, k0 + WG_KEYS)
            kt, vt = kf[:, :, keys], vf[:, :, keys]
            padded = torch.arange(k0, k0 + WG_KEYS) >= N
            for m0 in range(0, N, BWD_BLOCK_M):
                rows = slice(m0, m0 + BWD_BLOCK_M)
                qt, gt = qf[:, :, rows], gf[:, :, rows]
                p = torch.exp2(kt @ qt.transpose(-1, -2) * c
                               - lse[:, :, None, rows])  # Pᵀ: (keys, queries)
                if mask:
                    p[:, :, padded] = 0.0
                dp = rounded(vt @ gt.transpose(-1, -2))
                ds = rounded(p * (dp - delta[:, :, None, rows]) * scale)
                dv[:, :, keys] += rounded(p) @ gt
                dk[:, :, keys] += ds @ qt
                dq[:, :, rows] += ds.transpose(-1, -2) @ kt  # one partial
    return tuple(x[:, :, :N].to(dt).permute(0, 2, 1, 3).contiguous()
                 for x in (dq, dk, dv))


def emulated(q, k, v, dout, mask=True):
    """The kernels' forward (with lse) and backward, emulated."""
    out, lse = tiled_attention(q, k, v, return_lse=True)
    return tiled_backward(q, k, v, out, lse, dout, mask=mask)


@jax.jit
def _xla_vjp(q, k, v, dout):
    return jax.vjp(_xla_attention, q, k, v)[1](dout)


def jax_grads(q, k, v, dout):
    """jax.vjp(_xla_attention) at the same (exactly representable) inputs,
    compiled at XLA:CPU's optimization level 0 (the same numbers, sooner)."""
    jdt = JAX_DTYPE[q.dtype]
    args = [jnp.asarray(t.float().numpy()).astype(jdt)
            for t in (q, k, v, dout)]
    return tuple(torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                 for x in fast_compile(_xla_vjp, *args))


@jax.jit
def _xla_vjp_16bit(q, k, v, dout):
    """The vjp in bf16 and in fp16 of fp32 inputs rounded to each."""
    return tuple(jax.vjp(_xla_attention, *(x.astype(t) for x in (q, k, v)))[1](
        dout.astype(t)) for t in (jnp.bfloat16, jnp.float16))


@functools.lru_cache(maxsize=None)
def jax_grads_16bit(N, d):
    """{dtype: jax grads} at test_emulated_backward_matches_jax_vjp's
    inputs for (N, d), bf16 and fp16 from one compile."""
    args = [jnp.asarray(t.numpy())
            for t in inputs(100 * N + d, 2, N, 2, d, torch.float32)]
    return {dtype: tuple(torch.from_numpy(np.array(x.astype(jnp.float32)))
                         for x in grads)
            for dtype, grads in zip((torch.bfloat16, torch.float16),
                                    fast_compile(_xla_vjp_16bit, *args))}


def fp32_grads(q, k, v, dout):
    """The fp32 plain version's autograd at the inputs as they are."""
    qkv = torch.stack([q, k, v], 2).float().requires_grad_()
    out = attention_reference(*qkv.unbind(2))
    return torch.autograd.grad(out, qkv, dout.float())[0].unbind(2)


def inputs(seed, B, N, h, d, dtype, kind="randn"):
    rng = np.random.default_rng(seed)
    if kind == "randn":
        packed = rng.standard_normal((B, N, 3, h, d)).astype(np.float32)
    else:
        packed = chip_smoke.mask_trap_qkv(rng, B, N, h, d)
    q, k, v = torch.from_numpy(packed).to(dtype).unbind(2)
    dout = torch.from_numpy(rng.standard_normal((B, N, h, d))
                            .astype(np.float32)).to(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 100, 256])
def test_emulated_backward_matches_jax_vjp(N, d, dtype):
    q, k, v, dout = inputs(100 * N + d, 2, N, 2, d, dtype)
    ours = emulated(q, k, v, dout)
    theirs = jax_grads_16bit(N, d)[dtype]
    for name, a, b in zip("qkv", ours, theirs):
        assert a.shape == b.shape == (2, N, 2, d) and a.dtype == dtype
        assert grad_rel_err([a], [b]) <= REL_TOL[dtype], name


# chip_smoke.py's backward-kernel gradient cases by (N, d, dtype, inputs),
# cut to B·h = 2 (one batch, two heads).
SMOKE_CASES = sorted({(N, d, dname, kind) for _, N, _, d, dname, kind
                      in chip_smoke.KERNEL_GRAD_CASES})


@pytest.fixture(scope="module")
def smoke_errors():
    """The emulation's error against the fp32 plain autograd at each of
    SMOKE_CASES, as the smoke measures the kernel's (grad_rel_err, on the
    mask trap against the largest gradient)."""
    errors = {}
    for N, d, dname, kind in SMOKE_CASES:
        q, k, v, dout = inputs(N + d, 1, N, 2, d, getattr(torch, dname), kind)
        errors[N, d, dname, kind] = grad_rel_err(
            emulated(q, k, v, dout), fp32_grads(q, k, v, dout),
            common_scale=kind == "mask trap")
    return errors


@pytest.mark.parametrize("case", SMOKE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_smoke_tolerance_covers_the_emulated_backward(case, smoke_errors):
    err = smoke_errors[case]
    assert 4 * err <= BWD_RTOL[case[2:]], err


@pytest.mark.parametrize("kind", sorted(k for k in BWD_RTOL
                                         if k[0] != "float32"),
                         ids=lambda k: "-".join(k).replace(" ", "_"))
def test_smoke_tolerance_is_at_most_five_times_the_worst_error(kind,
                                                               smoke_errors):
    worst = max(e for case, e in smoke_errors.items() if case[2:] == kind)
    assert BWD_RTOL[kind] <= 5 * worst, worst


def test_smoke_mask_trap_catches_a_missing_key_mask():
    case = next(c for c in chip_smoke.KERNEL_GRAD_CASES if c[5] == "mask trap")
    _, N, _, d, dname, kind = case
    assert N % BWD_BLOCK_N and N % BWD_BLOCK_M  # ragged on both sides
    q, k, v, dout = inputs(3, 1, N, 2, d, getattr(torch, dname), kind)
    masked = emulated(q, k, v, dout)
    unmasked = emulated(q, k, v, dout, mask=False)
    assert all(torch.isfinite(x).all() for x in masked)
    assert not all(torch.isfinite(x).all() for x in unmasked)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 2, 32), (1, 100, 2, 16)],
                         ids=["path_shape", "ragged"])
def test_twins_match_jax_vjp(shape, dtype):
    q, k, v, dout = inputs(sum(shape), *shape, dtype)
    out, lse = attention_forward_lse_reference(q, k, v)
    torch.testing.assert_close(out, attention_reference(q, k, v), rtol=0,
                               atol=0)
    assert lse.shape == (shape[0], shape[2], shape[1]) and lse.is_contiguous()
    # lse is log2 of the row sums of exp2(s·c): P's rows sum to one.
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.exp2(s * (math.log2(math.e) / math.sqrt(shape[3]))
                   - lse[..., None])
    torch.testing.assert_close(p.sum(-1), torch.ones_like(lse), rtol=0,
                               atol=1e-5)
    grads = attention_backward_reference(q, k, v, out, lse, dout)
    assert all(g.dtype == dtype and g.is_contiguous() for g in grads)
    err = grad_rel_err(grads, jax_grads(q, k, v, dout))
    assert err <= TWIN_REL_TOL[dtype]


def packed_views(seed, B, N, h, d, dtype):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3, h, d))
                           .astype(np.float32)).to(dtype).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((B, N, h, d))
                         .astype(np.float32)).to(dtype)
    return qkv, g


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)],
                         ids=["fp32", "bf16"])
def test_function_with_twins_gives_plain_autograd_grads(dtype, tol):
    """KernelBackwardAttention with its twins injected, on strided views of
    a packed (B, N, 3, h, d) projection: the gradient on the packed tensor
    is the plain version's autograd's."""
    qkv, g = packed_views(5, 2, 100, 2, 16, dtype)
    calls = []

    def forward(q, k, v):
        calls.append("forward")
        return attention_forward_lse_reference(q, k, v)

    def backward(*args):
        calls.append("backward")
        return attention_backward_reference(*args)

    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = KernelBackwardAttention.apply(q, k, v, forward, backward)
    assert out.grad_fn.name() == "KernelBackwardAttentionBackward"
    (ours,) = torch.autograd.grad(out, qkv, g)
    assert calls == ["forward", "backward"]
    (plain,) = torch.autograd.grad(attention_reference(*qkv.unbind(2)), qkv,
                                   g)
    assert ours.shape == qkv.shape and ours.dtype == dtype
    assert grad_rel_err(ours.unbind(2), plain.unbind(2)) <= tol


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that says it is on the card: enough for
    fused_spatial_attention to take its CUDA branch."""

    @property
    def device(self):
        return torch.device("cuda")


def test_routing_by_dtype(monkeypatch):
    """Under grad, bf16, fp16 and fp32 CUDA tensors go to
    KernelBackwardAttention with the kernels' launchers (the recomputed
    fp32 backward is gone), CPU tensors to the plain version's autograd.
    The launchers refuse CPU tensors and count nothing."""
    assert BACKWARD_DTYPES == (torch.bfloat16, torch.float16, torch.float32)
    assert not hasattr(port_attention, "RecomputedBackwardAttention")
    routed = []
    name = "KernelBackwardAttention"
    monkeypatch.setattr(port_attention, name, type(name, (), {
        "apply": staticmethod(lambda *a: routed.append((name, a[3:])))}))
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        qkv, _ = packed_views(6, 1, 16, 2, 16, dtype)
        fused_spatial_attention(*(t.as_subclass(_ReportsCuda)
                                  for t in qkv.unbind(2)))
    assert routed == [(name, (attention_forward_lse, attention_backward))] * 3
    monkeypatch.undo()
    qkv, g = packed_views(6, 1, 16, 2, 16, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = fused_spatial_attention(q, k, v)
    assert "Attention" not in out.grad_fn.name()
    torch.testing.assert_close(out, attention_reference(q, k, v), rtol=0,
                               atol=0)
    before = port_attention.launch_count
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention_forward_lse(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention_backward(q, k, v, out, q.new_zeros(1, 2, 16), g)
    assert port_attention.launch_count == before
    assert port_attention.launch_counts.keys() == {
        "attention_fwd", "attention_fwd_fp32", "attention_bwd",
        "attention_bwd_fp32"}


# Symbols as ptxas reported them for csrc/attention.cu on the H100.
NS = "_ZN45_GLOBAL__N__a758641a_12_attention_cu_1a880bbc"


@pytest.mark.parametrize("symbol,expected", [
    (NS + "24attention_fwd_mma_kernelI13__nv_bfloat16Li32ELb0EEEvPKT_S4_S4_PS2_"
     "PfiiNS_7StridesES7_S7_f",
     ("attention_fwd_mma_kernel", torch.bfloat16, 32)),
    (NS + "24attention_fwd_mma_kernelI6__halfLi64ELb1EEEvPKT_S4_S4_PS2_PfiiNS_"
     "7StridesES7_S7_f",
     ("attention_fwd_mma_kernel/lse", torch.float16, 64)),
    (NS + "24attention_bwd_mma_kernelI13__nv_bfloat16Li16EEEvPKT_S4_S4_S4_PKfS6_"
     "PfPS2_S8_iiNS_7StridesES9_S9_S9_ff",
     ("attention_bwd_mma_kernel", torch.bfloat16, 16)),
    (NS + "25attention_fwd_tf32_kernelILi32ELi2ELb0EEEvPKfS2_S2_PfS3_iiNS_"
     "7StridesES4_S4_f",
     ("attention_fwd_tf32_kernel/m2", torch.float32, 32)),
    (NS + "25attention_fwd_tf32_kernelILi64ELi1ELb1EEEvPKfS2_S2_PfS3_iiNS_"
     "7StridesES4_S4_f",
     ("attention_fwd_tf32_kernel/m1/lse", torch.float32, 64)),
    (NS + "25attention_bwd_tf32_kernelILi16EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiNS_"
     "7StridesES4_S4_S4_ff",
     ("attention_bwd_tf32_kernel", torch.float32, 16)),
    (NS + "25attention_bwd_prep_kernelIfLi64EEEvPKT_S3_PfS4_iilNS_7StridesES5_",
     None),
    (NS + "26attention_fwd_wgmma_kernelI13__nv_bfloat16Li32ELb1EEEv14CUtensorMap_"
     "stS2_S2_S2_Pfiiif",
     ("attention_fwd_wgmma_kernel/lse", torch.bfloat16, 32)),
    (NS + "26attention_fwd_wgmma_kernelI6__halfLi16ELb0EEEv14CUtensorMap_stS2_S2_"
     "S2_Pfiiif",
     ("attention_fwd_wgmma_kernel", torch.float16, 16)),
    (NS + "26attention_bwd_wgmma_kernelI6__halfLi64EEEv14CUtensorMap_stS2_S2_S2_"
     "S2_S2_S2_S2_S2_iiff",
     ("attention_bwd_wgmma_kernel", torch.float16, 64)),
    (NS + "25attention_bwd_prep_kernelI6__halfLi32EEEvPKT_S4_PfS5_iilNS_"
     "7StridesES6_", None),
    (NS + "23attention_bwd_dq_kernelI13__nv_bfloat16EEvPKfPT_l", None),
])
def test_kernel_instance_parses_the_mangled_names(symbol, expected):
    assert kernel_instance(symbol) == expected


# (kind, (B, N, h, d), ms, what binds): the bound the card checks report,
# the larger of the products and the bytes.
@pytest.mark.parametrize("kind,shape,ms,by", [
    ("forward", (8, 1024, 8, 32), 0.0086855, "operations"),     # serve
    ("forward", (160, 256, 8, 32), 0.025041, "bytes"),          # CFG sampler
    ("backward", (80, 1024, 8, 16), 0.10857, "operations"),     # CFG train
    ("backward", (8, 1024, 4, 32), 0.010857, "operations"),     # TP
], ids=["serve", "cfg_n256", "cfg_bwd_n1024", "tp_bwd"])
def test_bound_is_the_largest_of_products_bytes_and_exponentials(kind, shape,
                                                                 ms, by):
    B, N, h, d = shape
    if kind == "forward":
        work = (4.0 * B * h * N * N * d, 4.0 * B * N * h * d * 2)
    else:
        work = (10.0 * B * h * N * N * d, 8.0 * B * N * h * d * 2 + 4.0 * B * h * N)
    got_ms, got_by = port_attention.bound_ms(*work, "bfloat16")
    assert got_by == by
    assert got_ms == pytest.approx(ms, rel=1e-4)
