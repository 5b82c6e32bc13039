"""The fp32 attention backward kernel's numerics and index maps, emulated on
the CPU.

`csrc/attention.cu`'s fp32 backward (`attention_bwd_tf32_kernel`, with the
fp32 forward's lse instance before it) runs only on a card.
`tf32x3_backward` below follows its arithmetic in PyTorch: D = rowsum(dO∘O)
in fp32 (the pre-pass); keys in blocks of 64 and queries in tiles of 64,
both zero-filled past N, padded keys given P = 0 and padded queries lse
+inf; every operand split into two TF32 parts as the forward splits them
(test_torch_attention_tf32.py's `split`) and every product as three TF32
products (lo·hi, hi·lo, then hi·hi), each mma's sum rounded toward zero;
Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ summed over the k8 steps of d into one
accumulator; P = exp2(s·c − lse) and dS = P∘(dP − D)/√d in fp32, neither
rounded; dV, dK (over the k8 steps of queries) and dQ (over the k8 steps
of a block's keys) each step's three products in a zeroed fragment added
in fp32; dQ's partial of each key block added to dq in block order (the
kernel's float2 atomics, in an order that varies from run to run).

Measured (this file's inputs), max over dq, dk, dv of max|Δ|/max|ref|
(ops/attention.py's grad_rel_err):
  - emulation against `jax.vjp(_xla_attention)` in fp32 at d 16, 32, 64
    and N 16, 64, 100: 5.2e-7 to 2.4e-6, the largest at d 64 (bound 1e-5);
    the emulated forward against `_xla_attention` and the Pallas kernel in
    interpret mode at the same inputs: ≤ 9.8e-7;
  - emulation against the fp32 plain version's autograd at chip_smoke.py's
    fp32 gradient shapes cut to B·h = 2: 1.4e-6 (N 64) to 4.05e-6 (N 1000,
    d 64), which sets the card's tolerance BWD_RTOL["float32", "randn"]
    (ops/attention.py) at 4.9 times it; a single TF32 product (no split)
    errs by 6.9e-4 to 1.7e-3, past it. dQ's atomics change only the order of at most N/64 fp32 additions,
    about 2^-24 relative each.

The second part simulates the kernel's m16n8k8 TF32 fragment maps (the
products over d, over queries with Pᵀ and dSᵀ taken from C fragments, and
dQ's over keys from the dSᵀ tile) and its shared-memory bank maps at d 16,
32 and 64. The last compiles the C dispatch's routes
(csrc/attention_route.h) with the host's C++ compiler and asks them, through
`kernel_route`, which kernel each fp32 call runs.
"""

import ctypes
import math
import shutil
import subprocess

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
    ROUTE_HEADER,
    attention_reference,
    grad_rel_err,
    kernel_route,
)
from hybrid_diffusion_tpu_torch.utils.cuda_build import CSRC_DIR
from test_torch_attention_tf32 import (
    LANES,
    a_coords,
    b_coords,
    bank_conflicts,
    c_coords,
    mma,
    mma_sim,
    out_column,
    split,
    tf32x3_attention,
    vec_width,
)

BLOCK_N = 64   # keys a block: TB_BLOCK_N
BLOCK_M = 64   # queries a step: TB_BLOCK_M
DS_STRIDE = BLOCK_M + 8


def mma3(c, a, b, passes=3):
    """c + a·b as 3xTF32 in the kernel's order (a_lo·b_hi, a_hi·b_lo,
    a_hi·b_hi), each mma rounded toward zero; passes=1 only hi·hi."""
    (ah, al), (bh, bl) = split(a.contiguous()), split(b.contiguous())
    if passes == 3:
        c = mma(mma(c, al, bh), ah, bl)
    return mma(c, ah, bh)


def steps_of_8(x_left, x_right, c, passes, fragments):
    """x_left @ x_right over the last/first axis in k8 steps: into one
    accumulator `c`, or (fragments) each step in a zeroed fragment added to
    `c` in fp32."""
    for k0 in range(0, x_left.shape[-1], 8):
        a, b = x_left[..., k0:k0 + 8], x_right[..., k0:k0 + 8, :]
        if fragments:
            c = c + mma3(torch.zeros_like(c), a, b, passes)
        else:
            c = mma3(c, a, b, passes)
    return c


def tf32x3_backward(q, k, v, out, lse, dout, passes=3):
    """(dq, dk, dv) of fp32 (B, N, h, d) inputs in the kernel's order of work
    (the module docstring); `lse` (B, h, N) from the forward."""
    B, N, H, D = q.shape
    scale = np.float32(1.0) / np.float32(math.sqrt(D))
    c = np.float32(1.4426950408889634) * scale
    qf, kf, vf, of, gf = (t.float().permute(0, 2, 1, 3)
                          for t in (q, k, v, out, dout))
    delta = (gf * of).sum(-1)                                  # (B, h, N)
    pad_n, pad_m = -N % BLOCK_N, -N % BLOCK_M
    kf, vf = (F.pad(t, (0, 0, 0, pad_n)) for t in (kf, vf))
    qf, gf = (F.pad(t, (0, 0, 0, pad_m)) for t in (qf, gf))
    lse = F.pad(lse, (0, pad_m), value=math.inf)
    delta = F.pad(delta, (0, pad_m))
    zeros = qf.new_zeros(B, H, kf.shape[2], qf.shape[2])
    st = steps_of_8(kf, qf.transpose(-1, -2), zeros, passes, False)  # Sᵀ
    dpt = steps_of_8(vf, gf.transpose(-1, -2), zeros, passes, False)  # dPᵀ
    p = torch.exp2((st.double() * float(c) - lse[:, :, None].double()).float())
    p[:, :, N:] = 0.0                                          # padded keys
    dst = p * (dpt - delta[:, :, None]) * scale                # dSᵀ
    dv = steps_of_8(p, gf, torch.zeros_like(kf), passes, True)
    dk = steps_of_8(dst, qf, torch.zeros_like(kf), passes, True)
    dq = torch.zeros_like(qf)
    ds = dst.transpose(-1, -2)
    for n0 in range(0, kf.shape[2], BLOCK_N):                  # block order
        keys = slice(n0, n0 + BLOCK_N)
        dq = dq + steps_of_8(ds[..., keys], kf[:, :, keys],
                             torch.zeros_like(qf), passes, True)
    return tuple(x[:, :, :N].permute(0, 2, 1, 3).contiguous()
                 for x in (dq, dk, dv))


def emulated(q, k, v, dout, passes=3):
    """The kernels' fp32 forward (with lse) and backward, emulated."""
    out, lse = tf32x3_attention(q, k, v, return_lse=True)
    return tf32x3_backward(q, k, v, out, lse, dout, passes)


def inputs(seed, B, N, h, d):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((B, N, h, d))
                                   .astype(np.float32)) for _ in range(4))
    return q, k, v, g


@jax.jit
def _xla_vjp(q, k, v, dout):
    return jax.vjp(_xla_attention, q, k, v)[1](dout)


def fp32_grads(q, k, v, dout):
    """The fp32 plain version's autograd."""
    qkv = torch.stack([q, k, v], 2).requires_grad_()
    out = attention_reference(*qkv.unbind(2))
    return torch.autograd.grad(out, qkv, dout)[0].unbind(2)


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 64, 100])
def test_emulated_backward_matches_jax_vjp(N, d):
    q, k, v, g = inputs(7 * N + d, 1, N, 2, d)
    ours = emulated(q, k, v, g)
    theirs = [torch.from_numpy(np.array(x)) for x in fast_compile(
        _xla_vjp, *(jnp.asarray(t.numpy()) for t in (q, k, v, g)))]
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (1, N, 2, d) and a.dtype == torch.float32
    assert grad_rel_err(ours, theirs) <= 1e-5


def test_emulated_lse_is_the_log_sum_exp_of_the_scores():
    q, k, v, _ = inputs(3, 1, 100, 2, 32)
    out, lse = tf32x3_attention(q, k, v, return_lse=True)
    want_out, want_lse = port_attention.attention_forward_lse_reference(
        q, k, v)
    assert lse.shape == want_lse.shape == (1, 2, 100)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, want_out, rtol=0, atol=2e-6)


# chip_smoke.py's fp32 backward-kernel gradient cases by (N, d), cut to
# B·h = 2 (one batch, two heads).
SMOKE_CASES = sorted({(N, d) for _, N, _, d, _, _ in
                      chip_smoke.FP32_GRAD_CASES})


@pytest.fixture(scope="module")
def smoke_errors():
    """(emulation, single TF32 product) error against the fp32 plain
    autograd at each of SMOKE_CASES."""
    errors = {}
    for N, d in SMOKE_CASES:
        q, k, v, g = inputs(N + d, 1, N, 2, d)
        ref = fp32_grads(q, k, v, g)
        errors[N, d] = (grad_rel_err(emulated(q, k, v, g), ref),
                        grad_rel_err(emulated(q, k, v, g, passes=1), ref))
    return errors


def test_smoke_fp32_cases_cover_the_paths():
    """The tparity shape, the flagship train shape, the CFG step's d 16 at N
    1024, a ragged N and d 64."""
    assert {(64, 32), (1024, 32), (1024, 16)} <= set(SMOKE_CASES)
    assert any(N % BLOCK_N for N, _ in SMOKE_CASES)
    assert any(d == 64 for _, d in SMOKE_CASES)


@pytest.mark.parametrize("case", SMOKE_CASES,
                         ids=lambda c: f"N{c[0]}-d{c[1]}")
def test_smoke_tolerance_covers_the_emulated_backward(case, smoke_errors):
    err, single = smoke_errors[case]
    tol = BWD_RTOL["float32", "randn"]
    assert 4 * err <= tol < single, (err, single)


def test_smoke_tolerance_is_at_most_six_times_the_worst_error(smoke_errors):
    worst = max(err for err, _ in smoke_errors.values())
    assert BWD_RTOL["float32", "randn"] <= 6 * worst, worst


def test_smoke_holds_fp32_grads_to_the_kernel_tolerance():
    """Every fp32 gradient case of the smoke is held at BWD_RTOL (the
    recomputed backward's GRAD_RTOL is gone with it)."""
    assert not hasattr(chip_smoke, "GRAD_RTOL")
    assert ("float32", "randn") in BWD_RTOL


# ---------------------------------------------------------------- fragments

def tb_off(d, row, col):
    """The kernel's tb_off: row stride d + 8, 16-byte chunks of rows 4..7 of
    every 8 swapped in pairs."""
    return row * (d + 8) + (((col >> 2) ^ (((row >> 2) & 1) << 1)) << 2) \
        + (col & 3)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_fragment_maps_compute_the_five_products(d):
    """Sᵀ = K·Qᵀ (float2 reads of rows at d 8kk+2t), dV = Pᵀ·dO with Pᵀ's A
    fragment (c0, c2, c1, c3) of Sᵀ's C fragment and dO read at rows
    8j+2t+r, columns out_column; dQ = dS·K with dS read from the dSᵀ tile at
    (key 8kk+t (+4), query g (+8)) and K at rows 8kk+t+4r; the epilogue's
    map of C fragments to d."""
    rng = np.random.default_rng(d)
    K = rng.integers(-4, 5, (16, d)).astype(np.float64)      # a warp's keys
    Q = rng.integers(-4, 5, (32, d)).astype(np.float64)      # a sub-step
    G = rng.integers(-4, 5, (32, d)).astype(np.float64)      # dO rows
    kf = np.zeros((d // 8, 32, 4))
    for lane, (g, t) in enumerate(LANES):
        for kk in range(d // 8):
            for reg in range(4):
                row, kidx = a_coords(reg, g, t)
                kf[kk, lane, reg] = K[row, 8 * kk + 2 * t + (kidx >= 4)]
    st = np.zeros((4, 32, 4))
    for j in range(4):
        for kk in range(d // 8):
            qb = np.array([[Q[8 * j + g, 8 * kk + 2 * t + r] for r in range(2)]
                           for g, t in LANES])
            st[j] = mma_sim(st[j], kf[kk], qb)
    S = np.zeros((16, 32))
    for j in range(4):
        for lane, (g, t) in enumerate(LANES):
            for reg in range(4):
                row, col = c_coords(reg, g, t)
                S[row, 8 * j + col] = st[j, lane, reg]
    np.testing.assert_array_equal(S, K @ Q.T)

    acc = np.zeros((d // 8, 32, 4))                           # dV = Pᵀ·dO
    for j in range(4):
        pa = st[j][:, [0, 2, 1, 3]]
        for nt in range(d // 8):
            gb = np.array([[G[8 * j + 2 * t + r, out_column(d, nt, g)]
                            for r in range(2)] for g, t in LANES])
            acc[nt] = mma_sim(acc[nt], pa, gb)
    w = vec_width(d)
    dv = np.full((16, d), np.nan)
    for lane, (g, t) in enumerate(LANES):
        for half in range(2):
            for grp in range(d // 8 // w):
                for c in range(2):
                    for i in range(w):
                        col = 8 * w * grp + w * (2 * t + c) + i
                        dv[g + 8 * half, col] = acc[grp * w + i, lane,
                                                    2 * half + c]
    np.testing.assert_array_equal(dv, S @ G)

    DST = rng.integers(-4, 5, (64, 16)).astype(np.float64)    # dSᵀ: keys × queries
    KB = rng.integers(-4, 5, (64, d)).astype(np.float64)      # the block's K
    dq = np.zeros((d // 8, 32, 4))
    for kk in range(8):
        a = np.array([[DST[8 * kk + t + 4 * (reg >> 1), g + 8 * (reg & 1)]
                       for reg in range(4)] for g, t in LANES])
        for reg in range(4):   # the A map: (row g (+8), k t (+4))
            for lane, (g, t) in enumerate(LANES):
                row, kidx = a_coords(reg, g, t)
                assert a[lane, reg] == DST[8 * kk + kidx, row]
        for nt in range(d // 8):
            kb = np.array([[KB[8 * kk + t + 4 * r, out_column(d, nt, g)]
                            for r in range(2)] for g, t in LANES])
            for lane, (g, t) in enumerate(LANES):
                for r in range(2):
                    kidx, col = b_coords(r, g, t)
                    assert kb[lane, r] == KB[8 * kk + kidx,
                                             out_column(d, nt, col)]
            dq[nt] = mma_sim(dq[nt], a, kb)
    DQ = np.full((16, d), np.nan)
    for lane, (g, t) in enumerate(LANES):
        for half in range(2):
            for grp in range(d // 8 // w):
                for c in range(2):
                    for i in range(w):
                        DQ[g + 8 * half, 8 * w * grp + w * (2 * t + c) + i] = \
                            dq[grp * w + i, lane, 2 * half + c]
    np.testing.assert_array_equal(DQ, DST.T @ KB)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_shared_memory_maps_are_free_of_bank_conflicts(d):
    """Every read of the K, V, Q and dO tiles through tb_off (float2 at rows
    g, d 8kk+2t; W floats at rows 2t+r and at rows t+4r, d 8W·grp + W·g),
    the dSᵀ tile's float2 writes and single reads; and tb_off is a
    bijection onto each row's d floats. The same reads of an unswizzled
    tile collide."""
    w = vec_width(d)
    for base in range(0, 64, 8):
        for kk in range(d // 8):
            offs = [tb_off(d, base + g, 8 * kk + 2 * t) for g, t in LANES]
            assert bank_conflicts(offs, 2) == 0, ("rows g", base, kk)
        for r in range(2):
            for grp in range(d // 8 // w):
                for rows in ("2t+r", "t+4r"):
                    offs = [tb_off(d, base + (2 * t + r if rows == "2t+r"
                                              else t + 4 * r),
                                   8 * w * grp + w * g) for g, t in LANES]
                    assert bank_conflicts(offs, w) == 0, (rows, base, r, grp)
    for row in range(64):
        cols = sorted(tb_off(d, row, c) - row * (d + 8) for c in range(d))
        assert cols == list(range(d))
    unswizzled = [(2 * t) * (d + 8) + w * g for g, t in LANES]
    assert bank_conflicts(unswizzled, w) > 0
    for j in range(4):                                   # dSᵀ
        writes = [(16 + g) * DS_STRIDE + 8 * j + 2 * t for g, t in LANES]
        assert bank_conflicts(writes, 2) == 0
    for kk in range(8):
        reads = [(8 * kk + t) * DS_STRIDE + 16 + g for g, t in LANES]
        assert bank_conflicts(reads, 1) == 0


# ---------------------------------------------------------------- routing

@pytest.fixture(scope="module")
def route_library(tmp_path_factory):
    """csrc/attention_route.h, the C dispatch's routes, compiled by the host's
    C++ compiler into a library of its own."""
    folder = tmp_path_factory.mktemp("route")
    src = folder / "route.cpp"
    src.write_text(f'#include "{CSRC_DIR / ROUTE_HEADER}"\n')
    lib = folder / "libroute.so"
    compiler = shutil.which("g++") or shutil.which("c++")
    subprocess.run([compiler, "-std=c++17", "-shared", "-fPIC", "-o", str(lib),
                    str(src)], check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("backward,n,d,kernel", [
    (False, 64, 32, "attention_fwd_tf32_kernel"),      # path, tparity
    (False, 1024, 32, "attention_fwd_tf32_kernel"),    # fp32 serve, train
    (False, 1024, 16, "attention_fwd_tf32_kernel"),    # CFG in fp32
    (False, 1000, 64, "attention_fwd_tf32_kernel"),    # ragged, d 64
    (False, 64, 64, "attention_fwd_tf32_kernel"),
    (True, 64, 32, "attention_bwd_tf32_kernel"),
    (True, 1024, 16, "attention_bwd_tf32_kernel"),
    (True, 1000, 64, "attention_bwd_tf32_kernel"),
])
def test_fp32_routes_name_the_new_instances(route_library, backward, n, d,
                                            kernel):
    """kernel_route(torch.float32, N, d) through the compiled routes names
    the kernel that runs, and that kernel has instances of its d in the
    library (kernel_instance's names start with it)."""
    assert kernel_route(torch.float32, n, d, backward,
                        lib=route_library) == kernel
    assert torch.float32 in BACKWARD_DTYPES
    assert port_attention.BACKWARD_KERNEL_BY_DTYPE[torch.float32] == \
        "attention_bwd_fp32"


@pytest.mark.parametrize("backward,n,d,dtype,kernel", [
    (False, 1024, 32, torch.bfloat16, "attention_fwd_wgmma_kernel"),
    (False, 256, 32, torch.bfloat16, "attention_fwd_mma_kernel"),
    (False, 1024, 16, torch.bfloat16, "attention_fwd_mma_kernel"),
    (True, 1024, 32, torch.bfloat16, "attention_bwd_wgmma_kernel"),
    (True, 1024, 32, torch.float16, "attention_bwd_mma_kernel"),
])
def test_16_bit_routes_are_unchanged(route_library, backward, n, d, dtype,
                                     kernel):
    assert kernel_route(dtype, n, d, backward, lib=route_library) == kernel


@pytest.mark.parametrize("mode", ["fp32", "forward", "backward"])
def test_attention_variants_edits_apply_once(mode):
    """Every named edit of attention_variants.py (the design A/B runs on the
    card) matches the source, with the routes' header inlined, exactly
    once: the tool stops at one that does not."""
    from hybrid_diffusion_tpu_torch import attention_variants as av

    variants, table = av.MODES[mode]
    for name, edits in variants.items():
        src = av.variant_source(edits, table)
        assert f'#include "{ROUTE_HEADER}"' not in src, name
