"""The fp32 attention kernel's numerics and index maps, emulated on the CPU.

`csrc/attention.cu`'s fp32 kernel (`attention_fwd_tf32_kernel`) runs only on
a card. `tf32x3_attention` below follows its arithmetic in PyTorch: every
operand split into two TF32 parts (round to nearest, ties away, bit for bit
as the kernel rounds), each product as three TF32 products (lo·hi and hi·lo
first, then hi·hi) whose sums are added to an fp32 accumulator and rounded
toward zero once per `mma` (the products of TF32 values are exact in fp32;
the rounding toward zero is the model of the tensor cores that matched the
card: accumulating P·V straight into the running output, it predicted
1.1e-6 to 5.5e-6 where an H100 measured 1.1e-6 to 6.0e-6), each key step of
P·V in a zeroed fragment added to the output in fp32, key tiles of 32 keys
zero-filled past N and masked to -inf, the online softmax with log2(e)/√d
folded into exp2, P kept in fp32, one division by the row sum at the end.

Measured (this file's inputs): against `_xla_attention` and the Pallas
kernel in interpret mode, max|emulation − jax| / max|jax| ≤ 8.0e-7 (bound
1e-5, the plain version's own bound in test_torch_attention.py). Against
the fp32 plain version on chip_smoke.py's fp32 kernel cases (batch 1): 2.9e-7
to 8.1e-7, where max |out| is 0.33 to 1.34; the smoke's tolerance, 1e-5, is
12.4 times the largest. A single TF32 product (no split) errs by 2.4e-4 to
6.6e-4 on the same inputs, 24 to 66 times past 1e-5: the split is what makes
the tensor cores fp32-accurate here.

The second half simulates the m16n8k8 TF32 fragment layouts of the PTX ISA
with the kernel's index maps (Q and K with d permuted for float4 reads, P
taken from the scores' C fragments with the key permutation, V and the
output with d permuted for vector reads) and its shared-memory bank map at
d 16, 32 and 64.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from hybrid_diffusion_tpu.ops.attention import _pallas_attention, _xla_attention
from hybrid_diffusion_tpu_torch.ops.attention import attention_reference

# The kernel's constants: TF32_BLOCK_N, tf32_k_stride, tf32_v_stride, W.
BLOCK_N = 32


def k_stride(d):
    return d if (d // 4) % 8 == 4 else d + 16


def v_stride(d):
    return d + 4


def vec_width(d):
    return min(d // 8, 4)


# ---------------------------------------------------------------- numerics

def tf32(x):
    """fp32 -> fp32 rounded to TF32: (bits + 0x1000) & 0xffffe000."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma(c, a, b):
    """c + a·b, the TF32 products summed exactly and rounded once to fp32,
    toward zero, as the tensor cores round."""
    exact = c.double() + a.double() @ b.double()
    near = exact.float()
    over = near.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)),
                       near)


def qk_step_columns(d):
    """The d columns of each k8 step of Q·Kᵀ: step 2i takes 16i+4t and
    16i+4t+1 (k t and t+4), step 2i+1 16i+4t+2 and 16i+4t+3."""
    steps = []
    for i in range(d // 16):
        for first in (0, 2):
            steps.append([16 * i + 4 * t + first + e for e in (0, 1)
                          for t in range(4)])
    return steps


def tf32x3_attention(q, k, v, passes=3, step_fragments=True):
    """(B, N, h, d) fp32 -> (B, N, h, d) fp32, in the kernel's order of work.
    passes=1 is a single TF32 product (the hi parts only);
    step_fragments=False accumulates P·V straight into the output."""
    B, N, H, D = q.shape
    c = np.float32(1.4426950408889634) / np.float32(math.sqrt(D))
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    pad = (0, 0, 0, -N % BLOCK_N)  # the copy zero-fills keys past N
    kf, vf = F.pad(kf, pad), F.pad(vf, pad)
    qh, ql = split(qf.contiguous())
    m = torch.full((B, H, N, 1), -math.inf)
    l = torch.zeros(B, H, N, 1)
    acc = torch.zeros(B, H, N, D)
    steps = qk_step_columns(D)
    for k0 in range(0, N, BLOCK_N):
        kh, kl = split(kf[:, :, k0:k0 + BLOCK_N].contiguous())
        s = torch.zeros(B, H, N, BLOCK_N)
        if passes == 3:
            for cols in steps:
                s = mma(s, ql[..., cols], kh[..., cols].transpose(-1, -2))
                s = mma(s, qh[..., cols], kl[..., cols].transpose(-1, -2))
        for cols in steps:
            s = mma(s, qh[..., cols], kh[..., cols].transpose(-1, -2))
        s[..., N - k0:] = -math.inf
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        mc = m_new * c
        p = torch.exp2((s.double() * float(c) - mc.double()).float())  # FFMA
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr
        ph, pl = split(p)
        vh, vl = split(vf[:, :, k0:k0 + BLOCK_N].contiguous())
        for j in range(0, BLOCK_N, 8):  # each key step in a zeroed fragment
            keys = slice(j, j + 8)
            part = torch.zeros_like(acc) if step_fragments else acc
            if passes == 3:
                part = mma(part, pl[..., keys], vh[..., keys, :])
                part = mma(part, ph[..., keys], vl[..., keys, :])
            part = mma(part, ph[..., keys], vh[..., keys, :])
            acc = acc + part if step_fragments else part
        m = m_new
    return (acc * (1.0 / l)).permute(0, 2, 1, 3)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11),
                      1.0 + 2**-11 - 2**-23, 3.0e-30], dtype=torch.float32)
    want = [1.0, 1.0 + 2**-10, 1.0 + 2 * 2**-10, -(1.0 + 2**-10), 1.0]
    assert tf32(x)[:5].tolist() == want
    hi, lo = split(torch.randn(10_000, generator=torch.Generator().manual_seed(0)))
    bits = torch.cat([hi, lo]).view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()  # both parts exact TF32 values


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 100])
def test_emulation_matches_xla_and_pallas(N, d):
    rng = np.random.default_rng(300 * N + d)
    q, k, v = (rng.standard_normal((2, N, 2, d)).astype(np.float32)
               for _ in range(3))
    ours = tf32x3_attention(*map(torch.from_numpy, (q, k, v)))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for name, theirs in (
            ("xla", _xla_attention(jq, jk, jv)),
            ("pallas", _pallas_attention(jq, jk, jv, interpret=True))):
        theirs = torch.from_numpy(np.array(theirs))
        assert ours.shape == theirs.shape == (2, N, 2, d)
        assert rel_err(ours, theirs) <= 1e-5, name


def smoke_fp32_cases():
    """chip_smoke.py's fp32 kernel cases at batch 1, (case, q, k, v)."""
    rng = np.random.default_rng(0)
    for case in chip_smoke.KERNEL_CASES:
        _, N, h, d, dname, inputs = case
        if dname == "float32":
            assert inputs == "randn"
            packed = rng.standard_normal((1, N, 3, h, d)).astype(np.float32)
            yield (case, *torch.from_numpy(packed).unbind(2))


def test_smoke_fp32_tolerance_covers_the_kernel_error_with_margin():
    """The emulation errs against the fp32 plain version by at most a tenth
    of chip_smoke.py's fp32 tolerance in each of its fp32 cases; a single
    TF32 product errs past it."""
    seen = 0
    for case, q, k, v in smoke_fp32_cases():
        ref = attention_reference(q, k, v)
        err = (tf32x3_attention(q, k, v) - ref).abs().max().item()
        one = (tf32x3_attention(q, k, v, passes=1) - ref).abs().max().item()
        assert 10 * err <= chip_smoke.ATOL["float32", "randn"], (case, err)
        assert one > chip_smoke.ATOL["float32", "randn"], (case, one)
        seen += 1
    assert seen >= 5  # the path, the flagship, both ragged cases and d 16


def test_step_fragments_keep_the_rounding_bias_out_of_the_output():
    """Fed straight into the running output, 384 mma rounded toward zero
    bias it at N 1024 (emulated 3.9e-6 here, where an H100 measured
    6.0e-6); each key step summed in a zeroed fragment first errs 13.5
    times less (2.9e-7)."""
    case, q, k, v = next(c for c in smoke_fp32_cases()
                         if c[0] == chip_smoke.FP32_SERVE_CASE)
    ref = attention_reference(q, k, v)
    ours = (tf32x3_attention(q, k, v) - ref).abs().max().item()
    direct = (tf32x3_attention(q, k, v, step_fragments=False)
              - ref).abs().max().item()
    assert 10 * ours <= direct and direct > 2e-6, (ours, direct)


# ---------------------------------------------------------------- fragments
# PTX ISA, mma.m16n8k8 with .tf32 operands: where register `reg` of lane
# 4·g + t lies in its matrix.

def a_coords(reg, g, t):  # A, 16 x 8: (row, k)
    return g + 8 * (reg & 1), t + 4 * (reg >> 1)


def b_coords(reg, g, t):  # B, 8 x 8: (k, column)
    return t + 4 * reg, g


def c_coords(reg, g, t):  # C, 16 x 8: (row, column)
    return g + 8 * (reg >> 1), 2 * t + (reg & 1)


LANES = [(lane >> 2, lane & 3) for lane in range(32)]


def mma_sim(c, a, b):
    """One warp's mma on fragments: c (32, 4), a (32, 4), b (32, 2)."""
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane, (g, t) in enumerate(LANES):
        for reg in range(4):
            A[a_coords(reg, g, t)] = a[lane, reg]
            C[c_coords(reg, g, t)] = c[lane, reg]
        for reg in range(2):
            B[b_coords(reg, g, t)] = b[lane, reg]
    C = C + A @ B
    return np.array([[C[c_coords(reg, g, t)] for reg in range(4)]
                     for g, t in LANES])


def out_column(d, nt, col):
    """d of column `col` of output tile nt."""
    w = vec_width(d)
    return 8 * w * (nt // w) + w * col + nt % w


@pytest.mark.parametrize("d", [16, 32, 64])
def test_fragment_maps_compute_q_kt_and_p_v(d):
    """The kernel's Q and K fragments (one float4 of a row per lane and step
    pair) give Q·Kᵀ; P's A fragments taken from the scores' C fragments
    (c0, c2, c1, c3), with V read at keys 8j+2t, 8j+2t+1 and columns
    out_column, give P·V, written back by the epilogue's map."""
    rng = np.random.default_rng(d)
    Q = rng.integers(-4, 5, (16, d)).astype(np.float64)
    K = rng.integers(-4, 5, (BLOCK_N, d)).astype(np.float64)
    V = rng.integers(-4, 5, (BLOCK_N, d)).astype(np.float64)
    qf = np.zeros((d // 8, 32, 4))
    for lane, (g, t) in enumerate(LANES):
        for half in range(2):
            for i in range(d // 16):
                x = Q[g + 8 * half, 16 * i + 4 * t: 16 * i + 4 * t + 4]
                qf[2 * i, lane, half], qf[2 * i, lane, half + 2] = x[0], x[1]
                qf[2 * i + 1, lane, half], qf[2 * i + 1, lane, half + 2] = x[2], x[3]
    s = np.zeros((BLOCK_N // 8, 32, 4))
    for j in range(BLOCK_N // 8):
        kf = np.zeros((d // 8, 32, 2))
        for lane, (g, t) in enumerate(LANES):
            for i in range(d // 16):
                x = K[8 * j + g, 16 * i + 4 * t: 16 * i + 4 * t + 4]
                kf[2 * i, lane], kf[2 * i + 1, lane] = x[:2], x[2:]
        for kk in range(d // 8):
            s[j] = mma_sim(s[j], qf[kk], kf[kk])
    S = np.zeros((16, BLOCK_N))
    for j in range(BLOCK_N // 8):
        for lane, (g, t) in enumerate(LANES):
            for reg in range(4):
                row, col = c_coords(reg, g, t)
                S[row, 8 * j + col] = s[j, lane, reg]
    np.testing.assert_array_equal(S, Q @ K.T)

    P = rng.integers(-4, 5, (16, BLOCK_N)).astype(np.float64)
    for j in range(BLOCK_N // 8):  # P in the scores' C fragments
        for lane, (g, t) in enumerate(LANES):
            for reg in range(4):
                row, col = c_coords(reg, g, t)
                s[j, lane, reg] = P[row, 8 * j + col]
    acc = np.zeros((d // 8, 32, 4))
    for j in range(BLOCK_N // 8):
        pa = s[j][:, [0, 2, 1, 3]]
        for nt in range(d // 8):
            vf = np.array([[V[8 * j + 2 * t + r, out_column(d, nt, g)]
                            for r in range(2)] for g, t in LANES])
            acc[nt] = mma_sim(acc[nt], pa, vf)
    w = vec_width(d)
    out = np.full((16, d), np.nan)
    for lane, (g, t) in enumerate(LANES):
        for half in range(2):
            for grp in range(d // 8 // w):
                for c in range(2):
                    for i in range(w):
                        col = 8 * w * grp + w * (2 * t + c) + i
                        assert np.isnan(out[g + 8 * half, col])
                        out[g + 8 * half, col] = acc[grp * w + i, lane, 2 * half + c]
    np.testing.assert_array_equal(out, P @ V)


def bank_conflicts(offsets, width):
    """Extra shared-memory wavefronts of one warp's load of `width` floats
    a lane at float offsets `offsets` (32,): the warp is served in phases of
    32/width lanes, each of which should touch 32 distinct banks."""
    lanes = 32 // width
    extra = 0
    for first in range(0, 32, lanes):
        banks = [(o + e) % 32 for o in offsets[first:first + lanes]
                 for e in range(width)]
        extra += max(banks.count(b) for b in set(banks)) - 1
    return extra


@pytest.mark.parametrize("d", [16, 32, 64])
def test_shared_memory_reads_are_free_of_bank_conflicts(d):
    """The K reads (float4 at row 8j+g, d 16i+4t) and the V reads (W floats
    at rows 8j+2t and 8j+2t+1, d 8W·grp + W·g) at the kernel's padded row
    strides; the K reads at an unpadded stride collide where it pads."""
    sk, sv, w = k_stride(d), v_stride(d), vec_width(d)
    for j in range(BLOCK_N // 8):
        for i in range(d // 16):
            offs = [(8 * j + g) * sk + 16 * i + 4 * t for g, t in LANES]
            assert bank_conflicts(offs, 4) == 0, ("K", j, i)
        for r in range(2):
            for grp in range(d // 8 // w):
                offs = [(8 * j + 2 * t + r) * sv + 8 * w * grp + w * g
                        for g, t in LANES]
                assert bank_conflicts(offs, w) == 0, ("V", j, r, grp)
    assert sk % 4 == 0 and sv % 4 == 0  # 16-byte aligned cp.async rows
    if sk != d:
        offs = [g * d + 4 * t for g, t in LANES]
        assert bank_conflicts(offs, 4) > 0
