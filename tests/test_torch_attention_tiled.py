"""The numerics of the tensor-core attention kernel, emulated on the CPU.

`csrc/attention.cu` runs only on a card. `tiled_attention` below follows its
bf16/fp16 kernel's order of work in PyTorch: key tiles of the kernel's
width (MMA_BLOCK_N, 64), zero-filled past N and masked to -inf; scores
in fp32; the online softmax with log2(e)/sqrt(d) folded into exp2; P rounded
to the input type before P·V; fp32 accumulation; one division by the row sum
at the end. It is held against the JAX package's `_xla_attention` and its
Pallas kernel (interpret mode) on numpy-seeded inputs, and against the fp32
plain version on chip_smoke.py's inputs, which justifies that script's
bf16 and fp16 tolerances.

Measured (this file's inputs): against XLA and Pallas, max|emulation − jax|
/ max|jax| ≤ 6.2e-3 in bf16 and ≤ 9.2e-4 in fp16, i.e. about one unit in
the last place of the output (2^-7 and 2^-10 of its largest value), since
both round the output once and P at different points; the bounds below are
1e-2 and 1.5e-3. Against the fp32 plain version on chip_smoke.py's kernel
cases: at most 1.8e-3 (bf16) and 2.5e-4 (fp16) on random inputs, where
|out| is about 0.03 to 0.07, and 4.1e-3 and 5.1e-4 on the mask-trap
inputs, where |out| is about 1 (half a unit in the last place). The smoke's
tolerances, 8e-3 and 1.25e-3 on random inputs and 2e-2 and 2.5e-3 on the
mask trap, are 4.4, 5.0, 4.9 and 4.9 times that. Without the
mask the mask-trap inputs give an error of about 1.
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

BLOCK_N = 64  # keys per tile: the kernel's MMA_BLOCK_N
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
# max|emulation − jax| / max|jax|: about one unit in the last place.
REL_TOL = {torch.bfloat16: 1e-2, torch.float16: 1.5e-3}


def tiled_attention(q, k, v, block_n=BLOCK_N, mask=True):
    """(B, N, h, d) bf16/fp16 -> (B, N, h, d), in the kernel's order of work."""
    B, N, H, D = q.shape
    c = (torch.tensor(1.4426950408889634, dtype=torch.float32)
         / torch.tensor(float(D)).sqrt())
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    pad = (0, 0, 0, -N % block_n)  # the kernel zero-fills keys past N
    kf, vf = F.pad(kf, pad), F.pad(vf, pad)
    m = torch.full((B, H, N, 1), -math.inf)
    l = torch.zeros(B, H, N, 1)
    acc = torch.zeros(B, H, N, D)
    for k0 in range(0, N, block_n):
        s = qf @ kf[:, :, k0:k0 + block_n].transpose(-1, -2)
        if mask:
            s[..., N - k0:] = -math.inf
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(q.dtype).float() @ vf[:, :, k0:k0 + block_n]
        m = m_new
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("N", [16, 100, 256])
def test_tiled_emulation_matches_xla_and_pallas(N, d, dtype):
    rng = np.random.default_rng(100 * N + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, N, 2, d))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    ours = tiled_attention(q, k, v)
    # The inputs are exact in the 16-bit type, so both sides see the same.
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(JAX_DTYPE[dtype])
                  for t in (q, k, v))
    for name, theirs in (
            ("xla", _xla_attention(jq, jk, jv)),
            ("pallas", _pallas_attention(jq, jk, jv, interpret=True))):
        theirs = torch.from_numpy(np.array(theirs.astype(jnp.float32)))
        assert ours.shape == theirs.shape == (2, N, 2, d)
        assert ours.dtype == dtype
        assert rel_err(ours.float(), theirs) <= REL_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_smoke_tolerances_cover_the_kernel_error_with_margin(dtype):
    """chip_smoke.py's kernel cases of this dtype, random and mask-trap
    inputs, at batch 1. Each case's tolerance is at least 4 times the
    emulation's error against the fp32 plain version."""
    name = str(dtype).split(".")[-1]
    rng = np.random.default_rng(0)
    kinds = set()
    for _, N, h, d, dname, inputs in chip_smoke.KERNEL_CASES:
        if dname != name:
            continue
        if inputs == "randn":
            packed = rng.standard_normal((1, N, 3, h, d)).astype(np.float32)
        else:
            packed = chip_smoke.mask_trap_qkv(rng, 1, N, h, d)
        q, k, v = torch.from_numpy(packed).to(dtype).unbind(2)
        ref = attention_reference(q.float(), k.float(), v.float())
        err = (tiled_attention(q, k, v).float() - ref).abs().max().item()
        assert 4 * err <= chip_smoke.ATOL[name, inputs], (N, d, inputs, err)
        kinds.add(inputs)
    assert kinds == {"randn", "mask trap"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_mask_trap_catches_a_missing_mask(dtype):
    """Every real score is about -30, so an unmasked zero-filled key (score
    0, v 0) takes nearly all the weight: an error of about 1."""
    rng = np.random.default_rng(1)
    q, k, v = torch.from_numpy(
        chip_smoke.mask_trap_qkv(rng, 2, 1000, 2, 32)).to(dtype).unbind(2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(32)
    assert scores.max() < -25 and abs(scores.mean() + 30) < 1
    ref = attention_reference(q.float(), k.float(), v.float())
    masked = (tiled_attention(q, k, v).float() - ref).abs().max().item()
    unmasked = (tiled_attention(q, k, v, mask=False).float()
                - ref).abs().max().item()
    assert masked <= chip_smoke.ATOL[str(dtype).split(".")[-1], "mask trap"]
    assert unmasked > 0.5


@pytest.mark.parametrize("img_size,batch", [(64, 2), (256, 1)])
def test_smoke_kernel_cases_hold_the_main_paths_attention_shapes(
        img_size, batch, monkeypatch):
    """The shapes chip_smoke.py holds its kernels at are the ones the model
    hands the attention: its path phase (64², batch 2, fp32) and its serve
    phase (256², batch 8, bf16; checked here at batch 1 and in fp32)."""
    from hybrid_diffusion_tpu_torch.config import flagship_config
    from hybrid_diffusion_tpu_torch.models import blocks
    from hybrid_diffusion_tpu_torch.train.loop import build_model

    seen = []

    def record(q, k, v):
        seen.append(tuple(q.shape))
        return attention_reference(q, k, v)

    monkeypatch.setattr(blocks, "fused_spatial_attention", record)
    torch.manual_seed(0)
    model = build_model(flagship_config(img_size=img_size, bf16=False)).eval()
    with torch.no_grad():
        model(torch.zeros(batch, img_size, img_size, 6),
              torch.zeros(batch, dtype=torch.long))
    B, N, h, d, _, _ = (chip_smoke.PATH_CASE if img_size == 64
                        else chip_smoke.SERVE_CASE)
    assert seen == [(batch if img_size == 256 else B, N, h, d)] * 4
