"""Ring attention: exact attention with the token axis sharded over a mesh
axis.

Counterpart of `hybrid_diffusion_tpu/ops/ring_attention.py` (:31-122).
Each rank keeps its query rows and one block of K/V; the blocks travel
around the ring (rank r sends to r+1 and receives from r−1 with
`torch.distributed.batch_isend_irecv`, the next block in flight while the
current one is multiplied), and a flash-style online softmax folds each
visiting block into a running (max, sum, out) accumulator. The JAX body is
einsum, not Pallas, so plain torch matmuls in fp32 are its counterpart.

Reverse mode: JAX differentiates through its scan and ppermute; here
`_RingAttention` has a ring backward: it recomputes each block's
probabilities from the saved log-sum-exp, accumulates dQ locally, and sends
each block's dK/dV along with the block, one more hop bringing them home.

`ring_spatial_attention(q, k, v, mesh, axis)` takes replicated (B, N, h, d)
tensors, as a drop-in for `fused_spatial_attention` under replicated
activations: each rank takes its token rows, runs the ring, and the rows
are gathered back (Megatron's split/gather pair: the split's backward
gathers the input gradients, the gather's backward keeps the rank's rows).

Send/recv over gloo does not take CUDA tensors; with CUDA tensors the ring
needs NCCL (one card a rank).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import axis_group, axis_size


def _rotate(tensors: list, group) -> tuple[list, list]:
    """Start sending `tensors` (contiguous) to the next rank of the ring and
    receiving the previous rank's; returns (received buffers, requests)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recv])
    return recv, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def _ring_forward(q, k, v, group):
    """(out (B, n, h, d) in q's dtype, lse (B, h, n) fp32) for the local
    query rows against every rank's K/V block."""
    size = 1 if group is None else dist.get_world_size(group)
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32 = q.float()
    B, n, h, d = q.shape
    o = q32.new_zeros((B, h, n, d))
    m = q32.new_full((B, h, n), -math.inf)
    l = q32.new_zeros((B, h, n))
    kb, vb = k.contiguous(), v.contiguous()
    for step in range(size):
        reqs = None
        if step < size - 1:
            (nk, nv), reqs = _rotate([kb, vb], group)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float()) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                vb.float())
        m = m_new
        if reqs is not None:
            _wait(reqs)
            kb, vb = nk, nv
    out = (o / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(l)


def _ring_backward(q, k, v, out, lse, grad_out, group):
    """(dq, dk, dv) of the local rows and block."""
    size = 1 if group is None else dist.get_world_size(group)
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, do = q.float(), grad_out.float()
    delta = torch.einsum("bqhd,bqhd->bhq", do, out.float())
    dq = torch.zeros_like(q32)
    kb, vb = k.contiguous(), v.contiguous()
    dkb = torch.zeros_like(k, dtype=torch.float32)
    dvb = torch.zeros_like(v, dtype=torch.float32)
    for step in range(size):
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float()) * scale
        p = torch.exp(s - lse[..., None])
        dvb = dvb + torch.einsum("bhqk,bqhd->bkhd", p, do)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, vb.float())
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float())
        dkb = dkb + torch.einsum("bhqk,bqhd->bkhd", ds, q32)
        if size > 1:
            # The block moves on with its gradients; after the last block
            # one more hop takes dK/dV home.
            moving = [dkb, dvb] if step == size - 1 else [kb, vb, dkb, dvb]
            recv, reqs = _rotate(moving, group)
            _wait(reqs)
            if step == size - 1:
                dkb, dvb = recv
            else:
                kb, vb, dkb, dvb = recv
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group):
        out, lse = _ring_forward(q, k, v, group)
        ctx.group = group
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_backward(q, k, v, out, lse, grad_out, ctx.group),
                None)


class _SplitTokens(torch.autograd.Function):
    """This rank's token rows of a replicated (B, N, ...) tensor; backward:
    the gradient rows of every rank, gathered."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        per = x.shape[1] // size
        return x[:, rank * per:(rank + 1) * per].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_tokens(grad, ctx.group), None


class _GatherTokens(torch.autograd.Function):
    """Every rank's token rows, concatenated; backward: this rank's rows
    of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_tokens(x, group)

    @staticmethod
    def backward(ctx, grad):
        size, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        per = grad.shape[1] // size
        return grad[:, rank * per:(rank + 1) * per].contiguous(), None


@torch.no_grad()
def _gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    return all_gather_rows(x.transpose(0, 1), group).transpose(0, 1)


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group) -> torch.Tensor:
    """The exact softmax(QKᵀ/√d)V rows of this rank's query block: q, k, v
    (B, n, h, d) are the rank's token blocks (rank r holds tokens
    [r·n, (r+1)·n)). Differentiable; group None is one rank (no
    communication)."""
    return _RingAttention.apply(q, k, v, group)


def ring_spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh, axis: str = "data") -> torch.Tensor:
    """Exact attention with the token axis sharded over `mesh[axis]`.

    q, k, v: (B, N, heads, head_dim), the same on every rank of the axis;
    N must divide by the axis size. Returns the (B, N, heads, head_dim)
    output on every rank, equal to `fused_spatial_attention(q, k, v)` but
    for the order of the fp32 sums.
    """
    n_axis = axis_size(mesh, axis)
    if q.shape[1] % n_axis:
        raise ValueError(
            f"token count {q.shape[1]} not divisible by mesh axis "
            f"'{axis}' of size {n_axis}")
    group = axis_group(mesh, axis)
    if group is None:
        return ring_attention_shard(q, k, v, None)
    q, k, v = (_SplitTokens.apply(t, group) for t in (q, k, v))
    return _GatherTokens.apply(ring_attention_shard(q, k, v, group), group)


def make_ring_attention(mesh, axis: str = "data"):
    """Adapter with the `fused_spatial_attention(q, k, v)` signature, for
    SpatialSelfAttention's hook
    (`block.attention_fn = make_ring_attention(mesh, "data")`)."""

    def attention_fn(q, k, v):
        return ring_spatial_attention(q, k, v, mesh, axis)

    return attention_fn
