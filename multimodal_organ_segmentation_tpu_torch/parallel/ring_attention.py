"""Ring attention: sequence-parallel attention over the voxel-token axis
(port of the JAX package's ``parallel/ring_attention.py``).

Each rank holds its ``[B, N/size, H, D]`` shard of the tokens of q, k and v.
Per ring step a rank attends its queries to the visiting K/V block with the
flash recurrence (running max and denominator, in f32), then passes the
block to the next rank (``batch_isend_irecv``); after ``size`` steps every
query has seen every key. Plain PyTorch, as the JAX package's einsums: no
kernel.

torch's point-to-point ops do not differentiate, so the gradient is written
out (:class:`_RingAttention`): the backward runs the ring again from the
saved log-sum-exp, each K/V block travelling with its dK/dV accumulators
until they are home.

gloo carries point-to-point transfers of CPU tensors only: on a gloo group
of CUDA ranks (two ranks sharing one card) every exchange stages through the
host. NCCL groups exchange on the device.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from multimodal_organ_segmentation_tpu_torch.parallel.mesh import DeviceMesh, _staged, collective


def _pass_on(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send every tensor to the next rank of the ring and receive the
    previous rank's, as one flat f32 buffer."""
    size = dist.get_world_size(group)
    if size == 1:
        return tensors
    rank = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    staged = _staged(group, flat)
    send = flat.cpu() if staged else flat
    recv = torch.empty_like(send)
    for req in collective(dist.batch_isend_irecv, [dist.P2POp(dist.isend, send, nxt, group),
                                                   dist.P2POp(dist.irecv, recv, prv, group)]):
        req.wait()
    recv = recv.to(flat.device)
    return [c.view_as(t).to(t.dtype) for c, t in
            zip(recv.split([t.numel() for t in tensors]), tensors)]


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        size = dist.get_world_size(group)
        qf = q.float() * scale
        b, n, h, _ = q.shape
        m_run = torch.full((b, h, n), -1e30, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, h, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for step in range(size):
            s = torch.einsum("bnhd,bmhd->bhnm", qf, k_blk.float())
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bhnm,bmhd->bnhd", p, v_blk.float())
            m_run = m_new
            if step < size - 1:
                k_blk, v_blk = _pass_on([k_blk, v_blk], group)
        out = acc / l_run.transpose(1, 2)[..., None]
        ctx.save_for_backward(q, k, v, out, m_run + torch.log(l_run))
        ctx.group, ctx.scale = group, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        size = dist.get_world_size(group)
        qf, do = q.float(), dout.float()
        delta = (do * out).sum(dim=-1).transpose(1, 2)[..., None]  # [B, H, n, 1]
        dq = torch.zeros_like(qf)
        k_blk, v_blk = k.float(), v.float()
        dk, dv = torch.zeros_like(k_blk), torch.zeros_like(v_blk)
        for step in range(size):
            p = torch.exp(torch.einsum("bnhd,bmhd->bhnm", qf * scale, k_blk) - lse[..., None])
            dv = dv + torch.einsum("bhnm,bnhd->bmhd", p, do)
            ds = p * (torch.einsum("bnhd,bmhd->bhnm", do, v_blk) - delta)
            dq = dq + torch.einsum("bhnm,bmhd->bnhd", ds, k_blk) * scale
            dk = dk + torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
            # the accumulators travel with their block; after `size` passes
            # every block and its dK/dV are back with their owner
            if step < size - 1:
                k_blk, v_blk, dk, dv = _pass_on([k_blk, v_blk, dk, dv], group)
            else:
                dk, dv = _pass_on([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    axis_name: str = "data",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Sequence-parallel attention with the tokens sharded over
    ``axis_name``.

    Args:
        q, k, v: this rank's ``[B, N/size, H, D]`` shards; shard ``r`` holds
            tokens ``[r·N/size, (r+1)·N/size)``.
        mesh: the process mesh.
        axis_name: mesh axis carrying the token shards.

    Returns:
        this rank's ``[B, N/size, H, D]`` shard of the output, in q's dtype.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, mesh.group(axis_name), float(scale))
