"""Attention primitives: dense and blockwise (flash-style) multi-head attention.

Port of the JAX package's ``ops/attention.py``. All functions take
``[B, N, H, Dh]`` query/key/value (tokens-major, heads inside) and return
``[B, N, H, Dh]`` in q's dtype:

- ``dense_attention`` — reference softmax attention, f32 math;
- ``blockwise_attention`` — a loop over KV blocks with the (running max,
  running denominator) flash recurrence; the plain version of kernel B;
- ``multi_head_attention`` — the dispatch: kernel B (``flash_attention``)
  on a CUDA tensor, ``blockwise_attention`` on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Reference dense softmax attention."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)  # f32 math; f64 stays f64
    scores = torch.einsum("bnhd,bmhd->bhnm", q.to(acc), k.to(acc)) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", probs, v.to(acc))
    return out.to(q.dtype)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_block: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Memory-efficient attention: loop over KV blocks, flash recurrence."""
    b, n, h, d = q.shape
    m = k.shape[1]
    scale = scale if scale is not None else d**-0.5

    if m <= kv_block:
        return dense_attention(q, k, v, scale)

    # pad KV to a multiple of kv_block with -inf-masked entries
    pad = (-m) % kv_block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    valid = torch.arange(m + pad, device=q.device) < m

    wide = torch.promote_types(q.dtype, torch.float32)  # f32 math; f64 stays f64
    qf = q.to(wide) * scale
    m_run = torch.full((b, h, n), -torch.inf, dtype=wide, device=q.device)
    l_run = torch.zeros((b, h, n), dtype=wide, device=q.device)
    acc = torch.zeros((b, n, h, d), dtype=wide, device=q.device)
    for start in range(0, m + pad, kv_block):
        k_i = k[:, start:start + kv_block].to(wide)
        v_i = v[:, start:start + kv_block].to(wide)
        mask_i = valid[start:start + kv_block]
        s = torch.einsum("bnhd,bmhd->bhnm", qf, k_i)
        s = torch.where(mask_i[None, None, None, :], s, -torch.inf)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        # guard: all-masked block at start gives -inf; exp(-inf - -inf) nan
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        correction = torch.exp(m_run - m_safe)
        correction = torch.where(torch.isnan(correction), 0.0, correction)
        l_run = l_run * correction + p.sum(dim=-1)
        acc = acc * correction.permute(0, 2, 1)[..., None] + torch.einsum(
            "bhnm,bmhd->bnhd", p, v_i
        )
        m_run = m_new
    out = acc / l_run.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_block: int = 2048,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Dispatch: kernel B on a CUDA tensor, ``blockwise_attention`` on a CPU
    tensor. ``use_kernel=False`` runs the plain version on any device (the
    reference the kernel is held against on the card)."""
    if use_kernel and q.device.type == "cuda":
        return flash_attention(q, k, v)
    return blockwise_attention(q, k, v, kv_block=kv_block)
