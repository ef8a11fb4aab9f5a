"""Multi-modal fusion library (port of the JAX package's ``models/fusion.py``).

- ``EarlyFusion``                 — channel concat + optional 1×1 projection
- ``LateFusion``                  — concat(+proj) / add / max / mean
- ``HierarchicalLateFusion``      — one LateFusion per decoder level
- ``AttentionFusion``             — SE-style modality softmax weighting
- ``CrossAttentionFusion``        — multi-head cross attention over voxel
                                    tokens, through kernel B
- ``BidirectionalCrossAttention`` — 1→2 and 2→1 cross attention + 1×1 fuse
- ``SUVGuidedAttention``          — PET-SUV-derived soft spatial gating of CT
                                    features

Features are channels-last ``[B, H, W, D, C]``; the JAX package's 1×1×1
convs are held as ``Linear`` over the channel axis. Torch fixes parameter
shapes at construction, so each module takes its channel counts.
``CrossAttentionFusion`` runs as a K/V ring over a process mesh's axis when
given ``sequence_axis`` and ``mesh`` and the ranks share a batch (sequence
parallelism). ``AttentionFusion``'s
modality weights, which the JAX module sows for the explainability code,
go to a ``sow`` list when the caller passes one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_organ_segmentation_tpu_torch.models.layers import (
    Conv3d,
    Dropout,
    Linear,
    conv_cl,
    instance_norm,
)
from multimodal_organ_segmentation_tpu_torch.ops.attention import multi_head_attention
from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear
from multimodal_organ_segmentation_tpu_torch.parallel.tensor_parallel import (
    Split,
    copy_in,
    heads_rule,
    reduce_out,
)

_RING_FALLBACK_WARNED: set = set()


def _warn_ring_fallback(axis: str, n: int, size: int) -> None:
    """Warn (once per shape) when ring attention was configured but the
    token count cannot ride the mesh axis: the fallback to one rank's flash
    attention must not hide a disabled parallelism."""
    key = (axis, n, size)
    if key in _RING_FALLBACK_WARNED:
        return
    _RING_FALLBACK_WARNED.add(key)
    import warnings

    warnings.warn(
        f"ring attention configured on mesh axis '{axis}' (size {size}) but "
        f"token count {n} is not shardable over it — falling back to "
        f"single-device flash attention. Sequence parallelism is OFF for "
        f"this tensor.",
        stacklevel=3,
    )


def _warn_ring_unshared(axis: str) -> None:
    """Warn (once per axis) when ring attention was configured but the ranks
    are not known to hold one batch (each its own tiles or cases): their
    tokens must not meet in one ring, so each rank attends alone."""
    key = (axis, "unshared")
    if key in _RING_FALLBACK_WARNED:
        return
    _RING_FALLBACK_WARNED.add(key)
    import warnings

    warnings.warn(
        f"ring attention configured on mesh axis '{axis}' but the ranks do not "
        f"hold one batch here (each runs its own tiles or cases) — falling back "
        f"to single-device flash attention. Sequence parallelism is OFF for "
        f"these calls.",
        stacklevel=3,
    )


class EarlyFusion(nn.Module):
    """Concat modalities along channels; with ``project``, a 1×1 conv to
    ``out_channels`` (default: the first modality's), instance norm, relu."""

    def __init__(self, in_channels: Sequence[int], out_channels: Optional[int] = None,
                 project: bool = True):
        super().__init__()
        self.project = project
        if project:
            self.proj = Linear(sum(in_channels), out_channels or in_channels[0])

    def forward(self, modalities: List[torch.Tensor]) -> torch.Tensor:
        x = torch.cat(modalities, dim=-1)
        if self.project:
            x = F.relu(conv_cl(instance_norm, self.proj(x)))
        return x


LATE_MODES = ("concat", "add", "max", "mean")


class LateFusion(nn.Module):
    """Combine per-modality feature maps: concat + 1×1 conv (to
    ``out_channels``, default the first's), sum, max or mean."""

    def __init__(self, mode: str = "concat", in_channels: Sequence[int] = (),
                 out_channels: Optional[int] = None):
        super().__init__()
        if mode not in LATE_MODES:
            raise ValueError(f"LateFusion: unknown mode {mode!r}; choose from {LATE_MODES}")
        self.mode = mode
        if mode == "concat":
            self.proj = Linear(sum(in_channels), out_channels or in_channels[0])

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        if self.mode == "concat":
            return self.proj(torch.cat(features, dim=-1))
        if self.mode == "add":
            return sum(features[1:], features[0])
        stacked = torch.stack(features, dim=0)
        return stacked.amax(dim=0) if self.mode == "max" else stacked.mean(dim=0)


class HierarchicalLateFusion(nn.Module):
    """One ``LateFusion`` per pyramid level (``level{i}``);
    ``in_channels[i]`` lists level i's per-modality channels."""

    def __init__(self, in_channels: Sequence[Sequence[int]], mode: str = "concat"):
        super().__init__()
        self.num_levels = len(in_channels)
        for i, chans in enumerate(in_channels):
            self.add_module(f"level{i}", LateFusion(mode, chans))

    def forward(self, per_level_features: List[List[torch.Tensor]]) -> List[torch.Tensor]:
        return [getattr(self, f"level{i}")(feats) for i, feats in enumerate(per_level_features)]


class AttentionFusion(nn.Module):
    """SE-style modality weighting: global-average-pool each modality →
    concat → Dense → relu → Dense → softmax over the modalities → the
    weighted sum of the modalities. ``sow``, a list, takes the weights
    ``[B, M]`` (flax's ``modality_weights``)."""

    def __init__(self, num_modalities: int, channels: int, reduction: int = 4):
        super().__init__()
        width = num_modalities * channels
        self.fc1 = Linear(width, max(width // reduction, 1))
        self.fc2 = Linear(max(width // reduction, 1), num_modalities)

    def forward(self, features: List[torch.Tensor],
                sow: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        pooled = torch.cat([f.mean(dim=(1, 2, 3)) for f in features], dim=-1)  # [B, M*C]
        w = torch.softmax(self.fc2(F.relu(self.fc1(pooled))), dim=-1)  # [B, M]
        if sow is not None:
            sow.append(w)
        stacked = torch.stack(features, dim=1)  # [B, M, H, W, D, C]
        return (stacked * w[:, :, None, None, None, None]).sum(dim=1)


class CrossAttentionFusion(nn.Module):
    """Multi-head cross attention over flattened voxel tokens: query from one
    modality, key/value from the other; residual + instance norm.

    The q/k/v/out projections are the JAX package's 1x1x1 convs, held as
    ``Linear`` over the channel axis. Tokens go through
    ``multi_head_attention``: the custom op of kernel B (the kernel on the
    card, its plain version on the CPU), or the blockwise plain version for
    bf16 on the CPU and when ``use_kernel`` is False (``set_use_kernels``).

    Sequence parallelism: with ``sequence_axis`` naming an axis of ``mesh``
    (a process mesh, ``parallel/mesh.py``) whose size divides the token
    count, the tokens are sharded over its ranks and attention runs as a K/V
    ring (``parallel/ring_attention.py``); otherwise it warns once and falls
    back to the path above, as the JAX module does. The ring runs only where
    the ranks of the axis are known to compute on one batch
    (``parallel.mesh.rows`` in the data-parallel step and validation, where
    the data axis's ranks hold blocks of one batch and a model group's ranks
    the same rows; ``parallel.mesh.same_input``); elsewhere, as in the
    tile-sharded sliding window or case sharding, each rank holds other
    inputs, and it warns once and falls back likewise.

    Tensor parallelism (``tp_apply``, in a SwinUNETR whose model axis is > 1):
    ``num_heads`` is the rank's share, q/k/v hold its heads' output features,
    kernel B runs on those heads, and ``out_proj`` holds their input
    features, whose partial products are summed over the model group before
    the bias; the dropout, residual and norm after it are whole on every rank.
    """

    tp = None

    def __init__(self, channels: int, num_heads: int = 4, dropout: float = 0.0,
                 kv_block: int = 2048, sequence_axis: Optional[str] = None, mesh=None):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} must divide num_heads {num_heads}")
        self.num_heads = num_heads
        self.kv_block = kv_block
        if sequence_axis is not None and mesh is not None:
            mesh.group(sequence_axis)  # an axis the mesh lacks raises here
        self.sequence_axis = sequence_axis
        self.mesh = mesh
        self.use_kernel = True
        self.q_proj = Linear(channels, channels)
        self.k_proj = Linear(channels, channels)
        self.v_proj = Linear(channels, channels)
        self.out_proj = Linear(channels, channels)
        self.dropout = Dropout(dropout)

    def tp_rule(self, path: str, m: int) -> list:
        heads = self.num_heads * (self.tp.size if self.tp else 1)
        split = {f"{n}.{t}": Split(0) for n in ("q_proj", "k_proj", "v_proj")
                 for t in ("weight", "bias")}
        return [heads_rule(path, heads, m, {**split, "out_proj.weight": Split(1)})]

    def tp_apply(self, tp, plan) -> None:
        if self.sequence_axis is not None:
            raise ValueError("a cross-attention fusion with a sequence axis (ring attention) "
                             "cannot also split its heads over the model axis")
        self.tp, self.num_heads = tp, plan.local["num_heads"]

    def forward(self, query_features: torch.Tensor, key_value_features: torch.Tensor) -> torch.Tensor:
        b, h, w, d, c = query_features.shape
        tp = self.tp
        hd = c // (self.num_heads * (tp.size if tp else 1))
        n = h * w * d
        qf, kvf = ((copy_in(query_features, tp), copy_in(key_value_features, tp)) if tp
                   else (query_features, key_value_features))
        q = self.q_proj(qf).reshape(b, n, self.num_heads, hd)
        k = self.k_proj(kvf).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(kvf).reshape(b, -1, self.num_heads, hd)
        if self._ring_ok(n) and k.shape[1] == n:
            out = self._ring(q, k, v)
        else:
            out = multi_head_attention(q, k, v, kv_block=self.kv_block, use_kernel=self.use_kernel)
        out = out.reshape(b, h, w, d, self.num_heads * hd)
        if tp is None:
            out = self.out_proj(out)
        else:
            out = reduce_out(F.linear(out, self.out_proj.weight.to(out.dtype)), tp)
            out = out + self.out_proj.bias.to(out.dtype)
        return conv_cl(instance_norm, query_features + self.dropout(out))

    def _ring_ok(self, n: int) -> bool:
        if self.sequence_axis is None or self.mesh is None:
            return False
        from multimodal_organ_segmentation_tpu_torch.parallel.mesh import ranks_share_batch

        size = self.mesh.shape.get(self.sequence_axis, 1)
        ok = size > 1 and n % size == 0
        if not ok:
            _warn_ring_fallback(self.sequence_axis, n, size)
        elif not ranks_share_batch():
            _warn_ring_unshared(self.sequence_axis)
            ok = False
        return ok

    def _ring(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Ring attention over the ranks of ``sequence_axis``: this rank's
        token shard of every row attends over the ring, and the output's
        shards are gathered back. Every step differentiates.

        Over the data axis, on a batch split over the same ranks (data
        parallelism: ``parallel.mesh.rows``), q, k and v are first gathered
        over the batch and the rank keeps its rows of the output at the end,
        which GSPMD does for the JAX package; the data-parallel step's sum of
        the gradients over the data group adds the shards' parts. Over the
        model axis the ranks of a group hold the same rows and compute the
        replicated layers alike, and no sum over the group follows: each
        rank's shard gradients are gathered back to every rank, and the
        gathered output's gradient, alike on every rank, is not summed."""
        from multimodal_organ_segmentation_tpu_torch.parallel.mesh import (
            active_rows,
            all_gather_cat,
            gather_alike,
            scatter_alike,
        )
        from multimodal_organ_segmentation_tpu_torch.parallel.ring_attention import (
            ring_attention,
        )

        mesh, axis = self.mesh, self.sequence_axis
        if axis != "data":
            q, k, v = (scatter_alike(t, 1, mesh, axis) for t in (q, k, v))
            return gather_alike(ring_attention(q, k, v, mesh, axis), 1, mesh, axis)
        split = active_rows()
        if split is not None:
            q, k, v = (all_gather_cat(t, 0, mesh, axis) for t in (q, k, v))
        m = q.shape[1] // mesh.shape[axis]
        lo = mesh.axis_rank(axis) * m
        out = ring_attention(q[:, lo:lo + m], k[:, lo:lo + m], v[:, lo:lo + m], mesh, axis)
        out = all_gather_cat(out, 1, mesh, axis)
        if split is not None:
            out = out[split[0]:split[0] + split[1]]
        return out


class BidirectionalCrossAttention(nn.Module):
    """Both directions of cross attention (``cross_1to2``, ``cross_2to1``),
    concat, 1×1 conv back to ``channels``, instance norm, relu."""

    def __init__(self, channels: int, num_heads: int = 4, dropout: float = 0.0,
                 sequence_axis: Optional[str] = None, mesh=None):
        super().__init__()
        self.cross_1to2 = CrossAttentionFusion(channels, num_heads, dropout,
                                               sequence_axis=sequence_axis, mesh=mesh)
        self.cross_2to1 = CrossAttentionFusion(channels, num_heads, dropout,
                                               sequence_axis=sequence_axis, mesh=mesh)
        self.fuse = Linear(2 * channels, channels)

    def forward(self, features_1: torch.Tensor, features_2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.cross_1to2(features_1, features_2),
                       self.cross_2to1(features_2, features_1)], dim=-1)
        return F.relu(conv_cl(instance_norm, self.fuse(x)))


class SUVGuidedAttention(nn.Module):
    """PET-SUV-guided spatial attention over CT features: the SUV volume,
    resized to the features' grid, becomes a soft mask σ(2·(SUV − τ)) in f32;
    two 3³ convs (16 channels, relu; 1 channel, sigmoid) turn it into a gate
    ``a``; ``ct · (1 + a)`` → 1×1 conv → instance norm. τ is fixed, or a
    learnable scalar ``threshold`` starting at ``suv_threshold``."""

    def __init__(self, channels: int, suv_threshold: float = 2.5,
                 learnable_threshold: bool = False):
        super().__init__()
        self.suv_threshold = float(suv_threshold)
        self.threshold = (nn.Parameter(torch.tensor(self.suv_threshold))
                          if learnable_threshold else None)
        self.mask_conv1 = Conv3d(1, 16, 3, padding=1)
        self.mask_conv2 = Conv3d(16, 1, 3, padding=1)
        self.proj = Linear(channels, channels)

    def forward(self, ct_features: torch.Tensor, pet_suv: torch.Tensor) -> torch.Tensor:
        tau = self.threshold.float() if self.threshold is not None else self.suv_threshold
        grid = tuple(ct_features.shape[1:4])
        if tuple(pet_suv.shape[1:4]) != grid:
            pet_suv = resize_linear(pet_suv, grid, (1, 2, 3))
        mask = torch.sigmoid((pet_suv.float() - tau) * 2.0).to(ct_features.dtype)
        a = torch.sigmoid(conv_cl(self.mask_conv2, F.relu(conv_cl(self.mask_conv1, mask))))
        return conv_cl(instance_norm, self.proj(ct_features * (1.0 + a)))


FUSION_REGISTRY = {
    "early": EarlyFusion,
    "late": LateFusion,
    "attention": AttentionFusion,
    "cross_attention": CrossAttentionFusion,
    "bidirectional": BidirectionalCrossAttention,
    "suv_guided": SUVGuidedAttention,
}
