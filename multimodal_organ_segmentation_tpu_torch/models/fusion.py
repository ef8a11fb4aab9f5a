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
shapes at construction, so each module takes its channel counts. The
ring-attention branch of ``CrossAttentionFusion`` (sequence parallelism over
a mesh axis) belongs to the multi-device slice. ``AttentionFusion``'s
modality weights, which the JAX module sows for the explainability code,
come with that code.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_organ_segmentation_tpu_torch.models.layers import (
    Conv3d,
    Linear,
    conv_cl,
    instance_norm,
)
from multimodal_organ_segmentation_tpu_torch.ops.attention import multi_head_attention
from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear


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
    weighted sum of the modalities."""

    def __init__(self, num_modalities: int, channels: int, reduction: int = 4):
        super().__init__()
        width = num_modalities * channels
        self.fc1 = Linear(width, max(width // reduction, 1))
        self.fc2 = Linear(max(width // reduction, 1), num_modalities)

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        pooled = torch.cat([f.mean(dim=(1, 2, 3)) for f in features], dim=-1)  # [B, M*C]
        w = torch.softmax(self.fc2(F.relu(self.fc1(pooled))), dim=-1)  # [B, M]
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
    """

    def __init__(self, channels: int, num_heads: int = 4, dropout: float = 0.0,
                 kv_block: int = 2048):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} must divide num_heads {num_heads}")
        self.num_heads = num_heads
        self.kv_block = kv_block
        self.use_kernel = True
        self.q_proj = Linear(channels, channels)
        self.k_proj = Linear(channels, channels)
        self.v_proj = Linear(channels, channels)
        self.out_proj = Linear(channels, channels)
        self.dropout = nn.Dropout(dropout)

    def forward(self, query_features: torch.Tensor, key_value_features: torch.Tensor) -> torch.Tensor:
        b, h, w, d, c = query_features.shape
        hd = c // self.num_heads
        n = h * w * d
        q = self.q_proj(query_features).reshape(b, n, self.num_heads, hd)
        k = self.k_proj(key_value_features).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(key_value_features).reshape(b, -1, self.num_heads, hd)
        out = multi_head_attention(q, k, v, kv_block=self.kv_block, use_kernel=self.use_kernel)
        out = self.dropout(self.out_proj(out.reshape(b, h, w, d, c)))
        return conv_cl(instance_norm, query_features + out)


class BidirectionalCrossAttention(nn.Module):
    """Both directions of cross attention (``cross_1to2``, ``cross_2to1``),
    concat, 1×1 conv back to ``channels``, instance norm, relu."""

    def __init__(self, channels: int, num_heads: int = 4, dropout: float = 0.0):
        super().__init__()
        self.cross_1to2 = CrossAttentionFusion(channels, num_heads, dropout)
        self.cross_2to1 = CrossAttentionFusion(channels, num_heads, dropout)
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
