"""Prediction heads (port of the JAX package's ``models/heads.py``).

Segmentation (dropout + k³ conv + optional activation), deep supervision
(one segmentation head per scale, upsampled to a target grid), anchor-based
detection and anchor-free CenterNet-style detection. Features in and
outputs out are channels-last ``[B, H, W, D, C]``, as the JAX heads take
them; the convolutions run on channels-first views. Each head's output
convs run in f32, as in the JAX package (``cast_to_compute_dtype`` keeps
their weights f32: ``out_conv``, ``cls_head``, ``reg_head`` and ``*_out``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_organ_segmentation_tpu_torch.models.layers import Conv3d, Dropout3D, conv_cl
from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear


def _same_conv(cin: int, cout: int, k: int) -> Conv3d:
    if k % 2 == 0:
        raise ValueError(f"SAME padding needs an odd kernel, got {k}")
    return Conv3d(cin, cout, k, padding=k // 2)


class SegmentationHead(nn.Module):
    """dropout → conv(k³, f32) → optional softmax / sigmoid over classes."""

    def __init__(self, in_channels: int, num_classes: int, kernel_size: int = 1,
                 dropout: float = 0.0, activation: Optional[str] = None):
        super().__init__()
        if activation not in (None, "softmax", "sigmoid"):
            raise ValueError(f"SegmentationHead: unknown activation {activation!r}")
        self.activation = activation
        self.dropout = Dropout3D(dropout)
        self.out_conv = _same_conv(in_channels, num_classes, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_cl(self.out_conv, conv_cl(self.dropout, x).float())
        if self.activation == "softmax":
            return torch.softmax(x, dim=-1)
        if self.activation == "sigmoid":
            return torch.sigmoid(x)
        return x


class DeepSupervisionHead(nn.Module):
    """One ``SegmentationHead`` per scale (``scale{i}``), each output
    linearly resized to ``target_size`` where its grid differs."""

    def __init__(self, in_channels: Sequence[int], num_classes: int,
                 target_size: Tuple[int, int, int], dropout: float = 0.0):
        super().__init__()
        self.target_size = tuple(int(s) for s in target_size)
        for i, c in enumerate(in_channels):
            self.add_module(f"scale{i}", SegmentationHead(c, num_classes, dropout=dropout))
        self.num_scales = len(in_channels)

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = []
        for i, f in enumerate(features):
            logits = getattr(self, f"scale{i}")(f)
            if tuple(logits.shape[1:4]) != self.target_size:
                logits = resize_linear(logits, self.target_size, (1, 2, 3))
            outs.append(logits)
        return outs


class DetectionHead(nn.Module):
    """Anchor-based: shared 3³ conv → relu → f32 3³ convs for the classes
    (anchors × classes) and the boxes (anchors × 6)."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int = 3,
                 hidden: int = 64):
        super().__init__()
        self.conv = _same_conv(in_channels, hidden, 3)
        self.cls_head = _same_conv(hidden, num_anchors * num_classes, 3)
        self.reg_head = _same_conv(hidden, num_anchors * 6, 3)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = F.relu(conv_cl(self.conv, x)).float()
        return {"cls": conv_cl(self.cls_head, h), "reg": conv_cl(self.reg_head, h)}


class CenterNetHead(nn.Module):
    """Anchor-free: three branches of 3³ conv → relu → f32 1×1 conv: the
    class heatmap (sigmoid), the centre offset (3) and the box size (3)."""

    BRANCHES = ("heatmap", "offset", "size")

    def __init__(self, in_channels: int, num_classes: int, hidden: int = 64):
        super().__init__()
        for name, out in zip(self.BRANCHES, (num_classes, 3, 3)):
            self.add_module(f"{name}_conv", _same_conv(in_channels, hidden, 3))
            self.add_module(f"{name}_out", Conv3d(hidden, out, 1))

    def _branch(self, name: str, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(conv_cl(getattr(self, f"{name}_conv"), x)).float()
        return conv_cl(getattr(self, f"{name}_out"), h)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {name: self._branch(name, x) for name in self.BRANCHES}
        out["heatmap"] = torch.sigmoid(out["heatmap"])
        return out
