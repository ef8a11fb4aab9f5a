"""Dual/multi-encoder architecture with per-level fusion (port of the JAX
package's ``models/dual_encoder.py``).

One UNet-style encoder per modality (``encoder{m}``); per-level fusion ∈
{concat (1×1 projection), add, attention (SE over modalities),
cross_attention, bidirectional, suv_guided, mean}; a shared UNet decoder.
The input ``[B, H, W, D, M]`` is split channel-wise per modality. Public
layout and precision as ``UNet3D``.

Cross attention (kernel B on the card) runs where a level's voxel-token
count is within ``xattn_max_tokens``; above it the level fuses by addition,
as in the JAX package. Torch fixes parameter shapes at construction, so the
attention modules are built for the levels of an ``img_size`` tile; an input
whose level attends without a module raises.

With more than two modalities the key and value of cross attention (and
the addition above the budget) take the mean of the other modalities.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from multimodal_organ_segmentation_tpu_torch.models.fusion import (
    AttentionFusion,
    BidirectionalCrossAttention,
    CrossAttentionFusion,
    SUVGuidedAttention,
)
from multimodal_organ_segmentation_tpu_torch.models.layers import (
    Conv3d,
    ConvBlock3D,
    DownBlock3D,
    Dropout3D,
    Linear,
    UpBlock3D,
    cf,
    cl,
    logits_out,
    perturb_at,
    supervised_outputs,
)
from multimodal_organ_segmentation_tpu_torch.utils.config import deep_supervision

FUSION_TYPES = ("concat", "add", "attention", "cross_attention", "bidirectional", "suv_guided",
                "mean")


class _Encoder(nn.Module):
    """``init_conv`` + ``down{i}``; returns every level's features."""

    def __init__(self, features: Sequence[int], norm: str, in_channels: int = 1):
        super().__init__()
        self.levels = len(features)
        self.init_conv = ConvBlock3D(in_channels, features[0], norm=norm)
        for i in range(len(features) - 1):
            self.add_module(f"down{i}", DownBlock3D(features[i], features[i + 1], norm))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.init_conv(x)
        outs = [x]
        for i in range(self.levels - 1):
            x, _ = getattr(self, f"down{i}")(x)
            outs.append(x)
        return outs


def _mean(features: List[torch.Tensor]) -> torch.Tensor:
    return features[0] if len(features) == 1 else torch.stack(features, dim=0).mean(dim=0)


class DualEncoder(nn.Module):
    """Separate encoder per modality + fused shared decoder.

    Submodules carry the JAX package's names: ``encoder{m}``,
    ``fusion_proj{l}`` / ``fusion_attn{l}`` / ``fusion_xattn{l}`` /
    ``fusion_bixattn{l}`` / ``fusion_suv{l}`` per level, ``up{j}``,
    ``ds_head{j}``, ``out_conv``. ``suv_channel`` is the input channel of
    the PET/SUV volume that ``suv_guided`` fusion reads. ``forward``'s
    ``perturb`` takes the perturbation points ``fused{l}`` (each level's
    fused features).
    """

    def __init__(
        self,
        num_modalities: int = 2,
        out_channels: int = 8,
        features: Sequence[int] = (32, 64, 128, 256, 512),
        norm: str = "instance",
        fusion_type: str = "concat",
        dropout: float = 0.0,
        cross_attn_heads: int = 4,
        suv_channel: int = 1,
        suv_threshold: float = 2.5,
        dtype: torch.dtype = torch.float32,
        xattn_max_tokens: int = 16384,
        deep_supervision: bool = False,
        img_size: Sequence[int] = (96, 96, 96),
    ):
        super().__init__()
        if fusion_type not in FUSION_TYPES:
            raise ValueError(f"DualEncoder: unknown fusion {fusion_type!r}; choose from "
                             f"{FUSION_TYPES}")
        feats = [int(f) for f in features]
        self.features = tuple(feats)
        self.num_modalities = num_modalities
        self.fusion_type = fusion_type
        self.suv_channel = suv_channel
        self.dtype = dtype
        self.xattn_max_tokens = int(xattn_max_tokens)
        self.deep_supervision = deep_supervision
        self.img_size = tuple(int(s) for s in img_size)
        for m in range(num_modalities):
            self.add_module(f"encoder{m}", _Encoder(feats, norm))
        grid = self.img_size
        for level, c in enumerate(feats):
            fusion = self._fusion_module(level, c, grid, cross_attn_heads, suv_threshold)
            if fusion is not None:
                self.add_module(*fusion)
            grid = tuple(g // 2 for g in grid)
        for j, i in enumerate(range(len(feats) - 1, 0, -1)):
            self.add_module(f"up{j}", UpBlock3D(feats[i], feats[i - 1], feats[i - 1], feats[i] // 2, norm))
            if deep_supervision and i > 1:
                self.add_module(f"ds_head{j}", Conv3d(feats[i - 1], out_channels, 1))
        self.dropout = Dropout3D(dropout)
        self.out_conv = Conv3d(feats[0], out_channels, 1)

    def _fusion_module(self, level: int, c: int, grid: Tuple[int, ...], heads: int,
                       suv_threshold: float) -> Optional[Tuple[str, nn.Module]]:
        t = self.fusion_type
        if t == "concat":
            return f"fusion_proj{level}", Linear(self.num_modalities * c, c)
        if t == "attention":
            return f"fusion_attn{level}", AttentionFusion(self.num_modalities, c)
        if t == "suv_guided":
            return f"fusion_suv{level}", SUVGuidedAttention(c, suv_threshold)
        if t in ("cross_attention", "bidirectional") and self._attends(grid):
            if t == "cross_attention":
                return f"fusion_xattn{level}", CrossAttentionFusion(c, num_heads=heads)
            return f"fusion_bixattn{level}", BidirectionalCrossAttention(c, num_heads=heads)
        return None

    def _attends(self, grid: Sequence[int]) -> bool:
        """Voxel-token attention is O(N²): a level attends only within the
        token budget, and fuses by addition above it."""
        return grid[0] * grid[1] * grid[2] <= self.xattn_max_tokens

    @property
    def perturb_points(self) -> List[str]:
        """The names of the perturbation points."""
        return [f"fused{i}" for i in range(len(self.features))]

    def forward(
        self,
        x: torch.Tensor,
        capture: bool = False,
        perturb: Optional[Dict[str, torch.Tensor]] = None,
        intermediates: Optional[Dict[Tuple[str, ...], List[torch.Tensor]]] = None,
    ) -> Union[torch.Tensor, List[torch.Tensor], Tuple[torch.Tensor, Dict[str, list]]]:
        """Logits, or with ``capture`` ``(logits, {"encoder_features": per
        modality the channels-last features of every level, "fused_features":
        the channels-last fused features of every level})`` (``outs`` for the
        logits under deep supervision in training). ``perturb`` takes the live
        fused features ``fused{l}``; ``intermediates`` takes the modality weights of
        ``attention`` fusion under ``("fusion_attn{l}", "modality_weights")``."""
        if x.shape[-1] != self.num_modalities:
            raise ValueError(f"DualEncoder built for {self.num_modalities} modalities got "
                             f"{tuple(x.shape)}")
        x = x.to(self.dtype)
        per_modality = [getattr(self, f"encoder{m}")(cf(x[..., m:m + 1]))
                        for m in range(self.num_modalities)]
        suv = x[..., self.suv_channel:self.suv_channel + 1]
        fused = [perturb_at(perturb, f"fused{level}",
                            self._fuse(level, [cl(f[level]) for f in per_modality], suv,
                                       intermediates), channels_first=True)
                 for level in range(len(self.features))]

        y, skips = fused[-1], fused[:-1]
        aux = []
        for j, i in enumerate(range(len(self.features) - 1, 0, -1)):
            y = getattr(self, f"up{j}")(y, skips[i - 1])
            if self.deep_supervision and self.training and i > 1:
                aux.append(logits_out(getattr(self, f"ds_head{j}"), y))
        logits = logits_out(self.out_conv, self.dropout(y))
        if aux:
            logits = supervised_outputs(logits, aux[::-1])
        if capture:
            return logits, {"encoder_features": [[cl(f) for f in feats] for feats in per_modality],
                            "fused_features": [cl(f) for f in fused]}
        return logits

    def _fuse(self, level: int, feats: List[torch.Tensor], suv: torch.Tensor,
              intermediates: Optional[dict] = None) -> torch.Tensor:
        """One level's channels-last features per modality → the fused
        channels-first features."""
        t = self.fusion_type
        if t == "concat":
            f = getattr(self, f"fusion_proj{level}")(torch.cat(feats, dim=-1))
        elif t == "add":
            f = sum(feats[1:], feats[0])
        elif t == "attention":
            sow = None
            if intermediates is not None:
                sow = intermediates.setdefault((f"fusion_attn{level}", "modality_weights"), [])
            f = getattr(self, f"fusion_attn{level}")(feats, sow)
        elif t in ("cross_attention", "bidirectional"):
            others = _mean(feats[1:])
            if not self._attends(feats[0].shape[1:4]):
                f = feats[0] + others
            else:
                name = f"fusion_{'xattn' if t == 'cross_attention' else 'bixattn'}{level}"
                if not hasattr(self, name):
                    raise ValueError(f"DualEncoder built for {self.img_size} tiles has no {name} "
                                     f"for a {tuple(feats[0].shape[1:4])} level")
                f = getattr(self, name)(feats[0], others)
        elif t == "suv_guided":
            base = feats[0] + _mean(feats[1:]) if len(feats) > 1 else feats[0]
            f = getattr(self, f"fusion_suv{level}")(base, suv)
        else:  # mean
            f = _mean(feats)
        return cf(f)

    @property
    def encoder_channels(self) -> List[int]:
        return list(self.features)


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def build_dual_encoder(config, dtype: torch.dtype = torch.float32) -> DualEncoder:
    """Factory from config (the JAX package's ``build_dual_encoder``).

    ``parallel.sequence_axis`` shards cross attention's tokens over a mesh
    axis (ring attention). On one device the JAX builder drops it, the axis
    having size 1; this port runs one process on one device and drops it the
    same way. A process group of more than one raises: the ring comes with
    the multi-device slice.
    """
    backbone = config.get("model.backbone", {}) or {}
    fusion = config.get("model.fusion", {}) or {}
    modalities = [str(m).upper() for m in config.get("data.modalities", ["CT", "PET"])]
    ftype = str(fusion.get("type", "concat"))
    if ftype in ("early", "late"):  # the CLI vocabulary onto the DualEncoder's
        ftype = "concat"
    if config.get("parallel.sequence_axis", None) and _world_size() > 1:
        raise NotImplementedError(
            "parallel.sequence_axis across processes (ring attention, A24) is not ported to the "
            "PyTorch package yet; it comes with the multi-device slice")
    return DualEncoder(
        num_modalities=len(modalities),
        out_channels=int(config.get("model.out_channels", 8)),
        features=tuple(backbone.get("features", [32, 64, 128, 256, 512])),
        norm=str(backbone.get("norm", "instance")),
        fusion_type=ftype,
        dropout=float(config.get("model.head.dropout", 0.0) or 0.0),
        suv_channel=modalities.index("PET") if "PET" in modalities else min(1, len(modalities) - 1),
        suv_threshold=float(fusion.get("suv_threshold", 2.5)),
        dtype=dtype,
        xattn_max_tokens=int(fusion.get("max_tokens", 16384)),
        deep_supervision=deep_supervision(config),
        img_size=tuple(backbone.get("img_size", [96, 96, 96])),
    )
