"""3D UNet backbone (port of the JAX package's ``models/unet3d.py``).

Encoder-decoder with skip connections; feature ladder default
(32, 64, 128, 256, 512); the bottleneck is excluded from the skips. The
public layout is channels-last: input ``[B, H, W, D, C_in]``, f32 logits
``[B, H, W, D, out_channels]``. Inside, the convolutions take
channels-first views of channels-last memory (``channels_last_3d``), as in
the port's SwinUNETR.

Deep supervision: 1×1 f32 heads ``ds_head{j}`` on the intermediate decoder
stages; in training the model returns ``[main, aux_fine, ..., aux_coarse]``,
each linearly upsampled to the full grid (the trainer's loss wrapper weights
them 1, 1/2, 1/4, ...); in eval only the logits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from multimodal_organ_segmentation_tpu_torch.models.layers import (
    Conv3d,
    ConvBlock3D,
    DownBlock3D,
    Dropout3D,
    UpBlock3D,
    cf,
    cl,
    logits_out,
    perturb_at,
    supervised_outputs,
)
from multimodal_organ_segmentation_tpu_torch.utils.config import (
    deep_supervision,
    refuse_tensor_parallel,
)


class UNet3D(nn.Module):
    """Standard 3D UNet: ``init_conv``, ``down{i}``, ``up{j}``, an optional
    ``ds_head{j}`` per intermediate decoder stage, dropout, ``out_conv``.
    ``dtype`` is the compute dtype (parameters may stay f32 and are cast
    per op); the heads compute in f32. ``forward``'s ``perturb`` takes the
    perturbation points ``feat{i}`` (each encoder level's output)."""

    def __init__(self, in_channels: int = 2, out_channels: int = 8,
                 features: Sequence[int] = (32, 64, 128, 256, 512), norm: str = "instance",
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 deep_supervision: bool = False):
        super().__init__()
        feats = [int(f) for f in features]
        self.features = tuple(feats)
        self.dtype = dtype
        self.deep_supervision = deep_supervision
        self.init_conv = ConvBlock3D(in_channels, feats[0], norm=norm)
        for i in range(len(feats) - 1):
            self.add_module(f"down{i}", DownBlock3D(feats[i], feats[i + 1], norm))
        for j, i in enumerate(range(len(feats) - 1, 0, -1)):
            self.add_module(f"up{j}", UpBlock3D(feats[i], feats[i - 1], feats[i - 1], feats[i] // 2, norm))
            if deep_supervision and i > 1:
                self.add_module(f"ds_head{j}", Conv3d(feats[i - 1], out_channels, 1))
        self.dropout = Dropout3D(dropout)
        self.out_conv = Conv3d(feats[0], out_channels, 1)

    @property
    def perturb_points(self) -> List[str]:
        """The names of the perturbation points."""
        return [f"feat{i}" for i in range(len(self.features))]

    def forward(
        self,
        x: torch.Tensor,
        capture: bool = False,
        perturb: Optional[Dict[str, torch.Tensor]] = None,
        intermediates: Optional[dict] = None,
    ) -> Union[torch.Tensor, List[torch.Tensor], Tuple[torch.Tensor, List[torch.Tensor]]]:
        """Logits, or with ``capture`` ``(logits, hidden)`` (``(outs,
        hidden)`` under deep supervision in training), ``hidden`` the
        channels-last encoder features, bottleneck last. ``perturb`` takes the
        live activations at ``feat0..feat{L-1}``, the same features. The
        model sows no ``intermediates``: the dict stays empty."""
        levels = len(self.features)
        x = perturb_at(perturb, "feat0", self.init_conv(cf(x.to(self.dtype))), channels_first=True)
        skips = [x]
        for i in range(levels - 1):
            x, _ = getattr(self, f"down{i}")(x)
            x = perturb_at(perturb, f"feat{i + 1}", x, channels_first=True)
            skips.append(x)
        hidden = [cl(s) for s in skips] if capture else None
        aux = []
        for j, i in enumerate(range(levels - 1, 0, -1)):
            x = getattr(self, f"up{j}")(x, skips[i - 1])
            if self.deep_supervision and self.training and i > 1:
                aux.append(logits_out(getattr(self, f"ds_head{j}"), x))
        logits = logits_out(self.out_conv, self.dropout(x))
        if aux:
            logits = supervised_outputs(logits, aux[::-1])
        return (logits, hidden) if capture else logits

    @property
    def encoder_channels(self) -> List[int]:
        return list(self.features)


def build_unet3d(config, dtype: torch.dtype = torch.float32) -> UNet3D:
    """Factory from config (the JAX package's ``build_unet3d``)."""
    backbone = config.get("model.backbone", {}) or {}
    refuse_tensor_parallel(config)
    return UNet3D(
        in_channels=len(config.get("data.modalities", ["CT", "PET"])),
        out_channels=int(config.get("model.out_channels", 8)),
        features=tuple(backbone.get("features", [32, 64, 128, 256, 512])),
        norm=str(backbone.get("norm", "instance")),
        dropout=float(config.get("model.head.dropout", 0.0) or 0.0),
        dtype=dtype,
        deep_supervision=deep_supervision(config),
    )
