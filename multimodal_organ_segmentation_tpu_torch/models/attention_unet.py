"""Attention U-Net: UNet3D with attention-gated skip connections (port of
the JAX package's ``models/attention_unet.py``).

Additive attention gates (Oktay et al., "Attention U-Net") modulate each
skip connection with a gating signal from the coarser decoder level before
concatenation. Public layout and precision as ``UNet3D``: channels-last
input, f32 channels-last logits, channels-first views inside.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_organ_segmentation_tpu_torch.models.layers import (
    Conv3d,
    ConvBlock3D,
    ConvTranspose3d,
    DownBlock3D,
    Dropout3D,
    cf,
    cl,
    logits_out,
    perturb_at,
)
from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear


class AttentionGate(nn.Module):
    """α = σ(ψ(relu(θ·x + φ·g))), out = x·α, on channels-first views.

    ``theta`` is flax's 2³ stride-2 conv with ``padding="SAME"``: on an odd
    axis it gives ceil(n/2) outputs, padding one zero at the end, where a
    torch conv without padding would give floor(n/2). The pad is explicit.
    """

    def __init__(self, x_channels: int, g_channels: int, inter_channels: int):
        super().__init__()
        self.theta = Conv3d(x_channels, inter_channels, 2, stride=2, bias=False)
        self.phi = Conv3d(g_channels, inter_channels, 1)
        self.psi = Conv3d(inter_channels, 1, 1)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        h, w, d = x.shape[2:]
        theta_x = self.theta(F.pad(x, (0, d % 2, 0, w % 2, 0, h % 2)))
        phi_g = self.phi(g)
        if phi_g.shape[2:] != theta_x.shape[2:]:
            phi_g = resize_linear(phi_g, tuple(theta_x.shape[2:]), (2, 3, 4))
        alpha = torch.sigmoid(self.psi(F.relu(theta_x + phi_g)))
        return x * resize_linear(alpha, (h, w, d), (2, 3, 4))


class AttentionUNet3D(nn.Module):
    """3D UNet with attention-gated skips: ``init_conv``, ``down{i}``, then
    per decoder level ``gate{j}`` (skip gated by the coarser features),
    ``up{j}_tconv`` (2× transposed conv), ``up{j}_conv`` (``ConvBlock3D`` on
    the concat), dropout, ``out_conv`` in f32. ``forward``'s ``perturb`` takes
    the perturbation points ``feat{i}`` (each encoder level's output)."""

    def __init__(self, in_channels: int = 2, out_channels: int = 8,
                 features: Sequence[int] = (32, 64, 128, 256, 512), norm: str = "instance",
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        feats = [int(f) for f in features]
        self.features = tuple(feats)
        self.dtype = dtype
        self.init_conv = ConvBlock3D(in_channels, feats[0], norm=norm)
        for i in range(len(feats) - 1):
            self.add_module(f"down{i}", DownBlock3D(feats[i], feats[i + 1], norm))
        for j, i in enumerate(range(len(feats) - 1, 0, -1)):
            self.add_module(f"gate{j}", AttentionGate(feats[i - 1], feats[i], max(feats[i - 1] // 2, 1)))
            self.add_module(f"up{j}_tconv", ConvTranspose3d(feats[i], feats[i] // 2, 2, stride=2))
            self.add_module(f"up{j}_conv", ConvBlock3D(feats[i] // 2 + feats[i - 1], feats[i - 1],
                                                       norm=norm))
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
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, List[torch.Tensor]]]:
        """Logits, or with ``capture`` ``(logits, hidden)``, ``hidden`` the
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
        for j, i in enumerate(range(levels - 1, 0, -1)):
            gated = getattr(self, f"gate{j}")(skips[i - 1], x)
            x = getattr(self, f"up{j}_tconv")(x)
            if x.shape[2:] != gated.shape[2:]:
                x = resize_linear(x, tuple(gated.shape[2:]), (2, 3, 4))
            x = getattr(self, f"up{j}_conv")(torch.cat([x, gated], dim=1))
        logits = logits_out(self.out_conv, self.dropout(x))
        return (logits, hidden) if capture else logits

    @property
    def encoder_channels(self) -> List[int]:
        return list(self.features)


def build_attention_unet(config, dtype: torch.dtype = torch.float32) -> AttentionUNet3D:
    """Factory from config (the JAX package's ``build_attention_unet``)."""
    backbone = config.get("model.backbone", {}) or {}
    return AttentionUNet3D(
        in_channels=len(config.get("data.modalities", ["CT", "PET"])),
        out_channels=int(config.get("model.out_channels", 8)),
        features=tuple(backbone.get("features", [32, 64, 128, 256, 512])),
        norm=str(backbone.get("norm", "instance")),
        dropout=float(config.get("model.head.dropout", 0.0) or 0.0),
        dtype=dtype,
    )
