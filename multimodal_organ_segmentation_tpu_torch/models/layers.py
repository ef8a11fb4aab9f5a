"""Shared layers: the normalisation dispatcher (port of the JAX package's
``models/layers.py`` ``Norm3D``; inputs are channels-first ``[B, C, H, W, D]``
in any memory format) and the parameter-casting layers. The rest of
``layers.py`` comes with the UNet3D port.

Flax keeps f32 parameters and casts them to the module's compute dtype at
each op. ``Linear``, ``Conv3d``, ``ConvTranspose3d`` and ``LayerNorm`` here do
the same: each casts its parameters to the input's dtype in ``forward``. With
f32 master weights (training) a bf16 input computes in bf16 and the gradient
flows back to the f32 parameter through the cast; with weights already stored
in the compute dtype (serving) the cast is a no-op.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

NORMS = ("instance", "group", "batch", "none")
EPS = 1e-5


def _as(p: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    return None if p is None else p.to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _as(self.weight, x), _as(self.bias, x))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, _as(self.weight, x), _as(self.bias, x),
                            self.eps)


class Conv3d(nn.Conv3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _as(self.weight, x), _as(self.bias, x))


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(x, _as(self.weight, x), _as(self.bias, x), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Affine-free instance norm of a channels-first volume, eps 1e-5.

    Calls ``torch.group_norm`` directly: ``F.group_norm`` refuses a volume
    of one voxel per channel (the /32 bottleneck of a 32³ tile), where the
    norm is exactly 0, as flax's ``GroupNorm`` gives it.
    """
    return torch.group_norm(x, x.shape[1], None, None, EPS)


class Norm3D(nn.Module):
    """Normalization dispatcher matching the reference vocabulary.

    - ``instance``: torch InstanceNorm3d defaults — affine-free, eps 1e-5
      (flax ``GroupNorm(group_size=1)`` in the JAX package);
    - ``group``: 8 groups with scale and bias, eps 1e-5;
    - ``batch``: running statistics with flax's momentum 0.99 (torch 0.01);
    - ``none``: identity.
    """

    def __init__(self, norm: str, channels: int):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown norm {norm!r}; choose from {NORMS}")
        self.norm = norm
        if norm == "group":
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        elif norm == "batch":
            self.bn = nn.BatchNorm3d(channels, eps=EPS, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm == "instance":
            return instance_norm(x)
        if self.norm == "group":
            return torch.group_norm(x, 8, _as(self.weight, x), _as(self.bias, x), EPS)
        if self.norm == "batch":
            return self.bn(x)
        return x
