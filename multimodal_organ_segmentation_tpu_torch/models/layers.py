"""Shared normalisation layer (port of the JAX package's ``models/layers.py``
``Norm3D``). Inputs are channels-first ``[B, C, H, W, D]`` (any memory
format). The rest of ``layers.py`` comes with the UNet3D port.
"""

from __future__ import annotations

import torch
from torch import nn

NORMS = ("instance", "group", "batch", "none")
EPS = 1e-5


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
            return torch.group_norm(x, 8, self.weight, self.bias, EPS)
        if self.norm == "batch":
            return self.bn(x)
        return x
