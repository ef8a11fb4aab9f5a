"""Shared conv building blocks (port of the JAX package's ``models/layers.py``).

Inputs are channels-first ``[B, C, H, W, D]`` views, in any memory format
(the models hand over channels-last memory, ``channels_last_3d``):

- ``Norm3D``: instance, group(8), batch (flax's running statistics) or none;
- ``ConvBlock3D``: (3³ conv, pad 1 → norm → activation) × 2;
- ``DownBlock3D``: 2³ max pool → ``ConvBlock3D``;
- ``UpBlock3D``: 2× transposed conv (or linear 2× upsample + 1×1 conv),
  linear resize when the grid does not match the skip's, skip concat,
  ``ConvBlock3D``;
- ``Dropout3D``, ``Dropout``: channel and element dropout.

On a batch split over ranks (data parallelism, ``parallel/mesh.py``) batch
norm takes the global batch's statistics and dropout the global batch's
mask, so each rank computes its rows of the one-process result. Under tensor
parallelism (``parallel/tensor_parallel.py``) a ``ConvBlock3D`` that the
model lists as a target splits its first conv's output channels (and the
norm between the convs) over the model ranks and sums the second conv's
partial products over them.

Flax keeps f32 parameters and casts them to the module's compute dtype at
each op. ``Linear``, ``Conv3d``, ``ConvTranspose3d`` and ``LayerNorm`` here do
the same: each casts its parameters to the input's dtype in ``forward``. With
f32 master weights (training) a bf16 input computes in bf16 and the gradient
flows back to the f32 parameter through the cast; with weights already stored
in the compute dtype (serving) the cast is a no-op.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear
from multimodal_organ_segmentation_tpu_torch.parallel.mesh import (
    active_rows,
    all_reduce_sum,
    dropout_rows,
)
from multimodal_organ_segmentation_tpu_torch.parallel.tensor_parallel import (
    Split,
    channels_rule,
    copy_in,
    reduce_out,
)

NORMS = ("instance", "group", "batch", "none")
EPS = 1e-5
BATCH_MOMENTUM = 0.99  # flax BatchNorm: r <- 0.99 r + 0.01 batch


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


def cf(x: torch.Tensor) -> torch.Tensor:
    """channels-last ``[B, H, W, D, C]`` → channels-first view."""
    return x.permute(0, 4, 1, 2, 3)


def cl(x: torch.Tensor) -> torch.Tensor:
    """channels-first ``[B, C, H, W, D]`` → channels-last view."""
    return x.permute(0, 2, 3, 4, 1)


def perturb_at(points: Optional[dict], name: str, x: torch.Tensor,
               channels_first: bool = False) -> torch.Tensor:
    """flax's ``perturb`` in eager PyTorch: record the live activation ``x``
    under ``name`` in ``points`` (channels-last) and return the tensor the
    rest of the forward goes on with, so that ``torch.autograd.grad`` of a
    score with respect to ``points[name]`` is the gradient flax reads from
    its zero perturbation. A channels-first ``x`` is recorded as its
    channels-last view and the forward goes on through that view (views, no
    copy), so the recorded tensor lies on every path to the output."""
    if points is None:
        return x
    p = cl(x) if channels_first else x
    points[name] = p
    return cf(p) if channels_first else p


def conv_cl(conv: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Apply a channels-first conv (or norm, or dropout) to a channels-last
    volume (views, no copy)."""
    return cl(conv(cf(x)))


def logits_out(out_conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 1×1 head in f32 on channels-first features → channels-last logits."""
    return cl(out_conv(x.float()))


def supervised_outputs(logits: torch.Tensor, aux: List[torch.Tensor]) -> List[torch.Tensor]:
    """``[logits] + aux`` with each aux head's channels-last logits linearly
    resized to the logits' grid (``aux`` in the order the loss weights
    them: finest first)."""
    full = tuple(logits.shape[1:4])
    return [logits] + [resize_linear(a, full, (1, 2, 3)) for a in aux]


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
    - ``group``: 8 groups with scale and bias, eps 1e-5 (a rank's share of
      them under tensor parallelism: ``groups``);
    - ``batch``: flax's ``BatchNorm``: in training the batch's statistics in
      f32 (the biased variance, as E[x²] − E[x]²) normalise, and the f32
      running buffers move as ``r ← 0.99·r + 0.01·batch``; in eval the
      running statistics normalise. eps 1e-5;
    - ``none``: identity.
    """

    def __init__(self, norm: str, channels: int):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown norm {norm!r}; choose from {NORMS}")
        self.norm = norm
        self.groups = 8
        if norm in ("group", "batch"):
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        if norm == "batch":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm == "instance":
            return instance_norm(x)
        if self.norm == "group":
            return torch.group_norm(x, self.groups, _as(self.weight, x), _as(self.bias, x), EPS)
        if self.norm == "batch":
            return self._batch_norm(x)
        return x

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            split = active_rows()
            if split is None:
                mean = xf.mean(dims)
                var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            else:
                # a batch split over ranks: the global batch's statistics,
                # as flax's BatchNorm takes them under GSPMD
                count = xf.numel() // xf.shape[1] * split[2] // split[1]
                sums = all_reduce_sum(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]), split[3])
                mean = sums[0] / count
                var = (sums[1] / count - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(BATCH_MOMENTUM).add_(mean.detach(), alpha=1 - BATCH_MOMENTUM)
                self.running_var.mul_(BATCH_MOMENTUM).add_(var.detach(), alpha=1 - BATCH_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + EPS) * self.weight.float()
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.float().reshape(shape)
        return y.to(x.dtype)


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """relu (also for an unknown name, as the JAX package), leaky relu with
    slope 0.2, or flax's ``gelu`` (the tanh approximation)."""
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.2)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    return F.relu


def conv_pair_splits(norm: str) -> dict:
    """The split tensors of a conv → norm → act → conv pair: the first conv's
    output channels (with the norm's parameters and running statistics),
    the second conv's input channels. The second conv's bias is added once,
    after the sum over the model ranks."""
    params = {"conv1.weight": Split(0), "conv1.bias": Split(0), "conv2.weight": Split(1)}
    if norm in ("group", "batch"):
        params.update({"norm1.weight": Split(0), "norm1.bias": Split(0)})
    if norm == "batch":
        params.update({"norm1.running_mean": Split(0), "norm1.running_var": Split(0)})
    return params


def row_conv(conv: nn.Conv3d, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel conv: the partial products of the rank's input
    channels, summed over the model group, then the bias."""
    y = reduce_out(conv._conv_forward(x, _as(conv.weight, x), None), tp)
    return y + _as(conv.bias, y).reshape(1, -1, 1, 1, 1)


class ConvPairSplit:
    """The tensor-parallel rule of a block whose ``conv1`` → ``norm1`` → act →
    ``conv2`` splits by ``conv1``'s output channels (``conv_pair_splits``);
    ``tp`` is the model group once ``parallelize`` applied the plan."""

    tp = None

    def tp_rule(self, path: str, m: int) -> list:
        return [channels_rule(path, self.conv1.out_channels, self.norm1.norm, m,
                              conv_pair_splits(self.norm1.norm))]

    def tp_apply(self, tp, plan) -> None:
        self.tp = tp
        self.norm1.groups = plan.local.get("groups", self.norm1.groups)


class ConvBlock3D(ConvPairSplit, nn.Module):
    """(conv k³, SAME → norm → act) × 2. Under tensor parallelism
    (``tp_apply``) conv1 and norm1 hold the rank's output channels and conv2
    its input channels; norm2 and the output are whole on every rank."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 norm: str = "instance", activation: str = "relu"):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"ConvBlock3D: SAME padding needs an odd kernel, got {kernel_size}")
        pad = kernel_size // 2
        self.act = activation_fn(activation)
        self.conv1 = Conv3d(in_channels, features, kernel_size, padding=pad)
        self.norm1 = Norm3D(norm, features)
        self.conv2 = Conv3d(features, features, kernel_size, padding=pad)
        self.norm2 = Norm3D(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.act(self.norm1(self.conv1(copy_in(x, self.tp))))
            return self.act(self.norm2(row_conv(self.conv2, x, self.tp)))
        x = self.act(self.norm1(self.conv1(x)))
        return self.act(self.norm2(self.conv2(x)))


def max_pool_3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """``window``³ max pool with stride ``window`` (VALID: a trailing odd
    voxel is dropped, as flax's ``max_pool``)."""
    return F.max_pool3d(x, window, window)


class DownBlock3D(nn.Module):
    """maxpool(2) → ConvBlock3D; returns (conv output, pooled input)."""

    def __init__(self, in_channels: int, features: int, norm: str = "instance"):
        super().__init__()
        self.block = ConvBlock3D(in_channels, features, norm=norm)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        pooled = max_pool_3d(x)
        return self.block(pooled), pooled


class UpBlock3D(nn.Module):
    """Upsample ×2 → (resize-on-mismatch) → concat skip → ConvBlock3D.

    ``mode="transpose"``: a 2³ stride-2 transposed conv to ``up_features``;
    ``"linear"``: a linear 2× resize, then a 1×1 conv to ``up_features``.
    """

    def __init__(self, in_channels: int, skip_channels: int, features: int, up_features: int,
                 norm: str = "instance", mode: str = "transpose"):
        super().__init__()
        if mode not in ("transpose", "linear"):
            raise ValueError(f"UpBlock3D: unknown mode {mode!r}")
        self.mode = mode
        if mode == "transpose":
            self.transp_conv = ConvTranspose3d(in_channels, up_features, 2, stride=2)
        else:
            self.up_conv = Conv3d(in_channels, up_features, 1)
        self.block = ConvBlock3D(up_features + skip_channels, features, norm=norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.mode == "transpose":
            x = self.transp_conv(x)
        else:
            x = self.up_conv(resize_linear(x, tuple(2 * s for s in x.shape[2:]), (2, 3, 4)))
        if x.shape[2:] != skip.shape[2:]:
            x = resize_linear(x, tuple(skip.shape[2:]), (2, 3, 4))
        return self.block(torch.cat([x, skip], dim=1))


class Dropout3D(nn.Dropout3d):
    """Channel dropout like the JAX package's ``Dropout3D``: in training each
    (sample, channel) is dropped whole at rate ``p`` and the rest scaled by
    1/(1−p), on a channels-first ``[B, C, H, W, D]`` view. Its draws come
    from torch's generator, which the train step seeds from its key."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p <= 0.0 or not self.training:
            return x
        split = dropout_rows(x, self.p, channel=True)
        return super().forward(x) if split is None else split


class Dropout(nn.Dropout):
    """Element dropout; on a batch split over ranks (``parallel.mesh.rows``)
    each rank keeps its rows of the mask the whole batch draws. On an
    activation split over the model ranks (``tp_slice = (dim, m, rank)``,
    set by a tensor-parallel layer) it keeps its slice of the mask the whole
    activation draws."""

    tp_slice = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.p <= 0.0 or not self.training:
            return x
        if self.tp_slice is not None:
            dim, m, r = self.tp_slice
            shape = list(x.shape)
            n = shape[dim]
            shape[dim] = n * m
            ones = torch.ones(shape, dtype=x.dtype, device=x.device)
            noise = dropout_rows(ones, self.p, channel=False)
            if noise is None:
                noise = F.dropout(ones, self.p, True)
            return x * noise.narrow(dim, r * n, n)
        split = dropout_rows(x, self.p, channel=False)
        return super().forward(x) if split is None else split
