"""SwinUNETR: 3D Swin-transformer encoder + UNETR conv decoder, with the
PET/CT cross-attention fusion pyramid.

Port of the JAX package's ``models/swin_unetr.py`` (native wiring). The
public layout is channels-last: input ``[B, H, W, D, C_in]``, logits
``[B, H, W, D, out_channels]``; the Swin stages work channels-last too. The
decoder's convolutions take channels-first views of the same memory
(``permute`` to ``[B, C, H, W, D]``, the ``channels_last_3d`` format), so no
layout copy is made around a convolution.

Window attention goes through the custom op of kernel A
(``ops.window_attention.window_mha``) and the fusion attention through that of
kernel B: the kernels on a CUDA tensor, their plain versions on a CPU
tensor. With ``use_kernel`` False on a module (``set_use_kernels``), and for
bf16 on the CPU (``ops.attention.takes_custom_op``), the module's own plain
path runs.

Differences from the flax module, all forced by eager PyTorch:

- parameter shapes are fixed at construction, so the relative-position
  tables are sized from ``img_size`` (the tile size): the JAX package sizes
  them from the first input, clamping each stage's window to its grid;
- ``scan_blocks`` (one ``lax.scan`` body per stage) is the same math as
  unrolled blocks, so both build unrolled blocks here; ``convert`` unstacks
  a stacked JAX tree;
- tensor parallelism (``parallel.mesh.model`` > 1 in a job of several
  ranks) is written out over the model group (``parallel/tensor_parallel.py``)
  where the JAX package leaves it to GSPMD: window attention by heads (kernel
  A on the rank's heads and their rows of the relative-position bias), each
  block's MLP by hidden units, the cross-attention fusion by heads (kernel
  B), and the UNETR decoder's residual blocks fed by the activations JAX
  constrains (decoders 5 to 2) by channels (``tp_targets``);
- the explainability hooks are arguments of ``forward`` rather than flax
  collections: ``capture`` returns the pyramid taps, ``perturb`` (a dict) takes
  the live activations at the points ``stage0..stage4`` that flax's ``perturb`` names, so that
  ``torch.autograd.grad`` gives the gradients flax reads from its zero
  perturbations; ``intermediates`` (a dict) takes every window attention's
  probabilities under the path flax sows them at. No parameter or buffer is
  added, so the state dict is the same with or without them.

``monai_compat`` reproduces MONAI's SwinUNETR graph, as the JAX model's flag
does, for reference-checkpoint interchange (``models/torch_import.py``,
``models/torch_export.py``): feature taps after each patch merge plus the raw
patch embedding, a parameter-free layer norm on every tap, no residual block
on the /16 skip, MONAI's v1 patch-merging order, and relative-position tables
sized by the constructor window with the index sliced ``[:n, :n]`` where a
grid clamps the window. Its blocks still run kernel A, which takes the
gathered ``[H, N, N]`` bias as it is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_organ_segmentation_tpu_torch.models.fusion import CrossAttentionFusion
from multimodal_organ_segmentation_tpu_torch.models.layers import (
    Conv3d,
    ConvPairSplit,
    ConvTranspose3d,
    Dropout,
    LayerNorm,
    Linear,
    Norm3D,
    _as,
    cf,
    conv_cl,
    logits_out,
    perturb_at,
    row_conv,
    supervised_outputs,
)
from multimodal_organ_segmentation_tpu_torch.parallel.tensor_parallel import (
    Split,
    copy_in,
    heads_rule,
    hidden_rule,
    reduce_out,
)
from multimodal_organ_segmentation_tpu_torch.utils.config import deep_supervision
from multimodal_organ_segmentation_tpu_torch.ops.attention import takes_custom_op
from multimodal_organ_segmentation_tpu_torch.ops.window_attention import window_mha

Window = Tuple[int, int, int]
LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


# ---------------------------------------------------------------------------
# window utilities
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, window: Window) -> torch.Tensor:
    """[B, H, W, D, C] → [B·nW, wh·ww·wd, C], batch-major, windows fastest;
    H/W/D must divide window."""
    b, h, w, d, c = x.shape
    wh, ww, wd = window
    x = x.reshape(b, h // wh, wh, w // ww, ww, d // wd, wd, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wh * ww * wd, c)


def window_unpartition(windows: torch.Tensor, window: Window, dims: Tuple[int, int, int, int]) -> torch.Tensor:
    """Inverse of window_partition."""
    b, h, w, d = dims
    wh, ww, wd = window
    c = windows.shape[-1]
    x = windows.reshape(b, h // wh, w // ww, d // wd, wh, ww, wd, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, h, w, d, c)


def _relative_position_index(window: Window) -> np.ndarray:
    """Static [N, N] index into the (2wh-1)(2ww-1)(2wd-1) bias table."""
    wh, ww, wd = window
    coords = np.stack(
        np.meshgrid(np.arange(wh), np.arange(ww), np.arange(wd), indexing="ij")
    )  # [3, wh, ww, wd]
    flat = coords.reshape(3, -1)  # [3, N]
    rel = flat[:, :, None] - flat[:, None, :]  # [3, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 2] += wd - 1
    rel[:, :, 0] *= (2 * ww - 1) * (2 * wd - 1)
    rel[:, :, 1] *= 2 * wd - 1
    return rel.sum(-1)  # [N, N]


def _shift_attention_mask(dims: Tuple[int, int, int], window: Window, shift: Window,
                          device=None) -> torch.Tensor:
    """Additive f32 [nW, N, N] mask (0 / -1e9) forbidding attention across
    rolled borders; windows in ``window_partition`` order."""

    def axis_ids(size: int, win: int, s: int) -> torch.Tensor:
        pos = torch.arange(size, device=device)
        if s == 0:
            return torch.zeros((size,), dtype=torch.int64, device=device)
        return (pos >= size - win).long() + (pos >= size - s).long()

    h, w, d = dims
    wh, ww, wd = window
    ids = (
        axis_ids(h, wh, shift[0])[:, None, None] * 9
        + axis_ids(w, ww, shift[1])[None, :, None] * 3
        + axis_ids(d, wd, shift[2])[None, None, :]
    )  # [H, W, D]
    ids = window_partition(ids[None, ..., None], window)[..., 0]  # [nW, N]
    diff = ids[:, None, :] - ids[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(diff != 0, torch.full_like(zero, -1e9), zero)


def _clamped_window(window: Sequence[int], grid: Sequence[int]) -> Window:
    return tuple(min(w, g) for w, g in zip(window, grid))


def _shift_for(window: Window, grid: Sequence[int]) -> Window:
    """Swin rule: half-window shift, none along an axis the window covers."""
    return tuple(w // 2 if w < g else 0 for w, g in zip(window, grid))


# ---------------------------------------------------------------------------
# transformer pieces
# ---------------------------------------------------------------------------

class WindowAttention(nn.Module):
    """Multi-head self attention within windows + relative position bias.

    With ``attn_drop == 0``, ``use_kernel`` True and a tensor that
    ``takes_custom_op``, the custom op ``window_mha`` computes
    softmax(q·kᵀ + bias + mask)·v, in training as in serving (it is
    differentiable). Otherwise the module's dense path runs, with the JAX
    package's precision rule: f32 inputs stay f32 throughout; for bf16, the
    scores, bias, mask and softmax are bf16 and the matmuls accumulate in f32.

    ``sow``, a list, takes the probabilities ``[B·nW, heads, N, N]`` (the
    model dtype) of this call. The kernel never writes them out, so a call
    given one takes the dense path, as the flax module does when its
    ``intermediates`` collection is mutable.

    Under tensor parallelism (``tp_apply``) ``num_heads`` is the rank's share:
    ``qkv`` holds its heads' rows of q, k and v, ``rel_pos_bias`` their
    columns, and ``proj`` their input features, whose partial products are
    summed over the model group before the bias.
    """

    tp = None

    def __init__(self, dim: int, num_heads: int, window: Window, attn_drop: float = 0.0,
                 table_window: Optional[Window] = None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window = tuple(window)
        self.attn_drop = attn_drop
        self.use_kernel = True
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        # MONAI sizes the table by the constructor window and slices its
        # index [:n, :n] where the grid clamps the window (``table_window``);
        # the native model uses the clamped window's own table
        wh, ww, wd = table_window = tuple(table_window or self.window)
        table = (2 * wh - 1) * (2 * ww - 1) * (2 * wd - 1)
        self.rel_pos_bias = nn.Parameter(torch.zeros(table, num_heads))
        self.register_buffer(
            "rel_index", torch.from_numpy(_relative_position_index(table_window)), persistent=False
        )
        self.dropout = Dropout(attn_drop)

    def tp_rule(self, path: str, m: int) -> list:
        return [heads_rule(path, self.num_heads * (self.tp.size if self.tp else 1), m, {
            "qkv.weight": Split(0, 3), "qkv.bias": Split(0, 3), "rel_pos_bias": Split(1),
            "proj.weight": Split(1)})]

    def tp_apply(self, tp, plan) -> None:
        self.tp, self.num_heads = tp, plan.local["num_heads"]

    def _proj(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        out = out.reshape(out.shape[0], out.shape[1], -1).to(x.dtype)
        if self.tp is None:
            return self.proj(out)
        y = reduce_out(F.linear(out, _as(self.proj.weight, out)), self.tp)
        return y + _as(self.proj.bias, y)

    def bias(self, n: int) -> torch.Tensor:
        """The f32 ``[heads, N, N]`` relative-position bias."""
        idx = self.rel_index[:n, :n].reshape(-1)
        return self.rel_pos_bias[idx].reshape(n, n, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                sow: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        b_, n, c = x.shape
        head_dim = self.dim // (self.num_heads * (self.tp.size if self.tp else 1))
        if self.tp is not None:
            x = copy_in(x, self.tp)
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, head_dim)
        q, k, v = qkv.unbind(2)
        bias = self.bias(n)

        # attention dropout acts on the probabilities, which the kernel never
        # writes out: a module built with it takes the dense path
        if self.use_kernel and self.attn_drop == 0.0 and sow is None and takes_custom_op(x):
            nw = mask.shape[0] if mask is not None else 1
            out = window_mha(q, k, v, bias, mask, nw)
            return self._proj(out, x)

        # for bf16 the scores come from an f32 product scaled in f32, and
        # bias, mask and softmax stay in the model dtype, as in the JAX package
        attn = (torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * head_dim**-0.5).to(x.dtype)
        bias = bias.to(x.dtype)
        if mask is not None:
            mask = mask.to(x.dtype)
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, self.num_heads, n, n) + mask[None, :, None]
            attn = attn.reshape(b_, self.num_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        if sow is not None:
            sow.append(attn)
        attn = self.dropout(attn)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self._proj(out, x)


class SwinBlock(nn.Module):
    """LN → (S)W-MSA → +res → LN → MLP(4×, exact GELU) → +res.

    ``window`` is the configured window and ``grid`` the spatial size this
    block sees: the window clamps to the grid (and the bias table with it,
    unless ``monai_table`` keeps MONAI's table of the configured window),
    and a window that covers an axis does not shift along it. Under tensor
    parallelism the MLP splits by hidden units (``tp_apply``): ``mlp_fc1``
    holds the rank's rows, ``mlp_fc2`` their columns.
    """

    tp = None

    def __init__(self, dim: int, num_heads: int, window: Window, grid: Window,
                 shift: bool = False, mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, monai_table: bool = False):
        super().__init__()
        self.window = _clamped_window(window, grid)
        self.grid = tuple(grid)
        self.shift = _shift_for(self.window, grid) if shift else (0, 0, 0)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, self.window, attn_drop,
                                    table_window=tuple(window) if monai_table else None)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim)
        self.drop = Dropout(drop)
        # the shift mask of the padded grid, fixed at construction: a buffer
        # that moves with the model and that an exported program holds
        padded = tuple(g + (-g) % w for g, w in zip(self.grid, self.window))
        self.register_buffer(
            "attn_mask",
            _shift_attention_mask(padded, self.window, self.shift) if any(self.shift) else None,
            persistent=False,
        )

    def tp_rule(self, path: str, m: int) -> list:
        # a layer keeps its constructor's sizes when its weights are sliced
        hidden = self.mlp_fc1.out_features
        return self.attn.tp_rule(f"{path}.attn", m) + [hidden_rule(path, hidden, m, {
            "mlp_fc1.weight": Split(0), "mlp_fc1.bias": Split(0), "mlp_fc2.weight": Split(1)})]

    def tp_apply(self, tp, plan) -> None:
        self.tp = tp
        self.drop.tp_slice = (-1, tp.size, tp.rank)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.mlp_fc2(self.drop(F.gelu(self.mlp_fc1(x))))
        z = self.drop(F.gelu(self.mlp_fc1(copy_in(x, self.tp))))
        z = reduce_out(F.linear(z, _as(self.mlp_fc2.weight, z)), self.tp)
        return z + _as(self.mlp_fc2.bias, z)

    def forward(self, x: torch.Tensor, sow: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        b, h, w, d, c = x.shape
        if (h, w, d) != self.grid:
            raise ValueError(f"SwinBlock built for a {self.grid} grid got {(h, w, d)}")
        wh, ww, wd = self.window
        shortcut = x
        y = self.norm1(x)

        ph, pw, pd = (-h) % wh, (-w) % ww, (-d) % wd
        if ph or pw or pd:
            y = F.pad(y, (0, 0, 0, pd, 0, pw, 0, ph))
        hp, wp, dp = h + ph, w + pw, d + pd

        mask = None
        if any(self.shift):
            y = torch.roll(y, tuple(-s for s in self.shift), dims=(1, 2, 3))
            mask = self.attn_mask

        attended = self.attn(window_partition(y, self.window), mask, sow)
        y = window_unpartition(attended, self.window, (b, hp, wp, dp))

        if any(self.shift):
            y = torch.roll(y, self.shift, dims=(1, 2, 3))
        if ph or pw or pd:
            y = y[:, :h, :w, :d, :]

        x = shortcut + y
        return x + self._mlp(self.norm2(x))


# MONAI's v1 ``PatchMerging`` ("merging", SwinUNETR's default downsample)
# samples these 8 (i, j, k) parity triples — (0,1,0) and (0,0,1) twice each,
# (0,1,1) and (1,1,0) never — as indices into the product-ordered
# (i·4 + j·2 + k) space-to-depth blocks.
MONAI_V1_MERGE_ORDER = (0, 4, 2, 1, 5, 2, 1, 7)


class PatchMerging(nn.Module):
    """Space-to-depth 2³ → LayerNorm → Linear(8C → 2C). ``order="product"``
    concatenates the 8 parities in lexicographic order; ``"monai_v1"`` takes
    MONAI's v1 slice list (duplicates included: they enter the LayerNorm
    statistics)."""

    def __init__(self, dim: int, order: str = "product"):
        super().__init__()
        if order not in ("product", "monai_v1"):
            raise ValueError(f"unknown patch-merging order {order!r}")
        self.order = order
        self.norm = LayerNorm(8 * dim, eps=LN_EPS)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d, c = x.shape
        ph, pw, pd = h % 2, w % 2, d % 2
        if ph or pw or pd:
            x = F.pad(x, (0, 0, 0, pd, 0, pw, 0, ph))
            h, w, d = h + ph, w + pw, d + pd
        x = x.reshape(b, h // 2, 2, w // 2, 2, d // 2, 2, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, h // 2, w // 2, d // 2, 8, c)
        if self.order == "monai_v1":
            x = x[..., list(MONAI_V1_MERGE_ORDER), :]
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, d // 2, 8 * c)))


def param_free_layer_norm(x: torch.Tensor) -> torch.Tensor:
    """``F.layer_norm(x, [C])`` in f32 with no scale or bias (MONAI's
    ``swinViT.proj_out`` with ``normalize=True``), back in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-5).to(x.dtype)


class UnetrResBlock(ConvPairSplit, nn.Module):
    """conv-norm-act ×2 + 1×1 shortcut (UNETR basic residual block), on
    channels-first ``[B, C, H, W, D]``. Under tensor parallelism conv1 and
    norm1 hold the rank's output channels and conv2 its input channels;
    norm2 and the shortcut are whole on every rank."""

    def __init__(self, in_channels: int, features: int, norm: str = "instance"):
        super().__init__()
        self.conv1 = Conv3d(in_channels, features, 3, padding=1)
        self.norm1 = Norm3D(norm, features)
        self.conv2 = Conv3d(features, features, 3, padding=1)
        self.norm2 = Norm3D(norm, features)
        self.conv3 = self.norm3 = None
        if in_channels != features:
            self.conv3 = Conv3d(in_channels, features, 1)
            self.norm3 = Norm3D(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            y = F.leaky_relu(self.norm1(self.conv1(copy_in(x, self.tp))), 0.01)
            y = self.norm2(row_conv(self.conv2, y, self.tp))
        else:
            y = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
            y = self.norm2(self.conv2(y))
        residual = x if self.conv3 is None else self.norm3(self.conv3(x))
        return F.leaky_relu(y + residual, 0.01)


class UnetrUpBlock(nn.Module):
    """transpose-conv ×2 → concat skip → residual block (channels-first)."""

    def __init__(self, in_channels: int, features: int, norm: str = "instance"):
        super().__init__()
        self.transp_conv = ConvTranspose3d(in_channels, features, 2, stride=2)
        self.res = UnetrResBlock(2 * features, features, norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.res(torch.cat([self.transp_conv(x), skip], dim=1))


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _divisor_heads(channels: int, target_head_dim: int) -> int:
    """Largest head count ≤ channels/target_head_dim that divides channels
    (≥1). Keeps head_dim ≥ ~target while honoring the divisibility rule."""
    h = max(1, channels // target_head_dim)
    while channels % h:
        h -= 1
    return h


class SwinUNETR(nn.Module):
    """3D Swin encoder + UNETR decoder, native wiring.

    Input ``[B, *img_size, in_channels]`` (each side divisible by 32) →
    logits ``[B, *img_size, out_channels]`` in f32. With
    ``modality_fusion="cross_attention"`` (and at least 2 input channels)
    channels ``[1:]`` feed a strided-conv pyramid whose features the Swin
    tokens cross-attend to after the patch merges listed in
    ``fusion_stages``. ``use_remat`` (``parallel.remat``) recomputes each Swin
    block in the backward pass instead of keeping its activations, in
    training mode only. ``dtype`` is the compute dtype: parameters may stay
    f32 (training) and are cast per op. ``monai_compat`` builds MONAI's
    wiring (module docstring): no ``encoder4``, and neither fusion nor deep
    supervision, which MONAI's graph has no slots for. ``forward``'s
    ``perturb`` takes the perturbation points ``stage0..stage4`` (each
    stage's output before its merge, and the bottleneck).
    """

    def __init__(
        self,
        in_channels: int = 2,
        out_channels: int = 8,
        img_size: Sequence[int] = (96, 96, 96),
        feature_size: int = 48,
        depths: Sequence[int] = (2, 2, 2, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: Sequence[int] = (7, 7, 7),
        norm: str = "instance",
        drop_rate: float = 0.0,
        attn_drop_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        modality_fusion: Optional[str] = None,
        fusion_stages: Sequence[int] = (0, 1, 2, 3),
        use_remat: bool = False,
        deep_supervision: bool = False,
        monai_compat: bool = False,
    ):
        super().__init__()
        if any(s % 32 for s in img_size):
            raise ValueError(f"img_size {tuple(img_size)} must be divisible by 32")
        if monai_compat and (modality_fusion == "cross_attention" or deep_supervision):
            raise ValueError("monai_compat reproduces MONAI's graph: no modality fusion and no "
                             "deep supervision")
        self.monai_compat = monai_compat
        fs = feature_size
        self.in_channels = in_channels
        self.img_size = tuple(int(s) for s in img_size)
        self.feature_size = fs
        self.dtype = dtype
        self.use_remat = use_remat
        self.window_size = tuple(int(w) for w in window_size)
        self.fusion_stages = tuple(fusion_stages)
        self.xfuse = modality_fusion == "cross_attention" and in_channels >= 2
        dims = [fs, fs * 2, fs * 4, fs * 8]

        self.patch_embed = Conv3d(in_channels, fs, 2, stride=2)
        if self.xfuse:
            self.aux_embed = Conv3d(in_channels - 1, fs, 2, stride=2)
        grid = tuple(s // 2 for s in self.img_size)
        aux_ch = fs
        for stage in range(4):
            for bi in range(depths[stage]):
                self.add_module(f"stage{stage}_block{bi}", SwinBlock(
                    dims[stage], num_heads[stage], tuple(window_size), grid,
                    shift=(bi % 2 == 1), drop=drop_rate, attn_drop=attn_drop_rate,
                    monai_table=monai_compat,
                ))
            self.add_module(f"merge{stage}", PatchMerging(
                dims[stage], order="monai_v1" if monai_compat else "product"))
            grid = tuple((g + 1) // 2 for g in grid)
            if self.xfuse:
                self.add_module(f"aux_down{stage}", Conv3d(aux_ch, 2 * dims[stage], 2, stride=2))
                aux_ch = 2 * dims[stage]
                if stage in self.fusion_stages:
                    c = 2 * dims[stage]
                    self.add_module(f"xfuse{stage}", CrossAttentionFusion(
                        c, num_heads=_divisor_heads(c, 96),
                    ))
        self.depths = tuple(depths)

        self.encoder0 = UnetrResBlock(in_channels, fs, norm)
        self.encoder1 = UnetrResBlock(fs, fs, norm)
        self.encoder2 = UnetrResBlock(fs * 2, fs * 2, norm)
        self.encoder3 = UnetrResBlock(fs * 4, fs * 4, norm)
        if not monai_compat:  # MONAI feeds the /16 skip to decoder5 as it is
            self.encoder4 = UnetrResBlock(fs * 8, fs * 8, norm)
        self.encoder10 = UnetrResBlock(fs * 16, fs * 16, norm)
        self.decoder5 = UnetrUpBlock(fs * 16, fs * 8, norm)
        self.decoder4 = UnetrUpBlock(fs * 8, fs * 4, norm)
        self.decoder3 = UnetrUpBlock(fs * 4, fs * 2, norm)
        self.decoder2 = UnetrUpBlock(fs * 2, fs, norm)
        self.decoder1 = UnetrUpBlock(fs, fs, norm)
        self.out_conv = Conv3d(fs, out_channels, 1)
        self.deep_supervision = deep_supervision
        if deep_supervision:  # f32 1×1 heads on d1 (/2) and d2 (/4)
            self.ds_head0 = Conv3d(fs, out_channels, 1)
            self.ds_head1 = Conv3d(fs * 2, out_channels, 1)

    @property
    def perturb_points(self) -> List[str]:
        """The names of the perturbation points."""
        return [f"stage{i}" for i in range(5)]

    def tp_targets(self) -> List[str]:
        """The layers tensor parallelism splits where it can: every Swin
        block's attention and MLP, every cross-attention fusion, and the
        residual blocks of decoders 5 to 2, which take the activations the
        JAX model constrains to the model axis (``swin_unetr.py:757-766``)."""
        blocks = [f"stage{s}_block{b}" for s in range(4) for b in range(self.depths[s])]
        fusions = [f"xfuse{s}" for s in range(4) if hasattr(self, f"xfuse{s}")]
        return blocks + fusions + [f"decoder{i}.res" for i in (5, 4, 3, 2)]

    def forward(
        self,
        x: torch.Tensor,
        capture: bool = False,
        perturb: Optional[Dict[str, torch.Tensor]] = None,
        intermediates: Optional[Dict[Tuple[str, ...], List[torch.Tensor]]] = None,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, List[torch.Tensor]]]:
        """Logits, or with ``capture`` ``(logits, hidden)`` (``(outs,
        hidden)`` under deep supervision in training), ``hidden`` the
        channels-last pyramid taps of the JAX model: native, each stage's
        output before its merge and the bottleneck; ``monai_compat``, the
        patch embedding and each merge's output. ``perturb`` takes the live
        activations at ``stage0..stage4`` (before each merge, then the
        bottleneck: the flax points, also under ``monai_compat``).
        ``intermediates`` takes each block's attention probabilities under
        ``("stage{s}_block{b}", "attn", "attn_probs")``; those blocks take
        the dense path (``WindowAttention``), and kernel B still runs."""
        if tuple(x.shape[1:4]) != self.img_size or x.shape[-1] != self.in_channels:
            raise ValueError(f"SwinUNETR built for [B, {self.img_size}, {self.in_channels}] "
                             f"inputs got {tuple(x.shape)}")
        x = x.to(self.dtype)
        inp = x

        y = conv_cl(self.patch_embed, x)
        hidden: List[torch.Tensor] = []
        if self.monai_compat:
            hidden.append(y)  # MONAI's x0: the raw patch embedding at /2
        if self.xfuse:
            aux = F.gelu(conv_cl(self.aux_embed, x[..., 1:]))
        for stage in range(4):
            for bi in range(self.depths[stage]):
                block = getattr(self, f"stage{stage}_block{bi}")
                sow = None
                if intermediates is not None:
                    sow = intermediates.setdefault((f"stage{stage}_block{bi}", "attn",
                                                    "attn_probs"), [])
                if (self.use_remat and self.training and torch.is_grad_enabled()
                        and sow is None):
                    # remat: keep the block's input only and run its forward
                    # again in the backward pass (``nn.remat`` in flax)
                    y = checkpoint(block, y, use_reentrant=False)
                else:
                    y = block(y, sow)
            y = perturb_at(perturb, f"stage{stage}", y)
            if not self.monai_compat:
                hidden.append(y)  # tap pre-merge (native wiring)
            y = getattr(self, f"merge{stage}")(y)
            if self.xfuse:
                aux = F.gelu(conv_cl(getattr(self, f"aux_down{stage}"), aux))
                if stage in self.fusion_stages:
                    y = getattr(self, f"xfuse{stage}")(y, aux)
            if self.monai_compat:
                hidden.append(y)  # MONAI taps post-merge
        y = perturb_at(perturb, "stage4", y)
        if not self.monai_compat:
            hidden.append(y)  # bottleneck 16fs @ /32
        taps = [param_free_layer_norm(t) for t in hidden] if self.monai_compat else hidden

        enc0 = self.encoder0(cf(inp))
        enc1 = self.encoder1(cf(taps[0]))
        enc2 = self.encoder2(cf(taps[1]))
        enc3 = self.encoder3(cf(taps[2]))
        enc4 = cf(taps[3]) if self.monai_compat else self.encoder4(cf(taps[3]))
        bottleneck = self.encoder10(cf(taps[4]))

        d4 = self.decoder5(bottleneck, enc4)
        d3 = self.decoder4(d4, enc3)
        d2 = self.decoder3(d3, enc2)
        d1 = self.decoder2(d2, enc1)
        d0 = self.decoder1(d1, enc0)
        logits = logits_out(self.out_conv, d0)  # f32 logits, as the JAX model's
        if self.deep_supervision and self.training:
            logits = supervised_outputs(logits, [logits_out(self.ds_head0, d1),
                                                 logits_out(self.ds_head1, d2)])
        return (logits, hidden) if capture else logits


def set_use_kernels(model: nn.Module, use_kernels: bool) -> None:
    """Set ``use_kernel`` on every attention module of ``model``: True (the
    default) runs the kernels on CUDA tensors, False runs the plain versions
    everywhere (the reference the kernels are held against on the card)."""
    for m in model.modules():
        if isinstance(m, (WindowAttention, CrossAttentionFusion)):
            m.use_kernel = use_kernels


def build_swin_unetr(config, dtype: torch.dtype = torch.float32) -> SwinUNETR:
    """Factory from config (the JAX package's ``build_swin_unetr``)."""
    backbone = config.get("model.backbone", {}) or {}
    fusion = config.get("model.fusion", {}) or {}
    ftype = str(fusion.get("type", "early")).lower()
    modalities = config.get("data.modalities", ["CT", "PET"])
    modality_fusion = "cross_attention" if (ftype == "cross_attention" and len(modalities) >= 2) else None
    monai_compat = bool(backbone.get("monai_compat", False))
    if modality_fusion and monai_compat:
        raise ValueError(
            "model.backbone.monai_compat reproduces the reference graph "
            "exactly and cannot be combined with model.fusion.type="
            "cross_attention (this framework's extension) — drop one.")
    if deep_supervision(config) and monai_compat:
        raise ValueError(
            "model.head.type=deep_supervision adds aux-head params that do "
            "not exist in the MONAI graph — incompatible with "
            "model.backbone.monai_compat (torch checkpoint interchange).")
    if monai_compat and bool(backbone.get("scan_blocks", False)):
        raise ValueError("model.backbone.scan_blocks stacks block params on a depth axis — "
                         "incompatible with monai_compat checkpoint-parity trees")
    stages = fusion.get("stages") if hasattr(fusion, "get") else None
    return SwinUNETR(
        in_channels=int(config.get("model.in_channels", len(modalities))),
        out_channels=int(config.get("model.out_channels", 8)),
        img_size=tuple(backbone.get("img_size", [96, 96, 96])),
        feature_size=int(backbone.get("feature_size", 48)),
        depths=tuple(backbone.get("depths", [2, 2, 2, 2])),
        num_heads=tuple(backbone.get("num_heads", [3, 6, 12, 24])),
        window_size=tuple(backbone.get("window_size", [7, 7, 7])),
        drop_rate=float(config.get("model.head.dropout", 0.0) or 0.0),
        dtype=dtype,
        use_remat=bool(config.get("parallel.remat", False)),
        modality_fusion=modality_fusion,
        # stages: [] is a legitimate "no per-stage fusion" request — only
        # an ABSENT key falls back to all stages
        fusion_stages=tuple(stages) if stages is not None else (0, 1, 2, 3),
        deep_supervision=deep_supervision(config),
        monai_compat=monai_compat,
    )
