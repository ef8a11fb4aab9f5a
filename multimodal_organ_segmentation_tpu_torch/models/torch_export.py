"""Export the port's weights to reference-loadable torch checkpoints (port of
the JAX package's ``models/torch_export.py``).

The inverse of ``models/torch_import.py``, by the same key tables: the
port's parameters go into the reference's ``.pth`` layout
(``{"epoch", "model_state_dict", ...}`` through ``torch.save``), so a run of
the port can be evaluated in the reference's own harness, and
``import(export(state)) == state`` exactly.

Bias caveat: MONAI's ``UnetResBlock`` and transposed-conv layers are
bias-free while the port's convs carry biases. Fresh and imported biases are
zeros, so the round trip is exact; a ``monai_compat`` model trained in the
port may hold non-zero biases with no slot in MONAI's graph: those are
dropped with a warning listing the keys and their max |bias|.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping

import numpy as np
import torch

from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import _relative_position_index
from multimodal_organ_segmentation_tpu_torch.models.torch_import import (
    Pairs,
    _backbone,
    dual_encoder_fusion,
    dual_encoder_pairs,
    swin_unetr_pairs,
    unet3d_pairs,
)


def export_pairs(state: Mapping[str, torch.Tensor], pairs: Pairs) -> Dict[str, torch.Tensor]:
    """The port's tensors → a reference state dict by ``pairs`` (f32 CPU
    copies); biases without a reference slot are dropped, with a warning
    where one is not zero."""
    sd: Dict[str, torch.Tensor] = {}
    dropped = []
    for ref, port, kind in pairs:
        if kind == "opt" and port not in state:
            continue
        t = state[port].detach().to("cpu", torch.float32).clone()
        if kind == "biasfree":
            mx = float(t.abs().max()) if t.numel() else 0.0
            if mx > 0:
                dropped.append((ref, mx))
            continue
        sd[ref] = t[..., None, None, None] if kind == "proj" else t
    if dropped:
        lines = ", ".join(f"{k} (max|b|={m:.2e})" for k, m in dropped)
        warnings.warn(
            f"exported SwinUNETR drops {len(dropped)} non-zero conv biases "
            f"that have no slot in MONAI's bias-free layers: {lines}. "
            f"Logits from the exported checkpoint will differ accordingly.",
            stacklevel=3,
        )
    return sd


def to_torch_unet3d(state: Mapping[str, torch.Tensor], num_levels: int) -> Dict[str, torch.Tensor]:
    """The port's UNet3D state → reference UNet3D state_dict."""
    return export_pairs(state, unet3d_pairs(num_levels))


def to_torch_swin_unetr(state: Mapping[str, torch.Tensor], depths=(2, 2, 2, 2),
                        window_size=(7, 7, 7)) -> Dict[str, torch.Tensor]:
    """The port's ``SwinUNETR(monai_compat=True)`` state → MONAI SwinUNETR
    state_dict, with the ``relative_position_index`` buffers MONAI registers
    in every block."""
    weight = state["patch_embed.weight"]
    pairs = swin_unetr_pairs(depths, int(weight.shape[1]), int(weight.shape[0]))
    sd = export_pairs(state, pairs)
    rel_idx = torch.from_numpy(_relative_position_index(tuple(window_size)).astype(np.int64))
    for s in range(4):
        for b in range(depths[s]):
            sd[f"swinViT.layers{s + 1}.0.blocks.{b}.attn.relative_position_index"] = rel_idx.clone()
    return sd


def to_torch_dual_encoder(state: Mapping[str, torch.Tensor], num_levels: int,
                          num_modalities: int = 2,
                          fusion_type: str = "concat") -> Dict[str, torch.Tensor]:
    """The port's DualEncoder state → reference DualEncoder state_dict."""
    return export_pairs(state, dual_encoder_pairs(num_levels, num_modalities, fusion_type))


def export_torch_checkpoint(
    state: Mapping[str, torch.Tensor],
    config,
    path,
    epoch: int = 0,
    best_metric: float = 0.0,
    **extra: Any,
) -> str:
    """Write the port's weights as a reference-loadable ``.pth``.

    Config-driven as ``import_torch_checkpoint``; the state_dict keys carry
    the reference wrapper prefixes (``backbone.`` for UNet3D/DualEncoder,
    ``backbone.model.`` for the MONAI-wrapped SwinUNETR), so ``torch.load`` +
    ``model.load_state_dict`` works as it is in the reference repository.
    """
    name = str(config.get("model.name", "swin_unetr")).lower()
    backbone = _backbone(config)
    if name in ("unet", "unet3d"):
        feats = list(backbone.get("features", [32, 64, 128, 256, 512]))
        sd = to_torch_unet3d(state, num_levels=len(feats))
        prefix = "backbone."
    elif name == "swin_unetr":
        # only the monai_compat graph maps onto MONAI's slots: a natively
        # wired SwinUNETR (pre-merge taps, encoder4 block, fusion modules)
        # has weights with no reference slot
        if not bool(backbone.get("monai_compat", False)):
            raise ValueError(
                "exporting a SwinUNETR .pth requires model.backbone."
                "monai_compat: true — the reference graph is MONAI's; the "
                "native wiring (pre-merge taps, encoder4 block, modality "
                "fusion) has no slots in it.")
        if bool(backbone.get("scan_blocks", False)):
            raise ValueError(
                "cannot export a scan_blocks configuration: its params are "
                "stacked per stage (stage{s}/blocks); use scan_blocks: false "
                "for torch interchange.")
        sd = to_torch_swin_unetr(
            state,
            depths=tuple(backbone.get("depths", [2, 2, 2, 2])),
            window_size=tuple(backbone.get("window_size", [7, 7, 7])),
        )
        prefix = "backbone.model."
    elif name == "dual_encoder":
        feats = list(backbone.get("features", [32, 64, 128, 256, 512]))
        sd = to_torch_dual_encoder(
            state, num_levels=len(feats),
            num_modalities=len(config.get("data.modalities", ["CT", "PET"])),
            fusion_type=dual_encoder_fusion(config))
        prefix = "backbone."
    else:
        raise ValueError(f"no torch export mapping for model.name={name!r}")

    ckpt = {
        "epoch": int(epoch),
        "model_state_dict": {prefix + k: v for k, v in sd.items()},
        "best_metric": float(best_metric),
        **extra,
    }
    torch.save(ckpt, path)
    return str(path)
