"""Import reference PyTorch checkpoints into the port's models (port of the
JAX package's ``models/torch_import.py``).

The reference saves ``{"model_state_dict": ...}`` torch checkpoints of its
UNet3D, of MONAI's SwinUNETR and of its DualEncoder. The port's modules keep
torch's own layouts (Conv3d ``[out, in, kh, kw, kd]``, ConvTranspose3d
``[in, out, kh, kw, kd]``, Linear ``[out, in]``), so a map from a reference
state dict to the port's ``state_dict`` is a table of key pairs, with four
exceptions:

- MONAI's ``UnetResBlock`` and transposed convs have no bias where the port's
  convs (as the JAX package's) have one: the import fills zeros, the export
  drops them (warning when a trained one is not zero);
- the DualEncoder's concat projections are 1×1×1 convs in the reference and
  ``Linear`` layers in the port: a reshape;
- a relative-position-bias table is resampled when the target window
  differs from the checkpoint's (:func:`resample_rel_pos_bias`);
- MONAI's ``relative_position_index`` buffers are not the port's (it builds
  its own), so the import skips them and the export writes them.

The tables below drive both directions (``models/torch_export.py`` is the
inverse), and ``import(export(state)) == state`` exactly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# (reference key, port key, kind); kinds:
#   copy     — the same tensor;
#   opt      — the same tensor, where the source has it (qkv biases);
#   zeros    — a bias the reference may lack: zeros on import, written on export;
#   biasfree — a bias the reference never has: zeros on import, dropped on export;
#   proj     — a 1×1×1 conv ``[out, in, 1, 1, 1]`` ↔ a Linear ``[out, in]``;
#   table    — a relative-position-bias table (resampled on import when asked).
Pairs = List[Tuple[str, str, str]]


def _conv_block(pairs: Pairs, ref: str, port: str) -> None:
    """The reference ``ConvBlock``'s two biased convs (norms carry nothing)."""
    for conv in ("conv1", "conv2"):
        for leaf in ("weight", "bias"):
            pairs.append((f"{ref}.{conv}.{leaf}", f"{port}.{conv}.{leaf}", "copy"))


def _copy(pairs: Pairs, ref: str, port: str, leaves=("weight", "bias")) -> None:
    for leaf in leaves:
        pairs.append((f"{ref}.{leaf}", f"{port}.{leaf}", "copy"))


def unet3d_pairs(num_levels: int) -> Pairs:
    """Reference UNet3D (``init_conv``, ``encoders.i.conv``,
    ``decoders.j.{up,conv}``, ``out_conv``) ↔ the port's UNet3D."""
    pairs: Pairs = []
    _conv_block(pairs, "init_conv", "init_conv")
    for i in range(num_levels - 1):
        _conv_block(pairs, f"encoders.{i}.conv", f"down{i}.block")
    for j in range(num_levels - 1):
        _copy(pairs, f"decoders.{j}.up", f"up{j}.transp_conv")
        _conv_block(pairs, f"decoders.{j}.conv", f"up{j}.block")
    _copy(pairs, "out_conv", "out_conv")
    return pairs


def _res_block(pairs: Pairs, ref: str, port: str, shortcut: bool) -> None:
    """MONAI ``UnetResBlock`` (bias-free convs; affine-free instance norms)."""
    for conv in ("conv1", "conv2") + (("conv3",) if shortcut else ()):
        pairs.append((f"{ref}.{conv}.conv.weight", f"{port}.{conv}.weight", "copy"))
        pairs.append((f"{ref}.{conv}.conv.bias", f"{port}.{conv}.bias", "biasfree"))


def swin_unetr_pairs(depths=(2, 2, 2, 2), in_channels: int = 2,
                     feature_size: int = 48) -> Pairs:
    """MONAI SwinUNETR (``swinViT.*``, ``encoder{1,2,3,4,10}``,
    ``decoder{5..1}``, ``out``) ↔ the port's ``SwinUNETR(monai_compat=True)``.
    MONAI's ``encoder1..4`` are the port's ``encoder0..3``; a shortcut conv
    exists where a block changes the channel count."""
    pairs: Pairs = [
        ("swinViT.patch_embed.proj.weight", "patch_embed.weight", "copy"),
        ("swinViT.patch_embed.proj.bias", "patch_embed.bias", "zeros"),
    ]
    for s in range(4):
        layer = f"swinViT.layers{s + 1}.0"
        for b in range(depths[s]):
            blk, ours = f"{layer}.blocks.{b}", f"stage{s}_block{b}"
            _copy(pairs, f"{blk}.norm1", f"{ours}.norm1")
            pairs.append((f"{blk}.attn.qkv.weight", f"{ours}.attn.qkv.weight", "copy"))
            pairs.append((f"{blk}.attn.qkv.bias", f"{ours}.attn.qkv.bias", "opt"))
            pairs.append((f"{blk}.attn.relative_position_bias_table",
                          f"{ours}.attn.rel_pos_bias", "table"))
            _copy(pairs, f"{blk}.attn.proj", f"{ours}.attn.proj")
            _copy(pairs, f"{blk}.norm2", f"{ours}.norm2")
            _copy(pairs, f"{blk}.mlp.linear1", f"{ours}.mlp_fc1")
            _copy(pairs, f"{blk}.mlp.linear2", f"{ours}.mlp_fc2")
        _copy(pairs, f"{layer}.downsample.norm", f"merge{s}.norm")
        _copy(pairs, f"{layer}.downsample.reduction", f"merge{s}.reduction", ("weight",))
    fs = feature_size
    for ours, monai, shortcut in (("encoder0", "encoder1", in_channels != fs),
                                  ("encoder1", "encoder2", False),
                                  ("encoder2", "encoder3", False),
                                  ("encoder3", "encoder4", False),
                                  ("encoder10", "encoder10", False)):
        _res_block(pairs, f"{monai}.layer", ours, shortcut)
    for n in range(5, 0, -1):
        pairs.append((f"decoder{n}.transp_conv.conv.weight", f"decoder{n}.transp_conv.weight",
                      "copy"))
        pairs.append((f"decoder{n}.transp_conv.conv.bias", f"decoder{n}.transp_conv.bias",
                      "biasfree"))
        _res_block(pairs, f"decoder{n}.conv_block", f"decoder{n}.res", True)
    pairs.append(("out.conv.conv.weight", "out_conv.weight", "copy"))
    pairs.append(("out.conv.conv.bias", "out_conv.bias", "zeros"))
    return pairs


def dual_encoder_pairs(num_levels: int, num_modalities: int = 2,
                       fusion_type: str = "concat") -> Pairs:
    """Reference DualEncoder (``encoders.m.{init_conv,blocks.i.conv}``,
    ``decoder.j.{up,conv}``, ``out_conv``, the fusion's ``fusion_proj.l`` or
    ``fusion_layers.l.attention.{2,4}``) ↔ the port's DualEncoder."""
    pairs: Pairs = []
    for m in range(num_modalities):
        _conv_block(pairs, f"encoders.{m}.init_conv", f"encoder{m}.init_conv")
        for i in range(num_levels - 1):
            _conv_block(pairs, f"encoders.{m}.blocks.{i}.conv", f"encoder{m}.down{i}.block")
    for j in range(num_levels - 1):
        _copy(pairs, f"decoder.{j}.up", f"up{j}.transp_conv")
        _conv_block(pairs, f"decoder.{j}.conv", f"up{j}.block")
    _copy(pairs, "out_conv", "out_conv")
    for lv in range(num_levels):
        if fusion_type == "concat":
            pairs.append((f"fusion_proj.{lv}.weight", f"fusion_proj{lv}.weight", "proj"))
            pairs.append((f"fusion_proj.{lv}.bias", f"fusion_proj{lv}.bias", "copy"))
        elif fusion_type == "attention":
            _copy(pairs, f"fusion_layers.{lv}.attention.2", f"fusion_attn{lv}.fc1")
            _copy(pairs, f"fusion_layers.{lv}.attention.4", f"fusion_attn{lv}.fc2")
    return pairs


def _t(a) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.detach().to("cpu", torch.float32).clone()


def _interp_linear_axis(a: np.ndarray, coords: np.ndarray, axis: int) -> np.ndarray:
    """1-D linear interpolation of ``a`` at fractional ``coords`` along
    ``axis`` (separable building block of the trilinear resample below)."""
    i0 = np.clip(np.floor(coords).astype(np.int64), 0, a.shape[axis] - 1)
    i1 = np.minimum(i0 + 1, a.shape[axis] - 1)
    frac = coords - np.floor(coords)
    shape = [1] * a.ndim
    shape[axis] = -1
    w = frac.reshape(shape)
    return np.take(a, i0, axis) * (1.0 - w) + np.take(a, i1, axis) * w


def resample_rel_pos_bias(
    table: np.ndarray,
    src_window: Tuple[int, int, int],
    dst_window: Tuple[int, int, int],
) -> np.ndarray:
    """Window-size transfer for Swin relative-position-bias tables.

    ``table`` is ``[(2sh-1)(2sw-1)(2sd-1), heads]``: a per-head bias over the
    3-D relative-displacement grid ``[-(w-1), w-1]³``. Moving a checkpoint
    trained at one window size (MONAI's 7³ default) to another (the 6³
    window that divides every stage of a 96³ ROI) resamples that grid
    trilinearly with the displacement axes scaled proportionally: target
    displacement ``d`` reads the source at ``d · (ws-1)/(wt-1)``. Nothing
    else in a SwinUNETR checkpoint is window-shaped.
    """
    sh = tuple(2 * int(w) - 1 for w in src_window)
    dh = tuple(2 * int(w) - 1 for w in dst_window)
    heads = table.shape[-1]
    if table.shape[0] != int(np.prod(sh)):
        raise ValueError(
            f"rel-pos-bias table has {table.shape[0]} rows; window "
            f"{tuple(src_window)} implies {int(np.prod(sh))}")
    if sh == dh:
        return table
    grid = np.asarray(table, np.float64).reshape(*sh, heads)
    for axis in range(3):
        s, d = src_window[axis], dst_window[axis]
        if d > 1:
            # displacement −(d−1)..(d−1) → source units, then +center offset
            disp = np.arange(dh[axis], dtype=np.float64) - (d - 1)
            coords = disp * (s - 1) / (d - 1) + (s - 1)
        else:
            coords = np.array([float(s - 1)])  # center (zero displacement)
        grid = _interp_linear_axis(grid, coords, axis)
    return np.ascontiguousarray(grid.reshape(-1, heads).astype(table.dtype, copy=False))


def _infer_cubic_window(table_rows: int) -> Tuple[int, int, int]:
    """Source window of a checkpoint bias table, assuming cubic windows
    (the only kind the reference constructs — MONAI's default 7³)."""
    side = round(table_rows ** (1.0 / 3.0))
    for cand in (side - 1, side, side + 1):
        if cand > 0 and cand % 2 == 1 and cand**3 == table_rows:
            w = (cand + 1) // 2
            return (w, w, w)
    raise ValueError(
        f"cannot infer a cubic source window from a {table_rows}-row "
        "rel-pos-bias table; pass src_window explicitly")


def _strip(state_dict: Mapping[str, Any], prefixes=("backbone.", "model.")) -> Dict[str, Any]:
    """Keys without the wrapper prefixes (the reference's ``backbone.`` and
    MONAI wrapper's ``model.``), in that order."""
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            k = k.removeprefix(p)
        out[k] = v
    return out


def import_pairs(sd: Mapping[str, Any], pairs: Pairs, table=None) -> Dict[str, torch.Tensor]:
    """A reference state dict (prefixes stripped) → the port's tensors by
    ``pairs``; ``table(t)`` maps each relative-position table."""
    out: Dict[str, torch.Tensor] = {}
    for ref, port, kind in pairs:
        if kind in ("zeros", "biasfree") and ref not in sd:
            weight = sd[ref.removesuffix(".bias") + ".weight"]
            # a conv's output channels lead its weight; a transposed conv's follow
            n = weight.shape[1] if "transp_conv" in ref else weight.shape[0]
            out[port] = torch.zeros(int(n), dtype=torch.float32)
        elif kind == "opt" and ref not in sd:
            continue
        elif kind == "proj":
            w = _t(sd[ref])
            out[port] = w.reshape(w.shape[0], w.shape[1])
        elif kind == "table" and table is not None:
            out[port] = _t(table(np.asarray(_t(sd[ref]).numpy())))
        else:
            out[port] = _t(sd[ref])
    return out


def from_torch_unet3d(state_dict: Mapping[str, Any], num_levels: int) -> Dict[str, torch.Tensor]:
    """Reference UNet3D state_dict → the port's UNet3D parameters
    (``num_levels`` = len(features); the reference has num_levels-1
    encoder and decoder blocks)."""
    return import_pairs(_strip(state_dict, ("backbone.",)), unet3d_pairs(num_levels))


def from_torch_swin_unetr(
    state_dict: Mapping[str, Any],
    depths=(2, 2, 2, 2),
    target_window: Optional[Tuple[int, int, int]] = None,
    src_window: Optional[Tuple[int, int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """MONAI SwinUNETR state_dict → the port's ``SwinUNETR(monai_compat=True)``
    parameters.

    MONAI's keys (``swinViT.layers{i}.0.blocks.{j}...``,
    ``encoder{1,2,3,4,10}.layer...``, ``decoder{5..1}...``, ``out.conv``),
    with the wrapper prefixes (the reference's ``model.``, the JAX package's
    ``backbone.``) stripped. Target the ``merge_order`` the checkpoint was
    trained with (MONAI's default ``downsample="merging"`` is the port's
    ``monai_v1``, which ``monai_compat`` builds).

    ``target_window``: when the target config's ``window_size`` differs
    from the checkpoint's, every relative-position-bias table is resampled
    onto the new displacement grid (:func:`resample_rel_pos_bias`);
    ``src_window`` is inferred from the table's row count (cubic) unless
    given.
    """
    sd = _strip(state_dict)
    in_channels = int(sd["swinViT.patch_embed.proj.weight"].shape[1])
    feature_size = int(sd["swinViT.patch_embed.proj.weight"].shape[0])
    table = None
    if target_window is not None:
        def table(t):
            src = src_window or _infer_cubic_window(t.shape[0])
            return resample_rel_pos_bias(t, src, tuple(target_window))
    return import_pairs(sd, swin_unetr_pairs(depths, in_channels, feature_size), table)


def from_torch_dual_encoder(
    state_dict: Mapping[str, Any],
    num_levels: int,
    num_modalities: int = 2,
    fusion_type: str = "concat",
) -> Dict[str, torch.Tensor]:
    """Reference DualEncoder state_dict → the port's DualEncoder parameters:
    the per-modality encoders, the shared decoder (deepest level first on
    both sides), the 1×1 ``out_conv`` and the fusion (``concat``: per-level
    1×1 projections; ``attention``: the SE MLP's two Linear layers, indices 2
    and 4 of its Sequential; ``add``: nothing). Instance norms are
    affine-free on both sides."""
    return import_pairs(_strip(state_dict, ("backbone.",)),
                        dual_encoder_pairs(num_levels, num_modalities, fusion_type))


def load_state_dict(path) -> Dict[str, Any]:
    """Load a reference .pth checkpoint (the reference's model_state_dict /
    state_dict / raw formats)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        return ckpt["model_state_dict"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def _backbone(config) -> Dict[str, Any]:
    backbone = config.get("model.backbone", {}) or {}
    return backbone.to_dict() if hasattr(backbone, "to_dict") else dict(backbone)


def dual_encoder_fusion(config) -> str:
    """The reference DualEncoder's fusion for this config (early and late
    are its concat), or ValueError: the reference wires only concat, add and
    attention, so other fusions have no checkpoint layout."""
    fusion = config.get("model.fusion", {}) or {}
    ftype = str(fusion.get("type", "concat") if hasattr(fusion, "get") else "concat").lower()
    if ftype in ("early", "late"):
        ftype = "concat"
    if ftype not in ("concat", "add", "attention"):
        raise ValueError(
            f"the reference DualEncoder only ever wires concat/add/attention fusion — "
            f"there is no reference checkpoint layout for fusion type {ftype!r}")
    return ftype


def import_torch_checkpoint(path, config) -> Dict[str, torch.Tensor]:
    """The reference's ``load_pretrained``, config-driven: load a reference
    .pth and map it onto this config's model; returns the port's parameters
    by name (the state dict of ``build_model(config)`` without buffers).

    unet3d → the UNet3D map; swin_unetr → the MONAI SwinUNETR map (requires
    ``model.backbone.monai_compat: true``, so the port's graph reproduces the
    checkpoint's wiring); dual_encoder → per-modality encoders + fusion.
    ``attention_unet`` has no reference implementation to import from.
    """
    sd = load_state_dict(path)
    name = str(config.get("model.name", "swin_unetr")).lower()
    backbone = _backbone(config)
    if name in ("unet", "unet3d"):
        feats = list(backbone.get("features", [32, 64, 128, 256, 512]))
        return from_torch_unet3d(sd, num_levels=len(feats))
    if name == "swin_unetr":
        if not bool(backbone.get("monai_compat", False)):
            raise ValueError(
                "importing a reference SwinUNETR .pth requires "
                "model.backbone.monai_compat: true (the checkpoint encodes "
                "MONAI's graph wiring — post-merge taps, v1 merge order, "
                "constructor-window bias tables)")
        return from_torch_swin_unetr(
            sd,
            depths=tuple(backbone.get("depths", [2, 2, 2, 2])),
            # resample the bias tables when the target window differs from
            # the checkpoint's (a no-op when they match)
            target_window=tuple(backbone.get("window_size", [7, 7, 7])),
        )
    if name == "dual_encoder":
        feats = list(backbone.get("features", [32, 64, 128, 256, 512]))
        return from_torch_dual_encoder(
            sd, num_levels=len(feats),
            num_modalities=len(config.get("data.modalities", ["CT", "PET"])),
            fusion_type=dual_encoder_fusion(config))
    raise ValueError(f"no reference torch-checkpoint mapping for model.name={name!r}")
