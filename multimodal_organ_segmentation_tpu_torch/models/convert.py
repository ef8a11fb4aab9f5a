"""Carry the JAX package's SwinUNETR weights into the port.

``swin_unetr_params_from_jax`` takes the native flax params tree, as nested
dicts of numpy arrays (``jax.device_get`` of the tree, or the tree itself),
and returns the port's ``state_dict``. It takes both the unrolled tree and
the ``scan_blocks`` tree, whose ``stage{s}/blocks/...`` leaves are stacked on
a leading depth axis.

Layouts (as the JAX package's ``models/torch_export.py`` states them); the
spatial axes (H, W, D) keep their order in torch's three spatial slots:

- Conv3d          ``[kh, kw, kd, in, out]`` → ``[out, in, kh, kw, kd]``
- ConvTranspose3d flax ``[kh, kw, kd, in, out]`` is flipped spatially, then
                  → torch ``[in, out, kh, kw, kd]``
- Dense           ``[in, out]`` → Linear ``[out, in]`` (a 1×1×1 fusion conv
                  becomes a Linear the same way)
- LayerNorm       ``scale`` → ``weight``
- ``rel_pos_bias`` ``[table, heads]`` stays as it is.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _conv(sd: Dict[str, torch.Tensor], prefix: str, node: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (4, 3, 0, 1, 2)))
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _dense(sd: Dict[str, torch.Tensor], prefix: str, node: Tree) -> None:
    kernel = np.asarray(node["kernel"])
    sd[f"{prefix}.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    if "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _layer_norm(sd: Dict[str, torch.Tensor], prefix: str, node: Tree) -> None:
    sd[f"{prefix}.weight"] = _t(node["scale"])
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _prefixed(prefix: str, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in state.items()}


def window_attention_state(node: Tree) -> Dict[str, torch.Tensor]:
    """flax ``WindowAttention`` params → the port's ``WindowAttention`` state."""
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "qkv", node["qkv"])
    _dense(sd, "proj", node["proj"])
    sd["rel_pos_bias"] = _t(node["rel_pos_bias"])
    return sd


def swin_block_state(node: Tree) -> Dict[str, torch.Tensor]:
    """flax ``SwinBlock`` params → the port's ``SwinBlock`` state."""
    sd = _prefixed("attn", window_attention_state(node["attn"]))
    _layer_norm(sd, "norm1", node["norm1"])
    _layer_norm(sd, "norm2", node["norm2"])
    _dense(sd, "mlp_fc1", node["mlp_fc1"])
    _dense(sd, "mlp_fc2", node["mlp_fc2"])
    return sd


def cross_attention_fusion_state(node: Tree) -> Dict[str, torch.Tensor]:
    """flax ``CrossAttentionFusion`` params (no ring) → the port's state."""
    sd: Dict[str, torch.Tensor] = {}
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(sd, proj, node[proj])
    return sd


def _res_block(sd: Dict[str, torch.Tensor], prefix: str, node: Tree) -> None:
    for i in range(3):
        if f"Conv_{i}" in node:
            _conv(sd, f"{prefix}.conv{i + 1}", node[f"Conv_{i}"])
        norm = node.get(f"Norm3D_{i}")
        if norm is None:  # instance norm holds no params
            continue
        if "GroupNorm_0" not in norm:
            raise NotImplementedError(f"{prefix}: only instance and group norms are converted")
        sd[f"{prefix}.norm{i + 1}.weight"] = _t(norm["GroupNorm_0"]["scale"])
        sd[f"{prefix}.norm{i + 1}.bias"] = _t(norm["GroupNorm_0"]["bias"])


def _unstack(node: Any, i: int) -> Any:
    if isinstance(node, Mapping):
        return {k: _unstack(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _depth(node: Any) -> int:
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    return int(np.shape(node)[0])


def swin_unetr_params_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """Native flax SwinUNETR params (``variables["params"]`` or the whole
    ``variables`` dict) → the port's ``SwinUNETR`` state_dict, f32."""
    if "params" in params:
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for key, node in params.items():
        if key in ("patch_embed", "aux_embed", "out_conv") or key.startswith("aux_down"):
            _conv(sd, key, node)
        elif re.fullmatch(r"stage\d+_block\d+", key):
            sd.update(_prefixed(key, swin_block_state(node)))
        elif re.fullmatch(r"stage\d+", key):  # scan_blocks: stacked on depth
            blocks = node["blocks"]
            for b in range(_depth(blocks)):
                sd.update(_prefixed(f"{key}_block{b}", swin_block_state(_unstack(blocks, b))))
        elif key.startswith("merge"):
            _layer_norm(sd, f"{key}.norm", node["LayerNorm_0"])
            _dense(sd, f"{key}.reduction", node["Dense_0"])
        elif key.startswith("xfuse"):
            sd.update(_prefixed(key, cross_attention_fusion_state(node)))
        elif re.fullmatch(r"encoder\d+", key):
            _res_block(sd, key, node)
        elif re.fullmatch(r"decoder\d+", key):
            kernel = np.asarray(node["ConvTranspose_0"]["kernel"])[::-1, ::-1, ::-1]
            sd[f"{key}.transp_conv.weight"] = _t(np.transpose(kernel, (3, 4, 0, 1, 2)))
            sd[f"{key}.transp_conv.bias"] = _t(node["ConvTranspose_0"]["bias"])
            _res_block(sd, f"{key}.res", node["_UnetrResBlock_0"])
        else:
            raise KeyError(f"unexpected SwinUNETR parameter group {key!r}")
    return sd
