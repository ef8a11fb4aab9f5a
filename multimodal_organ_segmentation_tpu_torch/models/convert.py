"""Carry the JAX package's SwinUNETR weights into the port, and back.

``swin_unetr_params_from_jax`` takes the native flax params tree, as nested
dicts of numpy arrays (``jax.device_get`` of the tree, or the tree itself),
and returns the port's ``state_dict``. It takes both the unrolled tree and
the ``scan_blocks`` tree, whose ``stage{s}/blocks/...`` leaves are stacked on
a leading depth axis. ``swin_unetr_params_to_jax`` is the inverse: a port
``state_dict`` back to a numpy params tree in either layout, so that both
packages can be stepped from one init and their updated weights compared.

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
from typing import Any, Dict, List, Mapping

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


# ---------------------------------------------------------------------------
# the other direction: the port's state_dict → a flax params tree (numpy)
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _conv_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": np.transpose(_np(sd[f"{prefix}.weight"]), (2, 3, 4, 1, 0)),
            "bias": _np(sd[f"{prefix}.bias"])}


def _dense_to_jax(sd: Mapping[str, torch.Tensor], prefix: str, conv1: bool = False) -> Dict[str, np.ndarray]:
    kernel = _np(sd[f"{prefix}.weight"]).T
    node = {"kernel": kernel[None, None, None] if conv1 else kernel}
    if f"{prefix}.bias" in sd:
        node["bias"] = _np(sd[f"{prefix}.bias"])
    return node


def _layer_norm_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _swin_block_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    return {
        "attn": {"qkv": _dense_to_jax(sd, f"{prefix}.attn.qkv"),
                 "proj": _dense_to_jax(sd, f"{prefix}.attn.proj"),
                 "rel_pos_bias": _np(sd[f"{prefix}.attn.rel_pos_bias"])},
        "norm1": _layer_norm_to_jax(sd, f"{prefix}.norm1"),
        "norm2": _layer_norm_to_jax(sd, f"{prefix}.norm2"),
        "mlp_fc1": _dense_to_jax(sd, f"{prefix}.mlp_fc1"),
        "mlp_fc2": _dense_to_jax(sd, f"{prefix}.mlp_fc2"),
    }


def _res_block_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    node: Dict[str, Any] = {}
    for i in range(3):
        if f"{prefix}.conv{i + 1}.weight" in sd:
            node[f"Conv_{i}"] = _conv_to_jax(sd, f"{prefix}.conv{i + 1}")
        if f"{prefix}.norm{i + 1}.weight" in sd:
            node[f"Norm3D_{i}"] = {"GroupNorm_0": {"scale": _np(sd[f"{prefix}.norm{i + 1}.weight"]),
                                                   "bias": _np(sd[f"{prefix}.norm{i + 1}.bias"])}}
    return node


def _stack(nodes: List[Any]) -> Any:
    if isinstance(nodes[0], Mapping):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return np.stack(nodes, axis=0)


def swin_unetr_params_to_jax(state: Mapping[str, torch.Tensor],
                             scan_blocks: bool = False) -> Dict[str, Any]:
    """The port's ``SwinUNETR`` state_dict → the native flax params tree as
    nested dicts of f32 numpy arrays: unrolled ``stage{s}_block{b}`` groups,
    or with ``scan_blocks`` each stage's blocks stacked on a leading depth
    axis under ``stage{s}/blocks``. The inverse of
    :func:`swin_unetr_params_from_jax`."""
    groups = sorted({key.split(".")[0] for key in state})
    params: Dict[str, Any] = {}
    blocks: Dict[int, Dict[int, Any]] = {}
    for key in groups:
        block = re.fullmatch(r"stage(\d+)_block(\d+)", key)
        if key in ("patch_embed", "aux_embed", "out_conv") or key.startswith("aux_down"):
            params[key] = _conv_to_jax(state, key)
        elif block:
            blocks.setdefault(int(block.group(1)), {})[int(block.group(2))] = _swin_block_to_jax(state, key)
        elif key.startswith("merge"):
            params[key] = {"LayerNorm_0": _layer_norm_to_jax(state, f"{key}.norm"),
                           "Dense_0": _dense_to_jax(state, f"{key}.reduction")}
        elif key.startswith("xfuse"):
            params[key] = {proj: _dense_to_jax(state, f"{key}.{proj}", conv1=True)
                           for proj in ("q_proj", "k_proj", "v_proj", "out_proj")}
        elif re.fullmatch(r"encoder\d+", key):
            params[key] = _res_block_to_jax(state, key)
        elif re.fullmatch(r"decoder\d+", key):
            kernel = np.transpose(_np(state[f"{key}.transp_conv.weight"]), (2, 3, 4, 0, 1))
            params[key] = {
                "ConvTranspose_0": {"kernel": np.ascontiguousarray(kernel[::-1, ::-1, ::-1]),
                                    "bias": _np(state[f"{key}.transp_conv.bias"])},
                "_UnetrResBlock_0": _res_block_to_jax(state, f"{key}.res"),
            }
        else:
            raise KeyError(f"unexpected SwinUNETR state group {key!r}")
    for stage, by_index in blocks.items():
        ordered = [by_index[i] for i in sorted(by_index)]
        if scan_blocks:
            params[f"stage{stage}"] = {"blocks": _stack(ordered)}
        else:
            for i, node in enumerate(ordered):
                params[f"stage{stage}_block{i}"] = node
    return params
