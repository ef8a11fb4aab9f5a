"""Carry the JAX package's model weights into the port, and back.

``params_from_jax(name, params, batch_stats=None)`` takes the native flax
params tree of any model of the registry, as nested dicts of numpy arrays
(``jax.device_get`` of the tree, or the tree itself; bare, or wrapped as
``{"backbone": ...}`` by the JAX package's ``MultiModalSegmentationModel``,
or a whole ``variables`` dict, whose ``perturbations`` and ``intermediates``
collections, as the JAX explainability runner builds them, hold no weights
and are passed over), and the ``batch_stats`` tree of a batch-norm model,
and returns the port's ``state_dict``.

``params_to_jax(name, state)`` is the inverse: a port ``state_dict`` back
to numpy ``(params, batch_stats)`` trees (``batch_stats`` is {} without
batch norm), so that both packages can be stepped from one init and their
updated weights compared. ``swin_unetr_params_from_jax`` and
``swin_unetr_params_to_jax`` also take and give SwinUNETR's
``scan_blocks`` tree, whose ``stage{s}/blocks/...`` leaves are stacked on a
leading depth axis.

Both directions read one table per module: (port name, flax name, kind),
where the kind is a leaf layout below or a nested table. Flax's automatic
names (``ConvBlock3D_0/Conv_0``, ``Norm3D_1/BatchNorm_0``, ...) sit in the
tables; the top-level names of a model are the same in both packages.

Layouts (as the JAX package's ``models/torch_export.py`` states them); the
spatial axes (H, W, D) keep their order in torch's three spatial slots:

- ``conv``   Conv3d          ``[kh, kw, kd, in, out]`` → ``[out, in, kh, kw, kd]``
- ``tconv``  ConvTranspose3d flax ``[kh, kw, kd, in, out]`` is flipped
                             spatially, then → torch ``[in, out, kh, kw, kd]``
- ``dense``  Dense           ``[in, out]`` → Linear ``[out, in]``
- ``proj``   a 1×1×1 conv held as a Linear: ``[1, 1, 1, in, out]`` → ``[out, in]``
- ``layer_norm`` ``scale`` → ``weight``
- ``norm``   ``Norm3D``: ``GroupNorm_0`` or ``BatchNorm_0`` ``scale``/``bias``
             → ``weight``/``bias``, batch norm's ``mean``/``var`` →
             ``running_mean``/``running_var``; instance norm holds nothing
- ``raw``    stays as it is (``rel_pos_bias [table, heads]``, a threshold).

Tensor parallelism: ``shard_state_dict(sd, plan, mesh)`` slices a whole
port state dict (from ``params_from_jax``, a checkpoint) to one model rank's
shard by a ``parallel.tensor_parallel.TPPlan``; ``gather_state_dict``
rebuilds the whole layout, from every rank's shard given as a list, or from
this rank's shard over the mesh's model group (a collective). Checkpoints and
the tests go through these two.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

Tree = Mapping[str, Any]
State = Dict[str, torch.Tensor]


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


# ---------------------------------------------------------------------------
# leaf layouts, both directions: flax node ↔ port tensors under a prefix
# ---------------------------------------------------------------------------

def _conv(sd: State, prefix: str, node: Tree) -> None:
    sd[_join(prefix, "weight")] = _t(np.transpose(np.asarray(node["kernel"]), (4, 3, 0, 1, 2)))
    if "bias" in node:
        sd[_join(prefix, "bias")] = _t(node["bias"])


def _conv_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    node = {"kernel": np.transpose(_np(sd[_join(prefix, "weight")]), (2, 3, 4, 1, 0))}
    if _join(prefix, "bias") in sd:
        node["bias"] = _np(sd[_join(prefix, "bias")])
    return node


def _tconv(sd: State, prefix: str, node: Tree) -> None:
    kernel = np.asarray(node["kernel"])[::-1, ::-1, ::-1]
    sd[_join(prefix, "weight")] = _t(np.transpose(kernel, (3, 4, 0, 1, 2)))
    sd[_join(prefix, "bias")] = _t(node["bias"])


def _tconv_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    kernel = np.transpose(_np(sd[_join(prefix, "weight")]), (2, 3, 4, 0, 1))
    return {"kernel": np.ascontiguousarray(kernel[::-1, ::-1, ::-1]),
            "bias": _np(sd[_join(prefix, "bias")])}


def _dense(sd: State, prefix: str, node: Tree) -> None:
    kernel = np.asarray(node["kernel"])
    sd[_join(prefix, "weight")] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    if "bias" in node:
        sd[_join(prefix, "bias")] = _t(node["bias"])


def _dense_to_jax(sd: Mapping[str, torch.Tensor], prefix: str, conv1: bool = False) -> Dict[str, np.ndarray]:
    kernel = _np(sd[_join(prefix, "weight")]).T
    node = {"kernel": kernel[None, None, None] if conv1 else kernel}
    if _join(prefix, "bias") in sd:
        node["bias"] = _np(sd[_join(prefix, "bias")])
    return node


def _layer_norm(sd: State, prefix: str, node: Tree) -> None:
    sd[_join(prefix, "weight")] = _t(node["scale"])
    sd[_join(prefix, "bias")] = _t(node["bias"])


def _layer_norm_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[_join(prefix, "weight")]), "bias": _np(sd[_join(prefix, "bias")])}


_STATS = {"mean": "running_mean", "var": "running_var"}


def _norm(sd: State, prefix: str, node: Tree) -> None:
    (inner,) = node.values()  # GroupNorm_0 or BatchNorm_0 (batch_stats merged in)
    _layer_norm(sd, prefix, inner)
    for flax_name, port_name in _STATS.items():
        if flax_name in inner:
            sd[_join(prefix, port_name)] = _t(inner[flax_name])


def _norm_to_jax(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    inner: Dict[str, np.ndarray] = _layer_norm_to_jax(sd, prefix)
    if _join(prefix, "running_mean") not in sd:
        return {"GroupNorm_0": inner}
    for flax_name, port_name in _STATS.items():
        inner[flax_name] = _np(sd[_join(prefix, port_name)])
    return {"BatchNorm_0": inner}


def _raw(sd: State, prefix: str, node: Any) -> None:
    sd[prefix] = _t(node)


_LEAVES = {
    "conv": (_conv, _conv_to_jax),
    "tconv": (_tconv, _tconv_to_jax),
    "dense": (_dense, _dense_to_jax),
    "proj": (_dense, lambda sd, p: _dense_to_jax(sd, p, conv1=True)),
    "layer_norm": (_layer_norm, _layer_norm_to_jax),
    "norm": (_norm, _norm_to_jax),
    "raw": (_raw, lambda sd, p: _np(sd[p])),
}

# ---------------------------------------------------------------------------
# module tables: (port name, flax name, kind or nested table)
# ---------------------------------------------------------------------------

Table = List[Tuple[str, str, Any]]

CONV_BLOCK: Table = [("conv1", "Conv_0", "conv"), ("norm1", "Norm3D_0", "norm"),
                     ("conv2", "Conv_1", "conv"), ("norm2", "Norm3D_1", "norm")]
DOWN_BLOCK: Table = [("block", "ConvBlock3D_0", CONV_BLOCK)]
UP_BLOCK: Table = [("transp_conv", "ConvTranspose_0", "tconv"), ("up_conv", "Conv_0", "conv"),
                   ("block", "ConvBlock3D_0", CONV_BLOCK)]
# groups named alike in both packages: (pattern of the name, kind or table)
Groups = Tuple[Tuple[str, Any], ...]
ENCODER: Groups = ((r"init_conv", CONV_BLOCK), (r"down\d+", DOWN_BLOCK))
GATE: Table = [("theta", "theta", "conv"), ("phi", "phi", "conv"), ("psi", "psi", "conv")]
CROSS_ATTENTION: Table = [(p, p, "proj") for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
BIDIRECTIONAL: Table = [("cross_1to2", "cross_1to2", CROSS_ATTENTION),
                        ("cross_2to1", "cross_2to1", CROSS_ATTENTION), ("fuse", "Conv_0", "proj")]
ATTENTION_FUSION: Table = [("fc1", "Dense_0", "dense"), ("fc2", "Dense_1", "dense")]
SUV_GUIDED: Table = [("mask_conv1", "Conv_0", "conv"), ("mask_conv2", "Conv_1", "conv"),
                     ("proj", "Conv_2", "proj"), ("threshold", "threshold", "raw")]
WINDOW_ATTENTION: Table = [("qkv", "qkv", "dense"), ("proj", "proj", "dense"),
                           ("rel_pos_bias", "rel_pos_bias", "raw")]
SWIN_BLOCK: Table = [("attn", "attn", WINDOW_ATTENTION), ("norm1", "norm1", "layer_norm"),
                     ("norm2", "norm2", "layer_norm"), ("mlp_fc1", "mlp_fc1", "dense"),
                     ("mlp_fc2", "mlp_fc2", "dense")]
RES_BLOCK: Table = [entry for i in range(3) for entry in
                    ((f"conv{i + 1}", f"Conv_{i}", "conv"), (f"norm{i + 1}", f"Norm3D_{i}", "norm"))]
UNETR_UP: Table = [("transp_conv", "ConvTranspose_0", "tconv"), ("res", "_UnetrResBlock_0", RES_BLOCK)]
MERGE: Table = [("norm", "LayerNorm_0", "layer_norm"), ("reduction", "Dense_0", "dense")]
EARLY_FUSION: Table = [("proj", "Conv_0", "proj")]
LATE_FUSION: Table = [("proj", "Conv_0", "proj")]
HIERARCHICAL_LATE_FUSION: Groups = ((r"level\d+", LATE_FUSION),)
SEGMENTATION_HEAD: Table = [("out_conv", "Conv_0", "conv")]
DEEP_SUPERVISION_HEAD: Groups = ((r"scale\d+", SEGMENTATION_HEAD),)
DETECTION_HEAD: Table = [("conv", "Conv_0", "conv"), ("cls_head", "cls_head", "conv"),
                         ("reg_head", "reg_head", "conv")]
CENTERNET_HEAD: Groups = ((r"\w+_(conv|out)", "conv"),)

# each model's top-level groups
_HEAD = (r"out_conv|ds_head\d+", "conv")
MODELS: Dict[str, Groups] = {
    "unet3d": ((r"init_conv", CONV_BLOCK), (r"down\d+", DOWN_BLOCK), (r"up\d+", UP_BLOCK), _HEAD),
    "attention_unet": ((r"init_conv", CONV_BLOCK), (r"down\d+", DOWN_BLOCK), (r"gate\d+", GATE),
                       (r"up\d+_tconv", "tconv"), (r"up\d+_conv", CONV_BLOCK), _HEAD),
    "dual_encoder": ((r"encoder\d+", ENCODER), (r"fusion_proj\d+", "proj"),
                     (r"fusion_attn\d+", ATTENTION_FUSION), (r"fusion_xattn\d+", CROSS_ATTENTION),
                     (r"fusion_bixattn\d+", BIDIRECTIONAL), (r"fusion_suv\d+", SUV_GUIDED),
                     (r"up\d+", UP_BLOCK), _HEAD),
    "swin_unetr": ((r"patch_embed|aux_embed|aux_down\d+", "conv"),
                   (r"stage\d+_block\d+", SWIN_BLOCK), (r"merge\d+", MERGE),
                   (r"xfuse\d+", CROSS_ATTENTION), (r"encoder\d+", RES_BLOCK),
                   (r"decoder\d+", UNETR_UP), _HEAD),
}
MODELS["unet"] = MODELS["unet3d"]


def _group(groups: Groups, name: str) -> Any:
    for pattern, kind in groups:
        if re.fullmatch(pattern, name):
            return kind
    raise KeyError(f"unexpected parameter group {name!r}")


def _load(sd: State, prefix: str, node: Any, kind: Any) -> None:
    """flax ``node`` of ``kind`` → port tensors under ``prefix``."""
    if isinstance(kind, str):
        _LEAVES[kind][0](sd, prefix, node)
    elif isinstance(kind, tuple):
        for name, sub in node.items():
            _load(sd, _join(prefix, name), sub, _group(kind, name))
    else:
        for port_name, flax_name, sub in kind:
            if flax_name in node:
                _load(sd, _join(prefix, port_name), node[flax_name], sub)


def _save(sd: Mapping[str, torch.Tensor], prefix: str, kind: Any) -> Any:
    """Port tensors under ``prefix`` → the flax node of ``kind``."""
    if isinstance(kind, str):
        return _LEAVES[kind][1](sd, prefix)
    below = [k[len(prefix) + 1:] if prefix else k for k in sd
             if not prefix or k.startswith(prefix + ".")]
    if isinstance(kind, tuple):
        names = sorted({k.split(".")[0] for k in below})
        return {name: _save(sd, _join(prefix, name), _group(kind, name)) for name in names}
    present = {k.split(".")[0] for k in below}
    return {flax_name: _save(sd, _join(prefix, port_name), sub)
            for port_name, flax_name, sub in kind if port_name in present}


def _merge(params: Tree, stats: Optional[Tree]) -> Tree:
    """``params`` with the ``batch_stats`` leaves merged in at their paths."""
    if not stats:
        return params
    out = dict(params)
    for key, value in stats.items():
        out[key] = _merge(params.get(key, {}), value) if isinstance(value, Mapping) else value
    return out


def _unwrap(params: Tree, batch_stats: Optional[Tree]) -> Tuple[Tree, Optional[Tree]]:
    """The bare backbone trees of a ``variables`` dict, a params tree or the
    wrapped ``{"backbone": ...}`` tree."""
    if "params" in params:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    if set(params) == {"backbone"}:
        params = params["backbone"]
        batch_stats = (batch_stats or {}).get("backbone", batch_stats)
    return params, batch_stats


def params_from_jax(name: str, params: Tree, batch_stats: Optional[Tree] = None) -> State:
    """A flax params tree (+ ``batch_stats``) of registry model ``name`` →
    the port's state_dict, f32."""
    if name == "swin_unetr":
        return swin_unetr_params_from_jax(params)
    params, batch_stats = _unwrap(params, batch_stats)
    sd: State = {}
    _load(sd, "", _merge(params, batch_stats), MODELS[name])
    return sd


def _split_stats(node: Any) -> Tuple[Any, Any]:
    """A merged tree → (params, batch_stats); the second is {} when empty."""
    if not isinstance(node, Mapping):
        return node, {}
    params, stats = {}, {}
    for key, value in node.items():
        if key in _STATS:
            stats[key] = value
            continue
        p, s = _split_stats(value)
        params[key] = p
        if s:
            stats[key] = s
    return params, stats


def params_to_jax(name: str, state: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's state_dict of registry model ``name`` → the bare flax
    ``(params, batch_stats)`` trees as nested dicts of f32 numpy arrays
    (``batch_stats`` is {} without batch norm). The inverse of
    :func:`params_from_jax`."""
    return _split_stats(_save(state, "", MODELS[name]))


# ---------------------------------------------------------------------------
# SwinUNETR, whose scan_blocks tree stacks each stage's blocks on depth
# ---------------------------------------------------------------------------

def state_from_jax(node: Tree, kind: Any) -> State:
    """One module's flax params (batch_stats merged in) → its port state,
    by its table (``CONV_BLOCK``, ``GATE``, ``SEGMENTATION_HEAD``, ...)."""
    sd: State = {}
    _load(sd, "", node, kind)
    return sd


def window_attention_state(node: Tree) -> State:
    """flax ``WindowAttention`` params → the port's ``WindowAttention`` state."""
    return state_from_jax(node, WINDOW_ATTENTION)


def swin_block_state(node: Tree) -> State:
    """flax ``SwinBlock`` params → the port's ``SwinBlock`` state."""
    return state_from_jax(node, SWIN_BLOCK)


def cross_attention_fusion_state(node: Tree) -> State:
    """flax ``CrossAttentionFusion`` params (no ring) → the port's state."""
    return state_from_jax(node, CROSS_ATTENTION)


def _unstack(node: Any, i: int) -> Any:
    if isinstance(node, Mapping):
        return {k: _unstack(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _depth(node: Any) -> int:
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    return int(np.shape(node)[0])


def swin_unetr_params_from_jax(params: Tree) -> State:
    """Native flax SwinUNETR params (``variables["params"]`` or the whole
    ``variables`` dict, bare or wrapped) → the port's ``SwinUNETR``
    state_dict, f32."""
    params, _ = _unwrap(params, None)
    unrolled = {}
    for key, node in params.items():
        if re.fullmatch(r"stage\d+", key):  # scan_blocks: stacked on depth
            blocks = node["blocks"]
            for b in range(_depth(blocks)):
                unrolled[f"{key}_block{b}"] = _unstack(blocks, b)
        else:
            unrolled[key] = node
    sd: State = {}
    _load(sd, "", unrolled, MODELS["swin_unetr"])
    return sd


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
    params, _ = params_to_jax("swin_unetr", state)
    if not scan_blocks:
        return params
    blocks: Dict[int, Dict[int, Any]] = {}
    for key in list(params):
        block = re.fullmatch(r"stage(\d+)_block(\d+)", key)
        if block:
            blocks.setdefault(int(block.group(1)), {})[int(block.group(2))] = params.pop(key)
    for stage, by_index in blocks.items():
        params[f"stage{stage}"] = {"blocks": _stack([by_index[i] for i in sorted(by_index)])}
    return params


# ---------------------------------------------------------------------------
# tensor-parallel shards
# ---------------------------------------------------------------------------

def shard_state_dict(sd: Mapping[str, torch.Tensor], plan, mesh) -> State:
    """One model rank's shard of a whole state dict: each tensor the plan
    splits cut to the rank's piece (a copy), the rest as they are. ``mesh``
    is a mesh (this rank's model index) or the model index itself."""
    r = mesh if isinstance(mesh, int) else mesh.axis_rank("model")
    splits = plan.splits
    return {k: (splits[k].shard(v, plan.m, r).clone() if k in splits else v)
            for k, v in sd.items()}


def gather_state_dict(shard, plan, mesh=None) -> State:
    """The whole state dict from tensor-parallel shards: ``shard`` a list of
    every model rank's shard in rank order (no collective), or, with
    ``mesh``, this rank's shard, gathered over the mesh's model group (every
    rank of the group calls it and gets the whole)."""
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import _all_gather

    splits = plan.splits
    if mesh is None:
        shards = list(shard)
        return {k: (splits[k].gather([s[k] for s in shards]) if k in splits else v)
                for k, v in shards[0].items()}
    group = mesh.group("model")
    return {k: (splits[k].gather(_all_gather(v, group)) if k in splits else v)
            for k, v in shard.items()}
