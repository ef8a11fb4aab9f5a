"""Model factory (port of the JAX package's ``models/build.py``).

``MODEL_REGISTRY`` maps every ``model.name`` of the JAX package to its
builder. ``build_model`` builds on the CUDA device unless the caller names
another device, and raises when there is no CUDA device rather than
carrying on on the CPU. Weights are drawn from an explicit
``torch.Generator`` with flax's default initialisers. For serving they are
then stored in the compute dtype of ``hardware.mixed_precision``; for
training (``train=True``) they stay f32 master weights and every op casts
them to the compute dtype, as flax does.

``build_model`` returns the backbone itself, without the JAX package's
``MultiModalSegmentationModel`` wrapper, which only forwards ``capture``.
Every model lists its perturbation points (the explainability code's
gradients) and takes a ``perturb`` dict in ``forward``; they add no parameter
or buffer, so ``model.enable_perturb``, which flax needs to create its
perturbation variables, is accepted and ignored. The explainability code
names the points as the wrapped flax tree does (``backbone/<point>``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Union

import torch
from torch import nn

from multimodal_organ_segmentation_tpu_torch.models.attention_unet import build_attention_unet
from multimodal_organ_segmentation_tpu_torch.models.dual_encoder import build_dual_encoder
from multimodal_organ_segmentation_tpu_torch.models.layers import Norm3D
from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import (
    WindowAttention,
    build_swin_unetr,
)
from multimodal_organ_segmentation_tpu_torch.models.unet3d import build_unet3d
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

MODEL_REGISTRY: Dict[str, Callable] = {
    "swin_unetr": build_swin_unetr,
    "unet": build_unet3d,
    "unet3d": build_unet3d,
    "attention_unet": build_attention_unet,
    "dual_encoder": build_dual_encoder,
}

# parameters the JAX models compute in f32 whatever the compute dtype: the
# output and deep-supervision heads (and the heads' output convs), and the
# relative-position tables (kernel A takes an f32 bias)
_F32_PARAMS = re.compile(r"(^|\.)(out_conv|ds_head\d+|cls_head|reg_head|\w+_out)\.|rel_pos_bias$")
_LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def compute_dtype(config) -> torch.dtype:
    mp = str(config.get("hardware.mixed_precision", "bf16")).lower()
    if mp in ("bf16", "bfloat16", "true", "mixed"):
        return torch.bfloat16
    return torch.float32


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults: truncated lecun-normal kernels, zero biases, unit
    norms, and a 0.02 truncated normal for the relative-position tables."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d, nn.ConvTranspose3d)):
                w = m.weight
                fan_in = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.ConvTranspose3d) else w[0].numel()
                std = fan_in**-0.5 / _LECUN_TRUNC
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.rel_pos_bias, std=0.02, a=-0.04, b=0.04, generator=generator)
            elif isinstance(m, Norm3D) and m.norm in ("group", "batch"):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if m.norm == "batch":
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)


def cast_to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> None:
    """Store the weights in the compute dtype (the serving choice: flax
    casts its f32 params per op, which gives the same values). What the JAX
    model computes in f32 stays f32: the output and deep-supervision heads,
    the relative-position tables, and the norms' running statistics (buffers,
    which this leaves alone)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not _F32_PARAMS.search(name):
                p.data = p.data.to(dtype)


def get_model(name: str) -> Callable:
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def model_input_channels(config) -> int:
    """Channel count of the stacked-modalities input tensor."""
    return len(config.get("data.modalities", ["CT", "PET"]))


def build_model(
    config: Union[ConfigNode, Mapping],
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
) -> nn.Module:
    """Build the configured model on ``device`` (CUDA when None).
    ``generator`` (a CPU generator) draws the initial weights; by default one
    seeded with ``experiment.seed``. ``train=False`` returns the serving
    model: eval mode, weights stored in the compute dtype. ``train=True``
    returns the training model: train mode, f32 master weights that each op
    casts to the compute dtype (``freeze_for_inference`` of the trainer turns
    it into the serving model)."""
    config = config if isinstance(config, ConfigNode) else ConfigNode(dict(config))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_model: no CUDA device; pass device='cpu' to run the port on the CPU"
            )
        device = "cuda"
    name = str(config.get("model.name", "swin_unetr")).lower()
    dtype = compute_dtype(config)
    model = get_model(name)(config, dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.get("experiment.seed", 0)))
    init_weights(model, generator)
    model.to(device)
    if train:
        return model.train()
    cast_to_compute_dtype(model, dtype)
    return model.eval()
