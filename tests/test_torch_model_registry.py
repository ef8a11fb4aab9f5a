"""The port's model registry against the JAX package's: every shipped config
builds through the port, and each config whose model is a UNet3D or a
DualEncoder has the JAX model's parameter count at full width
(``jax.eval_shape``: no compute)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from multimodal_organ_segmentation_tpu.models import build as jbuild
from multimodal_organ_segmentation_tpu.utils.config import load_config as jload_config
from multimodal_organ_segmentation_tpu_torch.models import build as tbuild
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from multimodal_organ_segmentation_tpu_torch.utils.config import load_config
from tests.torch_port_utils import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))
COUNTED = ["tiny_cpu.yaml", "unet3d_ct_64.yaml", "unet3d_earlyfusion_96.yaml",  # UNet3D
           "dual_encoder_xattn_128.yaml", "full_pipeline_4mod.yaml"]  # DualEncoder


def _jax_param_count(name: str) -> int:
    """The JAX model's parameter count, from shapes alone. The config's
    ``parallel.sequence_axis`` is dropped, as the JAX builder drops it on
    one device: with the suite's 8 host devices it would take the ring
    path, whose larger token budget attends at one more level."""
    cfg = jload_config(REPO / "configs" / name)
    cfg.set("parallel.sequence_axis", None)
    model = jbuild.build_model(cfg)
    img = tuple(cfg.get("model.backbone.img_size"))
    x = jax.ShapeDtypeStruct((1, *img, jbuild.model_input_channels(cfg)), np.float32)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False), jax.random.key(0), x)
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))


def test_the_registry_names_every_jax_model():
    assert set(tbuild.MODEL_REGISTRY) == set(jbuild.MODEL_REGISTRY)
    with pytest.raises(ValueError, match="Unknown model"):
        tbuild.get_model("vnet")
    cfg = load_config(REPO / "configs" / "full_pipeline_4mod.yaml")
    assert tbuild.model_input_channels(cfg) == jbuild.model_input_channels(cfg) == 4


@pytest.mark.parametrize("name", CONFIGS)
def test_every_shipped_config_builds(name):
    """The configs of this slice's models through ``build_model`` (seeded
    init included), with the JAX model's parameter count; the SwinUNETR
    configs, whose model earlier slices hold to the JAX package at small
    sizes, through their registry builder alone (the init of 70 M weights
    on one CPU thread takes seconds and shows nothing more)."""
    cfg = load_config(REPO / "configs" / name)
    if name in COUNTED:
        model = build_model(cfg, device="cpu", train=True)
        assert sum(p.numel() for p in model.parameters()) == _jax_param_count(name), name
    else:
        model = tbuild.get_model(cfg.get("model.name"))(cfg, tbuild.compute_dtype(cfg))
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("name", ["unet", "unet3d", "attention_unet", "dual_encoder"])
def test_each_builder_needs_cuda_without_a_device(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"model": {"name": name, "backbone": {"features": [4, 8], "img_size": [8, 8, 8]}}}
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    assert build_model(cfg, device="cpu") is not None


def test_serving_cast_keeps_what_the_jax_models_compute_in_f32():
    """bf16 serving weights, but the output and deep-supervision heads and
    the batch norms' running statistics stay f32."""
    cfg = {"model": {"name": "unet3d", "out_channels": 3,
                     "backbone": {"features": [4, 8, 16], "norm": "batch"},
                     "head": {"type": "deep_supervision"}},
           "hardware": {"mixed_precision": "bf16"}}
    model = build_model(cfg, device="cpu")
    assert not model.training
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    for name, dtype in dtypes.items():
        want = torch.float32 if name.startswith(("out_conv.", "ds_head")) else torch.bfloat16
        assert dtype == want, name
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    norm = model.init_conv.norm1
    assert torch.equal(norm.running_mean, torch.zeros(4)) and torch.equal(norm.running_var, torch.ones(4))
    out = model(torch.zeros(1, 16, 16, 16, 2))
    assert out.dtype == torch.float32 and out.shape == (1, 16, 16, 16, 3)
