"""The port's prediction heads against the JAX package's ``models/heads.py``:
same seeded weights, same numpy inputs, f32 on the CPU, within 2e-5 (O(1)
outputs of one or two convs summed in another order)."""

import numpy as np
import pytest
import torch

from multimodal_organ_segmentation_tpu.models import heads as jheads
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.models import heads as theads
from multimodal_organ_segmentation_tpu_torch.models.build import cast_to_compute_dtype
from tests.torch_port_utils import as_np, port, seeded_variables
from tests.torch_port_utils import _one_thread  # noqa: F401

TOL = 2e-5


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kernel_size,activation", [(1, None), (3, "softmax"), (1, "sigmoid")])
def test_segmentation_head(kernel_size, activation):
    x = _normal((2, 5, 4, 3, 6), 0)
    flax_mod = jheads.SegmentationHead(4, kernel_size=kernel_size, activation=activation)
    variables = seeded_variables(flax_mod, x, False, seed=1)
    ref = flax_mod.apply(variables, x, False)
    mod = theads.SegmentationHead(6, 4, kernel_size=kernel_size, activation=activation).eval()
    mod.load_state_dict(convert.state_from_jax(variables["params"], convert.SEGMENTATION_HEAD))
    out = mod(port(x))
    assert out.dtype == torch.float32 and out.shape == (2, 5, 4, 3, 4)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=0, atol=TOL)


def test_deep_supervision_head_resizes_each_scale_to_the_target():
    feats = [_normal((1, 8, 8, 6, 4), 2), _normal((1, 4, 4, 3, 8), 3), _normal((1, 2, 2, 2, 16), 4)]
    flax_mod = jheads.DeepSupervisionHead(5, target_size=(8, 8, 6))
    variables = seeded_variables(flax_mod, feats, False, seed=5)
    ref = flax_mod.apply(variables, feats, False)
    mod = theads.DeepSupervisionHead([4, 8, 16], 5, (8, 8, 6)).eval()
    mod.load_state_dict(convert.state_from_jax(variables["params"], convert.DEEP_SUPERVISION_HEAD))
    outs = mod([port(f) for f in feats])
    assert len(outs) == 3
    for out, r in zip(outs, ref):
        assert out.shape == (1, 8, 8, 6, 5)
        np.testing.assert_allclose(as_np(out), np.asarray(r), rtol=0, atol=TOL)


def test_detection_head():
    x = _normal((2, 4, 4, 3, 6), 6)
    flax_mod = jheads.DetectionHead(3, num_anchors=2, hidden=8)
    variables = seeded_variables(flax_mod, x, False, seed=7)
    ref = flax_mod.apply(variables, x, False)
    mod = theads.DetectionHead(6, 3, num_anchors=2, hidden=8)
    mod.load_state_dict(convert.state_from_jax(variables["params"], convert.DETECTION_HEAD))
    out = mod(port(x))
    assert set(out) == {"cls", "reg"} and out["reg"].shape == (2, 4, 4, 3, 12)
    for key in out:
        np.testing.assert_allclose(as_np(out[key]), np.asarray(ref[key]), rtol=0, atol=TOL)


def test_centernet_head():
    x = _normal((1, 5, 4, 3, 6), 8)
    flax_mod = jheads.CenterNetHead(3, hidden=8)
    variables = seeded_variables(flax_mod, x, False, seed=9)
    ref = flax_mod.apply(variables, x, False)
    mod = theads.CenterNetHead(6, 3, hidden=8)
    mod.load_state_dict(convert.state_from_jax(variables["params"], convert.CENTERNET_HEAD))
    out = mod(port(x))
    assert set(out) == {"heatmap", "offset", "size"} and out["heatmap"].shape == (1, 5, 4, 3, 3)
    for key in out:
        np.testing.assert_allclose(as_np(out[key]), np.asarray(ref[key]), rtol=0, atol=TOL)


def test_output_convs_stay_f32_in_a_bf16_model():
    """The heads' output convs compute in f32 (the JAX heads cast to f32),
    so the serving cast leaves their weights f32 and the hidden convs go to
    the compute dtype."""
    heads = torch.nn.ModuleDict({"det": theads.DetectionHead(6, 3, hidden=8),
                                 "cn": theads.CenterNetHead(6, 3, hidden=8),
                                 "seg": theads.SegmentationHead(6, 4)})
    cast_to_compute_dtype(heads, torch.bfloat16)
    dtypes = {n: p.dtype for n, p in heads.named_parameters()}
    assert dtypes["det.conv.weight"] == dtypes["cn.size_conv.weight"] == torch.bfloat16
    for name in ("det.cls_head.weight", "det.reg_head.bias", "cn.heatmap_out.weight",
                 "cn.offset_out.weight", "seg.out_conv.weight"):
        assert dtypes[name] == torch.float32, name
    x = port(_normal((1, 4, 4, 4, 6), 10), torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in heads["det"](x).values())
