"""Sliding-window inference: the port's host grid, blend and labels against
the JAX package's, and the slice as a whole.

The slice test builds the flagship's structure narrow (fs=12, 6³ windows,
fusion at stages 1-3, 2 channels, 8 classes), converts the same seeded
params into the port, and runs ``sliding_window_inference`` +
``predict_labels`` on a 40×40×32 volume with a 32³ ROI (4 tiles in chunks
of 3, so the last chunk holds two padded slots). The JAX reference runs
once, on the unrolled tree; the port loads those params from the unrolled
tree and, restacked along depth, from the ``scan_blocks`` tree.

Tolerances: the blend alone is a weighted mean of the same f32 numbers,
summed in the same tile order: 1e-6. The whole slice runs ~40 f32 layers on
each side in another summation order: 1e-4 on the logits; labels must
agree wherever the JAX logits' top-2 margin exceeds twice that.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.models import swin_unetr as jswin
from multimodal_organ_segmentation_tpu.ops import sliding_window as jsw
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as tsw
from tests.torch_port_utils import as_np, no_tf32, port, seeded_variables
from tests.torch_port_utils import _one_thread  # noqa: F401

BLEND_TOL = 1e-6
SLICE_TOL = 1e-4


def test_flagship_grid_has_45_tiles_in_3_chunks():
    shape, roi = (192, 192, 256), (96, 96, 96)
    assert tsw.tile_count(shape, roi, 0.5) == 45
    starts, valid = tsw.make_tile_grid(shape, roi, 0.5, 15)
    assert starts.shape == (3, 15, 3) and valid.all()
    assert tsw.resolve_sw_batch("auto:16", shape, roi, 0.5) == 15


@pytest.mark.parametrize("shape", [(192, 192, 256), (40, 40, 40), (20, 70, 33), (300, 96, 97)])
@pytest.mark.parametrize("overlap", [0.0, 0.25, 0.5, 0.625])
def test_grid_rules_match_jax(shape, overlap):
    roi = (32, 64, 32) if shape[0] < 100 else (96, 96, 96)
    assert tsw.tile_count(shape, roi, overlap) == jsw.tile_count(shape, roi, overlap)
    for sw in (1, 3, 4, 15):
        for mc, cm in ((0, 1), (5, 1), (0, 4)):
            a = tsw.make_tile_grid(shape, roi, overlap, sw, min_chunks=mc, chunk_multiple=cm)
            b = jsw.make_tile_grid(shape, roi, overlap, sw, min_chunks=mc, chunk_multiple=cm)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_chunk_size_rules_match_jax():
    for n in (1, 7, 27, 36, 45, 64, 100):
        for target in (1, 4, 12, 15, 16):
            for cm in (1, 2, 8):
                assert tsw.auto_sw_batch_size(n, target, chunk_multiple=cm) == \
                    jsw.auto_sw_batch_size(n, target, chunk_multiple=cm)
    for value in (None, 6, "9", "auto", "AUTO:12"):
        assert tsw.resolve_sw_batch(value, (192, 192, 256), (96, 96, 96), 0.5) == \
            jsw.resolve_sw_batch(value, (192, 192, 256), (96, 96, 96), 0.5)
    np.testing.assert_array_equal(
        tsw.gaussian_importance_map((96, 64, 7)), jsw.gaussian_importance_map((96, 64, 7))
    )


@pytest.mark.parametrize("mode", ["gaussian", "constant"])
@pytest.mark.parametrize("shape,roi,sw", [((40, 40, 40), (32, 32, 32), 3),
                                          ((20, 50, 36), (24, 24, 24), 4)])
def test_blend_matches_jax(mode, shape, roi, sw):
    """A linear per-voxel predict_fn (C → K); the second shape is smaller
    than the ROI along one axis, so the volume is padded and cropped."""
    rng = np.random.default_rng(0)
    vol = rng.normal(size=(*shape, 2)).astype(np.float32)
    w = rng.normal(size=(2, 5)).astype(np.float32)
    ref = jsw.sliding_window_inference(
        jnp.asarray(vol), lambda p: p @ jnp.asarray(w), roi, 5, 0.5, sw, mode
    )
    out = tsw.sliding_window_inference(port(vol), lambda p: p @ port(w), roi, 5, 0.5, sw, mode)
    assert out.dtype == torch.float32 and out.shape == (*shape, 5)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=BLEND_TOL, atol=BLEND_TOL)


def test_batched_volume_and_labels_match_jax():
    rng = np.random.default_rng(1)
    vols = rng.normal(size=(2, 20, 20, 20, 2)).astype(np.float32)
    w = rng.normal(size=(2, 4)).astype(np.float32)
    ref = jsw.sliding_window_inference(jnp.asarray(vols), lambda p: p @ jnp.asarray(w),
                                       (16, 16, 16), 4, 0.5, 2)
    out = tsw.sliding_window_inference(port(vols), lambda p: p @ port(w), (16, 16, 16), 4, 0.5, 2)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=BLEND_TOL, atol=BLEND_TOL)

    def j_run(v):
        return jsw.sliding_window_inference(v, lambda p: p @ jnp.asarray(w), (16, 16, 16), 4)

    def t_run(v):
        return tsw.sliding_window_inference(v, lambda p: p @ port(w), (16, 16, 16), 4)

    for tta in (False, True):
        jl, jp = jsw.predict_labels(j_run, jnp.asarray(vols[0]), tta=tta, return_probs=True)
        tl, tp = tsw.predict_labels(t_run, port(vols[0]), tta=tta, return_probs=True)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(as_np(tp), np.asarray(jp), rtol=BLEND_TOL, atol=BLEND_TOL)


def _slice_config(scan_blocks):
    return {
        "experiment": {"seed": 0},
        "data": {"modalities": ["CT", "PET"]},
        "model": {
            "name": "swin_unetr", "in_channels": 2, "out_channels": 8,
            "backbone": {"img_size": [32, 32, 32], "feature_size": 12, "depths": [2, 2, 2, 2],
                         "num_heads": [3, 6, 12, 24], "window_size": [6, 6, 6],
                         "scan_blocks": scan_blocks},
            "fusion": {"type": "cross_attention", "stages": [1, 2, 3]},
            "head": {"type": "conv", "dropout": 0.0},
        },
        "hardware": {"mixed_precision": "fp32"},
    }


SLICE_VOLUME = (40, 40, 32)


def _scan_tree(params):
    """The ``scan_blocks`` form of an unrolled SwinUNETR param tree: each
    stage's ``stage{s}_block{b}`` leaves stacked along a leading depth axis
    under ``stage{s}/blocks``."""
    stages = {}
    out = {}
    for key, value in params.items():
        m = re.fullmatch(r"stage(\d+)_block(\d+)", key)
        if m:
            stages.setdefault(f"stage{m.group(1)}", {})[int(m.group(2))] = value
        else:
            out[key] = value
    for stage, blocks in stages.items():
        ordered = [blocks[b] for b in sorted(blocks)]
        out[stage] = {"blocks": jax.tree_util.tree_map(lambda *a: np.stack(a), *ordered)}
    return out


@pytest.fixture(scope="module")
def jax_slice():
    """The JAX package's slice on the unrolled tree: the volume, the params,
    the logits and the labels."""
    roi, sw, classes = (32, 32, 32), 3, 8
    vol = np.random.default_rng(2).normal(size=(*SLICE_VOLUME, 2)).astype(np.float32)
    flax_model = jswin.build_swin_unetr(ConfigNode(_slice_config(False)))
    variables = seeded_variables(flax_model, vol[None, :32, :32, :32], train=False, seed=3)

    def j_predict(params, patches):
        return flax_model.apply(params, patches, train=False)

    j_logits = jsw.sliding_window_inference(
        jnp.asarray(vol), j_predict, roi, classes, 0.5, sw, "gaussian", params=variables
    )
    j_labels = np.asarray(jsw.predict_labels(lambda v: j_logits, jnp.asarray(vol)))
    return vol, variables, np.asarray(j_logits), j_labels


def test_scan_tree_restacks_the_unrolled_blocks(jax_slice):
    _, variables, _, _ = jax_slice
    scan = _scan_tree(variables["params"])
    assert sorted(k for k in scan if k.startswith("stage")) == [f"stage{s}" for s in range(4)]
    leaf = scan["stage1"]["blocks"]
    first = jax.tree_util.tree_leaves(leaf)[0]
    assert first.shape[0] == 2
    np.testing.assert_array_equal(
        first[1], jax.tree_util.tree_leaves(variables["params"]["stage1_block1"])[0])


@pytest.mark.parametrize("scan_blocks", [False, True])
def test_slice_matches_jax(scan_blocks, jax_slice):
    no_tf32()
    roi, sw, classes = (32, 32, 32), 3, 8
    vol, variables, j_logits, j_labels = jax_slice
    assert tsw.tile_count(SLICE_VOLUME, roi, 0.5) == 4
    params = _scan_tree(variables["params"]) if scan_blocks else variables["params"]

    model = build_model(_slice_config(scan_blocks), device="cpu")
    model.load_state_dict(convert.swin_unetr_params_from_jax({"params": params}))
    t_logits = tsw.sliding_window_inference(port(vol), model, roi, classes, 0.5, sw, "gaussian")
    t_labels = tsw.predict_labels(lambda v: t_logits, port(vol)).numpy()

    assert t_logits.shape == (*SLICE_VOLUME, classes) and torch.isfinite(t_logits).all()
    np.testing.assert_allclose(as_np(t_logits), j_logits, rtol=SLICE_TOL, atol=SLICE_TOL)
    top2 = np.sort(j_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * SLICE_TOL
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(t_labels[clear], j_labels[clear])
