"""Surface, lesion and calibration metrics, the native EDT and the
postprocess: the port against the JAX package (and the EDT against scipy,
its plain version).

The surface metrics are host numpy in both packages on the same distances,
so they agree exactly; the EDT kernel is the same C++ source, held to
scipy's exact transform to 1e-12. ECE's per-bin sums run in f64 on the
device in the port and in f32 chunks in JAX: 1e-6. Every metric sees
empty classes (absent from prediction, ground truth or both) and an empty
case.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.ops import postprocess as jpp
from multimodal_organ_segmentation_tpu.train import metrics as jm
from multimodal_organ_segmentation_tpu_torch.ops import edt as tedt
from multimodal_organ_segmentation_tpu_torch.ops import postprocess as tpp
from multimodal_organ_segmentation_tpu_torch.train import metrics as tm
from tests.torch_port_utils import _one_thread  # noqa: F401

EDT_TOL = 1e-12
ECE_TOL = 1e-6
CLASSES = 5
SHAPE = (18, 16, 14)


def _blobs(seed, shape=SHAPE, classes=CLASSES, absent=()):
    """A label map of a few ellipsoid 'organs' plus scattered islands."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*(np.arange(n) for n in shape), indexing="ij"), -1)
    lab = np.zeros(shape, np.int32)
    for c in range(1, classes):
        if c in absent:
            continue
        center = rng.uniform(3, np.array(shape) - 3)
        radii = rng.uniform(2, 5, size=3)
        lab[(((grid - center) / radii) ** 2).sum(-1) <= 1] = c
    islands = rng.integers(0, np.array(shape), size=(6, 3))
    lab[tuple(islands.T)] = rng.integers(1, classes, 6)
    for c in absent:
        lab[lab == c] = 0
    return lab


@pytest.fixture(scope="module")
def cases():
    """(pred, gt) pairs: overlapping, a class missing from the prediction,
    one missing from the ground truth, both missing one, and an empty case."""
    return [
        (_blobs(1), _blobs(2)),
        (_blobs(3, absent=(2,)), _blobs(3)),
        (_blobs(4), _blobs(5, absent=(1, 3))),
        (_blobs(6, absent=(4,)), _blobs(7, absent=(4,))),
        (np.zeros(SHAPE, np.int32), np.zeros(SHAPE, np.int32)),
        (np.zeros(SHAPE, np.int32), _blobs(8)),
    ]


@pytest.mark.parametrize("sampling", [None, (1.5, 0.8, 2.5), 0.7])
@pytest.mark.parametrize("density", [0.02, 0.5])
def test_native_edt_matches_scipy(sampling, density):
    rng = np.random.default_rng(0)
    arr = rng.random((21, 17, 30)) > density
    out = tedt.distance_transform_edt(arr, sampling=sampling)
    ref = ndimage.distance_transform_edt(arr, sampling=sampling)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref, rtol=0, atol=EDT_TOL)
    assert tedt.library_path().exists()


def test_edt_raises_instead_of_falling_back(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="3D"):
        tedt.distance_transform_edt(np.ones((4, 4)))
    monkeypatch.setattr(tedt, "_lib", None)
    monkeypatch.setattr(tedt, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="compiler"):
        tedt.distance_transform_edt(np.ones((4, 4, 4)))


@pytest.mark.parametrize("spacing", [None, (1.2, 0.9, 2.0)])
def test_surface_metrics_match_jax(cases, spacing):
    port = (tm.HausdorffDistance(95), tm.SurfaceDice(CLASSES, tolerance_mm=1.5),
            tm.AverageSurfaceDistance(CLASSES))
    ref = (jm.HausdorffDistance(95), jm.SurfaceDice(CLASSES, tolerance_mm=1.5),
           jm.AverageSurfaceDistance(CLASSES))
    for pred, gt in cases:
        cache_t, cache_j = {}, {}
        port[0].update(pred[None], gt[None], spacing=spacing)
        ref[0].update(pred[None], gt[None], spacing=spacing)
        for t, j, ct, cj in ((port[1], ref[1], cache_t, cache_j),
                             (port[2], ref[2], cache_t, cache_j)):
            t.update(pred[None], gt[None], spacing=spacing, distance_cache=ct)
            j.update(pred[None], gt[None], spacing=spacing, distance_cache=cj)
    assert port[0].distances == ref[0].distances and len(port[0].distances) == 4
    for t, j in zip(port, ref):
        a, b = t.compute(), j.compute()
        assert a.keys() == b.keys()
        np.testing.assert_equal(a, b)
    for t, j in zip(port[1:], ref[1:]):
        assert t._scores == j._scores
    # an empty class contributes nothing: nan per class, not 0
    assert np.isnan(port[1].compute()["surface_dice_per_class"][0])


def test_hausdorff_of_no_pair_is_inf():
    empty = np.zeros((1, *SHAPE), np.int32)
    h = tm.HausdorffDistance()
    h.update(empty, empty)
    assert h.compute() == jm.HausdorffDistance().compute() == {"hausdorff_distance": float("inf")}
    for cls in (tm.SurfaceDice, tm.AverageSurfaceDistance):
        out = cls(CLASSES).compute()
        assert all(np.isnan(v) for v in out.values() if isinstance(v, float) and v != 2.0)


@pytest.mark.parametrize("threshold,classes", [(0.0, None), (0.3, [2, 4])])
def test_lesion_detection_matches_jax(cases, threshold, classes):
    t = tm.LesionDetectionMetric(CLASSES, overlap_threshold=threshold, classes=classes)
    j = jm.LesionDetectionMetric(CLASSES, overlap_threshold=threshold, classes=classes)
    for pred, gt in cases:
        assert t.update(pred[None], gt[None]) == j.update(pred[None], gt[None])
    np.testing.assert_equal(t.compute(), j.compute())
    empty = tm.LesionDetectionMetric(CLASSES).compute()
    assert np.isnan(empty["lesion_f1"]) and empty["lesion_tp"] == 0


def test_calibration_error_matches_jax(cases):
    rng = np.random.default_rng(9)
    t, j = tm.CalibrationError(n_bins=10), jm.CalibrationError(n_bins=10)
    for _, gt in cases[:4]:
        logits = rng.normal(size=(*SHAPE, CLASSES)).astype(np.float32) * 2
        logits[..., 1] += 1.5
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        a = t.update(torch.from_numpy(probs), torch.from_numpy(gt))
        b = j.update(jnp.asarray(probs), jnp.asarray(gt))
        assert abs(a - b) <= ECE_TOL
    np.testing.assert_allclose(t.count, j.count, rtol=0, atol=0)
    np.testing.assert_allclose(t.conf_sum, j.conf_sum, rtol=ECE_TOL)
    np.testing.assert_allclose(t.correct_sum, j.correct_sum, rtol=0, atol=0)
    a, b = t.compute(), j.compute()
    assert a["ece_bins"] == b["ece_bins"] == 10 and abs(a["ece"] - b["ece"]) <= ECE_TOL
    assert np.isnan(tm.CalibrationError().compute()["ece"])


def test_get_metrics_matches_jax():
    from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    cfg = {"model": {"out_channels": 6}}
    t, j = tm.get_metrics(ConfigNode(cfg)), jm.get_metrics(JConfig(cfg))
    assert t.keys() == j.keys() and t["dice"].num_classes == 6


@pytest.mark.parametrize("kwargs", [{}, {"classes": [1, 3]}, {"min_voxels": 20},
                                    {"classes": [2], "min_voxels": 400}])
def test_keep_largest_components_matches_jax(cases, kwargs):
    for pred, _ in cases:
        out = tpp.keep_largest_components(pred, **kwargs)
        np.testing.assert_array_equal(out, jpp.keep_largest_components(pred, **kwargs))
    cfg = {"inference": {"postprocess": {"largest_component": True, "min_voxels": 5}}}
    from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    pred = cases[0][0]
    np.testing.assert_array_equal(tpp.postprocess_from_config(pred, ConfigNode(cfg)),
                                  jpp.postprocess_from_config(pred, JConfig(cfg)))
    assert tpp.postprocess_from_config(pred, ConfigNode({})) is pred
