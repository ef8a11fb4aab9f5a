"""The shape-bucketed ``SlidingWindowRunner``, ``bucket_shape`` and
``predictive_entropy``: the port against its own ``sliding_window_inference``
and against the JAX package.

The runner's contract is the JAX docstring's: logits equal to
``sliding_window_inference`` on the original shape. The predict function
here adds the mean over its batch of tiles, so a tile's logits depend on
which tiles share its chunk: equal logits (bit for bit) show the runner
batches the same tiles in the same chunks. Against the JAX runner, the
blend is the same weighted f32 mean: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.ops import sliding_window as jsw
from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as tsw
from tests.torch_port_utils import _one_thread  # noqa: F401

BLEND_TOL = 1e-6
ROI = (16, 16, 16)
CLASSES = 4


def _weights():
    return np.random.default_rng(0).normal(size=(2, CLASSES)).astype(np.float32)


def _t_predict(params, patches):
    w = torch.from_numpy(params)
    return patches @ w + patches.mean(dim=0, keepdim=True) @ w


def _j_predict(params, patches):
    w = jnp.asarray(params)
    return patches @ w + patches.mean(axis=0, keepdims=True) @ w


@pytest.mark.parametrize("shape", [(37, 21, 29), (15, 40, 23)])
@pytest.mark.parametrize("sw", [3, "auto:5"])
def test_runner_logits_equal_sliding_window_bit_for_bit(shape, sw):
    vol = np.random.default_rng(1).normal(size=(*shape, 2)).astype(np.float32)
    w = _weights()
    runner = tsw.SlidingWindowRunner(_t_predict, ROI, CLASSES, overlap=0.5, sw_batch_size=sw)
    out = runner(torch.from_numpy(vol), w)
    n_sw = tsw.resolve_sw_batch(sw, shape, ROI, 0.5)
    ref = tsw.sliding_window_inference(torch.from_numpy(vol), lambda p: _t_predict(w, p), ROI,
                                       CLASSES, 0.5, n_sw, "gaussian")
    assert out.shape == (*shape, CLASSES) and out.dtype == torch.float32
    assert torch.equal(out, ref)
    starts, valid, (bucket, chunks) = runner.grid(shape)
    assert bucket == tsw.bucket_shape(shape, ROI, 0.5)
    assert starts.shape[0] == chunks and valid.sum() == tsw.tile_count(shape, ROI, 0.5)

    jrunner = jsw.SlidingWindowRunner(_j_predict, ROI, CLASSES, overlap=0.5, sw_batch_size=sw)
    j_out = np.asarray(jrunner(jnp.asarray(vol), w))
    np.testing.assert_allclose(out.numpy(), j_out, rtol=BLEND_TOL, atol=BLEND_TOL)


def test_runner_counts_buckets_and_refuses_a_mesh():
    w = _weights()
    runner = tsw.SlidingWindowRunner(_t_predict, ROI, CLASSES, sw_batch_size=4)
    for shape in ((30, 30, 30), (31, 32, 25), (17, 17, 17), (40, 20, 20)):
        runner(torch.zeros((*shape, 2)), w)
    # (30, 30, 30) and (31, 32, 25) share the bucket (32, 32, 32)
    assert runner.num_compiled == 3
    with pytest.raises(NotImplementedError, match="multi-device"):
        tsw.SlidingWindowRunner(_t_predict, ROI, CLASSES, mesh=object())


@pytest.mark.parametrize("shape", [(192, 192, 256), (160, 176, 224), (128, 128, 112),
                                   (96, 96, 96), (50, 97, 145), (1, 300, 191)])
@pytest.mark.parametrize("overlap", [0.5, 0.25, 0.0])
def test_bucket_shape_matches_jax(shape, overlap):
    roi = (96, 96, 96)
    b = tsw.bucket_shape(shape, roi, overlap)
    assert b == jsw.bucket_shape(shape, roi, overlap)
    assert tsw.tile_count(b, roi, overlap) == tsw.tile_count(shape, roi, overlap)


def test_predictive_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 5, 4, 8)).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 0, 0] = np.eye(8, dtype=np.float32)[3]  # certain: entropy 0
    probs[0, 0, 1] = 1.0 / 8  # uniform: entropy 1
    out = tsw.predictive_entropy(torch.from_numpy(probs)).numpy()
    ref = np.asarray(jsw.predictive_entropy(jnp.asarray(probs)))
    np.testing.assert_allclose(out, ref, rtol=BLEND_TOL, atol=BLEND_TOL)
    assert out.shape == (6, 5, 4) and out.min() >= 0 and out.max() <= 1 + 1e-6
    assert abs(out[0, 0, 0]) < 1e-6 and abs(out[0, 0, 1] - 1) < 1e-6
