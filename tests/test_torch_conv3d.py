"""Kernel C's plain version, ``conv3x3x3_plain`` (what ``conv3x3x3`` runs on a
CPU tensor and what the CUDA kernel is held against on the card), against
the JAX convolution as ``scripts/proto_conv_kernel.py::conv3d_native`` builds
it, and against the TPU kernel ``conv3x3x3_pallas`` in interpret mode at the
script's ``[2, 16, 16, 16, 8]`` shape.

Tolerances: f32 1e-4 (the script's own, ``proto_conv_kernel.py:159``; 216
products of O(0.1) summed in another order); bf16 2e-2 on outputs below 2
(both round one f32 sum to bf16, where one ulp is 7.8e-3).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu_torch.ops.conv3d import conv3x3x3, conv3x3x3_plain

REPO = Path(__file__).resolve().parents[1]


def conv3d_native(x, w):
    """Re-stated from ``scripts/proto_conv_kernel.py:127-130``."""
    return jax.lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC")
    )


def _inputs(shape, cout, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (scale * rng.normal(size=(3, 3, 3, shape[-1], cout))).astype(np.float32)
    return x, w


@pytest.mark.parametrize(
    "shape,cout",
    [((2, 16, 16, 16, 8), 8), ((1, 5, 7, 9, 8), 16), ((2, 3, 1, 4, 16), 8), ((1, 6, 6, 6, 3), 5)],
)
def test_plain_matches_jax_conv_f32(shape, cout):
    """Odd D/H/W, a one-voxel axis, and channel counts the kernel would refuse."""
    x, w = _inputs(shape, cout)
    ref = np.asarray(conv3d_native(jnp.asarray(x), jnp.asarray(w)))
    out = conv3x3x3(torch.from_numpy(x), torch.from_numpy(w))  # a CPU tensor: the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_plain_matches_jax_conv_bf16():
    x, w = _inputs((2, 8, 8, 8, 16), 8, seed=1, scale=0.3 / np.sqrt(27 * 16))
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    ref = conv3d_native(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    out = conv3x3x3_plain(xb, wb)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(ref).max() < 2.0
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2e-2)
    # against the f32-accumulated result of the same bf16 inputs
    exact = conv3x3x3_plain(xb.float(), wb.float())
    np.testing.assert_allclose(out.float().numpy(), exact.numpy(), rtol=0, atol=2e-2)


def test_plain_matches_the_pallas_kernel_in_interpret_mode():
    """The TPU kernel itself, run as its script's ``--interpret`` stage runs it."""
    spec = importlib.util.spec_from_file_location(
        "proto_conv_kernel", REPO / "scripts" / "proto_conv_kernel.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    x, w = _inputs((2, 16, 16, 16, 8), 8, seed=2)
    ref = np.asarray(script.conv3x3x3_pallas(jnp.asarray(x), jnp.asarray(w), dt=8, ht=8,
                                             interpret=True))
    out = conv3x3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_f64_stays_f64():
    x, w = _inputs((1, 4, 4, 4, 2), 3, seed=3)
    out = conv3x3x3_plain(torch.from_numpy(x).double(), torch.from_numpy(w).double())
    ref = np.asarray(conv3d_native(jnp.asarray(x), jnp.asarray(w)))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_bad_shapes_and_dtypes_raise():
    x, w = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 4, 8), 8))
    with pytest.raises(ValueError):
        conv3x3x3(x[0], w)
    with pytest.raises(ValueError):
        conv3x3x3(x, w[:, :, :, :4])
    with pytest.raises(ValueError):
        conv3x3x3(x, w[:2])
    with pytest.raises(TypeError):
        conv3x3x3(x, w.bfloat16())


def test_launch_counter_counts_kernel_launches_only():
    x, w = (torch.from_numpy(a) for a in _inputs((1, 4, 4, 4, 8), 8))
    before = conv3x3x3.launches
    conv3x3x3(x, w)
    assert conv3x3x3.launches == before  # the CPU route launches no kernel
