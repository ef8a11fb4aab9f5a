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

from multimodal_organ_segmentation_tpu_torch.ops import conv3d
from multimodal_organ_segmentation_tpu_torch.ops.conv3d import conv3x3x3, conv3x3x3_plain
from tests.torch_port_utils import _one_thread  # noqa: F401

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
    before = dict(conv3x3x3.launches)
    assert set(before) == set(conv3d.ROUTES)
    conv3x3x3(x, w)
    conv3x3x3(x.bfloat16(), w.bfloat16())
    assert conv3x3x3.launches == before  # the CPU route launches no kernel


# Ragged shapes for the launch plan: D/H/W below, not a multiple of, and one
# past the 8-voxel tile, a one-voxel axis; C and Cout not multiples of 16
# and 48; batches of 1 and 3; grids cut at the SM count or not.
PLAN_SHAPES = [
    ((1, 5, 7, 3, 8), 8), ((3, 9, 9, 9, 24), 56), ((1, 1, 12, 17, 40), 104),
    ((3, 16, 8, 1, 8), 56), ((1, 10, 1, 20, 24), 8), ((8, 96, 96, 96, 96), 48),
    ((8, 96, 96, 96, 48), 48),
]


@pytest.mark.parametrize("shape,cout", PLAN_SHAPES)
def test_plan_routes_and_fits(shape, cout):
    b, d, h, w, c = shape
    p = conv3d.plan(b, d, h, w, c, cout, torch.bfloat16)
    assert p["route"] == "wgmma" and p["stages"] >= 2 and p["nblock"] == 48
    assert p["smem"] <= conv3d.SMEM_LIMIT and p["smem"] >= p["stages"] * conv3d.STAGE_BYTES
    assert p["threads"] == 288 and p["grid"] == min(p["items"], conv3d.H100_SMS)
    assert p["chunks"] * conv3d.CHUNK >= c > (p["chunks"] - 1) * conv3d.CHUNK
    f = conv3d.plan(b, d, h, w, c, cout, torch.float32)
    assert f["route"] == "f32" and f["smem"] == 0
    assert f["grid"] * f["threads"] >= b * d * h * w * cout // 8 > (f["grid"] - 1) * f["threads"]
    with pytest.raises(TypeError):
        conv3d.plan(b, d, h, w, c, cout, torch.float16)


@pytest.mark.parametrize("shape,cout", PLAN_SHAPES[:5])
@pytest.mark.parametrize("sms", [132, 5])
def test_plan_covers_every_output_once(shape, cout, sms):
    """Every block walks items i, i + grid, ...; the items' tiles and channel
    blocks, cut at the tensor's edges, cover each output voxel x channel
    exactly once."""
    b, d, h, w, c = shape
    p = conv3d.plan(b, d, h, w, c, cout, torch.bfloat16, sms=sms)
    hits = np.zeros((b, d, h, w, cout), np.int32)
    for block in range(p["grid"]):
        for item in range(block, p["items"], p["grid"]):
            bi, d0, h0, w0, n0 = conv3d.item_origin(p, item)
            t = conv3d.TILE
            hits[bi, d0:d0 + t, h0:h0 + t, w0:w0 + t, n0:n0 + p["nblock"]] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("c,cout", [(8, 8), (24, 56), (40, 104), (96, 48)])
def test_pack_weights_matches_an_index_computation(c, cout):
    w = torch.from_numpy(np.random.default_rng(c).normal(size=(3, 3, 3, c, cout)).astype(np.float32))
    packed = conv3d.pack_weights(w)
    nblocks, chunks = -(-cout // 48), -(-c // 16)
    assert tuple(packed.shape) == (nblocks, chunks, 27, 2, 48, 8) and packed.is_contiguous()
    # one (channel block, chunk) piece is one ring stage's weights
    assert packed[0, 0].numel() * 2 == conv3d.STAGE_BYTES - 2 * conv3d.HALO_GROUP_BYTES
    nb, cc, tap, kg, n, j = np.meshgrid(*(np.arange(s) for s in packed.shape), indexing="ij")
    ci, co = cc * 16 + kg * 8 + j, nb * 48 + n
    inside = (ci < c) & (co < cout)
    flat = w.reshape(27, c, cout).numpy()
    want = np.where(inside, flat[tap, np.minimum(ci, c - 1), np.minimum(co, cout - 1)], 0.0)
    np.testing.assert_array_equal(packed.numpy(), want)
