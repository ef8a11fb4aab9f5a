"""Kernel A's plain version (``dense_window_mha``) against the JAX package.

The port's ``dense_window_mha`` is held against the Pallas kernel run in
interpret mode (``_window_mha_fwd_impl(..., interpret=True)``, as
``tests/test_window_mha.py`` runs it) and against the JAX dense formula.
The CUDA kernel itself runs only on the card (``chip_smoke.py``); here the
wrapper's dispatch and input checks are tested on CPU tensors, and its
route and launch plan (``plan``) as plain Python.

Tolerances: f32 2e-5 (the two packages sum the N-long dot products and the
softmax denominator in a different order; the values are O(1)); bf16 2e-2
(inputs and output rounded to bf16's 8-bit mantissa, ~4e-3 relative per
rounding), as in ``tests/test_window_mha.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke

from multimodal_organ_segmentation_tpu.ops.pallas import window_attention as jwa
from multimodal_organ_segmentation_tpu_torch.ops import window_attention as twa
from tests.torch_port_utils import as_np, port
from tests.torch_port_utils import _one_thread  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(bw, n, h, d, nw, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bw, n, h, d)).astype(np.float32) for _ in range(3))
    bias = (rng.normal(size=(h, n, n)) * 0.1).astype(np.float32)
    mask = None
    if with_mask:
        # shift-style mask: blocks of 0 / -100 like the real swin mask
        mask = rng.choice([0.0, -100.0], size=(nw, n, n), p=[0.8, 0.2]).astype(np.float32)
    return q, k, v, bias, mask


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _port(a, dtype=torch.float32):
    return None if a is None else port(a, dtype)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize(
    "bw,n,h,d,nw",
    [
        (8, 343, 3, 16, 4),  # 7³ windows, head_dim 16
        (6, 27, 2, 8, 3),  # tiny odd shapes
        (4, 128, 4, 32, 2),  # exact lane multiples
        (4, 216, 3, 16, 2),  # the flagship's 6³ windows, head_dim 16
    ],
)
def test_dense_window_mha_matches_jax(bw, n, h, d, nw, with_mask):
    q, k, v, bias, mask = _inputs(bw, n, h, d, nw, with_mask)
    jargs = (_jax(q), _jax(k), _jax(v), _jax(bias), _jax(mask), nw)
    pallas = np.asarray(jwa._window_mha_fwd_impl(*jargs, interpret=True))
    dense = np.asarray(jwa.dense_window_mha(*jargs))
    out = as_np(twa.dense_window_mha(port(q), port(k), port(v), port(bias), _port(mask), nw))
    np.testing.assert_allclose(out, pallas, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(out, dense, rtol=F32_TOL, atol=F32_TOL)


def test_dense_window_mha_bf16_matches_pallas():
    q, k, v, bias, mask = _inputs(4, 216, 3, 16, 2, True)
    pallas = jwa._window_mha_fwd_impl(
        _jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16), _jax(v, jnp.bfloat16),
        _jax(bias), _jax(mask), 2, interpret=True,
    )
    out = twa.dense_window_mha(
        port(q, torch.bfloat16), port(k, torch.bfloat16), port(v, torch.bfloat16),
        port(bias), port(mask), 2,
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        as_np(out), np.asarray(pallas, np.float32), rtol=BF16_TOL, atol=BF16_TOL
    )


def test_window_mha_on_cpu_runs_the_plain_version():
    q, k, v, bias, mask = _inputs(6, 27, 2, 8, 3, True)
    before = dict(twa.window_mha.launches)
    out = twa.window_mha(port(q), port(k), port(v), port(bias), port(mask), 3)
    ref = twa.dense_window_mha(port(q), port(k), port(v), port(bias), port(mask), 3)
    assert torch.equal(out, ref)
    assert twa.window_mha.launches == before  # only a kernel launch counts


def test_window_mha_takes_strided_qkv_views():
    """The model hands the kernel q, k, v as slices of one qkv projection."""
    rng = np.random.default_rng(1)
    qkv = port(rng.normal(size=(4, 27, 3, 2, 8)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    bias = port((0.1 * rng.normal(size=(2, 27, 27))).astype(np.float32))
    twa._check_inputs(q, k, v, bias, None, 1)
    out = twa.window_mha(q, k, v, bias, None, 1)
    ref = twa.dense_window_mha(q.contiguous(), k.contiguous(), v.contiguous(), bias, None, 1)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(n=513), ValueError),  # more tokens than a lane's 16 keys
        (dict(d=12), ValueError),  # head dim not a multiple of 8
        (dict(d=72), ValueError),  # head dim above 64
        (dict(dtype=torch.float16), TypeError),
        (dict(mask_windows=3), ValueError),  # mask is [nW, N, N] with nW = 2
        (dict(bias_dtype=torch.bfloat16), ValueError),
        (dict(bw=5), ValueError),  # BW not a multiple of nW
    ],
)
def test_kernel_input_checks(change, error):
    """The CUDA wrapper's checks raise on what the kernel does not take."""
    bw, n, h, d = change.get("bw", 4), change.get("n", 27), 2, change.get("d", 8)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros((bw, n, h, d), dtype=dtype)
    bias = torch.zeros((h, n, n), dtype=change.get("bias_dtype", torch.float32))
    mask = torch.zeros((change.get("mask_windows", 2), n, n))
    with pytest.raises(error):
        twa._check_inputs(q, q, q, bias, mask, 2)


# ---- route and launch plan ---------------------------------------------


@pytest.mark.parametrize("tiles", [15, 2], ids=["serving_chunk", "training_micro_batch"])
def test_every_flagship_bf16_shape_takes_the_mma_route(tiles):
    for stage, bw, heads, nw, _, w in chip_smoke.window_shapes(tiles):
        p = twa.plan(bw, w**3, heads, 16, nw or 1, torch.bfloat16)
        assert p["route"] == "mma", (stage, bw, heads, nw)
        assert p["threads"] == 224 and p["rows"] == 112  # 2 blocks of 7 warps cover N = 216


@pytest.mark.parametrize("tiles", [15, 2], ids=["serving_chunk", "training_micro_batch"])
def test_f32_takes_the_f32_route(tiles):
    for _, bw, heads, nw, _, w in chip_smoke.window_shapes(tiles):
        p = twa.plan(bw, w**3, heads, 16, nw or 1, torch.float32)
        assert p["route"] == "f32" and p["grid"] == (bw * heads, 1)


@pytest.mark.parametrize("d,aligned", [(8, True), (24, True), (16, False)])
def test_bf16_off_the_mma_rule_takes_the_f32_route(d, aligned):
    """Head dims that are no whole k16 step, and rows that are not 16-byte
    aligned, go to the f32 pipes (which take bf16 too)."""
    assert twa.plan(8, 216, 3, d, 4, torch.bfloat16, aligned)["route"] == "f32"


@pytest.mark.parametrize("d", twa.MMA_HEAD_DIMS)
def test_mma_plan_fits_shared_memory_for_every_window_size(d):
    """Every N from 1 to MAX_TOKENS gets an mma plan at D = 16 (the model's
    head dim) within the 232,448 bytes a block can have; at wider heads a
    window whose K and V alone overflow goes to the f32 route instead."""
    for n in range(1, twa.MAX_TOKENS + 1):
        p = twa.plan(4, n, 3, d, 2, torch.bfloat16)
        if p["route"] == "mma":
            assert p["smem"] <= twa.SMEM_LIMIT == 232_448, n
            assert p["rows"] == 16 * (p["threads"] // 32) and 1 <= p["threads"] // 32 <= 8
            assert p["rows"] <= 16 * math.ceil(n / 16)
        else:
            assert d > 16, n
    assert twa.plan(4, 216, 3, 16, 2, torch.bfloat16)["smem"] == 105_728  # 2 blocks an SM
    assert twa.plan(4, 343, 3, 16, 2, torch.bfloat16)["rows"] == 128
    assert twa.plan(4, 512, 3, 16, 2, torch.bfloat16)["rows"] == 112


def _coverage(p, bw, n, heads, num_windows):
    """How often the plan's blocks compute each output (window bw, row i,
    head h), by the kernel's own index arithmetic: block x = (row block,
    head, window) with the row block fastest, block y = group of tiles."""
    batch = bw // num_windows
    count = np.zeros((bw, n, heads), np.int64)
    if p["route"] == "f32":
        for bx in range(p["grid"][0]):
            h, t = bx % heads, bx // heads
            b, w = t % batch, t // batch
            count[b * num_windows + w, :, h] += 1
        return count
    rows, tiles = p["rows"], p["tiles_per_block"]
    row_blocks = math.ceil(n / rows)
    for bx in range(p["grid"][0]):
        rb, h, w = bx % row_blocks, (bx // row_blocks) % heads, bx // row_blocks // heads
        assert w < num_windows
        for by in range(p["grid"][1]):
            for b in range(by * tiles, min(batch, (by + 1) * tiles)):
                count[b * num_windows + w, rb * rows:min(n, (rb + 1) * rows), h] += 1
    return count


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "bw,n,heads,nw",
    [
        (7680, 216, 3, 512),  # stage 0 of a serving chunk, shifted
        (7680, 216, 3, 1),  # ... unshifted: one bias for every window
        (15, 216, 24, 1),  # stage 3: few windows, the tiles split into groups
        (128, 216, 6, 64),  # stage 1 of a training micro-batch
        (16, 27, 3, 8),  # 3³ windows
        (16, 343, 3, 8),  # the 7³ envelope
        (8, 343, 3, 8),  # one tile
        (6, 512, 2, 3),  # the largest window: 5 row blocks of 112
        (5, 17, 1, 5),  # odd sizes
    ],
)
def test_plan_grid_covers_every_output_once(bw, n, heads, nw, dtype):
    p = twa.plan(bw, n, heads, 16, nw, dtype)
    assert p["route"] == ("mma" if dtype == torch.bfloat16 else "f32")
    assert (_coverage(p, bw, n, heads, nw) == 1).all()


def test_plan_fills_the_card_when_windows_are_few():
    """Stage 3 of a serving chunk is 24 heads x 1 window: the 15 tiles are
    cut into groups so the grid gives each SM two blocks."""
    p = twa.plan(15, 216, 24, 16, 1, torch.bfloat16)
    assert p["grid"][0] * p["grid"][1] >= 2 * twa.SM_COUNT
    assert p["tiles_per_block"] * p["grid"][1] >= 15
    shifted = twa.plan(7680, 216, 3, 16, 512, torch.bfloat16)
    assert shifted["tiles_per_block"] == 15 and shifted["grid"] == (2 * 3 * 512, 1)
