"""Kernel B's plain versions against the JAX package.

``dense_attention``, ``blockwise_attention`` and ``multi_head_attention`` of
the port are held against their JAX counterparts and against the Pallas
``flash_attention`` in interpret mode (the JAX package's own CPU run). The
CUDA kernel runs only on the card (``chip_smoke.py``); here the wrapper's
dispatch and input checks are tested on CPU tensors, and its route and
launch plan (``plan``) as plain Python.

Tolerances: f32 2e-5 absolute, as ``tests/test_flash_attention.py`` holds
the Pallas kernel (outputs are O(1) convex combinations of the values; the
packages sum in different orders); bf16 2e-2 (bf16 inputs and output).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke

from multimodal_organ_segmentation_tpu.ops import attention as jatt
from multimodal_organ_segmentation_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from multimodal_organ_segmentation_tpu_torch.ops import attention as tatt
from multimodal_organ_segmentation_tpu_torch.ops import flash_attention as tfa
from tests.torch_port_utils import as_np, port
from tests.torch_port_utils import _one_thread  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 2e-2

SHAPES = [(300, 300, 4, 8), (729, 729, 2, 32), (100, 257, 3, 16), (64, 1500, 1, 64)]


def _qkv(nq, nk, h, d, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, nq, h, d)).astype(np.float32),
        rng.normal(size=(b, nk, h, d)).astype(np.float32),
        rng.normal(size=(b, nk, h, d)).astype(np.float32),
    )


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [port(a) for a in arrays]


@pytest.mark.parametrize("nq,nk,h,d", SHAPES)
def test_plain_versions_match_jax(nq, nk, h, d):
    (jq, jk, jv), (q, k, v) = _both(_qkv(nq, nk, h, d))
    ref = np.asarray(jatt.dense_attention(jq, jk, jv))
    pallas = np.asarray(jax_flash_attention(jq, jk, jv))  # interpret mode on the CPU
    np.testing.assert_allclose(pallas, ref, atol=F32_TOL)
    np.testing.assert_allclose(as_np(tatt.dense_attention(q, k, v)), ref, atol=F32_TOL)
    # kv_block below the key count: the flash recurrence, with a ragged
    # last block whose padded keys are masked
    jblock = np.asarray(jatt.blockwise_attention(jq, jk, jv, kv_block=128))
    tblock = as_np(tatt.blockwise_attention(q, k, v, kv_block=128))
    np.testing.assert_allclose(tblock, jblock, atol=F32_TOL)
    np.testing.assert_allclose(tblock, pallas, atol=F32_TOL)
    # the dispatch: the CPU takes blockwise_attention at its default block
    mha = as_np(tatt.multi_head_attention(q, k, v))
    np.testing.assert_allclose(mha, np.asarray(jatt.multi_head_attention(jq, jk, jv)), atol=F32_TOL)
    np.testing.assert_allclose(mha, pallas, atol=F32_TOL)


@pytest.mark.parametrize("kv_block", [512, 1000])
def test_blockwise_at_the_fusion_shape(kv_block):
    """The /8 fusion of the flagship: 1728 tokens, 2 heads of 96. With
    kv_block 1000 the last block holds 728 keys and 272 pads."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1728, 1728, 2, 96, seed=3, b=1))
    ref = np.asarray(jatt.blockwise_attention(jq, jk, jv, kv_block=kv_block))
    out = as_np(tatt.blockwise_attention(q, k, v, kv_block=kv_block))
    np.testing.assert_allclose(out, ref, atol=F32_TOL)
    np.testing.assert_allclose(out, np.asarray(jatt.dense_attention(jq, jk, jv)), atol=F32_TOL)


def test_blockwise_one_valid_key_in_the_last_block():
    """A last block of one real key and 127 pads keeps the running max
    finite; no -inf - -inf reaches an exponent."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(40, 129, 2, 8, seed=4))
    out = as_np(tatt.blockwise_attention(q, k, v, kv_block=128))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(jatt.dense_attention(jq, jk, jv)), atol=F32_TOL)


def test_bf16_matches_pallas():
    (jq, jk, jv), (q, k, v) = _both(_qkv(128, 300, 2, 16))
    pallas = jax_flash_attention(*(x.astype(jnp.bfloat16) for x in (jq, jk, jv)))
    out = tatt.blockwise_attention(*(x.to(torch.bfloat16) for x in (q, k, v)), kv_block=128)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(out), np.asarray(pallas, np.float32), atol=BF16_TOL)


def test_flash_attention_on_cpu_runs_the_plain_version():
    _, (q, k, v) = _both(_qkv(100, 600, 2, 8))
    before = dict(tfa.flash_attention.launches)
    out = tfa.flash_attention(q, k, v)
    assert torch.equal(out, tatt.blockwise_attention(q, k, v, kv_block=512))
    assert tfa.flash_attention.launches == before  # only a kernel launch counts
    # the dispatch sends an f32 CPU tensor through the op, i.e. to its plain
    # version; use_kernel=False (and bf16 on the CPU) takes blockwise(kv_block)
    assert torch.equal(tatt.multi_head_attention(q, k, v, use_kernel=True), out)
    plain = tatt.blockwise_attention(q, k, v, kv_block=2048)
    assert torch.equal(tatt.multi_head_attention(q, k, v, use_kernel=False), plain)


@pytest.mark.parametrize(
    "make,error",
    [
        (lambda q: (q, q, q[..., :2]), ValueError),  # v's head dim differs
        (lambda q: (q.to(torch.bfloat16), q, q), TypeError),
        (lambda q: (q.half(), q.half(), q.half()), TypeError),
        (lambda q: (q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2)), ValueError),
        (lambda q: (q[:, :, :, :6], q[:, :, :, :6].contiguous(), q[:, :, :, :6].contiguous()),
         ValueError),  # head dim 6 is not a multiple of 4
        (lambda q: (q, q[:, :0], q[:, :0]), ValueError),  # no keys
    ],
)
def test_kernel_input_checks(make, error):
    """The CUDA wrapper's checks raise on what the kernel does not take."""
    with pytest.raises(error):
        tfa._check_inputs(*make(torch.zeros((2, 10, 2, 8))))


def test_kernel_takes_head_dims_up_to_256():
    big = torch.zeros((1, 4, 1, 260))
    with pytest.raises(ValueError):
        tfa._check_inputs(big, big, big)
    ok = torch.zeros((1, 4, 1, 256))
    tfa._check_inputs(ok, ok, ok)


# ---- route and launch plan ---------------------------------------------

# (B, N, H, D) of kernel B's launches on the models' main paths, with the
# route bf16 takes: the flagship's fusions (a serving chunk of 15 tiles, a
# training micro-batch of 2) and the DualEncoders' attending levels (DE128
# 2 tiles a chunk, 1 a micro-batch; the 4-modality model 4 a chunk).
# wgmma from 2**20 query-key pairs, mma below.
MODEL_SHAPES = [
    ((15, 1728, 2, 96), "wgmma"), ((15, 216, 4, 96), "wgmma"), ((15, 27, 8, 96), "mma"),
    ((2, 1728, 2, 96), "wgmma"), ((2, 216, 4, 96), "mma"), ((2, 27, 8, 96), "mma"),
    ((2, 4096, 4, 64), "wgmma"), ((2, 512, 4, 128), "wgmma"),
    ((1, 4096, 4, 64), "wgmma"), ((1, 512, 4, 128), "wgmma"),
    ((4, 13824, 4, 32), "wgmma"), ((4, 1728, 4, 64), "wgmma"), ((4, 216, 4, 128), "mma"),
]


@pytest.mark.parametrize("tiles", [15, 2], ids=["serving_chunk", "training_micro_batch"])
def test_every_flagship_bf16_shape_takes_the_mma_route(tiles):
    """Every bf16 fusion of the flagship takes a tensor-core route: wgmma
    (384 threads: two consumer warpgroups of 64 query rows and a producer
    warpgroup) from ``WGMMA_MIN_PAIRS`` query-key pairs, mma (4 warps of 16
    rows) below, as at the /32 fusion."""
    for stage, b, n, heads, d in chip_smoke.flash_shapes(tiles):
        p = tfa.plan(b, n, n, heads, d, torch.bfloat16)
        if b * heads * n * n >= tfa.WGMMA_MIN_PAIRS:
            assert p["route"] == "wgmma", (stage, b, n, heads, d)
            assert p["threads"] == 384 and p["rows"] == 128 and p["stages"] == 3
        else:
            assert p["route"] == "mma", (stage, b, n, heads, d)
            assert p["threads"] == 128 and p["rows"] == 64


@pytest.mark.parametrize("tiles", [15, 2], ids=["serving_chunk", "training_micro_batch"])
def test_f32_takes_the_f32_route(tiles):
    for _, b, n, heads, d in chip_smoke.flash_shapes(tiles):
        assert tfa.plan(b, n, n, heads, d, torch.float32)["route"] == "f32"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,route", MODEL_SHAPES,
                         ids=["x".join(map(str, sh)) for sh, _ in MODEL_SHAPES])
def test_plan_route_at_the_model_shapes(shape, route, dtype):
    b, n, heads, d = shape
    p = tfa.plan(b, n, n, heads, d, dtype)
    assert p["route"] == (route if dtype == torch.bfloat16 else "f32")


def test_plan_fits_shared_memory_for_every_head_dim():
    """Every route at every head dim the kernel takes: the tensor-core routes
    exactly for bf16 at multiples of 16 up to 128 and aligned inputs
    (wgmma from ``WGMMA_MIN_PAIRS`` pairs, as 2 x 2 x 1000 x 300 are)."""
    for d in range(4, tfa.MAX_HEAD_DIM + 1, 4):
        for dtype in (torch.bfloat16, torch.float32):
            for aligned in (True, False):
                p = tfa.plan(2, 1000, 300, 2, d, dtype, aligned)
                tc = dtype == torch.bfloat16 and d % 16 == 0 and d <= 128 and aligned
                assert p["route"] == ("wgmma" if tc else "f32"), (d, dtype, aligned)
                assert p["smem"] <= tfa.SMEM_LIMIT == 232_448, (d, p)
                if tc:
                    mma = tfa.plan(2, 1000, 300, 2, d, dtype, aligned, route="mma")
                    assert mma["smem"] <= tfa.SMEM_LIMIT
    assert tfa.plan(15, 1728, 1728, 2, 96, torch.bfloat16, route="mma")["smem"] == 53_248


@pytest.mark.parametrize("d", range(16, 129, 16))
def test_wgmma_ring_at_every_head_dim(d):
    """The wgmma route's shared memory: a 128-row Q tile and a 3-stage ring
    of K and V tiles of 128 keys, all bf16, and 7 mbarriers, in one block of
    384 threads; at D = 128 it takes 229,560 of the 232,448 bytes."""
    p = tfa.plan(2, 1000, 1000, 2, d, torch.bfloat16)
    assert tfa.WGMMA_KEYS == 128 and p["stages"] == tfa.WGMMA_STAGES == 3
    assert p["smem"] == 128 * d * 2 + 3 * 2 * 128 * d * 2 + 8 * 7 + 128 <= tfa.SMEM_LIMIT
    assert p["threads"] == 384 and p["rows"] == 128


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.bfloat16, "mma"),
                                         (torch.float32, "f32")])
@pytest.mark.parametrize("b,nq,heads", [(15, 1728, 2), (15, 216, 4), (15, 27, 8), (2, 129, 3),
                                        (1, 64, 1), (1, 1, 1)])
def test_plan_grid_covers_every_query_row_once(b, nq, heads, dtype, route):
    """By the kernels' index arithmetic: wgmma blocks are (query block of
    128, b*H), mma blocks (query block of 64, b*H), f32 blocks (b*H, query
    block of 64)."""
    p = tfa.plan(b, nq, 300, heads, 96, dtype, route=route)
    count = np.zeros((b * heads, nq), np.int64)
    qb_axis = 1 if p["route"] == "f32" else 0
    assert p["route"] == route and p["rows"] == (128 if route == "wgmma" else 64)
    assert p["grid"][1 - qb_axis] == b * heads
    assert p["grid"][qb_axis] == math.ceil(nq / p["rows"])
    for bh in range(b * heads):
        for qb in range(p["grid"][qb_axis]):
            count[bh, qb * p["rows"]:(qb + 1) * p["rows"]] += 1
    assert (count == 1).all()


def test_plan_refuses_a_grid_the_card_cannot_launch():
    with pytest.raises(ValueError, match="grid"):
        tfa.plan(70_000, 64, 64, 1, 16, torch.bfloat16)


@pytest.mark.parametrize(
    "args,route",
    [
        ((2, 100, 100, 2, 96, torch.float32), "wgmma"),  # f32 is no tensor-core type
        ((2, 100, 100, 2, 96, torch.float32), "mma"),
        ((2, 100, 100, 2, 24, torch.bfloat16), "wgmma"),  # no whole k16 step
        ((2, 100, 100, 2, 144, torch.bfloat16), "mma"),  # past 128
        ((2, 100, 100, 2, 96, torch.bfloat16, False), "wgmma"),  # unaligned
        ((2, 100, 100, 2, 96, torch.bfloat16), "tma"),  # no such route
    ],
)
def test_plan_refuses_a_route_that_does_not_take_the_call(args, route):
    with pytest.raises(ValueError, match="route"):
        tfa.plan(*args, route=route)
