"""Kernel B's plain versions against the JAX package.

``dense_attention``, ``blockwise_attention`` and ``multi_head_attention`` of
the port are held against their JAX counterparts and against the Pallas
``flash_attention`` in interpret mode (the JAX package's own CPU run). The
CUDA kernel runs only on the card (``chip_smoke.py``); here the wrapper's
dispatch and input checks are tested on CPU tensors.

Tolerances: f32 2e-5 absolute, as ``tests/test_flash_attention.py`` holds
the Pallas kernel (outputs are O(1) convex combinations of the values; the
packages sum in different orders); bf16 2e-2 (bf16 inputs and output).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.ops import attention as jatt
from multimodal_organ_segmentation_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from multimodal_organ_segmentation_tpu_torch.ops import attention as tatt
from multimodal_organ_segmentation_tpu_torch.ops import flash_attention as tfa
from tests.torch_port_utils import as_np, port

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
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v)
    assert torch.equal(out, tatt.blockwise_attention(q, k, v, kv_block=512))
    assert tfa.flash_attention.launches == before  # only a kernel launch counts
    # the dispatch sends a CPU tensor to the plain version whatever use_kernel says
    plain = tatt.blockwise_attention(q, k, v, kv_block=2048)
    assert torch.equal(tatt.multi_head_attention(q, k, v, use_kernel=True), plain)


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
