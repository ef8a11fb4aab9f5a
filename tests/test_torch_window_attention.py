"""Kernel A's plain version (``dense_window_mha``) against the JAX package.

The port's ``dense_window_mha`` is held against the Pallas kernel run in
interpret mode (``_window_mha_fwd_impl(..., interpret=True)``, as
``tests/test_window_mha.py`` runs it) and against the JAX dense formula.
The CUDA kernel itself runs only on the card (``chip_smoke.py``); here the
wrapper's dispatch and input checks are tested on CPU tensors.

Tolerances: f32 2e-5 (the two packages sum the N-long dot products and the
softmax denominator in a different order; the values are O(1)); bf16 2e-2
(inputs and output rounded to bf16's 8-bit mantissa, ~4e-3 relative per
rounding), as in ``tests/test_window_mha.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.ops.pallas import window_attention as jwa
from multimodal_organ_segmentation_tpu_torch.ops import window_attention as twa
from tests.torch_port_utils import as_np, port

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
    before = twa.window_mha.launches
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
