"""Gradients through the port's ``window_mha`` and ``flash_attention``
(``torch.autograd.Function``s) against ``jax.grad`` of the JAX package's
``custom_vjp`` kernels, which run on the CPU as the JAX package's own tests
run them. On the CPU the port's Functions take the plain forward; the
backward, the gradient of the plain version on the saved inputs, is the one
the card uses.

Tolerances are those of ``tests/test_window_mha.py`` (rtol 1e-4, atol 1e-5)
and ``tests/test_flash_attention.py`` (atol 3e-5): f32 sums in another order.
``gradcheck`` in f64 holds the Functions' backward to finite differences.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.ops.pallas import flash_attention as jflash
from multimodal_organ_segmentation_tpu.ops.pallas import window_attention as jwin
from multimodal_organ_segmentation_tpu_torch.ops.attention import multi_head_attention
from multimodal_organ_segmentation_tpu_torch.ops.flash_attention import flash_attention
from multimodal_organ_segmentation_tpu_torch.ops.window_attention import (
    dense_window_mha,
    window_mha,
)


def _window_inputs(bw, n, h, d, nw, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bw, n, h, d)).astype(np.float32) for _ in range(3))
    bias = (0.1 * rng.normal(size=(h, n, n))).astype(np.float32)
    mask = None
    if with_mask:
        mask = rng.choice([0.0, -100.0], size=(nw, n, n), p=[0.8, 0.2]).astype(np.float32)
    return q, k, v, bias, mask


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("bw,n,h,d,nw", [(4, 27, 2, 8, 2), (4, 64, 3, 16, 4)])
def test_window_mha_gradients_match_jax(bw, n, h, d, nw, with_mask):
    q, k, v, bias, mask = _window_inputs(bw, n, h, d, nw, with_mask)
    jmask = None if mask is None else jnp.asarray(mask)
    nw_arg = nw if with_mask else 1

    def loss(q, k, v, bias):
        return jnp.sum(jwin.window_mha(q, k, v, bias, jmask, nw_arg) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))

    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias))
    tmask = None if mask is None else torch.from_numpy(mask)
    out = window_mha(tq, tk, tv, tb, tmask, nw_arg)
    assert out.grad_fn is not None and "WindowMHA" in type(out.grad_fn).__name__
    (out**2).sum().backward()
    for t, r in zip((tq, tk, tv, tb), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    assert tmask is None or tmask.grad is None


def test_window_mha_strided_views_of_one_qkv_get_one_gradient():
    """The model hands over slices of one qkv projection."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(4, 27, 3, 2, 8)).astype(np.float32)).requires_grad_()
    bias = torch.from_numpy((0.1 * rng.normal(size=(2, 27, 27))).astype(np.float32)).requires_grad_()
    q, k, v = qkv.unbind(2)
    (window_mha(q, k, v, bias, None, 1) ** 2).sum().backward()
    got = qkv.grad.clone()
    qkv.grad = None
    (dense_window_mha(q, k, v, bias, None, 1) ** 2).sum().backward()
    np.testing.assert_allclose(got.numpy(), qkv.grad.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("nq,nk,h,d", [(96, 96, 2, 8), (40, 700, 2, 16)])
def test_flash_attention_gradients_match_jax(nq, nk, h, d):
    """700 keys exceed the plain version's 512-key block: the backward goes
    through the blockwise recurrence."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, nq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(2, nk, h, d)).astype(np.float32) for _ in range(2))

    def loss(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out**2).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=3e-5)


def test_only_the_inputs_that_ask_get_a_gradient():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 12, 2, 4)).astype(np.float32)) for _ in range(3))
    k.requires_grad_()
    multi_head_attention(q, k, v).sum().backward()
    assert k.grad is not None and q.grad is None and v.grad is None
    bias = torch.zeros(2, 12, 12)
    out = window_mha(q, k, v, bias, None, 1)
    assert out.requires_grad
    with torch.no_grad():
        assert not window_mha(q, k, v, bias, None, 1).requires_grad


def test_gradcheck_window_mha_f64():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 5, 2, 3))).requires_grad_() for _ in range(3))
    bias = torch.from_numpy(0.1 * rng.normal(size=(2, 5, 5))).requires_grad_()
    mask = torch.from_numpy(rng.choice([0.0, -100.0], size=(2, 5, 5), p=[0.8, 0.2]))
    assert torch.autograd.gradcheck(lambda *a: window_mha(*a, mask, 2), (q, k, v, bias))


def test_gradcheck_flash_attention_f64():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 4, 2, 3))).requires_grad_()
    k, v = (torch.from_numpy(rng.normal(size=(2, 6, 2, 3))).requires_grad_() for _ in range(2))
    assert torch.autograd.gradcheck(flash_attention, (q, k, v))
