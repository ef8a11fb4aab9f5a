"""The port's losses against the JAX package's, same numpy inputs.

Tolerances: values 1e-6 (f32 reductions over ~2k voxels in another order;
losses are O(1)); gradients w.r.t. the logits 1e-5 relative to the largest
gradient element plus 1e-7 absolute (elements are O(1/N)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.train import losses as jlosses
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfigNode
from multimodal_organ_segmentation_tpu_torch.train import losses as tlosses
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

VALUE_TOL = 1e-6
GRAD_RTOL = 1e-5
CLASSES = 5
WEIGHTS = [0.2, 1.0, 2.0, 0.5, 1.5]


def _data(seed=0, shape=(2, 6, 5, 4), dtype=np.float32):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.normal(size=(*shape, CLASSES))).astype(dtype)
    labels = rng.integers(0, CLASSES, size=shape).astype(np.int32)
    return logits, labels


CASES = {
    "dice": (lambda m: m.dice_loss, {}),
    "dice_no_background": (lambda m: m.dice_loss, {"include_background": False}),
    "dice_sum": (lambda m: m.dice_loss, {"reduction": "sum", "smooth": 0.5}),
    "ce": (lambda m: m.cross_entropy_loss, {}),
    "ce_weighted": (lambda m: m.cross_entropy_loss, {"class_weights": WEIGHTS}),
    "ce_weighted_sum": (lambda m: m.cross_entropy_loss,
                        {"class_weights": WEIGHTS, "reduction": "sum"}),
    "focal": (lambda m: m.focal_loss, {}),
    "focal_alpha": (lambda m: m.focal_loss, {"alpha": WEIGHTS, "gamma": 1.5}),
    "tversky": (lambda m: m.tversky_loss, {"alpha": 0.3, "beta": 0.7}),
    "dice_ce": (lambda m: m.dice_ce_loss, {}),
    "dice_ce_weighted": (lambda m: m.dice_ce_loss,
                         {"dice_weight": 0.3, "ce_weight": 0.7, "class_weights": WEIGHTS,
                          "include_background": False}),
}


def _jax_kwargs(kwargs):
    return {k: jnp.asarray(v, jnp.float32) if k in ("class_weights", "alpha") else v
            for k, v in kwargs.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_value_and_gradient(case):
    pick, kwargs = CASES[case]
    logits, labels = _data()
    jfn = lambda lg: pick(jlosses)(lg, jnp.asarray(labels), **_jax_kwargs(kwargs))
    ref, ref_grad = jax.value_and_grad(jfn)(jnp.asarray(logits))

    lg = torch.from_numpy(logits).requires_grad_()
    out = pick(tlosses)(lg, torch.from_numpy(labels), **kwargs)
    out.backward()
    assert out.dtype == torch.float32
    scale = max(1.0, abs(float(ref)))
    assert abs(float(out.detach()) - float(ref)) <= VALUE_TOL * scale
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(lg.grad.numpy(), ref_grad, rtol=0,
                               atol=GRAD_RTOL * np.abs(ref_grad).max() + 1e-7)


@pytest.mark.parametrize("reduction", ["none"])
@pytest.mark.parametrize("name", ["dice_loss", "cross_entropy_loss", "focal_loss", "tversky_loss"])
def test_unreduced_losses(name, reduction):
    logits, labels = _data(1)
    ref = getattr(jlosses, name)(jnp.asarray(logits), jnp.asarray(labels), reduction=reduction)
    out = getattr(tlosses, name)(torch.from_numpy(logits), torch.from_numpy(labels),
                                 reduction=reduction)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=VALUE_TOL, atol=VALUE_TOL)


def test_dice_without_softmax_takes_probabilities():
    logits, labels = _data(2)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ref = jlosses.dice_loss(jnp.asarray(probs), jnp.asarray(labels), apply_softmax=False)
    out = tlosses.dice_loss(torch.from_numpy(probs), torch.from_numpy(labels), apply_softmax=False)
    assert abs(float(out) - float(ref)) <= VALUE_TOL


@pytest.mark.parametrize("dtype,expect", [(torch.bfloat16, torch.float32),
                                          (torch.float64, torch.float64)])
def test_reductions_run_in_at_least_f32(dtype, expect):
    """bf16 logits reduce in f32; f64 stays f64."""
    logits, labels = _data(3)
    lg = torch.from_numpy(logits).to(dtype)
    for fn in (tlosses.dice_loss, tlosses.cross_entropy_loss, tlosses.focal_loss,
               tlosses.tversky_loss, tlosses.dice_ce_loss):
        assert fn(lg, torch.from_numpy(labels)).dtype == expect
    ref = jlosses.dice_ce_loss(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels))
    out = tlosses.dice_ce_loss(torch.from_numpy(logits).to(torch.bfloat16),
                               torch.from_numpy(labels))
    assert abs(float(out) - float(ref)) <= VALUE_TOL  # the same bf16 inputs, f32 math


LOSS_CONFIGS = {
    "dice": {"name": "dice"},
    "ce": {"name": "ce", "class_weights": WEIGHTS},
    "cross_entropy": {"name": "cross_entropy"},
    "focal": {"name": "focal", "class_weights": WEIGHTS},
    "tversky": {"name": "tversky", "tversky_alpha": 0.3, "tversky_beta": 0.7},
    "dice_ce": {"name": "dice_ce", "dice_weight": 0.25, "ce_weight": 0.75,
                "class_weights": WEIGHTS},
    "unknown_falls_back_to_dice_ce": {"name": "no_such_loss"},
    "default": {},
}


@pytest.mark.parametrize("case", sorted(LOSS_CONFIGS))
def test_get_loss(case):
    cfg = {"training": {"loss": LOSS_CONFIGS[case]}}
    logits, labels = _data(4)
    ref = jlosses.get_loss(JConfigNode(cfg))(jnp.asarray(logits), jnp.asarray(labels))
    out = tlosses.get_loss(ConfigNode(cfg))(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(float(out) - float(ref)) <= VALUE_TOL * max(1.0, abs(float(ref)))
    if case == "unknown_falls_back_to_dice_ce":
        plain = tlosses.dice_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
        assert float(out) == float(plain)


def test_deep_supervision_list():
    """A list of logits weighs 2^-k; a single tensor passes through."""
    labels = _data(5)[1]
    heads = [_data(5 + k)[0] for k in range(3)]
    ref_fn = jlosses.with_deep_supervision(jlosses.get_loss(JConfigNode({})))
    fn = tlosses.with_deep_supervision(tlosses.get_loss(ConfigNode({})))
    ref = ref_fn([jnp.asarray(h) for h in heads], jnp.asarray(labels))
    out = fn([torch.from_numpy(h) for h in heads], torch.from_numpy(labels))
    assert abs(float(out) - float(ref)) <= VALUE_TOL * max(1.0, abs(float(ref)))
    single = fn(torch.from_numpy(heads[0]), torch.from_numpy(labels))
    assert float(single) == float(tlosses.dice_ce_loss(torch.from_numpy(heads[0]),
                                                       torch.from_numpy(labels)))
    assert abs(float(single) - float(ref_fn(jnp.asarray(heads[0]), jnp.asarray(labels)))) <= VALUE_TOL * 2
