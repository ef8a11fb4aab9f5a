"""The port's conv building blocks against the JAX package's
``models/layers.py``: same seeded weights (carried by ``convert``), same
numpy inputs, f32 on the CPU.

Tolerance 2e-5 absolute: the outputs are O(1) (normalised activations) and
both packages sum a 3³ conv or a norm's moments in f32 in another order.
"""

import numpy as np
import pytest
import torch

import jax

from multimodal_organ_segmentation_tpu.models import layers as jlayers
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.models import layers as tlayers
from multimodal_organ_segmentation_tpu_torch.train.trainer import _dropout_active
from tests.torch_port_utils import as_np, port, seeded_variables
from tests.torch_port_utils import _one_thread  # noqa: F401

TOL = 2e-5


def _normal(shape, seed, loc=0.0, scale=1.0):
    return (loc + scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _cf(x):
    """channels-last numpy → channels-first view of a port tensor."""
    return port(x).permute(0, 4, 1, 2, 3)


def _cl(t):
    return as_np(t.permute(0, 2, 3, 4, 1))


def _merged(variables, name=None):
    """A module's params with its batch_stats merged in (``name``: a child)."""
    params, stats = variables["params"], variables.get("batch_stats")
    if name is not None:
        params, stats = params[name], (stats or {}).get(name)
    return convert._merge(params, stats)


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "gelu", "swish"])
def test_activation_fn(name):
    x = _normal((64,), 0, scale=3.0)
    ref = np.asarray(jlayers.activation_fn(name)(x))
    np.testing.assert_allclose(as_np(tlayers.activation_fn(name)(port(x))), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("norm", ["instance", "group", "batch", "none"])
@pytest.mark.parametrize("train", [True, False])
def test_conv_block(norm, train):
    x = _normal((2, 6, 5, 4, 3), 1)
    flax_mod = jlayers.ConvBlock3D(8, norm=norm)
    variables = seeded_variables(flax_mod, x, False, seed=2)
    mutable = ["batch_stats"] if (train and norm == "batch") else []
    if mutable:
        ref, new_vars = flax_mod.apply(variables, x, True, mutable=mutable)
    else:
        ref = flax_mod.apply(variables, x, train)
    mod = tlayers.ConvBlock3D(3, 8, norm=norm).train(train)
    mod.load_state_dict(convert.state_from_jax(_merged(variables), convert.CONV_BLOCK))
    np.testing.assert_allclose(_cl(mod(_cf(x))), np.asarray(ref), rtol=0, atol=TOL)
    if mutable:  # the running statistics moved as flax's did
        moved = convert.state_from_jax(convert._merge(variables["params"], new_vars["batch_stats"]),
                                       convert.CONV_BLOCK)
        for key in ("norm1.running_mean", "norm1.running_var", "norm2.running_mean",
                    "norm2.running_var"):
            np.testing.assert_allclose(as_np(mod.state_dict()[key]), as_np(moved[key]),
                                       rtol=0, atol=TOL, err_msg=key)


def test_batch_norm_train_step_follows_flax():
    """One train-mode step of batch norm at a 4³ grid, batch 2 (128 voxels
    a channel): the output and the running mean and variance as flax's
    ``BatchNorm`` (momentum 0.99, the biased variance). An unbiased running
    variance would differ from flax's by 128/127 - 1 = 0.8% of the batch
    term."""
    x = _normal((2, 4, 4, 4, 8), 3, loc=1.5, scale=2.0)
    flax_mod = jlayers.Norm3D("batch")
    variables = seeded_variables(flax_mod, x, False, seed=4)
    ref, new_vars = flax_mod.apply(variables, x, True, mutable=["batch_stats"])
    mod = tlayers.Norm3D("batch", 8).train()
    mod.load_state_dict(convert.state_from_jax(_merged(variables), "norm"))
    out = mod(_cf(x))
    np.testing.assert_allclose(_cl(out), np.asarray(ref), rtol=0, atol=TOL)
    stats = new_vars["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(as_np(mod.running_mean), np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(as_np(mod.running_var), np.asarray(stats["var"]), rtol=0, atol=1e-6)
    assert mod.running_mean.dtype == mod.running_var.dtype == torch.float32
    # and in eval the running statistics normalise
    ref_eval = flax_mod.apply({"params": variables["params"], "batch_stats": new_vars["batch_stats"]},
                              x, False)
    np.testing.assert_allclose(_cl(mod.eval()(_cf(x))), np.asarray(ref_eval), rtol=0, atol=TOL)


def test_batch_norm_gradient_flows_through_the_batch_statistics():
    """In training the batch's own mean and variance normalise, so the
    gradient of a per-channel sum of the output is 0 with respect to x,
    as flax's is."""
    x = _normal((2, 4, 3, 2, 4), 5)
    flax_mod = jlayers.Norm3D("batch")
    variables = seeded_variables(flax_mod, x, False, seed=6)

    def f(xj):
        y, _ = flax_mod.apply(variables, xj, True, mutable=["batch_stats"])
        return (y * np.arange(1, 5, dtype=np.float32)).sum() + (y**2).sum()

    ref = np.asarray(jax.grad(f)(x))
    mod = tlayers.Norm3D("batch", 4).train()
    mod.load_state_dict(convert.state_from_jax(_merged(variables), "norm"))
    xt = port(x).requires_grad_()
    y = mod(xt.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    ((y * torch.arange(1, 5, dtype=torch.float32)).sum() + (y**2).sum()).backward()
    np.testing.assert_allclose(as_np(xt.grad), ref, rtol=0, atol=1e-4)


def test_max_pool_and_down_block_drop_a_trailing_odd_voxel():
    x = _normal((2, 7, 6, 5, 4), 7)
    np.testing.assert_array_equal(_cl(tlayers.max_pool_3d(_cf(x))),
                                  np.asarray(jlayers.max_pool_3d(x)))
    flax_mod = jlayers.DownBlock3D(8)
    variables = seeded_variables(flax_mod, x, False, seed=8)
    ref_conv, ref_pool = flax_mod.apply(variables, x, False)
    mod = tlayers.DownBlock3D(4, 8)
    mod.load_state_dict(convert.state_from_jax(_merged(variables), convert.DOWN_BLOCK))
    conv, pool = mod(_cf(x))
    assert conv.shape == (2, 8, 3, 3, 2)
    np.testing.assert_allclose(_cl(conv), np.asarray(ref_conv), rtol=0, atol=TOL)
    np.testing.assert_array_equal(_cl(pool), np.asarray(ref_pool))


@pytest.mark.parametrize("mode", ["transpose", "linear"])
@pytest.mark.parametrize("skip_grid", [(8, 6, 4), (9, 7, 4)])
def test_up_block(mode, skip_grid):
    """Both upsampling modes; a skip grid of odd sides makes the 2× output
    miss it, and the block resizes before the concat."""
    x = _normal((2, 4, 3, 2, 12), 9)
    skip = _normal((2, *skip_grid, 6), 10)
    flax_mod = jlayers.UpBlock3D(6, 6, mode=mode)
    variables = seeded_variables(flax_mod, x, skip, False, seed=11)
    ref = flax_mod.apply(variables, x, skip, False)
    mod = tlayers.UpBlock3D(12, 6, 6, 6, mode=mode)
    mod.load_state_dict(convert.state_from_jax(_merged(variables), convert.UP_BLOCK))
    out = mod(_cf(x), _cf(skip))
    assert tuple(out.shape[2:]) == skip_grid
    np.testing.assert_allclose(_cl(out), np.asarray(ref), rtol=0, atol=TOL)


def test_dropout3d_drops_whole_channels():
    """Each (sample, channel) is dropped whole or kept and scaled by
    1/(1 - p), as flax's ``Dropout`` broadcast over the spatial axes; eval
    and rate 0 pass the input through. The trainer sees it as a dropout."""
    x = port(_normal((4, 3, 3, 3, 16), 12, loc=2.0))
    mod = tlayers.Dropout3D(0.25).train()
    torch.manual_seed(0)
    y = mod(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    kept = (y != 0).reshape(4, -1, 16)
    assert bool((kept.all(dim=1) | ~kept.any(dim=1)).all())  # whole channels
    dropped = float((~kept.any(dim=1)).float().mean())
    assert 0.05 < dropped < 0.5
    scaled = y.reshape(4, -1, 16)[:, 0][kept[:, 0]]
    torch.testing.assert_close(scaled, x.reshape(4, -1, 16)[:, 0][kept[:, 0]] / 0.75)
    assert torch.equal(mod.eval()(x), x)
    assert torch.equal(tlayers.Dropout3D(0.0).train()(x), x)
    assert _dropout_active(torch.nn.Sequential(tlayers.Dropout3D(0.1)))
    assert not _dropout_active(torch.nn.Sequential(tlayers.Dropout3D(0.0)))
