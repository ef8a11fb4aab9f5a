"""A JAX training state resumed in the port.

The JAX package's trainer state (params, batch statistics, the optax state
of ``inject_hyperparams(chain(clip|identity, base))``, EMA weights, the
step) is written by its own ``save_checkpoint``, converted by
``scripts/jax_checkpoint_to_torch.py`` (the JAX package's numpy restore,
then the port's ``train/checkpoint.py::from_jax_checkpoint``) and resumed by
the port's ``Trainer``. Models are the JAX package's ``build_model``
(its ``{"backbone": ...}`` wrapper), their weights seeded from numpy.

Tolerances (the port's train-step tests'): the resumed step against JAX's next step, loss 1e-4
and ``grad_norm`` 1e-3 relative; the weights and the EMA after it 1e-4, except the
biases of the convs in front of a batch norm, whose gradient is 0 but for
rounding, which adam and adafactor turn into steps of up to ±lr either
side; the optimiser's second moments after it (adam's ``nu``, adafactor's
``v`` and the ``v_row`` ⊗ ``v_col`` estimate it divides by, in the port's
layout) 1e-3 relative, the same biases left out (their moments are squares
of rounding noise), and adam's ``mu`` 1e-3 of its largest entry; the
logits of the weights carried across 1e-4. Adam runs at lr 1e-3, which
moves a weight by up to 1e-3 a step; adafactor at lr 3e-2, since it moves a
weight by about lr × rms(the weight) and the 128-channel conv's rms is
about 1/sqrt(27 · 128): the step must move that conv by more than ten times
the weight tolerance (it moves it by 2.7e-3), or a wrong factored moment
could pass.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.models.build import build_model as jbuild_model
from multimodal_organ_segmentation_tpu.train import trainer as jtrainer
from multimodal_organ_segmentation_tpu.train.checkpoint import save_checkpoint as jsave
from multimodal_organ_segmentation_tpu.train.losses import get_loss, with_deep_supervision
from multimodal_organ_segmentation_tpu.train.optim import make_optimizer as jmake_optimizer
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.train import optim as toptim
from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer
from multimodal_organ_segmentation_tpu_torch.utils.config import save_config, ConfigNode
from scripts.jax_checkpoint_to_torch import convert as convert_checkpoint
from tests.torch_port_utils import no_tf32, seeded_variables
from tests.torch_port_utils import _one_thread  # noqa: F401

LOSS_TOL, GNORM_RTOL, WEIGHT_TOL, LOGIT_TOL, MOMENT_RTOL = 1e-4, 1e-3, 1e-4, 1e-4, 1e-3
LR = {"adamw": 1e-3, "adafactor": 3e-2}
EMA = 0.9
MICRO = 2


def _unet_cfg(root, optimizer, features):
    return {"experiment": {"name": optimizer, "seed": 0, "output_dir": str(root / "out")},
            "data": {"modalities": ["CT", "PET"]},
            "model": {"name": "unet3d", "in_channels": 2, "out_channels": 4,
                      "backbone": {"features": features, "img_size": [8, 8, 8],
                                   "norm": "batch"},
                      "head": {"type": "conv", "dropout": 0.0}},
            "training": {"batch_size": MICRO, "accumulation_steps": 1, "ema_decay": EMA,
                         "grad_clip_norm": 1.0,
                         "optimizer": {"name": optimizer, "lr": LR[optimizer],
                                       "weight_decay": 1e-4},
                         "loss": {"name": "dice_ce", "dice_weight": 0.5, "ce_weight": 0.5}},
            "hardware": {"mixed_precision": "fp32"}}


def _jax_state(flax_mod, cfg, variables, ema=False):
    tx = jmake_optimizer(JConfig(cfg))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    extra = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in variables.items()
             if k != "params"}
    return tx, jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=jax.jit(tx.init)(params), extra=extra,
                                   ema_params=jax.tree_util.tree_map(jnp.array, params) if ema
                                   else None)


@pytest.fixture(scope="module", params=[("adamw", [4, 8]), ("adafactor", [4, 128])],
                ids=["adamw", "adafactor"])
def jax_run(request, tmp_path_factory):
    """Three JAX steps of a batch-norm UNet3D with EMA (adafactor's
    128-channel block has factored moments), the state after two of them
    written by JAX's ``save_checkpoint`` and converted by the script."""
    optimizer, features = request.param
    root = tmp_path_factory.mktemp(optimizer)
    cfg = _unet_cfg(root, optimizer, features)
    flax_mod = jbuild_model(JConfig(cfg))
    variables = seeded_variables(flax_mod, np.zeros((1, 8, 8, 8, 2), np.float32),
                                 train=False, seed=5)
    tx, state = _jax_state(flax_mod, cfg, variables, ema=True)
    step = jtrainer.make_train_step(flax_mod, tx, with_deep_supervision(get_loss(JConfig(cfg))),
                                    1, ema_decay=EMA)
    rng = np.random.default_rng(6)
    images = rng.standard_normal((3, 1, MICRO, 8, 8, 8, 2)).astype(np.float32)
    labels = rng.integers(0, 4, size=(3, 1, MICRO, 8, 8, 8)).astype(np.int32)
    metrics = []
    for i in range(3):
        if i == 2:
            jsave(state, root / "jax_ckpt", epoch=1, best_metric=0.25,
                  history={"train_loss": [1.5, 1.25], "val_loss": [], "val_dice": [0.25]})
        state, m = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]), jax.random.key(i))
        metrics.append({k: float(v) for k, v in m.items()})
    save_config(ConfigNode(cfg), root / "config.yaml")
    tree = convert_checkpoint(root / "config.yaml", root / "jax_ckpt", root / "port_ckpt")
    return {"cfg": cfg, "root": root, "images": images, "labels": labels, "metrics": metrics,
            "tree": tree, "after": jax.device_get((state.params, state.extra, state.ema_params)),
            "moments": jax.device_get(_moments(state.opt_state))}


def _moments(node):
    """The optax state that holds the moments (adam's ``ScaleByAdamState``,
    adafactor's ``FactoredState``) in a chain of named tuples."""
    if hasattr(node, "nu") or hasattr(node, "v_row"):
        return node
    for child in node if isinstance(node, tuple) else ():
        found = _moments(child)
        if found is not None:
            return found
    return None


def _estimate(v_row, v_col, dims):
    """The second moment adafactor divides by, from its factored moments
    (optax's ``scale_by_factored_rms``): v_row / its mean over the second
    axis, times v_col, each spread over the axis it averages."""
    d1, d0 = dims
    reduced_d1 = d1 - 1 if d1 > d0 else d1
    rows = v_row / v_row.mean(axis=reduced_d1, keepdims=True)
    return np.expand_dims(rows, d0) * np.expand_dims(v_col, d1)


def _second_moments(params, moments):
    """JAX's second moments leaf by leaf in the layout of the weights (adam's
    ``nu``; adafactor's ``v`` or the estimate of a factored leaf), for the
    weights' layout maps to carry into the port's."""
    if hasattr(moments, "nu"):
        return moments.nu
    from multimodal_organ_segmentation_tpu_torch.train.optim import _factored_dims

    def leaf(p, v_row, v_col, v):
        dims = _factored_dims(np.shape(p))
        return np.asarray(v) if dims is None else _estimate(np.asarray(v_row), np.asarray(v_col),
                                                            dims)
    return jax.tree_util.tree_map(leaf, params, moments.v_row, moments.v_col, moments.v)


def test_a_jax_run_resumes_in_the_port(jax_run):
    """The converted state resumes the port's trainer where the JAX run
    stood (step, epoch, best metric, history, EMA, moments), and the port's
    next step is JAX's third: its loss, ``grad_norm``, weights, batch
    statistics and EMA."""
    no_tf32()
    cfg, r = jax_run["cfg"], jax_run
    trainer = Trainer(cfg, device="cpu", resume_from=str(r["root"] / "port_ckpt"))
    trainer.init_state()
    assert trainer.state.step == 2 and trainer.current_epoch == 2
    assert trainer.best_metric == 0.25 and trainer.history["train_loss"] == [1.5, 1.25]
    opt = trainer.state.optimizer.inner
    kinds = {k for slot in opt.state.values() for k in slot}
    assert kinds == ({"step", "exp_avg", "exp_avg_sq"} if cfg["training"]["optimizer"]["name"]
                     == "adamw" else {"step", "v_row", "v_col", "v"})
    step = trainer.train_step_fn()
    _, m = step(trainer.state, torch.from_numpy(r["images"][2]),
                torch.from_numpy(r["labels"][2]).long(), trainer.keys.next())
    want = r["metrics"][2]
    assert abs(float(m["loss"]) - want["loss"]) <= LOSS_TOL, (m, want)
    assert abs(float(m["grad_norm"]) - want["grad_norm"]) <= GNORM_RTOL * want["grad_norm"]
    params, extra, ema = r["after"]
    got = trainer.model.state_dict()
    noise = re.compile(r".*\.conv[12]\.bias")  # a conv block's convs, each before its norm
    for name, w in convert.params_from_jax("unet3d", params, extra["batch_stats"]).items():
        if not noise.fullmatch(name):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=WEIGHT_TOL,
                                       err_msg=name)
    for name, w in convert.params_from_jax("unet3d", ema).items():
        if not noise.fullmatch(name):
            np.testing.assert_allclose(trainer.state.ema_params[name].numpy(), w.numpy(), rtol=0,
                                       atol=WEIGHT_TOL, err_msg=f"ema {name}")
    # the second moments after the step: JAX's in the port's layout (for a
    # factored leaf the estimate adafactor divides by, whichever axis each
    # side calls the row), and adam's first moment
    names = [n for n, _ in trainer.model.named_parameters()]
    slots = [opt.state[p] for p in trainer.model.parameters()]
    want = convert.params_from_jax("unet3d", _second_moments(params, r["moments"]))
    factored = []
    for name, slot in zip(names, slots):
        if noise.fullmatch(name):
            continue
        if "v_row" in slot:
            factored.append(name)
            dims = toptim._factored_dims(tuple(got[name].shape))
            v = _estimate(slot["v_row"].numpy(), slot["v_col"].numpy(), dims)
        else:
            v = slot["v" if "v" in slot else "exp_avg_sq"].numpy()
        np.testing.assert_allclose(v, want[name].numpy(), rtol=MOMENT_RTOL, atol=0,
                                   err_msg=f"second moment {name}")
    if hasattr(r["moments"], "mu"):
        mu = convert.params_from_jax("unet3d", r["moments"].mu)
        for name, slot in zip(names, slots):
            if not noise.fullmatch(name):
                w = mu[name].numpy()
                np.testing.assert_allclose(slot["exp_avg"].numpy(), w, rtol=0,
                                           atol=MOMENT_RTOL * np.abs(w).max(), err_msg=name)
    # the resumed moments matter: the step moved each weight the check holds
    # (adafactor's factored conv above all) by far more than the tolerance
    start = r["tree"]["params"]
    moved = {k: float((got[k] - start[k]).abs().max()) for k in start}
    assert max(moved.values()) > 10 * WEIGHT_TOL, moved
    if cfg["training"]["optimizer"]["name"] == "adafactor":
        assert factored == ["down0.block.conv2.weight"], factored
        assert moved[factored[0]] > 10 * WEIGHT_TOL, moved


def _xattn_de_cfg(root):
    return {"experiment": {"name": "de", "seed": 0, "output_dir": str(root / "out")},
            "data": {"modalities": ["CT", "PET"]},
            "model": {"name": "dual_encoder", "in_channels": 2, "out_channels": 4,
                      "backbone": {"features": [4, 8, 16], "img_size": [16, 16, 16]},
                      "fusion": {"type": "cross_attention", "max_tokens": 512},
                      "head": {"type": "conv", "dropout": 0.0}},
            "training": {"optimizer": {"name": "adamw", "lr": 1e-4}},
            "hardware": {"mixed_precision": "fp32"}}


def _attention_unet_cfg(root):
    return {"experiment": {"name": "attn", "seed": 0, "output_dir": str(root / "out")},
            "data": {"modalities": ["CT", "PET"]},
            "model": {"name": "attention_unet", "in_channels": 2, "out_channels": 4,
                      "backbone": {"features": [4, 8, 8], "img_size": [16, 16, 16]},
                      "head": {"type": "conv", "dropout": 0.0}},
            "training": {"optimizer": {"name": "sgd", "lr": 1e-2, "momentum": 0.9}},
            "hardware": {"mixed_precision": "fp32"}}


@pytest.mark.parametrize("family", ["dual_encoder", "attention_unet"])
def test_weights_the_pth_cannot_carry(tmp_path, family):
    """A cross-attention DualEncoder and an Attention U-Net, which the JAX
    package's ``--format torch`` ``.pth`` does not carry, cross through a
    JAX checkpoint: the port's logits of the converted weights within 1e-4
    of JAX's, and the fresh optimiser state (adamw's moments, sgd's trace)
    mapped slot for slot."""
    no_tf32()
    cfg = (_xattn_de_cfg if family == "dual_encoder" else _attention_unet_cfg)(tmp_path)
    x = np.random.default_rng(3).standard_normal((2, 16, 16, 16, 2)).astype(np.float32)
    x[..., 1] = np.abs(x[..., 1]) * 2.0
    flax_mod = jbuild_model(JConfig(cfg))
    variables = seeded_variables(flax_mod, x, train=False, seed=4)
    _, state = _jax_state(flax_mod, cfg, variables)
    jsave(state, tmp_path / "jax_ckpt", epoch=0)
    logits = np.asarray(jax.jit(lambda v, a: flax_mod.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    save_config(ConfigNode(cfg), tmp_path / "config.yaml")
    tree = convert_checkpoint(tmp_path / "config.yaml", tmp_path / "jax_ckpt", tmp_path / "port")
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state()
    trainer.load_params(str(tmp_path / "port"))
    trainer.model.eval()
    with torch.no_grad():
        got = trainer.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, logits, rtol=0, atol=LOGIT_TOL)
    trainer.state.optimizer.load_state_dict(tree["opt_state"])
    slots = trainer.state.optimizer.inner.state
    assert len(slots) == len(list(trainer.model.parameters()))
    for p in trainer.model.parameters():
        for t in slots[p].values():
            if isinstance(t, torch.Tensor) and t.dim():
                assert t.shape == p.shape and not t.any()
