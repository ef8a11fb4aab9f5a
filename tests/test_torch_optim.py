"""The port's optimisers and schedules against optax and the JAX package.

Five updates of a small numpy tree with seeded gradients go through
``make_optimizer`` of both packages. Tolerance 1e-6 absolute on weights of
O(1) moved by lr = 1e-2 a step: the update rules are the same up to f32
rounding (torch's AdamW decays ``p`` by ``1 - lr*wd`` before the step where
optax adds ``lr*wd*p`` to it: a difference of lr²·wd·|direction| = 1e-6·|d|
at these rates, so the adamw-with-decay case states 2e-6). The schedules are
pure Python copies and must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.train import optim as joptim
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfigNode
from multimodal_organ_segmentation_tpu_torch.train import optim as toptim
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

STEPS = 5
TOL = 1e-6


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32),
              "t": rng.normal(size=(2, 2, 2)).astype(np.float32)}
    grads = [{k: (scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for scale in (1.0, 0.1, 3.0, 0.5, 2.0)]
    return params, grads


def _cfg(name, wd, clip, **extra):
    return {"training": {"optimizer": {"name": name, "lr": 1e-2, "weight_decay": wd, **extra},
                         "grad_clip_norm": clip}}


def _run_jax(cfg, params, grads, lrs=None):
    tx = joptim.make_optimizer(JConfigNode(cfg))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    for i, g in enumerate(grads):
        if lrs is not None:
            state = joptim.set_learning_rate(state, lrs[i])
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
    return jax.device_get(p)


def _run_torch(cfg, params, grads, lrs=None):
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = toptim.make_optimizer(ConfigNode(cfg), p.values())
    for i, g in enumerate(grads):
        if lrs is not None:
            toptim.set_learning_rate(opt, lrs[i])
        for k in p:
            p[k].grad = torch.from_numpy(g[k].copy())
        opt.step()
        opt.zero_grad()
    return {k: v.detach().numpy() for k, v in p.items()}


@pytest.mark.parametrize("clip", [0.0, 0.7])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_five_updates_match_optax(name, wd, clip):
    params, grads = _tree()
    cfg = _cfg(name, wd, clip)
    ref, out = _run_jax(cfg, params, grads), _run_torch(cfg, params, grads)
    tol = 2e-6 if (name == "adamw" and wd) else TOL
    for k in params:
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0, atol=tol, err_msg=k)
        assert np.abs(out[k] - params[k]).max() > 1e-3  # it moved


def test_adamw_betas_momentum_and_injected_learning_rates():
    params, grads = _tree(1)
    lrs = [1e-2, 5e-3, 2e-2, 1e-3, 1e-2]
    for cfg in (_cfg("adamw", 0.0, 0.0, betas=[0.8, 0.99]), _cfg("sgd", 0.0, 0.0, momentum=0.5)):
        ref, out = _run_jax(cfg, params, grads, lrs), _run_torch(cfg, params, grads, lrs)
        for k in params:
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0, atol=TOL, err_msg=k)


def test_unknown_optimizer_name_is_adamw():
    params, grads = _tree(2)
    a = _run_torch(_cfg("no_such_optimizer", 1e-2, 0.0), params, grads)
    b = _run_torch(_cfg("adamw", 1e-2, 0.0), params, grads)
    for k in params:
        assert np.array_equal(a[k], b[k])


def test_clip_rule_is_optax_global_norm():
    """g · min(1, c/‖g‖): untouched below the threshold, scaled to it above."""
    p = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2, 2))]
    opt = toptim.ChainedOptimizer(torch.optim.SGD(p, lr=1.0), clip_norm=1.0)
    g = [torch.tensor([3.0, 0.0, 0.0]), torch.tensor([[0.0, 4.0], [0.0, 0.0]])]
    assert float(toptim.global_norm(g)) == 5.0
    for q, gi in zip(p, g):
        q.grad = gi.clone()
    opt.step()
    np.testing.assert_allclose(p[0].detach().numpy(), [-0.6, 0, 0], atol=1e-7)
    np.testing.assert_allclose(p[1].detach().numpy(), [[0, -0.8], [0, 0]], atol=1e-7)
    for q, gi in zip(p, g):
        q.data.zero_()
        q.grad = 0.1 * gi
    opt.step()
    np.testing.assert_allclose(p[0].detach().numpy(), [-0.3, 0, 0], atol=1e-7)


def test_learning_rate_accessors_and_adafactor():
    p = [torch.nn.Parameter(torch.zeros(3))]
    opt = toptim.make_optimizer(ConfigNode(_cfg("adamw", 0.0, 0.0)), p)
    assert toptim.get_learning_rate(opt) == 1e-2
    assert toptim.get_learning_rate(toptim.set_learning_rate(opt, 3e-4)) == 3e-4
    with pytest.raises(NotImplementedError, match="adafactor"):
        toptim.make_optimizer(ConfigNode(_cfg("adafactor", 0.0, 0.0)), p)


SCHEDULES = {
    "cosine": {"name": "cosine", "min_lr": 1e-6},
    "cosine_warmup_only_shortens_t_max": {"name": "cosine", "warmup_epochs": 10, "min_lr": 1e-6},
    "cosine_warmup_ramp": {"name": "cosine", "warmup_epochs": 5, "warmup": True},
    "step": {"name": "step", "step_size": 7, "gamma": 0.5},
    "poly": {"name": "poly", "power": 0.9},
    "poly_warmup_ramp": {"name": "poly", "warmup_epochs": 4, "warmup": True, "min_lr": 1e-5},
    "plateau": {"name": "plateau", "patience": 2, "factor": 0.5},
    "constant": {"name": "none"},
    "default": {},
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_over_30_epochs_is_exact(case):
    cfg = {"training": {"epochs": 30, "optimizer": {"lr": 2e-4}, "scheduler": SCHEDULES[case]}}
    ref, out = joptim.LRScheduler(JConfigNode(cfg)), toptim.LRScheduler(ConfigNode(cfg))
    rng = np.random.default_rng(7)
    metric = None
    for epoch in range(30):
        assert out.lr_for_epoch(epoch, metric=metric) == ref.lr_for_epoch(epoch, metric=metric)
        metric = float(rng.uniform()) if epoch % 3 else 0.1
