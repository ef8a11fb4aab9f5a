"""The port's optimisers and schedules against optax and the JAX package.

Five updates of a small numpy tree with seeded gradients go through
``make_optimizer`` of both packages. Tolerance 1e-6 absolute on weights of
O(1) moved by lr = 1e-2 a step: the update rules are the same up to f32
rounding (torch's AdamW decays ``p`` by ``1 - lr*wd`` before the step where
optax adds ``lr*wd*p`` to it: a difference of lr²·wd·|direction| = 1e-6·|d|
at these rates, so the adamw-with-decay case states 2e-6). The schedules are
pure Python copies and must agree exactly.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.train import optim as joptim
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfigNode
from multimodal_organ_segmentation_tpu_torch.train import optim as toptim
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from tests.torch_port_utils import _one_thread  # noqa: F401

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
    opt = toptim.make_optimizer(ConfigNode(_cfg("adafactor", 1e-3, 0.0)), p)
    assert isinstance(opt.inner, toptim.Adafactor) and opt.param_groups[0]["weight_decay"] == 1e-3


def _factored_tree(seed=4):
    """The small tree plus a tensor whose two largest axes reach optax's
    128 (factored second moments) and one whose second-largest does not."""
    params, grads = _tree(seed)
    rng = np.random.default_rng(seed + 1)
    for k, shape in (("f", (2, 130, 128)), ("n", (127, 300))):
        params[k] = rng.normal(size=shape).astype(np.float32)
        for scale, g in zip((1.0, 0.1, 3.0, 0.5, 2.0), grads):
            g[k] = (scale * rng.normal(size=shape)).astype(np.float32)
    return params, grads


@pytest.mark.parametrize("clip", [0.0, 0.7])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adafactor_matches_optax(wd, clip):
    """optax.adafactor with its defaults (factored rms, block-rms clipping,
    parameter-scale, decay) over five steps with changing learning rates."""
    params, grads = _factored_tree()
    cfg = _cfg("adafactor", wd, clip)
    lrs = [1e-2, 2e-2, 5e-3, 1e-2, 3e-2]
    ref = _run_jax(cfg, params, grads, lrs)
    out = _run_torch(cfg, params, grads, lrs)
    for k in params:
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=TOL, err_msg=k)
        assert not np.array_equal(out[k], params[k]), k


def test_adafactor_factors_the_same_axes_in_torch_layout():
    """A flax Dense kernel ``[in, out]`` is a torch Linear ``[out, in]``: the
    factored axes are found by size, so the transposed tensor takes the
    transposed update (up to the order of one mean)."""
    params, grads = _factored_tree(7)
    lrs = [1e-2] * STEPS
    ref = _run_jax(_cfg("adafactor", 0.0, 0.0), {"k": params["f"][0]},
                   [{"k": g["f"][0]} for g in grads], lrs)
    out = _run_torch(_cfg("adafactor", 0.0, 0.0), {"k": params["f"][0].T},
                     [{"k": g["f"][0].T} for g in grads], lrs)
    np.testing.assert_allclose(out["k"].T, ref["k"], rtol=0, atol=TOL)


class _ThreadGroup:
    """Threads standing in for the ranks of a group: ``sum`` adds every
    member's tensors in place, as an all_reduce would."""

    def __init__(self, size):
        self.barrier, self.slots = threading.Barrier(size, timeout=60), {}

    def sum(self, tensors, rank):
        self.slots[rank] = [t.clone() for t in tensors]
        self.barrier.wait()
        for i, t in enumerate(tensors):
            t.copy_(sum(self.slots[r][i] for r in sorted(self.slots)))
        self.barrier.wait()


def _pieces_step(shape, cuts, init, grads, lrs):
    """Each piece of a leaf cut by ``cuts`` ((dim, n) each, a grid of
    threads) stepped by its own ``Adafactor`` whose groups are thread groups
    (a group is ``(_ThreadGroup, the thread's rank in it)``, summed by the
    caller's stand-in for ``optim.sum_over``); returns every piece's weights
    and optimiser by grid position."""
    coords = list(np.ndindex(*[n for _, n in cuts]))

    def others(at, i):
        return tuple(c for j, c in enumerate(at) if j != i)

    groups = {(i, others(at, i)): _ThreadGroup(n) for i, (_, n) in enumerate(cuts)
              for at in coords}
    out = {}

    def piece(t, at):
        for (dim, n), c in zip(cuts, at):
            t = t.chunk(n, dim)[c]
        return t.contiguous()

    def rank(at):
        handles = [(groups[(i, others(at, i))], at[i]) for i in range(len(cuts))]
        part = toptim.Part(shape, tuple((dim, h) for (dim, _), h in zip(cuts, handles)))
        p = torch.nn.Parameter(piece(torch.from_numpy(init), at).clone())
        opt = toptim.Adafactor([p], lr=lrs[0], weight_decay=1e-2, parts=[part])
        for lr, g in zip(lrs, grads):
            toptim.set_learning_rate(opt, lr)
            p.grad = piece(torch.from_numpy(g), at)
            opt.step()
        out[at] = (p.detach(), opt.state[p])

    threads = [threading.Thread(target=rank, args=(at,)) for at in coords]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(out) == coords, (shape, cuts)
    return out


def test_adafactor_of_a_leaf_in_pieces_equals_the_whole_leaf(monkeypatch):
    """Leaves cut over ranks (threads here, whose group sums stand in for the
    all_reduce of a ZeRO-1 data group or a tensor-parallel model group), each
    piece stepped by an ``Adafactor`` told the whole shape and its cuts:
    five steps give the whole leaf's weights, and each rank's moments are
    its piece of the whole leaf's (``moment_dim``), for a leaf cut along its
    largest axis (``v_row`` whole on each rank), its second largest
    (``v_col`` whole), a third axis, an unfactored leaf, a leaf cut along
    two axes over a 2 × 2 grid of groups, and one under the 1e-3 RMS floor,
    weight decay on."""
    monkeypatch.setattr(toptim, "sum_over", lambda ts, h: h[0].sum(ts, h[1]))
    rng = np.random.default_rng(11)
    cases = [((2, 130, 128), ((1, 2),)), ((2, 130, 128), ((2, 2),)), ((2, 130, 128), ((0, 2),)),
             ((127, 300), ((1, 2),)), ((2, 130, 128), ((1, 2), (2, 2))), ((6, 4), ((0, 2),))]
    lrs = [1e-2, 2e-2, 5e-3, 1e-2, 3e-2]
    for shape, cuts in cases:
        scale = 1e-4 if shape == (6, 4) else 1.0
        init = (scale * rng.normal(size=shape)).astype(np.float32)
        grads = [rng.normal(size=shape).astype(np.float32) for _ in lrs]
        whole = torch.nn.Parameter(torch.from_numpy(init.copy()))
        ref = toptim.Adafactor([whole], lr=lrs[0], weight_decay=1e-2)
        for lr, g in zip(lrs, grads):
            toptim.set_learning_rate(ref, lr)
            whole.grad = torch.from_numpy(g)
            ref.step()
        out = _pieces_step(shape, cuts, init, grads, lrs)
        for at, (p, state) in out.items():
            want = whole.detach()
            for (dim, n), c in zip(cuts, at):
                want = want.chunk(n, dim)[c]
            np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=0, atol=TOL,
                                       err_msg=f"{shape} {cuts} {at}")
            for key, v in ref.state[whole].items():
                if not isinstance(v, torch.Tensor):
                    assert state[key] == v
                    continue
                for (dim, n), c in zip(cuts, at):
                    d = toptim.moment_dim(key, v.dim(), shape, dim)
                    v = v if d is None else v.chunk(n, d)[c]
                np.testing.assert_allclose(state[key].numpy(), v.numpy(), rtol=1e-5, atol=0,
                                           err_msg=f"{shape} {cuts} {at} {key}")
        assert np.abs(whole.detach().numpy() - init).max() > 1e-3 * scale


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
