"""K optimiser steps of the port's ``make_train_step`` against the JAX
trainer's, from one init carried across with ``swin_unetr_params_from_jax``.

fs=12 SwinUNETR with cross-attention fusion at 32³, adamw + ``dice_ce``,
K = 3 steps of 2 micro-batches of 1 patch, f32 on the CPU (where the port's
attention runs the kernels' plain versions under the same
``autograd.Function``s the card uses).

Tolerances: loss per step 1e-4 absolute (f32 sums in another order over
~40 layers; losses are O(1)); ``grad_norm`` 1e-3 relative; updated weights
1e-4 absolute. Adam divides each gradient element by the root of its own
second moment, so an element whose gradient is rounding noise (|g| near
1e-8, Adam's epsilon) takes steps of up to ±lr whose sign the two packages'
summation orders decide differently. The weights are therefore held to:
at least 99.5% of every leaf's elements within 1e-4 (measured: 99.89% in
the worst leaf), no element further apart than 2·K·lr (the most K such
steps can differ), and the update of all leaves together within 5e-2
relative in norm (the JAX package's own torch-parity test allows 3e-2 for
the same reason). A conv bias that feeds an affine-free instance norm has an
analytically zero gradient, all noise: it is left out of the fraction and
the norm and held to the 2·K·lr bound only. The optimisers' update rules
themselves are held to optax at 1e-6 in ``test_torch_optim.py``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.models import swin_unetr as jswin
from multimodal_organ_segmentation_tpu.train import trainer as jtrainer
from multimodal_organ_segmentation_tpu.train.losses import get_loss as jget_loss
from multimodal_organ_segmentation_tpu.train.losses import with_deep_supervision as jwith_ds
from multimodal_organ_segmentation_tpu.train.optim import make_optimizer as jmake_optimizer
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfigNode
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from multimodal_organ_segmentation_tpu_torch.train.losses import get_loss, with_deep_supervision
from multimodal_organ_segmentation_tpu_torch.train.optim import make_optimizer
from multimodal_organ_segmentation_tpu_torch.train.trainer import (
    TrainState,
    make_train_step,
    select_infer_params,
)
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from tests.torch_port_utils import no_tf32, seeded_variables
from tests.torch_port_utils import _one_thread  # noqa: F401


K = 3
ACCUM = 2
LR = 1e-4
LOSS_TOL = 1e-4
GNORM_RTOL = 1e-3
WEIGHT_TOL = 1e-4


def _config(remat=False, ema=0.0, skip=False, scan_blocks=False, depths=(2, 2, 2, 2)):
    return {
        "experiment": {"seed": 0},
        "data": {"modalities": ["CT", "PET"]},
        "model": {
            "name": "swin_unetr", "in_channels": 2, "out_channels": 8,
            "backbone": {"img_size": [32, 32, 32], "feature_size": 12, "depths": list(depths),
                         "num_heads": [3, 6, 12, 24], "window_size": [6, 6, 6],
                         "scan_blocks": scan_blocks},
            "fusion": {"type": "cross_attention", "stages": [1, 2, 3]},
            "head": {"type": "conv", "dropout": 0.0},
        },
        "training": {
            "accumulation_steps": ACCUM,
            "optimizer": {"name": "adamw", "lr": LR, "weight_decay": 1e-5},
            "loss": {"name": "dice_ce", "dice_weight": 0.5, "ce_weight": 0.5},
            "ema_decay": ema, "skip_nonfinite_updates": skip,
        },
        "parallel": {"remat": remat},
        "hardware": {"mixed_precision": "fp32"},
    }


def _batches(seed=5):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(K, ACCUM, 1, 32, 32, 32, 2)).astype(np.float32)
    labels = rng.integers(0, 8, size=(K, ACCUM, 1, 32, 32, 32)).astype(np.int32)
    return images, labels


@pytest.fixture(scope="module")
def init_variables():
    flax_mod = jswin.build_swin_unetr(JConfigNode(_config()))
    x = np.zeros((1, 32, 32, 32, 2), np.float32)
    return seeded_variables(flax_mod, x, train=False, seed=31)


# The step's own rules (skipping, EMA, dropout draws) do not depend on the
# model's depth: those tests take one block a stage. The shifted-window
# blocks of the second half of each stage are held to the JAX trainer by
# the K-step tests above.
LIGHT = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def light_variables():
    flax_mod = jswin.build_swin_unetr(JConfigNode(_config(depths=LIGHT)))
    return seeded_variables(flax_mod, np.zeros((1, 32, 32, 32, 2), np.float32), train=False,
                            seed=31)


def _torch_setup(cfg, variables):
    no_tf32()
    model = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(convert.swin_unetr_params_from_jax(variables))
    node = ConfigNode(cfg)
    optimizer = make_optimizer(node, model.parameters())
    ema = None
    decay = float(cfg["training"]["ema_decay"]) or None
    if decay:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState(step=0, model=model, optimizer=optimizer, ema_params=ema)
    step = make_train_step(
        model, optimizer, with_deep_supervision(get_loss(node)), ACCUM,
        skip_nonfinite=bool(cfg["training"]["skip_nonfinite_updates"]), ema_decay=decay,
    )
    return state, step


def _torch_run(cfg, variables, images, labels):
    state, step = _torch_setup(cfg, variables)
    out = []
    for i in range(len(images)):
        state, m = step(state, torch.from_numpy(images[i]), torch.from_numpy(labels[i]).long())
        out.append({k: float(v) for k, v in m.items()})
    return state, out


@pytest.fixture(scope="module")
def jax_run(init_variables):
    cfg = JConfigNode(_config())
    flax_mod = jswin.build_swin_unetr(cfg)
    tx = jmake_optimizer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, init_variables["params"])
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=jax.jit(tx.init)(params), extra={},
                                ema_params=None)
    step = jtrainer.make_train_step(flax_mod, tx, jwith_ds(jget_loss(cfg)), ACCUM)
    images, labels = _batches()
    out = []
    for i in range(K):
        state, m = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]), jax.random.key(i))
        out.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state.params), out


@pytest.fixture(scope="module")
def torch_run(init_variables):
    """The port's K steps, under torch's deterministic algorithms: the remat
    test holds its own run to these bit for bit."""
    images, labels = _batches()
    torch.use_deterministic_algorithms(True)
    try:
        return _torch_run(_config(), init_variables, images, labels)
    finally:
        torch.use_deterministic_algorithms(False)


def test_k_step_losses_and_grad_norms_match_the_jax_trainer(jax_run, torch_run):
    _, jm = jax_run
    _, tm = torch_run
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= LOSS_TOL, (jm, tm)
        assert abs(j["grad_norm"] - t["grad_norm"]) <= GNORM_RTOL * j["grad_norm"], (jm, tm)
    assert all(np.isfinite(t["loss"]) for t in tm)


def _zero_grad_leaf(path) -> bool:
    """A conv bias in front of an affine-free instance norm: the norm
    removes any per-channel constant, so its gradient is analytically 0."""
    names = [str(getattr(p, "key", p)) for p in path]
    in_res_block = any(n.startswith(("encoder", "decoder")) for n in names[:1])
    return in_res_block and names[-1] == "bias" and names[-2].startswith("Conv_")


def test_k_step_updated_weights_match_the_jax_trainer(jax_run, torch_run, init_variables):
    jparams, _ = jax_run
    state, _ = torch_run
    back = convert.swin_unetr_params_to_jax(state.model.state_dict())
    ref = jax.tree_util.tree_leaves_with_path(jparams)
    got = jax.tree_util.tree_leaves_with_path(back)
    init = jax.tree_util.tree_leaves(init_variables["params"])
    assert [p for p, _ in ref] == [p for p, _ in got]
    num = den = 0.0
    for (path, r), (_, g), i in zip(ref, got, init):
        r = np.asarray(r)
        err = np.abs(r - g)
        name = jax.tree_util.keystr(path)
        assert float(err.max()) <= 2 * K * LR * 1.01, (name, float(err.max()))
        if _zero_grad_leaf(path):
            continue
        assert float((err > WEIGHT_TOL).mean()) <= 0.005, (name, float((err > WEIGHT_TOL).mean()))
        num += float(((r - i) - (g - i)).astype(np.float64).__pow__(2).sum())
        den += float((r - i).astype(np.float64).__pow__(2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 5e-2, (num / den) ** 0.5
    # the weights did move, by about K·lr where the gradient is not noise
    assert den ** 0.5 > 0.1 * K * LR * sum(np.size(i) for i in init) ** 0.5


def test_remat_on_equals_remat_off_exactly(init_variables, torch_run):
    """Recomputing a block's forward changes no bit of the step. The gather
    of the relative-position bias has a scatter-add for a backward, whose
    order varies from run to run on its own, so both runs use torch's
    deterministic algorithms; the run without remat is ``torch_run``."""
    images, labels = _batches()
    state_off, m_off = torch_run
    torch.use_deterministic_algorithms(True)
    try:
        state_on, m_on = _torch_run(_config(remat=True), init_variables, images, labels)
    finally:
        torch.use_deterministic_algorithms(False)
    assert state_on.model.use_remat and not state_off.model.use_remat
    assert m_on == m_off
    for (n, a), (_, b) in zip(state_on.model.named_parameters(),
                              state_off.model.named_parameters()):
        assert torch.equal(a, b), n


def test_attention_parameters_get_gradients(init_variables):
    """What a detached kernel wrapper would break: every relative-position
    table, qkv and fusion projection has a non-zero gradient. At 32³ the /32
    fusion sees one voxel, whose instance norm is exactly 0 whatever went in:
    that stage's projections have a zero gradient by construction."""
    state, _ = _torch_setup(_config(), init_variables)
    images, labels = _batches()
    model = state.model
    loss = with_deep_supervision(get_loss(ConfigNode(_config())))(
        model(torch.from_numpy(images[0, 0])), torch.from_numpy(labels[0, 0]).long())
    loss.backward()
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith("xfuse3."):
            continue
        if any(s in name for s in ("rel_pos_bias", "attn.qkv", "q_proj", "k_proj", "v_proj")):
            assert p.grad is not None and float(p.grad.abs().max()) > 0, name
            checked += 1
    assert checked == 8 + 16 + 2 * 6


def test_skip_nonfinite_leaves_params_moments_and_ema_untouched(light_variables):
    cfg = _config(ema=0.9, skip=True, depths=LIGHT)
    state, step = _torch_setup(cfg, light_variables)
    images, labels = _batches()
    state, m = step(state, torch.from_numpy(images[0]), torch.from_numpy(labels[0]).long())
    assert float(m["skipped"]) == 0.0
    before = copy.deepcopy({"p": state.model.state_dict(), "o": state.optimizer.state_dict(),
                            "e": state.ema_params})
    bad = images[1].copy()
    bad[0, 0, 3, 3, 3, 0] = np.nan
    state, m = step(state, torch.from_numpy(bad), torch.from_numpy(labels[1]).long())
    assert float(m["skipped"]) == 1.0 and not np.isfinite(float(m["loss"]))
    assert state.step == 2  # the step still advances
    for n, t in state.model.state_dict().items():
        assert torch.equal(t, before["p"][n]), n
    for n, t in state.ema_params.items():
        assert torch.equal(t, before["e"][n]), n
    now = state.optimizer.state_dict()["state"]
    for idx, slot in before["o"]["state"].items():
        for k, v in slot.items():
            assert torch.equal(torch.as_tensor(now[idx][k]), torch.as_tensor(v)), (idx, k)
    # and a finite batch afterwards steps again
    state, m = step(state, torch.from_numpy(images[2]), torch.from_numpy(labels[2]).long())
    assert float(m["skipped"]) == 0.0 and np.isfinite(float(m["loss"]))


def test_ema_rule_and_infer_param_selection(light_variables):
    """e ← d·e + (1−d)·p from e₀ = p₀, on the params after the update."""
    d = 0.9
    cfg = _config(ema=d, depths=LIGHT)
    state, step = _torch_setup(cfg, light_variables)
    images, labels = _batches()
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    for n in p0:
        assert torch.equal(state.ema_params[n], p0[n])
    state, _ = step(state, torch.from_numpy(images[0]), torch.from_numpy(labels[0]).long())
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema_params[n], d * p0[n] + (1 - d) * p.detach(),
                                   rtol=1e-6, atol=1e-7)
    assert select_infer_params(state, ConfigNode(cfg)) is state.ema_params
    off = ConfigNode({"training": {"ema_eval": False}})
    assert set(select_infer_params(state, off)) == set(p0)
    assert select_infer_params(state, off) is not state.ema_params


def test_wrong_accumulation_count_raises(init_variables):
    state, step = _torch_setup(_config(), init_variables)
    images, labels = _batches()
    with pytest.raises(ValueError, match="micro-batches"):
        step(state, torch.from_numpy(images[0][:1]), torch.from_numpy(labels[0][:1]).long())


def test_dropout_draws_follow_the_step_key(light_variables):
    """With an active dropout the step's key decides the draws, and torch's
    global generator is left where it was."""
    from multimodal_organ_segmentation_tpu_torch.utils.prng import KeyStream

    cfg = _config(depths=LIGHT)
    cfg["model"]["head"]["dropout"] = 0.2
    images, labels = _batches()
    x, y = torch.from_numpy(images[0]), torch.from_numpy(labels[0]).long()

    def first_loss(key):
        state, step = _torch_setup(cfg, light_variables)
        torch.manual_seed(123)
        before = torch.get_rng_state()
        _, m = step(state, x, y, key)
        assert torch.equal(torch.get_rng_state(), before)
        return float(m["loss"])

    a, b = first_loss(KeyStream(1).next()), first_loss(KeyStream(1).next())
    c = first_loss(KeyStream(1, counter=1).next())
    assert a == b and a != c
