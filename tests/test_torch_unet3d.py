"""UNet3D and AttentionUNet3D of the port against the JAX package's, and
three train steps of a batch-norm UNet3D against the JAX trainer's.

Models: features (4, 8, 16) at 16³, f32 on the CPU, weights from
``seeded_variables`` carried by ``convert.params_from_jax``; logits within
1e-4 absolute (O(1) logits after ~15 layers, each summed in f32 in another
order). The attention gate alone within 2e-5. Train steps: 3 AdamW steps of
2 micro-batches, loss within 1e-4 and ``grad_norm`` within 1e-3 relative (as
``tests/test_torch_train_step.py``), the running statistics within 1e-5
after the steps.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from multimodal_organ_segmentation_tpu.models import attention_unet as jattn
from multimodal_organ_segmentation_tpu.models import unet3d as junet
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfigNode
from multimodal_organ_segmentation_tpu_torch.models import attention_unet as tattn
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from multimodal_organ_segmentation_tpu_torch.models.unet3d import UNet3D
from multimodal_organ_segmentation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from multimodal_organ_segmentation_tpu_torch.train.trainer import _dropout_active
from multimodal_organ_segmentation_tpu_torch.utils.prng import KeyStream
from tests.torch_port_utils import (
    as_np,
    jax_train_steps,
    port,
    seeded_variables,
    torch_train_setup,
    torch_train_steps,
)
from tests.torch_port_utils import _one_thread  # noqa: F401

MODEL_TOL = 1e-4
TOL = 2e-5
K, ACCUM = 3, 2
LOSS_TOL, GNORM_RTOL, STATS_TOL = 1e-4, 1e-3, 1e-5


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _config(name="unet3d", norm="instance", head="conv", dropout=0.0):
    return {
        "experiment": {"seed": 0},
        "data": {"modalities": ["CT", "PET"]},
        "model": {"name": name, "in_channels": 2, "out_channels": 4,
                  "backbone": {"features": [4, 8, 16], "img_size": [16, 16, 16], "norm": norm},
                  "head": {"type": head, "dropout": dropout}},
        "training": {"accumulation_steps": ACCUM,
                     "optimizer": {"name": "adamw", "lr": 1e-4, "weight_decay": 1e-5},
                     "loss": {"name": "dice_ce", "dice_weight": 0.5, "ce_weight": 0.5}},
        "hardware": {"mixed_precision": "fp32"},
    }


def _jax_model(cfg):
    build = jattn.build_attention_unet if cfg["model"]["name"] == "attention_unet" else junet.build_unet3d
    return build(JConfigNode(cfg))


def _forward_pair(cfg, seed, train=False):
    x = _normal((2, 16, 16, 16, 2), seed)
    flax_mod = _jax_model(cfg)
    variables = seeded_variables(flax_mod, x, train=False, seed=seed + 1)
    mutable = ["batch_stats"] if (train and "batch_stats" in variables) else False
    ref = flax_mod.apply(variables, x, train=train, mutable=mutable)
    ref = ref[0] if mutable else ref
    model = build_model(cfg, device="cpu", train=train)
    name = cfg["model"]["name"]
    model.load_state_dict(convert.params_from_jax(name, variables["params"],
                                                  variables.get("batch_stats")))
    with torch.no_grad():
        out = model(port(x))
    return out, ref, model, variables


@pytest.mark.parametrize("name,norm", [("unet3d", "instance"), ("unet3d", "batch"),
                                       ("attention_unet", "instance")])
def test_model_forward_matches_flax(name, norm):
    out, ref, _, _ = _forward_pair(_config(name, norm), 20)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, 16, 4)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=0, atol=MODEL_TOL)


def test_unet3d_deep_supervision_outputs_in_training():
    """Training returns [main, aux_fine, ...] upsampled to the tile, as the
    flax model; eval the logits alone. (4, 8, 16) has one intermediate
    stage, so one aux head."""
    cfg = _config(head="deep_supervision")
    outs, ref, model, variables = _forward_pair(cfg, 30, train=True)
    assert "ds_head0" in variables["params"] and len(outs) == len(ref) == 2
    for out, r in zip(outs, ref):
        assert out.shape == (2, 16, 16, 16, 4)
        np.testing.assert_allclose(as_np(out), np.asarray(r), rtol=0, atol=MODEL_TOL)
    with torch.no_grad():
        logits = model.eval()(port(_normal((1, 16, 16, 16, 2), 31)))
    assert isinstance(logits, torch.Tensor) and logits.shape == (1, 16, 16, 16, 4)


@pytest.mark.parametrize("grid", [(8, 8, 8), (9, 7, 5)])
def test_attention_gate_pads_an_odd_grid_at_the_end(grid):
    """flax's stride-2 SAME conv on an odd side gives ceil(n/2) outputs and
    pads at the end; the gate's output keeps the skip's grid."""
    x = _normal((2, *grid, 6), 40)
    g = _normal((2, *[(s + 1) // 2 for s in grid], 10), 41)
    flax_mod = jattn.AttentionGate(3)
    variables = seeded_variables(flax_mod, x, g, False, seed=42)
    ref = flax_mod.apply(variables, x, g, False)
    mod = tattn.AttentionGate(6, 10, 3)
    mod.load_state_dict(convert.state_from_jax(variables["params"], convert.GATE))
    out = mod(port(x).permute(0, 4, 1, 2, 3), port(g).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(as_np(out.permute(0, 2, 3, 4, 1)), np.asarray(ref), rtol=0, atol=TOL)


def test_params_round_trip_through_the_flax_layout():
    """``params_to_jax`` inverts ``params_from_jax``, batch stats included."""
    _, _, model, variables = _forward_pair(_config(norm="batch", head="deep_supervision"), 50)
    params, stats = convert.params_to_jax("unet3d", model.state_dict())
    for ref, got in ((variables["params"], params), (variables["batch_stats"], stats)):
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in ref_leaves] == [p for p, _ in got_leaves]
        for (_, r), (_, g) in zip(ref_leaves, got_leaves):
            np.testing.assert_array_equal(np.asarray(r), g)


# -- train steps of a batch-norm UNet3D --------------------------------------

def _batches(seed=5):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(K, ACCUM, 1, 16, 16, 16, 2)).astype(np.float32)
    labels = rng.integers(0, 4, size=(K, ACCUM, 1, 16, 16, 16)).astype(np.int32)
    return images, labels


@pytest.fixture(scope="module")
def bn_variables():
    cfg = _config(norm="batch")
    return seeded_variables(_jax_model(cfg), np.zeros((1, 16, 16, 16, 2), np.float32),
                            train=False, seed=60)


def test_batch_norm_unet3d_train_steps_match_the_jax_trainer(bn_variables):
    cfg = _config(norm="batch")
    images, labels = _batches()
    _, jextra, jm = jax_train_steps(_jax_model(cfg), cfg, bn_variables, images, labels, ACCUM)
    state, tm = torch_train_steps("unet3d", cfg, bn_variables, images, labels, ACCUM)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= LOSS_TOL, (jm, tm)
        assert abs(j["grad_norm"] - t["grad_norm"]) <= GNORM_RTOL * j["grad_norm"], (jm, tm)
    _, stats = convert.params_to_jax("unet3d", state.model.state_dict())
    ref = jax.tree_util.tree_leaves_with_path(jextra["batch_stats"])
    got = jax.tree_util.tree_leaves_with_path(stats)
    assert [p for p, _ in ref] == [p for p, _ in got] and len(ref) == 2 * 2 * 5
    moved = 0.0
    for (path, r), (_, g), (_, r0) in zip(ref, got, jax.tree_util.tree_leaves_with_path(
            bn_variables["batch_stats"])):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=STATS_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, float(np.abs(np.asarray(r) - r0).max()))
    assert moved > 1e-3  # 6 forward passes moved the statistics


def test_skipped_step_restores_the_running_statistics(bn_variables, tmp_path):
    """A NaN batch through a batch-norm UNet3D: the forward passes update
    the running statistics in place, and the skipped step puts every buffer
    back bit for bit; a checkpoint saved then and loaded into a fresh model
    gives the same buffers."""
    cfg = _config(norm="batch")
    state, step = torch_train_setup("unet3d", cfg, bn_variables, ACCUM, skip_nonfinite=True)
    images, labels = _batches()
    state, m = step(state, torch.from_numpy(images[0]), torch.from_numpy(labels[0]).long())
    assert float(m["skipped"]) == 0.0
    before = copy.deepcopy(dict(state.model.named_buffers()))
    bad = images[1].copy()
    bad[1, 0, 3, 3, 3, 0] = np.nan
    state, m = step(state, torch.from_numpy(bad), torch.from_numpy(labels[1]).long())
    assert float(m["skipped"]) == 1.0
    buffers = dict(state.model.named_buffers())
    assert len(buffers) == 2 * 2 * 5 and buffers.keys() == before.keys()
    for name, b in buffers.items():
        assert torch.equal(b, before[name]), name
    save_checkpoint(state.tree(), tmp_path / "ckpt")
    fresh = build_model(cfg, device="cpu", train=True)
    fresh.load_state_dict(load_checkpoint(tmp_path / "ckpt")["tree"]["params"])
    for name, b in fresh.named_buffers():
        assert torch.equal(b, before[name]), name


def test_channel_dropout_draws_follow_the_step_key(bn_variables):
    """``Dropout3D`` in the model turns the step's dropout seeding on: two
    steps from the same state with the same key draw the same channel masks
    (equal losses), another key draws others."""
    cfg = _config(norm="batch", dropout=0.5)
    images, labels = _batches()
    x, y = torch.from_numpy(images[0]), torch.from_numpy(labels[0]).long()

    def first_loss(key):
        state, step = torch_train_setup("unet3d", cfg, bn_variables, ACCUM)
        assert _dropout_active(state.model)
        torch.manual_seed(123)
        before = torch.get_rng_state()
        _, m = step(state, x, y, key)
        assert torch.equal(torch.get_rng_state(), before)
        return float(m["loss"])

    a, b = first_loss(KeyStream(1).next()), first_loss(KeyStream(1).next())
    c = first_loss(KeyStream(1, counter=1).next())
    assert a == b and a != c
    assert not _dropout_active(UNet3D(features=(4, 8), dropout=0.0))
