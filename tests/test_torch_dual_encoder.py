"""The port's fusion modules and DualEncoder against the JAX package's, and
three train steps of a tiny DualEncoder against the JAX trainer's.

f32 on the CPU (the port's cross attention runs kernel B's plain version
under the same ``autograd.Function`` the card uses), weights from
``seeded_variables`` carried by ``convert``. Fusion modules within 2e-5
absolute (O(1) outputs); whole DualEncoders, features (4, 8, 16) at 16³
with ``xattn_max_tokens=512`` (level 0's 4096 tokens add, levels 1 and 2
attend), logits within 1e-4; train steps as ``tests/test_torch_unet3d.py``.

The JAX DualEncoder is built from configs without ``parallel.sequence_axis``:
with the suite's 8 host devices such a config would take the ring path,
which waits for the multi-device slice.
"""

import numpy as np
import pytest
import torch

import jax

from multimodal_organ_segmentation_tpu.models import dual_encoder as jde
from multimodal_organ_segmentation_tpu.models import fusion as jfusion
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfigNode
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.models import dual_encoder as tde
from multimodal_organ_segmentation_tpu_torch.models import fusion as tfusion
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from tests.torch_port_utils import (
    as_np,
    jax_train_steps,
    port,
    seeded_variables,
    torch_train_steps,
)
from tests.torch_port_utils import _one_thread  # noqa: F401

TOL = 2e-5
MODEL_TOL = 1e-4
K, ACCUM = 3, 2
LOSS_TOL, GNORM_RTOL = 1e-4, 1e-3
FUSIONS = ["concat", "add", "attention", "cross_attention", "bidirectional", "suv_guided", "mean"]


def _normal(shape, seed, loc=0.0, scale=1.0):
    return (loc + scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _feats(n, seed, shape=(2, 4, 4, 3, 8)):
    return [_normal(shape, seed + i) for i in range(n)]


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=0, atol=tol)


# -- fusion modules ----------------------------------------------------------

@pytest.mark.parametrize("project", [True, False])
def test_early_fusion(project):
    feats = _feats(2, 0)
    flax_mod = jfusion.EarlyFusion(project=project)
    variables = seeded_variables(flax_mod, feats, False, seed=1) if project else {}
    ref = flax_mod.apply(variables, feats, False)
    mod = tfusion.EarlyFusion([8, 8], project=project)
    if project:
        mod.load_state_dict(convert.state_from_jax(variables["params"], convert.EARLY_FUSION))
    _close(mod([port(f) for f in feats]), ref)


@pytest.mark.parametrize("mode", ["concat", "add", "max", "mean"])
def test_late_fusion(mode):
    feats = _feats(3, 2)
    flax_mod = jfusion.LateFusion(mode=mode)
    variables = seeded_variables(flax_mod, feats, False, seed=3) if mode == "concat" else {}
    ref = flax_mod.apply(variables, feats, False)
    mod = tfusion.LateFusion(mode, [8, 8, 8])
    if mode == "concat":
        mod.load_state_dict(convert.state_from_jax(variables["params"], convert.LATE_FUSION))
    _close(mod([port(f) for f in feats]), ref)


def test_hierarchical_late_fusion():
    levels = [_feats(2, 4, (1, 4, 4, 4, 4)), _feats(2, 6, (1, 2, 2, 2, 8))]
    flax_mod = jfusion.HierarchicalLateFusion(num_levels=2)
    variables = seeded_variables(flax_mod, levels, False, seed=7)
    ref = flax_mod.apply(variables, levels, False)
    mod = tfusion.HierarchicalLateFusion([[4, 4], [8, 8]])
    mod.load_state_dict(convert.state_from_jax(variables["params"],
                                               convert.HIERARCHICAL_LATE_FUSION))
    outs = mod([[port(f) for f in level] for level in levels])
    for out, r in zip(outs, ref):
        _close(out, r)


def test_attention_fusion():
    feats = _feats(3, 8)
    flax_mod = jfusion.AttentionFusion()
    variables = seeded_variables(flax_mod, feats, False, seed=11)
    ref = flax_mod.apply(variables, feats, False)
    mod = tfusion.AttentionFusion(3, 8)
    mod.load_state_dict(convert.state_from_jax(variables["params"], convert.ATTENTION_FUSION))
    _close(mod([port(f) for f in feats]), ref)


def test_bidirectional_cross_attention():
    f1, f2 = _feats(2, 12)
    flax_mod = jfusion.BidirectionalCrossAttention(num_heads=2)
    variables = seeded_variables(flax_mod, f1, f2, False, seed=14)
    ref = flax_mod.apply(variables, f1, f2, False)
    mod = tfusion.BidirectionalCrossAttention(8, num_heads=2)
    mod.load_state_dict(convert.state_from_jax(variables["params"], convert.BIDIRECTIONAL))
    _close(mod(port(f1), port(f2)), ref)


@pytest.mark.parametrize("learnable", [False, True])
def test_suv_guided_attention_resizes_the_suv_volume(learnable):
    ct = _normal((2, 4, 4, 3, 8), 15)
    suv = _normal((2, 8, 8, 6, 1), 16, loc=2.5, scale=1.5)  # around the threshold
    flax_mod = jfusion.SUVGuidedAttention(learnable_threshold=learnable)
    variables = seeded_variables(flax_mod, ct, suv, False, seed=17)
    if learnable:  # away from its init, so a wrong mapping shows
        variables["params"]["threshold"] = np.float32(2.0)
    ref = flax_mod.apply(variables, ct, suv, False)
    mod = tfusion.SUVGuidedAttention(8, learnable_threshold=learnable)
    mod.load_state_dict(convert.state_from_jax(variables["params"], convert.SUV_GUIDED))
    assert (mod.threshold is not None) == learnable
    _close(mod(port(ct), port(suv)), ref)


def test_fusion_registry_names_the_jax_strategies():
    assert set(tfusion.FUSION_REGISTRY) == set(jfusion.FUSION_REGISTRY)
    for name, cls in tfusion.FUSION_REGISTRY.items():
        assert cls.__name__ == jfusion.FUSION_REGISTRY[name].__name__


# -- the DualEncoder ---------------------------------------------------------

def _config(fusion="cross_attention", modalities=("CT", "PET"), head="conv"):
    return {
        "experiment": {"seed": 0},
        "data": {"modalities": list(modalities)},
        "model": {"name": "dual_encoder", "in_channels": len(modalities), "out_channels": 4,
                  "backbone": {"features": [4, 8, 16], "img_size": [16, 16, 16],
                               "norm": "instance"},
                  "fusion": {"type": fusion, "max_tokens": 512},
                  "head": {"type": head, "dropout": 0.0}},
        "training": {"accumulation_steps": ACCUM,
                     "optimizer": {"name": "adamw", "lr": 1e-4, "weight_decay": 1e-5},
                     "loss": {"name": "dice_ce", "dice_weight": 0.5, "ce_weight": 0.5}},
        "hardware": {"mixed_precision": "fp32"},
    }


def _pair(cfg, seed, train=False):
    m = len(cfg["data"]["modalities"])
    x = _normal((2, 16, 16, 16, m), seed)
    x[..., 1] = np.abs(x[..., 1]) * 2.0  # the PET channel: SUV-like values around 2.5
    flax_mod = jde.build_dual_encoder(JConfigNode(cfg))
    assert flax_mod.mesh is None
    variables = seeded_variables(flax_mod, x, train=False, seed=seed + 1)
    ref = jax.jit(lambda v, x: flax_mod.apply(v, x, train=train))(variables, x)
    model = build_model(cfg, device="cpu", train=train)
    model.load_state_dict(convert.params_from_jax("dual_encoder", variables))
    with torch.no_grad():
        out = model(port(x))
    return out, ref, model, variables


@pytest.mark.parametrize("fusion,modalities", [(f, ("CT", "PET")) for f in FUSIONS]
                         + [("cross_attention", ("CT", "PET", "MRI"))])
def test_dual_encoder_matches_flax(fusion, modalities):
    out, ref, model, variables = _pair(_config(fusion, modalities), 20)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, 16, 4)
    _close(out, ref, MODEL_TOL)
    groups = {k.split(".")[0] for k in model.state_dict()}
    assert groups == set(variables["params"])
    if fusion in ("cross_attention", "bidirectional"):  # level 0 adds, 1 and 2 attend
        assert {g for g in groups if g.startswith("fusion_")} == {
            f"fusion_{'xattn' if fusion == 'cross_attention' else 'bixattn'}{lv}" for lv in (1, 2)}


def test_dual_encoder_deep_supervision_outputs_in_training():
    outs, ref, model, _ = _pair(_config(head="deep_supervision"), 30, train=True)
    assert len(outs) == len(ref) == 2
    for out, r in zip(outs, ref):
        assert out.shape == (2, 16, 16, 16, 4)
        _close(out, r, MODEL_TOL)
    params, _ = convert.params_to_jax("dual_encoder", model.state_dict())
    assert "ds_head0" in params and "fusion_xattn2" in params


def test_sequence_axis_is_dropped_on_one_device_and_refused_across_processes(monkeypatch):
    cfg = _config()
    cfg["parallel"] = {"mesh": {"data": -1, "model": 1}, "sequence_axis": "data"}
    model = build_model(cfg, device="cpu")
    assert model.xattn_max_tokens == 512 and hasattr(model, "fusion_xattn1")
    monkeypatch.setattr(tde, "_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="A24"):
        build_model(cfg, device="cpu")


def test_a_level_that_attends_needs_its_module():
    model = build_model(_config(), device="cpu")
    with pytest.raises(ValueError, match="fusion_xattn0"):  # 8³ tokens at level 0 now attend
        model(torch.zeros(1, 8, 8, 8, 2))


def test_dual_encoder_train_steps_match_the_jax_trainer():
    cfg = _config()
    x = np.zeros((1, 16, 16, 16, 2), np.float32)
    flax_mod = jde.build_dual_encoder(JConfigNode(cfg))
    variables = seeded_variables(flax_mod, x, train=False, seed=40)
    rng = np.random.default_rng(41)
    images = rng.normal(size=(K, ACCUM, 1, 16, 16, 16, 2)).astype(np.float32)
    labels = rng.integers(0, 4, size=(K, ACCUM, 1, 16, 16, 16)).astype(np.int32)
    _, _, jm = jax_train_steps(flax_mod, cfg, variables, images, labels, ACCUM)
    state, tm = torch_train_steps("dual_encoder", cfg, variables, images, labels, ACCUM)
    for j, t in zip(jm, tm):
        assert abs(j["loss"] - t["loss"]) <= LOSS_TOL, (jm, tm)
        assert abs(j["grad_norm"] - t["grad_norm"]) <= GNORM_RTOL * j["grad_norm"], (jm, tm)
    init = convert.params_from_jax("dual_encoder", variables)
    moved = [name for name, p in state.model.named_parameters()
             if name.startswith("fusion_xattn") and not torch.equal(p.detach(), init[name])]
    assert len(moved) == 2 * 8  # kernel B's wrapper passes the gradients on to every projection
