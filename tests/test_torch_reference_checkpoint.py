"""Reference ``.pth`` interchange (``models/torch_import.py``,
``models/torch_export.py``) and the MONAI-compatible SwinUNETR
(``model.backbone.monai_compat``) against the JAX package.

Models: UNet3D and DualEncoder (features 4-8-16) and a ``monai_compat``
SwinUNETR (fs 12, 32³, 4³ windows, so the last stage's 2³ grid clamps the
window and MONAI's constructor-window table applies), with seeded JAX
parameters carried by ``convert``. The port's export equals the JAX
package's ``to_torch_*`` dict exactly, and import(export) is exact (both are
copies and reshapes). The ``monai_compat`` logits are held to JAX's and to
``tests/monai_swin_replica.py``'s within 1e-4 (relative to the logits'
scale for the replica, whose LayerNorms take torch's eps): ~40 f32 layers
in another summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.models import dual_encoder as jde
from multimodal_organ_segmentation_tpu.models import swin_unetr as jswin
from multimodal_organ_segmentation_tpu.models import torch_export as jexport
from multimodal_organ_segmentation_tpu.models import torch_import as jimport
from multimodal_organ_segmentation_tpu.models import unet3d as junet
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch.models import convert, torch_export, torch_import
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from tests.monai_swin_replica import MonaiSwinUNETR
from tests.torch_port_utils import _one_thread, no_tf32, port, seeded_variables  # noqa: F401

MODEL_TOL = 1e-4
ROI = (32, 32, 32)


def _config(name, **backbone):
    cfg = {"data": {"modalities": ["CT", "PET"]},
           "model": {"name": name, "in_channels": 2, "out_channels": 4,
                     "backbone": {"features": [4, 8, 16], "img_size": [16, 16, 16], **backbone},
                     "fusion": {"type": "concat"}, "head": {"type": "conv", "dropout": 0.0}},
           "hardware": {"mixed_precision": "fp32"}}
    if name == "swin_unetr":
        cfg["model"]["backbone"] = {"img_size": list(ROI), "feature_size": 12,
                                    "depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24],
                                    "window_size": [4, 4, 4], "monai_compat": True, **backbone}
        cfg["model"]["fusion"] = {"type": "early"}
    return cfg


def _jax_model(cfg):
    node = JConfig(cfg)
    name = cfg["model"]["name"]
    if name == "swin_unetr":
        return jswin.build_swin_unetr(node)
    return jde.build_dual_encoder(node) if name == "dual_encoder" else junet.build_unet3d(node)


def _seeded_params(cfg, seed):
    """Seeded JAX params with zero conv biases wherever MONAI has none (a
    trained bias there is what the export warns about)."""
    size = cfg["model"]["backbone"]["img_size"]
    params = seeded_variables(_jax_model(cfg), np.zeros((1, *size, 2), np.float32), train=False,
                              seed=seed)["params"]
    if cfg["model"]["name"] == "swin_unetr":
        for key, node in params.items():
            if key.startswith(("encoder", "decoder")):
                for path, leaf in jax.tree_util.tree_flatten_with_path(node)[0]:
                    if str(getattr(path[-1], "key", "")) == "bias":
                        leaf[...] = 0.0
    return params


CASES = {
    "unet3d": (_config("unet3d"), lambda p: jexport.to_torch_unet3d(p, 3),
               lambda s: torch_export.to_torch_unet3d(s, 3)),
    "swin_unetr": (_config("swin_unetr"),
                   lambda p: jexport.to_torch_swin_unetr(p, (2, 2, 2, 2), (4, 4, 4)),
                   lambda s: torch_export.to_torch_swin_unetr(s, (2, 2, 2, 2), (4, 4, 4))),
    "dual_encoder_concat": (_config("dual_encoder"),
                            lambda p: jexport.to_torch_dual_encoder(p, 3, 2, "concat"),
                            lambda s: torch_export.to_torch_dual_encoder(s, 3, 2, "concat")),
}
CASES["dual_encoder_attention"] = (
    {**_config("dual_encoder"), "model": {**_config("dual_encoder")["model"],
                                          "fusion": {"type": "attention"}}},
    lambda p: jexport.to_torch_dual_encoder(p, 3, 2, "attention"),
    lambda s: torch_export.to_torch_dual_encoder(s, 3, 2, "attention"))


@pytest.fixture(scope="module")
def states():
    """Per case: the JAX params and the port's state carried by convert."""
    out = {}
    for i, (case, (cfg, _, _)) in enumerate(CASES.items()):
        params = _seeded_params(cfg, 10 + i)
        out[case] = (params, convert.params_from_jax(cfg["model"]["name"], params))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_export_equals_the_jax_export(states, case):
    cfg, jax_export, port_export = CASES[case]
    params, state = states[case]
    ref = jax_export(params)
    ours = port_export(state)
    assert list(ours) == list(ref) if case != "swin_unetr" else set(ours) == set(ref)
    for key, value in ref.items():
        assert tuple(ours[key].shape) == value.shape, key
        assert ours[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_import_of_the_export_is_exact(states, case, tmp_path):
    cfg, _, _ = CASES[case]
    state = states[case][1]
    path = torch_export.export_torch_checkpoint(state, ConfigNode(cfg), tmp_path / "m.pth",
                                                epoch=4, best_metric=0.7, history={"a": [1]})
    ckpt = torch.load(path, weights_only=False)
    assert (ckpt["epoch"], ckpt["best_metric"], ckpt["history"]) == (4, 0.7, {"a": [1]})
    prefix = "backbone.model." if case == "swin_unetr" else "backbone."
    assert all(k.startswith(prefix) for k in ckpt["model_state_dict"])
    back = torch_import.import_torch_checkpoint(path, ConfigNode(cfg))
    assert set(back) == set(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    # the JAX package's importer reads the port's file to its own tree
    jtree = jimport.import_torch_checkpoint(path, JConfig(cfg))["backbone"]
    name = cfg["model"]["name"]
    for key, value in convert.params_from_jax(name, jtree).items():
        assert torch.equal(value, state[key]), key


@pytest.fixture(scope="module")
def monai_pair(states):
    """JAX's monai_compat model on from_torch_swin_unetr params of the JAX
    export, and the port's on the port's import of the same dict."""
    no_tf32()
    cfg = CASES["swin_unetr"][0]
    params = states["swin_unetr"][0]
    sd = jexport.to_torch_swin_unetr(params, (2, 2, 2, 2), (4, 4, 4))
    jparams = jimport.from_torch_swin_unetr(sd, (2, 2, 2, 2), target_window=(4, 4, 4))
    x = np.random.default_rng(2).normal(size=(2, *ROI, 2)).astype(np.float32)
    flax_mod = _jax_model(cfg)
    ref = np.asarray(jax.jit(lambda p, x: flax_mod.apply({"params": p}, x, train=False))(
        jparams, jnp.asarray(x)))
    model = build_model(ConfigNode(cfg), device="cpu").eval()
    model.load_state_dict(torch_import.from_torch_swin_unetr(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, (2, 2, 2, 2),
        target_window=(4, 4, 4)))
    return model, x, ref, jparams


def test_monai_compat_logits_match_jax(monai_pair):
    model, x, ref, jparams = monai_pair
    assert "encoder4.conv1.weight" not in model.state_dict()
    assert model.stage3_block0.attn.rel_pos_bias.shape == (7**3, 24)  # the 4³ window's table
    with torch.no_grad():
        out = model(port(x))
    assert np.abs(out.numpy() - ref).max() <= MODEL_TOL
    # convert carries the monai_compat tree both ways
    state = convert.params_from_jax("swin_unetr", jparams)
    for key, value in model.state_dict().items():
        assert torch.equal(state[key], value), key
    back, _ = convert.params_to_jax("swin_unetr", state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, jparams))


def test_monai_replica_loads_the_port_export(tmp_path):
    """MONAI's graph (``tests/monai_swin_replica.py``, MONAI's default 7³
    window: the 4³ grid of the last stage clamps it) loads the port's
    exported ``.pth`` with strict keys and gives the port's logits. 64³: the
    replica's ``InstanceNorm3d`` needs a bottleneck of 2 voxels or more."""
    no_tf32()
    cfg = ConfigNode(_config("swin_unetr", img_size=[64, 64, 64], feature_size=6,
                             num_heads=[1, 2, 2, 4], window_size=[7, 7, 7]))
    model = build_model(cfg, device="cpu").eval()
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("rel_pos_bias", "weight")) and not name.startswith(("encoder",
                                                                                 "decoder")):
                p.add_(port(0.3 * rng.normal(size=tuple(p.shape))))
    path = torch_export.export_torch_checkpoint(model.state_dict(), cfg, tmp_path / "s.pth")
    sd = {k.removeprefix("backbone.model."): v
          for k, v in torch.load(path, weights_only=False)["model_state_dict"].items()}
    replica = MonaiSwinUNETR(in_channels=2, out_channels=4, feature_size=6,
                             depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
                             window_size=(7, 7, 7)).eval()
    replica.load_state_dict(sd, strict=True)
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 64, 2)).astype(np.float32))
    with torch.no_grad():
        ours = model(x)
        theirs = replica(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    # relative to the logits' scale (|logits| up to 8.7 here): the port's
    # LayerNorms keep flax's eps 1e-6 (as the JAX model), MONAI's torch
    # LayerNorms 1e-5, which moves these logits by about 1e-4
    assert (ours - theirs).abs().max() <= MODEL_TOL * max(1.0, float(ours.abs().max()))


def test_window_transfer_resamples_the_tables_as_jax(states):
    params = states["swin_unetr"][0]
    sd = jexport.to_torch_swin_unetr(params, (2, 2, 2, 2), (4, 4, 4))
    table = sd["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"]
    np.testing.assert_array_equal(torch_import.resample_rel_pos_bias(table, (4, 4, 4), (3, 3, 3)),
                                  jimport.resample_rel_pos_bias(table, (4, 4, 4), (3, 3, 3)))
    ours = torch_import.from_torch_swin_unetr(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, target_window=(3, 3, 3))
    ref = convert.params_from_jax("swin_unetr", jimport.from_torch_swin_unetr(
        sd, target_window=(3, 3, 3)))
    assert ours["stage0_block0.attn.rel_pos_bias"].shape == (125, 3)
    for key, value in ref.items():
        assert torch.equal(ours[key], value), key


def test_guards_and_the_trained_bias_warning(states, tmp_path):
    state = states["swin_unetr"][1]
    native = _config("swin_unetr", monai_compat=False)
    with pytest.raises(ValueError, match="monai_compat"):
        torch_export.export_torch_checkpoint(state, ConfigNode(native), tmp_path / "n.pth")
    path = torch_export.export_torch_checkpoint(state, ConfigNode(CASES["swin_unetr"][0]),
                                                tmp_path / "m.pth")
    with pytest.raises(ValueError, match="monai_compat"):
        torch_import.import_torch_checkpoint(path, ConfigNode(native))
    with pytest.raises(ValueError, match="scan_blocks"):
        torch_export.export_torch_checkpoint(state, ConfigNode(_config(
            "swin_unetr", scan_blocks=True)), tmp_path / "s.pth")
    xattn = _config("dual_encoder")
    xattn["model"]["fusion"] = {"type": "cross_attention"}
    with pytest.raises(ValueError, match="cross_attention"):
        torch_export.export_torch_checkpoint(states["dual_encoder_concat"][1], ConfigNode(xattn),
                                             tmp_path / "x.pth")
    with pytest.raises(ValueError, match="cross_attention"):
        torch_import.import_torch_checkpoint(path, ConfigNode(xattn))
    fused = _config("swin_unetr")
    fused["model"]["fusion"] = {"type": "cross_attention"}
    with pytest.raises(ValueError, match="cross_attention"):
        build_model(ConfigNode(fused), device="cpu")
    biased = dict(state)
    biased["encoder0.conv1.bias"] = biased["encoder0.conv1.bias"] + 0.1
    with pytest.warns(UserWarning, match="bias-free"):
        torch_export.export_torch_checkpoint(biased, ConfigNode(CASES["swin_unetr"][0]),
                                             tmp_path / "b.pth")


def test_model_pretrained_through_the_trainer(states, tmp_path):
    cfg, _, _ = CASES["unet3d"]
    state = states["unet3d"][1]
    path = torch_export.export_torch_checkpoint(state, ConfigNode(cfg), tmp_path / "u.pth")
    trainer = Trainer({**cfg, "model": {**cfg["model"], "pretrained": str(path)},
                       "experiment": {"output_dir": str(tmp_path)}}, device="cpu")
    trainer.init_state()
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, state[key]), key
    wider = _config("unet3d", features=[4, 8, 32])
    wider["model"]["pretrained"] = str(path)
    wider["experiment"] = {"output_dir": str(tmp_path)}
    with pytest.raises(ValueError, match="does not match"):
        Trainer(wider, device="cpu").init_state()
