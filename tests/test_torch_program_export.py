"""Exported programs (``models/program_export.py``, ``--mode export
--format pt2``) and their serving.

A UNet3D (features 4-8-16) and a tiny flagship (fs 12, 32³ ROI,
cross-attention fusion) are exported with ``torch.export`` and loaded
back: the program's logits equal the live model's bit for bit at tile
batches 1 and 3 (the same aten ops in the same order on the same weights),
and the flagship's program holds kernels A and B as the port's custom ops.
"""

import json
import zipfile

import numpy as np
import pytest
import torch
import yaml

from multimodal_organ_segmentation_tpu_torch import cli
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from multimodal_organ_segmentation_tpu_torch.models.program_export import (
    export_program,
    load_program,
)
from multimodal_organ_segmentation_tpu_torch.serving import server
from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti
from tests.test_torch_cli import _config
from tests.torch_port_utils import _one_thread, no_tf32  # noqa: F401

ROI = (32, 32, 32)


def _swin_config(root):
    """The CLI tests' SwinUNETR with two blocks a stage (a shifted block in
    each): the program holds 8 window attentions."""
    cfg = _config(root)
    cfg["model"]["backbone"]["depths"] = [2, 2, 2, 2]
    return cfg


def _unet_config(root):
    cfg = _config(root)
    cfg["model"] = {"name": "unet3d", "in_channels": 2, "out_channels": 4,
                    "backbone": {"features": [4, 8, 16], "img_size": [16, 16, 16]},
                    "head": {"type": "conv", "dropout": 0.0}}
    cfg["inference"]["sliding_window"]["roi_size"] = [16, 16, 16]
    return cfg


def _seeded(model, seed):
    """Weights from a numpy seed, far from their init (biases included)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.2 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Per model: its config, the live CPU model with seeded weights, its
    port checkpoint and its exported program."""
    no_tf32()
    root = tmp_path_factory.mktemp("export")
    out = {}
    for name, cfg in (("unet3d", _unet_config(root)), ("swin_unetr", _swin_config(root))):
        model = _seeded(build_model(ConfigNode(cfg), device="cpu"), 7).eval()
        ckpt = root / f"{name}_ckpt"
        save_checkpoint({"step": 0, "params": model.state_dict(), "opt_state": None,
                         "ema_params": None}, ckpt)
        roi = tuple(cfg["model"]["backbone"]["img_size"])
        path = export_program(model, root / f"{name}.pt2", roi=roi, in_channels=2,
                              metadata={"model": name, "num_classes": cfg["model"]["out_channels"],
                                        "modalities": ["CT", "PET"], "epoch": 3,
                                        "best_metric": 0.5})
        out[name] = {"cfg": cfg, "model": model, "ckpt": ckpt, "path": path, "roi": roi,
                     "program": load_program(path)}
    return root, out


@pytest.mark.parametrize("name", ["unet3d", "swin_unetr"])
@pytest.mark.parametrize("batch", [1, 3])
def test_program_logits_equal_the_live_model(world, name, batch):
    entry = world[1][name]
    call, _ = entry["program"]
    x = torch.from_numpy(np.random.default_rng(batch).normal(
        size=(batch, *entry["roi"], 2)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(call(x), entry["model"](x))


def test_program_calls_kernels_a_and_b_as_custom_ops(world):
    call, _ = world[1]["swin_unetr"]["program"]
    targets = [str(n.target) for n in call.graph.nodes if n.op == "call_function"]
    assert targets.count("organseg_torch.window_mha.default") == 8  # 2 blocks × 4 stages
    assert targets.count("organseg_torch.flash_attention.default") == 3  # fusion at /8-/32


def test_program_metadata(world):
    _, meta = world[1]["swin_unetr"]["program"]
    assert meta["format_version"] == 1
    assert meta["input"] == {"shape": ["b", 32, 32, 32, 2], "dtype": "float32",
                             "layout": "NDHWC (channels-last; b = symbolic tile batch)"}
    assert meta["platforms"] == ["cpu"] and meta["torch_version"] == torch.__version__
    assert (meta["model"], meta["num_classes"], meta["modalities"], meta["epoch"],
            meta["best_metric"]) == ("swin_unetr", 8, ["CT", "PET"], 3, 0.5)


def test_load_program_moves_the_program_to_another_device(world):
    """A program holds the device it was exported on; ``load_program(...,
    device=)`` moves its weights and constants (``meta`` stands in for the
    card here: the custom ops' fake versions run there)."""
    entry = world[1]["unet3d"]
    call, meta = load_program(entry["path"], device="meta")
    assert meta["platforms"] == ["cpu"]
    assert {t.device.type for t in [*call.parameters(), *call.buffers()]} == {"meta"}
    out = call(torch.zeros((2, *entry["roi"], 2), device="meta"))
    assert out.device.type == "meta" and out.shape == (2, *entry["roi"], 4)


def test_load_program_refuses_malformed_artifacts(world, tmp_path):
    (tmp_path / "plain.pt2").write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="not an exported program"):
        load_program(tmp_path / "plain.pt2")
    with zipfile.ZipFile(tmp_path / "partial.pt2", "w") as zf:
        zf.writestr("metadata.json", "{}")
    with pytest.raises(ValueError, match="not an exported program"):
        load_program(tmp_path / "partial.pt2")
    with zipfile.ZipFile(world[1]["unet3d"]["path"]) as src, \
            zipfile.ZipFile(tmp_path / "future.pt2", "w") as zf:
        zf.writestr("model.pt2", src.read("model.pt2"))
        zf.writestr("metadata.json", json.dumps({"format_version": 2}))
    with pytest.raises(ValueError, match="newer exporter"):
        load_program(tmp_path / "future.pt2")


def test_server_refuses_an_artifact_without_num_classes_or_channels(world, tmp_path):
    """The exported UNet3D's program under metadata as ``export_program``
    writes it with ``num_classes`` left out, or with one modality."""
    entry = world[1]["unet3d"]
    cfg = ConfigNode(entry["cfg"])
    with zipfile.ZipFile(entry["path"]) as src:
        program, full = src.read("model.pt2"), json.loads(src.read("metadata.json"))
    del full["num_classes"], full["modalities"], full["epoch"], full["best_metric"]
    for name, meta, match in (("nc.pt2", {"model": "unet3d"}, "num_classes"),
                              ("ch.pt2", {"num_classes": 4, "modalities": ["CT"]}, "channels")):
        path = tmp_path / name
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("model.pt2", program)
            zf.writestr("metadata.json", json.dumps({**full, **meta}))
        with pytest.raises(ValueError, match=match):
            server.InferenceService(cfg, path, device="cpu")


def test_served_artifact_mask_equals_the_checkpoint_mask(world):
    root, models = world
    entry = models["unet3d"]
    image = np.random.default_rng(5).normal(size=(24, 20, 18, 2)).astype(np.float32)
    inputs = {}
    for c, mod in enumerate(("CT", "PET")):
        inputs[mod] = str(root / "case" / f"{mod}.nii.gz")
        save_nifti(image[..., c], inputs[mod])
    masks = []
    for i, source in enumerate((entry["ckpt"], entry["path"])):
        svc = server.InferenceService(ConfigNode(entry["cfg"]), source, device="cpu")
        svc.segment(inputs, output_dir=str(root / f"served{i}"), case_id="c")
        masks.append(load_nifti(root / f"served{i}" / "c_pred.nii.gz"))
    assert svc.model_name == "unet3d (pt2)" and svc.runner.roi_size == (16, 16, 16)
    np.testing.assert_array_equal(masks[0], masks[1])


def test_cli_export_pt2_and_the_refused_stablehlo(world, tmp_path):
    root, models = world
    entry = models["unet3d"]
    config = tmp_path / "c.yaml"
    config.write_text(yaml.safe_dump(entry["cfg"]))
    out = tmp_path / "m.pt2"
    cli.main(["--mode", "export", "--format", "pt2", "--device", "cpu", "--config", str(config),
              "--checkpoint", str(entry["ckpt"]), "--output", str(out)])
    call, meta = load_program(out)
    assert meta["num_classes"] == 4 and meta["modalities"] == ["CT", "PET"]
    x = torch.ones((2, *entry["roi"], 2))
    with torch.no_grad():
        assert torch.equal(call(x), entry["model"](x))
    with pytest.raises(ValueError, match="pt2"):
        cli.main(["--mode", "export", "--format", "stablehlo", "--device", "cpu", "--config",
                  str(config), "--checkpoint", str(entry["ckpt"]), "--output", str(out)])
