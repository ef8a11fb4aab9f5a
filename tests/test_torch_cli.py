"""The slice as a whole on the CPU: the port's CLI (``--mode inference``,
``--mode eval`` on native grids, ``--mode train``) and its HTTP service
(``serving/server.py``, ``--mode serve``) against the JAX package.

A tiny SwinUNETR (the flagship's structure at fs=12 with one block a
stage, 32³ ROI, 8 classes, f32; the shifted blocks of depth 2 go through
the sliding window against JAX in ``tests/test_torch_sliding_window.py``,
and through the train step against the JAX trainer in
``tests/test_torch_train_step.py``)
gets seeded JAX parameters; the port's checkpoint (``tree.pt``) is
written from the converted ones, so ``--checkpoint`` loads exactly the
weights the JAX reference runs. Two CT+PET cases of different shapes in one
tile bucket go through the JAX reference once (shared module fixture):
modality normalisation → the JAX bucketed runner (logits equal to its
sliding window by contract) → ``predict_labels`` → postprocess → the JAX
metric classes.

Tolerances, as the slice test of ``sliding_window_inference``: logits of
~40 f32 layers in another summation order agree within 1e-4, so masks must
agree wherever the JAX top-2 margin exceeds twice that; Dice within 1e-4;
HD95, NSD and ASSD exactly wherever the masks agree (the same host numpy
on the same masks).
"""

import collections
import csv
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.data import transforms as jtr
from multimodal_organ_segmentation_tpu.models import swin_unetr as jswin
from multimodal_organ_segmentation_tpu.ops import postprocess as jpp
from multimodal_organ_segmentation_tpu.ops import sliding_window as jsw
from multimodal_organ_segmentation_tpu.serving import server as jserver
from multimodal_organ_segmentation_tpu.train import metrics as jm
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch import cli
from multimodal_organ_segmentation_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
    synthetic_volume,
)
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.serving import server
from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint
from multimodal_organ_segmentation_tpu_torch.utils import nifti
from multimodal_organ_segmentation_tpu_torch.utils.config import (
    ConfigNode,
    load_config,
    merge_config_with_args,
    save_config,
)
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti
from tests.torch_port_utils import _one_thread, no_tf32, seeded_variables  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SLICE_TOL = 1e-4
DICE_TOL = 1e-4
CLASSES = 8
ROI = (32, 32, 32)
CASES = {"case_a": (40, 38, 36), "case_b": (36, 42, 34)}  # one bucket: 48³
SPACING = (1.5, 1.2, 2.0)
AFFINE = np.diag([*SPACING, 1.0])


def _config(root):
    return {
        "experiment": {"name": "cli", "seed": 0, "output_dir": str(root / "out"),
                       "log_dir": str(root / "logs")},
        "data": {"modalities": ["CT", "PET"], "data_root": str(root / "data"),
                 "preprocessing": {"ct": {"window_center": -100, "window_width": 700},
                                   "pet": {"normalize": True}},
                 "augmentation": {"enabled": True, "random_flip": True, "random_rotate": 15,
                                  "random_intensity": 0.1}},
        "model": {
            "name": "swin_unetr", "in_channels": 2, "out_channels": CLASSES,
            "backbone": {"img_size": list(ROI), "feature_size": 12, "depths": [1, 1, 1, 1],
                         "num_heads": [3, 6, 12, 24], "window_size": [6, 6, 6],
                         "scan_blocks": False},
            "fusion": {"type": "cross_attention", "stages": [1, 2, 3]},
            "head": {"type": "conv", "dropout": 0.0},
        },
        "training": {"epochs": 1, "batch_size": 2, "accumulation_steps": 1,
                     "optimizer": {"name": "adamw", "lr": 1e-3},
                     "scheduler": {"name": "cosine", "warmup_epochs": 0},
                     "loss": {"name": "dice_ce"}},
        "inference": {"sliding_window": {"roi_size": list(ROI), "overlap": 0.5,
                                         "mode": "gaussian"},
                      "batch_size": 3, "normalize": True},
        "evaluation": {"sliding_window": True},
        "parallel": {"remat": False},
        "hardware": {"mixed_precision": "fp32", "num_workers": 2, "prefetch_depth": 2},
    }


def _run(config_path, mode, *extra):
    cli.main(["--mode", mode, "--config", str(config_path), "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Cases on disk (inference layout + a labelled test split), the port's
    checkpoint of the seeded params, the config file, and the JAX reference:
    per case the logits, masks and metric-class results."""
    no_tf32()
    root = tmp_path_factory.mktemp("cli")
    cfg = _config(root)
    rng = np.random.default_rng(11)
    images, labels = {}, {}
    rows = []
    for case, shape in CASES.items():
        image, label = synthetic_volume(shape, CLASSES, rng)
        images[case], labels[case] = image, label
        for c, mod in enumerate(("ct", "pet")):
            save_nifti(image[..., c], root / "input" / mod / f"{case}.nii.gz", affine=AFFINE)
            save_nifti(image[..., c], root / "data" / "test" / case / f"{mod}.nii.gz",
                       affine=AFFINE)
        save_nifti(label.astype(np.uint8), root / "data" / "test" / case / "label.nii.gz",
                   affine=AFFINE)
        rows.append([case, f"test/{case}/ct.nii.gz", f"test/{case}/pet.nii.gz",
                     f"test/{case}/label.nii.gz"])
    with open(root / "data" / "test.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "CT", "PET", "label"])
        w.writerows(rows)
    config_path = root / "config.yaml"
    config_path.write_text(yaml.safe_dump(cfg))
    # the voxel size eval reads back: the column norms of the stored affine
    # (NIfTI keeps it in f32, so 1.2 comes back as 1.2000000476837158)
    stored = load_nifti(root / "input" / "ct" / "case_a.nii.gz", return_affine=True)[1]
    spacing = tuple(np.sqrt((stored[:3, :3] ** 2).sum(axis=0)).tolist())

    jcfg = JConfig(cfg)
    flax_model = jswin.build_swin_unetr(jcfg)
    variables = seeded_variables(flax_model, np.zeros((1, *ROI, 2), np.float32), train=False,
                                 seed=4)
    state = convert.swin_unetr_params_from_jax(variables)
    ckpt = root / "ckpt"
    save_checkpoint({"step": 0, "params": state, "opt_state": None, "ema_params": None}, ckpt)

    runner = jsw.SlidingWindowRunner(lambda v, p: flax_model.apply(v, p, train=False), ROI,
                                     CLASSES, overlap=0.5, sw_batch_size=3)
    ref = {}
    dice = jm.DiceMetric(CLASSES)
    hd, nsd, assd = (jm.HausdorffDistance(95), jm.SurfaceDice(CLASSES, 2.0),
                     jm.AverageSurfaceDistance(CLASSES))
    for case in CASES:
        norm = jtr.normalize_from_config(jnp.asarray(images[case]), jcfg)
        logits = np.asarray(runner(norm, variables))
        mask = jpp.postprocess_from_config(
            np.asarray(jsw.predict_labels(lambda v: jnp.asarray(logits), norm)), jcfg)
        top2 = np.sort(logits, axis=-1)[..., -2:]
        dice.update(mask[None], labels[case][None])
        hd.update(mask[None], labels[case][None], spacing=spacing)
        nsd.update(mask[None], labels[case][None], spacing=spacing)
        assd.update(mask[None], labels[case][None], spacing=spacing)
        ref[case] = {"mask": mask, "clear": (top2[..., 1] - top2[..., 0]) > 2 * SLICE_TOL,
                     "logits": logits}
    metrics = {**dice.compute(), "hd95": hd.compute()["hausdorff_distance"], **nsd.compute(),
               **assd.compute()}
    assert runner.num_compiled == 1
    return {"root": root, "config": config_path, "ckpt": ckpt, "ref": ref, "metrics": metrics,
            "labels": labels, "spacing": spacing}


@pytest.fixture(scope="module")
def predicted(world):
    out = world["root"] / "pred"
    _run(world["config"], "inference", "--checkpoint", str(world["ckpt"]), "--input",
         str(world["root"] / "input"), "--output", str(out))
    return out


@pytest.fixture(scope="module")
def evaluated(world):
    _run(world["config"], "eval", "--checkpoint", str(world["ckpt"]))
    out = world["root"] / "out" / "cli"
    with open(out / "eval_native.json") as f:
        metrics = json.load(f)
    with open(out / "eval_native_cases.csv") as f:
        rows = list(csv.DictReader(f))
    return metrics, rows


def test_inference_masks_match_jax(world, predicted):
    for case, shape in CASES.items():
        img = nifti.load(str(predicted / f"{case}_pred.nii.gz"))
        mask = img.dataobj
        assert mask.dtype == np.uint8 and img.header.dtype == np.uint8
        assert mask.shape == shape
        np.testing.assert_allclose(img.affine, AFFINE)
        ref = world["ref"][case]
        assert ref["clear"].mean() > 0.99
        np.testing.assert_array_equal(mask[ref["clear"]], ref["mask"][ref["clear"]])


def test_native_eval_matches_jax(world, predicted, evaluated):
    """Dice against the JAX pipeline within 1e-4. The surface metrics are
    exact on the same masks: the JAX metric classes on the port's masks
    (eval and inference run the same normalisation and runner) give the
    port's HD95, NSD and ASSD bit for bit, and where every mask equals the
    JAX one, so do the JAX pipeline's."""
    metrics, rows = evaluated
    ref = world["metrics"]
    assert metrics["num_cases"] == 2 and [r["case"] for r in rows] == list(CASES)
    assert abs(metrics["dice"] - ref["dice"]) <= DICE_TOL
    np.testing.assert_allclose(metrics["dice_per_class"], ref["dice_per_class"], atol=DICE_TOL)
    masks = {c: load_nifti(predicted / f"{c}_pred.nii.gz").astype(np.int32) for c in CASES}
    hd, nsd, assd = (jm.HausdorffDistance(95), jm.SurfaceDice(CLASSES, 2.0),
                     jm.AverageSurfaceDistance(CLASSES))
    for case, mask in masks.items():
        label = world["labels"][case][None]
        hd.update(mask[None], label, spacing=world["spacing"])
        nsd.update(mask[None], label, spacing=world["spacing"])
        assd.update(mask[None], label, spacing=world["spacing"])
    on_ours = {"hd95": hd.compute()["hausdorff_distance"], **nsd.compute(), **assd.compute()}
    refs = [on_ours]
    if all(np.array_equal(m, world["ref"][c]["mask"]) for c, m in masks.items()):
        refs.append(ref)
    for r in refs:
        assert metrics["hd95"] == r["hd95"]
        for key in ("surface_dice", "assd"):
            assert metrics[key] == r[key]
            np.testing.assert_equal(metrics[f"{key}_per_class"], r[f"{key}_per_class"])


def test_native_eval_writes_every_key_and_column_of_the_jax_cli(evaluated):
    metrics, rows = evaluated
    for key in ("dice", "dice_per_class", "hd95", "hd95_std", "surface_dice",
                "surface_dice_per_class", "surface_dice_tolerance_mm", "assd", "assd_per_class",
                "num_cases", "per_case"):
        assert key in metrics, key
    case_keys = {"case", "dice", "dice_per_class", "hd95", "surface_dice",
                 "surface_dice_per_class", "assd", "assd_per_class"}
    assert set(metrics["per_case"][0]) == case_keys
    cols = (["case", "dice"] + [f"dice_c{c}" for c in range(CLASSES)] + ["hd95", "surface_dice"]
            + [f"surface_dice_c{c}" for c in range(CLASSES)] + ["assd"]
            + [f"assd_c{c}" for c in range(CLASSES)])
    assert list(rows[0]) == cols
    # background has no surface score: the CSV writes None as an empty cell
    assert rows[0]["surface_dice_c0"] == "" and rows[0]["assd_c0"] == ""


def test_eval_with_lesion_and_calibration_columns(world):
    out = world["root"] / "eval_opt"
    _run(world["config"], "eval", "--checkpoint", str(world["ckpt"]), "--output", str(out),
         "--set", "evaluation.lesion_metrics=true", "--set", "evaluation.calibration=true")
    metrics = json.loads((out / "eval_native.json").read_text())
    for key in ("lesion_f1", "lesion_tp", "lesion_fp", "lesion_fn", "ece", "ece_bins"):
        assert key in metrics, key
    with open(out / "eval_native_cases.csv") as f:
        header = next(csv.reader(f))
    assert header[-4:] == ["lesion_tp", "lesion_fp", "lesion_fn", "ece"]
    assert 0.0 <= metrics["ece"] <= 1.0


def test_duplicate_ensemble_member_gives_the_same_mask_and_uncertainty(world, predicted):
    out = world["root"] / "pred_ens"
    _run(world["config"], "inference", "--checkpoint", str(world["ckpt"]), "--input",
         str(world["root"] / "input"), "--output", str(out),
         "--set", f"inference.ensemble=[{world['ckpt']}]",
         "--set", "inference.save_uncertainty=true", "--set", "inference.save_probabilities=true")
    for case, shape in CASES.items():
        np.testing.assert_array_equal(load_nifti(out / f"{case}_pred.nii.gz"),
                                      load_nifti(predicted / f"{case}_pred.nii.gz"))
        unc = load_nifti(out / f"{case}_unc.nii.gz")
        probs = load_nifti(out / f"{case}_prob.nii.gz")
        assert unc.shape == shape and probs.shape == (*shape, CLASSES)
        assert unc.min() >= 0.0 and unc.max() <= 1.0 + 1e-6
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


def test_train_writes_a_checkpoint_that_inference_loads(world, tmp_path):
    data = tmp_path / "data"
    generate_synthetic_dataset(data, n_train=2, n_val=1, n_test=0, shape=(36, 36, 30),
                               num_classes=CLASSES, seed=5)
    cfg = yaml.safe_load(world["config"].read_text())
    cfg["data"]["data_root"] = str(data)
    cfg["experiment"]["output_dir"] = str(tmp_path / "out")
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    _run(path, "train", "--epochs", "1")
    run_dir = tmp_path / "out" / "cli"
    record = json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(record["train_loss"]) and (run_dir / "last" / "tree.pt").exists()
    _run(path, "inference", "--checkpoint", str(run_dir / "last"), "--input",
         str(world["root"] / "input"), "--output", str(tmp_path / "pred"))
    for case, shape in CASES.items():
        mask = load_nifti(tmp_path / "pred" / f"{case}_pred.nii.gz")
        assert mask.shape == shape and mask.max() < CLASSES


def test_preprocess_without_input_raises(world):
    """``--mode preprocess`` needs ``--input``, as the JAX CLI's does."""
    with pytest.raises(ValueError, match="--input is required for preprocess mode"):
        _run(world["config"], "preprocess")


def test_no_card_and_no_device_flag_raises(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mode", "inference", "--config", str(world["config"])])


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*"))


def _analysis_case(root):
    rng = np.random.default_rng(14)
    shape = (20, 18, 16)
    suv = rng.uniform(0.2, 0.8, shape).astype(np.float32)
    seg = np.zeros(shape, np.uint8)
    seg[2:8, 2:8, 2:8] = 5
    suv[2:8, 2:8, 2:8] = rng.normal(2.0, 0.2, (6, 6, 6))
    seg[10:14, 10:14, 2:6] = 2
    suv[12:18, 12:17, 9:14] = rng.normal(5.0, 0.5, (6, 5, 5))
    save_nifti(suv, root / "case" / "pet_suv.nii.gz", affine=AFFINE)
    save_nifti(seg, root / "case" / "case_pred.nii.gz", affine=AFFINE)
    return root / "case"


def test_analysis_mode_matches_the_jax_cli(world, tmp_path):
    """``--mode analysis --generate-report``: the JAX CLI's file set, its CSV
    columns, numbers within 1e-6 relative, the masks exactly."""
    from multimodal_organ_segmentation_tpu import cli as jcli

    case = _analysis_case(tmp_path)
    argv = ["--mode", "analysis", "--config", str(world["config"]), "--input", str(case),
            "--suv-analysis", "--tmtv-analysis", "--histogram", "--generate-report",
            "--device", "cpu"]
    jcli.main([*argv, "--output", str(tmp_path / "jax")])
    cli.main([*argv, "--output", str(tmp_path / "port")])
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert {"suv_analysis.csv", "tmtv_analysis.xlsx", "report.docx",
            "organ_histograms.png"} <= set(files)
    for name in files:
        got, want = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".csv"):
            with open(got) as f, open(want) as g:
                rows, ref = list(csv.reader(f)), list(csv.reader(g))
            assert rows[0] == ref[0] and len(rows) == len(ref), name
            for r, o in zip(ref[1:], rows[1:]):
                for a, b in zip(r, o):
                    try:
                        assert float(b) == pytest.approx(float(a), rel=1e-6), name
                    except ValueError:
                        assert a == b, name
        elif name.endswith(".nii.gz"):
            np.testing.assert_array_equal(load_nifti(got), load_nifti(want), err_msg=name)


@pytest.mark.parametrize("mode", ["explain", "analysis"])
def test_explain_and_analysis_without_a_card_raise(world, monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mode", mode, "--config", str(world["config"]), "--checkpoint", "c",
                  "--input", "i"])


def test_discover_cases_and_explicit_case_shard(world, tmp_path):
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer

    cfg = yaml.safe_load(world["config"].read_text())
    cfg["experiment"]["output_dir"] = str(tmp_path)
    save_nifti(np.zeros((4, 4, 4), np.float32), world["root"] / "input" / "ct" / "lonely.nii.gz")
    trainer = Trainer(cfg, device="cpu")
    cases = trainer._discover_cases(world["root"] / "input")
    assert sorted(cases) == list(CASES) and set(cases["case_a"]) == {"CT", "PET"}
    (world["root"] / "input" / "ct" / "lonely.nii.gz").unlink()
    trainer.config.set("inference.case_shard", [1, 2])
    assert trainer._case_shard() == (1, 2)
    for off in (False, "false", [0, 1]):
        trainer.config.set("inference.case_shard", off)
        assert trainer._case_shard() is None
    trainer.config.set("inference.case_shard", "auot")
    with pytest.raises(ValueError):
        trainer._case_shard()
    trainer.config.set("inference.case_shard", [2, 2])
    with pytest.raises(ValueError):
        trainer._case_shard()


@pytest.mark.parametrize("argv", [
    ["--mode", "train", "--epochs", "3", "--lr", "0.01", "--exp-name", "x", "--seed", "4",
     "--modalities", "CT", "MRI", "--set", "training.ema_decay=0.99", "--set",
     "experiment.name=no", "--set", "+model.backbone.extra=[1, 2]", "--gradcam"],
    ["--mode", "inference", "--checkpoint", "c", "--input", "i", "--output", "o",
     "--batch-size", "5", "--set", "inference.tta=true", "--set", "experiment.seed=2024-01-01"],
])
def test_merge_config_with_args_matches_jax(argv):
    from multimodal_organ_segmentation_tpu import cli as jcli
    from multimodal_organ_segmentation_tpu.utils import config as jconfig

    path = REPO / "configs" / "swin_unetr_xattn_flagship.yaml"
    schema = REPO / "configs" / "default.yaml"
    ours = merge_config_with_args(load_config(path), cli.parse_args(argv),
                                  schema=load_config(schema))
    ref = jconfig.merge_config_with_args(jconfig.load_config(path), jcli.parse_args(argv),
                                         schema=jconfig.load_config(schema))
    assert ours.to_dict() == ref.to_dict()
    with pytest.raises(ValueError, match="unknown config key"):
        merge_config_with_args(load_config(path), cli.parse_args(["--mode", "train", "--set",
                                                                   "trainig.epochs=1"]))


def test_save_config_and_logger_match_jax(tmp_path):
    from multimodal_organ_segmentation_tpu.utils import config as jconfig
    from multimodal_organ_segmentation_tpu.utils import logger as jlogger
    from multimodal_organ_segmentation_tpu_torch.utils import logger as tlogger

    cfg = load_config(REPO / "configs" / "swin_unetr_xattn_flagship.yaml")
    cfg["_args"] = {"mode": "train"}
    save_config(cfg, tmp_path / "a.yaml")
    jconfig.save_config(jconfig.ConfigNode(cfg.to_dict()), tmp_path / "b.yaml")
    assert (tmp_path / "a.yaml").read_text() == (tmp_path / "b.yaml").read_text()
    assert "_args" not in yaml.safe_load((tmp_path / "a.yaml").read_text())
    log = tlogger.setup_logger("port_test", log_file=str(tmp_path / "l.log"), level="WARNING")
    ref = jlogger.setup_logger("jax_test", log_file=str(tmp_path / "j.log"), level="WARNING")
    assert [type(h) for h in log.handlers] == [type(h) for h in ref.handlers]
    assert [h.level for h in log.handlers] == [h.level for h in ref.handlers]
    tlogger.LoggerAdapter(log).log_metrics({"dice": 0.5, "n": 3, "skip": [1]}, prefix="val ")
    assert tlogger.get_logger("port_test") is log
    assert (tmp_path / "l.log").read_text().strip().endswith("val dice=0.500000 n=3")


# -- the HTTP service (serving/server.py) on the same weights and cases ------
#
# Masks against the JAX reference under the rule above, and bit for bit
# against the port's own ``Trainer.predict``. The probability and entropy
# maps: within 1e-5 of the JAX package's ``predict_labels`` softmax and
# ``predictive_entropy`` applied to the port's blended logits (the maps' own
# arithmetic), and within 1e-4 of the whole JAX reference: with these seeded
# weights the logits reach |10.5| and the two packages' logits differ by up
# to 1.9e-4 at one tile, which moves a probability by up to 4e-5, so 1e-5
# cannot hold end to end.

PROB_TOL = 1e-5  # the maps' arithmetic on the same logits
MODEL_PROB_TOL = 1e-4  # the maps against the whole JAX reference
SHAPE = CASES["case_a"]
SMALL = (36, 32, 32)  # 2 tiles: the case of the service's other tests


@pytest.fixture(scope="module")
def serving(world):
    """The config as a dict, the inputs of case_a and of a small case, the
    JAX reference's probabilities and entropy of case_a, and the service."""
    cfg = yaml.safe_load(world["config"].read_text())
    inputs = {m: str(world["root"] / "input" / m.lower() / "case_a.nii.gz") for m in ("CT", "PET")}
    small, _ = synthetic_volume(SMALL, CLASSES, np.random.default_rng(12))
    inputs_small = {}
    for c, mod in enumerate(("CT", "PET")):
        inputs_small[mod] = str(world["root"] / "small" / f"{mod}.nii.gz")
        save_nifti(small[..., c], inputs_small[mod], affine=AFFINE)
    _, probs = jsw.predict_labels(lambda v: jnp.asarray(world["ref"]["case_a"]["logits"]),
                                  jnp.zeros((*SHAPE, 2)), return_probs=True)
    return {"cfg": cfg, "inputs": inputs, "small": inputs_small, "probs": np.asarray(probs),
            "unc": np.asarray(jsw.predictive_entropy(probs)),
            "service": server.InferenceService(ConfigNode(cfg), world["ckpt"], device="cpu")}


@pytest.fixture(scope="module")
def served(world, serving):
    out = world["root"] / "served"
    result = serving["service"].segment(serving["inputs"], output_dir=str(out),
                                        case_id="case_a", probabilities=True, uncertainty=True)
    return result, out


@pytest.fixture(scope="module")
def served_small(world, serving):
    out = world["root"] / "served_small"
    serving["service"].segment(serving["small"], output_dir=str(out), case_id="s",
                               probabilities=True, uncertainty=True)
    return out


def test_served_mask_matches_jax_and_trainer_predict(world, served, predicted):
    result, out = served
    assert result["shape"] == list(SHAPE) and result["bucket"] == [48, 48, 48]
    mask = load_nifti(out / "case_a_pred.nii.gz").astype(np.uint8)
    ref = world["ref"]["case_a"]
    np.testing.assert_array_equal(mask[ref["clear"]], ref["mask"][ref["clear"]])
    assert result["class_voxels"] == {int(c): int(n) for c, n in
                                      zip(*np.unique(mask, return_counts=True))}
    # --mode inference (Trainer.predict) on the same checkpoint and case
    np.testing.assert_array_equal(mask, load_nifti(predicted / "case_a_pred.nii.gz"))


def test_probability_and_uncertainty_maps_match_jax(world, serving, served, served_small):
    result, out = served
    probs = load_nifti(out / "case_a_prob.nii.gz")
    unc = load_nifti(out / "case_a_unc.nii.gz")
    assert result["probabilities"].endswith("case_a_prob.nii.gz")
    assert probs.shape == (*SHAPE, CLASSES) and unc.shape == SHAPE
    np.testing.assert_allclose(probs, serving["probs"], atol=MODEL_PROB_TOL)
    np.testing.assert_allclose(unc, serving["unc"], atol=MODEL_PROB_TOL)
    # the maps' arithmetic: JAX's softmax and entropy of the service's own logits
    from multimodal_organ_segmentation_tpu_torch.data.transforms import normalize_from_config

    service = serving["service"]
    probs = load_nifti(served_small / "s_prob.nii.gz")
    unc = load_nifti(served_small / "s_unc.nii.gz")
    image = np.stack([load_nifti(serving["small"][m]) for m in ("CT", "PET")], axis=-1)
    norm = normalize_from_config(torch.from_numpy(image), ConfigNode(serving["cfg"]))
    with torch.no_grad():
        logits = jnp.asarray(service.runner(norm, service._variables).numpy())
    _, jprobs = jsw.predict_labels(lambda v: logits, jnp.asarray(norm.numpy()),
                                   return_probs=True)
    np.testing.assert_allclose(probs, np.asarray(jprobs), atol=PROB_TOL)
    np.testing.assert_allclose(unc, np.asarray(jsw.predictive_entropy(jprobs)), atol=PROB_TOL)


def test_duplicate_ensemble_member_equals_the_single_model(world, serving, served_small):
    cfg = ConfigNode(serving["cfg"])
    cfg.set("inference.ensemble", [str(world["ckpt"])])
    ens = server.InferenceService(cfg, world["ckpt"], device="cpu")
    assert len(ens._members) == 2
    out = world["root"] / "ensemble"
    ens.segment(serving["small"], output_dir=str(out), case_id="s")
    np.testing.assert_array_equal(load_nifti(out / "s_pred.nii.gz"),
                                  load_nifti(served_small / "s_pred.nii.gz"))


class _Runner:
    num_compiled = 3


@pytest.mark.parametrize("n", [1, 2, 7, 600])
def test_stats_percentiles_equal_jax_stats(n):
    """The counters and the percentile rule of JAX's ``stats()`` (run on a
    stub instance: no model) over the same latency list, which for 600
    requests also exercises the 512-request window."""
    rng = np.random.default_rng(n)
    lats = {k: rng.random(n).round(4).tolist() for k in ("total_s", "device_s", "load_s")}

    def stub(cls):
        svc = object.__new__(cls)
        svc._stats_lock = threading.Lock()
        svc._counters = collections.Counter(rejected=2, client_errors=1,
                                                          warmups=1)
        svc._latencies = {k: collections.deque(v, maxlen=512)
                          for k, v in lats.items()}
        svc.requests_served = n
        svc.runner = _Runner()
        svc.max_in_flight = 4
        return svc

    assert stub(server.InferenceService).stats() == stub(jserver.InferenceService).stats()


def _post(url, body, raw=False):
    data = body if raw else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_endpoints_status_codes(serving, tmp_path):
    service = serving["service"]
    httpd = server.make_server(service, port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["modalities"] == ["CT", "PET"]
        code, info = _post(base + "/v1/warmup", {"shape": [32, 32, 32]})
        assert code == 200 and info["bucket"] == [32, 32, 32]
        code, res = _post(base + "/v1/segment", {"inputs": serving["small"], "case_id": "h"})
        assert code == 200 and res["shape"] == list(SMALL) and "output" not in res
        # 503: every admission slot taken
        held = [service._admission.acquire(blocking=False) for _ in range(service.max_in_flight)]
        try:
            assert all(held)
            assert _post(base + "/v1/segment", {"inputs": serving["small"]})[0] == 503
            assert _post(base + "/v1/warmup", {"shape": [32, 32, 32]})[0] == 503
        finally:
            for _ in held:
                service._admission.release()
        garbage = tmp_path / "g.nii.gz"
        garbage.write_bytes(b"not a nifti volume at all")
        cap, service.max_volume_voxels = service.max_volume_voxels, 1000
        try:
            assert _post(base + "/v1/segment", {"inputs": serving["small"]})[0] == 400  # oversize
            assert _post(base + "/v1/warmup", {"shape": [96, 96, 96]})[0] == 400
        finally:
            service.max_volume_voxels = cap
        assert _post(base + "/v1/segment", {"inputs": {"CT": serving["small"]["CT"]}})[0] == 400
        assert _post(base + "/v1/segment",
                     {"inputs": {"CT": str(garbage), "PET": str(garbage)}})[0] == 400
        assert _post(base + "/v1/segment", b"{not json", raw=True)[0] == 400
        assert _post(base + "/v1/segment", [1, 2])[0] == 400
        assert _post(base + "/v1/warmup", {"shape": [96, 96]})[0] == 400
        assert _post(base + "/v1/segment", {"inputs": serving["small"], "uncertainty": True}
                     )[0] == 400  # uncertainty without output_dir
        assert _post(base + "/v1/nothing", {})[0] == 404
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["rejected"] >= 2 and stats["client_errors"] >= 4
        assert stats["device_s"]["p50"] > 0 and stats["window"] >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def test_serve_mode_answers_and_drains_on_sigterm(world, serving):
    """``--mode serve`` in a process of its own: it binds an OS-assigned
    port, serves one request, and on SIGTERM drains and exits 0 with the
    final stats in its log."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_organ_segmentation_tpu_torch", "--mode", "serve",
         "--config", str(world["config"]), "--checkpoint", str(world["ckpt"]),
         "--device", "cpu", "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, port = [], {}

    def watch():
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"http://[\d.]+:(\d+)", line)
            if m and "port" not in port:
                port["port"] = int(m.group(1))

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        for _ in range(1200):
            if "port" in port or proc.poll() is not None:
                break
            watcher.join(timeout=0.1)
        assert "port" in port, "".join(lines)[-2000:]
        code, res = _post(f"http://127.0.0.1:{port['port']}/v1/segment",
                          {"inputs": serving["small"], "case_id": "sub"})
        assert code == 200 and res["shape"] == list(SMALL)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        watcher.join(timeout=30)
        log = "".join(lines)
        assert "SIGTERM: draining" in log
        final = json.loads(log.split("final stats: ")[1].splitlines()[0])
        assert final["requests"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
