"""The port stands alone: no JAX, no JAX package, and no silent CPU runs.

The import check runs in a subprocess, because this test process has
imported jax already (``tests/conftest.py``).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

import chip_smoke
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from tests.torch_port_utils import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multimodal_organ_segmentation_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_and_chip_smoke_import_no_jax():
    mods = _port_modules() + ["chip_smoke", "scripts.proto_conv_kernel_torch",
                              "scripts.ab_paths", "tests.torch_dist_worker"]
    pkg = "multimodal_organ_segmentation_tpu_torch"
    for new in ("ops.window_attention", "ops.conv3d", "train.losses", "train.optim",
                "train.metrics", "train.checkpoint", "train.trainer", "data.synthetic",
                "data.dataset", "data.dataloader", "utils.prng", "utils.io", "utils.nifti",
                "utils.config", "utils.logger", "ops.resize", "ops.edt", "ops.postprocess",
                "ops.sliding_window", "data.transforms", "cli", "__main__", "models.unet3d",
                "models.attention_unet", "models.heads", "models.dual_encoder", "serving",
                "serving.server", "serving.tuner", "models.program_export",
                "models.torch_import", "models.torch_export", "utils.tensorboard",
                "explainability", "explainability.gradcam", "explainability.attention",
                "explainability.shap_analysis", "explainability.tsne", "explainability.runner",
                "analysis", "analysis.suv", "analysis.tmtv", "analysis.histogram",
                "analysis.report", "utils.xlsx", "utils.visualization", "preprocessing",
                "preprocessing.dicom", "preprocessing.dicom_converter", "preprocessing.normalizer",
                "preprocessing.suv_calculator", "preprocessing.registration",
                "preprocessing.resample", "parallel", "parallel.mesh", "parallel.multihost",
                "parallel.ring_attention", "parallel.tensor_parallel"):
        assert f"{pkg}.{new}" in mods, new
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'multimodal_organ_segmentation_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_port_imports_without_the_host_renderers():
    """Every module of the port imports where matplotlib, sklearn and pandas
    are absent (the card's machine has no matplotlib or sklearn): the figures
    import them when they draw, and the tables need no pandas."""
    code = (
        "import importlib, sys\n"
        "for m in ('matplotlib', 'sklearn', 'pandas'): sys.modules[m] = None\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


FOREIGN_IMPORT = re.compile(
    r"^\s*(import|from) (jax|jaxlib|flax|optax|orbax|multimodal_organ_segmentation_tpu(\.|\s|$))",
    re.MULTILINE)


@pytest.mark.parametrize("path", ["chip_smoke.py", "scripts/proto_conv_kernel_torch.py",
                                  "scripts/ab_paths.py"]
                         + [str(p.relative_to(REPO)) for p in sorted(PORT.rglob("*.py"))])
def test_source_holds_no_foreign_import(path):
    """No line of the port, its smoke test or its conv script imports JAX,
    flax, optax, orbax or the JAX package (``..._tpu_torch`` is the port)."""
    assert not FOREIGN_IMPORT.search((REPO / path).read_text()), path


def test_the_import_pattern_catches_what_it_should():
    assert FOREIGN_IMPORT.search("import jax\n")
    assert FOREIGN_IMPORT.search("    from optax import adamw\n")
    assert FOREIGN_IMPORT.search("from multimodal_organ_segmentation_tpu.utils import io\n")
    assert FOREIGN_IMPORT.search("import multimodal_organ_segmentation_tpu\n")
    assert not FOREIGN_IMPORT.search("from multimodal_organ_segmentation_tpu_torch.ops import x\n")


def test_build_model_without_a_device_needs_cuda(monkeypatch):
    """No device named means the card; with none it raises instead of
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(chip_smoke.FLAGSHIP)


def test_chip_smoke_config_is_the_flagship_yaml():
    with open(REPO / "configs" / "swin_unetr_xattn_flagship.yaml") as f:
        cfg = yaml.safe_load(f)
    assert chip_smoke.FLAGSHIP["model"] == cfg["model"]
    assert chip_smoke.FLAGSHIP["inference"] == cfg["inference"]
    assert chip_smoke.FLAGSHIP["training"] == cfg["training"]
    assert chip_smoke.FLAGSHIP["parallel"] == cfg["parallel"]
    assert chip_smoke.FLAGSHIP["data"]["augmentation"] == cfg["data"]["augmentation"]
    assert chip_smoke.FLAGSHIP["data"]["modalities"] == cfg["data"]["modalities"]
    train = chip_smoke.train_config()
    assert train["data"]["augmentation"]["enabled"] is False
    assert train["training"]["skip_nonfinite_updates"] is True
    for block in ("model", "parallel", "inference"):
        assert train[block] == cfg[block]
    assert {k: v for k, v in train["training"].items() if k != "skip_nonfinite_updates"} == cfg["training"]
    assert chip_smoke.FLAGSHIP["experiment"]["seed"] == cfg["experiment"]["seed"]
    assert chip_smoke.FLAGSHIP["hardware"]["mixed_precision"] == cfg["hardware"]["mixed_precision"]


def test_chip_smoke_main_path_shapes():
    """The launches chip_smoke checks the kernels at: 8 window attentions
    and 3 flash attentions a chunk, as the issue's kernel table lists them."""
    window = [(s, bw, h, nw) for s, bw, h, nw, _, _ in chip_smoke.window_shapes()]
    assert window == [
        (0, 7680, 3, None), (0, 7680, 3, 512), (1, 960, 6, None), (1, 960, 6, 64),
        (2, 120, 12, None), (2, 120, 12, 8), (3, 15, 24, None), (3, 15, 24, None),
    ]
    assert list(chip_smoke.flash_shapes()) == [
        (1, 15, 1728, 2, 96), (2, 15, 216, 4, 96), (3, 15, 27, 8, 96)
    ]


def test_chip_smoke_training_shapes():
    """One training micro-batch of 2 tiles: (H, BW) = (3, 1024), (6, 128),
    (12, 16), (24, 2) for kernel A, B = 2 for kernel B."""
    window = [(s, bw, h, nw) for s, bw, h, nw, _, _ in chip_smoke.window_shapes(2)]
    assert window == [
        (0, 1024, 3, None), (0, 1024, 3, 512), (1, 128, 6, None), (1, 128, 6, 64),
        (2, 16, 12, None), (2, 16, 12, 8), (3, 2, 24, None), (3, 2, 24, None),
    ]
    assert list(chip_smoke.flash_shapes(2)) == [
        (1, 2, 1728, 2, 96), (2, 2, 216, 4, 96), (3, 2, 27, 8, 96)
    ]


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
