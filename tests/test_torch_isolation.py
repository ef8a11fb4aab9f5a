"""The port stands alone: no JAX, no JAX package, and no silent CPU runs.

The import check runs in a subprocess, because this test process has
imported jax already (``tests/conftest.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

import chip_smoke
from multimodal_organ_segmentation_tpu_torch.models.build import build_model

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "multimodal_organ_segmentation_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_and_chip_smoke_import_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    assert "multimodal_organ_segmentation_tpu_torch.ops.window_attention" in mods
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


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
