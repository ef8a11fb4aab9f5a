"""The kernel build's cache key: a library is rebuilt when its ``.cu``, any
header under ``csrc/`` or the flags change, and reused otherwise. Nothing is
compiled here (no ``nvcc`` on the CPU): only ``library_path`` is computed,
on a temporary copy of ``csrc/``."""

import shutil

import pytest

from multimodal_organ_segmentation_tpu_torch.ops import _build
from tests.torch_port_utils import _one_thread  # noqa: F401


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.SOURCES)
@pytest.mark.parametrize("header", ["common.cuh", "mma.cuh", "wgmma.cuh", "new_helpers.cuh"])
def test_a_header_edit_changes_every_library_path(csrc_copy, name, header):
    before = _build.library_path(name)
    assert before == _build.library_path(name)  # unchanged sources: the same library
    with open(csrc_copy / header, "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path(name)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(f"{name}-")


def test_every_kernel_includes_the_shared_mma_header():
    for name in _build.SOURCES:
        assert '#include "mma.cuh"' in (_build.CSRC / f"{name}.cu").read_text(), name


def test_a_source_edit_changes_only_its_own_library(csrc_copy):
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    with open(csrc_copy / "flash_attention.cu", "a") as f:
        f.write("\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after["flash_attention"] != before["flash_attention"]
    assert all(after[n] == before[n] for n in _build.SOURCES if n != "flash_attention")
