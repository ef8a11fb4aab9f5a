"""The port's serving tuner (``serving/tuner.py``, ``--mode tune``).

A UNet3D (features 4-8, 16³ ROI, 4 classes, f32) is swept on the CPU over
a 24³ volume. The report and the written profile keep the JAX tuner's keys,
and ``write_profile`` writes the JAX package's bytes for the same report.
One difference is pinned: when every parity-tier candidate (overlap ≥ 0.25)
was tried and failed, the port picks none, where the JAX tuner
(``serving/tuner.py:166-168``) falls back to a turbo candidate. Under
``torchrun`` (two ranks: ``tests/test_torch_distributed.py``) the ranks time
the multi-rank pass together and agree on each candidate.
"""

import json
import time

import pytest
import yaml

from multimodal_organ_segmentation_tpu.serving import tuner as jtuner
from multimodal_organ_segmentation_tpu_torch import cli
from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as SW
from multimodal_organ_segmentation_tpu_torch.serving import tuner
from multimodal_organ_segmentation_tpu_torch.utils.config import default_config, save_config
from tests.torch_port_utils import _one_thread  # noqa: F401

KEYS = {"overlap", "sw_batch", "volume_shape", "compile_s", "seconds_per_volume", "vol_per_min"}


@pytest.fixture()
def tune_cfg(tmp_path):
    cfg = default_config()
    cfg.set("model.name", "unet3d")
    cfg.set("model.out_channels", 4)
    cfg.set("model.backbone.features", [4, 8])
    cfg.set("model.backbone.img_size", [16, 16, 16])
    cfg.set("model.head.dropout", 0.0)
    cfg.set("inference.sliding_window.roi_size", [16, 16, 16])
    cfg.set("hardware.mixed_precision", "none")
    cfg.set("experiment.output_dir", str(tmp_path / "out"))
    cfg.set("experiment.log_dir", str(tmp_path / "logs"))
    cfg.set("tune.volume_shape", [24, 24, 24])
    cfg.set("tune.sw_batches", [1, 2])
    cfg.set("tune.repeats", 1)
    return cfg


def _runner_patch(monkeypatch, slow=None, fail=None):
    """Make the parity tier look slow, or one chunk size fail."""
    orig = SW.SlidingWindowRunner

    class Patched(orig):
        def __call__(self, volume, params=None):
            if fail is not None and self.sw_batch_size == fail:
                raise RuntimeError("CUDA out of memory")
            if slow and self.overlap >= 0.25:
                time.sleep(0.1)
            return orig.__call__(self, volume, params)

    monkeypatch.setattr(SW, "SlidingWindowRunner", Patched)


def test_sweep_measures_every_candidate_and_keeps_turbo_out(tune_cfg, monkeypatch):
    """2 chunk sizes × the config's overlap and the fast profiles 0.25 and
    0.125; with the parity tier slowed, turbo measures fastest but is not
    picked."""
    _runner_patch(monkeypatch, slow=True)
    report = tuner.tune_serving(tune_cfg, device="cpu")
    assert len(report["results"]) == 6
    assert {r["overlap"] for r in report["results"]} == {0.5, 0.25, 0.125}
    for r in report["results"]:
        assert set(r) == KEYS and r["vol_per_min"] > 0 and r["volume_shape"] == [24, 24, 24]
    fastest = max(report["results"], key=lambda r: r["vol_per_min"])
    assert fastest["overlap"] == 0.125
    tier = [r for r in report["results"] if r["overlap"] >= 0.25]
    assert report["best"] == max(tier, key=lambda r: r["vol_per_min"])


def test_allow_turbo_and_an_explicit_turbo_sweep(tune_cfg, monkeypatch):
    _runner_patch(monkeypatch, slow=True)
    tune_cfg.set("tune.sw_batches", [1])
    tune_cfg.set("tune.allow_turbo", True)
    assert tuner.tune_serving(tune_cfg, device="cpu")["best"]["overlap"] == 0.125
    tune_cfg.set("tune.allow_turbo", False)
    tune_cfg.set("tune.overlaps", [0.125])
    assert tuner.tune_serving(tune_cfg, device="cpu")["best"]["overlap"] == 0.125


def test_a_failed_candidate_is_recorded_and_the_sweep_goes_on(tune_cfg, monkeypatch):
    _runner_patch(monkeypatch, fail=2)
    tune_cfg.set("tune.overlaps", [0.5])
    report = tuner.tune_serving(tune_cfg, device="cpu")
    by_sw = {r["sw_batch"]: r for r in report["results"]}
    assert by_sw[2]["error"] == "RuntimeError: CUDA out of memory"
    assert by_sw[1]["vol_per_min"] > 0 and report["best"]["sw_batch"] == 1


def _rec(overlap, sw, vpm=None):
    r = {"overlap": overlap, "sw_batch": sw, "volume_shape": [24, 24, 24]}
    if vpm is None:
        r["error"] = "RuntimeError: CUDA out of memory"
    else:
        r.update(compile_s=0.1, seconds_per_volume=round(60 / vpm, 3), vol_per_min=vpm)
    return r


def test_no_turbo_fallback_when_the_parity_tier_was_tried_and_failed():
    """The divergence from the JAX tuner, whose ``pool = tier or ok`` would
    pick the 0.125 candidate here: the port picks none, and write_profile
    refuses to write."""
    failed_tier = [_rec(0.5, 8), _rec(0.25, 8), _rec(0.125, 8, 50.7)]
    assert tuner.select_best(failed_tier) is None
    assert tuner.select_best(failed_tier, allow_turbo=True)["overlap"] == 0.125
    # only a sweep with no parity-tier overlap at all falls back to turbo
    assert tuner.select_best([_rec(0.125, 4, 40.0), _rec(0.125, 8, 50.7)])["sw_batch"] == 8
    assert tuner.select_best([_rec(0.5, 8, 30.0), _rec(0.25, 8, 35.0),
                              _rec(0.125, 8, 50.7)])["overlap"] == 0.25
    with pytest.raises(RuntimeError, match="nothing to write"):
        tuner.write_profile({"results": failed_tier, "best": None}, "unused.yaml")


@pytest.mark.parametrize("best", [(0.5, 8, 33.33), (0.125, 9, 50.7)])
def test_write_profile_writes_the_jax_bytes(tmp_path, best):
    results = [_rec(0.5, 8, 33.33), _rec(0.25, 4), _rec(0.125, 9, 50.7)]
    report = {"results": results, "best": _rec(*best)}
    tuner.write_profile(report, tmp_path / "port" / "p.yaml")
    jtuner.write_profile(report, tmp_path / "jax" / "p.yaml")
    for name in ("p.yaml", "p.yaml.report.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    assert ("turbo" in (tmp_path / "port" / "p.yaml").read_text()) == (best[0] < 0.25)


def test_tune_mode_through_the_cli(tune_cfg, tmp_path):
    tune_cfg.set("tune.sw_batches", [2])
    tune_cfg.set("tune.overlaps", [0.5])
    path = tmp_path / "cfg.yaml"
    save_config(tune_cfg, path)
    profile = tmp_path / "tuned.yaml"
    cli.main(["--mode", "tune", "--config", str(path), "--device", "cpu", "--output",
              str(profile)])
    assert yaml.safe_load(profile.read_text())["inference"]["batch_size"] == 2
    sidecar = json.loads((tmp_path / "tuned.yaml.report.json").read_text())
    assert sidecar[0]["vol_per_min"] > 0


def test_tune_runs_as_one_process(tune_cfg, monkeypatch, tmp_path):
    """The tuner in a process group of one rank (gloo): the multi-rank path
    runs, each candidate's outcome settled by the ranks' votes
    (``parallel.mesh.agreement``); a failed candidate is recorded with its
    rank and the sweep goes on. Two ranks, one of them failing alone, run in
    ``tests/test_torch_distributed.py``."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        _runner_patch(monkeypatch, fail=2)
        tune_cfg.set("tune.overlaps", [0.5])
        report = tuner.tune_serving(tune_cfg, device="cpu")
    finally:
        dist.destroy_process_group()
    by_sw = {r["sw_batch"]: r for r in report["results"]}
    assert by_sw[2]["error"] == "RuntimeError: CUDA out of memory (rank 0)"
    assert set(by_sw[1]) == KEYS and by_sw[1]["vol_per_min"] > 0
    assert report["best"]["sw_batch"] == 1
