"""``--mode explain`` of the port's CLI against the JAX CLI's, on the CPU.

Apart from ``tests/test_torch_cli.py`` (which shares its helpers) because
it runs alone: the JAX CLI's explain run is most of its minute, and a file
of few tests queues beside the suite's longest file rather than ahead of it
(xdist's ``loadfile`` hands out files with more tests first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import yaml

from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti
from tests.test_torch_cli import AFFINE, _files, _run
from tests.torch_port_utils import _one_thread, seeded_variables  # noqa: F401


def _explain_world(root):
    """A DualEncoder of two levels (attention fusion, which sows its
    modality weights) with seeded weights as a port checkpoint and as the
    JAX package's own, three CT+PET cases of other shapes than its 8³ tile,
    and a config with every tool on, on native grids. The JAX CLI compiles
    the model's init (a threefry draw per parameter) and each tool afresh
    for every case, so the model is as small as keeps every tool's path."""
    from multimodal_organ_segmentation_tpu.models import build as jbuild
    from multimodal_organ_segmentation_tpu.train.checkpoint import save_checkpoint as jsave
    from multimodal_organ_segmentation_tpu.train.optim import make_optimizer
    from multimodal_organ_segmentation_tpu.train.trainer import TrainState

    cfg = {
        "experiment": {"name": "explain", "seed": 0, "log_dir": str(root / "logs")},
        "data": {"modalities": ["CT", "PET"]},
        "model": {"name": "dual_encoder", "out_channels": 3,
                  "backbone": {"features": [4, 8], "img_size": [8, 8, 8]},
                  "fusion": {"type": "attention"}},
        "inference": {"sliding_window": {"overlap": 0.5}, "batch_size": 2},
        "explainability": {"native_grid": True, "gradcam": {"enabled": True},
                           "attention_maps": {"enabled": True},
                           "tsne": {"enabled": True, "perplexity": 2},
                           "shap": {"enabled": True, "n_samples": 2}},
        "training": {"optimizer": {"name": "adamw", "lr": 1e-3}},
        "hardware": {"mixed_precision": "fp32"},
    }
    jcfg = JConfig(cfg)
    flax_model = jbuild.build_model(jcfg)
    variables = seeded_variables(flax_model, np.zeros((1, 8, 8, 8, 2), np.float32), train=False,
                                 seed=12)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jsave(TrainState(step=jnp.zeros((), jnp.int32), params=params,
                     opt_state=jax.jit(make_optimizer(jcfg).init)(params), extra={}),
          root / "jckpt")
    save_checkpoint({"step": 0, "params": convert.params_from_jax("dual_encoder", variables),
                     "opt_state": None, "ema_params": None}, root / "ckpt")
    rng = np.random.default_rng(13)
    for case, shape in {"c1": (12, 10, 8), "c2": (8, 8, 8), "c3": (12, 10, 8)}.items():
        for mod in ("ct", "pet"):
            save_nifti(rng.normal(size=shape).astype(np.float32),
                       root / "input" / mod / f"{case}.nii.gz", affine=AFFINE)
    path = root / "explain.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path



def test_explain_mode_matches_the_jax_cli(tmp_path):
    """``--mode explain`` writes the JAX CLI's file set; the native GradCAM
    maps within 1e-5 of the JAX CLI's and the native IG maps within 1e-4
    relative (the tolerances of tests/test_torch_explainability.py)."""
    from multimodal_organ_segmentation_tpu import cli as jcli

    config = _explain_world(tmp_path)
    jcli.main(["--mode", "explain", "--config", str(config), "--checkpoint",
               str(tmp_path / "jckpt"), "--input", str(tmp_path / "input"), "--output",
               str(tmp_path / "jax"), "--device", "cpu"])
    _run(config, "explain", "--checkpoint", str(tmp_path / "ckpt"), "--input",
         str(tmp_path / "input"), "--output", str(tmp_path / "port"))
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert "tsne.png" in files and "c1_attention" in files
    maps = [f for f in files if f.endswith(".nii.gz")]
    assert len(maps) == 9  # per case: GradCAM on fused1, IG of CT and of PET
    for name in maps:
        got, want = load_nifti(tmp_path / "port" / name), load_nifti(tmp_path / "jax" / name)
        assert got.shape == want.shape, name
        if "gradcam" in name:
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        else:
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    for name in files:
        if name.endswith(".png"):
            assert (tmp_path / "port" / name).stat().st_size > 1000, name
