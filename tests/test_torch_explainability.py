"""The port's explainability tools against the JAX package's, on the CPU.

Each family gets the same seeded parameters in both packages (flax shapes
from ``jax.eval_shape``, values from a numpy seed, carried across by
``convert.params_from_jax``) and the same seeded input, in f32, where the
port's attention runs its custom ops' plain versions.

Tolerances: 1e-5 on the minmax-normalised maps (GradCAM, GradCAM++, the
native-grid blends, the attention saliency) and on the captured attention
values and pooled t-SNE features; 1e-4 relative (max |difference| over max
|value|) on gradient SHAP and integrated gradients.

The SwinUNETR's maps are held to JAX at ``SWIN_TOL`` = 3e-5: JAX's own f32
maps of that ~40-layer model are up to 1.4e-5 off the float64 maps (the
port's model run in float64), while the port's f32 maps stay within 1e-5 of
them (``test_swin_maps_are_within_1e_5_of_float64``). GradCAM++ maps are
held at ``PP_TOL`` = 1e-4: its α = g²/(2g² + ΣA·g³) divides by a sum that
nearly cancels where the gradients are small, which turns f32 rounding of
the gradients into up to 4.7e-5 of the normalised map (DualEncoder; 2e-5
SwinUNETR, 1e-6 UNet3D), and at shallow points into more (1.9e-4 at the
SwinUNETR's stage2, where plain GradCAM agrees within 5e-6).

The attention saliency maps are compared before their minmax: a window's
mean attention received is 1/N whatever the probabilities (each row sums to
1), so the JAX package's per-window saliency is constant up to rounding and
its normalised map is that rounding, stretched to [0, 1].
"""

from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu import explainability as jexp
from multimodal_organ_segmentation_tpu.explainability.runner import _perturb_names
from multimodal_organ_segmentation_tpu.models import build as jbuild
from multimodal_organ_segmentation_tpu.models.swin_unetr import SwinUNETR as JSwinUNETR
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch.explainability import (
    AttentionVisualizer,
    GradCAM,
    GradCAMPlusPlus,
    SHAPAnalyzer,
    TSNEVisualizer,
    perturb_names,
    visualize_gradcam,
)
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from multimodal_organ_segmentation_tpu_torch.models.swin_unetr import SwinUNETR
from multimodal_organ_segmentation_tpu_torch.models.unet3d import UNet3D
from tests.torch_port_utils import _one_thread, fill_params, init_shapes, no_tf32  # noqa: F401

TOL = 1e-5
SWIN_TOL = 3e-5
PP_TOL = 1e-4
REL_TOL = 1e-4


def _config(name, backbone, fusion=None):
    cfg = {"data": {"modalities": ["CT", "PET"]}, "hardware": {"mixed_precision": "fp32"},
           "model": {"name": name, "out_channels": 3, "enable_perturb": True,
                     "backbone": backbone}}
    if fusion:
        cfg["model"]["fusion"] = fusion
    return cfg


# family → (config, tile, GradCAM target). The SwinUNETR (the flagship's
# structure: cross attention at /8 and /16, shifted windows in stage 0) has a
# 32³ tile, where the bottleneck point stage4 is one voxel and its CAM a
# constant: its target is stage3 (2³). The others take the runner's target,
# the last point.
FAMILIES = {
    "unet3d": (_config("unet3d", {"features": [4, 8]}), (8, 8, 8), "backbone/feat1"),
    "attention_unet": (_config("attention_unet", {"features": [4, 8, 8]}), (8, 8, 8),
                       "backbone/feat2"),
    "swin_unetr": (_config("swin_unetr", {"img_size": [32, 32, 32], "feature_size": 12,
                                          "depths": [2, 1, 1, 1], "num_heads": [3, 3, 3, 3],
                                          "window_size": [4, 4, 4]},
                           {"type": "cross_attention", "stages": [1, 2]}),
                   (32, 32, 32), "backbone/stage3"),
    "dual_encoder": (_config("dual_encoder", {"features": [4, 8, 8], "img_size": [8, 8, 8]},
                             {"type": "attention"}), (8, 8, 8), "backbone/fused2"),
}
_CACHE = {}
_JAX_CAMS = {}
_JAX_MAPS = {}


@pytest.fixture(autouse=True)
def _full_f32():
    no_tf32()


def pair(family):
    """(flax model, its variables with zero perturbations, the port's model
    with the same weights, a seeded input ``[1, *tile, 2]``), built once."""
    if family not in _CACHE:
        cfg, tile, _ = FAMILIES[family]
        flax_model = jbuild.build_model(JConfig(cfg))
        shapes = init_shapes(flax_model, np.zeros((1, *tile, 2), np.float32), train=False)
        variables = {
            "params": jax.tree_util.tree_map(jnp.asarray, fill_params(shapes["params"], 3)),
            "perturbations": jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                                    shapes["perturbations"]),
        }
        if "batch_stats" in shapes:
            variables["batch_stats"] = fill_params(shapes["batch_stats"], 4)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(convert.params_from_jax(cfg["model"]["name"], variables))
        x = np.random.default_rng(5).normal(size=(1, *tile, 2)).astype(np.float32)
        _CACHE[family] = JittedApply(flax_model), variables, model, x
    return _CACHE[family]


class JittedApply:
    """A flax model whose ``apply`` runs jitted. The JAX tools call ``apply``
    eagerly in places, and run op by op the first such call compiles every
    primitive on its own: 16 s for the SwinUNETR. Their three eager forwards
    (GradCAM's ``capture=True``, the attention capture's
    ``mutable=["intermediates"]`` and the t-SNE features') are one forward
    that returns both, compiled once per family and bit for bit the forward
    each asks for; any other call, and any call inside a trace, is one
    jitted program per set of keyword arguments."""

    _EAGER = ({"train": False, "capture": True}, {"train": False, "mutable": ["intermediates"]})

    def __init__(self, module):
        self.module = module
        self._fns = {}

    def apply(self, variables, *args, **kwargs):
        if kwargs in self._EAGER and not any(isinstance(a, jax.core.Tracer) for a in args):
            (logits, feats), state = self._jitted(train=False, capture=True,
                                                  mutable=["intermediates"])(variables, *args)
            return (logits, feats) if "capture" in kwargs else (logits, state)
        return self._jitted(**kwargs)(variables, *args)

    def _jitted(self, **kwargs):
        key = repr(sorted(kwargs.items()))
        if key not in self._fns:
            self._fns[key] = jax.jit(partial(self.module.apply, **kwargs))
        return self._fns[key]

    def __getattr__(self, name):
        return getattr(self.module, name)


def jax_cam(family, cam="GradCAM"):
    """The JAX package's ``cam`` (``GradCAM`` or ``GradCAMPlusPlus``) on
    ``family``'s pair, built once per family and class and shared by the
    tests. GradCAM++ reuses GradCAM's compiled gradient, the same function
    of the same model and parameters: only its weighting differs."""
    key = (family, cam)
    if key not in _JAX_CAMS:
        flax_model, variables, _, _ = pair(family)
        ref = getattr(jexp, cam)(flax_model, variables, [FAMILIES[family][2]])
        if cam != "GradCAM":
            ref._grad_fn = jax_cam(family)._grad_fn
        _JAX_CAMS[key] = ref
    return _JAX_CAMS[key]


def jax_map(family, cam="GradCAM"):
    """``cam``'s map of ``family``'s tile by the JAX package
    (``generate(x, class_idx=1)``), computed once: on one tile the JAX
    package's ``generate_native`` blends that tile alone, so the native
    one-tile test shares it."""
    if (family, cam) not in _JAX_MAPS:
        _, _, _, x = pair(family)
        _JAX_MAPS[family, cam] = jax_cam(family, cam).generate(jnp.asarray(x), 1)
    return _JAX_MAPS[family, cam]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(a)).max())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_perturbation_names_and_their_order(family):
    _, variables, model, _ = pair(family)
    names = perturb_names(model)
    assert names == _perturb_names(variables)
    assert names[-1] == {"unet3d": "backbone/feat1", "attention_unet": "backbone/feat2",
                         "swin_unetr": "backbone/stage4",
                         "dual_encoder": "backbone/fused2"}[family]


def test_perturbation_names_sort_as_flax_flattens():
    """flax flattens dict keys sorted: feat10 comes before feat2."""
    model = UNet3D(features=[2] * 11)
    tree = {"perturbations": {"backbone": {f"feat{i}": np.zeros(1) for i in range(11)}}}
    assert perturb_names(model) == _perturb_names(tree)
    assert perturb_names(model)[:3] == ["backbone/feat0", "backbone/feat1", "backbone/feat10"]


@pytest.mark.parametrize("cam", ["GradCAM", "GradCAMPlusPlus"])
@pytest.mark.parametrize("family", ["unet3d", "swin_unetr", "dual_encoder"])
def test_gradcam_generate_matches_jax(family, cam):
    _, _, model, x = pair(family)
    target = FAMILIES[family][2]
    ref = jax_map(family, cam)
    out = {"GradCAM": GradCAM, "GradCAMPlusPlus": GradCAMPlusPlus}[cam](model, [target]).generate(
        x, class_idx=1)
    assert list(out) == [target] and out[target].shape == x.shape[1:4]
    assert out[target].max() > 0.99  # a map, not a constant
    tol = PP_TOL if cam == "GradCAMPlusPlus" else SWIN_TOL if family == "swin_unetr" else TOL
    np.testing.assert_allclose(out[target], ref[target], atol=tol)


def _float64_map(cam_class, target, x):
    """The port's SwinUNETR in float64: its normalised map of ``x``."""
    import copy

    model = copy.deepcopy(pair("swin_unetr")[2]).double()
    model.dtype = torch.float64
    cam = cam_class(model, [target])._cams(torch.from_numpy(x).double(), 1, per_tile=False,
                                           strict=True)[target]
    return ((cam - cam.min()) / (cam.max() - cam.min() + 1e-8))[0].numpy()


@pytest.mark.parametrize("cam", ["GradCAM", "GradCAMPlusPlus"])
def test_swin_maps_are_within_1e_5_of_float64(cam):
    cam_class = {"GradCAM": GradCAM, "GradCAMPlusPlus": GradCAMPlusPlus}[cam]
    _, _, model, x = pair("swin_unetr")
    target = FAMILIES["swin_unetr"][2]
    out = cam_class(model, [target]).generate(x, class_idx=1)[target]
    np.testing.assert_allclose(out, _float64_map(cam_class, target, x), atol=TOL)


@pytest.mark.parametrize("volume", ["one_tile", "several_tiles"])
@pytest.mark.parametrize("family", ["unet3d", "swin_unetr", "dual_encoder"])
def test_gradcam_native_matches_jax(family, volume):
    """On one tile the blend equals ``generate`` on the volume, and the JAX
    package's map of that tile is the reference (its ``generate_native`` of
    one tile blends that tile alone: the map ``jax_map`` shares with the
    ``generate`` test); on several, JAX's blend."""
    _, _, model, x = pair(family)
    target = FAMILIES[family][2]
    roi = x.shape[1:4]
    if volume == "one_tile":
        vol = x[0]
        ref = jax_map(family)
    else:
        vol = np.random.default_rng(6).normal(
            size=(roi[0] + 8, roi[1] + 4, roi[2], 2)).astype(np.float32)
        ref = jax_cam(family).generate_native(
            vol, class_idx=1, roi_size=roi, overlap=0.5, sw_batch_size=2)
    out = GradCAM(model, [target]).generate_native(vol, class_idx=1, roi_size=roi, overlap=0.5,
                                                   sw_batch_size=2)
    assert out[target].shape == vol.shape[:3] and out[target].max() > 0.99
    np.testing.assert_allclose(out[target], ref[target],
                               atol=SWIN_TOL if family == "swin_unetr" else TOL)
    if volume == "one_tile":
        whole = GradCAM(model, [target]).generate(x, class_idx=1)[target]
        np.testing.assert_allclose(out[target], whole, atol=TOL)


@pytest.mark.parametrize("family", ["swin_unetr", "dual_encoder"])
def test_attention_capture_keys_order_and_values(family):
    """Every window attention's probabilities (dense path, as flax's capture
    forward) and the modality weights, under flax's names in its order."""
    flax_model, variables, model, x = pair(family)
    ref = jexp.AttentionVisualizer(flax_model, variables).capture(jnp.asarray(x))
    out = AttentionVisualizer(model).capture(x)
    assert list(out) == list(ref)
    assert len(out) == (5 if family == "swin_unetr" else 3)
    for name in ref:
        assert out[name].shape == ref[name].shape, name
        np.testing.assert_allclose(out[name], ref[name], atol=TOL, err_msg=name)


def test_capture_forward_leaves_the_logits_alone():
    _, _, model, x = pair("swin_unetr")
    with torch.no_grad():
        plain = model(torch.from_numpy(x))
        captured = model(torch.from_numpy(x), intermediates={})
    np.testing.assert_allclose(captured.numpy(), plain.numpy(), atol=1e-5)


def _anisotropic_swin():
    """The JAX package's own anisotropic-ROI case (tests/test_explainability.py):
    a 32×32×64 ROI whose every stage's window grid is anisotropic."""
    flax_model = JSwinUNETR(out_channels=2, feature_size=4, depths=(1, 1, 1, 1),
                            num_heads=(1, 1, 1, 1), window_size=(2, 2, 2))
    x = np.random.default_rng(3).normal(size=(32, 32, 64, 1)).astype(np.float32)
    shapes = init_shapes(flax_model, x[None], train=False)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, fill_params(shapes["params"], 7))}
    model = SwinUNETR(in_channels=1, out_channels=2, img_size=(32, 32, 64), feature_size=4,
                      depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 1), window_size=(2, 2, 2))
    model.load_state_dict(convert.params_from_jax("swin_unetr", variables))
    return flax_model, variables, model.eval(), x


def test_saliency_native_on_an_anisotropic_roi_matches_jax():
    """Every stage's window grid folds on its own axes; the per-tile
    saliency before the minmax equals JAX's, and the native maps come out
    on the grid, finite, in [0, 1]."""
    flax_model, variables, model, x = _anisotropic_swin()
    jviz, viz = jexp.AttentionVisualizer(flax_model, variables), AttentionVisualizer(model)
    ref = np.asarray(jax.jit(lambda p, t: jviz._tile_saliency(p, t, 4))(
        variables["params"], jnp.asarray(x)[None]))
    tile = viz._tile_saliency(torch.from_numpy(x)[None], 4).numpy()
    assert tile.shape == ref.shape == (1, 32, 32, 64, 4)
    np.testing.assert_allclose(tile, ref, atol=TOL)
    out = viz.saliency_native(x, roi_size=(32, 32, 64), sw_batch_size=1)
    assert len(out) == 4  # every stage folds, as in the JAX package's own test
    for o in out:
        assert o.shape == (32, 32, 64) and np.isfinite(o).all()
        assert o.min() >= 0 and o.max() <= 1 + 1e-6


def test_window_grid_folds_anisotropic_grids_and_refuses_ambiguous_ones():
    """Per-axis counts from the model's window size (JAX's rule); where two
    downsample levels would give different grids of the same product the
    fold is ambiguous and there is none (the JAX package returns the first)."""
    viz = AttentionVisualizer(_anisotropic_swin()[2])
    assert viz._window_grid(512, (16, 32, 64)) == (4, 8, 16)
    assert viz._window_grid(512, (32, 32, 32)) == (8, 8, 8)
    viz._level_grids = lambda spatial: [(2, 4, 8), (4, 4, 4), (4, 2, 1)]
    assert viz._window_grid(64, (16, 32, 64)) is None
    assert viz._window_grid(8, (16, 32, 64)) == (4, 2, 1)
    viz.model = object()  # no window size: a cube grid, or none
    del viz._level_grids
    assert viz._window_grid(512, (16, 32, 64)) == (8, 8, 8)
    assert viz._window_grid(500, (16, 32, 64)) is None


def test_layer_match_is_exact_full_path_first_then_leaf():
    names = ["backbone/feat1", "backbone/feat10"]
    assert GradCAM._match(names, "feat1") == "backbone/feat1"
    assert GradCAM._match(names, "feat10") == "backbone/feat10"
    assert GradCAM._match(names, "feat2") is None
    two = ["enc_a/feat1", "enc_b/feat1"]
    assert GradCAM._match(two, "enc_a/feat1") == "enc_a/feat1"  # the JAX package raises here
    with pytest.raises(ValueError, match="ambiguous"):
        GradCAM._match(two, "feat1")


@pytest.mark.parametrize("family", ["unet3d", "dual_encoder"])
def test_gradient_shap_and_integrated_gradients_match_jax(family):
    flax_model, variables, model, x = pair(family)
    ref = jexp.SHAPAnalyzer(flax_model, variables, n_steps=4)
    shap = SHAPAnalyzer(model, n_steps=4)
    for baseline in ("background", "zeros"):
        assert _rel(ref.gradient_shap(jnp.asarray(x), 1, baseline),
                    shap.gradient_shap(x, 1, baseline)) < REL_TOL
        assert _rel(ref.integrated_gradients(jnp.asarray(x), 1, baseline),
                    shap.integrated_gradients(x, 1, baseline)) < REL_TOL
    vol = np.random.default_rng(8).normal(size=(12, 12, 8, 2)).astype(np.float32)
    r = ref.integrated_gradients_native(vol, 1, roi_size=(8, 8, 8), sw_batch_size=2)
    o = shap.integrated_gradients_native(vol, 1, roi_size=(8, 8, 8), sw_batch_size=2)
    assert o.shape == (12, 12, 8, 2) and o.min() < 0 < o.max()
    assert _rel(r, o) < REL_TOL


def test_integrated_gradients_completeness():
    """Σ attributions ≈ F(x) − F(baseline) with the midpoint rule, on the
    JAX package's own completeness case (flax's init of its UNet3D, key 0)."""
    from multimodal_organ_segmentation_tpu.models.unet3d import UNet3D as JUNet3D

    x = np.random.default_rng(0).normal(size=(1, 8, 8, 8, 2)).astype(np.float32)
    flax_model = JUNet3D(out_channels=3, features=(4, 8), enable_perturb=True)
    variables = jax.jit(lambda k: flax_model.init(k, jnp.asarray(x), train=False))(
        jax.random.key(0))
    model = UNet3D(out_channels=3, features=(4, 8))
    model.load_state_dict(convert.params_from_jax("unet3d", variables))
    attr = SHAPAnalyzer(model.eval(), n_steps=64).integrated_gradients(x, class_idx=1)
    baseline = np.broadcast_to(x.mean(axis=(1, 2, 3), keepdims=True), x.shape).copy()
    with torch.no_grad():
        diff = float(model(torch.from_numpy(x))[..., 1].sum()
                     - model(torch.from_numpy(baseline))[..., 1].sum())
    assert attr.sum() == pytest.approx(diff, rel=0.08)


@pytest.mark.parametrize("family", ["unet3d", "swin_unetr", "dual_encoder"])
def test_tsne_features_match_jax(family):
    flax_model, variables, model, _ = pair(family)
    tile = FAMILIES[family][1]
    rng = np.random.default_rng(9)
    samples = [{"image": rng.normal(size=(*tile, 2)).astype(np.float32),
                "label": rng.integers(0, 3, tile)} for _ in range(3)]
    ref = jexp.TSNEVisualizer(flax_model, variables)
    # its own ``jax.jit`` of the features would compile the forward again:
    # unjitted, the pooling runs around the family's one capture forward
    ref._extract = ref._pooled_features
    ref = ref.collect(samples)
    out = TSNEVisualizer(model).collect(samples)
    np.testing.assert_array_equal(out["labels"], ref["labels"])
    np.testing.assert_allclose(out["features"], ref["features"], atol=TOL)


def test_figures_are_written(tmp_path):
    _, _, model, x = pair("unet3d")
    cam = GradCAM(model, ["feat1"]).generate(x)["feat1"]
    assert Path(visualize_gradcam(x[0], cam, tmp_path / "cam.png")).stat().st_size > 1000
    shap = SHAPAnalyzer(model, n_steps=2)
    out = shap.visualize(x, shap.gradient_shap(x), tmp_path / "shap.png")
    assert Path(out).stat().st_size > 1000
    rng = np.random.default_rng(0)
    samples = [{"image": rng.normal(size=(8, 8, 8, 2)).astype(np.float32),
                "label": rng.integers(0, 3, (8, 8, 8))} for _ in range(6)]
    out = TSNEVisualizer(model, perplexity=3).visualize(samples, tmp_path / "tsne.png")
    assert Path(out).stat().st_size > 1000
    _, _, swin, xs = pair("swin_unetr")
    written = AttentionVisualizer(swin).visualize(xs, tmp_path / "attn")
    assert len(written) == 5 and written[-1].endswith("attention_heads_grid.png")
    assert all(Path(f).stat().st_size > 1000 for f in written)


@pytest.mark.parametrize("family", ["unet3d", "swin_unetr"])
def test_params_from_jax_ignores_perturbations_and_intermediates(family):
    """A ``variables`` tree as the JAX runner builds it: params beside the
    perturbations and the sown intermediates."""
    cfg, tile, _ = FAMILIES[family]
    flax_model, variables, _, _ = pair(family)
    x = jnp.zeros((1, *tile, 2))
    _, state = jax.eval_shape(lambda p: flax_model.apply({"params": p}, x, train=False,
                                                         mutable=["intermediates"]),
                              variables["params"])
    variables = {**variables, "intermediates": jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), state.get("intermediates", {}))}
    assert "perturbations" in variables and (family == "unet3d") != bool(variables["intermediates"])
    got = convert.params_from_jax(cfg["model"]["name"], variables)
    want = convert.params_from_jax(cfg["model"]["name"], {"params": variables["params"]})
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_explanations_leave_parameter_grads_and_the_model_alone():
    _, _, model, x = pair("dual_encoder")
    marks = {n: torch.full_like(p, 0.5) for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = marks[n].clone()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    GradCAMPlusPlus(model, ["fused2"]).generate(x)
    SHAPAnalyzer(model, n_steps=2).integrated_gradients(x)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, marks[n]), n
        p.grad = None
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_perturbation_points_need_no_enable_perturb():
    """``model.enable_perturb`` is accepted and ignored: a model built
    without it lists the same points, fills a ``perturb`` dict and gives the
    same CAM. A target that names no point, or a module without points,
    raises."""
    cfg = _config("unet3d", {"features": [4, 8]})
    cfg["model"]["enable_perturb"] = False
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    cfg["model"]["enable_perturb"] = True
    opened = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert perturb_names(model) == perturb_names(opened) == ["backbone/feat0", "backbone/feat1"]
    points = {}
    model(torch.zeros(1, 8, 8, 8, 2), perturb=points)
    assert sorted(points) == ["feat0", "feat1"]
    x = np.random.default_rng(0).normal(size=(1, 8, 8, 8, 2)).astype(np.float32)
    cams = [GradCAM(m.eval(), ["feat1"]).generate(x, class_idx=1) for m in (model, opened)]
    assert np.array_equal(cams[0]["feat1"], cams[1]["feat1"])
    with pytest.raises(ValueError, match="not in perturbation"):
        GradCAM(pair("unet3d")[2], ["nope"])
    with pytest.raises(ValueError, match="no perturbation points"):
        GradCAM(torch.nn.Conv3d(2, 2, 1), ["feat0"])
