"""The port's registration (``preprocessing/registration.py``) against the
JAX package's, on the CPU at 16³–24³ from numpy seeds.

Tolerances: the sampler's value 1e-6 and its coordinate gradient 1e-5 (at
the integer identity grid the gradient is JAX's forward difference, exactly);
the pyramid helpers and B-spline 1e-6; the metrics 1e-6 relative of their
float64 value and 5e-6 of JAX's (JAX's f32 sums on the CPU land up to 3e-6
from float64, the port's within 6e-8), their gradients 1e-5; Adam 1e-7;
``register_arrays`` final parameters 1e-3 voxel and the warp 1e-4.

Each method's ``register_arrays`` is held to JAX with a metric whose
trajectory is stable under f32 rounding. MI's is not across pyramid levels:
its f32 gradient with respect to the translation moves by about 3e-5
relative with the order of summation (JAX's and the port's are each about
3e-4 from float64; ``test_mi_translation_gradient_matches_at_a_level``),
and Adam carries that into trajectories that part by tenths of a voxel
within ten iterations. MI is held on one level at lr 0.1 for 5 iterations,
where the parameters agree to 3e-6.

Each test loops over its cases (methods, metrics, sigmas): xdist's
``loadfile`` sends files with many tests first, and this file's JAX
references must not delay the suite's longest file.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodal_organ_segmentation_tpu.preprocessing import registration as JR
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch.preprocessing import registration as TR
from multimodal_organ_segmentation_tpu_torch.preprocessing.registration import ImageRegistration
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti
from tests.torch_port_utils import _one_thread  # noqa: F401

METHODS = ("translation", "rigid", "affine", "deformable")


def _t(a, grad=False) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _smooth_volume(shape, seed):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.normal(size=shape), 2).astype(np.float32)


def _random_params(method, seed, mesh_size=2):
    rng = np.random.default_rng(seed)
    p = {"t": rng.normal(0, 1.5, 3)}
    if method == "rigid":
        p["r"] = rng.normal(0, 0.1, 3)
    elif method == "affine":
        p["A"] = rng.normal(0, 0.05, (3, 3))
    elif method == "deformable":
        g = mesh_size + 3
        p["grid"] = rng.normal(0, 1.0, (g, g, g, 3))
    return {k: v.astype(np.float32) for k, v in p.items()}


# --------------------------------------------------------------------------
# the sampler, the transforms and the pyramid helpers
# --------------------------------------------------------------------------

def test_sample_value_and_gradient_match_map_coordinates():
    """At the integer identity grid JAX's coordinate gradient is the forward
    difference ``v[i+1] - v[i]`` (0 past the last voxel); fractional
    coordinates reach 2 voxels outside the volume, where corners sample 0."""
    for where in ("identity", "fractional"):
        rng = np.random.default_rng(0)
        vol = rng.normal(size=(16, 18, 20)).astype(np.float32)
        cot = rng.normal(size=vol.shape).astype(np.float32)
        if where == "identity":
            coords = np.asarray(JR._identity_coords(vol.shape))
        else:
            coords = rng.uniform(-2, 22, size=(3, *vol.shape)).astype(np.float32)
        jv, jvjp = jax.vjp(lambda c: JR._sample(jnp.asarray(vol), c), jnp.asarray(coords))
        c = _t(coords, grad=True)
        tv = TR._sample(_t(vol), c)
        (tv * _t(cot)).sum().backward()
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=1e-6,
                                   err_msg=where)
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(jvjp(jnp.asarray(cot))[0]),
                                   rtol=0, atol=1e-5, err_msg=where)
        if where == "identity":
            forward = np.diff(vol, axis=0, append=0)
            np.testing.assert_allclose(c.grad.numpy()[0], cot * forward, rtol=0, atol=1e-6)


def test_sample_nearest_rounds_exact_halves_to_even():
    rng = np.random.default_rng(1)
    vol = rng.integers(0, 9, (16, 16, 16)).astype(np.float32)
    base = np.asarray(JR._identity_coords(vol.shape))
    coords = (base * 0.5 + 0.5 * rng.integers(-2, 3, (3, 1, 1, 1))).astype(np.float32)
    coords[0, :2] = -0.5  # half a voxel outside: rounds to 0 (even), inside
    coords[1, -2:] = 15.5  # rounds to 16, outside
    want = np.asarray(JR._sample_nearest(jnp.asarray(vol), jnp.asarray(coords)))
    got = TR._sample_nearest(_t(vol), _t(coords)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.any(got[:, -2:] == 0)


def test_transform_coords():
    shape = (16, 18, 20)
    center = [(s - 1) / 2 for s in shape]
    for method in METHODS:
        p = _random_params(method, 2)
        want = jax.jit(JR.transform_coords, static_argnums=(2, 4))(
            {k: jnp.asarray(v) for k, v in p.items()}, JR._identity_coords(shape), method,
            jnp.asarray(center, jnp.float32), shape)
        got = TR.transform_coords({k: _t(v) for k, v in p.items()}, TR._identity_coords(shape),
                                  method, _t(center), shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=method)


def test_bspline_weights_and_upsample():
    weights = jax.jit(JR._bspline_weights_1d, static_argnums=(0, 1))
    for out_len, n_ctrl in ((33, 9), (16, 5), (1, 7)):
        np.testing.assert_allclose(TR._bspline_weights_1d(out_len, n_ctrl).numpy(),
                                   np.asarray(weights(out_len, n_ctrl)), rtol=0, atol=1e-6)
    ctrl = np.random.default_rng(3).normal(size=(6, 5, 7, 3)).astype(np.float32)
    upsample = jax.jit(JR.bspline_upsample, static_argnums=1)
    np.testing.assert_allclose(TR.bspline_upsample(_t(ctrl), (16, 17, 18)).numpy(),
                               np.asarray(upsample(jnp.asarray(ctrl), (16, 17, 18))),
                               rtol=0, atol=1e-6)


def test_gaussian_smooth():
    """σ ∈ {0, 1, 2}; an axis shorter than the kernel raises (JAX's fails)."""
    vol = np.random.default_rng(4).normal(size=(16, 17, 18)).astype(np.float32)
    for sigma in (0, 1, 2):
        np.testing.assert_allclose(TR._gaussian_smooth(_t(vol), sigma).numpy(),
                                   np.asarray(JR._gaussian_smooth(jnp.asarray(vol), sigma)),
                                   rtol=0, atol=1e-6, err_msg=f"sigma {sigma}")
    with pytest.raises(ValueError, match="at least 13"):
        TR._gaussian_smooth(torch.zeros(16, 12, 16), 2)


def test_shrink():
    vol = _smooth_volume((24, 20, 40), 5)
    for factor in (1, 2, 4):
        got = TR._shrink(_t(vol), factor).numpy()
        want = np.asarray(JR._shrink(jnp.asarray(vol), factor))
        assert got.shape == want.shape, factor
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"factor {factor}")


def test_metric_value_and_gradient():
    """At the identity warp (the minimum and the maximum sit on MI's bin
    centres 0 and 49, where JAX's ``|x|`` has gradient 1 and the tent's
    ``maximum`` splits a tie) and at a perturbed one."""
    from scipy.ndimage import shift as nd_shift

    rng = np.random.default_rng(6)
    fixed = _smooth_volume((18, 20, 22), 6)
    moving = (nd_shift(fixed, [1.3, -0.8, 0.6], order=1) * -2 + 3).astype(np.float32)
    perturbed = moving + 0.01 * rng.normal(size=moving.shape).astype(np.float32)
    for metric in sorted(TR._METRICS):
        value_and_grad = jax.jit(jax.value_and_grad(
            lambda w: JR._METRICS[metric](jnp.asarray(fixed), w)))
        for warped in (moving, perturbed):
            jv, jg = value_and_grad(jnp.asarray(warped))
            w = _t(warped, grad=True)
            tv = TR._METRICS[metric](_t(fixed), w)
            tv.backward()
            exact = float(TR._METRICS[metric](_t(fixed).double(), _t(warped).double()))
            np.testing.assert_allclose(tv.item(), exact, rtol=1e-6, err_msg=metric)
            np.testing.assert_allclose(tv.item(), float(jv), rtol=5e-6, err_msg=metric)
            np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-5,
                                       err_msg=metric)


def test_mi_translation_gradient_matches_at_a_level():
    """MI's gradient with respect to the translation through the sampler, at
    a fractional offset on a 12³ pyramid level: within 1e-4 relative of JAX's
    (measured 3.3e-5; each package's f32 value is about 3e-4 from float64)."""
    from scipy.ndimage import shift as nd_shift

    vol = _smooth_volume((24, 24, 24), 0)
    mv = (nd_shift(vol, [1.3, -0.8, 0.6], order=1) * -2 + 3).astype(np.float32)
    f2, m2 = (np.asarray(JR._shrink(jnp.asarray(v), 2)) for v in (vol, mv))
    coords = np.asarray(JR._identity_coords(f2.shape))
    inner = (slice(1, 11),) * 3
    t0 = np.asarray([0.25, -0.25, 0.25], np.float32)

    def jloss(t):
        warped = JR._sample(jnp.asarray(m2), jnp.asarray(coords) + t[:, None, None, None])
        return JR.neg_mattes_mi(jnp.asarray(f2)[inner], warped[inner])

    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(t0)))
    t = _t(t0, grad=True)
    TR.neg_mattes_mi(_t(f2)[inner],
                     TR._sample(_t(m2), _t(coords) + t[:, None, None, None])[inner]).backward()
    np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())


def test_adam_follows_optax():
    """``_Adam`` against ``optax.adam`` over five steps from one state, with
    a zero gradient component (Adam's 0/eps) and a sign change."""
    rng = np.random.default_rng(7)
    p0 = {"t": rng.normal(size=3).astype(np.float32),
          "A": rng.normal(size=(3, 3)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    grads[0]["t"][1] = 0.0
    grads[1]["t"][0] = -grads[0]["t"][0]
    tx = optax.adam(0.1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: _t(v) for k, v in p0.items()}
    adam = TR._Adam(tp, 0.1)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        tp = adam.step(tp, {k: _t(v) for k, v in g.items()})
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)


# --------------------------------------------------------------------------
# register_arrays
# --------------------------------------------------------------------------

PYRAMID = {"shrink_factors": [2, 1], "smoothing_sigmas": [1, 0]}
ONE_LEVEL = {"shrink_factors": [1], "smoothing_sigmas": [0]}
# the level scaling of the translation and the control grid; smoothing in the
# loop is held by test_zero_iterations_report_the_identity_metric (JAX's
# eager smoothing compiles for seconds)
SHRINK = {"shrink_factors": [2, 1], "smoothing_sigmas": [0, 0]}
REGISTER_CASES = {
    "translation": ("correlation", 15, ONE_LEVEL),
    "rigid": ("mean_squares", 15, ONE_LEVEL),
    "affine": ("mean_squares", 15, ONE_LEVEL),
    "deformable": ("mean_squares", 15, {**SHRINK, "mesh_size": 2}),
    "translation-mi": ("mattes_mutual_information", 5, {**ONE_LEVEL, "lr": 0.1}),
}


def _register_pair():
    from scipy.ndimage import shift as nd_shift

    fixed = _smooth_volume((20, 22, 24), 0)
    moving = (nd_shift(fixed, [1.3, -0.8, 0.6], order=1) * -2 + 3).astype(np.float32)
    return fixed, moving


def _register_config(case):
    metric, iterations, extra = REGISTER_CASES[case]
    return {"data": {"registration": {"method": case.split("-")[0], "metric": metric,
                                      "iterations": iterations, **extra}}}


def test_register_arrays_follows_jax():
    fixed, moving = _register_pair()
    for case in REGISTER_CASES:
        cfg = _register_config(case)
        j_warped, j_transform = JR.ImageRegistration(JConfig(cfg)).register_arrays(fixed, moving)
        reg = ImageRegistration(ConfigNode(cfg), device="cpu")
        warped, transform = reg.register_arrays(fixed, moving)
        assert (transform["method"], transform["metric"]) == \
            (j_transform["method"], j_transform["metric"]), case
        assert sorted(transform["params"]) == sorted(j_transform["params"]), case
        for k, v in j_transform["params"].items():
            np.testing.assert_allclose(np.asarray(transform["params"][k]), np.asarray(v),
                                       rtol=0, atol=1e-3, err_msg=f"{case} {k}")
        np.testing.assert_allclose(warped, j_warped, rtol=0, atol=1e-4, err_msg=case)
        np.testing.assert_allclose(transform["final_metric"], j_transform["final_metric"],
                                   rtol=1e-4, atol=1e-6, err_msg=case)
        assert [lv["shape"] for lv in reg.levels] == [
            tuple(max(s // f, 8) if f > 1 else s for s in fixed.shape)
            for f in REGISTER_CASES[case][2]["shrink_factors"]], case


def test_zero_iterations_report_the_identity_metric():
    fixed, moving = _register_pair()
    cfg = {"data": {"registration": {"iterations": 0, "metric": "mean_squares", **PYRAMID}}}
    _, j_transform = JR.ImageRegistration(JConfig(cfg)).register_arrays(fixed, moving)
    warped, transform = ImageRegistration(ConfigNode(cfg), "cpu").register_arrays(fixed, moving)
    np.testing.assert_array_equal(warped, moving)
    np.testing.assert_allclose(transform["final_metric"], j_transform["final_metric"], rtol=1e-6)


# --------------------------------------------------------------------------
# resampling onto the fixed grid and the transform JSON across packages
# --------------------------------------------------------------------------

def test_resample_to_fixed_grid_on_exact_halves():
    """A 2:1 spacing ratio puts the moving coordinates on exact halves; the
    float64 map cast to float32 rounds them as JAX's does."""
    for interpolation in ("linear", "nearest"):
        rng = np.random.default_rng(10)
        moving = rng.integers(0, 6, (12, 12, 10)).astype(np.float32)
        m_aff = np.diag([3.0, 3.0, 4.0, 1.0])
        m_aff[:3, 3] = [-1.5, 0.0, 2.0]
        f_aff = np.diag([1.5, 1.5, 2.0, 1.0])
        want = JR.ImageRegistration.resample_to_fixed_grid(moving, m_aff, (22, 24, 18), f_aff,
                                                           interpolation)
        got = ImageRegistration.resample_to_fixed_grid(moving, m_aff, (22, 24, 18), f_aff,
                                                       interpolation, device="cpu")
        atol = 0 if interpolation == "nearest" else 1e-6
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol,
                                   err_msg=interpolation)


def _label_volumes(tmp_path):
    fixed, moving = _register_pair()
    aff = np.diag([1.5, 1.5, 2.0, 1.0])
    save_nifti(fixed, tmp_path / "fixed.nii.gz", affine=aff)
    save_nifti(moving, tmp_path / "moving.nii.gz", affine=aff)
    labels = np.zeros(moving.shape, np.float32)
    labels[4:12, 5:14, 6:15] = 3.0
    labels[12:17, 2:7, 2:9] = 7.0
    ref_aff = np.diag([1.2, 1.5, 2.5, 1.0])
    save_nifti(labels, tmp_path / "labels.nii.gz", affine=aff)
    save_nifti(np.zeros((24, 22, 20), np.float32), tmp_path / "ref.nii.gz", affine=ref_aff)


def test_transform_json_applies_in_the_other_package(tmp_path):
    """``register_pair`` of one package writes the JSON (JAX a rigid one, the
    port a deformable one); both packages' ``apply_transform`` give the same
    warp, linear and nearest (uint8), onto the moving grid and onto another
    reference grid."""
    _label_volumes(tmp_path)
    jreg, treg = JR.ImageRegistration(), ImageRegistration(device="cpu")
    for writer, method in (("jax", "rigid"), ("port", "deformable")):
        cfg = {"data": {"registration": {"method": method, "metric": "mean_squares",
                                         "iterations": 5, "mesh_size": 2, **ONE_LEVEL}}}
        tfm = tmp_path / f"{writer}.json"
        pair = (tmp_path / "fixed.nii.gz", tmp_path / "moving.nii.gz", tmp_path / "w.nii.gz",
                tfm)
        if writer == "jax":
            JR.ImageRegistration(JConfig(cfg)).register_pair(*pair)
        else:
            ImageRegistration(ConfigNode(cfg), "cpu").register_pair(*pair)
        keys = sorted(json.loads(tfm.read_text()))
        assert keys == ["final_metric", "method", "metric", "params"], writer
        for src, ref, interp, dtype in (("moving", None, "linear", None),
                                       ("labels", None, "nearest", np.uint8),
                                       ("labels", tmp_path / "ref.nii.gz", "nearest", np.uint8)):
            args = (tmp_path / f"{src}.nii.gz", tfm)
            kw = dict(reference_path=ref, interpolation=interp, dtype=dtype)
            jreg.apply_transform(*args, tmp_path / "j.nii.gz", **kw)
            treg.apply_transform(*args, tmp_path / "p.nii.gz", **kw)
            want, want_aff = load_nifti(tmp_path / "j.nii.gz", return_affine=True)
            got, got_aff = load_nifti(tmp_path / "p.nii.gz", return_affine=True)
            what = f"{writer} {method} {src} {interp} {ref}"
            np.testing.assert_array_equal(got_aff, want_aff, err_msg=what)
            if dtype is None:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=what)
            else:
                np.testing.assert_array_equal(got, want, err_msg=what)
                assert set(np.unique(got).tolist()) <= {0.0, 3.0, 7.0}, what
