"""The transform graph and the resize: the port against the JAX package.

Each random transform is a draw and an apply in the port. Its apply is
held to the JAX transform on the parameters JAX draws from the same key:
the test recomputes the JAX draw (the same ``split``/``uniform``/``randint``
calls the JAX function makes) and hands it to the port's apply. The draws
themselves differ by design; the tests of the port's own draws check
shapes, label values and that a key always gives the same output.

Tolerances: the resize applies the same interpolation matrices, as two
taps a row where JAX multiplies the dense matrix, so sums differ in the
last f32 bit: 1e-5. Normalisation is the same elementwise f32 arithmetic
over reductions summed in another order: 1e-6. Labels move by selection
only: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_organ_segmentation_tpu.data import dataloader as jdl
from multimodal_organ_segmentation_tpu.data import transforms as jtr
from multimodal_organ_segmentation_tpu.data.synthetic import generate_synthetic_dataset
from multimodal_organ_segmentation_tpu.ops import resize as jrs
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch.data import dataloader as tdl
from multimodal_organ_segmentation_tpu_torch.data import transforms as ttr
from multimodal_organ_segmentation_tpu_torch.ops import resize as trs
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from tests.torch_port_utils import _one_thread  # noqa: F401

RESIZE_TOL = 1e-5
NORM_TOL = 1e-6
SHAPE = (12, 12, 10)


def _sample(seed=0, shape=SHAPE, channels=2, classes=5):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(*shape, channels)).astype(np.float32)
    label = rng.integers(0, classes, size=shape).astype(np.int32)
    return image, label


def _jax(image, label):
    return {"image": jnp.asarray(image), "label": jnp.asarray(label)}


def _port(image, label):
    return {"image": torch.from_numpy(image.copy()), "label": torch.from_numpy(label.copy())}


def _assert_same(t_out, j_out, tol=RESIZE_TOL):
    np.testing.assert_allclose(t_out["image"].numpy(), np.asarray(j_out["image"]), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(t_out["label"].numpy(), np.asarray(j_out["label"]))
    assert t_out["label"].dtype == torch.int32


@pytest.mark.parametrize("in_shape,out_shape", [
    ((7, 9, 5), (12, 4, 5)), ((20, 13, 11), (8, 26, 3)), ((1, 6, 4), (3, 1, 9)),
    ((16, 16, 16), (16, 8, 33)),
])
def test_resize_matches_jax(in_shape, out_shape):
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(2, *in_shape)).astype(np.float32)
    lab = rng.integers(0, 8, size=in_shape).astype(np.int32)
    j_lin = np.asarray(jrs.resize_linear(jnp.asarray(vol), out_shape))
    t_lin = trs.resize_linear(torch.from_numpy(vol), out_shape).numpy()
    np.testing.assert_allclose(t_lin, j_lin, rtol=RESIZE_TOL, atol=RESIZE_TOL)
    j_nn = np.asarray(jrs.resize_nearest(jnp.asarray(lab), out_shape))
    t_nn = trs.resize_volume(torch.from_numpy(lab), out_shape, order=0)
    assert t_nn.dtype == torch.int32
    np.testing.assert_array_equal(t_nn.numpy(), j_nn)
    for a, b in ((trs._linear_matrix, jrs._linear_matrix), (trs._nearest_matrix, jrs._nearest_matrix)):
        for n_in, n_out in zip(in_shape, out_shape):
            np.testing.assert_array_equal(a(n_in, n_out), b(n_in, n_out))


def test_upsample2x_matches_jax():
    x = np.random.default_rng(2).normal(size=(1, 3, 4, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(trs.upsample2x_linear(torch.from_numpy(x)).numpy(),
                               np.asarray(jrs.upsample2x_linear(jnp.asarray(x))),
                               rtol=RESIZE_TOL, atol=RESIZE_TOL)


@pytest.mark.parametrize("modalities", [["CT", "PET"], ["MRI", "US"], ["PET", "CT", "MRI"]])
def test_modality_normalize_matches_jax(modalities):
    rng = np.random.default_rng(3)
    image = (rng.normal(size=(*SHAPE, len(modalities))) * 300).astype(np.float32)
    image[..., modalities.index(modalities[-1])] += 50
    cfg = {"data": {"modalities": modalities, "preprocessing": {
        "ct": {"window_center": -100, "window_width": 700}, "pet": {"normalize": True},
        "mri": {"normalize": True}, "us": {"normalize": True}}}}
    ref = np.asarray(jtr.normalize_from_config(jnp.asarray(image), JConfig(cfg)))
    out = ttr.normalize_from_config(torch.from_numpy(image), ConfigNode(cfg)).numpy()
    np.testing.assert_allclose(out, ref, rtol=NORM_TOL, atol=NORM_TOL)


def test_pet_all_zero_channel_is_kept():
    image = np.zeros((*SHAPE, 1), np.float32)
    out = ttr.modality_normalize(torch.from_numpy(image), ["PET"], {})
    assert torch.equal(out, torch.zeros_like(out))


def test_deterministic_helpers_match_jax():
    image, label = _sample(4)
    img = image * 10 + 3
    for per_channel in (True, False):
        np.testing.assert_allclose(
            ttr.normalize(torch.from_numpy(img), per_channel=per_channel).numpy(),
            np.asarray(jtr.normalize(jnp.asarray(img), per_channel=per_channel)),
            rtol=NORM_TOL, atol=NORM_TOL)
        np.testing.assert_allclose(
            ttr.scale_intensity(torch.from_numpy(img), per_channel=per_channel).numpy(),
            np.asarray(jtr.scale_intensity(jnp.asarray(img), per_channel=per_channel)),
            rtol=NORM_TOL, atol=NORM_TOL)
    for kw in ({"min_val": -1.0, "max_val": 5.0}, {"percentile": (5.0, 95.0)}):
        np.testing.assert_allclose(ttr.clip_intensity(torch.from_numpy(img), **kw).numpy(),
                                   np.asarray(jtr.clip_intensity(jnp.asarray(img), **kw)),
                                   rtol=1e-5, atol=1e-5)
    _assert_same(ttr.center_crop(_port(image, label), (8, 7, 10)),
                 jtr.center_crop(_jax(image, label), (8, 7, 10)), 0)
    _assert_same(ttr.pad_to_min_size(_port(image, label), (15, 12, 13)),
                 jtr.pad_to_min_size(_jax(image, label), (15, 12, 13)), 0)
    _assert_same(ttr.label_centered_crop(_port(image, label), (8, 8, 6)),
                 jtr.label_centered_crop(_jax(image, label), (8, 8, 6)), 0)
    empty = np.zeros_like(label)
    _assert_same(ttr.label_centered_crop(_port(image, empty), (8, 8, 6)),
                 jtr.label_centered_crop(_jax(image, empty), (8, 8, 6)), 0)


# -- each random transform's apply on the parameters JAX draws -------------------

KEYS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", KEYS)
def test_flip_apply_matches_jax(seed):
    image, label = _sample(seed)
    key = jax.random.key(seed)
    coins = np.asarray(jax.random.uniform(key, (3,)) < 0.5).tolist()
    _assert_same(ttr.apply_flip(_port(image, label), coins),
                 jtr.random_flip(_jax(image, label), key, prob=0.5), 0)


@pytest.mark.parametrize("seed", KEYS)
def test_rotate90_apply_matches_jax(seed):
    image, label = _sample(seed)
    key = jax.random.key(seed)
    k_key, p_key = jax.random.split(key)
    apply = bool(jax.random.uniform(p_key) < 0.7)
    k = int(jax.random.randint(k_key, (), 1, 4))
    _assert_same(ttr.apply_rotate90(_port(image, label), apply, k),
                 jtr.random_rotate90(_jax(image, label), key, prob=0.7), 0)


def test_rotate90_needs_a_square_plane():
    image, label = _sample(0, shape=(12, 10, 10))
    with pytest.raises(ValueError, match="H == W"):
        ttr.apply_rotate90(_port(image, label), True, 1)


@pytest.mark.parametrize("seed", KEYS)
def test_intensity_shift_apply_matches_jax(seed):
    image, label = _sample(seed)
    key = jax.random.key(seed)
    p_key, sh_key, sc_key = jax.random.split(key, 3)
    apply = bool(jax.random.uniform(p_key) < 0.8)
    shift = np.asarray(jax.random.uniform(sh_key, (2,), minval=-0.1, maxval=0.1)).tolist()
    scale = np.asarray(jax.random.uniform(sc_key, (2,), minval=0.9, maxval=1.1)).tolist()
    _assert_same(ttr.apply_intensity_shift(_port(image, label), apply, shift, scale),
                 jtr.random_intensity_shift(_jax(image, label), key, prob=0.8))


@pytest.mark.parametrize("seed", KEYS)
def test_gaussian_noise_apply_matches_jax(seed):
    image, label = _sample(seed)
    key = jax.random.key(seed)
    p_key, n_key = jax.random.split(key)
    noise = None
    if bool(jax.random.uniform(p_key) < 0.5):
        noise = torch.from_numpy(np.array(0.0 + 0.05 * jax.random.normal(n_key, image.shape)))
    _assert_same(ttr.apply_gaussian_noise(_port(image, label), noise),
                 jtr.random_gaussian_noise(_jax(image, label), key, std=0.05, prob=0.5))


@pytest.mark.parametrize("seed", KEYS)
def test_zoom_apply_matches_jax(seed):
    image, label = _sample(seed)
    key = jax.random.key(seed)
    p_key, s_key = jax.random.split(key)
    apply = bool(jax.random.uniform(p_key) < 0.8)
    s = float(jax.random.uniform(s_key, (), minval=0.8, maxval=1.25))
    _assert_same(ttr.apply_zoom(_port(image, label), apply, s),
                 jtr.random_zoom(_jax(image, label), key, scale_range=(0.8, 1.25), prob=0.8))


def test_nearest_rounds_exact_halves_away_from_zero():
    """Zoom by 2 about the center of a 9³ grid puts every odd coordinate at
    an exact .5: JAX rounds those away from zero (2.5 → 3, 4.5 → 5), where
    ``torch.round`` would round half to even (2.5 → 2)."""
    n = 9
    label = np.arange(n**3, dtype=np.int32).reshape(n, n, n)
    image = np.random.default_rng(5).normal(size=(n, n, n, 1)).astype(np.float32)
    key = jax.random.key(0)
    t = ttr.apply_zoom(_port(image, label), True, 2.0)
    j = jtr.random_zoom(_jax(image, label), key, scale_range=(2.0, 2.0), prob=1.0)
    _assert_same(t, j)
    coords = 4 + (np.arange(n) - 4) / 2.0
    assert (coords % 1 == 0.5).sum() == 4
    rows = np.floor(coords + 0.5).astype(int)  # half away from zero (coords > 0)
    np.testing.assert_array_equal(t["label"].numpy()[:, 4, 4], label[rows, 4, 4])
    assert t["label"].numpy()[1, 4, 4] != label[int(np.round(coords[1])), 4, 4]
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997])
    assert ttr._round_half_away(x).tolist() == [-3.0, -2.0, -1.0, 1.0, 2.0, 3.0, 0.0]


@pytest.mark.parametrize("seed", KEYS)
def test_elastic_apply_matches_jax(seed):
    image, label = _sample(seed)
    key = jax.random.key(seed)
    p_key, d_key = jax.random.split(key)
    ctrl = None
    if bool(jax.random.uniform(p_key) < 0.8):
        ctrl = torch.from_numpy(np.array(
            2.0 * jax.random.normal(d_key, (4, 4, 4, 3), dtype=jnp.float32)))
    _assert_same(ttr.apply_elastic(_port(image, label), ctrl),
                 jtr.random_elastic_deform(_jax(image, label), key, prob=0.8))


@pytest.mark.parametrize("seed", KEYS)
def test_random_crop_apply_matches_jax(seed):
    image, label = _sample(seed)
    key = jax.random.key(seed)
    size = (8, 5, 10)
    starts = [int(jax.random.randint(k, (), 0, SHAPE[i] - size[i] + 1))
              for i, k in enumerate(jax.random.split(key, 3))]
    _assert_same(ttr.apply_crop(_port(image, label), starts, size),
                 jtr.random_crop(_jax(image, label), key, size), 0)


def _jax_balanced_draw(key, label, size, pos_ratio, class_balanced, num_classes):
    """The draws ``balanced_random_crop`` makes from ``key``, recomputed."""
    k_pick, k_coin, k_uni, k_cls = jax.random.split(key, 4)
    cls = None
    lbl = jnp.asarray(label)
    if class_balanced and num_classes > 1:
        counts = jnp.bincount(lbl.reshape(-1), length=num_classes)
        logits = jnp.where(counts[1:] > 0, 0.0, -jnp.inf)
        cls = int(1 + jax.random.categorical(k_cls, logits))
        total = int((lbl == cls).sum())
    else:
        total = int((lbl > 0).sum())
    nth = int(jax.random.randint(k_pick, (), 0, max(total, 1))) + 1
    uni = [int(jax.random.randint(k, (), 0, label.shape[i] - size[i] + 1))
           for i, k in enumerate(jax.random.split(k_uni, 3))]
    use_fg = bool(jax.random.uniform(k_coin) < pos_ratio) and total > 0
    return dict(use_fg=use_fg, nth=nth, cls=cls, uni_start=uni)


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("class_balanced", [False, True])
def test_balanced_crop_apply_matches_jax(seed, class_balanced):
    image, _ = _sample(seed)
    rng = np.random.default_rng(seed + 10)
    label = np.zeros(SHAPE, np.int32)
    label[rng.integers(0, 12, 30), rng.integers(0, 12, 30), rng.integers(0, 10, 30)] = \
        rng.integers(1, 4, 30)
    if seed == 3:
        label[:] = 0  # all background: falls back to the uniform start
    key = jax.random.key(seed)
    size = (6, 6, 5)
    draw = _jax_balanced_draw(key, label, size, 0.6, class_balanced, 5)
    _assert_same(ttr.apply_balanced_crop(_port(image, label), size, **draw),
                 jtr.balanced_random_crop(_jax(image, label), key, size, 0.6,
                                          class_balanced=class_balanced, num_classes=5), 0)


def test_port_draws_are_keyed_and_shaped():
    image, label = _sample(7)
    x = _port(image, label)
    a = ttr.balanced_random_crop(x, 11, (6, 6, 5), 1.0, class_balanced=True, num_classes=5)
    b = ttr.balanced_random_crop(x, 11, (6, 6, 5), 1.0, class_balanced=True, num_classes=5)
    assert a["image"].shape == (6, 6, 5, 2) and torch.equal(a["label"], b["label"])
    assert (a["label"] > 0).any()
    assert ttr.draw_flip(5) == ttr.draw_flip(5)
    assert ttr.split(5, 3) == ttr.split(5, 3) and len(set(ttr.split(5, 3))) == 3
    assert ttr.fold_in(5, 1) not in ttr.split(5, 4)
    ctrl = ttr.draw_elastic(3, prob=1.0)
    assert ctrl.shape == (4, 4, 4, 3) and ttr.draw_elastic(3, prob=0.0) is None
    noise = ttr.draw_gaussian_noise(2, x["image"], std=0.05, prob=1.0)
    assert noise.shape == x["image"].shape and torch.equal(
        noise, ttr.draw_gaussian_noise(2, x["image"], std=0.05, prob=1.0))


# -- the pipeline ---------------------------------------------------------------

def _pipe_config(patch=False, aug=False, **extra):
    cfg = {
        "experiment": {"seed": 5},
        "data": {"modalities": ["CT", "PET"],
                 "preprocessing": {"ct": {"window_center": 40, "window_width": 400}},
                 "augmentation": {"enabled": aug, "random_flip": True, "random_rotate": 15,
                                  "random_intensity": 0.1, "random_scale": [0.9, 1.1],
                                  "elastic": {"enabled": True, "prob": 0.5}}},
        "model": {"out_channels": 5, "backbone": {"img_size": [10, 10, 8]}},
    }
    if patch:
        cfg["data"]["patch_based"] = {"enabled": True, "size": [8, 8, 6], "pos_ratio": 0.7}
    cfg.update(extra)
    return cfg


@pytest.mark.parametrize("mode,patch", [("val", False), ("test", False), ("native", False),
                                        ("val", True)])
def test_get_transforms_matches_jax(mode, patch):
    image, label = _sample(8, shape=(13, 11, 9))
    image[..., 0] = image[..., 0] * 200
    meta = {"patient_id": "p0", "affine": np.eye(4)}
    cfg = _pipe_config(patch=patch)
    j = jtr.get_transforms(JConfig(cfg), mode=mode)
    t = ttr.get_transforms(ConfigNode(cfg), mode=mode, device="cpu")
    j_out = j({**_jax(image, label), **meta}, key=j.key_for(1, 0))
    t_out = t({"image": image, "label": label, **meta}, key=t.key_for(1, 0))
    assert t_out["patient_id"] == "p0" and t_out["affine"] is meta["affine"]
    _assert_same(t_out, j_out)


def test_train_pipeline_is_keyed_keeps_labels_and_shapes():
    image, label = _sample(9, shape=(13, 13, 9))
    cfg = ConfigNode(_pipe_config(aug=True))
    t = ttr.get_transforms(cfg, mode="train", device="cpu")
    outs = [t({"image": image, "label": label}, key=t.key_for(e, i))
            for e, i in ((1, 0), (1, 0), (1, 1), (2, 0))]
    for o in outs:
        assert o["image"].shape == (10, 10, 8, 2) and o["image"].dtype == torch.float32
        assert o["label"].shape == (10, 10, 8) and o["label"].dtype == torch.int32
        assert set(np.unique(o["label"].numpy())) <= set(np.unique(label))
        assert torch.isfinite(o["image"]).all()
    assert torch.equal(outs[0]["image"], outs[1]["image"])
    assert not torch.equal(outs[0]["image"], outs[2]["image"])
    assert not torch.equal(outs[0]["image"], outs[3]["image"])
    patch = ttr.get_transforms(ConfigNode(_pipe_config(patch=True, aug=True)), "train", "cpu")
    p = patch({"image": image, "label": label}, key=3)
    assert p["image"].shape == (8, 8, 6, 2)


@pytest.mark.parametrize("layout", ["C", "F", "stacked", "sliced"])
def test_pipeline_moves_any_host_layout_to_a_contiguous_copy(layout):
    """NIfTI arrays arrive Fortran-ordered, and channels stacked from them in
    neither order; the pipeline moves them as they lie and transposes on the
    device: the same values, C-contiguous."""
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((6, 5, 4, 2)).astype(np.float32)
    if layout == "F":
        vol = np.asfortranarray(vol)
    elif layout == "stacked":
        vol = np.stack([np.asfortranarray(vol[..., c]) for c in range(2)], axis=-1)
    elif layout == "sliced":
        vol = np.asfortranarray(vol)[:, ::-1, 1:]
    pipe = ttr.TransformPipeline(lambda arrays, key: arrays, device="cpu")
    out = pipe._to_device(vol)
    assert out.is_contiguous() and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), vol)


def test_get_transforms_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.get_transforms(ConfigNode(_pipe_config()), mode="val")


def test_get_dataloader_first_batch_matches_jax(tmp_path):
    """The repaired loader: without a ``transform`` it builds the split's
    transform graph, as the JAX loader does, so both hand over the same
    normalised, resized batch."""
    generate_synthetic_dataset(tmp_path, n_train=0, n_val=3, n_test=0, shape=(14, 12, 10),
                               num_classes=5, seed=2)
    cfg = _pipe_config()
    cfg["data"]["data_root"] = str(tmp_path)
    cfg["training"] = {"batch_size": 2}
    cfg["hardware"] = {"num_workers": 2, "prefetch_depth": 2}
    j_batch = next(iter(jdl.get_dataloader(JConfig(cfg), "val")))
    t_batch = next(iter(tdl.get_dataloader(ConfigNode(cfg), "val", device="cpu")))
    assert t_batch["patient_id"] == j_batch["patient_id"] == ["val_000", "val_001"]
    assert isinstance(t_batch["image"], torch.Tensor) and t_batch["image"].shape == (2, 10, 10, 8, 2)
    _assert_same(t_batch, j_batch)
    np.testing.assert_array_equal(t_batch["affine"], j_batch["affine"])


def test_collate_stacks_tensors_and_pads_ragged_ones():
    a = {"image": torch.ones(2, 3), "id": "a"}
    b = {"image": torch.ones(3, 2), "id": "b"}
    out = tdl.collate_fn([a, b])
    assert out["image"].shape == (2, 3, 3) and out["id"] == ["a", "b"]
    assert out["image"][0, 2].eq(0).all() and out["image"][1, :, 2].eq(0).all()
    same = tdl.collate_fn([a, dict(a)])
    assert torch.equal(same["image"], torch.ones(2, 2, 3))
