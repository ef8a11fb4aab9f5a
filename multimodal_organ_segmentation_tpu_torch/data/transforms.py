"""Transform graph: modality normalisation, augmentation, resize (port of the
JAX package's ``data/transforms.py``).

- ``modality_normalize``: CT window (center/width → clip → [0,1]); PET
  divide-by-max; MRI/US z-score.
- train augmentations: flip (p=.5 per axis), rot90 in the HW plane (p=.5,
  k∈1..3), per-channel intensity shift/scale (p=.3), Gaussian noise (std
  .05, p=.2); after the resize, zoom (``random_scale``) and elastic warps.
- always a resize to the backbone's ``img_size`` (whole volume, scipy
  order-1 image / order-0 label semantics via ``ops/resize.py``), except in
  ``native`` mode and for patch-based training.

Layout is channels-last: image ``[H, W, D, C]``, label ``[H, W, D]``.

Randomness is explicit. A key is an int; ``fold_in`` and ``split`` derive
keys from it by splitmix64 (``utils/prng.py``), at the positions where the
JAX code folds and splits its PRNG keys. Every random transform is a
**draw** of host scalars from a CPU ``torch.Generator`` seeded with its key
(coins, k, shift and scale, zoom factor, the elastic control grid, crop
starts; the noise field is drawn on the sample's device from a generator
seeded with the key) and an **apply** that takes those parameters and
branches in Python, so a transform that does not fire costs nothing. The
draws differ from JAX's by design; the key positions do not.

``TransformPipeline`` runs on an explicit ``device``: the card for the
trainer and the CLI (the JAX package ran the graph on the TPU under
``jax.jit``), the CPU for tests. Loader threads share the card's current
stream with the train step, so the graph's kernels queue between the
step's; host copies go through pinned memory and do not block the thread.
"""

from __future__ import annotations

import inspect
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear, resize_nearest
from multimodal_organ_segmentation_tpu_torch.utils.prng import _mix

Sample = Dict[str, Any]

_SPLIT = 1 << 32  # split() counters start here, fold_in() data stays below


def fold_in(key: int, data: int) -> int:
    """The key derived from ``key`` and ``data`` (``jax.random.fold_in``)."""
    return _mix(int(key), int(data) & 0xFFFFFFFF)


def split(key: int, n: int) -> List[int]:
    """``n`` keys derived from ``key`` (``jax.random.split``), disjoint from
    every ``fold_in(key, ·)``."""
    return [_mix(int(key), _SPLIT + i) for i in range(n)]


def _gen(key: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(key))


def _uniform(key: int, n: int = 1, lo: float = 0.0, hi: float = 1.0) -> List[float]:
    u = torch.rand(n, generator=_gen(key), dtype=torch.float64)
    return (lo + (hi - lo) * u).tolist()


def _randint(key: int, lo: int, hi: int) -> int:
    """A uniform int in ``[lo, hi)``."""
    return int(torch.randint(int(lo), int(hi), (1,), generator=_gen(key)))


# ---------------------------------------------------------------------------
# deterministic transforms
# ---------------------------------------------------------------------------

def modality_normalize(
    image: torch.Tensor, modalities: Sequence[str], preprocess_cfg: Dict[str, Any]
) -> torch.Tensor:
    """Per-channel modality-specific normalisation."""
    channels = []
    for c, modality in enumerate(modalities):
        mod_cfg = dict(preprocess_cfg.get(modality.lower(), {}) or {})
        ch = image[..., c]
        if modality == "CT":
            center = float(mod_cfg.get("window_center", 0))
            width = float(mod_cfg.get("window_width", 400))
            lo, hi = center - width / 2, center + width / 2
            ch = (ch.clamp(lo, hi) - lo) / (hi - lo)
        elif modality == "PET":
            if mod_cfg.get("normalize", True):
                mx = ch.max()
                ch = torch.where(mx > 0, ch / mx, ch)
        elif modality in ("MRI", "US"):
            if mod_cfg.get("normalize", True):
                mean = ch.mean()
                std = ch.std(correction=0) + 1e-8
                ch = (ch - mean) / std
        channels.append(ch)
    return torch.stack(channels, dim=-1)


def normalize_from_config(image: torch.Tensor, config) -> torch.Tensor:
    """``modality_normalize`` driven by a full config (the ``data.modalities``
    / ``data.preprocessing`` sections): the inference-time gate of the batch
    CLI."""
    modalities = list(config.get("data.modalities", ["CT", "PET"]))
    pc = config.get("data.preprocessing", {}) or {}
    pc = pc.to_dict() if hasattr(pc, "to_dict") else dict(pc)
    return modality_normalize(image, modalities, pc)


def resize_sample(sample: Sample, size: Tuple[int, int, int]) -> Sample:
    """Resize image (linear) and label (nearest) to ``size``."""
    out = dict(sample)
    out["image"] = resize_linear(sample["image"], size, spatial_axes=(0, 1, 2))
    if "label" in sample:
        out["label"] = resize_nearest(sample["label"], size, spatial_axes=(0, 1, 2))
    return out


def apply_crop(sample: Sample, start: Sequence[int], size) -> Sample:
    """The ``size`` patch of image and label at ``start``."""
    s0, s1, s2 = (int(s) for s in start)
    out = dict(sample)
    out["image"] = sample["image"][s0:s0 + size[0], s1:s1 + size[1], s2:s2 + size[2]]
    if "label" in sample:
        out["label"] = sample["label"][s0:s0 + size[0], s1:s1 + size[1], s2:s2 + size[2]]
    return out


def center_crop(sample: Sample, size: Tuple[int, int, int]) -> Sample:
    """Static center crop."""
    img = sample["image"]
    starts = [max(0, (img.shape[i] - size[i]) // 2) for i in range(3)]
    return apply_crop(sample, starts, size)


def normalize(
    image: torch.Tensor,
    mean: Optional[float] = None,
    std: Optional[float] = None,
    per_channel: bool = True,
) -> torch.Tensor:
    """Z-score normalisation."""
    if per_channel:
        axes = tuple(range(image.dim() - 1))
        m = image.mean(dim=axes) if mean is None else torch.as_tensor(mean, device=image.device)
        s = (image.std(dim=axes, correction=0) + 1e-8) if std is None else torch.as_tensor(
            std, device=image.device)
        return (image - m) / s
    m = image.mean() if mean is None else mean
    s = (image.std(correction=0) + 1e-8) if std is None else std
    return (image - m) / s


def clip_intensity(
    image: torch.Tensor,
    min_val: Optional[float] = None,
    max_val: Optional[float] = None,
    percentile: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """Clip intensities, optionally by percentiles (linear interpolation
    between order statistics, as ``numpy.percentile``)."""
    if percentile is not None:
        q = torch.tensor([percentile[0] / 100.0, percentile[1] / 100.0],
                         dtype=torch.float64, device=image.device)
        lo, hi = torch.quantile(image.reshape(-1).double(), q).to(image.dtype)
    else:
        lo = image.min() if min_val is None else torch.as_tensor(min_val, device=image.device)
        hi = image.max() if max_val is None else torch.as_tensor(max_val, device=image.device)
    return torch.minimum(torch.maximum(image, lo), hi)


def scale_intensity(image: torch.Tensor, per_channel: bool = True) -> torch.Tensor:
    """Min-max scale to [0, 1]."""
    if per_channel:
        axes = tuple(range(image.dim() - 1))
        lo = image.amin(dim=axes)
        hi = image.amax(dim=axes)
    else:
        lo, hi = image.min(), image.max()
    rng = hi - lo
    return torch.where(rng > 1e-8, (image - lo) / rng.clamp_min(1e-8), image)


# ---------------------------------------------------------------------------
# resampling (jax.scipy.ndimage.map_coordinates, mode="nearest", order 0/1)
# ---------------------------------------------------------------------------

def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, as ``lax.round`` (``torch.round`` rounds
    half to even). The fraction ``x - trunc(x)`` is exact, so this stays
    right just below a half, where ``floor(|x| + 0.5)`` rounds the sum up
    (0.49999997 + 0.5 is 1.0 in f32)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


def map_coordinates(vol: torch.Tensor, coords: torch.Tensor, order: int) -> torch.Tensor:
    """Sample ``vol [H, W, D]`` at ``coords [3, ...]`` with edge clamping
    (``mode="nearest"``). Order 0 takes the nearest voxel (coordinates
    rounded half away from zero); order 1 sums the 8 clamped linear taps in
    the JAX function's order."""
    shape = vol.shape
    if order == 0:
        idx = [_round_half_away(c).to(torch.int64).clamp(0, n - 1) for c, n in zip(coords, shape)]
        return vol[idx[0], idx[1], idx[2]]
    taps = []
    for c, n in zip(coords, shape):
        lower = torch.floor(c)
        w_hi = c - lower
        index = lower.to(torch.int64)
        taps.append([(index.clamp(0, n - 1), 1 - w_hi), ((index + 1).clamp(0, n - 1), w_hi)])
    out = None
    for (i0, w0), (i1, w1), (i2, w2) in itertools.product(*taps):
        term = (w0 * w1 * w2) * vol[i0, i1, i2]
        out = term if out is None else out + term
    return out.to(vol.dtype)


def _warp_sample(sample: Sample, coords: torch.Tensor) -> Sample:
    """Image trilinear, label nearest, at ``coords [3, H, W, D]``."""
    image, label = sample["image"], sample.get("label")
    out = dict(sample)
    out["image"] = torch.stack(
        [map_coordinates(image[..., c], coords, 1) for c in range(image.shape[-1])], dim=-1
    ).to(image.dtype)
    if label is not None:
        out["label"] = map_coordinates(label, coords, 0).to(label.dtype)
    return out


def _grid(full, device) -> torch.Tensor:
    """Voxel coordinates ``[3, H, W, D]`` (f32)."""
    return torch.stack(torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=device) for n in full), indexing="ij"))


# ---------------------------------------------------------------------------
# random transforms: draw (host scalars) + apply
# ---------------------------------------------------------------------------

def draw_flip(key: int, prob: float = 0.5) -> List[bool]:
    return [u < prob for u in _uniform(key, 3)]


def apply_flip(sample: Sample, coins: Sequence[bool]) -> Sample:
    """Flip each spatial axis whose coin is set."""
    axes = [a for a in range(3) if coins[a]]
    if not axes:
        return sample
    out = dict(sample)
    out["image"] = torch.flip(sample["image"], dims=axes)
    if sample.get("label") is not None:
        out["label"] = torch.flip(sample["label"], dims=axes)
    return out


def random_flip(sample: Sample, key: int, prob: float = 0.5) -> Sample:
    """Independent flip of each spatial axis with probability ``prob``."""
    return apply_flip(sample, draw_flip(key, prob))


def draw_rotate90(key: int, prob: float = 0.5) -> Tuple[bool, int]:
    k_key, p_key = split(key, 2)
    return _uniform(p_key)[0] < prob, _randint(k_key, 1, 4)


def apply_rotate90(sample: Sample, apply: bool, k: int) -> Sample:
    """Rotate by ``k`` quarter turns in the HW plane (the way ``jnp.rot90``
    turns with ``axes=(0, 1)``). Requires H == W, as the JAX transform does
    for its static shapes."""
    image = sample["image"]
    if image.shape[0] != image.shape[1]:
        raise ValueError(f"random_rotate90 needs H == W, got {tuple(image.shape[:3])}")
    if not apply:
        return sample
    out = dict(sample)
    out["image"] = torch.rot90(image, int(k), dims=(0, 1))
    if sample.get("label") is not None:
        out["label"] = torch.rot90(sample["label"], int(k), dims=(0, 1))
    return out


def random_rotate90(sample: Sample, key: int, prob: float = 0.5) -> Sample:
    """Random 90° rotation in the HW plane, k ∈ {1,2,3}."""
    return apply_rotate90(sample, *draw_rotate90(key, prob))


def draw_intensity_shift(
    key: int, channels: int,
    shift_range: Tuple[float, float] = (-0.1, 0.1),
    scale_range: Tuple[float, float] = (0.9, 1.1),
    prob: float = 0.5,
) -> Tuple[bool, List[float], List[float]]:
    p_key, sh_key, sc_key = split(key, 3)
    return (_uniform(p_key)[0] < prob, _uniform(sh_key, channels, *shift_range),
            _uniform(sc_key, channels, *scale_range))


def apply_intensity_shift(sample: Sample, apply: bool, shift: Sequence[float],
                          scale: Sequence[float]) -> Sample:
    """Per-channel ``image * scale + shift`` (host scalars: no copy to the
    device)."""
    if not apply:
        return sample
    image = sample["image"]
    out = dict(sample)
    out["image"] = torch.stack([image[..., c] * float(scale[c]) + float(shift[c])
                                for c in range(image.shape[-1])], dim=-1)
    return out


def random_intensity_shift(
    sample: Sample, key: int,
    shift_range: Tuple[float, float] = (-0.1, 0.1),
    scale_range: Tuple[float, float] = (0.9, 1.1),
    prob: float = 0.5,
) -> Sample:
    """Per-channel multiplicative scale + additive shift."""
    c = sample["image"].shape[-1]
    return apply_intensity_shift(
        sample, *draw_intensity_shift(key, c, shift_range, scale_range, prob))


def draw_gaussian_noise(
    key: int, image: torch.Tensor, mean: float = 0.0, std: float = 0.1, prob: float = 0.5,
) -> Optional[torch.Tensor]:
    """The noise field to add, drawn on the image's device, or None when the
    coin says no noise."""
    p_key, n_key = split(key, 2)
    if not _uniform(p_key)[0] < prob:
        return None
    g = torch.Generator(device=image.device).manual_seed(n_key)
    noise = torch.randn(image.shape, generator=g, device=image.device, dtype=image.dtype)
    return mean + std * noise


def apply_gaussian_noise(sample: Sample, noise: Optional[torch.Tensor]) -> Sample:
    if noise is None:
        return sample
    out = dict(sample)
    out["image"] = sample["image"] + noise
    return out


def random_gaussian_noise(
    sample: Sample, key: int, mean: float = 0.0, std: float = 0.1, prob: float = 0.5,
) -> Sample:
    return apply_gaussian_noise(sample, draw_gaussian_noise(key, sample["image"], mean, std, prob))


def draw_zoom(key: int, scale_range: Tuple[float, float] = (0.9, 1.1),
              prob: float = 0.3) -> Tuple[bool, float]:
    p_key, s_key = split(key, 2)
    return _uniform(p_key)[0] < prob, _uniform(s_key, 1, *scale_range)[0]


def apply_zoom(sample: Sample, apply: bool, scale: float) -> Sample:
    """Isotropic zoom by ``scale`` about the volume center, shape kept:
    sampling coordinates ``center + (x − center)/scale`` (s>1 magnifies,
    edges clamp to the border); image trilinear, label nearest."""
    if not apply:
        return sample
    image = sample["image"]
    full = tuple(image.shape[:3])
    center = torch.tensor([(n - 1) / 2.0 for n in full], dtype=torch.float32,
                          device=image.device)[:, None, None, None]
    s = torch.tensor(scale, dtype=torch.float32, device=image.device)
    return _warp_sample(sample, center + (_grid(full, image.device) - center) / s)


def random_zoom(sample: Sample, key: int, scale_range: Tuple[float, float] = (0.9, 1.1),
                prob: float = 0.3) -> Sample:
    """Random isotropic zoom about the volume center (shape-preserving)."""
    return apply_zoom(sample, *draw_zoom(key, scale_range, prob))


def draw_elastic(key: int, grid: int = 4, alpha: float = 2.0,
                 prob: float = 0.3) -> Optional[torch.Tensor]:
    """The coarse ``[grid, grid, grid, 3]`` control displacement (voxels,
    ~N(0, alpha)) on the host, or None when the coin says no warp."""
    p_key, d_key = split(key, 2)
    if not _uniform(p_key)[0] < prob:
        return None
    return alpha * torch.randn((grid, grid, grid, 3), generator=_gen(d_key), dtype=torch.float32)


def apply_elastic(sample: Sample, ctrl: Optional[torch.Tensor]) -> Sample:
    """Warp by the control displacement ``ctrl`` trilinearly upsampled to a
    full-resolution displacement field (smooth by construction)."""
    if ctrl is None:
        return sample
    image = sample["image"]
    full = tuple(image.shape[:3])
    ctrl = torch.as_tensor(ctrl, dtype=torch.float32).to(image.device)
    disp = resize_linear(ctrl[None], full, (1, 2, 3))[0]  # [H, W, D, 3]
    coords = _grid(full, image.device) + disp.permute(3, 0, 1, 2)
    return _warp_sample(sample, coords)


def random_elastic_deform(sample: Sample, key: int, grid: int = 4, alpha: float = 2.0,
                          prob: float = 0.3) -> Sample:
    """Smooth random spatial warp (elastic augmentation)."""
    return apply_elastic(sample, draw_elastic(key, grid, alpha, prob))


def draw_crop(key: int, shape, size) -> List[int]:
    maxs = [max(0, shape[i] - size[i]) for i in range(3)]
    return [_randint(k, 0, maxs[i] + 1) for i, k in enumerate(split(key, 3))]


def random_crop(sample: Sample, key: int, size: Tuple[int, int, int]) -> Sample:
    """Random spatial crop to ``size``."""
    return apply_crop(sample, draw_crop(key, sample["image"].shape, size), size)


# ---------------------------------------------------------------------------
# patch-based training (native-resolution patches)
# ---------------------------------------------------------------------------

def pad_to_min_size(sample: Sample, size: Tuple[int, int, int]) -> Sample:
    """Zero-pad (centered) so every spatial dim is ≥ ``size``. Image pads
    with 0, label with background class 0."""
    img = sample["image"]
    pads = [max(0, size[i] - img.shape[i]) for i in range(3)]
    if not any(pads):
        return sample
    spatial = []
    for p in reversed(pads):
        spatial += [p // 2, p - p // 2]
    out = dict(sample)
    out["image"] = F.pad(img, [0, 0] + spatial)
    if "label" in sample:
        out["label"] = F.pad(sample["label"], spatial)
    return out


def _unravel3(flat: int, shape) -> List[int]:
    _, w, d = shape
    return [flat // (w * d), (flat // d) % w, flat % d]


def _clip_start(center: Sequence[int], shape, size) -> List[int]:
    return [min(max(int(center[i]) - size[i] // 2, 0), shape[i] - size[i]) for i in range(3)]


def fg_crop_start(label: torch.Tensor, size, nth: int, cls: Optional[int] = None) -> List[int]:
    """The crop start centered on the ``nth`` (1-based) foreground voxel in
    flat order: the voxels of class ``cls``, or every voxel > 0. The k-th
    set voxel is found with an int64 ``cumsum`` and ``searchsorted`` on the
    label's device."""
    flat = label.reshape(-1)
    fg = (flat == cls) if cls is not None else (flat > 0)
    cum = torch.cumsum(fg.to(torch.int64), dim=0)
    pos = int(torch.searchsorted(cum, torch.tensor([int(nth)], device=cum.device)))
    return _clip_start(_unravel3(pos, tuple(label.shape)), tuple(label.shape), size)


def draw_balanced_crop(key: int, label: torch.Tensor, size, pos_ratio: float = 0.5,
                       class_balanced: bool = False, num_classes: int = 0) -> Dict[str, Any]:
    """The draws of ``balanced_random_crop``: ``use_fg`` (the coin, and a
    volume with foreground), ``nth`` (which foreground voxel), ``cls`` (the
    class drawn among those present, or None) and ``uni_start``. Reads the
    label's class counts from the device."""
    shape = tuple(label.shape)
    k_pick, k_coin, k_uni, k_cls = split(key, 4)
    cls = None
    if class_balanced and num_classes > 1:
        counts = torch.bincount(label.reshape(-1).to(torch.int64), minlength=num_classes)
        present = [c for c in range(1, num_classes) if int(counts[c]) > 0]
        # no class present: class 1, whose empty mask falls back to uniform
        cls = present[_randint(k_cls, 0, len(present))] if present else 1
        total = int(counts[cls]) if cls < counts.numel() else 0
    else:
        total = int((label > 0).sum())
    nth = _randint(k_pick, 0, max(total, 1)) + 1
    uni_start = [_randint(k, 0, shape[i] - size[i] + 1) for i, k in enumerate(split(k_uni, 3))]
    use_fg = _uniform(k_coin)[0] < pos_ratio and total > 0
    return {"use_fg": use_fg, "nth": nth, "cls": cls, "uni_start": uni_start}


def apply_balanced_crop(sample: Sample, size, use_fg: bool, nth: int, cls: Optional[int],
                        uni_start: Sequence[int]) -> Sample:
    start = fg_crop_start(sample["label"], size, nth, cls) if use_fg else uni_start
    return apply_crop(sample, start, size)


def balanced_random_crop(
    sample: Sample, key: int, size: Tuple[int, int, int], pos_ratio: float = 0.5,
    class_balanced: bool = False, num_classes: int = 0,
) -> Sample:
    """Random patch with foreground oversampling (nnU-Net-style sampler).

    With probability ``pos_ratio`` the patch is centered on a uniformly
    chosen foreground voxel (any label > 0), else its origin is uniform over
    the grid; all-background volumes always fall back to uniform.
    ``class_balanced`` (needs ``num_classes``) first draws a class uniformly
    among those present, then a voxel within that class. Requires dims ≥
    ``size`` (see :func:`pad_to_min_size`)."""
    if sample.get("label") is None:
        return random_crop(sample, key, size)
    draw = draw_balanced_crop(key, sample["label"], size, pos_ratio, class_balanced, num_classes)
    return apply_balanced_crop(sample, size, **draw)


def label_centered_crop(sample: Sample, size: Tuple[int, int, int]) -> Sample:
    """Deterministic patch centered on the foreground center of mass
    (all-background volumes center on the grid). Requires dims ≥ ``size``."""
    lbl = sample.get("label")
    if lbl is None:
        return center_crop(sample, size)
    shape = tuple(lbl.shape)
    fg = (lbl > 0).to(torch.float32)
    count = fg.sum()
    total = torch.clamp_min(count, 1.0)
    com = []
    for ax in range(3):
        other = tuple(a for a in range(3) if a != ax)
        per = fg.sum(dim=other)
        com.append((per * torch.arange(shape[ax], dtype=torch.float32, device=lbl.device)).sum()
                   / total)
    center = torch.stack(com)
    center = torch.where(count > 0, center,
                         torch.tensor([s / 2.0 for s in shape], device=lbl.device))
    return apply_crop(sample, _clip_start(center.to(torch.int32).tolist(), shape, size), size)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

class Compose:
    """Sequential transform composition. Each transform is ``fn(sample) →
    sample`` or ``fn(sample, key) → sample``; key-taking transforms get an
    independent fold of the call key."""

    def __init__(self, transforms):
        self.transforms = list(transforms)
        # arity probed once at construction, not per sample
        self._takes_key = [len(inspect.signature(t).parameters) >= 2 for t in self.transforms]

    def __call__(self, sample: Sample, key: Optional[int] = None) -> Sample:
        key = 0 if key is None else key
        for i, (t, takes_key) in enumerate(zip(self.transforms, self._takes_key)):
            sample = t(sample, fold_in(key, i)) if takes_key else t(sample)
        return sample


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "transforms: no CUDA device; pass device='cpu' to run the transform graph "
                "on the CPU")
        device = "cuda"
    return torch.device(device)


class TransformPipeline:
    """A composed transform ``(sample, key) → sample`` on ``device``.

    The image and label arrays move to ``device`` (through pinned memory for
    a CUDA device) and every op of the graph runs there; metadata passes
    through. Callers may pass an explicit key; otherwise the pipeline draws
    a fresh one per call (a thread-safe counter folded into the base key)."""

    _ARRAY_KEYS = ("image", "label")

    def __init__(self, fn: Callable[[Sample, int], Sample], seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self._fn = fn
        self._base_key = _mix(int(seed), 0)
        self._counter = itertools.count()
        self._lock = threading.Lock()
        self.device = _resolve_device(device)

    def _next_key(self) -> int:
        with self._lock:
            i = next(self._counter)
        return fold_in(self._base_key, i)

    def key_for(self, epoch: int, idx: int) -> int:
        """Deterministic key for sample ``idx`` of epoch ``epoch``.

        Stateless: a preempted-and-resumed run derives the exact same
        augmentation and patch-sampling randomness for every (epoch, sample)
        pair, which is what makes step-granular resume exact with random
        transforms on. The loader routes the epoch here via
        ``Dataset.get_sample``."""
        return fold_in(fold_in(self._base_key, 0x5EED ^ int(epoch)), int(idx))

    def _to_device(self, v) -> torch.Tensor:
        order = None
        if isinstance(v, torch.Tensor):
            t = v
        else:
            # NIfTI volumes are Fortran-ordered (and stacked channels of them
            # neither C nor F): move the memory as it lies and transpose on
            # the device, not with a host copy
            a = np.asarray(v)
            order = tuple(int(i) for i in np.argsort([-s for s in a.strides], kind="stable"))
            t = torch.from_numpy(np.ascontiguousarray(a.transpose(order)))
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(self.device, non_blocking=True)
        else:
            t = t.to(self.device)
        if order is not None and order != tuple(range(t.ndim)):
            t = t.permute(tuple(int(i) for i in np.argsort(order))).contiguous()
        return t

    def __call__(self, sample: Sample, key: Optional[int] = None) -> Sample:
        if key is None:
            key = self._next_key()
        arrays = {k: self._to_device(v) for k, v in sample.items() if k in self._ARRAY_KEYS}
        out = dict(sample)  # metadata (patient_id, affine, ...) passes through
        out.update(self._fn(arrays, key))
        return out


def _plain(d) -> Dict[str, Any]:
    d = d or {}
    return d.to_dict() if hasattr(d, "to_dict") else dict(d)


def get_transforms(config, mode: str = "train", device=None) -> TransformPipeline:
    """Build the transform pipeline of a split (``train``, ``val``, ``test``)
    or of native-grid evaluation (``native``: normalise only) on ``device``
    (the card when None; without one it raises)."""
    modalities = list(config.get("data.modalities", ["CT", "PET"]))
    preprocess_cfg = _plain(config.get("data.preprocessing", {}))
    aug = config.get("data.augmentation", {}) or {}
    img_size = tuple(config.get("model.backbone.img_size", [96, 96, 96]))

    train_mode = mode == "train"
    aug_enabled = bool(aug.get("enabled", False))
    do_flip = bool(aug.get("random_flip", True))
    do_rot = float(aug.get("random_rotate", 0) or 0) > 0
    intensity = float(aug.get("random_intensity", 0) or 0)
    # random_scale zooms (an empty/None list disables it)
    scale_range = aug.get("random_scale", None)
    scale_range = tuple(scale_range) if scale_range else None
    if scale_range is not None and len(scale_range) != 2:
        scale_range = None
    elastic_cfg = _plain(aug.get("elastic", {}))
    do_elastic = bool(elastic_cfg.get("enabled", False))
    # patch-based training: native-resolution patches with foreground
    # oversampling (train → balanced_random_crop, val → label_centered_crop;
    # test keeps the resize)
    pb_cfg = _plain(config.get("data.patch_based", {}))
    patch_mode = bool(pb_cfg.get("enabled", False)) and mode in ("train", "val")
    patch_size = tuple(pb_cfg.get("size") or img_size)
    pos_ratio = float(pb_cfg.get("pos_ratio", 0.5))
    class_balanced = bool(pb_cfg.get("class_balanced", False))
    num_classes = int(config.get("model.out_channels", 0))

    # mode="native": normalise only, keep the original grid (native-grid
    # sliding-window evaluation)
    resize_needed = len(img_size) == 3 and mode != "native" and not patch_mode

    def fn(sample: Sample, key: int) -> Sample:
        out = dict(sample)
        out["image"] = modality_normalize(out["image"].to(torch.float32), modalities,
                                          preprocess_cfg)
        if train_mode and aug_enabled:
            k1, k2, k3, k4 = split(key, 4)
            if do_flip:
                out = random_flip(out, k1, prob=0.5)
            if do_rot:
                out = random_rotate90(out, k2, prob=0.5)
            if intensity > 0:
                out = random_intensity_shift(out, k3, shift_range=(-intensity, intensity),
                                             prob=0.3)
            out = random_gaussian_noise(out, k4, std=0.05, prob=0.2)
        if patch_mode:
            out = pad_to_min_size(out, patch_size)
            if train_mode:
                out = balanced_random_crop(out, fold_in(key, 2), patch_size, pos_ratio,
                                           class_balanced=class_balanced,
                                           num_classes=num_classes)
            else:
                out = label_centered_crop(out, patch_size)
        if resize_needed:
            out = resize_sample(out, img_size)
        if train_mode and aug_enabled:
            # resampling augmentations run after the resize: at img_size the
            # coordinate grid and gathers cost far less than at a native grid
            k5, k6 = split(fold_in(key, 1), 2)
            if scale_range is not None:
                out = random_zoom(out, k6, scale_range=scale_range, prob=0.3)
            if do_elastic:
                out = random_elastic_deform(
                    out, k5, grid=int(elastic_cfg.get("grid", 4)),
                    alpha=float(elastic_cfg.get("alpha", 2.0)),
                    prob=float(elastic_cfg.get("prob", 0.3)),
                )
        return out

    seed = int(config.get("experiment.seed", 42))
    # distinct base keys per split so val/test keys never collide with train
    seed_offset = {"train": 0, "val": 1, "test": 2}.get(mode, 3)
    return TransformPipeline(fn, seed=seed * 4 + seed_offset, device=device)
