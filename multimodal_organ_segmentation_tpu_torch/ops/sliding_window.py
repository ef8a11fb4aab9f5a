"""Sliding-window inference over a volume: tile, predict, Gaussian-blend.

Port of the JAX package's ``ops/sliding_window.py`` (the single-device
``sliding_window_inference``, the mesh-parallel
``sharded_sliding_window_inference``, the shape-bucketed
``SlidingWindowRunner``, ``predict_labels`` and ``predictive_entropy``). The
host-side tile grid is the same code; the blend runs eagerly, chunk by
chunk, adding each tile's weighted logits into f32 accumulators in place.

Tiling contract (MONAI-compatible):
  interval_i = int(roi_i * (1 - overlap))   (roi_i if interval would be 0)
  n_i        = ceil((dim_i - roi_i) / interval_i) + 1
  start_k    = min(k * interval_i, dim_i - roi_i)

Gaussian blending: separable gaussian centered at (roi-1)/2 with
sigma = 0.125 * roi, max-normalized (MONAI default sigma_scale=0.125).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_organ_segmentation_tpu_torch.parallel.mesh import collective


def _scan_starts(dim: int, roi: int, overlap: float) -> list:
    """Tile start offsets along one axis (MONAI dense_patch_slices rule)."""
    if dim <= roi:
        return [0]
    interval = int(roi * (1.0 - overlap))
    if interval <= 0:
        interval = roi
    n = int(math.ceil((dim - roi) / interval)) + 1
    return [min(k * interval, dim - roi) for k in range(n)]


def tile_count(
    shape: Tuple[int, int, int],
    roi_size: Tuple[int, int, int],
    overlap: float,
) -> int:
    """Number of tiles the scan grid places over ``shape``."""
    n = 1
    for dim, roi in zip(shape, roi_size):
        n *= len(_scan_starts(dim, roi, overlap))
    return n


def auto_sw_batch_size(
    n_tiles: int, target: int, slack: int = 4, chunk_multiple: int = 1
) -> int:
    """Chunk size <= ``target`` minimizing padded tile slots.

    Padded slots run the model on duplicate tiles whose outputs are masked
    away, so waste is minimized first, then the largest chunk is taken.
    Single-device the search stays within ``slack`` of ``target``; with
    ``chunk_multiple`` > 1 (a data mesh rounds the chunk count up to the
    mesh size) the candidates are the per-quantum optima
    ``ceil(n / (cm*k))`` instead.
    """
    n = max(1, int(n_tiles))
    cm = max(1, int(chunk_multiple))
    target = max(1, min(int(target), n))

    def waste(sw: int) -> int:
        chunks = math.ceil(math.ceil(n / sw) / cm) * cm
        return chunks * sw - n

    if cm == 1:
        candidates = list(range(target, max(0, target - slack - 1), -1))
    else:
        candidates, k = [], 1
        while True:
            sw = math.ceil(n / (cm * k))
            if sw <= target and sw not in candidates:
                candidates.append(sw)
            if sw <= 1:
                break
            k += 1
    best, best_waste = None, None
    for sw in candidates:  # decreasing sw; strict < keeps the largest on ties
        w_ = waste(sw)
        if best is None or w_ < best_waste:
            best, best_waste = sw, w_
    return best


def resolve_sw_batch(
    value,
    shape: Tuple[int, int, int],
    roi_size: Tuple[int, int, int],
    overlap: float,
    default: int = 4,
    chunk_multiple: int = 1,
) -> int:
    """Resolve a config ``inference.batch_size`` to a concrete chunk size.

    ``value`` may be an int, ``"auto"`` (waste-minimizing search capped at
    16), or ``"auto:N"`` (capped at N).
    """
    if value is None:
        return int(default)
    if isinstance(value, str):
        v = value.strip().lower()
        if v.startswith("auto"):
            cap = int(v.split(":", 1)[1]) if ":" in v else 16
            return auto_sw_batch_size(
                tile_count(shape, roi_size, overlap), cap,
                chunk_multiple=chunk_multiple,
            )
        return int(v)
    return int(value)


def gaussian_importance_map(
    roi_size: Sequence[int], sigma_scale: float = 0.125, dtype=np.float32
) -> np.ndarray:
    """Separable Gaussian weight map over a ROI, max-normalized to 1."""
    maps = []
    for r in roi_size:
        center = (r - 1) / 2.0
        sigma = sigma_scale * r
        x = np.arange(r, dtype=np.float64)
        g = np.exp(-0.5 * ((x - center) / sigma) ** 2)
        maps.append(g)
    w = maps[0][:, None, None] * maps[1][None, :, None] * maps[2][None, None, :]
    w = w / w.max()
    # avoid exact zeros so normalization is safe everywhere
    w = np.maximum(w, w.max() * 1e-3)
    return w.astype(dtype)


def make_tile_grid(
    shape: Tuple[int, int, int],
    roi_size: Tuple[int, int, int],
    overlap: float,
    sw_batch_size: int,
    min_chunks: int = 0,
    chunk_multiple: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side tile grid: ``(starts [n_chunks, sw, 3], valid [n_chunks, sw])``.

    Padded slots (to fill the last chunk, reach ``min_chunks``, or round the
    chunk count up to ``chunk_multiple``) repeat the last tile with
    ``valid=0`` so they contribute nothing to the blend.
    """
    starts = [
        (sh, sw_, sd)
        for sh in _scan_starts(shape[0], roi_size[0], overlap)
        for sw_ in _scan_starts(shape[1], roi_size[1], overlap)
        for sd in _scan_starts(shape[2], roi_size[2], overlap)
    ]
    n_tiles = len(starts)
    n_chunks = max(int(math.ceil(n_tiles / sw_batch_size)), min_chunks, 1)
    n_chunks = int(math.ceil(n_chunks / chunk_multiple)) * chunk_multiple
    n_padded = n_chunks * sw_batch_size
    valid = np.zeros((n_padded,), dtype=np.float32)
    valid[:n_tiles] = 1.0
    while len(starts) < n_padded:
        starts.append(starts[-1])
    starts_arr = np.asarray(starts, dtype=np.int32).reshape(
        n_chunks, sw_batch_size, 3
    )
    return starts_arr, valid.reshape(n_chunks, sw_batch_size)


def _blend_weight(roi_size, mode: str) -> np.ndarray:
    if mode == "gaussian":
        w = gaussian_importance_map(roi_size)
    else:
        w = np.ones(roi_size, dtype=np.float32)
    return w[..., None]  # [rh, rw, rd, 1]


def _sw_accumulate(
    vol: torch.Tensor,
    starts_arr: np.ndarray,
    valid_arr: np.ndarray,
    run_predict: Callable[[torch.Tensor], torch.Tensor],
    roi_size: Tuple[int, int, int],
    num_classes: int,
    weight4: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the tile chunks over ``vol`` [H, W, D, C] → (acc, wacc) blends.

    The accumulators are f32 and are updated in place, one tile at a time;
    padded slots (``valid == 0``) add nothing.
    """
    H, W, D, _ = vol.shape
    rh, rw, rd = roi_size
    acc = torch.zeros((H, W, D, num_classes), dtype=torch.float32, device=vol.device)
    wacc = torch.zeros((H, W, D, 1), dtype=torch.float32, device=vol.device)
    for chunk_starts, chunk_valid in zip(starts_arr.tolist(), valid_arr.tolist()):
        patches = torch.stack(
            [vol[s0:s0 + rh, s1:s1 + rw, s2:s2 + rd] for s0, s1, s2 in chunk_starts]
        )  # [sw, rh, rw, rd, c]
        weighted = run_predict(patches).float() * weight4  # [sw, rh, rw, rd, K]
        for i, ((s0, s1, s2), v) in enumerate(zip(chunk_starts, chunk_valid)):
            if v == 0.0:
                continue
            acc[s0:s0 + rh, s1:s1 + rw, s2:s2 + rd].add_(weighted[i])
            wacc[s0:s0 + rh, s1:s1 + rw, s2:s2 + rd].add_(weight4)
    return acc, wacc


@torch.no_grad()
def sliding_window_inference(
    volume: torch.Tensor,
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    roi_size: Tuple[int, int, int],
    num_classes: int,
    overlap: float = 0.5,
    sw_batch_size: int = 4,
    mode: str = "gaussian",
) -> torch.Tensor:
    """Run tiled inference over ``volume``.

    Args:
        volume: ``[H, W, D, C]`` (single volume) or ``[B, H, W, D, C]``.
        predict_fn: maps ``[n, *roi, C]`` patches → ``[n, *roi, num_classes]``
            logits.
        roi_size: tile size.
        num_classes: output channel count.
        overlap: fractional tile overlap.
        sw_batch_size: tiles per model forward.
        mode: "gaussian" or "constant" blending.

    Returns:
        f32 logits with the same spatial shape as ``volume`` and
        ``num_classes`` channels, on the volume's device.
    """
    roi_size = tuple(int(r) for r in roi_size)
    if volume.dim() == 5:
        return torch.stack([
            sliding_window_inference(
                v, predict_fn, roi_size, num_classes, overlap, sw_batch_size, mode
            )
            for v in volume
        ])

    starts_np, valid_np = make_tile_grid(
        _padded_shape(volume.shape[:3], roi_size), roi_size, overlap, sw_batch_size)
    return _blend(volume, predict_fn, starts_np, valid_np, roi_size, num_classes, mode)


def _padded_shape(shape, roi_size) -> Tuple[int, int, int]:
    """The volume's shape padded up to at least the ROI along each axis."""
    return tuple(max(int(n), int(r)) for n, r in zip(shape, roi_size))


def _blend(
    volume: torch.Tensor,
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    starts_np: np.ndarray,
    valid_np: np.ndarray,
    roi_size: Tuple[int, int, int],
    num_classes: int,
    mode: str,
    mesh=None,
    axis_name: str = "data",
) -> torch.Tensor:
    """Blended logits of one ``[H, W, D, C]`` volume over a tile grid of its
    ROI-padded shape: pad, accumulate the chunks (with a ``mesh``, this
    rank's block of them, then the sum over the ranks), normalise, crop."""
    h, w, d, _ = volume.shape
    H, W, D = _padded_shape((h, w, d), roi_size)
    vol = torch.nn.functional.pad(volume, (0, 0, 0, D - d, 0, W - w, 0, H - h))
    weight4 = torch.from_numpy(_blend_weight(roi_size, mode)).to(volume.device)
    if mesh is not None:
        # this rank's contiguous block of the chunks (the JAX shard_map's
        # P(axis_name) over the chunk dim), then the sum over the ranks
        size = mesh.shape[axis_name]
        per = starts_np.shape[0] // size
        r = mesh.axis_rank(axis_name)
        starts_np, valid_np = starts_np[r * per:(r + 1) * per], valid_np[r * per:(r + 1) * per]
    acc, wacc = _sw_accumulate(
        vol, starts_np, valid_np, predict_fn, roi_size, num_classes, weight4
    )
    if mesh is not None and mesh.shape[axis_name] > 1:
        group = mesh.group(axis_name)
        collective(dist.all_reduce, acc, group=group)
        collective(dist.all_reduce, wacc, group=group)
    acc.div_(wacc)
    return acc[:h, :w, :d, :]


@torch.no_grad()
def sharded_sliding_window_inference(
    volume: torch.Tensor,
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    roi_size: Tuple[int, int, int],
    num_classes: int,
    mesh,
    axis_name: str = "data",
    overlap: float = 0.5,
    sw_batch_size: int = 4,
    mode: str = "gaussian",
) -> torch.Tensor:
    """Mesh-parallel sliding window: tile chunks split over the ranks of
    ``axis_name``.

    The chunk count is rounded up to a multiple of the axis size; each rank
    runs its contiguous block of chunks into a full-volume ``(acc, wacc)``
    pair of its own, and an ``all_reduce`` of both merges them. Gaussian
    blending is a weighted sum, so the merged logits equal the one-rank
    logits up to f32 summation order (bit for bit at one rank). Every rank
    must call it with the same volume; every rank gets the logits.

    Same contract as :func:`sliding_window_inference` for a single volume
    ``[H, W, D, C]``.
    """
    roi_size = tuple(int(r) for r in roi_size)
    starts_np, valid_np = make_tile_grid(
        _padded_shape(volume.shape[:3], roi_size), roi_size, overlap, sw_batch_size,
        chunk_multiple=int(mesh.shape[axis_name]))
    return _blend(volume, predict_fn, starts_np, valid_np, roi_size, num_classes, mode,
                  mesh=mesh, axis_name=axis_name)


def bucket_shape(
    shape: Tuple[int, int, int],
    roi_size: Tuple[int, int, int],
    overlap: float,
) -> Tuple[int, int, int]:
    """Smallest canonical shape with the same per-axis tile count as
    ``shape``: roi + interval·ceil((dim − roi)/interval). Every shape in a
    bucket shares tile counts, so a bucket wastes no tile slots."""
    out = []
    for dim, roi in zip(shape, roi_size):
        if dim <= roi:
            out.append(roi)
            continue
        interval = int(roi * (1.0 - overlap)) or roi
        out.append(roi + interval * int(math.ceil((dim - roi) / interval)))
    return tuple(out)


class SlidingWindowRunner:
    """Serving front-end: shape-bucketed sliding-window inference.

    The JAX runner compiles one XLA program per (bucket shape, channel
    count, chunk count) and pads each volume to its bucket so that the
    program serves the whole bucket; the tile starts come from the volume's
    ORIGINAL shape, so its logits equal the unbucketed program's. Eager
    PyTorch compiles nothing, so the pad buys nothing and is skipped: the
    tile grid comes from the original shape and the chunk size and count
    from the bucket (the same tile count, hence the same chunks), which
    makes the logits those of ``sliding_window_inference`` on the original
    shape, bit for bit. ``num_compiled`` counts the distinct (bucket,
    channels, chunks) keys seen, the programs the JAX runner would hold.

    ``predict_fn(params, patches)`` maps ``[n, *roi, C]`` patches to logits
    with the given weights. With a ``mesh`` the chunk count is rounded up to
    a multiple of its ``axis_name`` size and the chunks are split over the
    ranks (:func:`sharded_sliding_window_inference`); every rank must call
    it with the same volume. On a mesh with a model axis > 1 the chunks are
    split over the data axis only: the ranks of a model group run the same
    tiles, each its shard of the model, and the blend sums over the data
    group.
    """

    def __init__(
        self,
        predict_fn: Callable,
        roi_size: Tuple[int, int, int],
        num_classes: int,
        overlap: float = 0.5,
        sw_batch_size=4,
        mode: str = "gaussian",
        mesh=None,
        axis_name: str = "data",
    ):
        self.predict_fn = predict_fn
        self.roi_size = tuple(int(r) for r in roi_size)
        self.num_classes = int(num_classes)
        self.overlap = float(overlap)
        # "auto"/"auto:N" → per-bucket divisor search (the bucket fixes the
        # tile count, so every volume in a bucket shares the resolved size)
        self._sw_spec = sw_batch_size
        self.sw_batch_size = (
            sw_batch_size if isinstance(sw_batch_size, str) else int(sw_batch_size)
        )
        self.mode = str(mode)
        self.mesh = mesh
        self.axis_name = axis_name
        self._keys = set()

    def _chunk_multiple(self) -> int:
        return int(self.mesh.shape[self.axis_name]) if self.mesh is not None else 1

    def grid(self, shape: Tuple[int, int, int]) -> Tuple[np.ndarray, np.ndarray, tuple]:
        """The tile grid ``(starts, valid)`` of a volume of ``shape`` and its
        bucket key: starts from the original shape, chunk size and count
        from the bucket."""
        bucket = bucket_shape(shape, self.roi_size, self.overlap)
        cm = self._chunk_multiple()
        sw = resolve_sw_batch(self._sw_spec, bucket, self.roi_size, self.overlap,
                              chunk_multiple=cm)
        b_starts, _ = make_tile_grid(bucket, self.roi_size, self.overlap, sw)
        n_chunks = int(math.ceil(b_starts.shape[0] / cm)) * cm
        starts_np, valid_np = make_tile_grid(
            _padded_shape(shape, self.roi_size), self.roi_size, self.overlap, sw,
            min_chunks=n_chunks, chunk_multiple=cm,
        )
        if starts_np.shape[0] != n_chunks:
            raise AssertionError(
                f"bucket {bucket} chunk count {n_chunks} < the volume's "
                f"{starts_np.shape[0]}: bucket_shape must dominate tile counts")
        return starts_np, valid_np, (bucket, n_chunks)

    @torch.no_grad()
    def __call__(self, volume: torch.Tensor, params=None) -> torch.Tensor:
        """``[H, W, D, C]`` volume → ``[H, W, D, num_classes]`` f32 logits."""
        h, w, d, c = volume.shape
        starts_np, valid_np, (bucket, n_chunks) = self.grid((h, w, d))
        self._keys.add((bucket, c, n_chunks))
        return _blend(volume, lambda p: self.predict_fn(params, p), starts_np, valid_np,
                      self.roi_size, self.num_classes, self.mode, mesh=self.mesh,
                      axis_name=self.axis_name)

    @property
    def num_compiled(self) -> int:
        return len(self._keys)


def ensemble_run_sw(runner: Callable, members) -> Callable[[torch.Tensor], torch.Tensor]:
    """Volume → blended logits of ``runner(volume, params)`` with one member,
    or the mean of the members' softmaxes with several (``inference.ensemble``;
    ``predict_labels(..., already_probs=True)`` takes the latter)."""
    if len(members) == 1:
        return lambda vol: runner(vol, members[0])

    def run_sw(vol):
        acc = None
        for v in members:
            p = torch.softmax(runner(vol, v), dim=-1)
            acc = p if acc is None else acc + p
        return acc / len(members)

    return run_sw


def predict_labels(
    run_sw: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    tta: bool = False,
    return_probs: bool = False,
    already_probs: bool = False,
):
    """Blended logits → label map for one ``[H, W, D, C]`` volume.

    ``run_sw`` maps a volume to full-volume logits. With ``tta``, averages
    over the 3 single-axis spatial flips, un-flipping each prediction.
    ``return_probs`` additionally returns per-class probabilities
    ``[H, W, D, C]`` (softmax of the blended logits); ``already_probs`` marks
    ``run_sw`` as returning probabilities, so the softmax is skipped. Labels
    stay on the volume's device.
    """
    out = run_sw(image)
    if tta:
        for axis in range(3):
            flipped = torch.flip(image, dims=(axis,))
            out = out + torch.flip(run_sw(flipped), dims=(axis,))
        out = out / 4.0
    labels = torch.argmax(out, dim=-1)
    if not return_probs:
        return labels
    probs = out if already_probs else torch.softmax(out, dim=-1)
    return labels, probs


def predictive_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Normalised predictive entropy ``[H, W, D]`` in [0, 1] from per-class
    probabilities ``[H, W, D, C]``: ``H(p) / log C``, 0 where the model is
    certain, 1 at a uniform posterior (with an ensemble, an ensemble
    predictive entropy). Runs on the probabilities' device."""
    c = probs.shape[-1]
    h = -(probs * torch.log(probs.clamp_min(1e-12))).sum(dim=-1)
    return h / math.log(float(c))
