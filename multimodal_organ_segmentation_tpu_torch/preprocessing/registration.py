"""Image registration on the device (port of the JAX package's
``preprocessing/registration.py``; reference: src/preprocessing/registration.py:21-288).

Capabilities mirrored:

- methods: translation / rigid (Euler 3D about the volume center) /
  affine / deformable (cubic B-spline FFD: mesh_size M → (M+3)³ control
  points per axis, uniform cubic basis, matching SimpleITK's
  BSplineTransformInitializer convention, registration.py:209-222);
- metrics: mattes_mutual_information (differentiable Parzen soft-binned
  joint histogram, 50 bins), correlation (negative NCC), mean_squares
  (registration.py:237-244);
- 3-level multi-resolution pyramid, shrink [4,2,1] / smoothing [2,1,0]
  (registration.py:266-268);
- geometric center initialization (CenteredTransformInitializer GEOMETRY,
  registration.py:226-231) — both images are first resampled onto the
  fixed grid through their affines, which aligns physical centers;
- outputs ``{mod}_registered.nii.gz`` + ``{mod}_transform.json``, the JAX
  package's transform JSON (either package applies the other's).

Each iteration is a forward of the warp and the metric, ``torch.autograd``
for the gradient and optax's Adam rule written out (``_Adam``), all on the
registration's device. What the JAX package leaves to
``jax.scipy.ndimage.map_coordinates`` and ``jnp.convolve`` is written out
here so that the value *and* the gradient are JAX's:

- ``_sample`` is map_coordinates(order=1, mode="constant"): floor, eight
  gathers, zero outside; at integer coordinates (the identity the
  registration starts from) the gradient is the forward difference;
- ``_abs`` takes JAX's subgradient 1 at 0 (torch's ``abs`` takes 0), and
  the tent weights' ``maximum`` splits a tie's gradient as JAX's does;
- the Gaussian smoothing is zero-padded shifted adds, and every matmul
  runs with TF32 off (``_full_f32``), so the card computes in f32 as the
  reference does.
"""

from __future__ import annotations

import itertools
import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_organ_segmentation_tpu_torch.ops.resize import resize_linear
from multimodal_organ_segmentation_tpu_torch.preprocessing.resample import (
    Device,
    preprocess_device,
    to_device,
)
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_json, save_nifti

Params = Dict[str, torch.Tensor]


@contextmanager
def _full_f32():
    """Matmuls and convolutions in full f32 on the card (TF32 off); the
    previous settings come back on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# resampling / warping
# ---------------------------------------------------------------------------

def _identity_coords(shape: Tuple[int, int, int], device: Device = "cpu") -> torch.Tensor:
    """[3, H, W, D] voxel coordinate grid."""
    return torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=device) for s in shape], indexing="ij"))


def _sample(moving: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of moving at [3, ...] voxel coords: JAX's
    ``map_coordinates(order=1, mode="constant")``. Per axis the nodes are
    ``floor(c)`` with weight ``1 - (c - floor c)`` and ``floor(c) + 1`` with
    weight ``c - floor c``; a corner outside the volume contributes
    ``weight × 0``. Products and sums run in JAX's order."""
    shape = moving.shape
    flat = moving.reshape(-1)
    nodes = []
    for axis in range(3):
        c = coords[axis]
        lower = torch.floor(c)
        upper_weight = c - lower
        lower_weight = 1 - upper_weight
        index = lower.to(torch.int64)
        axis_nodes = []
        for idx, weight in ((index, lower_weight), (index + 1, upper_weight)):
            valid = (idx >= 0) & (idx < shape[axis])
            axis_nodes.append((idx.clamp(0, shape[axis] - 1), valid, weight))
        nodes.append(axis_nodes)
    out = None
    for (i0, v0, w0), (i1, v1, w1), (i2, v2, w2) in itertools.product(*nodes):
        value = torch.where(v0 & v1 & v2, flat[(i0 * shape[1] + i1) * shape[2] + i2], 0.0)
        term = w0 * w1 * w2 * value
        out = term if out is None else out + term
    return out


def _sample_nearest(moving: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor sample — the correct interpolator for LABEL maps
    (trilinear would invent fractional labels on boundaries). Rounds half to
    even, as ``jnp.round``; out-of-bounds coords sample 0, matching
    ``_sample``'s constant mode."""
    idx = torch.round(coords).to(torch.int64)
    inside = torch.ones(idx.shape[1:], dtype=torch.bool, device=idx.device)
    gather = []
    for i in range(3):
        inside &= (idx[i] >= 0) & (idx[i] < moving.shape[i])
        gather.append(idx[i].clamp(0, moving.shape[i] - 1))
    return torch.where(inside, moving[gather[0], gather[1], gather[2]], 0)


def _euler_matrix(rx, ry, rz):
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one, zero = torch.ones_like(rx), torch.zeros_like(rx)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return Rz @ Ry @ Rx


def transform_coords(
    params: Params,
    coords: torch.Tensor,
    method: str,
    center: torch.Tensor,
    grid_shape: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """Map fixed-grid voxel coords → moving-image voxel coords."""
    c = coords.reshape(3, -1)
    if method == "translation":
        out = c + params["t"][:, None]
    elif method == "rigid":
        R = _euler_matrix(*params["r"])
        out = R @ (c - center[:, None]) + center[:, None] + params["t"][:, None]
    elif method == "affine":
        A = torch.eye(3, device=c.device) + params["A"]
        out = A @ (c - center[:, None]) + center[:, None] + params["t"][:, None]
    elif method == "deformable":
        # cubic B-spline FFD displacement field from the control grid
        full = bspline_upsample(params["grid"], grid_shape)
        out = c + full.reshape(-1, 3).T + params["t"][:, None]
    else:
        raise ValueError(f"unknown method {method}")
    return out.reshape(coords.shape)


def init_params(method: str, mesh_size: int = 4, device: Device = "cpu") -> Params:
    p = {"t": torch.zeros(3, device=device)}
    if method == "rigid":
        p["r"] = torch.zeros(3, device=device)
    elif method == "affine":
        p["A"] = torch.zeros((3, 3), device=device)
    elif method == "deformable":
        g = mesh_size + 3  # cubic spline: mesh cells + order control points
        p["grid"] = torch.zeros((g, g, g, 3), device=device)
    return p


def _bspline_weights_1d(out_len: int, n_ctrl: int, device: Device = "cpu") -> torch.Tensor:
    """Dense [out_len, n_ctrl] uniform-cubic-B-spline evaluation matrix.

    The physical extent is divided into ``n_ctrl - 3`` cells (SimpleITK
    BSplineTransform convention: mesh_size cells need mesh_size + order
    control points per axis). Output position h maps to spline coordinate
    u = h·M/(out_len-1) ∈ [0, M]; with cell i = ⌊u⌋ and t = u - i the four
    uniform cubic basis functions weight control points i..i+3 (distinct
    columns, so a scatter writes the JAX one-hot contraction exactly).
    """
    m = n_ctrl - 3
    u = torch.arange(out_len, dtype=torch.float32, device=device) * (m / max(out_len - 1, 1))
    i = torch.clamp(torch.floor(u), 0, m - 1)
    t = u - i
    b0 = (1 - t) ** 3 / 6.0
    b1 = (3 * t**3 - 6 * t**2 + 4) / 6.0
    b2 = (-3 * t**3 + 3 * t**2 + 3 * t + 1) / 6.0
    b3 = t**3 / 6.0
    cols = i[:, None].to(torch.int64) + torch.arange(4, device=device)[None, :]  # [H, 4]
    vals = torch.stack([b0, b1, b2, b3], dim=1)  # [H, 4]
    return torch.zeros(out_len, n_ctrl, device=device).scatter_(1, cols, vals)


def bspline_upsample(
    control: torch.Tensor, out_shape: Tuple[int, int, int]
) -> torch.Tensor:
    """[g0, g1, g2, C] control grid → [H, W, D, C] cubic-B-spline field."""
    g0, g1, g2, _ = control.shape
    w0 = _bspline_weights_1d(out_shape[0], g0, control.device)
    w1 = _bspline_weights_1d(out_shape[1], g1, control.device)
    w2 = _bspline_weights_1d(out_shape[2], g2, control.device)
    out = torch.einsum("ha,awdc->hwdc", w0, control)
    out = torch.einsum("wb,hbdc->hwdc", w1, out)
    return torch.einsum("dg,hwgc->hwdc", w2, out)


# ---------------------------------------------------------------------------
# metrics (to minimize)
# ---------------------------------------------------------------------------

def mean_squares(fixed: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
    return torch.mean((fixed - warped) ** 2)


def neg_correlation(fixed: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
    f = fixed - torch.mean(fixed)
    m = warped - torch.mean(warped)
    cc = torch.sum(f * m) / (
        torch.sqrt(torch.sum(f**2)) * torch.sqrt(torch.sum(m**2)) + 1e-8
    )
    return -cc


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's gradient: +1 at 0 (``torch.abs`` gives 0 there).
    A voxel on a bin centre (the minimum always is) needs it."""
    return torch.where(x >= 0, x, -x)


def neg_mattes_mi(
    fixed: torch.Tensor, warped: torch.Tensor, bins: int = 50
) -> torch.Tensor:
    """Negative mutual information via Parzen soft binning (linear kernel)."""
    def normalize(x):
        lo, hi = torch.min(x), torch.max(x)  # ties share the gradient, as in JAX
        return (x - lo) / (hi - lo + 1e-8)

    f = normalize(fixed.reshape(-1)) * (bins - 1)
    m = normalize(warped.reshape(-1)) * (bins - 1)
    centers = torch.arange(bins, dtype=torch.float32, device=f.device)
    zero = torch.zeros((), device=f.device)
    # linear (tent) kernel weights [N, bins]; maximum halves a tie's gradient
    wf = torch.maximum(zero, 1.0 - _abs(f[:, None] - centers[None]))
    wm = torch.maximum(zero, 1.0 - _abs(m[:, None] - centers[None]))
    joint = wf.T @ wm  # [bins, bins]
    joint = joint / (torch.sum(joint) + 1e-8)
    pf = torch.sum(joint, dim=1)
    pm = torch.sum(joint, dim=0)
    eps = 1e-10
    mi = torch.sum(joint * (torch.log(joint + eps) - torch.log(pf[:, None] * pm[None] + eps)))
    return -mi


_METRICS = {
    "mattes_mutual_information": neg_mattes_mi,
    "correlation": neg_correlation,
    "mean_squares": mean_squares,
}


# ---------------------------------------------------------------------------
# pyramid helpers
# ---------------------------------------------------------------------------

def _gaussian_smooth(vol: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian: along each axis ``jnp.convolve(row, k,
    mode="same")`` with zero padding, as the ``2·radius + 1`` shifted,
    weighted adds it is (elementwise f32, so no TF32 on the card)."""
    if sigma <= 0:
        return vol
    radius = int(3 * sigma)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / torch.sum(k)).tolist()
    for axis in range(3):
        n = vol.shape[axis]
        if n < 2 * radius + 1:
            raise ValueError(f"axis {axis} has {n} voxels; smoothing with sigma {sigma} "
                             f"needs at least {2 * radius + 1}")
        out = torch.zeros_like(vol)
        for j, weight in enumerate(k):
            s = j - radius  # out[i] += k[j] · vol[i + s], zero outside
            lo, hi = max(0, -s), n - max(0, s)
            out.narrow(axis, lo, hi - lo).add_(vol.narrow(axis, lo + s, hi - lo), alpha=weight)
        vol = out
    return vol


def _shrink(vol: torch.Tensor, factor: int) -> torch.Tensor:
    if factor <= 1:
        return vol
    out_shape = tuple(max(s // factor, 8) for s in vol.shape)
    return resize_linear(vol, out_shape, spatial_axes=(0, 1, 2))


class _Adam:
    """``optax.adam(lr)``'s rule (b1 0.9, b2 0.999, eps 1e-8, eps_root 0),
    its state fresh from construction as after ``tx.init``."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Params, lr: float):
        self.lr = lr
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, params: Params, grads: Params) -> Params:
        self.count += 1
        count = torch.tensor(float(self.count))
        bc1 = 1 - torch.tensor(self.b1) ** count
        bc2 = 1 - torch.tensor(self.b2) ** count
        out = {}
        for k, g in grads.items():
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            mu_hat = self.mu[k] / bc1.item()
            nu_hat = self.nu[k] / bc2.item()
            out[k] = params[k] + -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return out


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class ImageRegistration:
    """Multi-resolution gradient-descent registration on ``device`` (the
    card unless ``"cpu"`` is asked for). ``levels`` holds the last
    ``register_arrays`` run's pyramid: each level's shape, iterations and
    wall seconds of its optimisation loop."""

    def __init__(self, config=None, device: Device = None):
        config = config or {}
        reg_cfg = config.get("data.registration", {}) if hasattr(config, "get") else {}
        reg_cfg = reg_cfg or {}
        self.method = str(reg_cfg.get("method", "translation"))
        self.metric = str(reg_cfg.get("metric", "mattes_mutual_information"))
        self.iterations = int(reg_cfg.get("iterations", 100))
        self.shrink_factors = list(reg_cfg.get("shrink_factors", [4, 2, 1]))
        self.smoothing_sigmas = list(reg_cfg.get("smoothing_sigmas", [2, 1, 0]))
        self.lr = float(reg_cfg.get("lr", 0.5))
        self.mesh_size = int(reg_cfg.get("mesh_size", 4))
        self.config = config
        self.device = preprocess_device(device)
        self.levels: List[Dict[str, Any]] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- core optimization --------------------------------------------------

    def register_arrays(
        self,
        fixed,
        moving,
        method: Optional[str] = None,
        metric: Optional[str] = None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Register moving → fixed (same grid); returns (warped, transform)."""
        method = method or self.method
        metric_name = metric or self.metric
        metric_fn = _METRICS[metric_name]
        dev = self.device
        with _full_f32():
            fixed_t = to_device(fixed, dev).float()
            moving_t = to_device(moving, dev).float()
            params = init_params(method, self.mesh_size, dev)
            self.levels = []
            loss_fn = None
            for factor, sigma in zip(self.shrink_factors, self.smoothing_sigmas):
                f_level = _shrink(_gaussian_smooth(fixed_t, sigma), factor)
                m_level = _shrink(_gaussian_smooth(moving_t, sigma), factor)
                loss_fn = self._level_loss(fixed_t.shape, f_level, m_level, method, metric_fn)
                tx = _Adam(params, self.lr if method == "translation" else self.lr * 0.2)
                self._sync()
                start = time.perf_counter()
                for _ in range(self.iterations):
                    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                    grads = torch.autograd.grad(loss_fn(leaves), list(leaves.values()))
                    params = tx.step(params, dict(zip(leaves, grads)))
                self._sync()
                self.levels.append({"shape": tuple(f_level.shape), "iterations": self.iterations,
                                    "seconds": time.perf_counter() - start})
            # metric of the *returned* parameters at the last level (also
            # covers iterations == 0)
            with torch.no_grad():
                final_metric = float(loss_fn(params))
                # final warp at full resolution
                coords = _identity_coords(fixed_t.shape, dev)
                center = torch.tensor([(s - 1) / 2 for s in fixed_t.shape], device=dev)
                c = transform_coords(params, coords, method, center, tuple(fixed_t.shape))
                warped = _sample(moving_t, c).cpu().numpy()

        transform = {
            "method": method,
            "metric": metric_name,
            "params": {k: v.detach().cpu().numpy().tolist() for k, v in params.items()},
            "final_metric": final_metric,
        }
        return warped, transform

    @staticmethod
    def _level_loss(full_shape, f_level, m_level, method, metric_fn):
        """The loss of one pyramid level as a function of the parameters
        (stored in full-resolution voxels)."""
        dev = f_level.device
        scale = torch.tensor([fs / ms for fs, ms in zip(full_shape, f_level.shape)],
                             dtype=torch.float32, device=dev)
        coords = _identity_coords(tuple(f_level.shape), dev)
        center = torch.tensor([(s - 1) / 2 for s in f_level.shape], dtype=torch.float32,
                              device=dev)
        # evaluate the metric on the interior only: zero-fill outside the
        # moving volume would otherwise bias the optimum toward zero shift
        margin = [max(1, s // 8) for s in f_level.shape]
        interior = tuple(slice(m, s - m) for m, s in zip(margin, f_level.shape))
        f_interior = f_level[interior]

        def loss_fn(p):
            # translations are stored in full-res voxels; scale to level
            q = dict(p)
            q["t"] = p["t"] / scale
            if method == "deformable":
                q["grid"] = p["grid"] / scale[None, None, None, :]
            c = transform_coords(q, coords, method, center, tuple(f_level.shape))
            warped = _sample(m_level, c)
            loss = metric_fn(f_interior, warped[interior])
            if method == "deformable":
                loss = loss + 1e-4 * torch.mean(q["grid"] ** 2)
            return loss

        return loss_fn

    # -- grid alignment -------------------------------------------------------

    @staticmethod
    def resample_to_fixed_grid(
        moving: np.ndarray,
        moving_affine: np.ndarray,
        fixed_shape: Tuple[int, int, int],
        fixed_affine: np.ndarray,
        interpolation: str = "linear",
        device: Device = None,
    ) -> np.ndarray:
        """Resample moving onto the fixed grid through the affines
        (coords_m = A_m⁻¹ · A_f · coords_f). The coordinate map is float64
        numpy, as in the JAX package, cast to float32 only to sample on the
        device."""
        dev = preprocess_device(device)
        A = np.linalg.inv(moving_affine) @ fixed_affine  # voxel_f → voxel_m
        coords = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in fixed_shape],
                                      indexing="ij"))
        flat = coords.reshape(3, -1)
        hom = np.vstack([flat, np.ones((1, flat.shape[1]))])
        m_coords = (A @ hom)[:3].reshape(coords.shape)
        del coords, flat, hom
        sampler = _sample_nearest if interpolation == "nearest" else _sample
        out = sampler(to_device(moving, dev).float(), to_device(m_coords, dev))
        return out.cpu().numpy()

    # -- file-level API (reference: register/register_pair/apply_transform) ---

    def register_pair(
        self,
        fixed_path,
        moving_path,
        output_path=None,
        transform_path=None,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        fixed, f_aff = load_nifti(fixed_path, return_affine=True)
        moving, m_aff = load_nifti(moving_path, return_affine=True)

        if moving.shape != fixed.shape or not np.allclose(m_aff, f_aff):
            moving = self.resample_to_fixed_grid(moving, m_aff, fixed.shape, f_aff,
                                                 device=self.device)

        warped, transform = self.register_arrays(fixed, moving)

        if output_path is not None:
            save_nifti(warped, output_path, affine=f_aff)
        if transform_path is not None:
            save_json(transform, transform_path)
        return warped, transform

    def register(self, data_dir, primary_modality: str = "CT") -> Dict[str, str]:
        """Register every modality volume under ``data_dir`` to the primary.

        Expects ``{data_dir}/{MOD}/{mod}.nii.gz`` (preprocess layout).
        """
        data_dir = Path(data_dir)
        primary = primary_modality.upper()
        fixed_path = data_dir / primary / f"{primary.lower()}.nii.gz"
        if not fixed_path.exists():
            raise FileNotFoundError(f"primary modality volume missing: {fixed_path}")

        results = {}
        for mod_dir in sorted(p for p in data_dir.iterdir() if p.is_dir()):
            mod = mod_dir.name.upper()
            if mod == primary:
                continue
            moving_path = mod_dir / f"{mod.lower()}.nii.gz"
            if not moving_path.exists():
                continue
            out = mod_dir / f"{mod.lower()}_registered.nii.gz"
            tfm = mod_dir / f"{mod.lower()}_transform.json"
            self.register_pair(fixed_path, moving_path, out, tfm)
            results[mod] = str(out)
        return results

    def apply_transform(
        self, moving_path, transform_path, output_path, reference_path=None,
        interpolation: str = "linear", dtype=None,
    ) -> str:
        """Apply a saved transform to a new volume.

        ``interpolation="nearest"`` warps LABEL maps without inventing
        fractional labels (and preserves the integer dtype) — what you use
        to carry a segmentation through a registration found on the
        underlying images. SimpleITK exposes the same switch
        (sitkNearestNeighbor); the reference, delegating to SimpleITK,
        never wires it."""
        moving, m_aff = load_nifti(moving_path, return_affine=True)
        with open(transform_path) as f:
            transform = json.load(f)
        method = transform["method"]
        dev = self.device
        params = {
            k: torch.from_numpy(np.asarray(v, dtype=np.float32)).to(dev)
            for k, v in transform["params"].items()
        }

        if interpolation not in ("linear", "nearest"):
            raise ValueError(
                f"interpolation must be 'linear' or 'nearest', got {interpolation!r}"
            )
        if reference_path is not None:
            ref, r_aff = load_nifti(reference_path, return_affine=True)
            if moving.shape != ref.shape or not np.allclose(m_aff, r_aff):
                moving = self.resample_to_fixed_grid(
                    moving, m_aff, ref.shape, r_aff, interpolation=interpolation, device=dev
                )
            out_affine = r_aff
        else:
            out_affine = m_aff

        with _full_f32():
            vol = to_device(moving, dev).float()
            coords = _identity_coords(tuple(vol.shape), dev)
            center = torch.tensor([(s - 1) / 2 for s in vol.shape], device=dev)
            c = transform_coords(params, coords, method, center, tuple(vol.shape))
            sampler = _sample_nearest if interpolation == "nearest" else _sample
            warped = sampler(vol, c).cpu().numpy()
        if dtype is not None:
            # e.g. uint8 for a warped label map (nearest keeps the values
            # exact, so the cast is lossless)
            warped = np.round(warped).astype(dtype) if np.issubdtype(
                np.dtype(dtype), np.integer
            ) else warped.astype(dtype)
        save_nifti(warped, output_path, affine=out_affine)
        return str(output_path)
