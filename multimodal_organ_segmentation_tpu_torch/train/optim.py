"""Optimisers and LR schedules (port of the JAX package's ``train.optim`` module).

``make_optimizer`` builds the configured optimiser over a model's parameters
with optax's update rules:

- ``adam``  — L2 weight decay added to the gradient (torch ``Adam``);
- ``adamw`` — decoupled decay (torch ``AdamW``). optax adds ``lr·wd·p`` to
  the update where torch multiplies ``p`` by ``1 − lr·wd`` first: the two
  differ by ``lr²·wd`` times the Adam direction, far below f32 resolution at
  the configured rates;
- ``sgd``   — momentum ``t ← g + μ·t``, L2 decay added to the gradient;
- ``adafactor`` — optax's ``adafactor`` with its defaults (:class:`Adafactor`;
  torch's own ``Adafactor`` follows another update rule);
- ``training.grad_clip_norm`` > 0 clips the global gradient norm first, by
  optax's rule ``g · min(1, c/‖g‖)`` (no epsilon).

The schedule is a host-side function ``lr(epoch)`` written into the
optimiser once per epoch (``set_learning_rate``), which also supports the
metric-driven plateau schedule.

Parity notes:
- cosine: ``CosineAnnealingLR(T_max=epochs-warmup, eta_min=min_lr)`` — the
  reference never applies an actual warmup ramp, it only shortens T_max (a
  quirk kept here; a real linear warmup is available with ``warmup: true``).
- step: ``StepLR(step_size, gamma)``.
- plateau: ``ReduceLROnPlateau(mode=max, patience, factor)``.
- poly: lr·(1 − e/E)^power (nnU-Net's standard schedule).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_organ_segmentation_tpu_torch.parallel.mesh import sum_over


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖g‖²) over all gradients, summed in f32."""
    grads = list(grads)
    if not grads:
        return torch.zeros(())
    norms = torch._foreach_norm([g.float() if g.dtype != torch.float64 else g for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class ChainedOptimizer:
    """Global-norm clipping followed by a torch optimiser (optax's
    ``chain(clip_by_global_norm, base)``). ``step`` reads ``p.grad``."""

    def __init__(self, inner: torch.optim.Optimizer, clip_norm: float = 0.0):
        self.inner = inner
        self.clip_norm = float(clip_norm)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def params(self) -> List[torch.Tensor]:
        return [p for group in self.inner.param_groups for p in group["params"]]

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update. ``grad_norm`` (the global norm of the current
        gradients) saves recomputing it for the clipping."""
        if self.clip_norm > 0:
            grads = [p.grad for p in self.params() if p.grad is not None]
            norm = grad_norm if grad_norm is not None else global_norm(grads)
            # g · min(1, c/‖g‖); a zero norm leaves the (zero) gradients alone
            scale = torch.clamp(self.clip_norm / norm.clamp_min(1e-38), max=1.0)
            torch._foreach_mul_(grads, scale.to(grads[0].device))
        self.inner.step()

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state) -> None:
        self.inner.load_state_dict(state)


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's rule: the two largest axes (second largest, largest), or None
    when fewer than two axes or the second largest is under the minimum.
    Between equal sizes the later axis counts as the larger (a stable sort:
    numpy's default sort may break the tie another way on another CPU, and a
    checkpoint's ``v_row`` / ``v_col`` must mean the same axes wherever it
    is read; the update is symmetric in the two)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def moment_dim(key: str, ndim: int, shape, dim: int) -> Optional[int]:
    """Where dim ``dim`` of a parameter whose whole shape is ``shape`` sits in
    its optimiser-state entry ``key`` of ``ndim`` dims: the same dim in a
    moment shaped like the parameter; in adafactor's factored ``v_row`` /
    ``v_col`` the dim shifted past the averaged axis. None where the entry
    does not run along ``dim``: a step count, or a factored moment averaged
    over ``dim`` (whole on every rank that holds a piece of the leaf)."""
    if key in ("v_row", "v_col"):
        d1, d0 = _factored_dims(tuple(shape))
        gone = d0 if key == "v_row" else d1
        return None if dim == gone else dim - int(dim > gone)
    return dim if ndim == len(shape) and ndim > 0 else None


@dataclass(frozen=True)
class Part:
    """A parameter held in pieces: ``shape`` is the whole leaf's, and each of
    ``cuts`` is ``(dim, group)``, a dim cut into equal pieces over the ranks
    of ``group`` (ZeRO-1 over the data group, tensor parallelism over the
    model group; one leaf may carry both)."""

    shape: Tuple[int, ...]
    cuts: Tuple[Tuple[int, Any], ...] = ()

    def groups(self, dim: Optional[int] = None) -> List[Any]:
        """The groups that cut ``dim`` (every cut's group for None)."""
        return [g for d, g in self.cuts if dim is None or d == dim]


class _Sums:
    """Partial sums of pieces of leaves, each to be summed over the groups
    that cut it; ``reduce`` issues one collective a group, the groups in the
    order they came (the same on every rank: every rank walks the same
    parameters)."""

    def __init__(self):
        self.by_group: Dict[Any, List[torch.Tensor]] = {}

    def add(self, t: torch.Tensor, groups: List[Any]) -> torch.Tensor:
        for g in groups:
            self.by_group.setdefault(g, []).append(t)
        return t

    def reduce(self) -> None:
        for g, ts in self.by_group.items():
            sum_over(ts, g)
        self.by_group = {}


def _move(p, group, part, state, p_sq, u, u_sq) -> None:
    """Steps 2 to 6 of :class:`Adafactor` on one leaf, given the whole
    leaf's Σp² and Σu²."""
    n = float(np.prod(part.shape))
    u = u / torch.clamp(torch.sqrt(u_sq / n) / group["clipping_threshold"], min=1.0)
    u = u * group["lr"]
    p_rms = torch.sqrt(p_sq / n)
    u = u * torch.where(p_rms <= group["min_scale"],
                        torch.full_like(p_rms, group["min_scale"]), p_rms)
    if group["weight_decay"]:
        u = u + group["weight_decay"] * p
    p.add_(-u)
    state["step"] += 1


class Adafactor(torch.optim.Optimizer):
    """optax's ``adafactor`` (``train/optim.py:55-64`` of the JAX package: its
    defaults, ``weight_decay_rate`` = the configured decay or none), as the
    chain optax builds:

    1. ``scale_by_factored_rms`` (decay ``1 - (t+1)^-0.8``, eps 1e-30): a
       tensor whose second-largest axis has at least 128 entries keeps row
       and column means of ``g² + eps`` over its two largest axes; any other
       keeps the full ``v``; the update is ``g / sqrt(v̂)``;
    2. ``clip_by_block_rms(1.0)``: ``u / max(1, rms(u))`` per tensor;
    3. times the learning rate;
    4. ``scale_by_param_block_rms``: times ``max(rms(p), 1e-3)``;
    5. ``add_decayed_weights``: ``+ weight_decay · p`` (not scaled by the
       learning rate);
    6. the parameter moves by minus the update.

    The factored axes are chosen by size, so the port's layouts (torch's
    ``[out, in, ...]`` where flax has ``[..., in, out]``) factor the same
    axes; between two axes of equal size the choice swaps row and column,
    which the rule is symmetric in (up to the order of one mean).

    A parameter held in pieces over ranks (``parts``: one :class:`Part` or
    None a parameter, in order) steps as the whole leaf would: whether it
    is factored, and over which axes, follows the whole shape, and the three
    statistics that are not elementwise (the row and column means of 1, the
    update's RMS of 2, the parameter's RMS of 4) sum their pieces over the
    groups that cut them (:func:`sum_over`), three collectives a step for
    each group. A rank keeps
    its piece of ``v``, and of ``v_row`` / ``v_col`` along a cut they run
    along; a factored moment averaged over a cut dim is whole on every
    rank."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0,
                 decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                 clipping_threshold: float = 1.0, eps: float = 1e-30, min_scale: float = 1e-3,
                 parts: Optional[Sequence[Optional[Part]]] = None):
        params = list(params)
        defaults = dict(lr=lr, weight_decay=weight_decay, decay_rate=decay_rate,
                        min_dim_size_to_factor=min_dim_size_to_factor,
                        clipping_threshold=clipping_threshold, eps=eps, min_scale=min_scale)
        super().__init__(params, defaults)
        flat = [p for group in self.param_groups for p in group["params"]]
        parts = list(parts) if parts is not None else [None] * len(flat)
        self.parts = {p: part or Part(tuple(p.shape)) for p, part in zip(flat, parts)}

    @torch.no_grad()
    def step(self, closure=None):
        work, sums = [], _Sums()
        # 1. the statistics of g² + eps (an unfactored leaf's v at once, a
        #    factored leaf's row and column sums) and Σp², summed over the cuts
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                part, state, g = self.parts[p], self.state[p], p.grad
                dims = _factored_dims(part.shape, group["min_dim_size_to_factor"])
                if not state:
                    state["step"] = 0
                    if dims is not None:
                        d1, d0 = dims
                        state["v_row"] = p.new_zeros(tuple(np.delete(p.shape, d0)))
                        state["v_col"] = p.new_zeros(tuple(np.delete(p.shape, d1)))
                    else:
                        state["v"] = torch.zeros_like(p)
                t = torch.tensor(float(state["step"] + 1), dtype=torch.float32)
                decay = (1.0 - t ** (-group["decay_rate"])).to(p.device)
                grad_sqr = g * g + group["eps"]
                if dims is not None:
                    stats = (sums.add(grad_sqr.sum(dim=dims[1]), part.groups(dims[1])),
                             sums.add(grad_sqr.sum(dim=dims[0]), part.groups(dims[0])))
                else:
                    state["v"] = decay * state["v"] + (1.0 - decay) * grad_sqr
                    stats = None
                p_sq = sums.add((p * p).sum(), part.groups())
                work.append((p, group, part, state, dims, decay, stats, p_sq))
        sums.reduce()
        # 2. the factored moments, and their rows' sums over the second axis
        row_sums = []
        for p, group, part, state, dims, decay, stats, _ in work:
            if dims is None:
                row_sums.append(None)
                continue
            d1, d0 = dims
            state["v_row"] = decay * state["v_row"] + (1.0 - decay) * (stats[0] / part.shape[d0])
            state["v_col"] = decay * state["v_col"] + (1.0 - decay) * (stats[1] / part.shape[d1])
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_sums.append(sums.add(state["v_row"].sum(dim=reduced_d1, keepdim=True),
                                     part.groups(d1)))
        sums.reduce()
        # 3. the update: a leaf held whole moves at once, a leaf in pieces
        #    once its Σu² is summed over the cuts
        pending = []
        for (p, group, part, state, dims, _, _, p_sq), row_sum in zip(work, row_sums):
            if dims is not None:
                d1, d0 = dims
                row_factor = (state["v_row"] / (row_sum / part.shape[d1])) ** -0.5
                u = p.grad * row_factor.unsqueeze(d0) * (state["v_col"] ** -0.5).unsqueeze(d1)
            else:
                u = p.grad * state["v"] ** -0.5
            u_sq = (u * u).sum()
            if part.cuts:
                pending.append((p, group, part, state, p_sq, u, sums.add(u_sq, part.groups())))
            else:
                _move(p, group, part, state, p_sq, u, u_sq)
        sums.reduce()
        for args in pending:
            _move(*args)


def make_optimizer(config, params: Iterable[torch.nn.Parameter],
                   parts: Optional[Sequence[Optional[Part]]] = None) -> ChainedOptimizer:
    """Build the configured optimiser over ``params`` with a learning rate
    that ``set_learning_rate`` rewrites. ``parts`` says which parameters are
    pieces of a leaf held over several ranks (:class:`Part`): adafactor
    steps them as whole leaves; the elementwise rules need nothing."""
    opt_cfg = config.get("training.optimizer", {}) or {}
    name = str(opt_cfg.get("name", "adamw")).lower()
    lr = float(opt_cfg.get("lr", 1e-4))
    wd = float(opt_cfg.get("weight_decay", 0) or 0)
    clip = float(config.get("training.grad_clip_norm", 0.0) or 0.0)
    params = list(params)

    if name == "adam":
        inner = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    elif name == "sgd":
        momentum = float(opt_cfg.get("momentum", 0.9))
        inner = torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=wd)
    elif name == "adafactor":
        inner = Adafactor(params, lr=lr, weight_decay=wd, parts=parts)
    else:  # adamw (and fallback)
        b1, b2 = tuple(opt_cfg.get("betas", [0.9, 0.999]))
        inner = torch.optim.AdamW(params, lr=lr, betas=(float(b1), float(b2)), eps=1e-8,
                                  weight_decay=wd)
    return ChainedOptimizer(inner, clip)


def set_learning_rate(optimizer, lr: float):
    """Write a new LR into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class LRScheduler:
    """Per-epoch LR controller (host side)."""

    def __init__(self, config):
        sched = config.get("training.scheduler", {}) or {}
        self.name = str(sched.get("name", "cosine")).lower()
        self.base_lr = float(config.get("training.optimizer.lr", 1e-4))
        self.epochs = int(config.get("training.epochs", 300))
        self.warmup = int(sched.get("warmup_epochs", 0) or 0)
        self.min_lr = float(sched.get("min_lr", 1e-6))
        self.step_size = int(sched.get("step_size", 30))
        self.gamma = float(sched.get("gamma", 0.1))
        self.power = float(sched.get("power", 0.9))  # poly only
        self.patience = int(sched.get("patience", 10))
        self.factor = float(sched.get("factor", 0.1))
        self.use_warmup_ramp = bool(sched.get("warmup", False))

        # plateau state
        self._best = -math.inf
        self._bad = 0
        self._scale = 1.0

    def lr_for_epoch(self, epoch: int, metric: Optional[float] = None) -> float:
        """LR to use during ``epoch`` (0-indexed); for plateau, ``metric`` is
        the previous epoch's monitored value."""
        if self.use_warmup_ramp and epoch < self.warmup:
            return self.base_lr * (epoch + 1) / max(self.warmup, 1)

        if self.name == "cosine":
            t_max = max(self.epochs - self.warmup, 1)
            e = min(epoch, t_max)
            return self.min_lr + (self.base_lr - self.min_lr) * (
                1 + math.cos(math.pi * e / t_max)
            ) / 2
        if self.name == "step":
            return self.base_lr * (self.gamma ** (epoch // self.step_size))
        if self.name == "poly":
            # nnU-Net-standard polynomial decay: lr·(1 − e/E)^power (the
            # conventional companion of patch-based training; the reference
            # offers cosine/step/plateau only). E excludes warmup epochs,
            # matching how the cosine branch treats its ramp.
            t_max = max(self.epochs - self.warmup, 1)
            e = min(max(epoch - (self.warmup if self.use_warmup_ramp else 0), 0), t_max)
            return max(
                self.base_lr * (1.0 - e / t_max) ** self.power, self.min_lr
            )
        if self.name == "plateau":
            if metric is not None:
                if metric > self._best:
                    self._best = metric
                    self._bad = 0
                else:
                    self._bad += 1
                    if self._bad > self.patience:
                        self._scale *= self.factor
                        self._bad = 0
            return max(self.base_lr * self._scale, self.min_lr)
        return self.base_lr
