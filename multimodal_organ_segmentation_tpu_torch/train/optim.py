"""Optimisers and LR schedules (port of the JAX package's ``train.optim`` module).

``make_optimizer`` builds the configured optimiser over a model's parameters
with optax's update rules:

- ``adam``  — L2 weight decay added to the gradient (torch ``Adam``);
- ``adamw`` — decoupled decay (torch ``AdamW``). optax adds ``lr·wd·p`` to
  the update where torch multiplies ``p`` by ``1 − lr·wd`` first: the two
  differ by ``lr²·wd`` times the Adam direction, far below f32 resolution at
  the configured rates;
- ``sgd``   — momentum ``t ← g + μ·t``, L2 decay added to the gradient;
- ``adafactor`` — not ported yet (torch's ``Adafactor`` follows another
  update rule than optax's): raises ``NotImplementedError``;
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
from typing import Iterable, List, Optional

import torch


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


def make_optimizer(config, params: Iterable[torch.nn.Parameter]) -> ChainedOptimizer:
    """Build the configured optimiser over ``params`` with a learning rate
    that ``set_learning_rate`` rewrites."""
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
        raise NotImplementedError(
            "training.optimizer.name=adafactor is not ported to the PyTorch package yet "
            "(optax's factored update rule; queued with the optimiser follow-ups)"
        )
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
