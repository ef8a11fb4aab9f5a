"""Trainer: train/eval steps + host epoch loop (port of the JAX package's
``train/trainer.py``, single device).

- ``train_step(state, images, labels, key) → (state, metrics)``: gradient
  accumulation over the micro-batches inside the step, gradients summed in
  f32 on f32 master weights, mean over ``accum``; the state is updated IN
  PLACE (parameters, moments and EMA are overwritten, not copied: the JAX
  step donates its state for the same reason) and returned;
- compute in the config's dtype with f32 parameters cast per op (bf16 needs
  no loss scaling);
- per-epoch LR schedule injected host-side (cosine/step/plateau parity);
- streaming device-side Dice during validation;
- best/last/every-N and step checkpoints, early stopping, resume.

Not ported yet, each raising ``NotImplementedError`` that names its slice:
meshes and ZeRO-1 (multi-device slice), ``evaluate_native``, ``predict``,
ensembles, case shards and native mid-train validation (evaluation slice),
``model.pretrained`` import, TensorBoard and profiler traces.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from multimodal_organ_segmentation_tpu_torch.models.build import (
    build_model,
    cast_to_compute_dtype,
    compute_dtype,
)
from multimodal_organ_segmentation_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    CheckpointPolicy,
    load_checkpoint,
    save_checkpoint,
)
from multimodal_organ_segmentation_tpu_torch.train.losses import (
    get_loss,
    with_deep_supervision,
)
from multimodal_organ_segmentation_tpu_torch.train.metrics import dice_update
from multimodal_organ_segmentation_tpu_torch.train.optim import (
    ChainedOptimizer,
    LRScheduler,
    global_norm,
    make_optimizer,
    set_learning_rate,
)
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from multimodal_organ_segmentation_tpu_torch.utils.io import ensure_dir
from multimodal_organ_segmentation_tpu_torch.utils.prng import KeyStream

Params = Mapping[str, torch.Tensor]


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; it comes with the {slice_name} slice"
    )


@dataclass
class TrainState:
    """What a checkpoint carries. ``model`` holds the f32 master weights,
    ``optimizer`` the moments (None once ``freeze_for_inference`` dropped
    them), ``ema_params`` the EMA of the parameters by name (None when
    ``training.ema_decay`` is 0/unset)."""

    step: int
    model: nn.Module
    optimizer: Optional[ChainedOptimizer]
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def tree(self) -> Dict[str, Any]:
        """The checkpoint tree (live tensors, not copies)."""
        return {
            "step": int(self.step),
            "params": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict() if self.optimizer is not None else None,
            "ema_params": self.ema_params,
        }


def select_infer_params(state: TrainState, config) -> Params:
    """The weights inference-like consumers run on: the EMA tree when the
    state carries one and ``training.ema_eval`` (default true), else the raw
    params. ONE rule shared by eval, freeze and export."""
    if state.ema_params is not None and bool(config.get("training.ema_eval", True)):
        return state.ema_params
    return state.params


def _dropout_active(model: nn.Module) -> bool:
    return any(isinstance(m, nn.Dropout) and m.p > 0 for m in model.modules())


def make_train_step(
    model: nn.Module, optimizer: ChainedOptimizer, loss_fn: Callable, accum_steps: int,
    skip_nonfinite: bool = False, ema_decay: Optional[float] = None,
) -> Callable:
    """Build the train step.

    images ``[accum, micro, H, W, D, C]``, labels ``[accum, micro, H, W, D]``.
    ``skip_nonfinite`` drops the update (params, optimiser state and EMA keep
    their previous values) when the loss or any gradient is non-finite — one
    bad batch on a long run must not poison the Adam moments. The step still
    advances and ``metrics["skipped"]`` reports 1.0 so the host loop can log
    it; the test costs one host sync a step.
    ``ema_decay`` maintains ``state.ema_params`` as an exponential moving
    average of the params (``e ← d·e + (1−d)·p``, initialised to the initial
    params so no debias term is needed).
    ``key`` (a ``torch.Generator`` from a ``KeyStream``, or None) seeds the
    dropout draws of the step's micro-batches; it is read only when the model
    holds an active dropout.
    """
    params = [p for p in model.parameters() if p.requires_grad]
    dropout = _dropout_active(model)

    @contextlib.contextmanager
    def micro_rng(key, i, device):
        """Dropout draws of micro-batch ``i`` seeded from the step's key,
        torch's global generators left as they were."""
        if not dropout or key is None:
            yield
            return
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(key.initial_seed() + i)
            yield

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor, key=None):
        if images.shape[0] != accum_steps:
            raise ValueError(f"train_step: expected {accum_steps} micro-batches, got "
                             f"{images.shape[0]}")
        model.train()
        optimizer.zero_grad()
        loss_sum = torch.zeros((), dtype=torch.float32, device=images.device)
        for i in range(accum_steps):
            with micro_rng(key, i, images.device):
                loss = loss_fn(model(images[i]), labels[i])
                loss.backward()  # sums into the f32 .grad of the master weights
            loss_sum += loss.detach().float()
        scale = 1.0 / accum_steps
        grads = [p.grad for p in params if p.grad is not None]
        torch._foreach_mul_(grads, scale)
        gnorm = global_norm(grads)
        metrics = {"loss": loss_sum * scale, "grad_norm": gnorm}
        ok = True
        if skip_nonfinite:
            # grad_norm is finite iff every gradient element is
            ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
            metrics["skipped"] = torch.tensor(0.0 if ok else 1.0)
        if ok:
            optimizer.step(grad_norm=gnorm)
            if ema_decay is not None and state.ema_params is not None:
                named = dict(model.named_parameters())
                ema = [state.ema_params[n] for n in state.ema_params]
                with torch.no_grad():
                    torch._foreach_mul_(ema, float(ema_decay))
                    torch._foreach_add_(ema, [named[n].detach().to(e.dtype) for n, e in
                                              zip(state.ema_params, ema)],
                                        alpha=1.0 - float(ema_decay))
        optimizer.zero_grad()
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: nn.Module, loss_fn: Callable, num_classes: int) -> Callable:
    """Eval: loss + argmax preds + per-class ∩/∪ on the device, in eval mode
    under ``no_grad``. ``params`` (a name → tensor mapping, e.g. the EMA
    tree) stands in for the model's own parameters; None runs the model's.
    ``n_valid`` (optional) restricts the loss and Dice reductions to the
    first ``n_valid`` samples of a padded batch."""

    def eval_step(params: Optional[Params], images, labels, n_valid=None):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits = model(images) if params is None else functional_call(
                    model, dict(params), (images,))
        finally:
            model.train(was_training)
        if n_valid is not None and int(n_valid) != images.shape[0]:
            logits_v, labels_v = logits[: int(n_valid)], labels[: int(n_valid)]
        else:
            logits_v, labels_v = logits, labels
        with torch.no_grad():
            loss = loss_fn(logits_v, labels_v)
            preds = logits.argmax(dim=-1)
            inter, union = dice_update(logits_v.argmax(dim=-1), labels_v, num_classes)
        return loss, preds, inter, union

    return eval_step


class Trainer:
    """Owns the model, the optimiser and the state, and runs the train and eval loops.

    Runs on the CUDA device unless the caller names another ``device``
    (``device="cpu"`` for the CPU); with no CUDA device and none named it
    raises rather than carrying on on the CPU."""

    def __init__(
        self,
        config,
        model: Optional[nn.Module] = None,
        train_loader=None,
        val_loader=None,
        logger=None,
        resume_from: Optional[str] = None,
        mesh=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        config = config if isinstance(config, ConfigNode) else ConfigNode(dict(config))
        self.config = config
        self.logger = logger
        self.train_loader = train_loader
        self.val_loader = val_loader
        if mesh not in (None, False):
            raise _later("training on a device mesh", "multi-device")
        if bool(config.get("parallel.zero1", False)):
            raise _later("parallel.zero1", "multi-device")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Trainer: no CUDA device; pass device='cpu' to train the port on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)

        self.model = model if model is not None else build_model(
            config, device=self.device, train=True)
        self.model.to(self.device)
        # the wrapper is pass-through for single-output models
        self.loss_fn = with_deep_supervision(get_loss(config))
        self.num_classes = int(config.get("model.out_channels", 8))
        self.epochs = int(config.get("training.epochs", 300))
        self.accum_steps = max(1, int(config.get("training.accumulation_steps", 1)))
        self.scheduler = LRScheduler(config)

        out_dir = Path(config.get("experiment.output_dir", "outputs")) / str(
            config.get("experiment.name", "exp")
        )
        self.output_dir = ensure_dir(out_dir)
        # training.checkpoint.async: true → writes happen on a background
        # worker; the loop pays only the host snapshot. Created lazily per
        # train() and closed at its end so repeated Trainer construction
        # never leaks worker threads.
        self._ckpt_async = bool(config.get("training.checkpoint.async", False))
        self._ckpt_writer = None
        self.ckpt = CheckpointPolicy(self.output_dir, config)

        seed = int(config.get("experiment.seed", 42))
        self.keys = KeyStream(seed)

        self.state: Optional[TrainState] = None
        self.current_epoch = 0
        self.best_metric = 0.0
        self.history: Dict[str, List[float]] = {
            "train_loss": [],
            "val_loss": [],
            "val_dice": [],
        }

        self._train_step = None
        self._eval_step = make_eval_step(self.model, self.loss_fn, self.num_classes)
        self._resume_from = resume_from
        self._resume_step_in_epoch = 0
        self.last_step_losses: List[float] = []

    # -- state ------------------------------------------------------------

    def _ema_decay(self) -> Optional[float]:
        """``training.ema_decay`` in (0, 1) turns on EMA weight averaging."""
        d = float(self.config.get("training.ema_decay", 0.0) or 0.0)
        if not (0.0 < d < 1.0):
            return None
        return d

    def _infer_params(self) -> Params:
        """Params used for eval/inference — see ``select_infer_params``."""
        return select_infer_params(self.state, self.config)

    def _fresh_ema(self) -> Dict[str, torch.Tensor]:
        # EMA starts AT the current params (no debias term needed)
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def init_state(self, sample_image=None) -> TrainState:
        """Create the optimiser state and EMA around the model's weights.
        ``sample_image`` is accepted for the JAX signature and unused: the
        port's parameter shapes are fixed at construction."""
        self.keys.next()  # the JAX trainer spends one key on the init: same stream position
        if self.config.get("model.pretrained", None) and not self._resume_from:
            raise _later("model.pretrained (reference .pth import)", "checkpoint-import")
        optimizer = make_optimizer(self.config, self.model.parameters())
        ema = self._fresh_ema() if self._ema_decay() is not None else None
        self.state = TrainState(step=0, model=self.model, optimizer=optimizer, ema_params=ema)
        self._train_step = None
        if self._resume_from:
            self.resume(self._resume_from)
            self._resume_from = None
        return self.state

    def freeze_for_inference(self) -> nn.Module:
        """Turn the training state into the serving model and return it.

        Drops the optimiser (Adam moments are 2× the parameters, and
        inference never steps them) and the gradients, loads the weights
        inference runs on (``select_infer_params``: the EMA when there is
        one), stores them in the compute dtype as ``build_model`` does for
        serving, and puts the model in eval mode: the result is the model of
        the serving path with this run's weights."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        weights = {n: t.detach().clone() for n, t in self._infer_params().items()}
        self.state.optimizer = None
        self._train_step = None
        self.model.zero_grad(set_to_none=True)
        self.model.load_state_dict(weights, strict=False)
        cast_to_compute_dtype(self.model, compute_dtype(self.config))
        self.model.requires_grad_(False)
        return self.model.eval()

    def _load_tree(self, tree: Mapping[str, Any]) -> None:
        """Weights, step and (unless frozen) moments of a checkpoint tree."""
        self.model.load_state_dict(tree["params"])
        self.state.step = int(tree.get("step", 0))
        if self.state.optimizer is not None and tree.get("opt_state"):
            self.state.optimizer.load_state_dict(tree["opt_state"])

    def resume(self, path) -> None:
        ckpt = load_checkpoint(path, map_location=self.device)
        tree = ckpt["tree"]
        self._load_tree(tree)
        # reconcile the checkpoint's EMA with this run's config
        want_ema = self.state.ema_params is not None
        have_ema = tree.get("ema_params") is not None
        if want_ema and have_ema:
            self.state.ema_params = {n: t.to(self.device) for n, t in tree["ema_params"].items()}
        elif want_ema:
            # pre-EMA checkpoint: restart the EMA at the restored weights
            self.state.ema_params = self._fresh_ema()
            if self.logger:
                self.logger.warning(
                    "checkpoint has no EMA params; EMA restarted at the restored weights"
                )
        elif have_ema and self.logger:
            # EMA was turned off for this run: a stale EMA would never be
            # updated again but would silently drive eval — it is dropped
            self.logger.info(
                "checkpoint carries EMA params but training.ema_decay is 0 — "
                "ignoring them for this run"
            )
        meta = ckpt.get("meta", {}) or {}
        step_in_epoch = int(meta.get("step_in_epoch", 0))
        if step_in_epoch > 0:
            # step-granular checkpoint: re-enter the SAME epoch, skip the
            # steps already taken, restore the key stream position — the
            # resumed run reproduces the uninterrupted loss trajectory
            self.current_epoch = ckpt["epoch"]
            self._resume_step_in_epoch = step_in_epoch
        else:
            self.current_epoch = ckpt["epoch"] + 1
            self._resume_step_in_epoch = 0
        if "key_counter" in meta:
            self.keys.counter = int(meta["key_counter"])
        self.best_metric = ckpt["best_metric"]
        self.history = {
            "train_loss": list(ckpt["history"].get("train_loss", [])),
            "val_loss": list(ckpt["history"].get("val_loss", [])),
            "val_dice": list(ckpt["history"].get("val_dice", [])),
        }
        if self.logger:
            self.logger.info(
                f"Resumed from epoch {self.current_epoch}"
                + (f" step {step_in_epoch}" if step_in_epoch else "")
            )

    def load_params(self, path) -> None:
        """Load params-only (eval/inference from a checkpoint).

        EMA follows the checkpoint, not the config: a checkpoint trained
        with EMA evaluates on its smoothed weights (``training.ema_eval``
        still opts out), one without evaluates on the raw weights. A frozen
        trainer stays frozen (the moments are not brought back)."""
        if self.state is None:
            raise RuntimeError("call init_state first")
        tree = load_checkpoint(path, map_location=self.device)["tree"]
        self._load_tree(tree)
        ema = tree.get("ema_params")
        self.state.ema_params = (
            {n: t.to(self.device) for n, t in ema.items()} if ema is not None else None
        )

    # -- batching ---------------------------------------------------------

    def _stack_accum(self, batches: List[Dict]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``accum`` loader batches → images ``[accum, micro, H, W, D, C]``
        and int64 labels ``[accum, micro, H, W, D]`` on the device."""

        def stack(key, dtype):
            vals = [b[key] for b in batches]
            if isinstance(vals[0], torch.Tensor):
                return torch.stack(vals).to(self.device, dtype)
            t = torch.from_numpy(np.stack([np.asarray(v) for v in vals], axis=0))
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, dtype, non_blocking=True)

        return stack("image", torch.float32), stack("label", torch.int64)

    # -- loops ------------------------------------------------------------

    def _prune_metrics_stream(self) -> None:
        """Drop metrics.jsonl lines for epochs this run is about to re-write
        (a fresh run in an existing dir, or a resume from a non-last
        checkpoint, would otherwise append a second record for an epoch)."""
        path = self.output_dir / "metrics.jsonl"
        if not path.exists():
            return
        kept = []
        for line in path.read_text().splitlines():
            try:
                rec = json.loads(line.replace("NaN", "null"))
            except Exception:
                continue
            if int(rec.get("epoch", 0)) <= self.current_epoch:
                kept.append(line)
        path.write_text("".join(l + "\n" for l in kept))

    def train(self) -> Dict[str, List[float]]:
        assert self.train_loader is not None, "train requires a train_loader"
        es_cfg = self.config.get("training.early_stopping", {}) or {}
        patience = int(es_cfg.get("patience", 30))
        es_enabled = bool(es_cfg.get("enabled", False))
        no_improve = 0
        prev_metric: Optional[float] = None
        if int(self.config.get("training.native_val_every", 0) or 0) > 0:
            raise _later("training.native_val_every (native-grid validation)", "evaluation")
        monitor = str(self.config.get("training.checkpoint.monitor", "dice") or "dice").lower()
        if monitor == "dice_native":
            raise _later("training.checkpoint.monitor=dice_native", "evaluation")
        if bool(self.config.get("experiment.tensorboard", False)):
            raise _later("experiment.tensorboard", "logging")
        if self.config.get("hardware.profile_dir"):
            raise _later("hardware.profile_dir (profiler trace of an epoch)", "tracing")

        if self.state is None:
            self.init_state()
        if self._ckpt_async and self._ckpt_writer is None:
            self._ckpt_writer = AsyncCheckpointWriter()
            self.ckpt.writer = self._ckpt_writer
        self._prune_metrics_stream()

        try:
            for epoch in range(self.current_epoch, self.epochs):
                self.current_epoch = epoch
                lr = self.scheduler.lr_for_epoch(epoch, metric=prev_metric)

                t0 = time.perf_counter()
                train_loss = self._train_epoch(lr)
                self.history["train_loss"].append(train_loss)

                val_loss, val_metrics = self._validate()
                self.history["val_loss"].append(val_loss)
                val_dice = val_metrics.get("dice", 0.0)
                self.history["val_dice"].append(val_dice)
                prev_metric = val_dice

                dt = time.perf_counter() - t0
                if self.logger:
                    self.logger.info(
                        f"Epoch [{epoch + 1}/{self.epochs}] "
                        f"Train Loss: {train_loss:.4f} Val Loss: {val_loss:.4f} "
                        f"Val Dice: {val_dice:.4f} LR: {lr:.2e} ({dt:.1f}s)"
                    )

                # machine-readable epoch stream (one JSON object per line),
                # append-only so a resumed run keeps the full trajectory
                def _num(x):
                    # strict-JSON consumers reject bare NaN/Infinity tokens
                    x = float(x)
                    return round(x, 6) if np.isfinite(x) else None

                rec = {
                    "epoch": epoch + 1,
                    "train_loss": _num(train_loss),
                    "val_loss": _num(val_loss),
                    "val_dice": _num(val_dice),
                    "lr": lr,
                    "seconds": round(dt, 2),
                }
                with open(self.output_dir / "metrics.jsonl", "a") as f:
                    f.write(json.dumps(rec) + "\n")

                # best-metric tracking is independent of checkpoint policy
                # (with save_best off, early stopping must still see the best)
                is_best = val_dice >= self.best_metric
                improved = val_dice > self.best_metric
                self.best_metric = max(self.best_metric, val_dice)
                self.ckpt.save(
                    self.state.tree(), epoch, val_dice, self.best_metric,
                    history=self.history, is_best=is_best,
                )

                no_improve = 0 if improved else no_improve + 1
                if es_enabled and no_improve >= patience:
                    if self.logger:
                        self.logger.info(f"Early stopping at epoch {epoch + 1}")
                    break
        finally:
            # close the writer on every exit path; don't return before every
            # queued write is on disk (writer errors surface here)
            if self._ckpt_writer is not None:
                self._ckpt_writer.close()
                self._ckpt_writer = None
                self.ckpt.writer = None
        return self.history

    def train_step_fn(self) -> Callable:
        """The train step over this trainer's model, optimiser and loss,
        built once per optimiser (``make_train_step``)."""
        if self.state is None:
            self.init_state()
        if self.state.optimizer is None:
            raise RuntimeError("the trainer was frozen for inference; it cannot train on")
        if self._train_step is None:
            self._train_step = make_train_step(
                self.model, self.state.optimizer, self.loss_fn, self.accum_steps,
                skip_nonfinite=bool(self.config.get("training.skip_nonfinite_updates", False)),
                ema_decay=self._ema_decay(),
            )
        return self._train_step

    def _train_epoch(self, lr: float) -> float:
        train_step = self.train_step_fn()
        set_learning_rate(self.state.optimizer, lr)

        # step-granular preemption recovery: every N optimiser steps an
        # atomic "last_step" checkpoint records (state, step-in-epoch, key
        # counter); resume re-enters this epoch at the exact position
        save_every_steps = int(
            self.config.get("training.checkpoint.save_every_steps", 0) or 0
        )
        skip_steps = self._resume_step_in_epoch
        self._resume_step_in_epoch = 0
        if hasattr(self.train_loader, "epoch_iter"):
            it = self.train_loader.epoch_iter(
                self.current_epoch + 1,
                skip_batches=skip_steps * self.accum_steps,
            )
        else:  # plain iterables (test fixtures): manual skip
            it = iter(self.train_loader)
            for _ in range(skip_steps * self.accum_steps):
                next(it, None)

        total, count = 0.0, 0
        step_in_epoch = skip_steps
        self.last_step_losses = []
        group: List[Dict] = []
        for batch in it:
            group.append(batch)
            if len(group) < self.accum_steps:
                continue
            images, labels = self._stack_accum(group)
            group = []
            self.state, metrics = train_step(
                self.state, images, labels, self.keys.next()
            )
            loss = float(metrics["loss"])
            if float(metrics.get("skipped", 0.0)) > 0:
                if self.logger:
                    self.logger.warning(
                        f"step {step_in_epoch + 1}: non-finite loss/grads "
                        f"(loss={loss}) — update skipped"
                    )
            else:
                total += loss
                count += 1
            step_in_epoch += 1
            self.last_step_losses.append(loss)
            if save_every_steps and step_in_epoch % save_every_steps == 0:
                _save = (
                    self._ckpt_writer.submit
                    if self._ckpt_writer is not None
                    else save_checkpoint
                )
                _save(
                    self.state.tree(),
                    self.output_dir / "last_step",
                    epoch=self.current_epoch,
                    best_metric=self.best_metric,
                    history=self.history,
                    step_in_epoch=step_in_epoch,
                    key_counter=self.keys.counter,
                )
        # a trailing partial accumulation group is dropped
        if count == 0 and skip_steps > 0:
            # the step checkpoint landed on the epoch's final step: nothing
            # left to run — report the last known train loss instead of 0.0
            if self.logger:
                self.logger.info(
                    f"Epoch {self.current_epoch + 1} was already complete at "
                    f"the resumed step checkpoint (step {skip_steps})"
                )
            prior = self.history.get("train_loss") or []
            return float(prior[-1]) if prior else 0.0
        return total / max(count, 1)

    def _validate(self) -> Tuple[float, Dict[str, Any]]:
        if self.val_loader is None:
            return 0.0, {}
        if self.state is None:
            self.init_state()

        from multimodal_organ_segmentation_tpu_torch.data.dataloader import device_prefetch

        # the EMA tree stands in for the parameters; raw params run as they are
        params = self._infer_params() if self.state.ema_params is not None else None
        total, count = 0.0, 0
        inter = np.zeros(self.num_classes)
        union = np.zeros(self.num_classes)
        for batch in device_prefetch(iter(self.val_loader), self.device):
            images = batch["image"].to(torch.float32)
            labels = batch["label"].to(torch.int64)
            loss, _, i, u = self._eval_step(params, images, labels)
            total += float(loss)
            count += 1
            inter += i.double().cpu().numpy()
            union += u.double().cpu().numpy()

        smooth = 1e-5
        per_class = (2.0 * inter + smooth) / (union + smooth)
        metrics = {
            "dice": float(per_class[1:].mean()),
            "dice_per_class": per_class.tolist(),
        }
        return total / max(count, 1), metrics

    def evaluate(self) -> Dict[str, Any]:
        loss, metrics = self._validate()
        metrics["loss"] = loss
        return metrics

    # -- later slices -------------------------------------------------------

    def evaluate_native(self, loader=None):
        raise _later("evaluate_native (native-grid Dice, HD95, NSD, ASSD)", "evaluation")

    def predict(self, *args, **kwargs):
        raise _later("predict (case discovery + sliding-window inference to NIfTI)", "evaluation")
